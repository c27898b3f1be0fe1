"""The equilibrium protocol (fields + profiles at a point).

Counterpart of ``graph_framework_tpu.models.equilibrium`` (reference:
equilibrium.hpp:235-466).  An equilibrium is an object whose methods are
plain batched torch functions: positions are (3, ...) tensors with the
component axis LEADING (as in the JAX package), fields come back the same
way.  The analytic equilibria (``NoMagneticField``, ``Slab``,
``SlabDensity``, ``SlabField``, ``GaussianDensity``; equilibrium.hpp:
482-1104) live here; EFIT (:mod:`graph_framework_tpu_torch.models.efit`)
and VMEC (:mod:`graph_framework_tpu_torch.models.vmec`, flux coordinates
with a non-identity basis) implement the same protocol.

Units are the reference's: densities in 1/m^3, temperatures in eV,
magnetic fields in T, positions in m.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from graph_framework_tpu_torch.constants import MI_DEUTERIUM


class PlasmaQuantities(NamedTuple):
    """Everything a dispersion relation reads from the equilibrium at one
    point, fetched together (the reference memoizes these subgraphs keyed
    on the evaluation point, ``set_cache``, equilibrium.hpp:1324-1384)."""
    b: torch.Tensor                 # magnetic field (3, ...) [T]
    ne: torch.Tensor                # electron density [1/m^3]
    te: torch.Tensor                # electron temperature [eV]
    ni: Tuple[torch.Tensor, ...]    # per-species ion densities
    ti: Tuple[torch.Tensor, ...]    # per-species ion temperatures


class Equilibrium:
    """Base interface (equilibrium.hpp:235-466).

    Subclasses implement the profile/field methods; the basis/coordinate
    methods default to cartesian (identity), matching ``generic::get_esup*``
    (equilibrium.hpp:383-440).
    """

    #: per-species ion masses [kg] / charges [e] (equilibrium.hpp:240-243).
    ion_masses: Tuple[float, ...] = ()
    ion_charges: Tuple[int, ...] = ()

    @property
    def num_ion_species(self) -> int:
        return len(self.ion_masses)

    # -- profiles ----------------------------------------------------------
    def electron_density(self, pos):
        raise NotImplementedError

    def ion_density(self, index, pos):
        raise NotImplementedError

    def electron_temperature(self, pos):
        raise NotImplementedError

    def ion_temperature(self, index, pos):
        raise NotImplementedError

    def magnetic_field(self, pos):
        raise NotImplementedError

    def plasma_quantities(self, pos) -> PlasmaQuantities:
        """All dispersion inputs at ``pos`` (see PlasmaQuantities).

        Default: delegate to the individual accessors, as the analytic
        equilibria share no work between them; EFIT overrides it to share
        its table gathers."""
        n = self.num_ion_species
        return PlasmaQuantities(
            b=self.magnetic_field(pos),
            ne=self.electron_density(pos),
            te=self.electron_temperature(pos),
            ni=tuple(self.ion_density(i, pos) for i in range(n)),
            ti=tuple(self.ion_temperature(i, pos) for i in range(n)),
        )

    def characteristic_field(self):
        """Normalizing field magnitude (the Boris pusher's b0;
        equilibrium.hpp get_characteristic_field)."""
        raise NotImplementedError

    def esup(self, pos):
        """Contravariant basis vectors as the rows of a (3, 3) matrix
        (e^1; e^2; e^3).  Cartesian default: the identity
        (equilibrium.hpp:383-440)."""
        return torch.eye(3, dtype=pos.dtype, device=pos.device)

    def kvec(self, kcov, pos):
        """Physical wave vector from covariant components:
        k = kx e^1 + ky e^2 + kz e^3 (dispersion.hpp:1387-1389).  Batched:
        ``kcov``/``pos`` are (3,) or (3, num_rays), and the rows of
        ``esup(pos)`` broadcast against the covariant components."""
        if self.is_cartesian():
            return kcov        # identity basis: skip the contraction
        esup = self.esup(pos)  # (3 basis, 3 components[, rays])
        return kcov[0] * esup[0] + kcov[1] * esup[1] + kcov[2] * esup[2]

    def is_cartesian(self) -> bool:
        """True when the contravariant basis is the identity everywhere."""
        return True

    def bind_point(self, pos):
        """An equilibrium view with any shared geometry precomputed at
        ``pos`` (the reference's point-keyed subgraph memoization).  Default:
        ``self`` - cartesian equilibria share no work between accessors."""
        return self

    def supports_batched(self) -> bool:
        """True when the field/basis methods take (3, num_rays) positions,
        which the batched ray right-hand side (models.rays) needs."""
        return self.is_cartesian()

    def value_rhs(self, dispersion):
        """A hand-written value path of the ray right-hand side of
        ``dispersion`` over this equilibrium, which ``models.rays.
        make_ray_rhs`` asks once: ``rhs(leaves)`` of the seven leaves (w, x,
        y, z, kx, ky, kz) gives the six derivatives, or None for leaves it
        does not take.  Default: None, no such path."""
        return None


def _constant(value, pos):
    """A 0-dim tensor of ``pos``'s dtype and device (the JAX package's
    ``jnp.asarray(value, dtype=result_type(pos))``)."""
    return torch.full((), value, dtype=pos.dtype, device=pos.device)


def _field_z(pos, bz):
    """B = (0, 0, bz) stacked on the leading axis."""
    zero = torch.zeros_like(pos[0])
    return torch.stack([zero, zero, zero + bz])


class _AnalyticEquilibrium(Equilibrium):
    """Shared bits of the closed-form equilibria: one deuterium ion species
    of charge 1 (equilibrium.hpp:488,617,...), and ion profiles equal to
    the electrons'.  All take (3, ...) positions; characteristic field 1."""

    ion_masses = (MI_DEUTERIUM,)
    ion_charges = (1,)

    def ion_density(self, index, pos):
        return self.electron_density(pos)

    def ion_temperature(self, index, pos):
        return self.electron_temperature(pos)

    def electron_temperature(self, pos):
        return _constant(1000.0, pos)

    def characteristic_field(self):
        return 1.0


class NoMagneticField(_AnalyticEquilibrium):
    """Linear density ramp, B = 0 (equilibrium.hpp:482-595):
    ne = ni = 1e19 (0.1 x + 1), te = ti = 1000 eV."""

    def electron_density(self, pos):
        return 1.0e19 * (0.1 * pos[0] + 1.0)

    def magnetic_field(self, pos):
        return torch.zeros_like(pos)


class Slab(_AnalyticEquilibrium):
    """Uniform density, sheared field (equilibrium.hpp:611-719):
    ne = ni = 1e19, te = ti = 1000 eV, B = (0, 0, 0.1 x + 1)."""

    def electron_density(self, pos):
        return _constant(1.0e19, pos)

    def magnetic_field(self, pos):
        return _field_z(pos, 0.1 * pos[0] + 1.0)


class SlabDensity(_AnalyticEquilibrium):
    """Linear density ramp, uniform field (equilibrium.hpp:735-848):
    ne = ni = 1e19 (0.1 x + 1), te = ti = 1000 eV, B = (0, 0, 1)."""

    def electron_density(self, pos):
        return 1.0e19 * (0.1 * pos[0] + 1.0)

    def magnetic_field(self, pos):
        return _field_z(pos, 1.0)


class SlabField(_AnalyticEquilibrium):
    """Gentle density+temperature+field ramps (equilibrium.hpp:864-977):
    ne = ni = 1e19 (0.01 x + 1), te = ti = 2000 (0.01 x + 1) eV,
    B = (0, 0, 0.01 x + 1)."""

    def electron_density(self, pos):
        return 1.0e19 * (0.01 * pos[0] + 1.0)

    def electron_temperature(self, pos):
        return 2000.0 * (0.01 * pos[0] + 1.0)

    def magnetic_field(self, pos):
        return _field_z(pos, 0.01 * pos[0] + 1.0)


class GaussianDensity(_AnalyticEquilibrium):
    """Gaussian density well, uniform x-directed field
    (equilibrium.hpp:991-1104): ne = ni = 1e19 exp(-(x^2+y^2)/0.2),
    te = ti = 1000 eV, B = (1, 0, 0)."""

    def electron_density(self, pos):
        return 1.0e19 * torch.exp((pos[0] * pos[0] + pos[1] * pos[1])
                                  / -0.2)

    def magnetic_field(self, pos):
        zero = torch.zeros_like(pos[0])
        return torch.stack([zero + 1.0, zero, zero])


# -- factories matching the reference's make_* helpers ----------------------
def make_no_magnetic_field():
    return NoMagneticField()


def make_slab():
    return Slab()


def make_slab_density():
    return SlabDensity()


def make_slab_field():
    return SlabField()


def make_gaussian_density():
    return GaussianDensity()
