"""The equilibrium protocol (fields + profiles at a point).

Counterpart of ``graph_framework_tpu.models.equilibrium`` (reference:
equilibrium.hpp:235-466).  An equilibrium is an object whose methods are
plain batched torch functions: positions are (3, ...) tensors with the
component axis LEADING (as in the JAX package), fields come back the same
way.  The analytic equilibria are not ported yet; EFIT
(:mod:`graph_framework_tpu_torch.models.efit`) implements this protocol.

Units are the reference's: densities in 1/m^3, temperatures in eV,
magnetic fields in T, positions in m.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


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

    def plasma_quantities(self, pos) -> PlasmaQuantities:
        """All dispersion inputs at ``pos`` (see PlasmaQuantities)."""
        raise NotImplementedError

    def kvec(self, kcov, pos):
        """Physical wave vector from covariant components:
        k = kx e^1 + ky e^2 + kz e^3 (dispersion.hpp:1387-1389).  The
        cartesian basis is the identity."""
        if self.is_cartesian():
            return kcov
        raise NotImplementedError(
            "non-cartesian bases are not ported yet")

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
