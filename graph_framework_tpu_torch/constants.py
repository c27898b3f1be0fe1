"""Physical constants shared by the dispersion functions.

Values match the reference's ``dispersion::physics`` base class
(reference: graph_framework/dispersion.hpp:489-503) so that trajectories are
bit-comparable across frameworks.

The framework works in the reference's normalized units
(graph_framework/dispersion.hpp "Normalization" docs): frequencies are scaled
by the speed of light (omega' = omega/c, units 1/m), time is scaled to
t' = t*c (units m), so phase and group velocities are dimensionless fractions
of c.
"""

import math

#: Vacuum permittivity [F/m] (dispersion.hpp:493).
EPSILON0 = 8.8541878138e-12

#: Vacuum permeability [H/m] (dispersion.hpp:495).
MU0 = math.pi * 4.0e-7

#: Fundamental charge [C] (dispersion.hpp:497).
Q = 1.602176634e-19

#: Electron mass [kg] (dispersion.hpp:499).
ME = 9.1093837015e-31

#: Speed of light [m/s], derived exactly as the reference does
#: (dispersion.hpp:501: c = 1/sqrt(epsilon0*mu0)).
C = 1.0 / math.sqrt(EPSILON0 * MU0)

#: Default ion (deuteron) mass [kg] used by all analytic equilibria
#: (equilibrium.hpp slab/no_magnetic_field constructors: 3.34449469E-27).
MI_DEUTERIUM = 3.34449469e-27


def plasma_frequency_squared(n, q, m):
    """Normalized plasma frequency squared: wp'^2 = n q^2 / (eps0 m c^2).

    Matches ``dispersion::build_plasma_frequency``
    (dispersion.hpp:324-333): the reference returns n*q*q/(epsilon0*m*c*c),
    i.e. (wp/c)^2 in 1/m^2.

    The scalar factor q^2/(eps0 m c^2) is folded in PYTHON f64 before it
    enters the trace.  Leaving q*q (2.6e-38) and eps0*m*c*c as separate
    f32 graph constants invites XLA's algebraic simplifier to reassociate
    them into intermediates below the f32 normal range: measured on
    XLA:CPU, grad of (q b/(m c))^2/w^2 rewrote to (q b)^2/((m c)^2 w^2)
    whose (m c)^2 = 7.5e-44 underflows -> inf -> NaN through the whole
    ray RHS (round-4 find; eager mode and f64 were unaffected).
    """
    return n * (q * q / (EPSILON0 * m * C * C))


def cyclotron_frequency(q, b, m):
    """Normalized cyclotron frequency: wc' = q B / (m c).

    Matches ``dispersion::build_cyclotron_frequency`` (dispersion.hpp:346-353).
    Note electrons pass a *negative* charge.  q/(m c) is folded in Python
    f64 first - see ``plasma_frequency_squared`` for the f32 underflow
    this prevents.
    """
    return b * (q / (m * C))
