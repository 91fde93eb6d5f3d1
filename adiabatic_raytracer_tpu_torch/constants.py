"""Physical constants in the mixed "natural-ish" unit system of the reference.

Units: lengths in km, times in s, energies in eV, magnetic field in Gauss,
masses (of the star) in solar masses, axion mass in eV.

Reference: Constants.jl:1-6 of the Julia reference
"""

import math

C_KM = 2.99792e5          # speed of light [km/s]
HBAR = 6.582119e-16       # hbar [eV s]
G_NEW = 1.32712e11        # G * Msun [km^3 / s^2] (per solar mass)

# Derived constants used by the Goldreich-Julian plasma-frequency formula
# (RayTracer.jl:877-878): n_e = |2 Omega B_z| / sqrt(4 pi alpha) * 1.95e-2 * hbar,
# omega_p = sqrt(4 pi n_e alpha / m_e).
INV_ALPHA = 137.0          # 1/alpha_em as used by the reference (exactly 137)
M_E_EV = 5.0e5             # electron mass [eV] as used by the reference
GAUSS_TO_EV2 = 1.95e-2     # B[Gauss] -> B[eV^2] conversion used by the reference
SQRT_4PI_ALPHA = math.sqrt(4.0 * math.pi / INV_ALPHA)
