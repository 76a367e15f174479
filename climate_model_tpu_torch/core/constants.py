"""Physical constants (a copy of ``climate_model_tpu/core/constants.py``).

The port keeps its own copy so that it never imports the JAX package. Values
are standard atmospheric-science values (Jacobson, *Fundamentals of
Atmospheric Modeling*, 2nd ed.). All constants are plain Python floats, so
precision follows the tensor dtype they combine with (fp32 on the card, fp64
in the CPU comparison tests).
"""

G = 9.81                 # gravitational acceleration          [m s-2]
R_EARTH = 6_371_000.0    # mean Earth radius                   [m]
OMEGA = 7.292115e-5      # Earth's angular velocity            [rad s-1]
R_D = 287.0              # specific gas constant, dry air      [J kg-1 K-1]
R_V = 461.5              # specific gas constant, water vapor  [J kg-1 K-1]
C_P = 1004.0             # specific heat, dry air, const p     [J kg-1 K-1]
KAPPA = R_D / C_P        # Poisson constant R_d/c_p            [-]
L_V = 2.501e6            # latent heat of vaporization         [J kg-1]
SIGMA_SB = 5.670374e-8   # Stefan-Boltzmann constant           [W m-2 K-4]
P_REF = 100_000.0        # reference pressure for Exner fn     [Pa]
SOLAR_CONSTANT = 1365.0  # total solar irradiance              [W m-2]

# Moist thermodynamics
EPS_V = R_D / R_V        # ratio of gas constants (~0.622)     [-]

# Magnus formula coefficients for saturation vapor pressure over water
# e_sat(T) = MAGNUS_E0 * exp(MAGNUS_A * T_C / (T_C + MAGNUS_B)), T_C in deg C
MAGNUS_E0 = 610.94       # [Pa]
MAGNUS_A = 17.625
MAGNUS_B = 243.04
T_ZERO_C = 273.15        # 0 deg C in K
RHO_WATER = 1000.0       # density of liquid water [kg m-3]

SECONDS_PER_DAY = 86_400.0
