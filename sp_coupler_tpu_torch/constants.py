"""Physical constants shared by the GCM, LES and coupling layers.

The same values as ``sp_coupler_tpu/constants.py`` (SI units, plain
floats), copied so that the port loads nothing of the JAX package;
tests/test_torch_imports.py holds the two tables equal.
"""

pref0 = 1.0e5       # Pa    reference pressure
rd = 287.04         # J/kg/K gas constant, dry air
rv = 461.5          # J/kg/K gas constant, water vapor
cp = 1004.0         # J/kg/K specific heat of dry air at constant pressure
rlv = 2.53e6        # J/kg  latent heat of vaporisation
rls = 2.84e6        # J/kg  latent heat of sublimation (ice processes)
grav = 9.81         # m/s^2 gravitational acceleration
mair = 28.967e-3    # kg/mol molar mass of dry air
omega = 7.292e-5    # 1/s   Earth rotation rate
a_earth = 6.371e6   # m     Earth radius
eps_i = rv / rd - 1.0  # ~0.61, virtual-temperature moisture factor
kappa = rd / cp

# Saturation vapor pressure constants (Tetens / Murray formulations)
es0 = 610.78        # Pa, saturation vapor pressure at T0
tmelt = 273.16      # K triple point
at_liq = 17.27      # Tetens coefficient over liquid water
bt_liq = 35.86      # K
at_ice = 21.875     # Tetens coefficient over ice
bt_ice = 7.66       # K
