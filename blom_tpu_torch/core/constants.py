"""Physical constants and unit-conversion parameters.

The port's own copy of `blom_tpu/core/constants.py` (BLOM's
mod_constants.F90:31-57).  BLOM measures layer "thickness" in pressure
units (kg m-1 s-2 == Pa); ``onem`` is the pressure of one metre of water
at reference density.
"""

grav = 9.806            # Gravitational acceleration [m s-2].
rearth = 6.37122e6      # Radius of the Earth [m].
spcifh = 3990.          # Specific heat capacity of sea water [J kg-1 K-1].
t0deg = 273.15          # Zero degrees Celsius in Kelvin [K].
alpha0 = 1.e-3          # Reference value of specific volume [m3 kg-1].
rho0 = 1.e3             # Reference value of density [kg m-3].
pi = 3.1415926536       # pi (BLOM's truncated value, kept for parity).
radian = 57.295779513   # 180/pi.

epsilpl = 1.e-14        # Small value for pressure*dx.
epsilp = 1.e-12         # Small value for pressure.
epsilz = 1.e-9          # Small value for depth.
epsilt = 1.e-11         # Small value for time.
epsilk = 1.e-15         # Small value for kappa.
spval = 1.e33           # Fill value for land / uninitialised points.

tenm = 98060.           # 10 m in pressure units [kg m-1 s-2].
onem = 9806.            # 1 m in pressure units.
tencm = 980.6           # 10 cm in pressure units.
onecm = 98.06           # 1 cm in pressure units.
onemm = 9.806           # 1 mm in pressure units.
onemu = .009806         # 1 micrometre in pressure units.

g2kg = 1.e-3
kg2g = 1.e3
