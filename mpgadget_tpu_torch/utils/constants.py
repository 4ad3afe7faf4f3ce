"""Physical constants in cgs units.

Values match the reference so that simulations are bit-comparable
(reference: libgadget/physconst.h).
"""

GRAVITY = 6.672e-8            # cm^3 g^-1 s^-2
SOLAR_MASS = 1.989e33         # g
SOLAR_LUM = 3.826e33          # erg/s
RAD_CONST = 7.565e-15         # erg cm^-3 K^-4
AVOGADRO = 6.0222e23
BOLTZMANN = 1.38066e-16       # erg/K
BOLEVK = 8.61734e-5           # eV/K
EV_IN_ERGS = 1.60218e-12
GAS_CONST = 8.31425e7
LIGHTCGS = 2.99792458e10      # cm/s
PLANCK = 6.6262e-27
CM_PER_MPC = 3.085678e24
CM_PER_KPC = 3.085678e21
PROTONMASS = 1.6726e-24       # g
ELECTRONMASS = 9.10953e-28
THOMPSON = 6.65245e-25
ELECTRONCHARGE = 4.8032e-10
HUBBLE = 3.2407789e-18        # H0/h in s^-1
SEC_PER_MEGAYEAR = 3.155e13
SEC_PER_YEAR = 3.155e7
STEFAN_BOLTZMANN = 5.670373e-5  # erg cm^-2 s^-1 K^-4

GAMMA = 5.0 / 3.0             # adiabatic index of simulated gas
GAMMA_MINUS1 = GAMMA - 1.0

HYDROGEN_MASSFRAC = 0.76      # primordial hydrogen mass fraction

# HeII ionization energy, used by helium reionization (cooling_qso_lightup.c)
E0_HeII_EV = 54.4
