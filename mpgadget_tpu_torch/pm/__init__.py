from .gravity import pm_force, PMConfig, PowerSpectrum
