"""Gadget/GenIC runtime parameter schemas.

Every parameter of the reference is declared here with the same name,
type, required/optional status and default (reference: gadget/params.c:50-387
and genic/params.c:10-69), so reference parameter files work verbatim.
All science switches are runtime parameters, as in the reference.
"""

from .utils.paramset import ParameterSet, REQUIRED, OPTIONAL

# -- enums (flag values match the reference headers) -------------------

DENSITY_KERNEL_TYPES = {"cubic": 1, "quintic": 2, "quartic": 4}

SHORTRANGE_FORCE_WINDOW = {"exact": 0, "erfc": 1}

COOLING_TYPES = {"KWH92": 0, "Enzo2Nyx": 1, "Sherwood": 2}
RECOMB_TYPES = {"Cen92": 0, "Verner96": 1, "Badnell06": 2}

# winds.h:14-19
WIND_SUBGRID = 1
WIND_DECOUPLE_SPH = 2
WIND_USE_HALO = 4
WIND_FIXED_EFFICIENCY = 8
WIND_ISOTROPIC = 512
WIND_MODELS = {
    "subgrid": WIND_SUBGRID,
    "decouple": WIND_DECOUPLE_SPH,
    "halo": WIND_USE_HALO,
    "fixedefficiency": WIND_FIXED_EFFICIENCY,
    "sh03": WIND_SUBGRID | WIND_DECOUPLE_SPH | WIND_FIXED_EFFICIENCY,
    "vs08": WIND_FIXED_EFFICIENCY,
    "ofjt10": WIND_USE_HALO | WIND_DECOUPLE_SPH,
    "isotropic": WIND_ISOTROPIC,
}

# sfr_eff.h:17-22
SFR_CRITERION = {
    "density": 1,
    "h2": 3,
    "selfgravity": 5,
    "convergent": 13,
    "continuous": 21,
}

# blackhole.h:48-52
BH_FEEDBACK_TOPHAT = 0x2
BH_FEEDBACK_SPLINE = 0x4
BH_FEEDBACK_MASS = 0x8
BH_FEEDBACK_VOLUME = 0x10
BH_FEEDBACK_METHODS = {
    "mass": BH_FEEDBACK_MASS,
    "volume": BH_FEEDBACK_VOLUME,
    "tophat": BH_FEEDBACK_TOPHAT,
    "spline": BH_FEEDBACK_SPLINE,
}


def create_gadget_parameter_set() -> ParameterSet:
    ps = ParameterSet()
    d, i, s, e = (ps.declare_double, ps.declare_int, ps.declare_string,
                  ps.declare_enum)

    s("InitCondFile", REQUIRED, help="Path to the Initial Condition File")
    s("OutputDir", REQUIRED, help="Prefix to the output files")
    e("DensityKernelType", DENSITY_KERNEL_TYPES, OPTIONAL, "quintic",
      "SPH density kernel: cubic, quartic or quintic.")
    s("SnapshotFileBase", OPTIONAL, "PART", "Base name of snapshot files")
    s("FOFFileBase", OPTIONAL, "PIG", "Base name of fof files")
    s("EnergyFile", OPTIONAL, "energy.txt", "Energy statistics output")
    i("OutputEnergyDebug", OPTIONAL, 0, "Output energy statistics")
    s("CpuFile", OPTIONAL, "cpu.txt", "Cpu usage output")
    s("OutputList", REQUIRED, help="List of output scale factors")

    # Potential planes
    s("PlaneOutputList", OPTIONAL, "", "Plane output scale factors")
    i("PlaneResolution", OPTIONAL, 256, "Pixels per dim in potential plane")
    d("PlaneThickness", OPTIONAL, -1, "Plane thickness, internal units")
    s("PlaneCutPoints", OPTIONAL, "", "Plane cut points")
    s("PlaneNormals", OPTIONAL, "0, 1, 2", "Plane normal directions")
    i("PlaneMassiveNuCorrection", OPTIONAL, 1, "Nu corrections on planes")
    i("PlaneDoubleOut", OPTIONAL, 0, "Write planes as float64")

    # Cosmology
    d("Omega0", REQUIRED, 0.2814, "Total matter density at z=0")
    d("CMBTemperature", OPTIONAL, 2.7255, "Present-day CMB temperature, K")
    d("OmegaBaryon", OPTIONAL, -1, "Baryon density at z=0")
    d("OmegaLambda", OPTIONAL, -1, "Dark energy density at z=0")
    d("Omega_fld", OPTIONAL, 0, "Dark energy fluid density")
    d("w0_fld", OPTIONAL, -1.0, "Dark energy equation of state")
    d("wa_fld", OPTIONAL, 0, "Dark energy evolution parameter")
    d("Omega_ur", OPTIONAL, 0, "Extra radiation density")
    d("HubbleParam", OPTIONAL, -1, "Hubble parameter h")

    i("OutputPotential", OPTIONAL, 1, "Save potential in snapshots")
    i("OutputTimebins", OPTIONAL, 0, "Save particle timebins in snapshots")
    i("OutputHeliumFractions", OPTIONAL, 0, "Save helium ionic fractions")
    i("OutputDebugFields", OPTIONAL, 0, "Save debug fields in snapshots")
    i("ShowBacktrace", OPTIONAL, 1, "Print a backtrace on crash")
    d("MaxMemSizePerNode", OPTIONAL, 0.6, "Preallocated memory per node, MB")
    d("AutoSnapshotTime", OPTIONAL, 0, "Auto-checkpoint wall-clock cadence, s")

    d("TimeMax", OPTIONAL, 1.0, "Scale factor to end run")
    d("TimeLimitCPU", REQUIRED, 0, "Wall-clock budget in seconds")

    i("MaxDomainTimeBinDepth", OPTIONAL, 8,
      "Force domain decomposition every 2^this timesteps")
    i("DomainOverDecompositionFactor", OPTIONAL, -1, "Subdomains per rank")
    d("RandomParticleOffset", OPTIONAL, 8.0,
      "Random box shift per decomposition, PM-cell fractions")
    i("DomainUseGlobalSorting", OPTIONAL, 1, "Global sort for domains")

    d("ErrTolIntAccuracy", OPTIONAL, 0.02, "Gravity timestep accuracy eta")
    d("ErrTolForceAcc", OPTIONAL, 0.002, "Tree force relative accuracy")
    d("BHOpeningAngle", OPTIONAL, 0.175, "Barnes-Hut opening angle")
    d("MaxBHOpeningAngle", OPTIONAL, 0.9, "Max BH opening angle")
    d("TreeRcut", OPTIONAL, 6, "Short-range cutoff in Asmth units")
    i("TreeUseBH", OPTIONAL, 2, "1: BH criterion; 2: BH on first step only")
    i("SplitGravityTimestepsOn", OPTIONAL, 1, "Hierarchical gravity stepping")

    d("Asmth", OPTIONAL, 1.5, "Force split scale in mesh cells")
    i("Nmesh", OPTIONAL, -1, "PM grid size")
    e("ShortRangeForceWindowType", SHORTRANGE_FORCE_WINDOW, OPTIONAL,
      "exact", "Short-range window: exact or erfc")

    d("MinGasHsmlFractional", OPTIONAL, 0, "Min gas Hsml / softening")
    d("MaxGasVel", OPTIONAL, 3e5, "Max gas velocity km/s")
    d("MaxSizeTimestep", OPTIONAL, 0.1, "Max PM timestep (delta-a)")
    d("MinSizeTimestep", OPTIONAL, 0, "Min PM timestep")
    i("ForceEqualTimesteps", OPTIONAL, 0, "All timesteps equal to smallest")
    d("MaxRMSDisplacementFac", OPTIONAL, 0.2, "PM step RMS-displacement cap")
    d("ArtBulkViscConst", OPTIONAL, 0.75, "SPH artificial viscosity")
    d("CourantFac", OPTIONAL, 0.15, "Courant factor")
    d("DensityResolutionEta", OPTIONAL, 1.0, "SPH resolution eta (Price 08)")
    d("DensityContrastLimit", OPTIONAL, 100, "Max density contrast, P-E SPH")
    d("MaxNumNgbDeviation", OPTIONAL, 2, "Neighbour count tolerance")
    d("HydroCostFactor", OPTIONAL, 1, "Unused")

    i("BytesPerFile", OPTIONAL, 1024 * 1024 * 1024, "Bytes per output file")
    i("NumWriters", OPTIONAL, 0, "Max concurrent writers")
    i("MinNumWriters", OPTIONAL, 1, "Min concurrent writers")
    i("WritersPerFile", OPTIONAL, 8, "Writer groups per file")
    i("EnableAggregatedIO", OPTIONAL, 1, "Aggregate small IO")
    i("AggregatedIOThreshold", OPTIONAL, 256, "Aggregated IO max MB")

    # Cooling
    i("CoolingOn", REQUIRED, 0, "Enables cooling")
    s("TreeCoolFile", OPTIONAL, "", "Path to UVB table")
    s("MetalCoolFile", OPTIONAL, "", "Path to metal cooling table")
    s("ReionHistFile", OPTIONAL, "", "HeIII reionization history table")
    s("UVFluctuationFile", OPTIONAL, "", "UV fluctuation table")
    d("HIReionTemp", OPTIONAL, 0, "Temperature boost at HI reionization")
    d("UVRedshiftThreshold", OPTIONAL, -1.0, "Earliest UVB redshift")
    e("CoolingRates", COOLING_TYPES, OPTIONAL, "Sherwood", "Cooling table")
    e("RecombRates", RECOMB_TYPES, OPTIONAL, "Verner96", "Recomb table")
    i("SelfShieldingOn", OPTIONAL, 1, "Rahmati-Schaye self-shielding")
    d("PhotoIonizeFactor", OPTIONAL, 1, "Scale TreeCool by this")
    i("PhotoIonizationOn", OPTIONAL, 1, "Enable photoionization")

    i("HydroOn", OPTIONAL, 1, "Enables hydro force")
    i("DensityOn", OPTIONAL, 1, "Enables SPH density")
    i("DensityIndependentSphOn", REQUIRED, 1, "Pressure-entropy SPH")
    i("LightconeOn", OPTIONAL, 0, "Enables lightcone output")
    i("TreeGravOn", OPTIONAL, 1, "Enables tree gravity")
    i("RadiationOn", OPTIONAL, 1, "Radiation in background evolution")
    i("FastParticleType", OPTIONAL, 2, "Type exempt from PM timestep")
    d("PairwiseActiveFraction", OPTIONAL, 0, "Pairwise gravity threshold")
    d("GravitySoftening", OPTIONAL, 1.0 / 30.0,
      "Softening in units of mean DM separation")
    i("GravitySofteningGas", OPTIONAL, 1, "Unused")

    d("ImportBufferBoost", OPTIONAL, 2.0, "Treewalk import buffer factor")
    d("PartAllocFactor", OPTIONAL, 1.5, "Particle over-allocation")
    d("TopNodeAllocFactor", OPTIONAL, 0.5, "TopNode allocation factor")
    d("SlotsIncreaseFactor", OPTIONAL, 0.01, "Slot growth factor")

    d("InitGasTemp", OPTIONAL, -1, "Initial gas temperature")
    d("MinGasTemp", OPTIONAL, 5, "Minimum gas temperature")
    i("ParticlesAlwaysSorted", OPTIONAL, 0, "Peano-sort after exchange")

    i("SnapshotWithFOF", REQUIRED, 0, "Enable FOF halo finder")
    i("FOFPrimaryLinkTypes", OPTIONAL, 2, "Primary FOF type mask")
    i("FOFSecondaryLinkTypes", OPTIONAL, 1 + 16 + 32, "Secondary type mask")
    i("FOFSaveParticles", OPTIONAL, 1, "Save particles in FOF catalog")
    d("FOFHaloLinkingLength", OPTIONAL, 0.2, "FOF linking length")
    i("FOFHaloMinLength", OPTIONAL, 32, "Min particles per halo")
    d("MinFoFMassForNewSeed", OPTIONAL, 2, "Min halo mass for BH seed")
    d("MinMStarForNewSeed", OPTIONAL, 5e-4, "Min stellar mass for BH seed")
    d("TimeBetweenSeedingSearch", OPTIONAL, 1.04, "Seeding cadence factor")

    # Black holes
    i("BlackHoleOn", REQUIRED, 1, "Enable black holes")
    i("MetalReturnOn", REQUIRED, 1, "Enable metal return")
    d("BlackHoleAccretionFactor", OPTIONAL, 100, "Bondi boost factor")
    d("BlackHoleEddingtonFactor", OPTIONAL, 2.1, "Eddington cap factor")
    d("SeedBlackHoleMass", OPTIONAL, 2e-5, "BH seed mass")
    d("MaxSeedBlackHoleMass", OPTIONAL, 0, "Upper limit power-law seed mass")
    d("SeedBlackHoleMassIndex", OPTIONAL, -2, "Seed mass power-law index")
    d("BlackHoleNgbFactor", OPTIONAL, 2, "BH neighbour number factor")
    d("BlackHoleMaxAccretionRadius", OPTIONAL, 99999.0, "No effect")
    d("BlackHoleFeedbackFactor", OPTIONAL, 0.05, "Thermal feedback fraction")
    d("BlackHoleFeedbackRadius", OPTIONAL, 0, "No effect")
    i("BlackHoleRepositionEnabled", OPTIONAL, 0, "Reposition to potential min")
    i("BlackHoleKineticOn", OPTIONAL, 0, "AGN kinetic feedback")
    d("BHKE_EddingtonThrFactor", OPTIONAL, 0.05, "Kinetic Eddington thresh")
    d("BHKE_EddingtonMFactor", OPTIONAL, 0.002, "Mbh-dep Eddington factor")
    d("BHKE_EddingtonMPivot", OPTIONAL, 0.05, "Mbh pivot")
    d("BHKE_EddingtonMIndex", OPTIONAL, 2, "Mbh power-law index")
    d("BHKE_EffRhoFactor", OPTIONAL, 0.05, "Kinetic efficiency factor 1")
    d("BHKE_EffCap", OPTIONAL, 0.05, "Kinetic efficiency cap")
    d("BHKE_InjEnergyThr", OPTIONAL, 5, "Min kinetic injection energy")
    d("BlackHoleFeedbackRadiusMaxPhys", OPTIONAL, 0, "Unused")
    i("WriteBlackHoleDetails", OPTIONAL, 1, "Output BH details per step")
    i("MaxBlackHoleDetails", OPTIONAL, 50, "Max GB of BH details per file")
    i("BH_DynFrictionMethod", OPTIONAL, 1, "DF source: 1 stars 2 +DM 3 all")
    i("BH_DFBoostFactor", OPTIONAL, 1, "DF boost factor")
    d("BH_DFbmax", OPTIONAL, 20, "DF max impact parameter, pkpc")
    i("BH_DRAG", OPTIONAL, 1, "BH drag force")
    i("MergeGravBound", OPTIONAL, 1, "Gravitational-bound merge check")
    d("SeedBHDynMass", OPTIONAL, -1, "Initial BH dynamic mass")
    e("BlackHoleFeedbackMethod", BH_FEEDBACK_METHODS, OPTIONAL,
      "spline, mass", "BH feedback weighting flags")

    # Star formation
    i("StarformationOn", REQUIRED, 0, "Enables star formation")
    i("WindOn", REQUIRED, 0, "Enables wind feedback")
    e("StarformationCriterion", SFR_CRITERION, OPTIONAL, "density",
      "Star formation criteria flags")
    d("CritOverDensity", OPTIONAL, 57.7, "SF overdensity threshold")
    d("CritPhysDensity", OPTIONAL, 0, "SF physical density, protons/cm^3")
    i("BoostSFDenseGas", OPTIONAL, 1, "Reduce sfr timescale in dense gas")
    d("BoostSFOverDenseFactor", OPTIONAL, 1000, "Dense boost threshold")
    i("BHFeedbackUseTcool", OPTIONAL, 1, "BH feedback / SFR interaction")
    d("FactorSN", OPTIONAL, 0.1, "SN energy fraction (SH03 beta)")
    d("FactorEVP", OPTIONAL, 1000, "SH03 evaporation factor A0")
    d("TempSupernova", OPTIONAL, 1e8, "SN remnant temperature K")
    d("TempClouds", OPTIONAL, 1000, "Cold cloud temperature K")
    d("MaxSfrTimescale", OPTIONAL, 1.5, "Max SF timescale t0")
    i("Generations", OPTIONAL, 4, "Stars per gas particle")
    e("WindModel", WIND_MODELS, OPTIONAL, "ofjt10", "Wind model flags")
    d("WindEfficiency", OPTIONAL, 2.0, "Wind mass loading (sh03/vs08)")
    d("WindEnergyFraction", OPTIONAL, 1.0, "Wind energy fraction")
    d("WindSigma0", OPTIONAL, 353, "Wind energy ejection sqrt rate, km/s")
    d("WindSpeedFactor", OPTIONAL, 3.7, "Wind speed / local sigma")
    d("WindFreeTravelLength", OPTIONAL, 20, "Wind decoupling distance")
    d("WindFreeTravelDensFac", OPTIONAL, 0.1, "Recoupling density factor")
    d("MinWindVelocity", OPTIONAL, 0, "Min wind kick velocity")
    d("WindThermalFactor", OPTIONAL, 0, "Thermal fraction of wind energy")
    d("MaxWindFreeTravelTime", OPTIONAL, 60, "Max decoupled time, Myr")

    i("RandomSeed", OPTIONAL, 42, "RNG seed")

    # Lyman alpha / helium heating
    d("QuickLymanAlphaProbability", OPTIONAL, 0, "QuickLya SF probability")
    d("QuickLymanAlphaTempThresh", OPTIONAL, 1e5, "QuickLya temp threshold")
    d("HydrogenHeatAmp", OPTIONAL, 1, "Hydrogen heat boost")
    i("HeliumHeatOn", OPTIONAL, 0, "Helium reionization extra heating")
    d("HeliumHeatThresh", OPTIONAL, 10, "Density-indep heating threshold")
    d("HeliumHeatAmp", OPTIONAL, 1, "Heat amplitude")
    d("HeliumHeatExp", OPTIONAL, 0, "Heat density exponent")

    # QSO lightup helium reionization
    i("QSOLightupOn", OPTIONAL, 0, "Quasar HeII reionization model")
    d("QSOMaxMass", OPTIONAL, 1000, "Max QSO host halo mass")
    d("QSOMinMass", OPTIONAL, 100, "Min QSO host halo mass")
    d("QSOMeanBubble", OPTIONAL, 20000, "Mean QSO bubble size")
    d("QSOVarBubble", OPTIONAL, 0, "Bubble size variance")
    d("QSOHeIIIReionFinishFrac", OPTIONAL, 0.995, "Flash-reion fraction")

    # Metal return
    d("MetalsSn1aN0", OPTIONAL, 1.3e-3, "SN1a rate per Msun")
    d("MetalsMaxNgbDeviation", OPTIONAL, 5.0, "Metal ngb tolerance")
    i("MetalsSPHWeighting", OPTIONAL, 1, "SPH-kernel weighted return")

    # Massive neutrinos
    i("MassiveNuLinRespOn", REQUIRED, 0, "Linear-response neutrinos")
    i("HybridNeutrinosOn", OPTIONAL, 0, "Hybrid particle neutrinos")
    d("MNue", OPTIONAL, 0, "First neutrino mass, eV")
    d("MNum", OPTIONAL, 0, "Second neutrino mass, eV")
    d("MNut", OPTIONAL, 0, "Third neutrino mass, eV")
    d("Vcrit", OPTIONAL, 500.0, "Hybrid-nu critical velocity, km/s")
    d("NuPartTime", OPTIONAL, 0.3333333, "Hybrid-nu particle start time")

    # Excursion set reionization
    i("ExcursionSetReionOn", OPTIONAL, 0, "Excursion-set UVBG")
    i("UVBGdim", OPTIONAL, 64, "Excursion grid size")
    i("ReionFilterType", OPTIONAL, 0, "Excursion filter type")
    i("RtoMFilterType", OPTIONAL, 0, "R-to-M filter type")
    d("ReionRBubbleMax", OPTIONAL, 20340.0, "Max filter radius")
    d("ReionRBubbleMin", OPTIONAL, 406.8, "Min filter radius")
    d("ReionDeltaRFactor", OPTIONAL, 1.1, "Filter radius step")
    d("ReionGammaHaloBias", OPTIONAL, 2.0, "Halo bias for J21")
    d("ReionNionPhotPerBary", OPTIONAL, 4000.0, "Photons per stellar baryon")
    d("AlphaUV", OPTIONAL, 3.0, "UV spectral slope")
    d("EscapeFractionNorm", OPTIONAL, 0.2, "Escape fraction norm")
    d("EscapeFractionScaling", OPTIONAL, 0.5, "Escape fraction scaling")
    d("UVBGTimestep", OPTIONAL, 10.0, "Myr between UVBG calcs")
    i("ReionUseParticleSFR", OPTIONAL, 1,
      "J21 from per-particle SFR (else stellar mass / timescale)")
    d("ReionSFRTimescale", OPTIONAL, 0.5,
      "Stellar-mass SFR proxy timescale, Hubble times")
    s("J21CoeffFile", OPTIONAL, "", "J21 rate coefficient table")
    d("ExcursionSetZStop", OPTIONAL, 5.0, "Excursion stop z")
    d("ExcursionSetZStart", OPTIONAL, 25.0, "Excursion start z")
    i("ReionUseParticleSFR", OPTIONAL, 0, "Use particle SFR in excursion")
    d("ReionSFRTimescale", OPTIONAL, 0.1, "Excursion SFR timescale")

    return ps


def create_genic_parameter_set() -> ParameterSet:
    from .utils import constants as C
    ps = ParameterSet()
    d, i, s = ps.declare_double, ps.declare_int, ps.declare_string

    s("FileWithInputSpectrum", REQUIRED, help="Input power spectrum file")
    s("OutputDir", REQUIRED, help="IC output directory")
    s("FileBase", REQUIRED, help="IC file name")
    d("Omega0", REQUIRED, 0.2814, "Total matter density")
    d("OmegaBaryon", REQUIRED, 0.0464, "Baryon density")
    d("OmegaLambda", REQUIRED, 0.7186, "Dark energy density")
    d("HubbleParam", REQUIRED, 0.697, "Hubble parameter")
    i("ProduceGas", REQUIRED, 0, "Create baryon particles")
    d("BoxSize", REQUIRED, 0, "Box size, internal units")
    d("Redshift", REQUIRED, 99, "Starting redshift")
    i("Nmesh", OPTIONAL, 0, "FFT grid for displacements")
    i("Ngrid", REQUIRED, 0, "CDM particle grid")
    i("NgridGas", OPTIONAL, -1, "Gas particle grid")
    i("NgridNu", OPTIONAL, 0, "Neutrino particle grid")
    i("Seed", REQUIRED, 0, "RNG seed for gaussian phases")
    i("MakeGlassGas", OPTIONAL, -1, "Glass IC for gas")
    i("MakeGlassCDM", OPTIONAL, 0, "Glass IC for CDM")
    i("UnitaryAmplitude", OPTIONAL, 1, "Unitary gaussian amplitudes")
    i("WhichSpectrum", OPTIONAL, 2, "Spectrum type, 2=file")
    d("Omega_fld", OPTIONAL, 0, "Dark energy fluid density")
    d("w0_fld", OPTIONAL, -1.0, "DE equation of state")
    d("wa_fld", OPTIONAL, 0, "DE evolution")
    d("Omega_ur", OPTIONAL, 0, "Extra radiation")
    i("CLASS_Radiation", OPTIONAL, 0, "CLASS radiation convention")
    d("MNue", OPTIONAL, 0, "Neutrino mass 1, eV")
    d("MNum", OPTIONAL, 0, "Neutrino mass 2, eV")
    d("MNut", OPTIONAL, 0, "Neutrino mass 3, eV")
    d("MWDM_therm", OPTIONAL, 0, "WDM thermal velocity mass, keV")
    d("Max_nuvel", OPTIONAL, 5000, "Max sampled neutrino velocity")
    i("DifferentTransferFunctions", OPTIONAL, 1, "Per-species transfers")
    i("ScaleDepVelocity", OPTIONAL, -1, "Scale-dependent velocities")
    s("FileWithTransferFunction", OPTIONAL, "", "CLASS transfer file")
    d("MaxMemSizePerNode", OPTIONAL, 0.6, "Max memory per node")
    d("CMBTemperature", OPTIONAL, 2.7255, "CMB temperature K")
    d("RadiationOn", OPTIONAL, 1, "Radiation in background")
    i("UsePeculiarVelocity", OPTIONAL, 1, "Peculiar velocities in output")
    i("SavePrePos", OPTIONAL, 1, "Save pre-displacement positions")
    i("InvertPhase", OPTIONAL, 0, "Flip phase for paired sims")
    i("PrePosGridCenter", OPTIONAL, 0, "Pre-pos at grid centers")
    i("ShowBacktrace", OPTIONAL, 1, "Backtrace on crash")
    d("PrimordialAmp", OPTIONAL, 2.215e-9, "Used by CLASS script only")
    d("Sigma8", OPTIONAL, -1, "Renormalize sigma8 if positive")
    d("InputPowerRedshift", OPTIONAL, -1, "Redshift of input power")
    d("PrimordialIndex", OPTIONAL, 0.971, "Spectral tilt")
    d("PrimordialRunning", OPTIONAL, 0, "Spectral running")
    d("UnitVelocity_in_cm_per_s", OPTIONAL, 1e5, "Velocity unit")
    d("UnitLength_in_cm", OPTIONAL, C.CM_PER_MPC / 1000, "Length unit")
    d("UnitMass_in_g", OPTIONAL, 1.989e43, "Mass unit")
    i("NumPartPerFile", OPTIONAL, 1024 * 1024 * 128, "Particles per file")
    i("NumWriters", OPTIONAL, 0, "Concurrent writers")
    return ps


def parse_output_list(text: str):
    """Comma-separated list of output scale factors
    (BuildOutputList, timebinmgr.c)."""
    return sorted(float(t) for t in text.replace(",", " ").split())
