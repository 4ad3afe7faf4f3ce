"""MP-Gadget equivalent CLI on one CUDA device (PyTorch port of
mpgadget_tpu/main.py).

Usage: python -m mpgadget_tpu_torch.main <paramfile> [RestartFlag [SnapNum]]
(gadget/main.c:56-68).  RestartFlag: omitted = start from IC; 1 = resume
from the last snapshot in Snapshots.txt; 2 <num> = restart from snapshot
num; 3 <num> = FOF halo catalogue (PIG_<num>) of snapshot num; 4 <num> =
measure power spectrum; 99 [num] = force-accuracy self-test (the tree
force against direct summation) of the IC, or of snapshot num.

Several ranks: ``python -m torch.distributed.run --nproc_per_node N -m
mpgadget_tpu_torch.main <paramfile>`` runs the sharded driver
(Simulation.run_sharded), one rank per card over NCCL.  MPG_SHARDED=1
runs it on one rank too, MPG_SHARDED=0 runs the single-device loop;
MPG_DIST_BACKEND=gloo puts the ranks on gloo instead (for example several
ranks that share one card).
"""

import atexit
import os
import sys

import torch

from .params import create_gadget_parameter_set, parse_output_list
from .timeline import Timeline
from .timestep import TimestepParams
from .run import Simulation
from .utils import get_unitsystem


def build_simulation(paramfile_or_ps, override=None, snapshot=None,
                     device="cuda"):
    """Parse the parameters, read the IC/snapshot and build a
    :class:`Simulation` whose tensors live on ``device``."""
    if isinstance(paramfile_or_ps, str):
        ps = create_gadget_parameter_set()
        ps.parse_file(paramfile_or_ps)
    else:
        ps = paramfile_or_ps
    for k, v in (override or {}).items():
        ps.set(k, v)

    ic_path = snapshot if snapshot is not None else ps["InitCondFile"]
    outputs = parse_output_list(ps["OutputList"])

    # Peek at the header for TimeIC / Nmesh defaults
    from .io.bigfile import BigFile
    from .io import snapshot as snap_io
    header = snap_io.read_header(BigFile(ic_path))
    time_ic = header.TimeIC if header.TimeIC > 0 else header.Time

    nmesh = ps["Nmesh"]
    if nmesh <= 0:
        # Nmesh default: 2x the cube root of particle number
        npart = int(header.TotNumPart.sum())
        ng = round(npart ** (1.0 / 3))
        nmesh = 2 * ng

    timeline = Timeline(outputs, TimeIC=header.Time,
                        TimeMax=ps["TimeMax"],
                        SnapshotWithFOF=bool(ps["SnapshotWithFOF"]))
    tsp = TimestepParams(
        ErrTolIntAccuracy=ps["ErrTolIntAccuracy"],
        CourantFac=ps["CourantFac"],
        MaxRMSDisplacementFac=ps["MaxRMSDisplacementFac"],
        MaxSizeTimestep=ps["MaxSizeTimestep"],
        MinSizeTimestep=ps["MinSizeTimestep"],
        ForceEqualTimesteps=bool(ps["ForceEqualTimesteps"]))

    cfg_kwargs = dict(
        nmesh=nmesh, output_dir=ps["OutputDir"], timeline=timeline,
        asmth=ps["Asmth"], snapshot_base=ps["SnapshotFileBase"],
        fast_particle_type=ps["FastParticleType"],
        tree_grav_on=bool(ps["TreeGravOn"]), rcut=ps["TreeRcut"],
        split_gravity_timesteps=bool(ps["SplitGravityTimestepsOn"]),
        gravity_softening=ps["GravitySoftening"],
        err_tol_force_acc=ps["ErrTolForceAcc"],
        bh_opening_angle=ps["BHOpeningAngle"],
        max_bh_opening_angle=ps["MaxBHOpeningAngle"],
        tree_use_bh=ps["TreeUseBH"],
        hydro_on=bool(ps["HydroOn"]),
        density_independent_sph=bool(ps["DensityIndependentSphOn"]),
        density_kernel_type=ps["DensityKernelType"],
        density_resolution_eta=ps["DensityResolutionEta"],
        max_numngb_deviation=ps["MaxNumNgbDeviation"],
        art_bulk_visc=ps["ArtBulkViscConst"],
        density_contrast_limit=ps["DensityContrastLimit"],
        init_gas_temp=ps["InitGasTemp"],
        min_gas_temp=ps["MinGasTemp"],
        min_gas_hsml_fractional=ps["MinGasHsmlFractional"],
        cooling_on=bool(ps["CoolingOn"]),
        treecool_file=ps["TreeCoolFile"],
        metal_cool_file=ps["MetalCoolFile"],
        uv_fluctuation_file=ps["UVFluctuationFile"],
        cooling_rates=ps["CoolingRates"],
        recomb_rates=ps["RecombRates"],
        self_shielding_on=bool(ps["SelfShieldingOn"]),
        photo_ionize_factor=ps["PhotoIonizeFactor"],
        photo_ionization_on=bool(ps["PhotoIonizationOn"]),
        excursion_set_on=bool(ps["ExcursionSetReionOn"]),
        uvbg_dim=ps["UVBGdim"],
        reion_filter_type=ps["ReionFilterType"],
        rtom_filter_type=ps["RtoMFilterType"],
        reion_r_bubble_max=ps["ReionRBubbleMax"],
        reion_r_bubble_min=ps["ReionRBubbleMin"],
        reion_delta_r_factor=ps["ReionDeltaRFactor"],
        reion_nion_phot_per_bary=ps["ReionNionPhotPerBary"],
        alpha_uv=ps["AlphaUV"],
        escape_fraction_norm=ps["EscapeFractionNorm"],
        escape_fraction_scaling=ps["EscapeFractionScaling"],
        uvbg_timestep_myr=ps["UVBGTimestep"],
        reion_use_particle_sfr=bool(ps["ReionUseParticleSFR"]),
        reion_sfr_timescale=ps["ReionSFRTimescale"],
        excursion_set_zstart=ps["ExcursionSetZStart"],
        excursion_set_zstop=ps["ExcursionSetZStop"],
        qso_lightup_on=bool(ps["QSOLightupOn"]),
        reion_hist_file=ps["ReionHistFile"],
        qso_min_mass=ps["QSOMinMass"],
        qso_max_mass=ps["QSOMaxMass"],
        qso_mean_bubble=ps["QSOMeanBubble"],
        qso_var_bubble=ps["QSOVarBubble"],
        qso_finish_frac=ps["QSOHeIIIReionFinishFrac"],
        helium_heat_on=bool(ps["HeliumHeatOn"]),
        helium_heat_thresh=ps["HeliumHeatThresh"],
        helium_heat_amp=ps["HeliumHeatAmp"],
        helium_heat_exp=ps["HeliumHeatExp"],
        starformation_on=bool(ps["StarformationOn"]),
        metal_return_on=bool(ps["MetalReturnOn"]),
        metals_sn1a_n0=ps["MetalsSn1aN0"],
        metals_sph_weighting=ps["MetalsSPHWeighting"],
        metals_max_ngb_deviation=ps["MetalsMaxNgbDeviation"],
        part_alloc_factor=ps["PartAllocFactor"],
        bytes_per_file=ps["BytesPerFile"],
        plane_output_list=ps["PlaneOutputList"],
        plane_resolution=ps["PlaneResolution"],
        plane_thickness=ps["PlaneThickness"],
        plane_cut_points=ps["PlaneCutPoints"],
        plane_normals=ps["PlaneNormals"],
        plane_nu_correction=bool(ps["PlaneMassiveNuCorrection"]),
        plane_double_out=bool(ps["PlaneDoubleOut"]),
        lightcone_on=bool(ps["LightconeOn"]),
        wind_on=bool(ps["WindOn"]),
        sfr_criterion=ps["StarformationCriterion"],
        crit_overdensity=ps["CritOverDensity"],
        crit_phys_density=ps["CritPhysDensity"],
        factor_sn=ps["FactorSN"],
        factor_evp=ps["FactorEVP"],
        temp_supernova=ps["TempSupernova"],
        temp_clouds=ps["TempClouds"],
        max_sfr_timescale=ps["MaxSfrTimescale"],
        generations=ps["Generations"],
        quick_lya_probability=ps["QuickLymanAlphaProbability"],
        quick_lya_temp_thresh=ps["QuickLymanAlphaTempThresh"],
        wind_model=ps["WindModel"],
        wind_efficiency=ps["WindEfficiency"],
        wind_energy_fraction=ps["WindEnergyFraction"],
        wind_sigma0=ps["WindSigma0"],
        wind_speed_factor=ps["WindSpeedFactor"],
        wind_free_travel_length=ps["WindFreeTravelLength"],
        wind_free_travel_dens_fac=ps["WindFreeTravelDensFac"],
        min_wind_velocity=ps["MinWindVelocity"],
        wind_thermal_factor=ps["WindThermalFactor"],
        max_wind_free_travel_time=ps["MaxWindFreeTravelTime"],
        random_seed=ps["RandomSeed"],
        random_particle_offset=ps["RandomParticleOffset"],
        massive_nu_lin_resp_on=bool(ps["MassiveNuLinRespOn"]),
        m_nu=(ps["MNue"], ps["MNum"], ps["MNut"]),
        hybrid_neutrinos_on=bool(ps["HybridNeutrinosOn"]),
        hybrid_vcrit=ps["Vcrit"],
        hybrid_nu_part_time=ps["NuPartTime"],
        black_hole_on=bool(ps["BlackHoleOn"]),
        bh_accretion_factor=ps["BlackHoleAccretionFactor"],
        bh_eddington_factor=ps["BlackHoleEddingtonFactor"],
        bh_feedback_factor=ps["BlackHoleFeedbackFactor"],
        bh_seed_mass=ps["SeedBlackHoleMass"],
        bh_ngb_factor=ps["BlackHoleNgbFactor"],
        min_fof_mass_for_seed=ps["MinFoFMassForNewSeed"],
        min_mstar_for_seed=ps["MinMStarForNewSeed"],
        time_between_seeding=ps["TimeBetweenSeedingSearch"],
        bh_kinetic_on=bool(ps["BlackHoleKineticOn"]),
        bh_merge_grav_bound=bool(ps["MergeGravBound"]),
        bh_dynfric_method=ps["BH_DynFrictionMethod"],
        bh_df_boost=float(ps["BH_DFBoostFactor"]),
        bh_df_bmax=ps["BH_DFbmax"],
        bhke_eddington_thr_factor=ps["BHKE_EddingtonThrFactor"],
        bhke_eddington_m_factor=ps["BHKE_EddingtonMFactor"],
        bhke_eddington_m_pivot=ps["BHKE_EddingtonMPivot"],
        bhke_eddington_m_index=ps["BHKE_EddingtonMIndex"],
        bhke_eff_rho_factor=ps["BHKE_EffRhoFactor"],
        bhke_eff_cap=ps["BHKE_EffCap"],
        bhke_inj_energy_thr=ps["BHKE_InjEnergyThr"],
        seed_bh_dyn_mass=ps["SeedBHDynMass"],
        bh_reposition=bool(ps["BlackHoleRepositionEnabled"]),
        write_bh_details=bool(ps["WriteBlackHoleDetails"]),
        time_limit_cpu=ps["TimeLimitCPU"],
        auto_snapshot_time=ps["AutoSnapshotTime"],
        output_energy_debug=bool(ps["OutputEnergyDebug"]),
        output_potential=bool(ps["OutputPotential"]),
        snapshot_with_fof=bool(ps["SnapshotWithFOF"]),
        fof_file_base=ps["FOFFileBase"],
        fof_save_particles=bool(ps["FOFSaveParticles"]),
        fof_linking_length=ps["FOFHaloLinkingLength"],
        fof_min_group_length=ps["FOFHaloMinLength"],
        fof_primary_link_types=ps["FOFPrimaryLinkTypes"],
        fof_secondary_link_types=ps["FOFSecondaryLinkTypes"],
        timestep=tsp,
        units=get_unitsystem(header.UnitLength_in_cm,
                             header.UnitMass_in_g,
                             header.UnitVelocity_in_cm_per_s))
    sim = Simulation.from_snapshot(ic_path, cfg_kwargs, device=device)
    return sim, ps


CPU_TIMEOUT = 600.0     # seconds, the gloo group's on the CPU


def init_distributed(device="cuda"):
    """Join the process group that ``torch.distributed.run`` describes
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT; the reference's
    MPI_Init), and return this rank's device.

    On the card the backend is NCCL, one rank per card on cuda:LOCAL_RANK;
    more ranks than visible cards raise, as NCCL refuses two ranks on one
    card.  gloo is used only when asked for: device="cpu" (every rank on
    the CPU), or MPG_DIST_BACKEND=gloo on the card, where ranks then share
    the cards (cuda:LOCAL_RANK mod the card count).  Without torchrun's
    environment, or when the group is up already, nothing is joined.
    Rank 0 prints the backend."""
    from .parallel import collectives as coll
    from .utils.log import message
    dev = torch.device(device)
    if coll.is_initialized():
        return _rank_device(dev)
    if "WORLD_SIZE" not in os.environ:
        return dev
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    backend = os.environ.get("MPG_DIST_BACKEND", "")
    if dev.type == "cpu":
        if backend not in ("", "gloo"):
            raise ValueError(f"backend {backend} cannot run on the CPU")
        backend = "gloo"
    elif backend in ("", "nccl"):
        backend = "nccl"
        ncard = torch.cuda.device_count()
        if world > ncard:
            raise RuntimeError(
                f"NCCL: {world} ranks but {ncard} visible card(s); NCCL "
                "runs one rank per card (MPG_DIST_BACKEND=gloo shares "
                "cards)")
    elif backend != "gloo":
        raise ValueError(f"unknown MPG_DIST_BACKEND {backend!r}")
    if dev.type == "cuda":
        dev = torch.device("cuda", local % max(torch.cuda.device_count(), 1))
        torch.cuda.set_device(dev)
    # on the CPU a rank waits at most MPG_DIST_TIMEOUT seconds (default
    # CPU_TIMEOUT) in the rendezvous or a collective, then raises; on the
    # card torch.distributed's default holds
    timeout = os.environ.get("MPG_DIST_TIMEOUT") or (
        CPU_TIMEOUT if dev.type == "cpu" else None)
    coll.init_process_group(
        backend,
        f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        world, rank, timeout=None if timeout is None else float(timeout))
    # leave the group before the interpreter exits: a gloo group torn down
    # by the exit itself can abort the process (SIGABRT, "terminate called
    # without an active exception") once its run has ended
    atexit.register(coll.destroy_process_group)
    message(f"[distributed] backend {backend}, {world} rank(s), rank 0 on "
            f"{dev}")
    return dev


def _rank_device(dev):
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def device_mesh_or_none(device):
    """The dispatch rule of the JAX package (main.py:229-243): more than
    one rank, or MPG_SHARDED=1, runs the sharded driver on the ranks'
    ShardMesh; MPG_SHARDED=0, or one rank without it, runs the
    single-device loop (None)."""
    from .parallel import collectives as coll
    from .parallel.mesh import ShardMesh
    force = os.environ.get("MPG_SHARDED", "")
    if coll.is_initialized():
        rank, size, backend = coll.world()
    else:
        rank, size, backend = 0, 1, "none"
    if force == "0" or (size == 1 and force != "1"):
        return None
    return ShardMesh(rank=rank, size=size,
                     device=_rank_device(torch.device(device)),
                     backend=str(backend))


def run_cli(paramfile, restart=0, snapnum=None, device="cuda"):
    """What ``main`` does for a paramfile and RestartFlag, on ``device``.
    A resumed run (flags 1 and 2) numbers its snapshots on from the one
    it started from (the reference's SnapshotFileCount), so that it
    writes no snapshot over an earlier one.  Under torch.distributed.run
    each rank joins the process group first (init_distributed) and the
    run dispatches as :func:`device_mesh_or_none` says."""
    device = init_distributed(device)
    if restart in (2, 3, 4) and snapnum is None:
        raise SystemExit("RestartFlag %d needs a snapshot number" % restart)
    snapshot = None
    if restart == 1 or (restart in (2, 3, 4, 99) and snapnum is not None):
        ps = create_gadget_parameter_set()
        ps.parse_file(paramfile)
        outdir = ps["OutputDir"]
        base = ps["SnapshotFileBase"]
        if restart == 1:
            with open(os.path.join(outdir, "Snapshots.txt")) as fh:
                snapnum = int(fh.read().split()[-2])
        snapshot = os.path.join(outdir, f"{base}_{snapnum:03d}")

    sim, ps = build_simulation(paramfile, snapshot=snapshot, device=device)
    if restart == 3:
        sim.run_fof(save=True, label=snapnum)
        return sim
    if restart == 99:
        sim.run_gravity_test()
        return sim
    if restart == 4:
        sim.compute_forces()
        D1 = sim.CP.GrowthFactor(sim.atime, 1.0)
        print(sim.last_power.save(sim.cfg.output_dir, sim.atime, D1))
        return sim
    if restart in (1, 2):
        sim.snapshot_count = snapnum + 1
    mesh = device_mesh_or_none(device)
    if mesh is not None:
        # SplitGravityTimestepsOn routes to the hierarchical substeps
        sim.run_sharded(mesh, hierarchical=bool(
            sim.cfg.split_gravity_timesteps and sim.cfg.tree_grav_on))
    else:
        sim.run()
    return sim


def main():
    if len(sys.argv) < 2:
        print(__doc__)
        sys.exit(1)
    restart = int(sys.argv[2]) if len(sys.argv) > 2 else 0
    snapnum = int(sys.argv[3]) if len(sys.argv) > 3 else None
    if not torch.cuda.is_available():
        raise SystemExit("mpgadget_tpu_torch.main needs a CUDA device")
    from .parallel import collectives as coll
    try:
        run_cli(sys.argv[1], restart, snapnum, device="cuda")
    finally:
        coll.destroy_process_group()


if __name__ == "__main__":
    main()
