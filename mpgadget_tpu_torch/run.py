"""Simulation driver: begrun/run analog (libgadget/run.c), PyTorch port of
the TreePM, SPH and galaxy-formation parts of mpgadget_tpu/run.py.

One device, a power-of-two quantized PM timestep, KDK integration with
exact FLRW factors, TreePM forces, with HydroOn the SPH density and hydro
force loops (sph/density.py, sph/hydra.py) for the gas, with CoolingOn
and StarformationOn the gas source terms (physics/cooling.py, the cooling
kernel K6; physics/sfr.py: the effective EOS, star particles, quick
Lyman-alpha conversion; ``sfr.txt``), with WindOn galactic winds
(physics/winds.py: the subgrid kicks, or the kicks of new stars' gas
neighbours scaled by the DM velocity dispersion), with MetalReturnOn the
stars' mass and metal return (physics/metal_return.py), with BlackHoleOn
black holes (physics/blackhole.py: Bondi accretion, swallowing, feedback,
mergers, FOF seeding; ``blackholes.txt`` and BlackholeDetails), in-line
power spectra, snapshot output at sync points and, with SnapshotWithFOF, a
friends-of-friends halo catalogue (PIG) beside each snapshot
(:meth:`Simulation.run_fof`).  The
dark-matter options run too: massive neutrinos in linear response
(physics/neutrinos_lra.py, a multiplier of the PM modes) and hybrid
neutrino particles, the past light cone (physics/lightcone.py), lensing
potential planes (physics/plane.py), OutputEnergyDebug (``energy.txt``
and the state checks) and the force-accuracy self-test of RestartFlag 99
(:meth:`Simulation.run_gravity_test`).  The PM step is either one global
KDK step or, with SplitGravityTimestepsOn, sub-cycled over per-particle
power-of-two timebins whose short-range and hydro forces and gas source
terms are computed for the closing set only
(:meth:`Simulation.step_hierarchical`); black holes and metal return then
run once per PM step.  The cooling may read a metal-line cooling table
(MetalCoolFile) and gate the UV background by a reionization-redshift grid
(UVFluctuationFile); after each PM step QSO helium reionization
(QSOLightupOn: physics/qso_lightup.py, bubbles around FOF halos) and the
excursion-set UV background (ExcursionSetReionOn: physics/uvbg.py, J21
from filtered CIC grids, whose rates the cooling then uses during its
epoch) run as in the JAX package.
"""

import os
import time as _time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .cosmology import Cosmology
from .timeline import Timeline, get_timestep_bin
from .timefac import ExactTimeFactors
from .timestep import (TimestepParams, assign_particle_bins,
                       get_long_range_timestep_dloga, get_pm_timestep_ti)
from .particles import ParticleData, fixed_to_pos, pos_to_fixed
from .pm import pm_force, PMConfig
from .integrate import drift, kick, MASK32
from .io.bigfile import BigFile
from .io import snapshot as snap_io
from .utils import get_unitsystem
from .utils.walltime import WallTime


@dataclass
class SimConfig:
    boxsize: float
    nmesh: int
    output_dir: str
    timeline: Timeline
    units: object
    asmth: float = 1.5
    snapshot_base: str = "PART"
    fast_particle_type: int = 2
    tree_grav_on: bool = True
    split_gravity_timesteps: bool = False  # per-bin sub-cycling
    rcut: float = 6.0
    gravity_softening: float = 1.0 / 30.0  # of mean DM separation
    err_tol_force_acc: float = 0.002
    bh_opening_angle: float = 0.175
    max_bh_opening_angle: float = 0.9
    tree_use_bh: int = 2
    # hydro
    hydro_on: bool = True
    density_independent_sph: bool = True
    density_kernel_type: int = 2      # quintic
    density_resolution_eta: float = 1.0
    max_numngb_deviation: float = 2.0
    art_bulk_visc: float = 0.75
    density_contrast_limit: float = 100.0
    init_gas_temp: float = -1.0
    min_gas_temp: float = 5.0
    min_gas_hsml_fractional: float = 0.0
    # cooling
    cooling_on: bool = False
    treecool_file: str = ""
    metal_cool_file: str = ""
    uv_fluctuation_file: str = ""
    cooling_rates: int = 2        # Sherwood
    recomb_rates: int = 1         # Verner96
    self_shielding_on: bool = True
    photo_ionize_factor: float = 1.0
    photo_ionization_on: bool = True
    helium_heat_on: bool = False
    helium_heat_thresh: float = 10.0
    helium_heat_amp: float = 1.0
    helium_heat_exp: float = 0.0
    # excursion-set reionization (uvbg.c)
    excursion_set_on: bool = False
    uvbg_dim: int = 64
    reion_filter_type: int = 0
    rtom_filter_type: int = 0
    reion_r_bubble_max: float = 20340.0
    reion_r_bubble_min: float = 406.8
    reion_delta_r_factor: float = 1.1
    reion_nion_phot_per_bary: float = 4000.0
    alpha_uv: float = 3.0
    escape_fraction_norm: float = 0.2
    escape_fraction_scaling: float = 0.5
    uvbg_timestep_myr: float = 10.0
    excursion_set_zstart: float = 25.0
    excursion_set_zstop: float = 5.0
    # ReionUseParticleSFR / ReionSFRTimescale (uvbg.c:46-47): J21 from
    # the per-particle SFR deposit, or from stellar mass over a
    # fraction of the Hubble time
    reion_use_particle_sfr: bool = True
    reion_sfr_timescale: float = 0.5
    # QSO helium reionization (cooling_qso_lightup.c)
    qso_lightup_on: bool = False
    reion_hist_file: str = ""
    qso_min_mass: float = 100.0
    qso_max_mass: float = 1000.0
    qso_mean_bubble: float = 20000.0
    qso_var_bubble: float = 0.0
    qso_finish_frac: float = 0.995
    # star formation
    starformation_on: bool = False
    metal_return_on: bool = False
    metals_sn1a_n0: float = 1.3e-3
    metals_sph_weighting: int = 1
    metals_max_ngb_deviation: float = 5.0
    wind_on: bool = False
    sfr_criterion: int = 1
    crit_overdensity: float = 57.7
    crit_phys_density: float = 0.0
    factor_sn: float = 0.1
    factor_evp: float = 1000.0
    temp_supernova: float = 1e8
    temp_clouds: float = 1000.0
    max_sfr_timescale: float = 1.5
    generations: int = 4
    quick_lya_probability: float = 0.0
    quick_lya_temp_thresh: float = 1e5
    wind_model: int = 4 | 2   # ofjt10
    wind_efficiency: float = 2.0
    wind_energy_fraction: float = 1.0
    wind_sigma0: float = 353.0
    wind_speed_factor: float = 3.7
    wind_free_travel_length: float = 20.0
    wind_free_travel_dens_fac: float = 0.1
    min_wind_velocity: float = 0.0
    wind_thermal_factor: float = 0.0
    max_wind_free_travel_time: float = 60.0
    random_seed: int = 42
    random_particle_offset: float = 8.0  # max shift in PM cells
    # massive neutrinos (linear response)
    massive_nu_lin_resp_on: bool = False
    m_nu: tuple = (0.0, 0.0, 0.0)
    # hybrid neutrinos (cosmology.c:32-34, run.c:170-175): type-2
    # particles carry the slow F-D tail; before nu_part_time they are
    # passive tracers excluded from gravity sources and the PM force
    hybrid_neutrinos_on: bool = False
    hybrid_vcrit: float = 500.0
    hybrid_nu_part_time: float = 0.3333333
    # black holes
    black_hole_on: bool = False
    bh_accretion_factor: float = 100.0
    bh_eddington_factor: float = 2.1
    bh_feedback_factor: float = 0.05
    bh_seed_mass: float = 2e-5
    bh_ngb_factor: float = 2.0
    min_fof_mass_for_seed: float = 2.0
    min_mstar_for_seed: float = 5e-4
    time_between_seeding: float = 1.04
    bh_kinetic_on: bool = False
    bh_merge_grav_bound: bool = True
    bh_dynfric_method: int = 0
    bh_df_boost: float = 1.0
    bh_df_bmax: float = 20.0
    bhke_eddington_thr_factor: float = 0.05
    bhke_eddington_m_factor: float = 0.002
    bhke_eddington_m_pivot: float = 0.05
    bhke_eddington_m_index: float = 2.0
    bhke_eff_rho_factor: float = 0.05
    bhke_eff_cap: float = 0.05
    bhke_inj_energy_thr: float = 5.0
    seed_bh_dyn_mass: float = -1.0
    bh_reposition: bool = False
    write_bh_details: bool = False
    # control
    time_limit_cpu: float = 0.0
    auto_snapshot_time: float = 0.0
    output_energy_debug: bool = False
    # OutputPotential (params.py:95): write the Potential block in
    # snapshots; drives the sharded state's potential column so the
    # striped writer matches the single-writer block set
    output_potential: bool = True
    # FOF
    part_alloc_factor: float = 1.5
    bytes_per_file: int = 1 << 30      # output striping (BytesPerFile)
    # lensing potential planes (plane.c)
    plane_output_list: str = ""
    plane_resolution: int = 256
    plane_thickness: float = -1.0
    plane_cut_points: str = ""
    plane_normals: str = "0, 1, 2"
    plane_nu_correction: bool = True
    plane_double_out: bool = False
    lightcone_on: bool = False
    snapshot_with_fof: bool = False
    fof_file_base: str = "PIG"
    fof_save_particles: bool = True
    fof_linking_length: float = 0.2
    fof_min_group_length: int = 32
    fof_primary_link_types: int = 2
    fof_secondary_link_types: int = 1 + 16 + 32
    timestep: TimestepParams = field(default_factory=TimestepParams)


def check_supported(cfg: SimConfig, has_gas: bool):
    """Refuse a configuration the run could not complete, before it starts:
    QSOLightupOn with gas needs its ReionHistFile (the JAX package raises
    the same at the first PM step that reaches the lightup).  Every switch
    of the single-device JAX package is carried."""
    if has_gas and cfg.qso_lightup_on and not cfg.reion_hist_file:
        raise ValueError("QSOLightupOn needs ReionHistFile")


def check_sharded_supported(cfg: SimConfig, has_gas: bool):
    """Refuse, before the first step, what the sharded driver
    (Simulation.run_sharded) does not carry.  It carries every switch of
    the shipped examples: the gas (HydroOn), cooling with the tables it
    takes (TreeCoolFile, MetalCoolFile, UVFluctuationFile), star
    formation, the winds (sh03 in the step, vs08 and ofjt10 from the new
    stars' neighbours), black holes, metal return, QSO lightup, the
    excursion set, massive and hybrid neutrinos, the light cone and the
    lensing planes.  As the JAX package's run_sharded, it refuses winds
    without star formation or subgrid winds other than sh03's fixed
    efficiency, and metal return without star formation (star rows); the
    single-device run() carries those too."""
    from .physics import winds as windmod
    if has_gas and cfg.hydro_on and cfg.wind_on:
        subgrid = bool(cfg.wind_model & windmod.WIND_SUBGRID)
        if not cfg.starformation_on or (
                subgrid and not cfg.wind_model
                & windmod.WIND_FIXED_EFFICIENCY):
            raise ValueError(
                "WindOn needs StarformationOn in the sharded driver and, "
                "for subgrid winds, fixed efficiency (sh03), as in the JAX "
                "package's run_sharded; run other combinations with "
                "MPG_SHARDED=0 on one device")
    if has_gas and cfg.hydro_on and cfg.metal_return_on \
            and not cfg.starformation_on:
        raise ValueError("MetalReturnOn needs StarformationOn in the sharded "
                         "driver (star rows), as in the JAX package's "
                         "run_sharded; run it with MPG_SHARDED=0 on one "
                         "device")


class Simulation:
    def __init__(self, cosmology: Cosmology, pdata: ParticleData,
                 cfg: SimConfig, time_ic: float = None):
        self.CP = cosmology
        self.pdata = pdata
        self.device = pdata.device
        self.cfg = cfg
        self.timeline = cfg.timeline
        self.tf = ExactTimeFactors(cosmology, cfg.timeline)
        # The Gaussian split smoothing stays on even for PM-only runs
        # (see the JAX package): the tree supplies the part below it.
        self.pm_cfg = PMConfig(nmesh=cfg.nmesh, boxsize=cfg.boxsize,
                               asmth=cfg.asmth, G=cosmology.GravInternal,
                               unitlength_in_cm=cfg.units.UnitLength_in_cm)
        self.ti_current = 0
        self.time_ic = time_ic if time_ic is not None else \
            np.exp(cfg.timeline.loga_from_ti(0))
        self.snapshot_count = 0
        self.walltime = WallTime()
        self.last_power = None
        self.has_gas = bool(((pdata.ptype == 0) & pdata.valid).any())
        check_supported(cfg, self.has_gas)
        # SPH state (sph/state.SphData), set up by setup_gas or
        # _restore_gas when gas is present and HydroOn
        self.sph = None
        self.stars = None           # physics/stars.StarData, once stars exist
        self.bh = None              # physics/blackhole.BhData, once BHs exist
        self._cooling = None        # set up lazily by _init_cooling
        self._sfr = None            # and _init_sfr
        self._winds = None          # physics/winds.WindParams (WindOn)
        # the halo wind model's DM velocity dispersion per row, computed on
        # global steps (set to zeros by _init_sfr, as in the JAX package)
        self._vdisp = None
        self._age_table = None      # metal return, the excursion set's cadence
        self._star_hsml = None
        self._gas_initialized = False
        self._gas_restore = None
        self._min_egy_spec = 0.0
        self._omega_per_type = self._compute_omegas()
        self._tree_grav = None      # set up lazily when enabled
        # optional treepm.StageTimer handed to the tree force (per-stage
        # seconds; each stage then ends in a device synchronisation)
        self.tree_timer = None
        self.tree_force_calls = 0
        # short-range force targets summed over evaluations (all valid
        # particles per global step, the closing set per substep)
        self.force_evals = 0
        # one dict per hierarchical PM step: substeps, the bin histogram
        # at its start and the closing targets of each evaluation
        self.step_log = []
        # one entry per overflow retry: the capacities that overflowed
        self.tree_retries = []
        # random internal box shift (partmanager.h:79-84): decorrelates
        # Morton-tree force errors between steps; subtracted on output
        self._ipos_offset = np.zeros(3, np.uint32)
        self._nstep_total = 0
        # neutrino delta_tot history (physics/neutrinos_lra.DeltaTotTable),
        # made at the first PM step, and a snapshot's saved one
        self._nu_table_state = None
        self._nu_restore = None
        self._lightcone = None      # physics/lightcone.Lightcone
        # counts the smoke and the tests read: gas rows kicked by winds,
        # gas swallowed by BHs, BH mergers, BHs seeded at each FOF
        self.wind_kicks = 0
        self.bh_swallowed = 0
        self.bh_mergers = 0
        self.bh_seeded = []
        self._plane_times = None    # set by _ensure_plane_params
        self._uvf = None            # physics/cooling.UVFluctuationTable
        # excursion-set reionization (ExcursionSetReionOn): its parameters,
        # set at its first update, and the Myr of its last update (-1e30 in
        # a new or resumed run, as in the JAX package)
        self._uvbg_params = None
        self._uvbg_last_myr = -1e30
        self.uvbg_updates = []      # (z, vol xHI, mass xHI) per update
        # QSO lightup (QSOLightupOn): the HeII history and its parameters
        self._heii_hist = None
        self._qso_params = None
        self.qso_bubbles = []       # (a, bubbles) per PM step in its epoch

    # -- setup ---------------------------------------------------------

    @classmethod
    def from_snapshot(cls, path, cfg_kwargs, device="cuda"):
        """Read an IC/snapshot bigfile (petaio_read_snapshot analog)."""
        bf = BigFile(path)
        header = snap_io.read_header(bf)
        pos_all, vel_all, mass_all, type_all, id_all = [], [], [], [], []
        for ptype in range(6):
            sp = snap_io.read_species(bf, ptype, header)
            if sp is None:
                continue
            n = len(sp["pid"])
            pos_all.append(sp["pos"])
            vel_all.append(sp["vel"])
            mass_all.append(sp["mass"])
            type_all.append(np.full(n, ptype, np.int32))
            id_all.append(sp["pid"].astype(np.int64))
        pos = np.concatenate(pos_all)
        n_read = len(pos)
        # over-allocate rows for star spawning and BH seeding
        # (PartAllocFactor; slots_reserve analog), rounded up to a multiple
        # of 128 as in the JAX package
        alloc = float(cfg_kwargs.get("part_alloc_factor", 1.5))
        if not (cfg_kwargs.get("starformation_on")
                or cfg_kwargs.get("black_hole_on")):
            alloc = 1.0     # nothing spawns: no padding needed
        capacity = int(np.ceil(max(1.0, alloc) * n_read / 128)) * 128
        pdata = ParticleData.from_numpy(
            pos, np.concatenate(vel_all), np.concatenate(mass_all),
            np.concatenate(type_all), np.concatenate(id_all),
            header.BoxSize, capacity=capacity, device=device)
        units = get_unitsystem(header.UnitLength_in_cm,
                               header.UnitMass_in_g,
                               header.UnitVelocity_in_cm_per_s)
        cp = Cosmology(
            Omega0=header.Omega0, OmegaBaryon=header.OmegaBaryon,
            OmegaLambda=header.OmegaLambda,
            HubbleParam=header.HubbleParam,
            CMBTemperature=header.CMBTemperature,
            Omega_fld=header.Omega_fld, w0_fld=header.w0_fld,
            wa_fld=header.wa_fld, Omega_ur=header.Omega_ur,
            MNu=tuple(cfg_kwargs.get("m_nu", (0.0, 0.0, 0.0))),
            MassiveNuLinRespOn=bool(
                cfg_kwargs.get("massive_nu_lin_resp_on", False)),
            HybridNeutrinosOn=bool(
                cfg_kwargs.get("hybrid_neutrinos_on", False)),
            HybridVcrit=float(cfg_kwargs.get("hybrid_vcrit", 500.0)),
            HybridNuPartTime=float(
                cfg_kwargs.get("hybrid_nu_part_time", 0.3333333)),
            TimeBegin=header.Time,
        ).init_units(units)
        cfg_kwargs = dict(cfg_kwargs)
        cfg_kwargs["units"] = units
        cfg = SimConfig(boxsize=header.BoxSize, **cfg_kwargs)
        sim = cls(cp, pdata, cfg, time_ic=header.TimeIC or header.Time)
        sim._header = header
        # restore gas thermal state when present (restart path): every
        # registered gas block present is restored
        if int(header.TotNumPart[0]) > 0 and "0/InternalEnergy" in bf:
            sim._gas_restore = {
                "u": bf.open("0/InternalEnergy").read(),
                "density": bf.open("0/Density").read(),
                "hsml": bf.open("0/SmoothingLength").read(),
            }
            from .io.registry import blocks_for_type
            for spec in blocks_for_type(0):
                if spec.holder != "sph" or spec.wronly:
                    continue
                if "0/" + spec.name in bf:
                    sim._gas_restore[spec.field] = \
                        bf.open("0/" + spec.name).read()
        # star and BH slot state via the declarative registry
        # (petaio.c:1040-1069)
        from .io.registry import blocks_for_type
        for t in (4, 5):
            if int(header.TotNumPart[t]) > 0:
                sim._restore_slot_state(t, {
                    spec.name: bf.open(f"{t}/{spec.name}").read()
                    for spec in blocks_for_type(t)
                    if not spec.wronly and f"{t}/{spec.name}" in bf})
        # neutrino delta_tot history (petaio_read_neutrinos analog)
        if "Neutrino" in bf:
            sim._nu_restore = snap_io.read_neutrino_state(bf)
        return sim

    def _restore_slot_state(self, t, blocks):
        """Scatter the registry's star (t = 4) or BH (t = 5) blocks (name ->
        array, in snapshot order) into an aligned StarData or BhData."""
        from .io.registry import blocks_for_type
        from .physics.blackhole import BhData
        from .physics.stars import StarData
        rows = (self.pdata.valid & (self.pdata.ptype == t)).cpu().numpy()
        if not blocks or not rows.any():
            return
        holder = (StarData if t == 4 else BhData).zeros(
            self.pdata.capacity, self.device)
        updates = {}
        for spec in blocks_for_type(t):
            arr = blocks.get(spec.name)
            if arr is None:
                continue
            full = getattr(holder, spec.field).cpu().numpy().copy()
            full[rows] = np.asarray(arr).reshape(
                (-1,) + full.shape[1:]).astype(full.dtype)
            updates[spec.field] = torch.as_tensor(full, device=self.device)
        if t == 5 and "bh_mass" not in updates:
            # never leave restored BHs with zero subgrid mass: Bondi mdot ~
            # bh_mass^2 would stay 0 forever
            m = np.zeros(self.pdata.capacity, np.float32)
            m[rows] = self.cfg.bh_seed_mass
            updates["bh_mass"] = torch.as_tensor(m, device=self.device)
        if t == 4:
            self.stars = holder.replace(**updates)
        else:
            self.bh = holder.replace(**updates)

    def _compute_omegas(self):
        """Density parameter per particle type, from total masses."""
        mass = self.pdata.mass.cpu().numpy()
        ptype = self.pdata.ptype.cpu().numpy()
        valid = self.pdata.valid.cpu().numpy()
        vol = self.cfg.boxsize ** 3
        omegas = np.zeros(6)
        for t in range(6):
            m = mass[valid & (ptype == t)].astype(np.float64).sum()
            omegas[t] = m / vol / self.CP.RhoCrit
        return omegas

    # -- state ---------------------------------------------------------

    @property
    def atime(self):
        return float(np.exp(self.timeline.loga_from_ti(self.ti_current)))

    # -- forces --------------------------------------------------------

    def compute_forces(self, measure_power=True, tree=True):
        """Long-range PM force (+ short-range tree when enabled)."""
        weights = torch.where(self.pdata.valid, self.pdata.mass, 0.0)
        # hybrid-nu passive tracers: before NuPartTime type-2 rows neither
        # source nor receive the PM force (hybrid_nu_gravpm_is_active,
        # gravpm.c:83-85,469-475)
        nu_tracer = self.CP.hybrid_nu_tracer(self.atime)
        if nu_tracer:
            weights = torch.where(self.pdata.ptype == 2, 0.0, weights)
        self.walltime.start("PMgrav")
        nu_table = None
        if self.cfg.massive_nu_lin_resp_on:
            nu_table = self._neutrino_response(weights)
        accel, pot, ps = pm_force(self.pdata.ipos, weights, self.pm_cfg,
                                  nu_table=nu_table)
        if nu_tracer:
            accel = torch.where((self.pdata.ptype == 2)[:, None], 0.0,
                                accel)
        self.walltime.stop("PMgrav")
        if self.cfg.massive_nu_lin_resp_on:
            self._total_matter_power(ps, self.atime)
        self.pdata = self.pdata.replace(grav_pm=accel)
        if pot is not None:
            self.pdata = self.pdata.replace(potential=pot)
        if measure_power:
            self.last_power = ps
        if self.cfg.tree_grav_on:
            if tree:
                self.walltime.start("Tree")
                self._compute_tree_forces()
                self.walltime.stop("Tree")
        else:
            self.pdata = self.pdata.replace(
                grav_accel=torch.zeros_like(self.pdata.grav_accel))

    def _neutrino_response(self, weights):
        """Per-PM-step neutrino linear-response table (logk, nufac)
        (compute_neutrino_power, gravpm.c:307-330): a deposit, FFT and
        binning of its own for delta_cdm, then the host table's step."""
        from .pm.gravity import measure_power
        ps = measure_power(self.pdata.ipos, weights, self.pm_cfg)
        return self._nu_table_step(ps, self.atime)

    def _nu_table_step(self, ps, atime):
        """The host table's step at atime from the CDM power ps (a
        PowerSpectrum of the unscaled deposit); the first call makes the
        table, with the history a snapshot carried.  Returns (logk,
        nufac)."""
        from .physics.neutrinos_lra import DeltaTotTable
        from .utils import constants as C
        good = ps.nmodes > 0
        scale = self.cfg.units.UnitLength_in_cm / C.CM_PER_MPC
        k_int = ps.k[good] * scale          # internal 1/length
        delta = np.sqrt(np.maximum(ps.power[good], 0.0))
        if self._nu_table_state is None:
            self._nu_table_state = DeltaTotTable(
                self.CP, k_int, delta, atime, self.cfg.units)
            if self._nu_restore is not None:
                # snapshot-embedded history (neutrinos_lra.c:379-452)
                self._nu_table_state.load_state(self._nu_restore)
        return self._nu_table_state.step(atime, delta)

    def _total_matter_power(self, ps, atime):
        """With massive neutrinos the modes were scaled by nufac (total
        matter) but the zero-mode norm is still the CDM mass squared:
        rescale ps so that it is the total matter power
        (gravpm.c:442-447)."""
        onu = self.CP.ONu.nopart(atime) * atime ** 3
        fac = self.CP.Omega0 / (self.CP.Omega0 - onu)
        ps.power = ps.power / (fac * fac)
        return ps

    def _make_tree_gravity(self):
        from .gravity.treepm import TreeGravity
        # softening in units of mean DM separation
        # (gravshort_set_softenings, gravshort-tree.c:43-50)
        mean_sep = self._dm_mean_sep()
        return TreeGravity(
            boxsize=self.cfg.boxsize, nmesh=self.cfg.nmesh,
            asmth=self.cfg.asmth, rcut=self.cfg.rcut,
            G=self.CP.GravInternal,
            softening=2.8 * self.cfg.gravity_softening * mean_sep,
            err_tol_force_acc=self.cfg.err_tol_force_acc,
            bh_opening_angle=self.cfg.bh_opening_angle,
            max_bh_opening_angle=self.cfg.max_bh_opening_angle,
            tree_use_bh=self.cfg.tree_use_bh,
            # potential comes from the PM mesh; the short-range
            # correction is only added on output (petaio stores
            # Potential on PM steps, gravshort-tree.c:137)
            with_potential=False)

    def _tree_compute(self, pdata=None, **kw):
        self._tree_grav.timer = self.tree_timer
        self.tree_force_calls += 1
        return self._tree_grav.compute(
            self.pdata if pdata is None else pdata, **kw)

    def _tree_compute_retry(self, pdata=None, **kw):
        """The tree force (TreeGravity.compute of pdata, by default the
        simulation's, with kw) through the restartable walk: capacities
        double on overflow and the walk runs again (the export-buffer-full
        retry analog, treewalk.c:801-902)."""
        if self._tree_grav is None:
            self._tree_grav = self._make_tree_gravity()
        for attempt in range(8):
            # a failed (overflowed) attempt must not consume the "BH
            # opening on the first call" state (TreeUseBH=2)
            bh_prev = self._tree_grav._use_bh_now
            res = self._tree_compute(pdata, **kw)
            if not bool(self._tree_grav.last_overflow):
                return res
            self.tree_retries.append(tuple(
                k for k, v in self._tree_grav.last_overflow_parts.items()
                if bool(v)))
            self._tree_grav._use_bh_now = bh_prev
            self._tree_grav.grow()
        raise RuntimeError(
            "tree walk capacity overflow after retries: increase "
            "WalkConfig.leaf_list_max/src_cap or TreeConfig.node_factor")

    def _compute_tree_forces(self, active=None):
        """Short-range forces for every particle, or (active: bool[N])
        for the blocks holding an active target; inactive rows keep their
        old grav_accel.  Before NuPartTime the hybrid neutrino tracers'
        mass is left out of the tree (force_tree_active_moments,
        forcetree.c:162)."""
        pd = self.pdata
        if self.CP.hybrid_nu_tracer(self.atime):
            pd = pd.replace(mass=torch.where(pd.ptype == 2, 0.0, pd.mass))
        accel = self._tree_compute_retry(pd, target_active=active)
        if active is not None:
            accel = torch.where(active[:, None], accel,
                                self.pdata.grav_accel)
        self.pdata = self.pdata.replace(grav_accel=accel)

    def _dm_mean_sep(self):
        """Mean type-1 (DM) inter-particle separation: the reference sets
        the ONE global gravitational softening from MeanSeparation[1]
        (init.c:117 -> gravshort_set_softenings, gravshort-tree.c:43-50).
        Falls back to the all-species count for DM-free boxes."""
        nd = float(((self.pdata.valid) & (self.pdata.ptype == 1)).sum())
        if nd < 1.0:
            nd = max(1.0, float(self.pdata.num_valid))
        return self.cfg.boxsize / np.cbrt(nd)

    # -- SPH -----------------------------------------------------------

    @property
    def gas_mask(self):
        return self.pdata.valid & (self.pdata.ptype == 0)

    def _density_params(self):
        from .sph.density import DensityParams
        softening = self.cfg.gravity_softening * self._dm_mean_sep()
        return DensityParams(
            kernel_type=self.cfg.density_kernel_type,
            eta=self.cfg.density_resolution_eta,
            max_ngb_deviation=self.cfg.max_numngb_deviation,
            min_hsml=self.cfg.min_gas_hsml_fractional * softening)

    def _min_egy(self):
        """Specific energy floor from MinGasTemp (neutral primordial
        gas)."""
        from .utils import constants as C
        uu = self.cfg.units.UnitInternalEnergy_in_cgs
        return (C.BOLTZMANN / C.PROTONMASS / C.GAMMA_MINUS1
                * self.cfg.min_gas_temp / uu
                / (4.0 / (1 + 3 * C.HYDROGEN_MASSFRAC)))

    def setup_gas(self):
        """Initial Hsml + entropy from InitGasTemp
        (setup_smoothinglengths, init.c:461-524)."""
        from .sph.state import SphData
        from .sph.density import sph_density
        from .utils import constants as C
        n = self.pdata.capacity
        dev = self.device
        self.sph = SphData.zeros(n, dev)
        gas = self.gas_mask
        atime = self.atime
        # initial hsml guess from the mean gas separation; BHs from the IC
        # get the same seed kernel (init.c:461-524 sets Hsml for types 0
        # and 5: a zero BH kernel would leave the accretion sums empty)
        ngas = float(gas.sum())
        mean_sep = self.cfg.boxsize / max(1.0, np.cbrt(ngas))
        is_bh = self.pdata.valid & (self.pdata.ptype == 5)
        hsml0 = torch.where(gas | is_bh, float(np.float32(2.0 * mean_sep)),
                            0.0)
        self.pdata = self.pdata.replace(hsml=hsml0)
        # u_init from InitGasTemp (init.c:488-501)
        init_temp = self.cfg.init_gas_temp
        if init_temp < 0:
            init_temp = self.CP.CMBTemperature / atime
        uu = self.cfg.units.UnitInternalEnergy_in_cgs
        u_init = (1.0 / C.GAMMA_MINUS1) * (C.BOLTZMANN / C.PROTONMASS) \
            * init_temp / uu
        mol_weight = (4 / (8 - 5 * (1 - C.HYDROGEN_MASSFRAC))
                      if init_temp > 1e4
                      else 4 / (1 + 3 * C.HYDROGEN_MASSFRAC))
        u_init /= mol_weight
        min_egy = self._min_egy()
        u_init = max(u_init, min_egy)
        self._min_egy_spec = min_egy
        a3 = atime ** 3
        # density + hsml convergence with unit entvar
        dpar = self._density_params()
        ones = torch.ones(n, dtype=torch.float32, device=dev)
        out = sph_density(self.pdata.ipos, self.pdata.mass, gas,
                          self.pdata.hsml, self.pdata.vel, self.pdata.vel,
                          ones, dpar, self.cfg.boxsize)
        self.pdata = self.pdata.replace(hsml=out["hsml"],
                                        dt_hsml=out["dt_hsml"])
        rho = out["density"]
        egy = rho
        entropy = C.GAMMA_MINUS1 * u_init / torch.clamp(
            rho / a3, min=1e-30) ** C.GAMMA_MINUS1
        if self.cfg.density_independent_sph:
            # iterate entropy <-> EgyWtDensity (init.c:406-452)
            for _ in range(8):
                entropy = C.GAMMA_MINUS1 * u_init / torch.clamp(
                    egy / a3, min=1e-30) ** C.GAMMA_MINUS1
                entvar = torch.clamp(entropy, min=1e-30) ** (1.0 / C.GAMMA)
                out = sph_density(
                    self.pdata.ipos, self.pdata.mass, gas, self.pdata.hsml,
                    self.pdata.vel, self.pdata.vel, entvar, dpar,
                    self.cfg.boxsize, update_hsml=False)
                new_egy = out["egy_wt_density"]
                diff = float(torch.where(
                    gas, torch.abs(new_egy - egy)
                    / torch.clamp(egy, min=1e-30), 0.0).max())
                egy = new_egy
                if diff < 1e-3:
                    break
        self.sph = self.sph.replace(
            entropy=torch.where(gas, entropy, 0.0),
            density=rho, egy_wt_density=egy,
            dhsml_density_factor=out["dhsml_density_factor"],
            dhsml_egy_factor=out["dhsml_egy_factor"],
            div_vel=out["div_vel"], curl_vel=out["curl_vel"])
        self._gas_initialized = True

    def _restore_gas(self):
        """Rebuild SPH state from snapshot blocks
        (check_density_entropy path, init.c:366-400)."""
        from .sph.state import SphData
        from .utils import constants as C
        n = self.pdata.capacity
        dev = self.device
        gas = self.gas_mask
        rows = gas.cpu().numpy()
        r = self._gas_restore
        a3 = self.atime ** 3

        def expand(x):
            full = np.zeros(n, np.float32)
            full[rows] = np.asarray(x, np.float32)
            return torch.as_tensor(full, device=dev)

        rho = expand(r["density"])
        u = expand(r["u"])
        entropy = C.GAMMA_MINUS1 * u / torch.clamp(
            rho / a3, min=1e-30) ** C.GAMMA_MINUS1
        sph = SphData.zeros(n, dev).replace(
            entropy=entropy, density=rho,
            egy_wt_density=(expand(r["egy_wt_density"])
                            if "egy_wt_density" in r else rho))
        # generic registry-driven field scatter (any dtype/shape)
        updates = {}
        for field, arr in r.items():
            if field in ("u", "density", "hsml", "egy_wt_density") \
                    or not hasattr(sph, field):
                continue
            cur = getattr(sph, field).cpu().numpy().copy()
            cur[rows] = np.asarray(arr).reshape(
                (-1,) + cur.shape[1:]).astype(cur.dtype)
            updates[field] = torch.as_tensor(cur, device=dev)
        if updates:
            sph = sph.replace(**updates)
        self.sph = sph
        self.pdata = self.pdata.replace(hsml=expand(r["hsml"]))
        self._min_egy_spec = self._min_egy()
        self._gas_initialized = True

    def compute_hydro(self, dloga, active=None):
        """Density + hydro force loops (run.c:466-489 analog).

        active: optional bool[N] — restrict TARGETS to the active set
        (hierarchical stepping); all gas stays as sources and inactive
        targets keep their old values."""
        from .sph.density import sph_density
        from .sph.hydra import hydro_force, HydroParams
        from .utils.constants import GAMMA
        gas = self.gas_mask
        tgt = gas if active is None else (gas & active)
        atime = self.atime
        hubble = self.CP.hubble_function(atime)
        entvar = torch.clamp(self.sph.entropy, min=1e-30) ** (1.0 / GAMMA)
        entvar = torch.where(gas, entvar, 0.0)
        dpar = self._density_params()

        def merge(new, old):
            if active is None:
                return new
            m = tgt[:, None] if new.dim() == 2 else tgt
            return torch.where(m, new, old)

        self.walltime.start("SPH/Density")
        out = sph_density(self.pdata.ipos, self.pdata.mass, gas,
                          self.pdata.hsml, self.pdata.vel, self.pdata.vel,
                          entvar, dpar, self.cfg.boxsize,
                          do_egy_density=self.cfg.density_independent_sph,
                          target_mask=None if active is None else tgt)
        self.walltime.stop("SPH/Density")
        self.pdata = self.pdata.replace(
            hsml=merge(out["hsml"], self.pdata.hsml),
            dt_hsml=merge(out["dt_hsml"], self.pdata.dt_hsml))
        sph = self.sph
        self.sph = sph.replace(
            density=merge(out["density"], sph.density),
            egy_wt_density=merge(out["egy_wt_density"], sph.egy_wt_density),
            dhsml_density_factor=merge(out["dhsml_density_factor"],
                                       sph.dhsml_density_factor),
            dhsml_egy_factor=merge(out["dhsml_egy_factor"],
                                   sph.dhsml_egy_factor),
            div_vel=merge(out["div_vel"], sph.div_vel),
            curl_vel=merge(out["curl_vel"], sph.curl_vel))
        hp = HydroParams(
            kernel_type=self.cfg.density_kernel_type,
            art_bulk_visc=self.cfg.art_bulk_visc,
            density_independent=self.cfg.density_independent_sph,
            density_contrast_limit=self.cfg.density_contrast_limit)
        self.walltime.start("SPH/Hydro")
        sph = self.sph
        res = hydro_force(
            self.pdata.ipos, self.pdata.mass, gas, self.pdata.hsml,
            self.pdata.vel, entvar, sph.density, sph.egy_wt_density,
            sph.div_vel, sph.curl_vel, sph.dhsml_egy_factor, hp,
            self.cfg.boxsize, atime, hubble, dloga)
        self.walltime.stop("SPH/Hydro")
        hydro_accel = res["hydro_accel"]
        dt_entropy = res["dt_entropy"]
        if self.cfg.wind_on and self._gas_initialized:
            # decoupled wind particles feel no hydro force
            # (winds_decoupled_hydro, winds.c:113-136)
            dec = sph.delay_time > 0
            hydro_accel = torch.where(dec[:, None], 0.0, hydro_accel)
            dt_entropy = torch.where(dec, 0.0, dt_entropy)
        self.sph = sph.replace(
            hydro_accel=merge(hydro_accel, sph.hydro_accel),
            dt_entropy=merge(dt_entropy, sph.dt_entropy),
            max_signal_vel=merge(res["max_signal_vel"],
                                 sph.max_signal_vel))

    # -- gas source terms: cooling and star formation -----------------

    def _init_cooling(self):
        from .physics.cooling import (CoolingParams, CoolingRates,
                                      CoolingUnits, MetalCoolingTable,
                                      TreeCool, UVFluctuationTable)
        par = CoolingParams(
            recomb=self.cfg.recomb_rates, cooling=self.cfg.cooling_rates,
            SelfShieldingOn=self.cfg.self_shielding_on,
            PhotoIonizationOn=self.cfg.photo_ionization_on,
            PhotoIonizeFactor=self.cfg.photo_ionize_factor,
            MinGasTemp=self.cfg.min_gas_temp,
            CMBTemperature=self.CP.CMBTemperature,
            fBar=self.CP.OmegaBaryon / max(self.CP.OmegaCDM, 1e-10),
            HeliumHeatOn=self.cfg.helium_heat_on,
            HeliumHeatThresh=self.cfg.helium_heat_thresh,
            HeliumHeatAmp=self.cfg.helium_heat_amp,
            HeliumHeatExp=self.cfg.helium_heat_exp)
        self._treecool = TreeCool(self.cfg.treecool_file or None, par)
        mtab = None
        if self.cfg.metal_cool_file:
            mtab = MetalCoolingTable.from_file(self.cfg.metal_cool_file)
        if self.cfg.uv_fluctuation_file:
            self._uvf = UVFluctuationTable.from_file(
                self.cfg.uv_fluctuation_file, self.cfg.boxsize,
                self.cfg.units.UnitLength_in_cm)
        self._cooling = CoolingRates(par, self._treecool, metal_table=mtab)
        units = self.cfg.units
        h = self.CP.HubbleParam
        self._cooling_units = CoolingUnits(
            density_in_phys_cgs=units.UnitDensity_in_cgs * h * h,
            uu_in_cgs=units.UnitInternalEnergy_in_cgs,
            tt_in_s=units.UnitTime_in_s / h)

    def _source_setup(self, active):
        """What both source-term paths start from: the gas rows to update
        (the closing ones when active is given), a, the redshift, H(a) and
        the UV background: the TreeCool table's, gated row by row by the UV
        fluctuation table (z_reion at each row), and during the excursion
        set's epoch the rates of each row's J21 instead."""
        from .physics.cooling import local_uvbg
        if self._cooling is None:
            self._init_cooling()
        gas = self.gas_mask
        if active is not None:
            gas = gas & active
        atime = self.atime
        redshift = 1.0 / atime - 1.0
        hubble = self.CP.hubble_function(atime)
        uvbg = self._treecool.get_global_uvbg(redshift)
        if self._uvf is not None:
            uvbg = local_uvbg(uvbg, self._uvf.zreion(self.pdata.ipos),
                              redshift)
        uvbg = self._excursion_uvbg(uvbg, redshift)
        return gas, atime, redshift, hubble, uvbg

    def _excursion_uvbg(self, uvbg, redshift):
        """During the excursion epoch the cooling UVB comes from each row's
        J21 (the grid readout): neutral cells see no background
        (excursionset_rundown.md); outside it, the given UVBG."""
        from .physics.cooling import UVBG
        from .physics.uvbg import j21_to_rates
        if not self.cfg.excursion_set_on or self.sph is None:
            return uvbg
        if not (self.cfg.excursion_set_zstop <= redshift
                <= self.cfg.excursion_set_zstart):
            return uvbg
        g, e = j21_to_rates(self.sph.local_j21, self.cfg.alpha_uv)
        return UVBG(gJH0=g[0], gJHe0=g[1], gJHep=g[2],
                    epsH0=e[0], epsHe0=e[1], epsHep=e[2],
                    self_shield_dens=uvbg.self_shield_dens)

    def apply_cooling(self, dloga, active=None):
        """Strang-split cooling after the kick (the cooling_direct path of
        cooling_and_starformation, sfr_eff.c:187).  dloga may be per
        particle (hierarchical bins, each closing particle cools over its
        own interval) and ``active`` restricts the update to the closing
        set."""
        from .physics.cooling import do_cooling
        from .utils.constants import GAMMA_MINUS1
        gas, atime, redshift, hubble, uvbg = self._source_setup(active)
        a3 = atime ** 3
        rho_phys = torch.clamp(self.sph.density, min=1e-30) / a3
        u = self.sph.entropy / GAMMA_MINUS1 * rho_phys ** GAMMA_MINUS1
        dt = torch.broadcast_to(torch.as_tensor(
            dloga, dtype=u.dtype, device=self.device) / hubble,
            u.shape).contiguous()
        self.walltime.start("Cooling")
        u_new, ne = do_cooling(self._cooling, redshift, u, rho_phys, dt,
                               uvbg, self.sph.ne, self._min_egy_spec,
                               self._cooling_units, rows=gas,
                               metallicity=self.sph.metallicity)
        self.walltime.stop("Cooling")
        ent_new = GAMMA_MINUS1 * u_new / rho_phys ** GAMMA_MINUS1
        self.sph = self.sph.replace(
            entropy=torch.where(gas, ent_new, self.sph.entropy),
            ne=torch.where(gas, ne, self.sph.ne))

    def _init_sfr(self):
        from .physics.sfr import SFRParams, init_sfr
        if self._cooling is None:
            self._init_cooling()
        mass = self.pdata.mass.cpu().numpy()
        gas = self.gas_mask.cpu().numpy()
        avg_bar = float(mass[gas].mean()) if gas.any() else 0.0
        par = SFRParams(
            StarformationCriterion=self.cfg.sfr_criterion,
            CritOverDensity=self.cfg.crit_overdensity,
            CritPhysDensity=self.cfg.crit_phys_density,
            FactorSN=self.cfg.factor_sn,
            FactorEVP=self.cfg.factor_evp,
            TempSupernova=self.cfg.temp_supernova,
            TempClouds=self.cfg.temp_clouds,
            MaxSfrTimescale=self.cfg.max_sfr_timescale,
            Generations=self.cfg.generations,
            QuickLymanAlphaProbability=self.cfg.quick_lya_probability,
            QuickLymanAlphaTempThresh=self.cfg.quick_lya_temp_thresh,
            WindOn=self.cfg.wind_on)
        self._sfr = init_sfr(par, self.CP, self.cfg.units, self._cooling,
                             self._cooling_units, avg_bar,
                             device=self.device)
        if self.cfg.wind_on:
            from .physics.winds import WindParams, init_winds
            wp = WindParams(
                model=self.cfg.wind_model,
                efficiency=self.cfg.wind_efficiency,
                energy_fraction=self.cfg.wind_energy_fraction,
                sigma0=self.cfg.wind_sigma0,
                speed_factor=self.cfg.wind_speed_factor,
                free_travel_length=self.cfg.wind_free_travel_length,
                free_travel_dens_fac=self.cfg.wind_free_travel_dens_fac,
                min_wind_velocity=self.cfg.min_wind_velocity,
                thermal_factor=self.cfg.wind_thermal_factor,
                max_free_travel_time=self.cfg.max_wind_free_travel_time)
            self._winds = init_winds(
                wp, self._sfr.FactorSN, self._sfr.EgySpecSN,
                self._sfr.PhysDensThresh, self.cfg.units.UnitTime_in_s)
            # as the JAX package: zeros, also when the first global step
            # has just computed the dispersion (it is used from the next)
            self._vdisp = torch.zeros(self.pdata.capacity,
                                      dtype=torch.float32,
                                      device=self.device)

    def apply_cooling_sfr(self, dloga, active=None):
        """cooling_and_starformation (sfr_eff.c:187): the effective EOS and
        star formation for star-forming gas, plain cooling otherwise, then
        the new stars and a line of ``sfr.txt``.  dloga may be per particle
        (hierarchical stepping applies the source terms to each closing
        bin over its own interval, timestep.c:298 + run.c:374-520);
        ``active`` restricts the update to the closing set.  With WindOn
        the subgrid model kicks the star-forming gas itself before the
        new stars spawn; the other models kick the new stars' gas
        neighbours after (winds_and_feedback, winds.c:299-345); then the
        decoupling timers advance."""
        from .physics import sfr as sfrmod
        from .physics.cooling import do_cooling
        from .utils import threefry
        gas, atime, redshift, hubble, uvbg = self._source_setup(active)
        if self._sfr is None:
            self._init_sfr()
        key = threefry.prng_key(
            (self.cfg.random_seed + self.ti_current) % (2 ** 31))

        def cool_fn(u, rho_phys, dt, ne, rows, metallicity):
            return do_cooling(self._cooling, redshift, u, rho_phys, dt,
                              uvbg, ne, self._min_egy_spec,
                              self._cooling_units, rows=rows,
                              metallicity=metallicity)

        self.walltime.start("Cooling/SFR")
        sph = self.sph
        out = sfrmod.cooling_and_starformation(
            self._sfr, self._cooling, self._cooling_units, key,
            density=sph.density, entropy=sph.entropy, ne=sph.ne,
            metallicity=sph.metallicity, delay_time=sph.delay_time,
            mass=self.pdata.mass, pid=self.pdata.pid, valid_gas=gas,
            redshift=redshift, atime=atime, hubble=hubble, dloga=dloga,
            uvbg=uvbg, do_cooling_fn=cool_fn)
        # keep the stored SFR of non-closing rows (out zeroes outside the
        # update mask)
        sfr_new = out["sfr"] if active is None else \
            torch.where(gas, out["sfr"], sph.sfr)
        self.sph = sph.replace(entropy=out["entropy"], ne=out["ne"],
                               sfr=sfr_new, metallicity=out["metallicity"])
        from .physics import winds as windmod
        wkey = threefry.fold_in(key, 77)
        subgrid = bool(self.cfg.wind_model & windmod.WIND_SUBGRID)
        if self.cfg.wind_on and subgrid:
            vdisp = self._vdisp if self._vdisp is not None else \
                torch.zeros_like(self.pdata.mass)
            vel_new, ent_new, delay_new, _ = windmod.winds_subgrid(
                self._winds, wkey, sm=out["sm"], mass=self.pdata.mass,
                pid=self.pdata.pid, vdisp=vdisp, vel=self.pdata.vel,
                entropy=self.sph.entropy, density=self.sph.density,
                delay_time=self.sph.delay_time, eligible=out["on_eeqos"],
                atime=atime)
            self.pdata = self.pdata.replace(vel=vel_new)
            self.sph = self.sph.replace(entropy=ent_new,
                                        delay_time=delay_new)
        # sfr.txt's sums, gathered before spawn_stars changes masses
        # (sfr_eff.c:319-364), read from the device in one transfer
        on_sf, make = out["on_eeqos"], out["make_star"]
        dt_sf = torch.broadcast_to(torch.as_tensor(
            dloga, dtype=torch.float32, device=self.device) / hubble,
            on_sf.shape)
        sums = torch.stack([
            torch.where(on_sf, dt_sf, 0.0).sum(),
            on_sf.sum().to(torch.float32),
            torch.where(make, torch.where(out["convert"], self.pdata.mass,
                                          out["star_mass"]), 0.0).sum(),
            make.sum().to(torch.float32),
            self.sph.sfr.sum(),
            torch.where(gas, out["sm"], 0.0).sum()]).cpu().numpy()
        sum_dtime, mass_formed, total_sfr, total_sm = (
            float(sums[i]) for i in (0, 2, 4, 5))
        n_sf, nstar = int(sums[1]), int(sums[3])
        new_star = None
        if nstar > 0:
            if self.stars is None:
                from .physics.stars import StarData
                self.stars = StarData.zeros(self.pdata.capacity, self.device)
            self.pdata, self.sph, self.stars, _, ovf, new_star = \
                sfrmod.spawn_stars(self.pdata, self.sph, make,
                                   out["convert"], out["star_mass"], atime,
                                   stars=self.stars, vdisp=self._vdisp)
            if ovf:
                raise RuntimeError("particle capacity exhausted while "
                                   "spawning stars; raise PartAllocFactor")
        self.walltime.stop("Cooling/SFR")
        if self.cfg.wind_on and not subgrid and new_star is not None:
            self.walltime.start("Winds")
            vel_new, ent_new, delay_new, kicked = \
                windmod.winds_via_neighbors(
                    self._winds, wkey, ipos=self.pdata.ipos,
                    mass=self.pdata.mass, hsml=self.pdata.hsml,
                    pid=self.pdata.pid, vel=self.pdata.vel,
                    entropy=self.sph.entropy, density=self.sph.density,
                    delay_time=self.sph.delay_time, is_gas=self.gas_mask,
                    new_star=new_star, star_vdisp=self.stars.vdisp,
                    boxsize=self.cfg.boxsize, atime=atime)
            self.pdata = self.pdata.replace(vel=vel_new)
            self.sph = self.sph.replace(entropy=ent_new,
                                        delay_time=delay_new)
            self.wind_kicks += int(kicked.sum())
            self.walltime.stop("Winds")
        if self.cfg.wind_on:
            # advance the decoupling timers (winds_evolve)
            dt = dloga / hubble if not isinstance(dloga, torch.Tensor) \
                else (dloga / hubble).to(torch.float32)
            self.sph = self.sph.replace(
                delay_time=windmod.winds_decouple_update(
                    self._winds, self.sph.delay_time, self.sph.density, dt,
                    atime))
        # sfr.txt in the reference's 8-column layout (write_sfr,
        # sfr_eff.c:381): a, total_sm (expected mass formed, internal),
        # totsfrrate (Msun/yr), the rate total_sm implies over the mean
        # star-forming dt (Msun/yr), the mass actually formed, the mean
        # dt, the star-forming count and the new stars
        rate_msun = (total_sm * n_sf / sum_dtime
                     * self._sfr.UnitSfr_in_solar_per_year
                     if sum_dtime > 0 else 0.0)
        mean_dt = sum_dtime / n_sf if n_sf > 0 else 0.0
        with open(os.path.join(self.cfg.output_dir, "sfr.txt"), "a") as fh:
            fh.write(f"{atime:.12g} {total_sm:g} {total_sfr:g} "
                     f"{rate_msun:g} {mass_formed:g} "
                     f"{mean_dt:g} {n_sf} {nstar}\n")

    def _source_terms(self, dloga, active=None):
        """The Strang-split gas source terms after the closing kick
        (run.c:586-604): star formation with its cooling, or cooling
        alone."""
        if not (self.has_gas and self._gas_initialized):
            return
        if self.cfg.starformation_on:
            self.apply_cooling_sfr(dloga, active)
        elif self.cfg.cooling_on:
            self.apply_cooling(dloga, active)

    def _compute_vdisp(self):
        """The halo wind model's DM velocity dispersion around the gas, on
        global steps (run.c:646-647; the JAX package computes it only in
        Simulation.step)."""
        from .physics.winds import dm_velocity_dispersion
        npart = float(self.pdata.num_valid)
        mean_sep = self.cfg.boxsize / max(1.0, np.cbrt(npart))
        self.walltime.start("Winds")
        self._vdisp = dm_velocity_dispersion(
            self.pdata.ipos, self.pdata.vel, self.pdata.mass,
            self.pdata.valid & (self.pdata.ptype == 1), self.gas_mask,
            self.cfg.boxsize, mean_sep)
        self.walltime.stop("Winds")

    # -- metal return and black holes ------------------------------------

    def _metal_return_tables(self):
        """The metal return's age table and parameters (made on first
        use; the excursion set shares the age table)."""
        from .physics import metal_return as mrmod
        if self._age_table is None:
            self._age_table = mrmod.AgeTable(
                self.CP.hubble_function, self.cfg.units,
                self.CP.HubbleParam, device=self.device)
        if getattr(self, "_mr_params", None) is None:
            self._mr_params = mrmod.MetalReturnParams(
                sn1a_n0=self.cfg.metals_sn1a_n0,
                sph_weighting=self.cfg.metals_sph_weighting,
                max_ngb_deviation=self.cfg.metals_max_ngb_deviation)
        return self._age_table, self._mr_params

    def _rho_crit_baryon(self):
        """The critical density times OmegaBaryon, internal units (the
        kinetic BH channel's star-forming density scale)."""
        return self.CP.OmegaBaryon * 3 * self.CP.Hubble ** 2 \
            / (8 * np.pi * self.CP.GravInternal)

    def apply_metal_return(self, dloga):
        """Stellar mass & metal return to the neighbour gas (metal_return(),
        metal_return.c:423-500)."""
        from .physics import metal_return as mrmod
        is_star = self.pdata.valid & (self.pdata.ptype == 4)
        if self.sph is None or self.stars is None or not bool(is_star.any()):
            return
        atime1 = self.atime
        atime0 = float(np.exp(np.log(atime1) - dloga))
        self._metal_return_tables()
        if self._star_hsml is None:
            self._star_hsml = torch.where(is_star, self.pdata.hsml, 0.0)
        # seed the star hsml from the particle hsml (gas-inherited) or the
        # mean spacing where zero
        npart = float(self.pdata.num_valid)
        mean_sep = self.cfg.boxsize / max(1.0, np.cbrt(npart))
        sh = torch.where(self._star_hsml > 0, self._star_hsml,
                         torch.where(self.pdata.hsml > 0, self.pdata.hsml,
                                     float(np.float32(2.0 * mean_sep))))
        self.walltime.start("MetalReturn")
        out = mrmod.metal_return_step(
            self.pdata.ipos, self.pdata.mass, self.pdata.hsml,
            self.sph.density, self.gas_mask, is_star, sh, self.stars,
            self.sph.metals, atime0, atime1, self._age_table,
            self.cfg.boxsize, self._mr_params, self.CP.HubbleParam)
        self.walltime.stop("MetalReturn")
        gas = self.gas_mask
        self.pdata = self.pdata.replace(mass=torch.where(
            gas, out["gas_mass"], out["star_mass"].to(torch.float32)))
        zmet = torch.sum(out["gas_metals"][:, 2:], dim=1)
        self.sph = self.sph.replace(
            metals=out["gas_metals"],
            metallicity=torch.where(gas, zmet, self.sph.metallicity))
        self.stars = self.stars.replace(
            total_mass_returned=out["total_mass_returned"].to(
                torch.float32),
            last_enrichment_myr=out["last_enrichment_myr"])
        self._star_hsml = out["star_hsml"]

    def _bh_params(self):
        from .physics.blackhole import BHParams
        return BHParams(
            accretion_factor=self.cfg.bh_accretion_factor,
            eddington_factor=self.cfg.bh_eddington_factor,
            feedback_factor=self.cfg.bh_feedback_factor,
            seed_mass=self.cfg.bh_seed_mass,
            ngb_factor=self.cfg.bh_ngb_factor,
            min_fof_mass_for_seed=self.cfg.min_fof_mass_for_seed,
            min_mstar_for_seed=self.cfg.min_mstar_for_seed,
            kinetic_on=self.cfg.bh_kinetic_on,
            merge_grav_bound=self.cfg.bh_merge_grav_bound,
            dynfric_method=self.cfg.bh_dynfric_method,
            df_boost=self.cfg.bh_df_boost,
            df_bmax=self.cfg.bh_df_bmax,
            ke_eddington_thr_factor=self.cfg.bhke_eddington_thr_factor,
            ke_eddington_m_factor=self.cfg.bhke_eddington_m_factor,
            ke_eddington_m_pivot=self.cfg.bhke_eddington_m_pivot,
            ke_eddington_m_index=self.cfg.bhke_eddington_m_index,
            ke_eff_rho_factor=self.cfg.bhke_eff_rho_factor,
            ke_eff_cap=self.cfg.bhke_eff_cap,
            ke_inj_energy_thr=self.cfg.bhke_inj_energy_thr,
            ke_sfr_crit_overdensity=self.cfg.crit_overdensity,
            seed_bh_dyn_mass=self.cfg.seed_bh_dyn_mass,
            reposition_enabled=self.cfg.bh_reposition)

    def apply_blackholes(self, dloga):
        """BH accretion, swallowing, feedback, mergers and repositioning
        (blackhole(), blackhole.c:216-360), when any BH exists; a line of
        ``blackholes.txt`` (a, BHs, total BH mass, total mdot, gas
        swallowed) and, with WriteBlackHoleDetails, the BHs' records."""
        from .physics import blackhole as bhmod
        from .physics.winds import dm_velocity_dispersion
        from .utils import threefry
        is_bh = self.pdata.valid & (self.pdata.ptype == 5)
        nbh = int(is_bh.sum())
        if nbh == 0:
            return
        self._ensure_bh()
        par = self._bh_params()
        gas = self.gas_mask
        atime = self.atime
        hubble = self.CP.hubble_function(atime)
        dtime = dloga / hubble
        pd = self.pdata
        box = self.cfg.boxsize
        ktype = self.cfg.density_kernel_type
        self.walltime.start("BH")
        # dynamical friction environment (bhdynfric.c)
        if par.dynfric_method > 0:
            src = pd.valid & (pd.ptype == 4)
            if par.dynfric_method > 1:
                src = src | (pd.valid & (pd.ptype == 1))
            if par.dynfric_method > 2:
                src = src | gas
            dfs = bhmod.bh_dynfric_sums(pd.ipos, pd.mass, pd.hsml, pd.vel,
                                        is_bh, src, box, kernel_type=ktype)
            df_acc = bhmod.dynfric_accel(
                dfs["rho"], dfs["vel"], dfs["rmsvel"], pd.mass, pd.vel,
                atime, self.CP.GravInternal, bmax=par.df_bmax,
                boost=par.df_boost)
            self.bh = self.bh.replace(df_accel=torch.where(
                is_bh[:, None], df_acc, 0.0).to(torch.float32))
        if par.kinetic_on:
            # 1D DM velocity dispersion around the BHs within each BH's own
            # Hsml (veldisp.c:60-76)
            vd = dm_velocity_dispersion(
                pd.ipos, pd.vel, pd.mass, pd.valid & (pd.ptype == 1), is_bh,
                box, 0.0, radius_per_particle=torch.where(is_bh, pd.hsml,
                                                          0.0))
            self.bh = self.bh.replace(vdisp=torch.where(is_bh, vd, 0.0))
        sums = bhmod.bh_neighbor_sums(pd.ipos, pd.mass, pd.hsml, pd.vel,
                                      self.sph.entropy, is_bh, gas, box,
                                      kernel_type=ktype)
        self.bh = self.bh.replace(bh_density=sums["rho"])
        gasvel = torch.stack([sums["vx"], sums["vy"], sums["vz"]], dim=-1)
        mdot, dm = bhmod.bondi_accretion(
            par, self.bh.bh_mass, self.bh.bh_density, sums["ent"], gasvel,
            pd.vel, atime, self.CP.GravInternal,
            self.cfg.units.UnitTime_in_s, self.CP.HubbleParam, dtime)
        self.bh = self.bh.replace(
            mdot=torch.where(is_bh, mdot, 0.0),
            bh_mass=torch.where(is_bh, self.bh.bh_mass + dm,
                                self.bh.bh_mass))
        ke_energy = keflag = None
        if par.kinetic_on:
            rho_crit_b = self._rho_crit_baryon()
            ke_energy, keflag = bhmod.kinetic_update(
                par, self.bh.bh_mass, self.bh.mdot, self.bh.bh_density,
                self.bh.vdisp, sums["mgas"], self.bh.kinetic_energy, dtime,
                self.cfg.units.UnitTime_in_s, self.CP.HubbleParam,
                rho_crit_b, self.cfg.units.UnitVelocity_in_cm_per_s)
        key = threefry.prng_key(
            (self.cfg.random_seed + self.ti_current + 5) % (2 ** 31))
        swallowed, ent_new, bhrow, kick = bhmod.swallow_and_feedback(
            par, key, ipos=pd.ipos, mass=pd.mass, hsml=pd.hsml,
            entropy=self.sph.entropy, density=self.sph.density,
            is_bh=is_bh, is_gas=gas, pid=pd.pid, bh_mass=self.bh.bh_mass,
            mdot=self.bh.mdot, bh_density=self.bh.bh_density,
            fbweight=sums["fbweight"], boxsize=box, atime=atime,
            dtime=dtime, unit_velocity=self.cfg.units.UnitVelocity_in_cm_per_s,
            uu_in_cgs=self.cfg.units.UnitInternalEnergy_in_cgs,
            kernel_type=ktype, ke_energy=ke_energy, keflag=keflag,
            mtrack=self.bh.mtrack)
        self.sph = self.sph.replace(entropy=ent_new)
        if par.kinetic_on:
            self.pdata = self.pdata.replace(vel=self.pdata.vel + kick)
            # reset the released energy (blackhole.c:986-989)
            self.bh = self.bh.replace(kinetic_energy=torch.where(
                keflag == 2, 0.0, ke_energy))
        # swallowing on the device: swallowed mass and momentum summed by
        # swallower row, then routed through Mtrack
        # (blackhole_feedback_postprocess, blackhole.c:960-978)
        nsw = int(swallowed.sum())
        if nsw > 0:
            n = self.pdata.capacity
            m = self.pdata.mass
            v = self.pdata.vel
            rows = torch.where(swallowed, bhrow, n)
            acc_mass = torch.zeros(n + 1, dtype=torch.float32,
                                   device=self.device)
            acc_mass.index_add_(0, rows, torch.where(swallowed, m, 0.0))
            acc_mom = torch.zeros((n + 1, 3), dtype=torch.float32,
                                  device=self.device)
            acc_mom.index_add_(0, rows, torch.where(
                swallowed[:, None], m[:, None] * v, 0.0))
            new_mass, new_mtrack, new_vel = bhmod.apply_mtrack_accretion(
                m, self.bh.mtrack, acc_mass[:n], acc_mom[:n], v, is_bh,
                par.seed_bh_dyn_mass)
            self.pdata = self.pdata.replace(
                mass=new_mass, vel=new_vel,
                valid=self.pdata.valid & ~swallowed)
            self.bh = self.bh.replace(mtrack=new_mtrack)
        self.bh_swallowed += nsw
        # BH-BH mergers (blackhole.c:495-560), on the host
        if nbh > 1:
            self._bh_mergers(par, atime)
        # minimum-potential repositioning (blackhole_minpot_ngbiter,
        # bhdynfric.c:199-231 + the drift.c:32-49 jump, applied here at the
        # end of the BH step)
        if par.reposition_enabled:
            self._bh_reposition()
        self.walltime.stop("BH")
        # the sums over the BHs at the step's start, mergers included
        tot = torch.stack([self.bh.mdot.sum(),
                           torch.where(is_bh, self.bh.bh_mass, 0.0).sum()])
        mdot_tot, mbh_tot = (float(x) for x in tot.cpu().numpy())
        with open(os.path.join(self.cfg.output_dir, "blackholes.txt"),
                  "a") as fh:
            fh.write(f"{atime:g} {nbh} {mbh_tot:g} {mdot_tot:g} {nsw}\n")
        if self.cfg.write_bh_details:
            self._write_bh_details(atime)

    def _bh_mergers(self, par, atime):
        """Merge bound BH pairs closer than twice the softening; the
        swallower takes the mass, momentum, subgrid mass and progenitors
        (np.add.at on the host, as the JAX package)."""
        from .physics import blackhole as bhmod
        pd = self.pdata
        host = {k: getattr(pd, k).cpu().numpy()
                for k in ("ipos", "vel", "grav_accel", "grav_pm", "pid",
                          "valid", "ptype", "mass")}
        soft = self.cfg.gravity_softening * self._dm_mean_sep()
        merge = bhmod.bh_mergers(
            par, pos=fixed_to_pos(host["ipos"], self.cfg.boxsize),
            vel=host["vel"],
            accel=host["grav_accel"] + host["grav_pm"],
            df_accel=self.bh.df_accel.cpu().numpy(), pid=host["pid"],
            is_bh=host["valid"] & (host["ptype"] == 5),
            boxsize=self.cfg.boxsize, atime=atime, softening=soft)
        swr, tor = merge["swallowed"], merge["swallower"]
        if not len(swr):
            return
        m = host["mass"].copy()
        v = host["vel"].copy()
        bhm = self.bh.bh_mass.cpu().numpy().copy()
        progs = self.bh.count_progs.cpu().numpy().copy()
        # a swallowed BH still in its Mtrack regime donates its tracked
        # mass, not the fixed dynamical seed mass (blackhole.c:795-798)
        othermass = m[swr]
        if par.seed_bh_dyn_mass > 0:
            mtk = self.bh.mtrack.cpu().numpy()
            othermass = np.where(mtk[swr] < par.seed_bh_dyn_mass, mtk[swr],
                                 othermass)
        mom = m[:, None] * v
        np.add.at(mom, tor, othermass[:, None] * v[swr])
        np.add.at(m, tor, othermass)
        np.add.at(bhm, tor, bhm[swr])
        np.add.at(progs, tor, progs[swr] + 1)
        v = np.where((m > 0)[:, None], mom / np.maximum(m, 1e-30)[:, None],
                     v)
        valid = host["valid"].copy()
        valid[swr] = False
        dev = self.device
        self.pdata = self.pdata.replace(
            mass=torch.as_tensor(m, dtype=torch.float32, device=dev),
            vel=torch.as_tensor(v, dtype=torch.float32, device=dev),
            valid=torch.as_tensor(valid, device=dev))
        self.bh = self.bh.replace(
            bh_mass=torch.as_tensor(bhm, dtype=torch.float32, device=dev),
            count_progs=torch.as_tensor(progs, dtype=torch.int32,
                                        device=dev))
        self.bh_mergers += len(swr)

    def _bh_reposition(self):
        """Move each BH to its kernel's minimum-potential neighbour: the
        total potential (PM plus one tree evaluation with the potential,
        gravshort-tree.c:137), then bhmod.bh_minpot."""
        from .physics import blackhole as bhmod
        pd = self.pdata
        is_bh = pd.valid & (pd.ptype == 5)
        srcs = pd.valid & ((pd.ptype == 0) | (pd.ptype == 1)
                           | (pd.ptype == 4) | (pd.ptype == 5))
        pot_tot = pd.potential
        if self.cfg.tree_grav_on and self._tree_grav is not None:
            _, tree_pot = self._tree_compute_retry(return_potential=True)
            pot_tot = pot_tot + tree_pot
        mp_pos, _, found = bhmod.bh_minpot(pd.ipos, pd.hsml, pot_tot,
                                           pd.vel, srcs, is_bh,
                                           self.cfg.boxsize)
        # stored in the offset-free output frame (as Position and the FOF
        # MassCenterPosition), so that the snapshot block agrees with
        # Position across the per-step offset re-randomization
        off = torch.as_tensor(self._ipos_offset.astype(np.float64)
                              * 2.0 ** -32 * self.cfg.boxsize,
                              dtype=torch.float32, device=self.device)
        mp_out = torch.remainder(mp_pos - off[None, :],
                                 float(np.float32(self.cfg.boxsize)))
        self.bh = self.bh.replace(min_pot_pos=torch.where(
            found[:, None], mp_out, self.bh.min_pot_pos))
        ip_new = torch.as_tensor(
            pos_to_fixed(mp_pos.cpu().numpy(), self.cfg.boxsize).astype(
                np.int64), device=self.device)
        self.pdata = self.pdata.replace(
            ipos=torch.where(found[:, None], ip_new, pd.ipos))

    def _write_bh_details(self, atime):
        """Per-step per-BH detail records (bhinfo.c:1-204 analog): float64
        rows of 12 (ID, a, BH mass, mdot, density, position, mass, Mtrack,
        progenitors, kinetic energy) appended to
        BlackholeDetails/BH-Details-R0 (layout: tools/read_bh_details.py)."""
        pd = self.pdata
        rows = np.flatnonzero((pd.valid & (pd.ptype == 5)).cpu().numpy())
        if rows.size == 0:
            return
        rec = np.zeros((rows.size, 12), np.float64)
        rec[:, 0] = pd.pid.cpu().numpy()[rows]
        rec[:, 1] = atime
        for col, arr in ((2, self.bh.bh_mass), (3, self.bh.mdot),
                         (4, self.bh.bh_density), (8, pd.mass),
                         (9, self.bh.mtrack), (10, self.bh.count_progs),
                         (11, self.bh.kinetic_energy)):
            rec[:, col] = arr.cpu().numpy()[rows]
        rec[:, 5:8] = self._output_pos()[rows]
        d = os.path.join(self.cfg.output_dir, "BlackholeDetails")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "BH-Details-R0"), "ab") as fh:
            fh.write(rec.tobytes())

    def _ensure_bh(self):
        """Create BhData on first use, and give IC black holes (type-5 rows
        without a BlackholeMass block, which is optional on read) the seed
        subgrid mass and their mass as Mtrack: Bondi mdot ~ Mbh^2 would
        otherwise stay zero forever."""
        from .physics.blackhole import BhData
        if self.bh is None:
            self.bh = BhData.zeros(self.pdata.capacity, self.device)
        fix = self.pdata.valid & (self.pdata.ptype == 5) \
            & (self.bh.bh_mass <= 0)
        if bool(fix.any()):
            self.bh = self.bh.replace(
                bh_mass=torch.where(fix, float(np.float32(
                    self.cfg.bh_seed_mass)), self.bh.bh_mass),
                mtrack=torch.where(fix, self.pdata.mass, self.bh.mtrack))

    def seed_black_holes_from_fof(self, cat):
        """FOF seeding (fof_seed): the densest gas particle of each halo
        above MinFoFMassForNewSeed and MinMStarForNewSeed that holds no BH
        becomes one.  Returns the number seeded."""
        from .physics import blackhole as bhmod
        if self.bh is None:
            self.bh = bhmod.BhData.zeros(self.pdata.capacity, self.device)
        self.pdata, self.bh, nseeded = bhmod.seed_black_holes(
            self._bh_params(), cat, self.pdata, self.bh, self.sph,
            self.atime)
        self.bh_seeded.append(nseeded)
        return nseeded

    def find_hydro_timestep_dloga(self):
        """Courant + Hsml-change criteria (timestep.c:1075-1090)."""
        from .utils.constants import GAMMA
        atime = self.atime
        hubble = self.CP.hubble_function(atime)
        par = self.cfg.timestep
        fac3 = atime ** (3 * (1 - GAMMA) / 2.0)
        vsig = torch.clamp(self.sph.max_signal_vel, min=1e-30)
        dt_c = 2 * par.CourantFac * atime * self.pdata.hsml / (fac3 * vsig)
        dt_h = par.CourantFac * atime * atime * torch.abs(
            self.pdata.hsml / (self.pdata.dt_hsml + 1e-20))
        dt = torch.minimum(dt_c, dt_h)
        dloga = float(torch.where(self.gas_mask, dt, float("inf")).min()) \
            * hubble
        return min(dloga, par.MaxSizeTimestep)

    def _gas_kick(self, mask, hk, dl):
        """Hydro kick and entropy update of the gas in mask: vel +=
        hydro_accel * hk, entropy += dt_entropy * dl, floored at
        MinGasTemp's entropy and at half the old entropy (apply_hydro_
        half_kick, timestep.c; check_density_entropy).  hk and dl are
        float32 tensors broadcast over the particles, or scalars."""
        from .utils.constants import GAMMA_MINUS1
        gas = self.gas_mask & mask
        sph = self.sph
        vel = self.pdata.vel + torch.where(
            gas[:, None], sph.hydro_accel * hk, 0.0)
        ent = sph.entropy + sph.dt_entropy * dl
        a3 = self.atime ** 3
        minent = GAMMA_MINUS1 * self._min_egy_spec / torch.clamp(
            sph.density / a3, min=1e-30) ** GAMMA_MINUS1
        ent = torch.maximum(ent, minent)
        # entropy may at most halve per step (Gadget convention)
        ent = torch.maximum(ent, 0.5 * sph.entropy)
        self.sph = sph.replace(entropy=torch.where(gas, ent, sph.entropy))
        self.pdata = self.pdata.replace(vel=vel)

    # -- stepping ------------------------------------------------------

    def find_pm_timestep(self):
        asmth_len = self.cfg.asmth * self.cfg.boxsize / self.cfg.nmesh
        dloga = get_long_range_timestep_dloga(
            self.pdata, self.CP, self.atime, asmth_len,
            self.cfg.timestep, self.cfg.fast_particle_type,
            self._omega_per_type)
        return get_pm_timestep_ti(dloga, self.timeline, self.ti_current,
                                  self.ti_current)

    def _apply_half_kick(self, t0, t1):
        """Gravity (+hydro, +entropy) kick over [t0, t1]
        (apply_half_kick / apply_hydro_half_kick, timestep.c)."""
        accel = self.pdata.grav_pm + self.pdata.grav_accel
        vel = kick(self.pdata.vel, accel, self.tf.gravkick(t0, t1))
        self.pdata = self.pdata.replace(vel=vel)
        if self.has_gas and self._gas_initialized:
            dloga = (self.timeline.loga_from_ti(t1)
                     - self.timeline.loga_from_ti(t0))
            self._gas_kick(self.pdata.valid,
                           float(np.float32(self.tf.hydrokick(t0, t1))),
                           float(np.float32(dloga)))

    def _apply_pm_half_kick(self, t0, t1):
        """Long-range-only kick (apply_PM_half_kick, timestep.c)."""
        vel = kick(self.pdata.vel, self.pdata.grav_pm,
                   self.tf.gravkick(t0, t1))
        self.pdata = self.pdata.replace(vel=vel)

    def _bin_half_kick(self, mask, bins, ti, maxbin, opening):
        """Per-timebin short-range half kick for the particles in mask,
        each over half of its own bin's interval (apply_half_kick for the
        active list, timestep.c:520-600).  The kick factors are tabulated
        on the host for the bins the masked particles occupy (each is a
        quadrature)."""
        bins = torch.clamp(bins, 0, maxbin).long()
        gas = self.has_gas and self._gas_initialized
        gfac = np.zeros(maxbin + 1, np.float32)
        hfac = np.zeros(maxbin + 1, np.float32)
        dlg = np.zeros(maxbin + 1, np.float32)
        for b in torch.unique(bins[mask]).tolist():
            if b < 1:
                continue
            db = 1 << b
            ta, tb = (ti, ti + db // 2) if opening else (ti - db // 2, ti)
            gfac[b] = self.tf.gravkick(ta, tb)
            if gas:
                hfac[b] = self.tf.hydrokick(ta, tb)
                dlg[b] = (self.timeline.loga_from_ti(tb)
                          - self.timeline.loga_from_ti(ta))
        gk = torch.as_tensor(gfac, device=self.device)[bins]
        vel = self.pdata.vel + torch.where(
            mask[:, None], self.pdata.grav_accel * gk[:, None], 0.0)
        self.pdata = self.pdata.replace(vel=vel)
        if gas:
            self._gas_kick(
                mask, torch.as_tensor(hfac, device=self.device)[bins][:, None],
                torch.as_tensor(dlg, device=self.device)[bins])

    def _drift_all(self, ti, dti):
        """Drift every particle (positions and predicted Hsml) over
        [ti, ti + dti]."""
        ddrift = self.tf.drift(ti, ti + dti)
        hsml = self.pdata.hsml + self.pdata.dt_hsml * float(
            np.float32(ddrift))
        hsml = torch.clamp(hsml, 0.0, 0.45 * self.cfg.boxsize)
        self.pdata = self.pdata.replace(
            ipos=drift(self.pdata.ipos, self.pdata.vel, ddrift,
                       1.0 / self.cfg.boxsize),
            hsml=hsml)

    def _update_random_offset(self):
        """Re-randomize the internal box shift (update_random_offset,
        partmanager.c:43-60; applied per PM step, run.c:411).  numpy's
        RandomState gives the same shifts as the JAX package."""
        frac = self.cfg.random_particle_offset / self.cfg.nmesh
        rng = np.random.RandomState(
            (self.cfg.random_seed * 9999991 + self._nstep_total)
            % (2 ** 31 - 1))
        new = (rng.random_sample(3) * frac * 2.0 ** 32).astype(
            np.uint64).astype(np.uint32)
        delta = (new.astype(np.int64)
                 - self._ipos_offset.astype(np.int64)) & MASK32
        delta = torch.as_tensor(delta, device=self.device)
        self.pdata = self.pdata.replace(
            ipos=(self.pdata.ipos + delta[None, :]) & MASK32)
        self._ipos_offset = new

    def _unshifted_ipos(self):
        """Fixed-point positions on the device with the internal random
        shift removed."""
        off = torch.as_tensor(self._ipos_offset.astype(np.int64),
                              device=self.device)
        return (self.pdata.ipos - off[None, :]) & MASK32

    def _output_pos(self, sel=None):
        """Float positions with the internal random shift removed
        (petaio position IO, partmanager.h:79-84)."""
        ip = self.pdata.ipos.cpu().numpy()
        if sel is not None:
            ip = ip[sel]
        ip = ((ip - self._ipos_offset.astype(np.int64)) & MASK32).astype(
            np.uint32)
        return fixed_to_pos(ip, self.cfg.boxsize)

    def step(self, dti: int):
        """One global KDK step over dti integer ticks."""
        t0, t1 = self.ti_current, self.ti_current + dti
        th = t0 + dti // 2
        if self.cfg.random_particle_offset > 0 and self._nstep_total:
            self._update_random_offset()
        self._nstep_total += 1
        # K: half kick with forces at t0
        self._apply_half_kick(t0, th)
        # D: full drift (positions and predicted Hsml)
        self._drift_all(t0, dti)
        self.ti_current = t1
        # Forces at t1: hydro first (run.c:466-489), then gravity
        if self.has_gas and self.cfg.hydro_on:
            # the halo wind model's DM velocity dispersion, on PM steps as
            # in the reference (run.c:646-647)
            if self.cfg.wind_on and self._gas_initialized \
                    and self.cfg.wind_model & 4:
                self._compute_vdisp()
            self.compute_hydro(self.timeline.dloga_from_dti(dti, t0))
        self.compute_forces()
        self.force_evals += self.pdata.num_valid
        # K: half kick with forces at t1
        self._apply_half_kick(th, t1)
        # Strang-split source terms (run.c:586-604): black holes, then
        # cooling and star formation, then metal return
        dloga = self.timeline.dloga_from_dti(dti, t0)
        if self.has_gas and self._gas_initialized \
                and self.cfg.black_hole_on:
            self.apply_blackholes(dloga)
        self._source_terms(dloga)
        if self.has_gas and self._gas_initialized \
                and self.cfg.metal_return_on:
            self.apply_metal_return(dloga)

    def step_hierarchical(self, dti_pm: int):
        """One PM interval with per-particle timebin sub-cycling
        (find_timesteps + the active-list KDK of run.c:374-520,
        timestep.c:298-503); returns the number of substeps.

        Particles carry power-of-two bins from the acceleration criterion;
        each substep advances the clock by the smallest active bin, drifts
        every particle, and recomputes the short-range force only for the
        targets closing their bin interval.  The PM force is a global half
        kick at each end of the interval.  Bins and tick counts are int64
        tensors (1 << bin)."""
        t0 = self.ti_current
        t_end = t0 + dti_pm
        if self.cfg.random_particle_offset > 0 and self._nstep_total:
            self._update_random_offset()
        self._nstep_total += 1
        mid = t0 + dti_pm // 2
        self._apply_pm_half_kick(t0, mid)

        soft = 2.8 * self.cfg.gravity_softening * self._dm_mean_sep()
        bins = assign_particle_bins(
            self.pdata, self.sph if self._gas_initialized else None,
            self.gas_mask, self.CP, self.atime, soft, self.timeline, t0,
            self.cfg.timestep, dti_pm)
        # a bin's interval must divide both t0 and dti_pm, or its
        # boundaries never meet the clock (is_timebin_active analog)
        maxbin = get_timestep_bin(dti_pm)
        tz = (t0 & -t0).bit_length() - 1 if t0 > 0 else 62
        tzp = (dti_pm & -dti_pm).bit_length() - 1
        maxbin = max(1, min(maxbin, tz, tzp))
        bins = torch.clamp(bins, 1, maxbin)
        if self.cfg.timestep.ForceEqualTimesteps:
            bins = torch.full_like(bins, int(bins.min()))
        self.pdata = self.pdata.replace(timebin=bins)
        dtib = torch.ones_like(bins, dtype=torch.int64) << bins.long()
        valid = self.pdata.valid
        log = dict(bins=torch.bincount(bins[valid].long(),
                                       minlength=maxbin + 1).tolist(),
                   actives=[])

        ti = t0
        n_sub = 0
        while ti < t_end:
            active = valid & ((ti & (dtib - 1)) == 0)
            self._bin_half_kick(active, bins, ti, maxbin, opening=True)
            dti_s = int(torch.where(active, dtib, 1 << 62).min())
            dti_s = min(dti_s, t_end - ti)
            # drift ALL particles (drift is global, drift.c)
            self._drift_all(ti, dti_s)
            ti += dti_s
            self.ti_current = ti
            closing = valid & ((ti & (dtib - 1)) == 0)
            n_closing = int(closing.sum())
            if self.has_gas and self.cfg.hydro_on \
                    and self._gas_initialized:
                self.compute_hydro(
                    self.timeline.dloga_from_dti(dti_s, ti - dti_s),
                    active=closing)
            self._compute_tree_forces(active=closing)
            self._bin_half_kick(closing, bins, ti, maxbin, opening=False)
            self.force_evals += n_closing
            log["actives"].append(n_closing)
            # gas source terms per closing bin, each particle over its own
            # interval (cooling_and_starformation on the active list,
            # run.c:374-520 + timestep.c:298)
            if self.has_gas and self._gas_initialized and (
                    self.cfg.starformation_on or self.cfg.cooling_on):
                dlg1 = self.timeline.dloga_from_dti(1, ti)
                dloga_pp = torch.where(
                    closing, dtib.to(torch.float32) * float(np.float32(dlg1)),
                    0.0)
                self._source_terms(dloga_pp, active=closing)
                if self.cfg.starformation_on:
                    # spawning may have added stars: refresh the loop's
                    # masks so that new particles drift and kick
                    valid = self.pdata.valid
                    bins = torch.clamp(self.pdata.timebin, 1, maxbin)
                    dtib = torch.ones_like(dtib) << bins.long()
            # re-derive the bins of the closing particles from the fresh
            # forces (timestep.c:298-503): a bin may shrink at its own
            # boundary, and grow only when the longer interval is aligned
            # with the clock (is_timebin_active rule)
            if ti < t_end and not self.cfg.timestep.ForceEqualTimesteps:
                new_bins = assign_particle_bins(
                    self.pdata, self.sph if self._gas_initialized else None,
                    self.gas_mask, self.CP, self.atime, soft, self.timeline,
                    ti, self.cfg.timestep, dti_pm)
                new_bins = torch.clamp(new_bins, 1, maxbin)
                dtin = torch.ones_like(dtib) << new_bins.long()
                aligned_new = (ti & (dtin - 1)) == 0
                bins = torch.where(closing & (new_bins < bins), new_bins,
                                   bins)
                bins = torch.where(closing & (new_bins > bins)
                                   & aligned_new, new_bins, bins)
                self.pdata = self.pdata.replace(timebin=bins)
                dtib = torch.ones_like(dtib) << bins.long()
            n_sub += 1
        # long-range force refresh + closing PM kick at the sync point
        self.compute_forces(tree=False)
        self._apply_pm_half_kick(mid, t_end)
        # cooling and star formation ran per closing bin in the loop; black
        # holes and metal return run once per PM interval, as in the JAX
        # package (the reference restricts them to the active BHs and
        # stars instead, blackhole.c:216)
        if self.has_gas and self._gas_initialized:
            dloga = self.timeline.dloga_from_dti(dti_pm, t0)
            if self.cfg.black_hole_on:
                self.apply_blackholes(dloga)
            if self.cfg.metal_return_on:
                self.apply_metal_return(dloga)
        log["n_sub"] = n_sub
        self.step_log.append(log)
        return n_sub

    def run(self, max_steps: Optional[int] = None, verbose=True):
        """Main loop (run.c:314-800): global KDK steps, or hierarchical
        ones with SplitGravityTimestepsOn."""
        os.makedirs(self.cfg.output_dir, exist_ok=True)
        from .utils.hci import (HCIManager, HCI_STOP, HCI_TERMINATE,
                                HCI_CHECKPOINT, HCI_TIMEOUT,
                                HCI_AUTO_CHECKPOINT)
        hci = HCIManager(self.cfg.output_dir,
                         time_limit_cpu=self.cfg.time_limit_cpu,
                         auto_checkpoint_time=self.cfg.auto_snapshot_time)
        hydro = self.has_gas and self.cfg.hydro_on
        if hydro and not self._gas_initialized:
            if self._gas_restore:
                self._restore_gas()
            else:
                self.setup_gas()
        if hydro:
            self.compute_hydro(dloga=0.0)
        self.compute_forces()
        nsteps = 0
        while self.ti_current < self.timeline.ti_end:
            action = hci.query()
            if action in (HCI_STOP, HCI_TIMEOUT):
                self.write_snapshot()
                break
            if action == HCI_TERMINATE:
                break
            if action in (HCI_CHECKPOINT, HCI_AUTO_CHECKPOINT):
                self.write_snapshot()
            step_t0 = _time.monotonic()
            dti = self.find_pm_timestep()
            if hydro:
                from .timeline import round_down_power_of_two
                dti_h = round_down_power_of_two(self.timeline.dti_from_dloga(
                    self.find_hydro_timestep_dloga(), self.ti_current))
                dti = min(dti, max(dti_h, 1))
            if dti <= 0:
                # dump state for post-mortem before dying
                # (emergency snapshot, run.c:776-780); a failed write
                # must not hide the error
                try:
                    self.write_snapshot(label=999)
                except Exception:
                    pass
                raise RuntimeError(
                    f"Bad timestep {dti}; emergency snapshot "
                    f"{self.cfg.snapshot_base}_999 written")
            if self.cfg.split_gravity_timesteps and self.cfg.tree_grav_on:
                self.step_hierarchical(dti)
            else:
                self.step(dti)
            nsteps += 1
            hci.update_longest_step(_time.monotonic() - step_t0)
            # QSO helium reionization runs on PM steps during its epoch,
            # with a fresh FOF (do_heiii_reionization)
            if (self.cfg.qso_lightup_on and self.has_gas
                    and self._gas_initialized):
                self._run_qso_lightup(self.timeline.dloga_from_dti(
                    dti, self.ti_current - dti))
            if self.cfg.plane_output_list:
                self._maybe_write_planes()
            if self.cfg.lightcone_on:
                self._run_lightcone(dti)
            if (self.cfg.excursion_set_on and self.has_gas
                    and self._gas_initialized):
                self._run_excursion_set()
            if self.cfg.output_energy_debug:
                self._check_invariants()
            sp = self.timeline.find_current_sync_point(self.ti_current)
            if sp is not None and sp.write_snapshot:
                self.write_snapshot()
                if self.cfg.output_energy_debug:
                    self.energy_statistics()
                if sp.write_fof or (self.cfg.snapshot_with_fof
                                    and sp.write_snapshot):
                    cat = self.run_fof()
                    if self.cfg.black_hole_on:
                        self.seed_black_holes_from_fof(cat)
            if self.last_power is not None:
                D1 = self.CP.GrowthFactor(self.atime, 1.0)
                self.last_power.save(self.cfg.output_dir, self.atime, D1)
            # per-step timer dump (the reference's cpu.txt,
            # walltime_summary in run.c:553)
            with open(os.path.join(self.cfg.output_dir, "cpu.txt"),
                      "a") as fh:
                fh.write(f"Step {nsteps}, Time: {self.atime:g}\n")
                tot = max(self.walltime.elapsed(), 1e-12)
                for name in sorted(self.walltime.totals,
                                   key=self.walltime.totals.get,
                                   reverse=True):
                    s = self.walltime.totals[name]
                    fh.write(f"    {name:<24s} {s:10.2f} "
                             f"{100 * s / tot:6.2f}%\n")
            if verbose:
                dloga = self.timeline.dloga_from_dti(
                    dti, self.ti_current - dti)
                print(f"[step {nsteps}] a={self.atime:.5f} "
                      f"dloga={dloga:.4g}")
            if max_steps and nsteps >= max_steps:
                break
        return nsteps

    def run_sharded(self, mesh, max_steps=None, verbose=True,
                    hierarchical=False, layer_sync=False):
        """Multi-rank main loop (run.c:358-800 at scale; the JAX package's
        run_sharded).

        mesh: parallel.mesh.ShardMesh of this rank.  Every rank holds the
        whole host state (read from the same IC, as every MPI rank reads
        the snapshot before the domain scatter, petaio.c:33-68), sets up
        its gas there (setup_gas or the snapshot's, then a first
        compute_hydro) and keeps the rows of its slab: parallel/driver.py's
        KDK step (global) or per-timebin substeps with a PM refresh at each
        end of the interval (hierarchical=True, the sharded
        step_hierarchical), over count-balanced boundaries recomputed from
        the x histogram summed over ranks after every step.  With gas the
        step runs the sharded density and hydro force, the entropy
        integration, and cooling or cooling with star formation (the new
        stars appended to the rank that formed them, sh03's subgrid winds
        before they spawn; during the excursion set's epoch the cooling
        reads each row's J21 rates); a density strip too narrow for the
        converged hsml runs the same step again with a strip 1.5 times
        wider, which the rest of the run keeps.  The PM bins the power of
        every PM step (rank 0 writes the powerspectrum file after the
        step, as the single-device loop); with MassiveNuLinRespOn the
        modes are scaled by the neutrino table, which each rank steps on
        the host from the CDM power of the rows' deposit summed over
        ranks (the snapshots carry its history); with HybridNeutrinosOn
        the type-2 rows neither source gravity (tree and PM) nor feel the
        PM force before NuPartTime.  After each global step and each
        substep the light cone's crossers of each rank's rows go to that
        rank's stripe.  After each global step, or each PM step of the
        hierarchical run, the passes run in the JAX package's order: the
        neighbour winds of the new stars (vs08, ofjt10:
        parallel/winds.py), the black holes (parallel/blackhole.py, which
        takes swallowed gas and merged BHs out of the rows), the metal
        return (parallel/metals.py), QSO helium reionization (bubbles
        around the halos of the distributed catalogue, the HeIII flag a
        column of the rows; rank 0 appends to helium.txt), the excursion
        set (the grids' deposits summed over ranks; J21 and zreion columns
        of the rows) and the lensing planes (each rank's counts summed
        over ranks, rank 0 writes); decoupled wind gas feels no hydro
        force (the single-device rule).  Timestep statistics are summed
        over ranks, so no step gathers rows.  Sync points write striped
        snapshots (parallel/snapshot.py) and, with SnapshotWithFOF, the
        distributed FOF's PIG (parallel/fof.py), after which BlackHoleOn
        seeds a BH in each halo above the seeding thresholds that holds
        none (parallel/fof.seed_convert).  Rank 0 writes sfr.txt from the
        sums over ranks, a line for each step that formed stellar mass
        (total_sm > 0, sfr_eff.c:356).  The host mirror (self.pdata,
        self.sph, self.stars, self.bh) is refreshed from every rank's rows
        at the end.  Neither blackholes.txt nor BH-Details is written (the
        JAX package's sharded run writes neither).

        layer_sync=True synchronises the device at each layer boundary of
        the step, so that ``self.walltime`` splits the step's seconds by
        layer; ``self.sharded_log`` gets one dict per PM step,
        ``self.sharded_rows`` this rank's rows by type at the end and
        ``self.sharded_formed`` the stars this rank formed;
        ``self.wind_kicks``, ``bh_swallowed``, ``bh_mergers`` and
        ``bh_seeded`` count over all ranks, ``qso_bubbles`` and
        ``uvbg_updates`` as in run().  Raises ValueError before the first
        step for a combination this driver does not carry
        (check_sharded_supported)."""
        check_sharded_supported(self.cfg, self.has_gas)
        from .parallel import collectives as coll
        from .parallel.decomp import balanced_boundaries
        from .parallel.driver import (MAXB, GasStep, Layers, PMOptions,
                                      assign_bins, measure_power_multi,
                                      pm_refresh, sharded_step)
        from .pm.gravity import _finalize_power
        from .parallel.fof import SEED_NONE, seed_convert, sharded_fof
        from .parallel.mesh import (default_n_local, fetch_global,
                                    shard_particles)
        from .physics import winds as windmod
        from .parallel.snapshot import (write_snapshot_sharded,
                                        write_pig_sharded)
        from .parallel.sph import STRIP_WIDEN
        from .physics.fof import FOFParams
        from .timeline import round_down_power_of_two
        from .utils.constants import GAMMA
        from .utils.hci import (HCIManager, HCI_STOP, HCI_TERMINATE,
                                HCI_CHECKPOINT, HCI_TIMEOUT,
                                HCI_AUTO_CHECKPOINT)
        from .utils.log import message, endrun

        if torch.device(mesh.device) != torch.device(self.device):
            raise ValueError(f"rank device {mesh.device} differs from the "
                             f"simulation's {self.device}")
        S = mesh.size
        log2s = int(np.log2(S))
        assert 1 << log2s == S, "rank count must be a power of two"
        with_gas = bool(self.has_gas and self.cfg.hydro_on)
        with_sfr = bool(with_gas and self.cfg.starformation_on)
        with_cooling = bool(with_gas and self.cfg.cooling_on
                            and not with_sfr)
        subgrid = bool(self.cfg.wind_model & windmod.WIND_SUBGRID)
        wind_sharded = bool(with_sfr and self.cfg.wind_on and subgrid)
        wind_neighbors = bool(with_sfr and self.cfg.wind_on and not subgrid)
        with_metals = bool(with_sfr and self.cfg.metal_return_on)
        with_bh = bool(with_gas and self.cfg.black_hole_on)
        # the BH reposition reads the potential column (bhdynfric.c:199)
        with_potential = bool(self.cfg.output_potential
                              or (with_bh and self.cfg.bh_reposition))
        with_nu = bool(self.cfg.massive_nu_lin_resp_on)
        # QSO lightup and the excursion set carry per-row columns (the
        # HeIII flag; J21 and zreion) in the rows
        with_qso = bool(with_gas and self.cfg.qso_lightup_on)
        with_excursion = bool(with_gas and self.cfg.excursion_set_on)
        os.makedirs(self.cfg.output_dir, exist_ok=True)
        if with_gas and not self._gas_initialized:
            if self._gas_restore:
                self._restore_gas()
            else:
                self.setup_gas()
        if with_gas:
            self.compute_hydro(dloga=0.0)
        if self._tree_grav is None:
            self.compute_forces(measure_power=False)
        tg = self._tree_grav
        lay = Layers(self.walltime, mesh.device, layer_sync)
        self.sharded_log = []

        # ---- this rank's rows of the host state (shard_particles) ----
        pd = self.pdata
        acc0 = pd.grav_accel + pd.grav_pm
        cols = {"ipos": pd.ipos, "vel": pd.vel, "mass": pd.mass,
                "pid": pd.pid, "ptype": pd.ptype,
                "amag": torch.sqrt(torch.sum(acc0 * acc0, dim=-1)),
                "grav_acc": pd.grav_accel if hierarchical else acc0}
        if hierarchical:
            cols["pm_acc"] = pd.grav_pm
            cols["bins"] = torch.ones_like(pd.ptype)
        if with_potential:
            # the PM part (single-device semantics); the tree part joins
            # it in the step (global) or per closing bin (hierarchical)
            cols["potential"] = pd.potential
            cols["pm_pot"] = pd.potential
            if hierarchical:
                cols["tree_pot"] = torch.zeros_like(pd.potential)
        if with_gas:
            sph = self.sph
            cols.update(
                gas_mask=self.gas_mask, hsml=pd.hsml, entropy=sph.entropy,
                dtent=sph.dt_entropy, density=sph.density,
                egywt=sph.egy_wt_density, divv=sph.div_vel,
                curlv=sph.curl_vel, dhsml_egy=sph.dhsml_egy_factor,
                dt_hsml=pd.dt_hsml, hydro_acc=sph.hydro_accel,
                maxsig=sph.max_signal_vel)
        if with_cooling or with_sfr:
            if self._cooling is None:
                self._init_cooling()
            cols.update(ne=self.sph.ne, metallicity=self.sph.metallicity)
        if with_qso:
            cols["he_iii_ionized"] = self.sph.he_iii_ionized
        if with_excursion:
            cols.update(local_j21=self.sph.local_j21,
                        zreion=self.sph.zreion)
        if with_sfr:
            if self._sfr is None:
                self._init_sfr()
            if self.stars is None:
                from .physics.stars import StarData
                self.stars = StarData.zeros(pd.capacity, self.device)
            cols.update(sfr=self.sph.sfr, delay_time=self.sph.delay_time,
                        formation_time=self.stars.formation_time,
                        birth_density=self.stars.birth_density,
                        birth_metallicity=self.stars.metallicity)
        if with_metals:
            # one [N, 9] species column: the gas's evolving metals, a
            # star's birth composition (metal_return.c's NMETALS layout)
            is_star0 = pd.valid & (pd.ptype == 4)
            msep = float(np.float32(2.0 * self.cfg.boxsize / max(
                1.0, np.cbrt(float(pd.num_valid)))))
            sh0 = self._star_hsml if self._star_hsml is not None else \
                torch.where(pd.hsml > 0, pd.hsml, msep)
            cols.update(
                metals=torch.where(is_star0[:, None], self.stars.metals,
                                   self.sph.metals),
                star_hsml=torch.where(is_star0, torch.where(
                    sh0 > 0, sh0, msep), 0.0).to(torch.float32),
                total_mass_returned=self.stars.total_mass_returned,
                last_enrichment_myr=self.stars.last_enrichment_myr)
        if with_bh:
            self._ensure_bh()
            bh = self.bh
            cols.update(bh_mass=bh.bh_mass, bh_mdot=bh.mdot,
                        bh_density=bh.bh_density, bh_mtrack=bh.mtrack,
                        bh_progs=bh.count_progs, bh_ke=bh.kinetic_energy,
                        bh_vdisp=bh.vdisp)
            if with_sfr:
                # one formation-time column: a BH row's seeding time
                cols["formation_time"] = torch.where(
                    pd.valid & (pd.ptype == 5), bh.formation_time,
                    cols["formation_time"])
        n_local = default_n_local(pd.capacity, S)
        st = shard_particles(cols, pd.valid.cpu(), mesh, n_local)
        for k, v in st.items():
            assert v.device == torch.device(mesh.device), (k, v.device)

        rcut_box = self.cfg.rcut * self.cfg.asmth / self.cfg.nmesh
        hist_bits = 12
        # count-balanced boundaries from the host state before the first
        # step (domain_decompose, domain.c:106)
        x = pd.ipos[:, 0][pd.valid].cpu().numpy()
        bounds = balanced_boundaries(np.bincount(
            x >> (32 - hist_bits), minlength=1 << hist_bits), S)

        def nu_response(ipos, weights, atime):
            """The neutrino table of a PM step from the CDM power of the
            rows' deposit summed over ranks (the same on every rank)."""
            nm = self.cfg.nmesh
            return self._nu_table_step(_finalize_power(
                *measure_power_multi(ipos, weights, nm, mesh, nm),
                self.pm_cfg), atime)

        # every PM step bins the power (the powerspectrum files)
        common = dict(nmesh=self.cfg.nmesh, boxsize=self.cfg.boxsize,
                      gconst=self.CP.GravInternal, asmth=self.cfg.asmth,
                      with_potential=with_potential, hist_bits=hist_bits,
                      layers=lay, pm=PMOptions(
                          nbins=self.cfg.nmesh,
                          nu_response=nu_response if with_nu else None))
        f32 = np.float32
        gas = None
        if with_gas:
            from .sph.hydra import HydroParams
            gas = GasStep(
                self._density_params(),
                HydroParams(
                    kernel_type=self.cfg.density_kernel_type,
                    art_bulk_visc=self.cfg.art_bulk_visc,
                    density_independent=self.cfg.density_independent_sph,
                    density_contrast_limit=self.cfg.density_contrast_limit),
                self.cfg.density_independent_sph, self._min_egy_spec,
                sfr_fn=self._sharded_sfr_fn() if with_sfr else None,
                cooling_fn=(self._sharded_cooling_fn() if with_cooling
                            else None),
                wind_fn=self._sharded_wind_fn() if wind_sharded else None,
                decouple=with_sfr and self.cfg.wind_on)

        def source_scalars(scal, ti_key, a1):
            """The source terms' host scalars at a1: the redshift, the
            global UV background (float32, as the JAX package's step) and,
            with star formation, the draws' key of the step."""
            if not (with_sfr or with_cooling):
                return scal
            z1 = 1.0 / a1 - 1.0
            scal["redshift"] = float(f32(z1))
            uv = self._treecool.get_global_uvbg(z1)
            scal["uvbg"] = type(uv)(*(float(f32(v)) for v in (
                uv.gJH0, uv.gJHe0, uv.gJHep, uv.epsH0, uv.epsHe0,
                uv.epsHep, uv.self_shield_dens)))
            if with_sfr:
                from .utils import threefry
                scal["key"] = threefry.prng_key(
                    (self.cfg.random_seed + ti_key) % (2 ** 31))
            return scal

        def step(st, scal):
            """One step; a density strip too narrow for the converged hsml
            runs it again with a wider one (kept for the rest of the
            run)."""
            while True:
                new, stats = sharded_step(st, bounds, scal, mesh, tg=tg,
                                          rcut=self.cfg.rcut,
                                          hierarchical=hierarchical,
                                          gas=gas, **common)
                if stats.get("strip_ok", True):
                    return new, stats
                gas.margin *= STRIP_WIDEN
                if verbose:
                    message(f"[sharded] density strip too narrow: margin "
                            f"{gas.margin:.4g}")

        def dloga_from_stats(stats, atime, pm_only=False):
            """The host timestep policy from statistics summed over ranks
            (get_long_range_timestep_dloga + the acceleration and Courant
            criteria, timestep.c:1063-1300); pm_only keeps the
            displacement criterion alone (the hierarchical PM interval)."""
            par = self.cfg.timestep
            hubble = self.CP.hubble_function(atime)
            dloga = par.MaxSizeTimestep
            asmth_len = self.cfg.asmth * self.cfg.boxsize / self.cfg.nmesh
            vsum = stats["vsum"].cpu().numpy().astype(np.float64)
            cnt = stats["count"].cpu().numpy().astype(np.float64)
            mmin = stats["min_mass"].cpu().numpy().astype(np.float64)
            for t in range(6):
                if cnt[t] == 0 or self._omega_per_type is None:
                    continue
                omega = self._omega_per_type[t]
                if omega <= 0:
                    continue
                dmean = (mmin[t] / (omega * self.CP.RhoCrit)) ** (1 / 3)
                vrms = np.sqrt(vsum[t] / cnt[t])
                if vrms <= 0:
                    continue
                d1 = (par.MaxRMSDisplacementFac * hubble * atime * atime
                      * min(asmth_len, dmean) / vrms)
                if t != self.cfg.fast_particle_type:
                    dloga = min(dloga, d1)
            if pm_only:
                return max(dloga, par.MinSizeTimestep)
            amax = float(stats["max_acc"])
            if amax > 0 and self.cfg.tree_grav_on:
                eta_eps = 2 * par.ErrTolIntAccuracy * atime * tg.softening
                dloga = min(dloga, float(
                    np.sqrt(eta_eps / (amax / atime ** 2)) * hubble))
            if with_gas:
                fac3 = atime ** (3 * (1 - GAMMA) / 2.0)
                hos = stats["min_h_over_sig"]
                if np.isfinite(hos):
                    dloga = min(dloga, 2 * par.CourantFac * atime * hos
                                / fac3 * hubble)
                hod = stats["min_h_over_dth"]
                if np.isfinite(hod):
                    dloga = min(dloga, par.CourantFac * atime * atime
                                * hod * hubble)
            return max(dloga, par.MinSizeTimestep)

        def mirror_to_host():
            """Every rank's rows, in rank order, into the host state
            (outputs and the final state only); the host arrays grow when
            new stars outnumber the free rows."""
            rows = {k: fetch_global(v, mesh) for k, v in st.items()}
            n = rows["ipos"].shape[0]
            cap = max(int(self.pdata.capacity), n)

            def put(field_arr, key):
                full = field_arr.clone()
                full[:n] = rows[key].to(self.device, full.dtype)
                return full

            new = ParticleData.zeros(cap, device=self.device)
            names = dict(ipos="ipos", vel="vel", mass="mass", pid="pid",
                         ptype="ptype", grav_accel="grav_acc")
            if hierarchical:
                names.update(grav_pm="pm_acc", timebin="bins")
            if with_potential:
                names["potential"] = "pm_pot"
            if with_gas:
                names.update(hsml="hsml", dt_hsml="dt_hsml")
            upd = {f: put(getattr(new, f), k) for f, k in names.items()}
            valid = torch.zeros(cap, dtype=torch.bool, device=self.device)
            valid[:n] = True
            upd["valid"] = valid
            self.pdata = new.replace(**upd)
            if with_gas:
                from .sph.state import SphData
                sph = SphData.zeros(cap, self.device)
                names = dict(entropy="entropy", dt_entropy="dtent",
                             density="density", egy_wt_density="egywt",
                             div_vel="divv", curl_vel="curlv",
                             dhsml_egy_factor="dhsml_egy",
                             hydro_accel="hydro_acc",
                             max_signal_vel="maxsig")
                if with_cooling or with_sfr:
                    names.update(ne="ne", metallicity="metallicity")
                if with_sfr:
                    names.update(sfr="sfr", delay_time="delay_time")
                if with_qso:
                    names["he_iii_ionized"] = "he_iii_ionized"
                if with_excursion:
                    names.update(local_j21="local_j21", zreion="zreion")
                self.sph = sph.replace(**{f: put(getattr(sph, f), k)
                                          for f, k in names.items()})
            if with_sfr:
                from .physics.stars import StarData
                stars = StarData.zeros(cap, self.device)
                names = dict(formation_time="formation_time",
                             birth_density="birth_density",
                             metallicity="birth_metallicity")
                if with_metals:
                    names.update(metals="metals",
                                 total_mass_returned="total_mass_returned",
                                 last_enrichment_myr="last_enrichment_myr")
                self.stars = stars.replace(**{
                    f: put(getattr(stars, f), k) for f, k in names.items()})
            if with_metals:
                # the species column: the gas's metals, the stars' birth
                # composition
                pt = self.pdata.ptype[:, None]
                self.sph = self.sph.replace(metals=torch.where(
                    pt == 0, self.stars.metals, self.sph.metals))
                self.stars = self.stars.replace(metals=torch.where(
                    pt == 4, self.stars.metals, 0.0))
                self._star_hsml = put(torch.zeros(
                    cap, dtype=torch.float32, device=self.device),
                    "star_hsml")
            if with_bh:
                from .physics.blackhole import BhData
                bh = BhData.zeros(cap, self.device)
                names = dict(bh_mass="bh_mass", mdot="bh_mdot",
                             bh_density="bh_density", mtrack="bh_mtrack",
                             count_progs="bh_progs",
                             kinetic_energy="bh_ke", vdisp="bh_vdisp")
                if with_sfr:
                    names["formation_time"] = "formation_time"
                self.bh = bh.replace(**{
                    f: put(getattr(bh, f), k) for f, k in names.items()})

        def do_fof():
            """The distributed FOF of the rows as they stand (their owners
            per ``owned``), its PIG and, with BlackHoleOn, the seeding
            (fof_seed, run.c:626-630): the densest gas row of each halo
            above MinFoFMassForNewSeed and MinMStarForNewSeed that holds
            no BH becomes one."""
            nonlocal st
            npart = int(coll.psum((st["ptype"] == 1).sum(), mesh))
            mean_sep = self.cfg.boxsize / max(1.0, np.cbrt(npart))
            params = FOFParams(
                linking_length=self.cfg.fof_linking_length,
                min_group_length=self.cfg.fof_min_group_length,
                primary_link_types=self.cfg.fof_primary_link_types,
                secondary_link_types=self.cfg.fof_secondary_link_types)
            lay("FOF")
            fstats = {}
            cat, sorted_labels, labels = sharded_fof(
                mesh, st, owned, boxsize=self.cfg.boxsize,
                mean_sep=mean_sep, params=params, with_bh=with_bh,
                stats=fstats)
            lay("IO")
            write_pig_sharded(self, mesh, st, labels, sorted_labels, cat)
            lay(None)
            seeded = 0
            if with_bh and cat["ngroups"]:
                par = self._bh_params()
                pick = ((cat["masses"] > par.min_fof_mass_for_seed)
                        & (cat["mass_by_type"][:, 4]
                           > par.min_mstar_for_seed)
                        & ~cat["has_bh"] & (cat["seed_gid"] != SEED_NONE))
                if pick.any():
                    lay("BH")
                    st, seeded = seed_convert(
                        st, cat["seed_gid"][pick], mesh,
                        seed_mass=par.seed_mass,
                        seed_dyn_mass=par.seed_bh_dyn_mass,
                        atime=self.atime)
                    lay(None)
                self.bh_seeded.append(seeded)
                if verbose and seeded:
                    message(f"[sharded fof] seeded {seeded} black holes")
            self.sharded_fofs.append(dict(a=self.atime,
                                          ngroups=cat["ngroups"],
                                          rounds=fstats["rounds"],
                                          seeded=seeded))

        self.sharded_fofs = []

        def sync_outputs():
            sp = self.timeline.find_current_sync_point(self.ti_current)
            if sp is None or not sp.write_snapshot:
                return
            lay("IO")
            write_snapshot_sharded(self, mesh, st)
            lay(None)
            if sp.write_fof or self.cfg.snapshot_with_fof:
                do_fof()

        self.sharded_formed = 0

        def write_sfr_line(stats):
            """sfr.txt from the sums over ranks, in the reference's
            8-column layout (write_sfr, sfr_eff.c:381), on rank 0 and only
            when the step formed stellar mass (sfr_eff.c:356)."""
            if not with_sfr:
                return
            self.sharded_formed += stats["formed_here"]
            if mesh.rank != 0 or not stats["sm_sum"] > 0:
                return
            sm, dt = stats["sm_sum"], stats["sf_dtime_sum"]
            n_sf = int(round(stats["sf_count"]))
            rate = (sm * n_sf / dt * self._sfr.UnitSfr_in_solar_per_year
                    if dt > 0 else 0.0)
            mean_dt = dt / n_sf if n_sf > 0 else 0.0
            with open(os.path.join(self.cfg.output_dir, "sfr.txt"),
                      "a") as fh:
                fh.write(f"{self.atime:.12g} {sm:g} {stats['sfr_sum']:g} "
                         f"{rate:g} {stats['mass_formed_sum']:g} "
                         f"{mean_dt:g} {n_sf} "
                         f"{int(round(stats['n_spawned']))}\n")

        # ---- HCI: stop / checkpoint / terminate files and TimeLimitCPU,
        # queried at PM boundaries; rank 0 decides and the others follow
        hci = HCIManager(self.cfg.output_dir,
                         time_limit_cpu=self.cfg.time_limit_cpu,
                         auto_checkpoint_time=self.cfg.auto_snapshot_time)

        def hci_check():
            action = hci.query() if mesh.rank == 0 else 0
            action = int(coll.broadcast(torch.tensor(action), mesh))
            if action in (HCI_STOP, HCI_TIMEOUT):
                write_snapshot_sharded(self, mesh, st)
                if verbose:
                    message("[hci] stop requested: checkpoint written"
                            if action == HCI_STOP else
                            "[hci] TimeLimitCPU reached: checkpoint "
                            "written")
                return True
            if action == HCI_TERMINATE:
                return True
            if action in (HCI_CHECKPOINT, HCI_AUTO_CHECKPOINT):
                write_snapshot_sharded(self, mesh, st)
            return False

        loga = self.timeline.loga_from_ti
        par_ts = self.cfg.timestep
        soft_h = 2.8 * self.cfg.gravity_softening * self._dm_mean_sep()

        def bin_tables(ti, dti_s, maxbin, a1s, pop):
            """Per-bin kick factors and alignment masks of one substep
            (apply_half_kick's factors, timestep.c); the factors (each a
            quadrature on the host) only for the bins that hold rows
            (pop: rows per bin, summed over ranks).  With gas the hydro
            kicks, the entropy's dloga per half bin and each bin's full
            dloga (the source terms' interval)."""
            z = np.zeros(MAXB + 1, f32)
            gko, gkc = z.copy(), z.copy()
            hko, hkc, dlo, dlc, dlf = (z.copy(), z.copy(), z.copy(),
                                       z.copy(), z.copy())
            ti2 = ti + dti_s
            for b in range(1, maxbin + 1):
                if not pop[b]:
                    continue
                db = 1 << b
                if ti % db == 0:
                    gko[b] = self.tf.gravkick(ti, ti + db // 2)
                    if with_gas:
                        hko[b] = self.tf.hydrokick(ti, ti + db // 2)
                        dlo[b] = loga(ti + db // 2) - loga(ti)
                if ti2 % db == 0:
                    gkc[b] = self.tf.gravkick(ti2 - db // 2, ti2)
                    if with_gas:
                        hkc[b] = self.tf.hydrokick(ti2 - db // 2, ti2)
                        dlc[b] = loga(ti2) - loga(ti2 - db // 2)
                        dlf[b] = loga(ti2) - loga(max(ti2 - db, 0))
            scal = {
                "ddrift": self.tf.drift(ti, ti2), "atime": a1s,
                "hubble": float(self.CP.hubble_function(a1s)),
                "gk_open": gko, "gk_close": gkc,
                "al_open": np.array([ti % (1 << b) == 0
                                     for b in range(MAXB + 1)]),
                "al_close": np.array([ti2 % (1 << b) == 0
                                      for b in range(MAXB + 1)]),
                "eta_eps": 2 * par_ts.ErrTolIntAccuracy * a1s * soft_h,
                "max_dloga": par_ts.MaxSizeTimestep,
                "dloga_tick": float(self.timeline._interval_dloga(ti)),
                "maxbin": maxbin,
                "nu_tracer": self.CP.hybrid_nu_tracer(a1s)}
            if with_gas:
                scal.update(
                    hk_open=hko, hk_close=hkc, dlg_open=dlo, dlg_close=dlc,
                    dlg_full=dlf, dloga_full=loga(ti2) - loga(ti),
                    courant_fac=par_ts.CourantFac,
                    fac3=a1s ** (3 * (1 - GAMMA) / 2.0))
            return source_scalars(scal, ti, a1s)

        bh_par = self._bh_params() if with_bh else None
        metal_margin = None

        def subgrid_passes(t0, t1):
            """The interval's subgrid passes on the rows as the step left
            them (their owners per ``owned``), in the JAX package's order:
            the new stars' neighbour winds, the black holes, the metal
            return.  The draws' keys are the JAX package's: the winds'
            from the step's first tick folded with 77, the BHs' from
            ti_current (the step's end) + 5."""
            nonlocal st, metal_margin
            from .utils import threefry
            a0, a1 = float(np.exp(loga(t0))), float(np.exp(loga(t1)))
            dtime = (loga(t1) - loga(t0)) / float(self.CP.hubble_function(a1))
            if wind_neighbors:
                from .parallel.winds import sharded_winds
                lay("Winds")
                key = threefry.fold_in(threefry.prng_key(
                    (self.cfg.random_seed + t0) % (2 ** 31)), 77)
                upd, ws = sharded_winds(
                    st, {"atime": a1, "dtime": dtime,
                         "aform_min": a0 * (1.0 + 1e-7), "key": key}, mesh,
                    self._winds, boxsize=self.cfg.boxsize,
                    mean_sep=self._dm_mean_sep())
                st.update(upd)
                self.wind_kicks += ws["n_kicked"]
            if with_bh:
                from .parallel.blackhole import sharded_bh
                lay("BH")
                key = threefry.prng_key(
                    (self.cfg.random_seed + self.ti_current + 5) % (2 ** 31))
                st, bs = sharded_bh(
                    st, {"atime": a1, "dtime": dtime, "key": key,
                         "bh_soft": self.cfg.gravity_softening
                         * self._dm_mean_sep()}, mesh, bh_par,
                    boxsize=self.cfg.boxsize, gconst=self.CP.GravInternal,
                    unit_time_in_s=self.cfg.units.UnitTime_in_s,
                    hubble_param=self.CP.HubbleParam,
                    unit_velocity=self.cfg.units.UnitVelocity_in_cm_per_s,
                    uu_in_cgs=self.cfg.units.UnitInternalEnergy_in_cgs,
                    rho_crit_baryon=self._rho_crit_baryon(),
                    kernel_type=self.cfg.density_kernel_type,
                    reposition=self.cfg.bh_reposition,
                    # the mergers' boundness test takes the full force
                    acc=(st["grav_acc"] + st["pm_acc"]) if hierarchical
                    else None)
                self.bh_swallowed += bs["n_swallowed"]
                self.bh_mergers += bs["n_merged"]
            if with_metals:
                from .parallel.metals import MARGIN, sharded_metal_return
                lay("MetalReturn")
                upd, ms = sharded_metal_return(
                    st, mesh, owned, float(f32(a0)), float(f32(a1)),
                    *self._metal_return_tables(), self.cfg.boxsize,
                    self.CP.HubbleParam, margin=metal_margin or MARGIN)
                st.update(upd)
                if ms["reruns"] and verbose:
                    message(f"[sharded] metal-return strip too narrow: "
                            f"margin {ms['margin']:.4g}")
                metal_margin = ms["margin"]
            lay(None)

        def apply_lightcone(ta, tb):
            """The light cone after a global step or a substep
            (lightcone_compute, lightcone.c:176-221 at scale): each rank
            tests its own rows against each replica's shell and appends
            the crossers to its own stripe (task = rank)."""
            if not self.cfg.lightcone_on:
                return
            from .physics.lightcone import Lightcone
            if self._lightcone is None:
                self._lightcone = Lightcone(
                    self.CP, self.time_ic,
                    self.cfg.units.UnitVelocity_in_cm_per_s,
                    self.cfg.output_dir, self.cfg.boxsize, task=mesh.rank)
            lay("Lightcone")
            self._lightcone.compute_sharded(
                float(np.exp(loga(tb))), self.tf.drift(ta, tb), st["ipos"],
                st["vel"], st["ptype"], st["pid"], self._ipos_offset)
            lay(None)

        step_cat = {}

        def sharded_cat():
            """The distributed catalogue of the rows as the step left them
            (their owners per ``owned``), made once a PM step for QSO
            lightup and the excursion set: (cat, sorted_labels,
            labels)."""
            if "cat" not in step_cat:
                npart = int(coll.psum((st["ptype"] == 1).sum(), mesh))
                params = FOFParams(
                    linking_length=self.cfg.fof_linking_length,
                    min_group_length=self.cfg.fof_min_group_length,
                    primary_link_types=self.cfg.fof_primary_link_types,
                    secondary_link_types=self.cfg.fof_secondary_link_types)
                lay("FOF")
                step_cat["cat"] = sharded_fof(
                    mesh, st, owned, boxsize=self.cfg.boxsize,
                    mean_sep=self.cfg.boxsize / max(1.0, np.cbrt(npart)),
                    params=params)
                lay(None)
            return step_cat["cat"]

        def apply_qso(t0, t1):
            """Helium reionization on the rows (cooling_qso_lightup.c at
            scale): the long-mean-free-path heating elementwise on each
            rank's gas, then bubbles around the halos of the distributed
            catalogue, placed alike on every rank (counts summed over
            ranks); rank 0 appends to helium.txt."""
            from .physics import qso_lightup as qmod
            if self._heii_hist is None:     # (check_supported: a file)
                self._heii_hist = qmod.load_heii_reion_hist(
                    self.cfg.reion_hist_file)
                self._qso_params = qmod.QSOParams(
                    min_mass=self.cfg.qso_min_mass,
                    max_mass=self.cfg.qso_max_mass,
                    mean_bubble=self.cfg.qso_mean_bubble,
                    var_bubble=self.cfg.qso_var_bubble,
                    finish_frac=self.cfg.qso_finish_frac,
                    heiii_start=self._heii_hist.zstart)
            hist = self._heii_hist
            par = self._qso_params.with_units(
                self.cfg.units.UnitInternalEnergy_in_cgs)
            a1 = float(np.exp(loga(t1)))
            if 1.0 / a1 - 1.0 > par.heiii_start or a1 > hist.aend:
                return
            dloga = loga(t1) - loga(t0)
            rate = qmod.lmfp_heating(hist, par, a1)
            gas_rows = st["gas_mask"]
            ionized = st["he_iii_ionized"] > 0
            lay("HeIII")
            if rate > 0 and dloga > 0:
                dt_s = (dloga / self.CP.hubble_function(a1)
                        * self.cfg.units.UnitTime_in_s / self.CP.HubbleParam)
                st["entropy"] = qmod.lmfp_heat_entropy(
                    st["entropy"], st["density"], gas_rows & ~ionized, rate,
                    dt_s, a1, self.cfg.units, self.CP.HubbleParam)
            cat = sharded_cat()[0]
            lay("HeIII")
            ion, ent, nbub = qmod.place_bubbles(
                st["ipos"], gas_rows, ionized, st["density"], st["entropy"],
                cat, hist, par, a1, self.cfg.boxsize, self.cfg.random_seed,
                self.cfg.output_dir, write=mesh.rank == 0, mesh=mesh)
            st["he_iii_ionized"] = ion.to(torch.uint8)
            st["entropy"] = ent.to(torch.float32)
            lay(None)
            self.qso_bubbles.append((a1, nbub))

        def apply_excursion(t1):
            """The excursion-set UVBG update at the UVBGTimestep cadence
            (calculate_uvbg, uvbg.c:506-594 at scale): halo masses from
            the distributed catalogue, each rank's CIC deposits summed
            over ranks, the ladder on every rank, the J21 readout on each
            rank's rows."""
            from .parallel.fof import group_index
            from .physics import uvbg as uvmod
            cfg = self.cfg
            a1 = float(np.exp(loga(t1)))
            z = 1.0 / a1 - 1.0
            if not (cfg.excursion_set_zstop <= z <= cfg.excursion_set_zstart):
                return
            p = self._excursion_params()
            t_myr = float(self._age_table(a1))
            if t_myr - self._uvbg_last_myr < cfg.uvbg_timestep_myr:
                return
            self._uvbg_last_myr = t_myr
            cat, sorted_labels, labels = sharded_cat()
            lay("UVBG")
            gi = group_index(labels, sorted_labels)
            masses = torch.as_tensor(np.asarray(cat["masses"], np.float32),
                                     device=mesh.device)
            halo_mass = torch.where(gi >= 0, masses[torch.clamp(gi, min=0)],
                                    0.0) if masses.numel() else \
                torch.zeros_like(st["mass"])
            fesc = uvmod.escape_fractions(
                halo_mass, p.escape_frac_norm, p.escape_frac_scaling,
                cfg.units.UnitMass_in_g, self.CP.HubbleParam)
            gas_rows = st["gas_mask"]
            sfr = st["sfr"] if "sfr" in st else torch.zeros_like(st["mass"])
            out = uvmod.calculate_uvbg(
                st["ipos"], st["mass"], torch.ones_like(gas_rows), gas_rows,
                st["ptype"] == 4, sfr, fesc, p, self.CP, cfg.units,
                cfg.boxsize, a1, mesh=mesh)
            j21_p = uvmod.readout_j21_max(out["j21"], st["ipos"])
            newly = gas_rows & (j21_p > st["local_j21"]) \
                & (st["zreion"] < 0)
            st["local_j21"] = torch.where(
                gas_rows, torch.maximum(st["local_j21"], j21_p),
                st["local_j21"])
            st["zreion"] = torch.where(newly, float(np.float32(z)),
                                       st["zreion"])
            lay(None)
            vol = out["volume_weighted_global_xHI"]
            mxhi = out["mass_weighted_global_xHI"]
            self.uvbg_updates.append((z, vol, mxhi))
            if verbose and mesh.rank == 0:
                message(f"[UVBG] z={z:.2f} vol xHI={vol:.4f} mass "
                        f"xHI={mxhi:.4f}")

        def maybe_planes():
            """Lensing potential planes of the rows (write_plane,
            plane.c:572 at scale): each rank projects its own rows, the
            counts are summed over ranks, rank 0 solves and writes."""
            from .physics.plane import write_planes
            self._ensure_plane_params()
            atime = self.atime
            for i, t in enumerate(self._plane_times):
                if i in self._planes_done or t > atime + 1e-9:
                    continue
                lay("Planes")
                off = torch.as_tensor(self._ipos_offset.astype(np.int64),
                                      device=mesh.device)
                n_tot = int(coll.psum(torch.tensor(
                    st["ipos"].shape[0], device=mesh.device), mesh))
                write_planes(self, i, self._plane_params,
                             ipos=(st["ipos"] - off[None, :]) & 0xFFFFFFFF,
                             weights=torch.ones_like(st["mass"]),
                             n_tot=n_tot, write=mesh.rank == 0, mesh=mesh)
                lay(None)
                self._planes_done.add(i)

        def aux_passes(t0, t1):
            """After the subgrid passes, in the JAX package's order: QSO
            lightup, the excursion set, the planes."""
            step_cat.clear()
            if with_qso:
                apply_qso(t0, t1)
            if with_excursion:
                apply_excursion(t1)
            if self.cfg.plane_output_list:
                maybe_planes()
            step_cat.clear()

        def write_power(pk):
            """The PM step's total-matter P(k), summed over ranks: rank 0
            writes the powerspectrum file, as the single-device loop does
            after each step."""
            ps = _finalize_power(*pk, self.pm_cfg)
            if with_nu:
                self._total_matter_power(ps, self.atime)
            self.last_power = ps
            if mesh.rank == 0:
                ps.save(self.cfg.output_dir, self.atime,
                        self.CP.GrowthFactor(self.atime, 1.0))

        def log_step(t_start, n_sub, n_closing, c0):
            self.sharded_log.append(dict(
                a=self.atime, substeps=n_sub, n_closing=n_closing,
                seconds=_time.monotonic() - t_start,
                coll_seconds=coll.STATS["seconds"] - c0[0],
                coll_bytes=coll.STATS["bytes"] - c0[1]))

        nsteps = 0
        stats = None
        pm_stats = None
        while self.ti_current < self.timeline.ti_end:
            if hci_check():
                break
            step_t0 = _time.monotonic()
            c0 = (coll.STATS["seconds"], coll.STATS["bytes"])
            t0 = self.ti_current
            a0 = self.atime
            last = pm_stats if hierarchical else stats
            if last is None:
                dti = self.find_pm_timestep()
                if with_gas and not hierarchical:
                    dti_h = round_down_power_of_two(
                        self.timeline.dti_from_dloga(
                            self.find_hydro_timestep_dloga(), t0))
                    dti = min(dti, max(dti_h, 1))
            else:
                dti = get_pm_timestep_ti(
                    dloga_from_stats(last, a0, pm_only=hierarchical),
                    self.timeline, t0, t0)
            if dti <= 0:
                endrun(1, f"bad sharded timestep {dti}")
            dti = min(dti, self.timeline.ti_end - t0)
            t1 = t0 + dti
            mid = t0 + dti // 2
            if not hierarchical:
                a1 = float(np.exp(loga(t1)))
                scal = {"dk1": self.tf.gravkick(t0, mid),
                        "ddrift": self.tf.drift(t0, t1),
                        "dk2": self.tf.gravkick(mid, t1), "atime": a1,
                        "hubble": float(self.CP.hubble_function(a1)),
                        "nu_tracer": self.CP.hybrid_nu_tracer(a1)}
                if with_gas:
                    scal.update(hk1=self.tf.hydrokick(t0, mid),
                                dloga1=loga(mid) - loga(t0),
                                hk2=self.tf.hydrokick(mid, t1),
                                dloga2=loga(t1) - loga(mid),
                                dloga_full=loga(t1) - loga(t0))
                owned = bounds
                st, stats = step(st, source_scalars(scal, t0, a1))
                self.ti_current = t1
                apply_lightcone(t0, t1)
                self.force_evals += stats["n_valid"]
                n_sub, n_closing = 1, [stats["n_valid"]]
                hist = stats["hist"]
                pk = stats["pk"]
                write_sfr_line(stats)
            else:
                # opening PM half kick with the carried long-range field
                st["vel"] = st["vel"] + st["pm_acc"] * float(
                    f32(self.tf.gravkick(t0, mid)))
                maxbin = get_timestep_bin(dti)
                tz = (t0 & -t0).bit_length() - 1 if t0 > 0 else 62
                tzp = (dti & -dti).bit_length() - 1
                maxbin = max(1, min(maxbin, tz, tzp, MAXB))
                st["bins"] = assign_bins(
                    st, a0, 2 * par_ts.ErrTolIntAccuracy * a0 * soft_h,
                    float(self.CP.hubble_function(a0)),
                    par_ts.MaxSizeTimestep,
                    float(self.timeline._interval_dloga(t0)), maxbin,
                    courant=((par_ts.CourantFac,
                              a0 ** (3 * (1 - GAMMA) / 2.0))
                             if with_gas else None))
                nloc = st["bins"].shape[0]
                if par_ts.ForceEqualTimesteps:
                    mb0 = int(coll.pmin(st["bins"].min().long() if nloc
                                        else torch.tensor(maxbin), mesh))
                    st["bins"] = torch.full_like(st["bins"], mb0)
                minb = int(coll.pmin(st["bins"].min().long() if nloc
                                     else torch.tensor(MAXB), mesh))
                pop = coll.psum(torch.bincount(
                    st["bins"].long(), minlength=MAXB + 1), mesh).cpu()
                ti = t0
                n_sub, n_closing = 0, []
                while ti < t1:
                    dti_s = min(1 << minb, t1 - ti)
                    a1s = float(np.exp(loga(ti + dti_s)))
                    owned = bounds
                    st, sstats = step(st, bin_tables(ti, dti_s, maxbin,
                                                     a1s, pop))
                    ti += dti_s
                    self.ti_current = ti
                    apply_lightcone(ti - dti_s, ti)
                    n_sub += 1
                    n_closing.append(sstats["n_closing"])
                    self.force_evals += sstats["n_closing"]
                    write_sfr_line(sstats)
                    bounds = balanced_boundaries(
                        sstats["hist"].cpu().numpy(), S)
                    minb = sstats["min_act_bin"]
                    pop = sstats["bin_hist"]
                # PM refresh and closing half kick at t1
                a1 = float(np.exp(loga(t1)))
                upd, pm_stats = pm_refresh(
                    st, mesh, {"fac": self.tf.gravkick(mid, t1), "atime": a1,
                               "nu_tracer": self.CP.hybrid_nu_tracer(a1)},
                    **common)
                st.update(upd)
                hist = pm_stats["hist"]
                pk = pm_stats["pk"]
            nsteps += 1
            subgrid_passes(t0, t1)
            aux_passes(t0, t1)
            log_step(step_t0, n_sub, n_closing, c0)
            sync_outputs()
            write_power(pk)
            # the next step's boundaries: the passes and the outputs above
            # read the rows where this step's exchange put them (owned)
            bounds = balanced_boundaries(hist.cpu().numpy(), S)
            hci.update_longest_step(_time.monotonic() - step_t0)
            if verbose:
                message(f"[sharded{'-hier' if hierarchical else ''} step "
                        f"{nsteps}] a={self.atime:.5f} substeps={n_sub}")
            if max_steps and nsteps >= max_steps:
                break
        self.sharded_rows = torch.bincount(st["ptype"].long().cpu(),
                                           minlength=6).tolist()
        mirror_to_host()
        return nsteps

    def _sharded_uvbg(self, uv, st, redshift):
        """The UV background of a rank's rows: the step's global rates,
        gated row by row by the UV fluctuation table when there is one,
        and during the excursion set's epoch the rates of each row's J21
        (the JAX package's excursion_uv; redshift the step's, in
        float32)."""
        from .physics.cooling import UVBG, local_uvbg
        from .physics.uvbg import j21_to_rates
        if self._uvf is not None:
            uv = local_uvbg(uv, self._uvf.zreion(st["ipos"]), redshift)
        if "local_j21" in st and (self.cfg.excursion_set_zstop <= redshift
                                  <= self.cfg.excursion_set_zstart):
            g, e = j21_to_rates(st["local_j21"], self.cfg.alpha_uv)
            uv = UVBG(gJH0=g[0], gJHe0=g[1], gJHep=g[2], epsH0=e[0],
                      epsHe0=e[1], epsHep=e[2],
                      self_shield_dens=uv.self_shield_dens)
        return uv

    def _sharded_sfr_fn(self):
        """The sharded step's star formation (the JAX package's sfr_fn):
        cooling, the effective EOS and stochastic star formation of the
        listed rows, over per-row intervals, with the step's key (the
        draws are per ID, so the same stars form at any rank count)."""
        from .physics import sfr as sfrmod
        from .physics.cooling import do_cooling

        def sfr_fn(st, gas, dloga, scal):
            z = scal["redshift"]
            uv = self._sharded_uvbg(scal["uvbg"], st, z)

            def cool_fn(u, rho_phys, dt, ne, rows, metallicity):
                return do_cooling(self._cooling, z, u, rho_phys, dt, uv, ne,
                                  self._min_egy_spec, self._cooling_units,
                                  rows=rows, metallicity=metallicity)

            return sfrmod.cooling_and_starformation(
                self._sfr, self._cooling, self._cooling_units, scal["key"],
                density=st["density"], entropy=st["entropy"], ne=st["ne"],
                metallicity=st["metallicity"], delay_time=st["delay_time"],
                mass=st["mass"], pid=st["pid"], valid_gas=gas, redshift=z,
                atime=float(np.float32(scal["atime"])),
                hubble=float(np.float32(scal["hubble"])), dloga=dloga,
                uvbg=uv, do_cooling_fn=cool_fn)
        return sfr_fn

    def _sharded_wind_fn(self):
        """The sh03 subgrid winds of the sharded step (the JAX package's
        wind_fn): winds_subgrid on the star-forming gas with no dispersion
        (fixed efficiency), keyed fold_in(step key, 77), then the
        decoupling timers over each row's interval."""
        from .physics import winds as windmod
        from .utils import threefry

        def wind_fn(st, out, dloga, scal):
            atime = float(np.float32(scal["atime"]))
            vel, ent, delay, _ = windmod.winds_subgrid(
                self._winds, threefry.fold_in(scal["key"], 77), sm=out["sm"],
                mass=st["mass"], pid=st["pid"],
                vdisp=torch.zeros_like(st["mass"]), vel=st["vel"],
                entropy=st["entropy"], density=st["density"],
                delay_time=st["delay_time"], eligible=out["on_eeqos"],
                atime=atime)
            dt = torch.as_tensor(dloga, dtype=torch.float32,
                                 device=st["mass"].device) \
                / float(np.float32(scal["hubble"]))
            return vel, ent, windmod.winds_decouple_update(
                self._winds, delay, st["density"], dt, atime)
        return wind_fn

    def _sharded_cooling_fn(self):
        """The sharded step's cooling without star formation (the
        cooling_direct path; the JAX package's cooling_fn)."""
        from .physics.cooling import do_cooling
        from .utils.constants import GAMMA_MINUS1

        def cooling_fn(st, gas, dloga, scal):
            z = scal["redshift"]
            uv = self._sharded_uvbg(scal["uvbg"], st, z)
            a = np.float32(scal["atime"])
            rho_phys = torch.clamp(st["density"], min=1e-30) / float(
                a * a * a)
            u = st["entropy"] / GAMMA_MINUS1 * rho_phys ** GAMMA_MINUS1
            dt = torch.broadcast_to(torch.as_tensor(
                dloga, dtype=u.dtype, device=u.device)
                / float(np.float32(scal["hubble"])), u.shape).contiguous()
            u_new, ne = do_cooling(self._cooling, z, u, rho_phys, dt, uv,
                                   st["ne"], self._min_egy_spec,
                                   self._cooling_units, rows=gas,
                                   metallicity=st["metallicity"])
            return GAMMA_MINUS1 * u_new / rho_phys ** GAMMA_MINUS1, ne
        return cooling_fn

    def _run_excursion_set(self):
        """The excursion-set UVBG update at the UVBGTimestep cadence
        (calculate_uvbg, uvbg.c:506-594): FOF halo masses -> escape
        fractions -> the grids -> each gas row's J21 (the max it has seen)
        and, where it first rises, zreion = z."""
        from .physics import uvbg as uvmod
        atime = self.atime
        z = 1.0 / atime - 1.0
        cfg = self.cfg
        if not (cfg.excursion_set_zstop <= z <= cfg.excursion_set_zstart):
            return
        p = self._excursion_params()
        t_myr = float(self._age_table(atime))
        if t_myr - self._uvbg_last_myr < cfg.uvbg_timestep_myr:
            return
        self._uvbg_last_myr = t_myr
        self.walltime.start("UVBG")
        # per-row escape fractions from the FOF halo masses
        cat = self.run_fof(save=False)
        gi = np.asarray(cat["group_index"])
        halo_mass = np.zeros(self.pdata.capacity, np.float32)
        ok = gi >= 0
        halo_mass[ok] = np.asarray(cat["masses"])[gi[ok]]
        fesc = uvmod.escape_fractions(
            torch.as_tensor(halo_mass, device=self.device),
            p.escape_frac_norm, p.escape_frac_scaling,
            cfg.units.UnitMass_in_g, self.CP.HubbleParam)
        pd = self.pdata
        is_star = pd.valid & (pd.ptype == 4)
        out = uvmod.calculate_uvbg(
            pd.ipos, pd.mass, pd.valid, self.gas_mask, is_star,
            self.sph.sfr, fesc, p, self.CP, cfg.units, cfg.boxsize, atime)
        j21_p = uvmod.readout_j21_max(out["j21"], pd.ipos)
        sph = self.sph
        newly = self.gas_mask & (j21_p > sph.local_j21) & (sph.zreion < 0)
        self.sph = sph.replace(
            local_j21=torch.where(self.gas_mask,
                                  torch.maximum(sph.local_j21, j21_p),
                                  sph.local_j21),
            zreion=torch.where(newly, float(np.float32(z)), sph.zreion))
        self.walltime.stop("UVBG")
        vol = out["volume_weighted_global_xHI"]
        mass = out["mass_weighted_global_xHI"]
        self.uvbg_updates.append((z, vol, mass))
        print(f"[UVBG] z={z:.2f} vol xHI={vol:.4f} mass xHI={mass:.4f}")

    def _excursion_params(self):
        """The excursion set's UVBGParams and the age table of its
        cadence, made at its first update."""
        from .physics import uvbg as uvmod
        cfg = self.cfg
        if self._uvbg_params is None:
            self._uvbg_params = uvmod.UVBGParams(
                uvbg_dim=cfg.uvbg_dim, r_bubble_max=cfg.reion_r_bubble_max,
                r_bubble_min=cfg.reion_r_bubble_min,
                delta_r_factor=cfg.reion_delta_r_factor,
                filter_type=cfg.reion_filter_type,
                rtom_filter_type=cfg.rtom_filter_type,
                nion_phot_per_bary=cfg.reion_nion_phot_per_bary,
                alpha_uv=cfg.alpha_uv,
                escape_frac_norm=cfg.escape_fraction_norm,
                escape_frac_scaling=cfg.escape_fraction_scaling,
                zstart=cfg.excursion_set_zstart,
                zstop=cfg.excursion_set_zstop,
                timestep_myr=cfg.uvbg_timestep_myr,
                use_particle_sfr=cfg.reion_use_particle_sfr,
                sfr_timescale=cfg.reion_sfr_timescale)
        if self._age_table is None:
            from .physics.metal_return import AgeTable
            self._age_table = AgeTable(
                self.CP.hubble_function, cfg.units, self.CP.HubbleParam,
                device=self.device)
        return self._uvbg_params

    def _run_qso_lightup(self, dloga=0.0):
        """Helium reionization for one PM step of dloga: the long-mean-free-
        path heating, then QSO bubbles around the halos of a fresh FOF."""
        from .physics import qso_lightup as qmod
        if self._heii_hist is None:     # (check_supported: a file is set)
            self._heii_hist = qmod.load_heii_reion_hist(
                self.cfg.reion_hist_file)
            self._qso_params = qmod.QSOParams(
                min_mass=self.cfg.qso_min_mass,
                max_mass=self.cfg.qso_max_mass,
                mean_bubble=self.cfg.qso_mean_bubble,
                var_bubble=self.cfg.qso_var_bubble,
                finish_frac=self.cfg.qso_finish_frac,
                heiii_start=self._heii_hist.zstart)
        hist, par = self._heii_hist, self._qso_params
        atime = self.atime
        if 1.0 / atime - 1.0 > par.heiii_start or atime > hist.aend:
            return
        self.walltime.start("HeIII")
        if dloga > 0:
            qmod.apply_lmfp_heating(self, hist, par, dloga)
        cat = self.run_fof(save=False)
        nbub = qmod.do_heiii_reionization(self, cat, hist, par)
        self.walltime.stop("HeIII")
        self.qso_bubbles.append((atime, nbub))

    def _check_invariants(self):
        """State sanity checks of OutputEnergyDebug (the reference's DEBUG
        blocks, timestep.c and exchange.c): finite velocities and entropy,
        positive masses; an emergency snapshot, then an error, if not."""
        valid = self.pdata.valid
        checks = [
            ("non-finite velocity", torch.isfinite(torch.where(
                valid[:, None], self.pdata.vel, 0.0)).all()),
            ("non-positive mass",
             (torch.where(valid, self.pdata.mass, 1.0) > 0).all())]
        if self.sph is not None and self._gas_initialized:
            ent = torch.where(self.gas_mask, self.sph.entropy, 1.0)
            checks.append(("bad gas entropy",
                           (torch.isfinite(ent) & (ent > 0)).all()))
        ok = torch.stack([c for _, c in checks]).cpu().numpy()
        bad = [name for (name, _), good in zip(checks, ok) if not good]
        if bad:
            try:
                self.write_snapshot(label=999)
            except Exception:
                pass
            raise RuntimeError(
                f"state invariants violated at a={self.atime:g}: "
                + ", ".join(bad))

    def _run_lightcone(self, dti):
        """Append horizon-crossing particles (lightcone_compute,
        lightcone.c:176-190) once per PM step."""
        from .physics.lightcone import Lightcone
        if self._lightcone is None:
            self._lightcone = Lightcone(
                self.CP, self.time_ic,
                self.cfg.units.UnitVelocity_in_cm_per_s,
                self.cfg.output_dir, self.cfg.boxsize)
        ddrift = self.tf.drift(self.ti_current - dti, self.ti_current)
        self.walltime.start("Lightcone")
        # fixed_to_pos in float64, then float32, as the JAX package
        pos = (self._unshifted_ipos().to(torch.float64)
               * (self.cfg.boxsize / 2.0 ** 32)).to(torch.float32)
        is_dm = self.pdata.valid & (self.pdata.ptype == 1)
        self._lightcone.compute(self.atime, ddrift, pos, self.pdata.vel,
                                is_dm, self.pdata.pid)
        self.walltime.stop("Lightcone")

    def _ensure_plane_params(self):
        from .physics.plane import PlaneParams
        if self._plane_times is None:
            def values(text, conv):
                return [conv(x) for x in text.replace(",", " ").split()]
            self._plane_times = sorted(values(self.cfg.plane_output_list,
                                              float))
            self._planes_done = set()
            self._plane_params = PlaneParams(
                output_times=self._plane_times,
                resolution=self.cfg.plane_resolution,
                thickness=self.cfg.plane_thickness,
                cut_points=values(self.cfg.plane_cut_points, float),
                normals=values(self.cfg.plane_normals, int),
                massive_nu_correction=self.cfg.plane_nu_correction,
                double_out=self.cfg.plane_double_out)

    def _maybe_write_planes(self):
        """Write lensing potential planes for any plane output times
        crossed this step (write_plane, plane.c:572)."""
        from .physics.plane import write_planes
        self._ensure_plane_params()
        atime = self.atime
        for i, t in enumerate(self._plane_times):
            if i in self._planes_done or t > atime + 1e-9:
                continue
            self.walltime.start("Planes")
            write_planes(self, i, self._plane_params)
            self.walltime.stop("Planes")
            self._planes_done.add(i)

    # -- statistics ----------------------------------------------------

    def energy_statistics(self):
        """energy.txt: kinetic/internal/potential energies per component
        (energy_statistics, stats.c:389-412), the JAX package's columns
        and %g format.  The potential is the PM one plus the tree's, from
        one more tree evaluation."""
        from .utils import constants as C
        from .utils.constants import GAMMA_MINUS1
        atime = self.atime
        valid = self.pdata.valid.cpu().numpy()
        ptype = self.pdata.ptype.cpu().numpy()
        mass = self.pdata.mass.cpu().numpy().astype(np.float64)
        vel = self.pdata.vel.cpu().numpy().astype(np.float64)
        pot = self.pdata.potential.cpu().numpy().astype(np.float64)
        if self.cfg.tree_grav_on and self._tree_grav is not None:
            # full potential = PM + short-range tree (stats.c:389)
            _, tree_pot = self._tree_compute_retry(return_potential=True)
            pot = pot + tree_pot.cpu().numpy().astype(np.float64)
        ekin_p = 0.5 * mass * (vel ** 2).sum(axis=1) / atime ** 2
        epot_p = 0.5 * mass * pot
        eint_p = np.zeros_like(mass)
        if self.sph is not None:
            rho = self.sph.density.cpu().numpy().astype(np.float64)
            u = self.sph.entropy.cpu().numpy().astype(np.float64) \
                / GAMMA_MINUS1 * np.maximum(rho * atime ** -3,
                                            1e-30) ** GAMMA_MINUS1
            eint_p = mass * u
        temp = 0.0
        ei = ek = ep = 0.0
        comp = []
        for t in range(6):
            sel = valid & (ptype == t)
            eic = float(eint_p[sel].sum()) if t == 0 else 0.0
            epc = float(epot_p[sel].sum())
            ekc = float(ekin_p[sel].sum())
            comp.append((eic, epc, ekc, float(mass[sel].sum())))
            ei += eic
            ep += epc
            ek += ekc
        # mass-weighted mean gas temperature, from u and the electron
        # abundance through the cooling mean-weight formula
        gas_sel = valid & (ptype == 0)
        if self.sph is not None and gas_sel.any():
            ne = self.sph.ne.cpu().numpy().astype(np.float64)
            xh = C.HYDROGEN_MASSFRAC
            nh_frac = 4.0 / (1.0 + 3.0 * xh + 4.0 * xh * ne)
            uu = self.cfg.units.UnitInternalEnergy_in_cgs
            temp_p = (GAMMA_MINUS1 * C.PROTONMASS / C.BOLTZMANN
                      * nh_frac * u * uu)
            mg = mass[gas_sel].sum()
            temp = float((mass[gas_sel] * temp_p[gas_sel]).sum()
                         / max(mg, 1e-300))
        row = [atime, temp, ei, ep, ek]
        for t in range(6):
            row += list(comp[t][:3])
        row += [comp[t][3] for t in range(6)]
        os.makedirs(self.cfg.output_dir, exist_ok=True)
        with open(os.path.join(self.cfg.output_dir, "energy.txt"),
                  "a") as fh:
            fh.write(" ".join(f"{x:g}" for x in row) + "\n")
        return dict(EnergyInt=ei, EnergyPot=ep, EnergyKin=ek)

    def run_gravity_test(self):
        """Force-accuracy self-test (RestartFlag 99; runtests.c:50-97): the
        TreePM short-range force against direct pairwise summation, in
        blocks of `batch` targets with batch * N near 2^27, so that a
        block's (batch, N, 3) int64 differences take 3 GiB."""
        from .gravity.shortrange import direct_shortrange_pairwise
        self.compute_forces(measure_power=False)
        tg = self._tree_grav
        acc_tree = self.pdata.grav_accel.cpu().numpy()
        rs_inv = 1.0 / (2 * self.cfg.asmth * self.cfg.boxsize
                        / self.cfg.nmesh)
        rcut = self.cfg.rcut * self.cfg.asmth * self.cfg.boxsize \
            / self.cfg.nmesh
        n = self.pdata.capacity
        batch = int(min(1024, max(1, (1 << 27) // max(n, 1))))
        t0 = _time.perf_counter()
        acc_pair, _ = direct_shortrange_pairwise(
            self.pdata.ipos, self.pdata.mass, self.pdata.valid,
            self.cfg.boxsize, float(np.float32(rs_inv)),
            float(np.float32(rcut)), float(np.float32(1.0 / tg.softening)),
            with_potential=False, batch=batch)
        acc_pair = acc_pair.cpu().numpy() * self.CP.GravInternal
        seconds = _time.perf_counter() - t0
        valid = self.pdata.valid.cpu().numpy()
        err = np.linalg.norm(acc_tree - acc_pair, axis=1)[valid]
        ref = np.sqrt(np.mean(np.linalg.norm(acc_pair, axis=1)[valid]
                              ** 2))
        rel = err / (ref + 1e-30)
        stats = {"mean_rel_err": float(rel.mean()),
                 "max_rel_err": float(rel.max()),
                 "p99_rel_err": float(np.percentile(rel, 99))}
        print(f"Force accuracy: mean={stats['mean_rel_err']:.2e} "
              f"p99={stats['p99_rel_err']:.2e} "
              f"max={stats['max_rel_err']:.2e}")
        print(f"Direct summation: {n} particles in batches of {batch}, "
              f"{seconds:.6f} s")
        return stats

    # -- FOF -----------------------------------------------------------

    def run_fof(self, save=True, label=None, timer=None):
        """FOF halo finding + PIG catalogue output (runfof, run.c:813-852
        and fof_save_groups).  timer: optional treepm.StageTimer, started
        by the caller (see physics.fof.fof_label); adds the lap "PIG"."""
        from .physics.fof import fof_catalog, FOFParams
        npart = float(((self.pdata.valid) & (self.pdata.ptype == 1)).sum())
        mean_sep = self.cfg.boxsize / max(1.0, np.cbrt(npart))
        cfg = FOFParams(
            linking_length=self.cfg.fof_linking_length,
            min_group_length=self.cfg.fof_min_group_length,
            primary_link_types=self.cfg.fof_primary_link_types,
            secondary_link_types=self.cfg.fof_secondary_link_types)
        self.walltime.start("FOF")
        cat = fof_catalog(self.pdata.ipos, self.pdata.vel, self.pdata.mass,
                          self.pdata.ptype, self.pdata.valid,
                          self.cfg.boxsize, mean_sep, cfg, timer=timer)
        self.walltime.stop("FOF")
        if save:
            self.write_fof_catalog(cat, label)
            if timer is not None:
                timer.lap("PIG")
        return cat

    def write_fof_catalog(self, cat, label=None):
        """PIG bigfile in the reference's FOFGroups schema
        (fofpetaio.c:540-570) plus the grouped particles' blocks."""
        if label is None:
            label = max(self.snapshot_count - 1, 0)
        path = os.path.join(self.cfg.output_dir,
                            f"{self.cfg.fof_file_base}_{label:03d}")
        bf = BigFile(path, create=True)
        ng = cat["ngroups"]
        atime = self.atime
        # GrNr counts from 1 (fof.c:1127-1133)
        bf.create_from_array("FOFGroups/GroupID",
                             np.arange(1, ng + 1, dtype="<u4"))
        bf.create_from_array("FOFGroups/Mass", cat["masses"].astype("<f4"))
        off = self._ipos_offset.astype(np.float64) / 2.0 ** 32 \
            * self.cfg.boxsize
        bf.create_from_array(
            "FOFGroups/MassCenterPosition",
            np.mod(cat["cm"] - off, self.cfg.boxsize).astype("<f8"))
        bf.create_from_array("FOFGroups/MassCenterVelocity",
                             (cat["vel"] / atime).astype("<f4"))
        bf.create_from_array("FOFGroups/LengthByType",
                             cat["len_by_type"].astype("<u4"))
        bf.create_from_array("FOFGroups/MassByType",
                             cat["mass_by_type"].astype("<f4"))
        bf.create_from_array("FOFGroups/StarFormationRate",
                             cat["sfr"].astype("<f4"))
        ntot = np.zeros(6, np.uint64)
        if self.cfg.fof_save_particles and ng > 0:
            # particles grouped by halo (fofpetaio.c fof_save_particles:
            # select GrNr > 0, sort by GrNr, write the usual blocks +
            # per-particle GroupID)
            gi = np.asarray(cat["group_index"])
            valid = self.pdata.valid.cpu().numpy()
            insel = valid & (gi >= 0)
            order = np.nonzero(insel)[0][np.argsort(gi[insel],
                                                    kind="stable")]
            ptype = self.pdata.ptype.cpu().numpy()[order]
            pos = self._output_pos()[order]
            vel = self.pdata.vel.cpu().numpy()[order]
            mass = self.pdata.mass.cpu().numpy()[order]
            pid = self.pdata.pid.cpu().numpy()[order]
            gid = (gi[order] + 1).astype("<u4")
            for t in range(6):
                tsel = ptype == t
                ntot[t] = tsel.sum()
                if ntot[t] == 0:
                    continue
                full = np.zeros(len(valid), bool)
                full[order[tsel]] = True
                extra = self._species_extra_blocks(t, full, atime)
                # _species_extra_blocks selects in array order; remap to
                # group order within the type (the rank of each row among
                # the selected rows)
                rord = np.searchsorted(np.nonzero(full)[0], order[tsel])
                extra = {k: v[rord] for k, v in extra.items()}
                extra["GroupID"] = gid[tsel]
                snap_io.write_species(
                    bf, t, pos=pos[tsel], vel=vel[tsel], pid=pid[tsel],
                    mass=mass[tsel], atime=atime, use_peculiar=True,
                    extra=extra)
        hdr = bf.create("Header")
        hdr.attrs["NumFOFGroupsTotal"] = np.asarray([ng], "<u8")
        hdr.attrs["NumPartInGroupTotal"] = ntot.astype("<u8")
        hdr.attrs["Time"] = float(atime)
        hdr.attrs["BoxSize"] = float(self.cfg.boxsize)
        hdr.attrs["Omega0"] = float(self.CP.Omega0)
        hdr.attrs["OmegaLambda"] = float(self.CP.OmegaLambda)
        hdr.attrs["HubbleParam"] = float(self.CP.HubbleParam)
        return path

    # -- output --------------------------------------------------------

    def _species_extra_blocks(self, t, sel, atime):
        """Type-specific blocks for a boolean selection sel, driven by the
        declarative registry (petaio.c:992-1078 analog), plus the derived
        InternalEnergy block of the gas.  The holders are the base
        particles, with gas the SPH state, with stars StarData, with black
        holes BhData."""
        from .io.registry import blocks_for_type
        from .utils.constants import GAMMA_MINUS1
        extra = {}
        holders = {"pdata": self.pdata, "sph": self.sph,
                   "stars": self.stars, "bh": self.bh}
        for spec in blocks_for_type(t):
            holder = holders.get(spec.holder)
            if holder is None:
                continue
            arr = getattr(holder, spec.field).cpu().numpy()
            extra[spec.name] = arr[sel].astype(spec.dtype)
        if t == 0 and self.sph is not None:
            ent = self.sph.entropy.cpu().numpy()[sel]
            rho = self.sph.density.cpu().numpy()[sel]
            u = ent / GAMMA_MINUS1 * np.maximum(
                rho * (1.0 / atime ** 3), 1e-30) ** GAMMA_MINUS1
            extra["InternalEnergy"] = u.astype("<f4")
        return extra

    def write_snapshot(self, label: Optional[int] = None):
        """write_checkpoint analog: snapshot == checkpoint."""
        if label is None:
            label = self.snapshot_count
            self.snapshot_count += 1
        path = os.path.join(self.cfg.output_dir,
                            f"{self.cfg.snapshot_base}_{label:03d}")
        bf = BigFile(path, create=True)
        atime = self.atime
        valid = self.pdata.valid.cpu().numpy()
        ptype = self.pdata.ptype.cpu().numpy()
        pos = self._output_pos()
        vel = self.pdata.vel.cpu().numpy()
        mass = self.pdata.mass.cpu().numpy()
        pid = self.pdata.pid.cpu().numpy()
        pot = self.pdata.potential.cpu().numpy()
        if self.cfg.tree_grav_on and self._tree_grav is not None:
            # stored Potential = PM + short-range tree (the reference
            # adds the tree part on output, gravshort-tree.c:137),
            # through the same retry as the forces: an overflowed walk
            # would write a truncated potential (the JAX package calls
            # the walk once and ignores its flag)
            _, tree_pot = self._tree_compute_retry(return_potential=True)
            pot = pot + tree_pot.cpu().numpy()
        ntot = np.zeros(6, np.uint64)
        hubble = self.CP.hubble_function(atime)
        for t in range(6):
            sel = valid & (ptype == t)
            ntot[t] = sel.sum()
            if ntot[t] == 0:
                continue
            extra = self._species_extra_blocks(t, sel, atime)
            extra["Potential"] = pot[sel].astype("<f4")
            # stripe count from the largest block (f8[3] positions),
            # petaio.c EnableAggregatedIO/BytesPerFile sizing
            nfile = max(1, int(np.ceil(
                int(ntot[t]) * 24 / self.cfg.bytes_per_file)))
            snap_io.write_species(
                bf, t, pos=pos[sel], vel=vel[sel], pid=pid[sel],
                mass=mass[sel], atime=atime, use_peculiar=True,
                extra=extra, Nfile=nfile)
        header = snap_io.SnapshotHeader(
            TotNumPart=ntot, MassTable=np.zeros(6), Time=atime,
            TimeIC=self.time_ic, BoxSize=self.cfg.boxsize,
            Omega0=self.CP.Omega0, OmegaLambda=self.CP.OmegaLambda,
            HubbleParam=self.CP.HubbleParam,
            OmegaBaryon=self.CP.OmegaBaryon,
            CMBTemperature=self.CP.CMBTemperature,
            UnitLength_in_cm=self.cfg.units.UnitLength_in_cm,
            UnitMass_in_g=self.cfg.units.UnitMass_in_g,
            UnitVelocity_in_cm_per_s=self.cfg.units.UnitVelocity_in_cm_per_s,
            RSDFactor=1.0 / (atime * hubble),
        )
        snap_io.write_header(bf, header)
        if self._nu_table_state is not None:
            snap_io.write_neutrino_state(bf, self._nu_table_state.state_dict())
        with open(os.path.join(self.cfg.output_dir, "Snapshots.txt"),
                  "a") as fh:
            fh.write(f"{label:03d} {atime}\n")
        return path
