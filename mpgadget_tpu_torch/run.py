"""Simulation driver: begrun/run analog (libgadget/run.c), PyTorch port of
the dark-matter-only part of mpgadget_tpu/run.py.

One device, a power-of-two quantized PM timestep, KDK integration with
exact FLRW factors, TreePM forces, in-line power spectra, snapshot output
at sync points and, with SnapshotWithFOF, a friends-of-friends halo
catalogue (PIG) beside each snapshot (:meth:`Simulation.run_fof`).  The
PM step is either one global KDK step or, with SplitGravityTimestepsOn,
sub-cycled over per-particle power-of-two timebins whose short-range
force is computed for the active set only
(:meth:`Simulation.step_hierarchical`).  Switches this port does not
carry yet raise NotImplementedError naming the parameter (see
:func:`check_supported`); none is silently ignored.
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
from .particles import ParticleData, fixed_to_pos
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
    """Raise NotImplementedError for a switch this port does not carry.

    Gas-only switches matter only when gas is present, as in the JAX
    package (with HydroOn = 0 gas particles are collisionless)."""
    always = (
        ("MassiveNuLinRespOn", cfg.massive_nu_lin_resp_on),
        ("HybridNeutrinosOn", cfg.hybrid_neutrinos_on),
        ("BlackHoleOn", cfg.black_hole_on),
        ("StarformationOn", cfg.starformation_on),
        ("LightconeOn", cfg.lightcone_on),
        ("PlaneOutputList", bool(cfg.plane_output_list)),
        ("OutputEnergyDebug", cfg.output_energy_debug),
    )
    with_gas = (
        ("HydroOn", cfg.hydro_on),
        ("CoolingOn", cfg.cooling_on),
        ("WindOn", cfg.wind_on),
        ("MetalReturnOn", cfg.metal_return_on),
        ("ExcursionSetReionOn", cfg.excursion_set_on),
        ("QSOLightupOn", cfg.qso_lightup_on),
    )
    for name, on in always + (with_gas if has_gas else ()):
        if on:
            raise NotImplementedError(
                f"{name} is not supported by mpgadget_tpu_torch yet "
                "(dark-matter-only TreePM)")


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

    # -- setup ---------------------------------------------------------

    @classmethod
    def from_snapshot(cls, path, cfg_kwargs, device="cuda"):
        """Read an IC/snapshot bigfile (petaio_read_snapshot analog)."""
        bf = BigFile(path)
        header = snap_io.read_header(bf)
        for t, name in ((4, "stars"), (5, "black holes")):
            if int(header.TotNumPart[t]) > 0:
                raise NotImplementedError(
                    f"snapshots with {name} (type {t}) are not supported "
                    "by mpgadget_tpu_torch yet")
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
        # nothing spawns on this path, so no PartAllocFactor padding;
        # rounded up to a multiple of 128 as in the JAX package
        capacity = int(np.ceil(n_read / 128)) * 128
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
        return sim

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
        self.walltime.start("PMgrav")
        accel, pot, ps = pm_force(self.pdata.ipos, weights, self.pm_cfg)
        self.walltime.stop("PMgrav")
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

    def _tree_compute(self, **kw):
        self._tree_grav.timer = self.tree_timer
        self.tree_force_calls += 1
        return self._tree_grav.compute(self.pdata, **kw)

    def _compute_tree_forces(self, active=None):
        """Short-range forces for every particle, or (active: bool[N])
        for the blocks holding an active target; inactive rows keep their
        old grav_accel."""
        if self._tree_grav is None:
            self._tree_grav = self._make_tree_gravity()
        # restartable walk: double capacities on overflow (the export-
        # buffer-full retry analog, treewalk.c:801-902)
        for attempt in range(8):
            # a failed (overflowed) attempt must not consume the "BH
            # opening on the first call" state (TreeUseBH=2)
            bh_prev = self._tree_grav._use_bh_now
            accel = self._tree_compute(target_active=active)
            if not bool(self._tree_grav.last_overflow):
                break
            self.tree_retries.append(tuple(
                k for k, v in self._tree_grav.last_overflow_parts.items()
                if bool(v)))
            self._tree_grav._use_bh_now = bh_prev
            self._tree_grav.grow()
        else:
            raise RuntimeError(
                "tree walk capacity overflow after retries: increase "
                "WalkConfig.leaf_list_max/src_cap or "
                "TreeConfig.node_factor")
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
        """Gravity kick over [t0, t1] (apply_half_kick, timestep.c)."""
        accel = self.pdata.grav_pm + self.pdata.grav_accel
        vel = kick(self.pdata.vel, accel, self.tf.gravkick(t0, t1))
        self.pdata = self.pdata.replace(vel=vel)

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
        gfac = np.zeros(maxbin + 1, np.float32)
        for b in torch.unique(bins[mask]).tolist():
            if b < 1:
                continue
            db = 1 << b
            ta, tb = (ti, ti + db // 2) if opening else (ti - db // 2, ti)
            gfac[b] = self.tf.gravkick(ta, tb)
        gk = torch.as_tensor(gfac, device=self.device)[bins]
        vel = self.pdata.vel + torch.where(
            mask[:, None], self.pdata.grav_accel * gk[:, None], 0.0)
        self.pdata = self.pdata.replace(vel=vel)

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
        # Forces at t1
        self.compute_forces()
        self.force_evals += self.pdata.num_valid
        # K: half kick with forces at t1
        self._apply_half_kick(th, t1)

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
            self.pdata, None, None, self.CP, self.atime, soft, self.timeline,
            t0, self.cfg.timestep, dti_pm)
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
            self._compute_tree_forces(active=closing)
            self._bin_half_kick(closing, bins, ti, maxbin, opening=False)
            self.force_evals += n_closing
            log["actives"].append(n_closing)
            # re-derive the bins of the closing particles from the fresh
            # forces (timestep.c:298-503): a bin may shrink at its own
            # boundary, and grow only when the longer interval is aligned
            # with the clock (is_timebin_active rule)
            if ti < t_end and not self.cfg.timestep.ForceEqualTimesteps:
                new_bins = assign_particle_bins(
                    self.pdata, None, None, self.CP, self.atime, soft,
                    self.timeline, ti, self.cfg.timestep, dti_pm)
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
            sp = self.timeline.find_current_sync_point(self.ti_current)
            if sp is not None and sp.write_snapshot:
                self.write_snapshot()
                # BH seeding from the catalogue waits for BlackHoleOn,
                # which check_supported refuses
                if sp.write_fof or (self.cfg.snapshot_with_fof
                                    and sp.write_snapshot):
                    self.run_fof()
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
        declarative registry (petaio.c:992-1078 analog).  Only the base
        particle holder exists on this path."""
        from .io.registry import blocks_for_type
        extra = {}
        holders = {"pdata": self.pdata}
        for spec in blocks_for_type(t):
            holder = holders.get(spec.holder)
            if holder is None:
                continue
            arr = getattr(holder, spec.field).cpu().numpy()
            extra[spec.name] = arr[sel].astype(spec.dtype)
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
            # adds the tree part on output, gravshort-tree.c:137)
            _, tree_pot = self._tree_compute(return_potential=True)
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
        with open(os.path.join(self.cfg.output_dir, "Snapshots.txt"),
                  "a") as fh:
            fh.write(f"{label:03d} {atime}\n")
        return path
