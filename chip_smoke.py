#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (mpgadget_tpu_torch) on one card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card; it
takes no arguments and imports nothing of JAX.  Phases, each of which
fails the run (non-zero exit, no result line) if it fails:

1. the card: CUDA must be available; prints the card's name and power
   limit as nvidia-smi reports them;
2. build: compiles the six kernels, the pair kernel K1
   (csrc/pairkernel.cu), the walk kernel K2 (csrc/treewalk.cu), the
   neighbour walk K3 (csrc/neighbors.cu), the SPH pair sums K4
   (csrc/sph_density.cu) and K5 (csrc/sph_hydro.cu) and the cooling
   network K6 (csrc/cooling.cu), and the six
   measurement aids (the serial walks K2 and K3 began as, the first
   designs of K4, K5 and K6, and an L2 pointer chase), one nvcc each, in
   parallel;
3. K1: the pair kernel against its plain PyTorch version on the card at
   the main path's shapes (nb=1024 blocks, G=256 targets, S=4096
   sources), with and without potential, on inputs from a seed, once
   over every slot and once with per-block source counts (one block
   filled to S, one empty, random counts between); tolerance 1e-4 of
   max |result|;
4. L2: one L2 round trip, timed by a pointer chase (csrc/l2chase.cu,
   built with the kernels and loaded only here: the latency of each
   load in the walk's chain of dependent loads);
5. K2: the walk kernel against its plain version on the card, on the
   dm-small lattice IC's first tree (BH opening, 512 leaves per block),
   at a retry-grown leaf list (relative opening, 4096 leaves, with
   potential), on 64^3 particles in eight clusters (BH, 512 leaves,
   with potential), where monopoles do most of the work (the lattice
   applies none), and on the lattice moved by the box shift of the
   slice's second step (relative opening), where blocks that straddle a
   jump of the Z curve open thousands of leaves, at 512 leaves (they
   overflow) and at the 8192 the retries reach: the same leaf lists,
   leaf counts, overflow flags and visit counts, acc and pot within 1e-5
   by norm.  In every case a second launch must give the same bits, and
   the serial walk the port began with (csrc/treewalk_serial.cu, loaded
   only here) is timed beside the kernel and must give the same bits
   too;
6. accuracy: the tree force on the card (walk + pair kernels) against
   direct pairwise summation, 4096 particles, as the repo's tree tests do;
7. slice: the examples/dm-small configuration at full width (64^3 DM
   particles, Nmesh 128, BoxSize 64000 kpc/h, z=9) with
   SplitGravityTimestepsOn=0 and SnapshotWithFOF=0, on a seeded lattice
   IC: build_simulation -> Simulation.run(max_steps=3) ->
   write_snapshot, with both kernels' launch counts read around it; then
   phase 3 again at the slice's final S if overflow retries grew it;
8. compaction: the tree force on 64^3 clustered particles with a seeded
   20% of the targets active (half the targets of a seeded 40% of the
   blocks), walked over exactly the active blocks, against the same force
   with every block walked: the same bits on active rows; and both
   kernels against their plain versions at those compacted shapes, to
   the tolerances of phases 3 and 5;
9. genic: examples/dm-small/paramfile.genic through the port's CLI,
   python -m mpgadget_tpu_torch.genic.main (Ngrid 64, Nmesh 128, Seed
   181170, z=9, UnitaryAmplitude) with the
   Eisenstein-Hu spectrum in place of the absent class_pk_9.dat
   (WhichSpectrum 1, Sigma8 0.8, InputPowerRedshift 0): header, IDs and
   masses, and the IC's P(k) at Nmesh 128 keeps the linear spectrum's
   shape over its 6 lowest-k bins to rtol 0.1 (examples/dm-small/
   check_results.py:62-75);
10. hierarchical dm-small: build_simulation on examples/dm-small/
   paramfile.gadget as it ships (SplitGravityTimestepsOn 1,
   SnapshotWithFOF 1), from that IC -> Simulation.run() to a = 0.25
   (HIER_STEPS), which writes a snapshot and a FOF catalogue (PIG) at
   each output, -> write_snapshot, the launch counts reset just before
   and read just after; per PM step its seconds, substeps, bin histogram
   and active targets per evaluation; finite state, no particle lost, the
   snapshot read back, the growth of P(k) between the first and last
   outputs equal to D1^2 to rtol 0.18 (check_results.py:76-81); each PIG
   read back and consistent (group rows, lengths >= FOFHaloMinLength,
   grouped particles per type with sorted GroupIDs), its halos per
   log10 mass bin, halos in the last one, and check_hmf's 9e12 Msun
   printed as met or not (not enforced: EH spectrum, the port's own
   realisation);
11. FOF of the final state: Simulation.run_fof from a cold leaf-list
   cache, K3's launch count reset just before and read just after, with
   the seconds of each stage and min-label round; the labels held to
   scipy's connected components (cKDTree with boxsize, positions in f64
   from the fixed point): every component at ll(1-1e-5) inside one port
   group, every port group inside one component at ll(1+1e-5);
12. K3: the neighbour walk against its plain version on the card, on the
   final state's FOF inputs (asymmetric, at the LL the FOF reached) and
   on 64^3 clustered particles (symmetric, a seeded hmax, LL 16, which
   some groups overflow): the same leaf lists, counts, flags and visits,
   two launches and the serial walk K3 began as (csrc/neighbors_serial.cu,
   loaded only here) bit-identical, device times of both by CUDA graph
   replays, each with its critical path; then the clustered set with a
   stack of one entry, so that K3's serial mode walks every group, held
   to the plain version too;
13. RestartFlag 3: python -m mpgadget_tpu_torch.main paramfile.gadget 3
   <the last snapshot>, whose PIG must read back and pass the checks of
   phase 10;
14. star-small without its subgrid physics: examples/star-small/
   paramfile.genic through the genic CLI with the Eisenstein-Hu cut of
   phase 9 (Ngrid 32: 32^3 gas + 32^3 DM, BoxSize 5000 kpc/h, z=9), then
   its paramfile.gadget as it ships (hierarchical, SnapshotWithFOF,
   DensityIndependentSphOn, Nmesh 64) but for CoolingOn, StarformationOn,
   BlackHoleOn, WindOn and MetalReturnOn, all 0 (GAS_SWITCHES_OFF), and
   TimeMax 0.15 (GAS_TIME_MAX, the depth cut that pays for phase 27; it
   ships with 0.2) -> Simulation.run() -> write_snapshot, the five kernels'
   launch counts reset just before and read just after: every density
   solve's targets within DesNumNgb +- MaxNumNgbDeviation (or the count
   that hit max_iter, and a failure), every hydro call's momentum
   (|sum m a| / sum m |a| < 1e-4), the IC's volume-weighted SPH density
   against Omega_b rho_crit (IC_RHO_TOL), the entropy floor, the growth
   of P(k) against D1^2 at k <= GAS_PK_KMAX (rtol 0.18), each
   snapshot's Density,
   SmoothingLength, InternalEnergy and EgyWtDensity and each PIG read
   back, and RestartFlag 3 through the CLI's body (main.run_cli, in this
   process) on the last gas snapshot;
15. K4 and K5 against their plain versions on the card, on the inputs
   of the run's own calls (K4: the first pass of the last density solve
   that targets every gas particle; K5: the last hydro call), and on a
   bigger IC, examples/dm-small/paramfile.genic with ProduceGas 1 (2 x
   64^3): every output within 1e-5 by norm (maxsig bit for bit, -inf at
   the same rows), two launches bit-identical, device times of both,
   the pairs each evaluates and counts, and the bound; beside them the
   first designs of K4 and K5 (csrc/sph_density_simple.cu,
   csrc/sph_hydro_simple.cu, loaded only here), held to the same
   tolerances and timed on the same inputs, and both designs' critical
   paths;
16. lya: examples/lya/paramfile.genic through the genic CLI with the
   Eisenstein-Hu cut of phase 9 (Ngrid 32: 32^3 gas + 32^3 DM, BoxSize
   20000 kpc/h, z=99), then its paramfile.gadget as it ships
   (hierarchical, cooling, star formation with QuickLymanAlphaProbability
   1, DensityIndependentSphOn 0, cubic, Nmesh 64) but for TreeCoolFile
   "" (LYA_SWITCHES: the absent TREECOOL_ep_2018p, the reference's
   no-UV-background case) and TimeMax 0.2 (LYA_TIME_MAX, the depth cut
   that pays for phase 27: it ships with 0.33333; the output at 0.2
   stays) -> Simulation.run() ->
   write_snapshot, the six kernels' launch counts reset just before and
   read just after: stars formed, no particle lost, the gas state finite
   and above the entropy floor, each snapshot's star count, stellar mass
   and type-4 blocks read back, sfr.txt's lines of 8 columns, and
   RestartFlag 3 through the CLI's body on the last snapshot, whose PIG
   carries its grouped stars' blocks;
17. K6 against its plain version on the card, on the inputs of the lya
   run's last cooling call: every gas particle and the call's own closing
   subset in float32, every gas particle in float64, the net rate (the
   cooling time's call) on every gas particle, and init_sfr's float64
   threshold (one particle): u_new, ne/nh and the rate within COOL_TOL,
   unlisted rows untouched, two launches bit-identical; in every case the
   first design of K6 (csrc/cooling_simple.cu, loaded only here) on the
   same inputs, whose outputs the kernel must equal bit for bit; the
   kernel's time and the first design's (CUDA graph replays of the entry
   point), the plain version's (one call), the bound and the kernel's
   share of it; and in every case where K6's loops stop (cooling_exits,
   rate_exits: the plain step functions run to the caps on the card, row
   by row) and the operations that leaves;
18. neutrinos: dm-small from its own paramfiles with MassiveNuLinRespOn
   1 and MNue 0.2 in both (genic in-process), planes at a = 0.2 and
   0.25 and OutputEnergyDebug (NU_SWITCHES), to a = 0.25, the kernels'
   launch counts reset just before and read just after (so in every
   phase below): the delta_tot history holds an entry for each PM step,
   grav_pm is finite, the multiplier is above 1 at the lowest k; its
   P(k) printed beside phase 10's at a = 0.25, bin by bin; energy.txt
   printed and held to one row a snapshot; the six planes read back
   (finite, zero mean, NPART); "PMgrav" with the neutrino response;
19. RestartFlags 1, 2, 4 and 99 through the CLI on phase 10's output,
   each in a copy of it, four processes at once: flags 2 and 1 resume
   from PART_001 to a = 0.25, their positions and P(k) held to the
   uninterrupted run's and to each other's (RESUME_POS_TOL,
   FLAG4_PK_RTOL); flag 4's P(k) of the last snapshot against the
   in-run P(k); flag 99 on it against GRAVITY_TEST_LIMITS, with the
   direct sum's seconds;
20. hybrid neutrinos: dm-small with 32^3 type-2 particles beside the
   64^3 DM (HYBRID_GENIC, HYBRID_SWITCHES: NuPartTime 0.2, to a = 0.22):
   grav_pm of type 2 zero at every force call before NuPartTime and
   nonzero after;
21. the light cone: dm-small's IC in a 500 Mpc/h box with LightconeOn
   (to a = 0.15): rows written, each inside the shell the run crossed,
   "Lightcone" seconds;
22. one IC through both packages: the committed reduced dm-small IC
   (tests/torch_parity/IC, 24^3, Nmesh 48) run twice to a = 0.25, each
   run's P(k) and PIGs against the JAX package's outputs from it
   (tests/torch_parity/jax_outputs.json) and the two runs against each
   other, within PARITY_PK_RTOL;
23. star-small as it ships: examples/star-small/paramfile.genic through
   the genic CLI (phase 9's Eisenstein-Hu cut), paramfile.gadget with
   TreeCoolFile empty (the absent TREECOOL_fg_june11), Simulation.run()
   to a = 0.15 (STAR_SMALL_TIME_MAX: the depth cut that pays for phases
   28 and 29; it ships with 0.2) with cooling, star formation, ofjt10
   winds,
   metal return
   and black holes (seeded from each PIG): the six kernels' launches,
   "walltime" by layer, stars, BHs, wind kicks (0: hierarchical steps
   compute no dispersion), the total mass against the IC's (MASS_TOL),
   each snapshot's star and BH blocks and each PIG read back, K3's and
   ops/pairs.pair_reduce's card time by caller (SUBGRID_CALLERS), and
   RestartFlag 3 through the CLI's body on the last snapshot;
24. winds and black holes on global steps: phase 23's snapshot at a =
   0.15 resumed through the CLI's body (RestartFlag 2) with
   GLOBAL_SWITCHES (SplitGravityTimestepsOn 0, the seeding and star
   formation thresholds lowered, Generations 64, outputs at a = 0.151
   and 0.152) for at most GLOBAL_STEPS global steps: wind kicks,
   decoupled rows without hydro force, a BH seeded that accretes,
   swallowing and mergers counted, BH-Details-R0 and the last
   snapshot's BH blocks read back (from_snapshot), and the card time by
   caller as in phase 23;
25. travis as it ships: examples/travis/paramfile.genic through the genic
   CLI (phase 9's Eisenstein-Hu cut: 24^3 gas + 24^3 DM, 128 kpc/h, z =
   99), paramfile.gadget with MetalCoolFile pointing at a stand-in table
   the smoke writes from a closed form (write_metal_table: the absent
   cooling_metal_UVB) and TreeCoolFile empty (the absent
   TREECOOL_fg_june11), Simulation.run() to a = 0.015 with cooling and
   the metal table, star formation, ofjt10 winds, metal return, black
   holes and FOF: every kernel launched, the gas's metallicity fed to K6,
   the total mass kept, the snapshots and PIGs read back;
26. reionization on star-small: phase 23's snapshot at a = 0.15 resumed
   through the CLI's body (RestartFlag 2, hierarchical as shipped) to a =
   0.162 (REION_TIME_MAX, the depth cut) with the metal table, a z_reion
   grid (UVFluctuationFile), the excursion set (epoch z 6 to 5.35) and QSO
   lightup on, each reading a stand-in the smoke writes
   (write_reion_inputs: a TreeCool table, the metal table, a z_reion grid
   at Nmesh 8 with a late patch at z_re 5.25, a HeII history from z 5.6 to
   4), QSOMinMass/QSOMaxMass bracketing the PIG's largest halo and 1000
   kpc/h bubbles (cuts, printed): the UVBG updates and their xHI, gas rows
   with J21 > 0 and zreion set, the late patch's rows without UV rates
   between the epoch's end (z 5.35) and z = 5.25 and with them after,
   HeIII-ionized rows each inside a placed bubble, gas with metallicity >
   0, the mass against the snapshot's, J21,
   ZReionized and HeIIIIonized read back from the last snapshot, the
   "UVBG" and "HeIII" seconds; then K6 with its per-row inputs on that
   run's last cooling call (per-row UV rates, metallicity, the metal
   table) against its plain version, and with them off bit for bit its
   first design, both timed (reion_cooling_case);
27. the sharded driver: examples/dm-small/paramfile.gadget as it ships
   (64^3, Nmesh 128, hierarchical, to a = 0.25, snapshots and PIGs at
   0.15, 0.2 and 0.25) from phase 9's IC through Simulation.run_sharded,
   with this script as each rank (--sharded-rank, started with the
   environment torch.distributed.run gives a rank; one launch a
   configuration runs phases 27-30 one after the other), twice: (a) one
   NCCL rank with MPG_SHARDED=1 and (b) two gloo ranks sharing the card
   (MPG_DIST_BACKEND=gloo), under a time limit: every rank on the card
   with K1, K2 and
   K3 launched by the sharded steps and FOF; every ID once in each
   snapshot, the total mass the IC's, the PIGs (pig_check), and the last
   snapshot's P(k) against phase 10's on the bins below k_Nyquist/4
   (SHARDED_PK_RTOL); per configuration the PM steps, substeps, seconds
   of steps, collective seconds and bytes per PM step and rank 0's
   walltime by layer;
28. the sharded driver with gas: phase 16's lya paramfile (cooling and
   quick-Lyman-alpha star formation, TreeCoolFile empty, TimeMax
   LYA_TIME_MAX) from phase 16's IC through Simulation.run_sharded, in
   phase 27's two configurations (lya_sharded_phase): every rank on the
   card with K1-K6 launched; held to phase 16's single-device run at the
   same a: every ID once (QLA converts whole: the IC's IDs exactly), the
   total mass the IC's, the final snapshot's dark-matter P(k) on the bins
   below k_Nyquist/4, the star count and stellar mass, and the gas's
   mean density and entropy, each within its LYA_SHARDED_TOL (measured);
   sfr.txt's rows (the steps that formed stellar mass) well formed and as
   many as phase 16's such rows within LYA_SFR_ROWS_TOL; stars formed on
   both ranks in (b); the distributed FOF of (b)'s final rows
   (FOFHaloMinLength LYA_FOF_MIN_LENGTH), gas and stars attached as
   secondaries, against the single-device run_fof of the same rows (group
   count, lengths and masses by type); per configuration the PM steps,
   substeps, seconds, collective seconds and bytes and rank 0's walltime
   by layer, SPH/Density, SPH/Hydro and Cooling/SFR among them;
29. the sharded driver with the subgrid physics: star-small as it ships
   (cooling, star formation, ofjt10 winds from the new stars'
   neighbours, metal return, BHs seeded from each PIG) through
   Simulation.run_sharded in phase 27's two configurations
   (star_sharded_phase), each rank this script: (i) phase 23's IC and
   paramfile copy to STAR_SHARDED_TIME_MAX (its depth cut), held to
   phase 23's snapshot at that a: every ID of the IC at most once
   (spawned stars' IDs a gas parent's + 2^40), the total mass the IC's
   (MASS_TOL), the dark-matter P(k) below k_Nyquist/4, the stars, BHs and
   gas rows with Z > 0 within STAR_SHARDED_TOL, the Metals, star and BH
   blocks read back, one stripe a rank; (ii) phase 23's a = 0.15
   snapshot resumed (RestartFlag 2) with phase 24's GLOBAL_SWITCHES on at
   most GLOBAL_STEPS global steps, held to phase 24: wind kicks, a BH
   seeded after the restart that accretes, the last snapshot's BH and
   star blocks read back; swallowed gas and mergers printed beside phase
   24's.  Every rank on the card with K1-K6 launched; per configuration
   and part the PM steps, substeps, seconds, collective seconds and bytes
   per PM step, rank 0's walltime by layer (Winds, BH and MetalReturn
   among them) and its K3 and pair_reduce card time by caller;
30. the sharded driver with the options: in phase 27's two
   configurations, each configuration's ranks started once for four runs
   one after the other (options_sharded_phase): (1) phase 18's neutrino
   run (its IC and paramfile: MNue 0.2, planes) to OPT_NU_TIME_MAX, every
   rank's delta_tot history an entry a PM step, the P(k) file rank 0
   wrote against phase 18's at that a below k_Nyquist/4
   (OPT_SHARDED_TOL), the planes finite with zero mean; (2) phase 20's
   hybrid run to OPT_HYBRID_TIME_MAX, on every rank the type-2 rows
   without PM force at each PM refresh before NuPartTime and with it
   after; (3) phase 21's light cone, one stripe a rank, every row inside
   the shell the run crossed, as many rows as phase 21's within
   OPT_SHARDED_TOL; (4) phase 26's reionization run, phase 23's a = 0.15
   snapshot resumed to OPT_REION_TIME_MAX: K1-K6 launched on every rank,
   the excursion set updated, gas with J21 > 0 each with zreion set,
   HeIII rows each inside the bubble that ionized it, the mass, the last
   snapshot's J21, ZReionized and HeIIIIonized blocks read back; per
   configuration and run the PM steps, seconds, collectives and rank 0's
   walltime by layer (Lightcone, Planes, HeIII, UVBG, PMgrav);
31. the tools and the examples' checkers (tools_phase): each tool of
   mpgadget_tpu_torch/tools runs as this script with --no-jax in a process
   of its own, in which any import of jax, jaxlib or mpgadget_tpu fails,
   TOOL_PROCESSES at a time, and its exit code is checked: (a)
   make_class_power --backend eh on copies of examples/dm-small's, lya's
   and travis's paramfile.genic, then genic's CLI on dm-small's and lya's
   unchanged (64^3; 32^3 gas + 32^3 DM): each IC held to phase 9's / 16's
   from the Eisenstein-Hu override, the same realisation, velocities by
   norm and positions' rms over the spacing within IC_TABLE_TOL; (b)
   check_examples' functions one by one on the outputs of phases 10, 16,
   23 and 25 (dm-small's and travis's input spectra the tables of (a)),
   printing those run and those left out with the reason (dm-small's
   check_hmf: the largest halo below the reference's 9e12 Msun, as phase
   10 prints; lya's redshift check: the depth cut; its IGM and ionization
   checks: no UV background); (c) compare_snap on the card on phase 22's
   two runs' final snapshots, displacements within COMPARE_POS_TOL of the
   box and the P(k) ratio within PARITY_PK_RTOL of 1; (d) hmf_from_fof and
   plot_gsmf on dm-small's and star-small's last PIGs, their counts those
   of the PIG (pig_check); (e) make_HI_reionization_table at phase 26's
   box with --ngrid 16 read back: Nmesh, BoxSize, finite, the median
   within 0.5 of --zbar; (f) make_yield_tables --npz equal to
   physics/yield_tables' arrays, convert_from_gadget_1 on a Gadget-1 file
   written here read back, convert_hdf5 where h5py is installed.

Every phase prints its seconds ("phase N (...): s of the smoke"), and
the line "phase seconds:" sums them before the kernel table.

Bounds ("bound_ms") are the larger of bytes over the card's memory rate
(3.35 TB/s) and FP32 operations over its FP32 peak (67 TFLOP/s, an FMA
counted as 2; K6's float64 cases over the FP64 peak, 34 TFLOP/s, of
NVIDIA's data sheet), for the work these inputs need: padding is not work, a
pair beyond rcut needs only its distance, and the walk reads each node
of the tree once (revisits hit L2).  Beside the walk's bound stands its
critical path, the longest chain of loads of which each needs the one
before, times one L2 round trip: the kernel's (the longest block's sum
of each round's longest sibling chain; for K3 the longest group's
rounds) and a serial walk's (the longest block's or group's visits);
for K4 and K5 the longest group's chain of dependent loads in each
design (sph_critical_paths).
K3's bound is the node rows read once, the groups read and the leaf
lists written, against NEIGHBOR_OPS per visit; beside it stands the
walk's own bound, which counts only the listed leaves written and not
the fill of the lists' unused slots.  K4's and K5's are the particle
tables read once and each target's row written once, against
DENSITY_PAIR_OPS / HYDRO_PAIR_OPS for each pair that counts and the
distance's operations for each other pair the lists hold.  K6's are
the operations its exits leave on these rows (cooling_exits: the network
evaluations and iterations each row makes, a transcendental, division or
square root counted as one), against the bytes of its arrays; beside it
stands the full work's (cooling_work: every iteration run, as the first
design does), which reads two designs against the same work.

The last two lines of standard output are the kernel table and the
result, each one JSON object.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
NGRID = 64            # dm-small: 64^3 particles
NMESH = 128           # dm-small: Nmesh 128
BOXSIZE = 64000.0     # kpc/h
A_START = 0.1         # z = 9
HIER_STEPS = None     # PM steps of the hierarchical dm-small run (None:
#                       the whole run to its TimeMax, a = 0.25)
KERNEL_TOL = 1e-4     # max |kernel - plain| / max |plain|
WALK_TOL = 1e-5       # |kernel - plain| / |plain| by norm (acc, pot)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM memory rate
FP32_OPS_PER_S = 67e12      # H100 SXM FP32 peak outside the tensor cores
FP64_OPS_PER_S = 34e12      # H100 SXM FP64 peak outside the tensor cores
# FP32 operations per source-target pair (an FMA counted as 2), counted
# from csrc/shortrange.cuh and the K1 loop: wrap 9, r2 5, rsqrt and r 3,
# u and -u^2 2, exp 2, erfcx fit 26, windows 3, softening 5, cut 2, sums 6
PAIR_OPS = {False: 64, True: 72}     # with_potential -> ops
DISTANCE_OPS = 15        # a pair beyond rcut: wrap 9, r2 5, the cut 1
MONOPOLE_OPS = {False: 64, True: 70}  # the walk keeps r = 0 in the pot
WALK_DECISION_OPS = 44   # per visit: wrap and |d| 12, dmin 10, r2min 5,
#                          criteria 11, inside 7 (csrc/treewalk.cu)
WALK_ROW_BYTES = 36      # per node: two float4 rows and one int
# K3 per visit (csrc/neighbors.cu): wrap and |d| 12, half length 1, dmin 9,
# r2min 5, reach^2 and the test 2, and the max with hmax when symmetric
NEIGHBOR_OPS = {False: 29, True: 30}
NEIGHBOR_ROW_BYTES = {False: 20, True: 24}   # float4 row, int meta, hmax
NEIGHBOR_GROUP_BYTES = 36    # per group read: node, center, half, radius
HMF_MSUN = 9e12   # check_hmf: the largest halo (check_results.py:104-115)

PARAMS = """
InitCondFile = {ic}
OutputDir = {out}
OutputList = 0.15,0.2,0.25
TimeMax = 0.25
TimeLimitCPU = 3600
Omega0 = 0.288
OmegaLambda = 0.712
OmegaBaryon = 0.0472
HubbleParam = 0.7
MassiveNuLinRespOn = 0
HydroOn = 0
CoolingOn = 0
StarformationOn = 0
DensityIndependentSphOn = 0
SnapshotWithFOF = 0
SplitGravityTimestepsOn = 0
PartAllocFactor = 2.0
BlackHoleOn = 0
MetalReturnOn = 0
WindOn = 0
Nmesh = {nmesh}
"""


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def bound(ops, nbytes, ops_per_s=FP32_OPS_PER_S):
    """(bound_ms, bound_by) for the given operations (FP32 unless the
    peak ops_per_s says otherwise) and bytes."""
    t_ops = ops / ops_per_s * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def pair_bound(nb, G, sources, with_potential, within=None):
    """K1's bound for `sources` real sources in all (padding excluded), of
    which `within` (source, target) pairs are closer than rcut and need
    the pair terms; the others need only their distance.  within=None:
    every pair at the full cost."""
    pairs = G * sources
    within = pairs if within is None else within
    ops = (within * PAIR_OPS[with_potential]
           + (pairs - within) * DISTANCE_OPS)
    # targets, sources (x, y, z, m), acc0 + pot0 read; acc + pot written
    nbytes = 4 * (3 * nb * G + 4 * sources + 4 * nb * G + 4 * nb * G + nb)
    return bound(ops, nbytes)


def walk_bound(nb, G, LL, nodes, visits, monopoles, with_potential):
    """K2's bound for `visits` node visits over a tree of `nodes` nodes,
    of which `monopoles` applied a monopole to the G targets of their
    block."""
    ops = (visits * WALK_DECISION_OPS
           + monopoles * G * MONOPOLE_OPS[with_potential])
    # each node row read once (at most the visits); targets, block boxes,
    # aold, active read; acc, pot, leaf lists, leaf counts, flags, visit
    # and monopole counts written
    nbytes = (min(nodes, visits) * WALK_ROW_BYTES + nb * G * 12 + nb * 29
              + nb * G * 16 + nb * LL * 8 + nb * 17)
    return bound(ops, nbytes)


def neighbor_bound(ng, LL, nodes, visits, symmetric, listed=None):
    """K3's bound for `visits` node visits of ng groups over a tree of
    `nodes` nodes: each node row read once (at most the visits), the
    groups read, and the leaf lists (ng x LL int32), counts, flags and
    visit counts written.  listed: count only that many list entries
    written, the leaves the walk records, without the fill of the unused
    slots (the walk's own bound)."""
    ops = visits * NEIGHBOR_OPS[symmetric]
    written = ng * LL if listed is None else listed
    nbytes = (min(nodes, visits) * NEIGHBOR_ROW_BYTES[symmetric]
              + ng * NEIGHBOR_GROUP_BYTES + written * 4 + ng * 9)
    return bound(ops, nbytes)


def rel_norm(a, ref):
    """|a - ref| / |ref| by norm (0 where both are zero)."""
    import torch
    return float(torch.linalg.norm(a - ref)
                 / max(float(torch.linalg.norm(ref)), 1e-30))


def write_lattice_ic(path, ngrid, seed=4242):
    """A 64^3-style DM IC: a lattice displaced by up to 0.3 cell (seeded),
    zero velocity, at a = 0.1, in the dm-small cosmology and box."""
    import numpy as np
    from mpgadget_tpu_torch.cosmology import Cosmology
    from mpgadget_tpu_torch.io.bigfile import BigFile
    from mpgadget_tpu_torch.io import snapshot as snap_io
    from mpgadget_tpu_torch.utils import get_unitsystem
    from mpgadget_tpu_torch.utils.constants import CM_PER_KPC

    units = get_unitsystem(CM_PER_KPC, 1.989e43, 1e5)
    cp = Cosmology(Omega0=0.288, OmegaBaryon=0.0472, OmegaLambda=0.712,
                   HubbleParam=0.7, TimeBegin=A_START).init_units(units)
    cell = BOXSIZE / ngrid
    g = (np.arange(ngrid) + 0.5) * cell
    pos = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    rng = np.random.RandomState(seed)
    pos = np.mod(pos + rng.uniform(-0.3, 0.3, pos.shape) * cell, BOXSIZE)
    n = len(pos)
    mass = cp.Omega0 * cp.RhoCrit * BOXSIZE ** 3 / n
    bf = BigFile(path, create=True)
    snap_io.write_species(bf, 1, pos=pos, vel=np.zeros((n, 3)),
                          pid=np.arange(1, n + 1), atime=A_START)
    masstable = np.zeros(6)
    masstable[1] = mass
    ntot = np.zeros(6, np.uint64)
    ntot[1] = n
    hubble = cp.hubble_function(A_START)
    snap_io.write_header(bf, snap_io.SnapshotHeader(
        TotNumPart=ntot, MassTable=masstable, Time=A_START, TimeIC=A_START,
        BoxSize=BOXSIZE, Omega0=cp.Omega0, OmegaLambda=cp.OmegaLambda,
        HubbleParam=cp.HubbleParam, OmegaBaryon=cp.OmegaBaryon,
        CMBTemperature=cp.CMBTemperature, RSDFactor=1.0 / (A_START * hubble)))
    return path


def build_sim(workdir, device, ngrid=NGRID, nmesh=NMESH):
    """build_simulation on the lattice IC with the dm-small parameters;
    returns (sim, output directory)."""
    from mpgadget_tpu_torch.main import build_simulation
    from mpgadget_tpu_torch.params import create_gadget_parameter_set

    ic = write_lattice_ic(os.path.join(workdir, "IC"), ngrid)
    out = os.path.join(workdir, "output")
    ps = create_gadget_parameter_set()
    ps.parse_string(PARAMS.format(ic=ic, out=out, nmesh=nmesh))
    ps.validate()
    sim, _ = build_simulation(ps, device=device)
    return sim, out


def time_ms(fn, reps):
    """Mean milliseconds per call on the card (CUDA events; one call
    first to warm up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def once_ms(fn, device):
    """(fn(), its milliseconds): CUDA events around the one call on the
    card, the host clock elsewhere."""
    import torch
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def graph_ms(fn, reps):
    """Mean milliseconds of the device work of one call of fn: the call
    is captured once in a CUDA graph and the graph replayed, so that the
    host's time to enqueue it (allocations, launches) does not count.  fn
    must not synchronise."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                        # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, reps)


def pairs_within(tx, ty, tz, sx, sy, sz, count, rcut, batch=64, chunk=512):
    """Number of (target, real source) pairs closer than rcut."""
    import torch

    def wrap(d):
        return d - torch.round(d)

    nb, S = sx.shape
    slot = torch.arange(S, device=sx.device)
    n = 0
    for b0 in range(0, nb, batch):
        bs = slice(b0, b0 + batch)
        for c0 in range(0, S, chunk):
            cs = slice(c0, c0 + chunk)
            dx = wrap(sx[bs, None, cs] - tx[bs, :, None])
            dy = wrap(sy[bs, None, cs] - ty[bs, :, None])
            dz = wrap(sz[bs, None, cs] - tz[bs, :, None])
            near = torch.sqrt(dx * dx + dy * dy + dz * dz) < rcut
            real = slot[None, cs] < count[bs, None]
            n += int((near & real[:, None, :]).sum())
    return n


def kernel_phase(nb, G, S, rs_inv, h_inv, rcut, counts=False, seed=7,
                 device="cuda"):
    """Pair kernel vs its plain version on the card at (nb, G, S); with
    counts, block 0 holds S sources, block 1 none and the others a
    random multiple of 8, with zero mass past each count."""
    import numpy as np
    import torch
    from mpgadget_tpu_torch.gravity import pairkernel as pk

    rng = np.random.RandomState(seed)
    c = rng.rand(nb, 1, 3)
    tgt = np.mod(c + rng.uniform(-0.01, 0.01, (nb, G, 3)), 1.0)
    src = np.mod(c + rng.uniform(-1.2 * rcut, 1.2 * rcut, (nb, S, 3)), 1.0)
    sm = rng.uniform(0.5, 1.5, (nb, S))
    dev = torch.device(device)
    if counts:
        cnt = rng.randint(0, S // 8 + 1, nb) * 8
        cnt[0], cnt[1] = S, 0
        sm[np.arange(S)[None, :] >= cnt[:, None]] = 0.0
    else:
        sm[:, -S // 10:] = 0.0      # zero-mass padding slots, as packed
        cnt = np.full(nb, S)
    count = torch.as_tensor(cnt, dtype=torch.int32, device=dev)
    sources = int(cnt.sum())

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=dev)

    tx, ty, tz = (put(tgt[:, :, k]) for k in range(3))
    sx, sy, sz = (put(src[:, :, k]) for k in range(3))
    smt = put(sm)
    within = pairs_within(tx, ty, tz, sx, sy, sz,
                          count, rcut)
    acc0 = torch.zeros((nb, 3, G), dtype=torch.float32, device=dev)
    pot0 = torch.zeros((nb, G), dtype=torch.float32, device=dev)
    out = {}
    for wp in (False, True):
        args = (tx, ty, tz, sx, sy, sz, smt, acc0, pot0, rs_inv, h_inv, rcut,
                count)
        kw = dict(with_potential=wp)
        acc, pot = pk.block_pair_accumulate(*args, **kw)
        torch.cuda.synchronize()
        (ref_acc, ref_pot), check_ms = once_ms(
            lambda: pk.block_pair_accumulate_reference(*args, **kw), dev)
        check(bool(torch.isfinite(acc).all() & torch.isfinite(pot).all()),
              "pair kernel output not finite")
        abs_err = float((acc - ref_acc).abs().max())
        rel = abs_err / max(float(ref_acc.abs().max()), 1e-30)
        if wp:
            pabs = float((pot - ref_pot).abs().max())
            rel = max(rel, pabs / max(float(ref_pot.abs().max()), 1e-30))
            abs_err = max(abs_err, pabs)
        ms = time_ms(lambda: pk.block_pair_accumulate(*args, **kw), 20)
        # above S = 8192 (the slice's grown S) the plain version's one
        # check call is its time (seconds a call); below, a mean of three
        plain_ms = check_ms if S > 8192 else time_ms(
            lambda: pk.block_pair_accumulate_reference(*args, **kw), 3)
        bound_ms, bound_by = pair_bound(nb, G, sources, wp, within)
        print(f"kernel block_pair_accumulate nb={nb} G={G} S={S} "
              f"counts={'per-block' if counts else 'all S'} "
              f"sum(count)={sources} pairs within rcut {within} of "
              f"{G * sources} with_potential={wp}: "
              f"max_abs_err={abs_err:.6e} err/max|plain|={rel:.6e} "
              f"(tol {KERNEL_TOL:g}) kernel_ms={ms:.6f} "
              f"plain_ms={plain_ms:.6f} bound_ms={bound_ms:.6f} "
              f"({bound_by})", flush=True)
        check(rel <= KERNEL_TOL, f"pair kernel disagrees with plain version "
              f"(with_potential={wp}, S={S}): {rel:.3e} > {KERNEL_TOL:g}")
        out[wp] = dict(max_abs_err=abs_err, rel=rel, ms=ms,
                       plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, sources=sources)
    return out


def l2_phase(entries=1 << 21, steps=200000, seed=11):
    """Nanoseconds per dependent load hitting L2: a random cycle through
    an 8 MB table (past L1, inside the 50 MB L2), walked once whole to
    bring it into L2."""
    import ctypes
    import numpy as np
    import torch
    from mpgadget_tpu_torch import kernels

    fn = kernels.load("l2chase").l2_chase
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    order = np.random.RandomState(seed).permutation(entries)
    nxt = np.empty(entries, np.int32)
    nxt[order] = np.roll(order, -1)
    nxt_t = torch.as_tensor(nxt, device="cuda")
    out = torch.zeros(1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def chase(n):
        check(fn(nxt_t.data_ptr(), n, out.data_ptr(), stream) == 0,
              "l2_chase launch failed")

    chase(entries)                  # bring the table into L2
    ns = time_ms(lambda: chase(steps), 3) * 1e6 / steps
    print(f"L2 round trip (pointer chase, 8 MB table): {ns:.3f} ns",
          flush=True)
    return ns


def clustered_ipos(n, seed=31):
    """n integer positions in eight Gaussian clusters (0.03 box wide)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    c = rng.uniform(0.2, 0.8, (8, 3))
    pos = np.mod(c[rng.randint(8, size=n)] + 0.03 * rng.randn(n, 3), 1.0)
    return np.minimum((pos * 2.0 ** 32).astype(np.int64), 2 ** 32 - 1)


SHIFT = (0.04367676, 0.01198168, 0.02141668)   # box units: what
#   run.py:_update_random_offset draws at dm-small's second step


def serial_walk_fn():
    """The serial walk's entry point (csrc/treewalk_serial.cu), a
    yardstick that only this script loads."""
    import ctypes
    from mpgadget_tpu_torch import kernels
    fn = kernels.load("treewalk_serial").tree_walk_serial_f32
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 3 + [ctypes.c_int]
                   + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
    return fn


def serial_walk(fn, packed, tree, tpos, center, half, aold, active, cfg,
                rcut, bh_angle2, use_bh, rs_inv, h_inv, with_potential):
    """One launch of the serial walk on the walk kernel's inputs; returns
    (acc, pot, leaf_idx, n_leaves, overflow, visits, monopoles)."""
    import numpy as np
    import torch
    nodes, meta = packed
    nb, G, _ = tpos.shape
    dev = tpos.device
    LL = cfg.leaf_list_max
    out = (torch.empty((nb, 3, G), dtype=torch.float32, device=dev),
           torch.empty((nb, G), dtype=torch.float32, device=dev),
           torch.empty((nb, LL), dtype=torch.int64, device=dev),
           torch.empty(nb, dtype=torch.int64, device=dev),
           torch.empty(nb, dtype=torch.bool, device=dev),
           torch.empty(nb, dtype=torch.int32, device=dev),
           torch.empty(nb, dtype=torch.int32, device=dev))
    rc = fn(nodes.data_ptr(), meta.data_ptr(), tree.n_nodes.data_ptr(),
            tpos.data_ptr(), center.data_ptr(), half.data_ptr(),
            aold.data_ptr(), active.data_ptr(), *(t.data_ptr() for t in out),
            nb, G, tree.capacity, LL, float(rcut),
            float(np.float32(rcut * rcut)), float(np.float32(bh_angle2)),
            int(bool(use_bh)), float(rs_inv), float(h_inv),
            int(with_potential), torch.cuda.current_stream(dev).cuda_stream)
    check(rc == 0, f"serial walk launch failed: CUDA error {rc}")
    return out


def walk_phase(workdir, l2_ns, device="cuda", ngrid=NGRID, nmesh=NMESH):
    """The walk kernel against its plain version on the dm-small lattice
    IC's first tree, on the same particles in clusters and on the lattice
    after a box shift, with the serial walk beside it; returns one dict
    per case."""
    import numpy as np
    import torch
    from mpgadget_tpu_torch.gravity import treewalk as tw
    from mpgadget_tpu_torch.gravity.treepm import StageTimer, walk_inputs

    sim, _ = build_sim(workdir, device, ngrid, nmesh)
    sim.compute_forces()            # PM and the first tree force
    pd = sim.pdata
    tg = sim._tree_grav
    acc_old = pd.grav_accel + pd.grav_pm
    amag = torch.sqrt(torch.sum(acc_old * acc_old, dim=-1))
    ipos_clusters = torch.as_tensor(clustered_ipos(int(pd.capacity)),
                                    device=pd.ipos.device)
    shift = torch.as_tensor((np.array(SHIFT) * 2.0 ** 32).astype(np.int64),
                            device=pd.ipos.device)
    ipos_shifted = (pd.ipos + shift[None, :]) & 0xFFFFFFFF
    serial_fn = serial_walk_fn() if device == "cuda" else None
    out = []
    for name, ipos, use_bh, LL, wp in (
            ("lattice", pd.ipos, True, 512, False),
            ("lattice", pd.ipos, False, 4096, True),
            ("clusters", ipos_clusters, True, 512, True),
            ("shifted", ipos_shifted, False, 512, False),
            ("shifted", ipos_shifted, False, 8192, False)):
        kw = tg.force_kwargs(int(pd.capacity), use_bh=use_bh)
        w = walk_inputs(ipos, pd.mass, pd.valid, amag,
                        leaf_max=kw["leaf_max"], max_level=kw["max_level"],
                        node_cap=kw["node_cap"], group_size=kw["group_size"])
        aold = kw["err_tol_force_acc"] * w.amin / kw["g_over_box2"]
        cfg = tw.WalkConfig(leaf_list_max=LL)
        args = (w.tree, w.tpos, w.center, w.half, aold, w.active, cfg,
                kw["rcut_box"], kw["theta2"], use_bh, kw["rs_inv_box"],
                kw["h_inv_box"])
        case = f"{name} LL={LL}"
        t_kernel, t_plain = StageTimer(), StageTimer()
        res = tw.traverse_fused(*args, with_potential=wp, timer=t_kernel)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = tw.traverse_fused_reference(*args, with_potential=wp,
                                          timer=t_plain)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        acc, pot, leaf, nl, ovf = res
        racc, rpot, rleaf, rnl, rovf = ref
        check(torch.equal(leaf, rleaf) and torch.equal(nl, rnl)
              and torch.equal(ovf, rovf),
              f"walk kernel leaf lists differ ({case})")
        check(t_kernel.series == t_plain.series
              and t_kernel.counts == t_plain.counts,
              f"walk kernel visit counts differ ({case}): "
              f"{t_kernel.series} vs {t_plain.series}")
        check(bool(torch.isfinite(acc).all() & torch.isfinite(pot).all()),
              "walk kernel output not finite")
        err = rel_norm(acc, racc)
        abs_err = float((acc - racc).abs().max())
        if wp:
            err = max(err, rel_norm(pot, rpot))
            abs_err = max(abs_err, float((pot - rpot).abs().max()))
        check(err <= WALK_TOL, f"walk kernel acc/pot differ by {err:.3e} "
              f"> {WALK_TOL:g} by norm ({case})")
        if name == "shifted":
            check(bool(ovf.any()) == (LL == 512),
                  f"overflowing blocks not as expected ({case})")

        # a second launch, and the serial walk: the same bits
        packed = tw.pack_nodes(w.tree)
        again, stats = tw.walk_kernel(*args, with_potential=wp,
                                      packed=packed)
        check(all(torch.equal(a, b) for a, b in zip(res, again)),
              f"two launches of the walk kernel differ ({case})")
        rounds = int(stats["rounds"].max())
        loads = int(stats["loads"].max())
        check(int(stats["serial"].sum()) == 0,
              f"the walk kernel's stack ran out of room ({case})")
        ser = serial_walk(serial_fn, packed, *args, wp)
        check(all(torch.equal(a, b) for a, b in zip(res, ser[:5]))
              and torch.equal(ser[5], stats["visits"])
              and torch.equal(ser[6], stats["monopoles"]),
              f"walk kernel and serial walk differ in some bit ({case})")

        # the kernel is shorter than the host takes to enqueue it, so the
        # device times come from graph replays; eager_ms is what a caller
        # sees who makes call after call
        ms = graph_ms(lambda: tw.traverse_fused(*args, with_potential=wp),
                      20)
        eager_ms = time_ms(lambda: tw.traverse_fused(
            *args, with_potential=wp), 20)
        serial_ms = graph_ms(lambda: serial_walk(serial_fn, packed, *args,
                                                 wp), 10)
        alone_ms = graph_ms(lambda: tw.walk_kernel(
            *args, with_potential=wp, packed=packed), 20)
        pack_ms = graph_ms(lambda: tw.pack_nodes(w.tree), 20)
        nb, G = w.tpos.shape[:2]
        nodes = t_kernel.series["walk_nodes"][0]
        visits = t_kernel.series["walk_visits_sum"][0]
        vmax = t_kernel.counts["walk_iterations"]
        mono = t_kernel.series["walk_monopoles"][0]
        if name == "clusters":
            check(mono > 0, "clustered walk applied no monopole")
        bound_ms, bound_by = walk_bound(nb, G, LL, nodes, visits, mono, wp)
        path_ms = loads * l2_ns * 1e-6
        serial_path_ms = vmax * l2_ns * 1e-6
        print(f"kernel traverse_fused {name} nb={nb} G={G} LL={LL} "
              f"{'BH' if use_bh else 'relative'} with_potential={wp}: "
              f"identical leaf lists ({int(nl.sum())} leaves, "
              f"{int(ovf.sum())} blocks overflowed); acc/pot err by norm "
              f"{err:.6e} (tol {WALK_TOL:g}), max abs {abs_err:.6e}; "
              f"two launches and the serial walk bit-identical; "
              f"tree nodes {nodes}, deepest level "
              f"{int(w.tree.level.max())}, visits {visits} (longest block "
              f"{vmax}), monopoles {mono} (pair terms "
              f"{mono * G}); kernel_ms={ms:.6f} (device time of the "
              f"wrapper, with pack_nodes {pack_ms:.6f}; the kernel alone "
              f"{alone_ms:.6f}; called again and again by the host "
              f"{eager_ms:.6f}) serial_walk_ms={serial_ms:.6f} "
              f"plain_ms={plain_ms:.6f} "
              f"bound_ms={bound_ms:.6f} ({bound_by}); critical path "
              f"{path_ms:.6f} ms (longest block {loads} dependent loads "
              f"in {rounds} rounds, x one L2 round trip; mean block "
              f"{float(stats['loads'].float().mean()):.1f} loads in "
              f"{float(stats['rounds'].float().mean()):.1f} rounds), a "
              f"serial walk's {serial_path_ms:.6f} ms (longest block "
              f"{vmax} visits)", flush=True)
        out.append(dict(case=case, max_abs_err=abs_err, rel=err, ms=ms,
                        alone_ms=alone_ms, eager_ms=eager_ms,
                        serial_ms=serial_ms,
                        pack_ms=pack_ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by, visits=visits,
                        visits_max=vmax, monopoles=mono, rounds_max=rounds,
                        loads_max=loads,
                        path_ms=path_ms, serial_path_ms=serial_path_ms))
    return out


def accuracy_phase(device):
    """Tree force (walk + pair kernel) vs direct summation, 4096
    particles; the error bounds of tests/test_tree_gravity.py."""
    import numpy as np
    from mpgadget_tpu_torch.gravity.treepm import TreeGravity
    from mpgadget_tpu_torch.gravity.treewalk import WalkConfig
    from mpgadget_tpu_torch.gravity.shortrange import (
        direct_shortrange_pairwise)
    from mpgadget_tpu_torch.particles import ParticleData

    n, box, nmesh = 4096, 1000.0, 32
    rng = np.random.RandomState(21)
    pos = rng.uniform(0, box, (n, 3))
    pdata = ParticleData.from_numpy(pos, np.zeros((n, 3)),
                                    rng.uniform(0.5, 1.5, n),
                                    np.ones(n, np.int32), np.arange(n) + 1,
                                    box, device=device)
    tg = TreeGravity(boxsize=box, nmesh=nmesh, asmth=1.5, rcut=4.5, G=1.0,
                     softening=box / 200.0, tree_use_bh=1,
                     walk_cfg=WalkConfig(leaf_list_max=1024, src_cap=8192))
    acc_tree = tg.compute(pdata)
    check(not bool(tg.last_overflow), "accuracy phase: walk overflow")
    acc_pair, _ = direct_shortrange_pairwise(
        pdata.ipos, pdata.mass, pdata.valid, box,
        float(nmesh / (2 * 1.5) / box), float(4.5 * 1.5 * box / nmesh),
        float(200.0 / box))
    acc_tree = acc_tree.cpu().double().numpy()
    acc_pair = acc_pair.cpu().double().numpy()
    ref = np.sqrt(np.mean(np.sum(acc_pair ** 2, axis=1)))
    rel = np.linalg.norm(acc_tree - acc_pair, axis=1) / ref
    print(f"accuracy tree vs direct (N={n}): mean rel err "
          f"{rel.mean():.6e} (limit 5e-3), p99 "
          f"{np.percentile(rel, 99):.6e} (limit 5e-2)", flush=True)
    check(rel.mean() < 5e-3 and np.percentile(rel, 99) < 5e-2,
          "tree force disagrees with direct summation")


def slice_phase(workdir, device, ngrid=NGRID, nmesh=NMESH, max_steps=3):
    """dm-small through the port's entry points; returns a dict of what
    was measured.  Both kernels' LAUNCHES are reset just before the run
    and read just after the snapshot."""
    import numpy as np
    import torch
    from mpgadget_tpu_torch.gravity import pairkernel as pk
    from mpgadget_tpu_torch.gravity import treewalk as tw
    from mpgadget_tpu_torch.gravity.treepm import StageTimer
    from mpgadget_tpu_torch.io.bigfile import BigFile
    from mpgadget_tpu_torch.io import snapshot as snap_io

    sim, out = build_sim(workdir, device, ngrid, nmesh)
    sim.tree_timer = StageTimer()
    step_seconds = []
    run_step = sim.step

    def timed_step(dti):
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_step(dti)
        if device == "cuda":
            torch.cuda.synchronize()
        step_seconds.append(time.perf_counter() - t0)

    sim.step = timed_step
    pk.LAUNCHES = 0
    tw.LAUNCHES = 0
    nsteps = sim.run(max_steps=max_steps, verbose=True)
    snap = sim.write_snapshot()
    launches = {"pair": pk.LAUNCHES, "walk": tw.LAUNCHES}

    check(nsteps == max_steps, f"ran {nsteps} steps, expected {max_steps}")
    check(sim.tree_force_calls >= nsteps + 2,
          f"only {sim.tree_force_calls} tree-force evaluations")
    if device == "cuda":
        for name, n in launches.items():
            check(n >= sim.tree_force_calls,
                  f"{name} kernel launched {n} times for "
                  f"{sim.tree_force_calls} tree-force evaluations")
    pd = sim.pdata
    valid = pd.valid
    check(int(valid.sum()) == ngrid ** 3, "particles lost")
    check(bool(torch.isfinite(pd.vel[valid]).all()), "velocity not finite")
    check(bool(torch.isfinite(pd.grav_accel[valid]).all()
               & torch.isfinite(pd.grav_pm[valid]).all()),
          "acceleration not finite")
    check(float(pd.grav_accel[valid].abs().max()) > 0, "tree force is zero")
    check(bool(((pd.ipos >= 0) & (pd.ipos < 2 ** 32)).all()),
          "position outside the box")
    pks = [f for f in os.listdir(out) if f.startswith("powerspectrum-")]
    check(len(pks) >= nsteps, f"power spectra written: {pks}")
    bf = BigFile(snap)
    hdr = snap_io.read_header(bf)
    sp = snap_io.read_species(bf, 1, hdr)
    check(int(hdr.TotNumPart[1]) == ngrid ** 3 and len(sp["pid"]) ==
          ngrid ** 3, "snapshot particle count")
    spot = bf.open("1/Potential").read()
    check(np.isfinite(sp["pos"]).all() and np.isfinite(sp["vel"]).all()
          and np.isfinite(spot).all(), "snapshot values not finite")
    check(((sp["pos"] >= 0) & (sp["pos"] < BOXSIZE)).all(),
          "snapshot position outside the box")
    power = sim.last_power
    check(np.isfinite(power.power).all() and (power.power > 0).all(),
          "power spectrum not finite and positive")
    return dict(nsteps=nsteps, launches=launches,
                tree_force_calls=sim.tree_force_calls,
                step_seconds=step_seconds, atime=sim.atime,
                stages=dict(sim.tree_timer.seconds),
                walltime=dict(sim.walltime.totals),
                npart=ngrid ** 3, snapshot=os.path.basename(snap),
                powerspectra=len(pks),
                retries=sim.tree_retries,
                counts=dict(sim.tree_timer.counts),
                series=dict(sim.tree_timer.series),
                src_cap=sim._tree_grav.walk_cfg.src_cap,
                group=sim._tree_grav.tree_cfg.group_max,
                capacity=int(sim.pdata.capacity))

def compaction_phase(l2_ns, device="cuda", ngrid=NGRID, nmesh=NMESH,
                     seed=41):
    """The active-target tree force (compacted to the active blocks)
    against the same force with every block walked, on 64^3 clustered
    particles; then both kernels against their plain versions at the
    compacted shapes, their inputs taken from the compacted call."""
    import numpy as np
    import torch
    from mpgadget_tpu_torch.gravity import pairkernel as pk
    from mpgadget_tpu_torch.gravity import treepm
    from mpgadget_tpu_torch.gravity import treewalk as tw

    n = ngrid ** 3
    dev = torch.device(device)
    rng = np.random.RandomState(seed)
    ipos = torch.as_tensor(clustered_ipos(n), device=dev)
    mass = torch.ones(n, dtype=torch.float32, device=dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    amag = torch.as_tensor(rng.uniform(0.5, 1.5, n).astype(np.float32),
                           device=dev) * 1e3
    tg = treepm.TreeGravity(boxsize=BOXSIZE, nmesh=nmesh,
                            softening=2.8 / 30.0 * BOXSIZE / ngrid,
                            tree_use_bh=0, with_potential=True)
    # the active set: half the targets of a seeded 40% of the blocks
    kw = tg.force_kwargs(n)
    G = kw["group_size"]
    nb = n // G
    w = treepm.walk_inputs(ipos, mass, valid, amag, leaf_max=kw["leaf_max"],
                           max_level=kw["max_level"],
                           node_cap=kw["node_cap"], group_size=G)
    blocks = rng.choice(nb, int(0.4 * nb), replace=False)
    rows = (blocks[:, None] * G + np.arange(G)).reshape(-1)
    rows = rows[rng.uniform(size=rows.size) < 0.5]
    act = torch.zeros(n, dtype=torch.bool, device=dev)
    act[w.perm[torch.as_tensor(rows, device=dev)]] = True

    captured = {}
    real_walk, real_pair = treepm.traverse_fused, pk.block_pair_accumulate

    def spy_walk(*a, **k):
        captured["walk"] = (a, k)
        return real_walk(*a, **k)

    def spy_pair(*a, **k):
        captured["pair"] = (a, k)
        return real_pair(*a, **k)

    for attempt in range(6):
        kw = tg.force_kwargs(n)
        treepm.traverse_fused, pk.block_pair_accumulate = spy_walk, spy_pair
        try:
            res_c = treepm.tree_force(ipos, mass, valid, amag,
                                      target_active=act, **kw)
        finally:
            treepm.traverse_fused = real_walk
            pk.block_pair_accumulate = real_pair
        if not bool(res_c.overflow):
            break
        tg.grow()
    check(not bool(res_c.overflow), "compaction phase: walk overflow")
    res_f = treepm.tree_force(ipos, mass, valid, amag, **kw)
    torch.cuda.synchronize()
    nact = int(act.sum())
    same = (torch.equal(res_c.accel[act], res_f.accel[act])
            and torch.equal(res_c.potential[act], res_f.potential[act]))
    diff = max(rel_norm(res_c.accel[act], res_f.accel[act]),
               rel_norm(res_c.potential[act], res_f.potential[act]))
    print(f"compaction: {nact} active targets of {n} in "
          f"{res_c.n_active_blocks} of {nb} blocks (LL "
          f"{kw['walk_cfg'].leaf_list_max}, S {kw['walk_cfg'].src_cap}); "
          f"acc and pot on active rows "
          f"{'bit-identical' if same else 'NOT bit-identical'} to every "
          f"block walked (difference by norm {diff:.6e})", flush=True)
    check(same, f"compacted tree force differs from the full one on "
          f"active rows ({diff:.3e} by norm)")

    # K2 at the compacted shapes
    args, wkw = captured["walk"]
    wkw = {k: v for k, v in wkw.items() if k != "timer"}
    t_kernel, t_plain = treepm.StageTimer(), treepm.StageTimer()
    kres = tw.traverse_fused(*args, timer=t_kernel, **wkw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = tw.traverse_fused_reference(*args, timer=t_plain, **wkw)
    torch.cuda.synchronize()
    walk_plain_ms = (time.perf_counter() - t0) * 1e3
    check(all(torch.equal(a, b) for a, b in zip(kres[2:], ref[2:])),
          "walk kernel leaf lists differ (compacted)")
    check(t_kernel.series == t_plain.series
          and t_kernel.counts == t_plain.counts,
          "walk kernel visit counts differ (compacted)")
    wp = wkw["with_potential"]
    walk_err = max(rel_norm(kres[0], ref[0]), rel_norm(kres[1], ref[1]))
    walk_abs = max(float((kres[0] - ref[0]).abs().max()),
                   float((kres[1] - ref[1]).abs().max()))
    check(walk_err <= WALK_TOL, f"walk kernel acc/pot differ by "
          f"{walk_err:.3e} > {WALK_TOL:g} by norm (compacted)")
    nbc, G = args[1].shape[:2]
    LL = args[6].leaf_list_max
    nodes = t_kernel.series["walk_nodes"][0]
    visits = t_kernel.series["walk_visits_sum"][0]
    mono = t_kernel.series["walk_monopoles"][0]
    walk_ms = graph_ms(lambda: tw.traverse_fused(*args, **wkw), 20)
    wb_ms, wb_by = walk_bound(nbc, G, LL, nodes, visits, mono, wp)
    print(f"kernel traverse_fused compacted nb={nbc} G={G} LL={LL} "
          f"with_potential={wp}: identical leaf lists and visit counts "
          f"({visits} visits, {mono} monopoles); acc/pot err by norm "
          f"{walk_err:.6e} (tol {WALK_TOL:g}), max abs {walk_abs:.6e}; "
          f"kernel_ms={walk_ms:.6f} (graph replays) "
          f"plain_ms={walk_plain_ms:.6f} bound_ms={wb_ms:.6f} ({wb_by})",
          flush=True)

    # K1 at the compacted shapes
    a, pkw = captured["pair"]
    acc, pot = pk.block_pair_accumulate(*a, **pkw)
    torch.cuda.synchronize()
    racc, rpot = pk.block_pair_accumulate_reference(*a, **pkw)
    torch.cuda.synchronize()
    rel = max(float((acc - racc).abs().max())
              / max(float(racc.abs().max()), 1e-30),
              float((pot - rpot).abs().max())
              / max(float(rpot.abs().max()), 1e-30))
    pair_abs = max(float((acc - racc).abs().max()),
                   float((pot - rpot).abs().max()))
    check(rel <= KERNEL_TOL, f"pair kernel disagrees with plain version "
          f"(compacted): {rel:.3e} > {KERNEL_TOL:g}")
    count = pkw["count"]
    tx, ty, tz, sx, sy, sz = a[:6]
    rcut = a[11]
    within = pairs_within(tx, ty, tz, sx, sy, sz, count, rcut)
    sources = int(count.sum())
    pair_ms = time_ms(lambda: pk.block_pair_accumulate(*a, **pkw), 20)
    pair_plain_ms = time_ms(
        lambda: pk.block_pair_accumulate_reference(*a, **pkw), 1)
    pb_ms, pb_by = pair_bound(nbc, G, sources, pkw["with_potential"],
                              within)
    print(f"kernel block_pair_accumulate compacted nb={nbc} G={G} "
          f"S={sx.shape[1]} sum(count)={sources} pairs within rcut {within}"
          f" with_potential={pkw['with_potential']}: "
          f"err/max|plain|={rel:.6e} (tol {KERNEL_TOL:g}) max_abs_err="
          f"{pair_abs:.6e} kernel_ms={pair_ms:.6f} "
          f"plain_ms={pair_plain_ms:.6f} bound_ms={pb_ms:.6f} ({pb_by})",
          flush=True)
    return dict(nb=nbc, active=nact, bit_identical=same,
                walk=dict(max_abs_err=walk_abs, rel=walk_err, ms=walk_ms,
                          plain_ms=walk_plain_ms, bound_ms=wb_ms,
                          bound_by=wb_by),
                pair=dict(max_abs_err=pair_abs, rel=rel, ms=pair_ms,
                          plain_ms=pair_plain_ms, bound_ms=pb_ms,
                          bound_by=pb_by))


# stand-ins for the absent class_pk_9.dat (examples/dm-small/
# paramfile.genic): the Eisenstein-Hu spectrum normalised by Sigma8 today
GENIC_OVERRIDE = {"WhichSpectrum": 1, "Sigma8": 0.8,
                  "InputPowerRedshift": 0}


def modecount_rebin(kk, pk, modes, minmodes=2, ndesired=20):
    """Rebin P(k) so each bin holds enough modes (the helper of
    examples/dm-small/check_results.py)."""
    import numpy as np
    logkk = np.log10(kk)
    mdlogk = (np.max(logkk) - np.min(logkk)) / ndesired
    istart = iend = 1
    count = 0
    k_list, pk_list = [kk[0]], [pk[0]]
    targetlogk = mdlogk + logkk[istart]
    while iend < np.size(logkk) - 1:
        count += modes[iend]
        iend += 1
        if count >= minmodes and logkk[iend - 1] >= targetlogk:
            pk_list.append(np.sum(modes[istart:iend]
                                  * pk[istart:iend]) / count)
            k_list.append(np.sum(modes[istart:iend]
                                 * kk[istart:iend]) / count)
            istart = iend
            targetlogk = mdlogk + logkk[istart]
            count = 0
    return np.array(k_list), np.array(pk_list)


def read_power(fn):
    """(k, P, D1) of a powerspectrum-*.txt, rebinned as check_results.py
    does."""
    import numpy as np
    data = np.loadtxt(fn)
    good = data[:, 0] > 0
    kk, pk = modecount_rebin(data[good, 0], data[good, 1], data[good, 2])
    d1 = 1.0
    with open(fn) as fh:
        for line in fh:
            if line.startswith("# D1"):
                d1 = float(line.split("=")[1].strip())
            if not line.startswith("#"):
                break
    return kk, pk, d1


def genic_phase(workdir, device="cuda", ngrid=None):
    """examples/dm-small/paramfile.genic, with GENIC_OVERRIDE written into
    a copy in workdir, through the port's CLI (python -m
    mpgadget_tpu_torch.genic.main, run in workdir: the paramfile's
    OutputDir is relative); returns a dict with the IC's path.  On the
    CPU, where the CLI refuses to run, the function it calls runs."""
    import numpy as np
    import torch
    from mpgadget_tpu_torch.cosmology import Cosmology
    from mpgadget_tpu_torch.genic.main import run_genic
    from mpgadget_tpu_torch.genic.power import PowerParams, PowerSpec
    from mpgadget_tpu_torch.io.bigfile import BigFile
    from mpgadget_tpu_torch.io import snapshot as snap_io
    from mpgadget_tpu_torch.params import create_genic_parameter_set
    from mpgadget_tpu_torch.particles import pos_to_fixed
    from mpgadget_tpu_torch.pm.gravity import PMConfig, measure_power
    from mpgadget_tpu_torch.utils import get_unitsystem
    from mpgadget_tpu_torch.utils.constants import CM_PER_MPC

    over = dict(GENIC_OVERRIDE)
    if ngrid is not None:       # a smaller rehearsal on the CPU
        over["Ngrid"] = ngrid
    with open(os.path.join(HERE, "examples", "dm-small",
                           "paramfile.genic")) as fh:
        lines = [ln for ln in fh.read().splitlines()
                 if ln.split("=")[0].strip() not in over]
    paramfile = os.path.join(workdir, "paramfile.genic")
    with open(paramfile, "w") as fh:
        fh.write("\n".join(lines + [f"{k} = {v}" for k, v in over.items()])
                 + "\n")
    ps = create_genic_parameter_set()
    ps.parse_file(paramfile)
    ng = ps["Ngrid"]
    path = os.path.join(workdir, ps["OutputDir"], ps["FileBase"])
    t0 = time.perf_counter()
    if device == "cuda":
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (HERE, os.environ.get("PYTHONPATH")) if p))
        out = subprocess.run(
            [sys.executable, "-m", "mpgadget_tpu_torch.genic.main",
             paramfile], cwd=workdir, env=env, capture_output=True,
            text=True, timeout=600)
        check(out.returncode == 0, "genic CLI failed: "
              + (out.stdout + out.stderr)[-2000:])
    else:
        cwd = os.getcwd()
        os.chdir(workdir)
        try:
            run_genic(ps, device=device)
        finally:
            os.chdir(cwd)
    seconds = time.perf_counter() - t0
    bf = BigFile(path)
    hdr = snap_io.read_header(bf)
    sp = snap_io.read_species(bf, 1, hdr)
    n = ng ** 3
    units = get_unitsystem(hdr.UnitLength_in_cm, hdr.UnitMass_in_g,
                           hdr.UnitVelocity_in_cm_per_s)
    atime = 1.0 / (1.0 + ps["Redshift"])
    cp = Cosmology(
        Omega0=ps["Omega0"], OmegaBaryon=ps["OmegaBaryon"],
        OmegaLambda=ps["OmegaLambda"], HubbleParam=ps["HubbleParam"],
        CMBTemperature=ps["CMBTemperature"],
        RadiationOn=bool(ps["RadiationOn"]),
        MNu=(ps["MNue"], ps["MNum"], ps["MNut"]),
        TimeBegin=atime).init_units(units)
    box = ps["BoxSize"]
    # the particles carry all matter but the neutrinos' share
    mass = (cp.Omega0 - cp.ONu(1.0)) * cp.RhoCrit * box ** 3 / n
    check(list(np.asarray(hdr.TotNumPart, np.int64)) == [0, n, 0, 0, 0, 0],
          f"IC header TotNumPart {hdr.TotNumPart}")
    check(abs(hdr.Time - atime) < 1e-12 and hdr.BoxSize == box
          and hdr.Omega0 == ps["Omega0"] and hdr.HubbleParam == 0.7,
          "IC header Time/BoxSize/cosmology")
    check(abs(hdr.MassTable[1] / mass - 1) < 1e-12
          and np.allclose(sp["mass"], mass, rtol=1e-6, atol=0),
          f"IC masses {hdr.MassTable[1]} vs {mass}")
    check(np.array_equal(np.sort(sp["pid"]), np.arange(1, n + 1)),
          "IC IDs are not 1..N")
    check(np.isfinite(sp["pos"]).all() and np.isfinite(sp["vel"]).all()
          and ((sp["pos"] >= 0) & (sp["pos"] < box)).all(),
          "IC positions/velocities")
    vrms = float(np.sqrt(np.mean(np.sum(sp["vel"] ** 2, axis=1))))
    check(vrms > 0, "IC has no velocities")

    ipos = torch.as_tensor(pos_to_fixed(sp["pos"], box).astype(np.int64),
                           device=device)
    weights = torch.as_tensor(sp["mass"], dtype=torch.float32,
                              device=device)
    pm_nmesh = 2 * ng
    power = measure_power(ipos, weights, PMConfig(
        nmesh=pm_nmesh, boxsize=box, unitlength_in_cm=hdr.UnitLength_in_cm))
    kk, pk = modecount_rebin(power.k, power.power, power.nmodes)
    lin = PowerSpec(PowerParams(WhichSpectrum=1,
                                PrimordialIndex=ps["PrimordialIndex"]),
                    cp, atime, units.UnitLength_in_cm)
    scale = units.UnitLength_in_cm / CM_PER_MPC   # h/Mpc -> internal
    nbins = min(6, len(kk))
    pk_lin = lin.delta_spec(kk[:nbins] * scale) ** 2
    ratio = pk[:nbins] / pk_lin
    shape_err = float(np.max(np.abs(ratio / np.mean(ratio) - 1)))
    print(f"genic dm-small (Ngrid {ng}, Nmesh {ps['Nmesh'] or 2 * ng}, "
          f"Seed {ps['Seed']}, z={ps['Redshift']:g}, EH spectrum): "
          f"{seconds:.6f} s on {device} ("
          f"{'the CLI process' if device == 'cuda' else 'run_genic'}); "
          f"{n} particles, mass "
          f"{hdr.MassTable[1]:.9g}, rms velocity {vrms:.6g}; IC P(k) at "
          f"Nmesh {pm_nmesh}, {nbins} lowest-k bins k={kk[:nbins].tolist()} "
          f"P/P_lin={ratio.tolist()}: largest deviation from their mean "
          f"{shape_err:.6f} (rtol 0.1)", flush=True)
    check(shape_err <= 0.1, f"IC P(k) shape differs from the linear "
          f"spectrum by {shape_err:.3f} > 0.1")
    return dict(path=path, seconds=seconds, shape_err=shape_err,
                npart=n)


def pig_check(path, min_length):
    """Read a PIG back through the port's bigfile and hold it to its own
    schema: NumFOFGroupsTotal rows of FOFGroups, every LengthByType row
    at least min_length, NumPartInGroupTotal rows of grouped particles
    per type whose GroupIDs are sorted.  Returns (groups,
    halo count per log10 mass bin in Msun as {bin start: count}, the
    largest mass in Msun or 0)."""
    import numpy as np
    from mpgadget_tpu_torch.io.bigfile import BigFile
    bf = BigFile(path)
    attrs = bf.open("Header").attrs
    ng = int(np.asarray(attrs["NumFOFGroupsTotal"]).reshape(-1)[0])
    npart = np.asarray(attrs["NumPartInGroupTotal"]).astype(np.int64)
    mass = bf.open("FOFGroups/Mass").read()
    lbt = np.asarray(bf.open("FOFGroups/LengthByType").read(),
                     np.int64).reshape(-1, 6)
    name = os.path.basename(path)
    check(len(mass) == ng and lbt.shape[0] == ng
          and len(bf.open("FOFGroups/GroupID").read()) == ng,
          f"{name}: NumFOFGroupsTotal {ng} against {len(mass)} rows")
    check(bool((lbt.sum(axis=1) >= min_length).all()),
          f"{name}: a group shorter than {min_length}")
    check(int(npart.sum()) == int(lbt.sum()),
          f"{name}: NumPartInGroupTotal {npart} against LengthByType")
    for t in np.nonzero(npart)[0]:
        gid = bf.open(f"{t}/GroupID").read().astype(np.int64)
        check(len(gid) == npart[t]
              and len(bf.open(f"{t}/Position").read()) == npart[t],
              f"{name}: type {t} rows against NumPartInGroupTotal")
        check(bool((np.diff(gid) >= 0).all()) and gid[0] >= 1
              and gid[-1] <= ng, f"{name}: GroupIDs not sorted in 1..{ng}")
    hh = float(np.asarray(attrs["HubbleParam"]).reshape(-1)[0])
    msun = mass.astype(np.float64) * 1e10 / hh
    lg = np.floor(np.log10(msun)).astype(int)
    bins = {int(b): int((lg == b).sum()) for b in np.unique(lg)}
    return ng, bins, float(msun.max()) if ng else 0.0


def hier_phase(workdir, device="cuda", max_steps=HIER_STEPS, nmesh=None):
    """examples/dm-small/paramfile.gadget as it ships (hierarchical
    timebins, SnapshotWithFOF 1: a PIG beside every output) from the
    genic IC in workdir; every kernel's LAUNCHES is reset just before the
    run and read just after the snapshot.  Returns its measurements and
    the simulation (the FOF phase takes its final state)."""
    import numpy as np
    import torch
    from mpgadget_tpu_torch.gravity import pairkernel as pk
    from mpgadget_tpu_torch.gravity import treewalk as tw
    from mpgadget_tpu_torch.gravity.treepm import StageTimer
    from mpgadget_tpu_torch.io.bigfile import BigFile
    from mpgadget_tpu_torch.io import snapshot as snap_io
    from mpgadget_tpu_torch.main import build_simulation
    from mpgadget_tpu_torch.ops import pairs

    override = {}
    if nmesh is not None:       # a smaller rehearsal on the CPU
        override["Nmesh"] = nmesh
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        sim, _ = build_simulation(
            os.path.join(HERE, "examples", "dm-small", "paramfile.gadget"),
            override=override, device=device)
        check(sim.cfg.split_gravity_timesteps and sim.cfg.snapshot_with_fof,
              "paramfile.gadget no longer sets SplitGravityTimestepsOn and "
              "SnapshotWithFOF")
        out = os.path.abspath(sim.cfg.output_dir)
        npart = sim.pdata.num_valid
        sim.tree_timer = StageTimer()
        step_seconds = []
        run_step = sim.step_hierarchical

        def timed_step(dti):
            if device == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            n_sub = run_step(dti)
            if device == "cuda":
                torch.cuda.synchronize()
            step_seconds.append(time.perf_counter() - t0)
            return n_sub

        sim.step_hierarchical = timed_step
        pk.LAUNCHES = 0
        tw.LAUNCHES = 0
        pairs.LAUNCHES = 0
        t0 = time.perf_counter()
        nsteps = sim.run(max_steps=max_steps, verbose=True)
        snap = os.path.abspath(sim.write_snapshot())
        run_seconds = time.perf_counter() - t0
        launches = {"pair": pk.LAUNCHES, "walk": tw.LAUNCHES,
                    "neighbors": pairs.LAUNCHES}
    finally:
        os.chdir(cwd)

    check(nsteps == max_steps or sim.ti_current == sim.timeline.ti_end,
          f"ran {nsteps} PM steps to a={sim.atime}")
    check(len(sim.step_log) == nsteps, "a PM step was not hierarchical")
    for i, (log, sec) in enumerate(zip(sim.step_log, step_seconds)):
        hist = {b: c for b, c in enumerate(log["bins"]) if c}
        print(f"hierarchical PM step {i + 1}: {sec:.6f} s, "
              f"{log['n_sub']} substeps, bins {hist}, active targets per "
              f"evaluation {log['actives']}", flush=True)
    check(any(sum(1 for c in log["bins"] if c) > 1 for log in sim.step_log)
          and max(log["n_sub"] for log in sim.step_log) > 1,
          "no sub-cycling: every particle in one bin")
    calls = sim.tree_force_calls
    pigs = sorted(f for f in os.listdir(out) if f.startswith("PIG_"))
    # one PIG beside every snapshot of the run (not the smoke's own last)
    check(len(pigs) == sim.snapshot_count - 1 >= 1,
          f"PIG catalogues written: {pigs}")
    if device == "cuda":
        for name in ("pair", "walk"):
            check(launches[name] >= calls, f"{name} kernel launched "
                  f"{launches[name]} times for {calls} tree-force "
                  "evaluations")
        check(launches["neighbors"] >= len(pigs), f"neighbour kernel "
              f"launched {launches['neighbors']} times for {len(pigs)} FOF")
    pd = sim.pdata
    valid = pd.valid
    check(int(valid.sum()) == npart, "particles lost")
    check(bool(torch.isfinite(pd.vel[valid]).all()
               & torch.isfinite(pd.grav_accel[valid]).all()
               & torch.isfinite(pd.grav_pm[valid]).all()),
          "state not finite")
    check(float(pd.grav_accel[valid].abs().max()) > 0, "tree force is zero")
    bf = BigFile(snap)
    hdr = snap_io.read_header(bf)
    sp = snap_io.read_species(bf, 1, hdr)
    check(int(hdr.TotNumPart[1]) == npart and len(sp["pid"]) == npart
          and np.isfinite(sp["pos"]).all() and np.isfinite(sp["vel"]).all(),
          "hierarchical snapshot does not read back")
    files = sorted(f for f in os.listdir(out)
                   if f.startswith("powerspectrum-"))
    check(len(files) >= 2, f"power spectra written: {files}")
    kk, pk0, d0 = read_power(os.path.join(out, files[0]))
    kk1, pk1, d1 = read_power(os.path.join(out, files[-1]))
    nbins = min(6, len(kk))
    growth = np.interp(kk[:nbins], kk1, pk1) / pk0[:nbins]
    want = (d1 / d0) ** 2
    growth_err = float(np.max(np.abs(growth / want - 1)))
    print(f"P(k) growth {files[0]} -> {files[-1]} over {nbins} lowest-k "
          f"bins: {growth.tolist()} against D1^2 ratio {want:.6f}, largest "
          f"deviation {growth_err:.6f} (rtol 0.18)", flush=True)
    check(growth_err <= 0.18, f"P(k) growth off D1^2 by {growth_err:.3f}")
    pig_groups = {}
    for name in pigs:
        ng, bins, last = pig_check(os.path.join(out, name),
                                      sim.cfg.fof_min_group_length)
        pig_groups[name] = ng
        print(f"{name}: read back and consistent; {ng} groups; halos per "
              f"log10(M/Msun) bin {bins}; largest {last:.6e} Msun",
              flush=True)
    check(ng > 0, f"{pigs[-1]} holds no halo (check_hmf asks for one)")
    print(f"check_hmf (examples/dm-small/check_results.py:104-115): "
          f"largest halo of {pigs[-1]} {last:.6e} Msun against "
          f"{HMF_MSUN:g}: {'met' if last > HMF_MSUN else 'NOT met'} (not "
          f"enforced: the spectrum is the Eisenstein-Hu stand-in and the "
          f"realisation the port's own)", flush=True)
    return dict(nsteps=nsteps, atime=sim.atime, launches=launches,
                tree_force_calls=calls, force_evals=sim.force_evals,
                step_seconds=step_seconds, run_seconds=run_seconds,
                step_log=sim.step_log, stages=dict(sim.tree_timer.seconds),
                series=dict(sim.tree_timer.series),
                walltime=dict(sim.walltime.totals), retries=sim.tree_retries,
                leaf_list_max=sim._tree_grav.walk_cfg.leaf_list_max,
                group=sim._tree_grav.tree_cfg.group_max,
                growth_err=growth_err, npart=npart,
                snapshot=os.path.basename(snap), powerspectra=len(files),
                pig_groups=pig_groups, largest_msun=last, sim=sim,
                snapnum=int(os.path.basename(snap).split("_")[-1]))


SHARDED_CONFIGS = (
    # (name, ranks, environment): one NCCL rank forced onto the sharded
    # driver, and two gloo ranks on the one card (the only way one card
    # runs exchanges and ghost strips that are not empty)
    ("nccl_1rank", 1, {"MPG_SHARDED": "1"}),
    ("gloo_2ranks", 2, {"MPG_DIST_BACKEND": "gloo"}),
)
SHARDED_TIMEOUT = 300     # seconds for each configuration's ranks
SHARDED_PK_RTOL = 3e-3    # the last snapshot's P(k) against phase 10's, on
                          # the bins below k_Nyquist/4; measured 3.2e-4 in
                          # both configurations (the sharded run keeps the
                          # box unshifted, as the JAX package's sharded
                          # run does, while phase 10 shifts it every PM
                          # step: their force errors differ)
MASS_RTOL = 1e-6


def sharded_rank(argv):
    """One rank of phases 27-30 (launch_ranks starts it with the
    environment torch.distributed.run would give it): argv
    = [paramfile, json prefix, device ("cuda"; "cpu" for a rehearsal),
    options...], and after each "--next" another run's [paramfile, json
    prefix, device, options...] in the same process group; options:
    "gas", "star", "restart=<snapshot number>" (RestartFlag 2 from that
    snapshot of OutputDir, as main.run_cli resumes), "max_steps=<n>".
    Joins the process group (main.init_distributed) and, for each run,
    builds the simulation on its card, takes the first forces, sets every
    kernel's count to 0, runs the sharded driver with its collectives and
    layers timed (and, with "star" on the card, the subgrid passes' K3 and
    pair_reduce card time by caller), and writes <prefix>_r<rank>.json.
    With "gas" (phase 28) the json also holds the gas's means, the stars,
    the rows this rank held and the stars it formed, and the distributed
    FOF of the final rows with gas and stars attached as secondaries
    beside the single-device catalogue of the same rows (rank 0); with
    "star" (phase 29) the gas's means, the stars, BHs and their accretion
    rates, the rows this rank held, and the wind kicks, swallowed gas,
    mergers and seeded BHs over all ranks; with "nu", "hybrid" and
    "reion" (phase 30) the entries of the delta_tot history, each PM
    refresh's largest type-2 PM acceleration on this rank
    (option_spies), and the reionization counts with the distances of the
    rows each bubble ionized on this rank (reion_rank_summary)."""
    sys.path.insert(0, HERE)
    import torch
    from mpgadget_tpu_torch.gravity import pairkernel as pk
    from mpgadget_tpu_torch.gravity import treewalk as tw
    from mpgadget_tpu_torch.main import (build_simulation, init_distributed,
                                         device_mesh_or_none)
    from mpgadget_tpu_torch.ops import pairs
    from mpgadget_tpu_torch.parallel import collectives as coll
    from mpgadget_tpu_torch.physics import cooling
    from mpgadget_tpu_torch.sph import density, hydra
    mods = {"pair": pk, "walk": tw, "neighbors": pairs, "density": density,
            "hydro": hydra, "cooling": cooling}
    device = argv[2]
    runs, cur = [], []
    for a in argv:             # runs separated by "--next"
        if a == "--next":
            runs.append(cur)
            cur = []
        else:
            cur.append(a)
    runs.append(cur)
    dev = init_distributed(device)
    check(dev.type == device, f"rank device {dev}")
    sync = torch.cuda.synchronize if device == "cuda" else (lambda d: None)
    try:
        for run in runs:
            t_run = time.perf_counter()
            paramfile, prefix = run[:2]
            opts = dict(o.partition("=")[::2] for o in run[3:])
            snapshot = None
            if "restart" in opts:
                from mpgadget_tpu_torch.params import \
                    create_gadget_parameter_set
                ps = create_gadget_parameter_set()
                ps.parse_file(paramfile)
                snapnum = int(opts["restart"])
                snapshot = os.path.join(
                    ps["OutputDir"], f"{ps['SnapshotFileBase']}_"
                    f"{snapnum:03d}")
            sim, _ = build_simulation(paramfile, snapshot=snapshot,
                                      device=dev)
            if snapshot is not None:
                sim.snapshot_count = snapnum + 1
            mesh = device_mesh_or_none(dev)
            check(mesh is not None, "the sharded driver was not selected")
            check(sim.pdata.ipos.device.type == device,
                  f"the state is on {sim.pdata.ipos.device}")
            sim.compute_forces(measure_power=False)
            coll.TIMED = True
            coll.reset_stats()
            for m in mods.values():
                m.LAUNCHES = 0
            if "star" in opts:
                subgrid_spans(device)
            spies = option_spies(opts)
            sync(dev)
            t0 = time.perf_counter()
            try:
                nsteps = sim.run_sharded(mesh, hierarchical=bool(
                    sim.cfg.split_gravity_timesteps and sim.cfg.tree_grav_on),
                    layer_sync=True, max_steps=int(opts.get("max_steps")
                                                   or 0) or None)
                sync(dev)
            finally:
                spied = spies.close()
            seconds = time.perf_counter() - t0
            res = dict(rank=mesh.rank, size=mesh.size,
                       backend=mesh.backend, device=str(dev), nsteps=nsteps,
                       atime=sim.atime, seconds=seconds,
                       launches={k: m.LAUNCHES for k, m in mods.items()},
                       log=sim.sharded_log, fofs=sim.sharded_fofs,
                       walltime=dict(sim.walltime.totals),
                       collectives=dict(coll.STATS),
                       state_on=str(sim.pdata.ipos.device))
            if "gas" in opts:
                res.update(gas_rank_summary(sim, mesh))
            if "star" in opts:
                res.update(star_rank_summary(sim))
                res["spans"] = {c: {k: list(v) for k, v in d.items()}
                                for c, d in read_spans(device).items()}
            res.update(spied)
            if "nu" in opts:
                res["nu_entries"] = len(sim._nu_table_state.scalefact)
            if "reion" in opts:
                res.update(reion_rank_summary(sim))
            # the run's seconds in this process, its set-up included
            res["run_wall"] = time.perf_counter() - t_run
            with open(f"{prefix}_r{mesh.rank}.json", "w") as fh:
                json.dump(res, fh)
    finally:
        coll.destroy_process_group()
    return 0


class option_spies:
    """Phase 30's per-rank spies for one run: with "hybrid" every PM
    refresh's a, whether the type-2 rows were passive tracers and their
    largest |PM acceleration| on this rank (parallel.driver.pm_refresh);
    with "reion" per bubble the largest distance over radius of the rows
    it ionized on this rank and their number
    (physics.qso_lightup._ionize_bubble).  close() undoes them and returns
    what they saw."""

    def __init__(self, opts):
        from mpgadget_tpu_torch.parallel import driver
        from mpgadget_tpu_torch.physics import qso_lightup
        self.undo, self.seen = [], {}
        if "hybrid" in opts:
            real = driver.pm_refresh
            tracer = self.seen.setdefault("tracer_pm", [])

            def refresh(st, mesh, scal, **kw):
                upd, stats = real(st, mesh, scal, **kw)
                t2 = st["ptype"] == 2
                tracer.append((float(scal["atime"]),
                               bool(scal.get("nu_tracer")),
                               float(upd["pm_acc"][t2].abs().max())
                               if bool(t2.any()) else 0.0))
                return upd, stats
            driver.pm_refresh = refresh
            self.undo.append(lambda: setattr(driver, "pm_refresh", real))
        if "reion" in opts:
            import numpy as np
            real_b = qso_lightup._ionize_bubble
            bubbles = self.seen.setdefault("bubbles", [])

            def ionize(ipos, is_gas, ionized, *a):
                out = real_b(ipos, is_gas, ionized, *a)
                center, radius = a[2], a[3]
                new = (out[0] & ~ionized).cpu().numpy()
                d = ipos.cpu().numpy()[new] / 2.0 ** 32 \
                    - center.cpu().numpy().astype(np.float64)
                d -= np.round(d)
                r = np.sqrt((d ** 2).sum(1))
                bubbles.append((float(r.max() / radius) if r.size else 0.0,
                                int(r.size)))
                return out
            qso_lightup._ionize_bubble = ionize
            self.undo.append(lambda: setattr(qso_lightup, "_ionize_bubble",
                                             real_b))

    def close(self):
        for u in self.undo:
            u()
        self.undo = []
        return self.seen


def reion_rank_summary(sim):
    """Phase 30 (4)'s part of a rank's json: the final state's gas rows
    with J21 > 0, with zreion set, HeIII-ionized and with metallicity > 0,
    and the gas (the host mirror, the same on every rank), the excursion
    set's updates, the bubbles placed and the total mass."""
    import torch
    gas, sph = sim.gas_mask, sim.sph
    n = torch.stack([(gas & (sph.local_j21 > 0)).sum(),
                     (gas & (sph.zreion >= 0)).sum(),
                     (gas & (sph.local_j21 > 0) & (sph.zreion < 0)).sum(),
                     (gas & (sph.he_iii_ionized > 0)).sum(),
                     (gas & (sph.metallicity > 0)).sum(),
                     gas.sum()]).cpu().tolist()
    return dict(zip(("n_j21", "n_zre", "n_j21_no_zre", "n_heiii", "n_metal",
                     "ngas"), n),
                uvbg_updates=[list(u) for u in sim.uvbg_updates],
                qso_bubbles=sum(b for _, b in sim.qso_bubbles),
                mass=total_mass(sim))


def gas_rank_summary(sim, mesh):
    """Phase 28's part of a rank's json: the final state's gas means and
    stars (the host mirror, the same on every rank), the rows by type this
    rank held at the end and the stars it formed, and, on more than one
    rank, the distributed FOF of the final rows (re-sharded and exchanged
    to count-balanced slabs; gas and stars attached as secondaries) with,
    on rank 0, the single-device catalogue (run_fof) of the same rows."""
    import numpy as np
    import torch
    from mpgadget_tpu_torch.parallel.decomp import (balanced_boundaries,
                                                    count_histogram,
                                                    exchange_to_slabs)
    from mpgadget_tpu_torch.parallel.fof import sharded_fof
    from mpgadget_tpu_torch.parallel.mesh import (default_n_local,
                                                  shard_particles)
    from mpgadget_tpu_torch.physics.fof import FOFParams
    pd, sph = sim.pdata, sim.sph
    gas = sim.gas_mask
    out = dict(
        gas_mean_density=float(sph.density[gas].double().mean()),
        gas_mean_entropy=float(sph.entropy[gas].double().mean()),
        nstars=int((pd.valid & (pd.ptype == 4)).sum()),
        rows_by_type=sim.sharded_rows, formed_here=sim.sharded_formed)
    if mesh.size == 1:      # phase 28 compares (b)'s catalogue
        return out
    cols = {"ipos": pd.ipos, "vel": pd.vel, "mass": pd.mass,
            "ptype": pd.ptype, "sfr": sph.sfr}
    st = shard_particles(cols, pd.valid.cpu(), mesh,
                         default_n_local(pd.capacity, mesh.size))
    bounds = balanced_boundaries(
        count_histogram(st["ipos"], mesh).cpu().numpy(), mesh.size)
    st, _ = exchange_to_slabs(st, st["ipos"], mesh, bounds)
    npart = int((pd.valid & (pd.ptype == 1)).sum())
    sim.cfg.fof_min_group_length = LYA_FOF_MIN_LENGTH
    params = FOFParams(linking_length=sim.cfg.fof_linking_length,
                       min_group_length=sim.cfg.fof_min_group_length,
                       primary_link_types=sim.cfg.fof_primary_link_types,
                       secondary_link_types=sim.cfg.fof_secondary_link_types)
    t0 = time.perf_counter()
    cat, _, _ = sharded_fof(mesh, st, bounds, boxsize=sim.cfg.boxsize,
                            mean_sep=sim.cfg.boxsize / np.cbrt(npart),
                            params=params)
    out["fof"] = dict(seconds=time.perf_counter() - t0,
                      ngroups=cat["ngroups"],
                      len_by_type=cat["len_by_type"].tolist(),
                      mass_by_type=cat["mass_by_type"].tolist())
    if mesh.rank == 0:
        one = sim.run_fof(save=False)
        out["fof_single"] = dict(
            ngroups=int(one["ngroups"]),
            len_by_type=np.asarray(one["len_by_type"]).tolist(),
            mass_by_type=np.asarray(one["mass_by_type"]).tolist())
    return out


def star_rank_summary(sim):
    """Phase 29's part of a rank's json: the final state's gas means, stars,
    BHs (the host mirror, the same on every rank) and the BHs' accretion
    rates, the rows by type this rank held at the end, and the subgrid
    counters (over all ranks)."""
    pd, sph = sim.pdata, sim.sph
    gas = sim.gas_mask
    bh = pd.valid & (pd.ptype == 5)
    return dict(
        gas_mean_density=float(sph.density[gas].double().mean()),
        gas_mean_entropy=float(sph.entropy[gas].double().mean()),
        gas_metal_rows=int((gas & (sph.metallicity > 0)).sum()),
        nstars=int((pd.valid & (pd.ptype == 4)).sum()), nbh=int(bh.sum()),
        bh_mdot=sim.bh.mdot[bh].tolist(),
        bh_formed=sim.bh.formation_time[bh].tolist(),
        rows_by_type=sim.sharded_rows, formed_here=sim.sharded_formed,
        wind_kicks=sim.wind_kicks, swallowed=sim.bh_swallowed,
        mergers=sim.bh_mergers, seeded=list(sim.bh_seeded),
        mass=total_mass(sim))


def snapshot_power(path, device, nmesh=NMESH, ptype=1):
    """P(k) of a snapshot's type-1 rows (pm.gravity.measure_power at
    nmesh): (k, P, modes) and k_Nyquist, in h/Mpc."""
    import numpy as np
    import torch
    from mpgadget_tpu_torch.io.bigfile import BigFile
    from mpgadget_tpu_torch.io import snapshot as snap_io
    from mpgadget_tpu_torch.particles import pos_to_fixed
    from mpgadget_tpu_torch.pm.gravity import PMConfig, measure_power
    bf = BigFile(path)
    hdr = snap_io.read_header(bf)
    ipos = torch.as_tensor(pos_to_fixed(bf.open(f"{ptype}/Position").read(),
                                        hdr.BoxSize).astype(np.int64),
                           device=device)
    mass = torch.as_tensor(bf.open(f"{ptype}/Mass").read(), device=device)
    ps = measure_power(ipos, mass, PMConfig(
        nmesh=nmesh, boxsize=hdr.BoxSize,
        unitlength_in_cm=hdr.UnitLength_in_cm))
    box_mpc = hdr.BoxSize * hdr.UnitLength_in_cm / 3.085678e24
    return ps.k, ps.power, ps.nmodes, np.pi * nmesh / box_mpc


def launch_ranks(what, nranks, env_over, argv, workdir, timeout, device,
                 kernels=None):
    """nranks processes of this script (--sharded-rank argv..., one or more
    runs separated by "--next"), each started directly with the
    environment torch.distributed.run gives a rank (RANK, LOCAL_RANK,
    WORLD_SIZE, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT; no launcher
    process), env_over set over the environment (MPG_SHARDED,
    MPG_DIST_BACKEND taken from it alone), under a time limit: a rank that
    fails ends the others.  Every rank of every run checked on the device
    and, on the card, each of its kernels launched: kernels names them
    (None: all it counts), one tuple for every run or a list of one entry
    a run.  Returns (for each run the ranks' json, the processes' wall
    seconds)."""
    import socket
    env = dict(os.environ, **env_over)
    for k in ("MPG_SHARDED", "MPG_DIST_BACKEND"):
        if k not in env_over:
            env.pop(k, None)
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    cmd = [sys.executable, os.path.join(HERE, "chip_smoke.py"),
           "--sharded-rank"] + argv
    procs, logs = [], []
    t0 = time.perf_counter()
    for r in range(nranks):
        renv = dict(env, RANK=str(r), LOCAL_RANK=str(r),
                    WORLD_SIZE=str(nranks), LOCAL_WORLD_SIZE=str(nranks),
                    MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        log = open(os.path.join(workdir, f"rank{r}_port{port}.log"), "w+")
        logs.append(log)
        procs.append(subprocess.Popen(cmd, cwd=workdir, env=renv,
                                      stdout=log, stderr=subprocess.STDOUT))
    failed = None
    try:
        while failed is None:
            codes = [pr.poll() for pr in procs]
            if any(c not in (None, 0) for c in codes):
                failed = f"a rank failed (exit codes {codes})"
            elif all(c == 0 for c in codes):
                break
            elif time.perf_counter() - t0 > timeout:
                failed = f"over {timeout} s"
            else:
                time.sleep(0.2)
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
            pr.wait()
    texts = []
    for log in logs:
        log.seek(0)
        texts.append(log.read())
        log.close()
    wall = time.perf_counter() - t0
    check(failed is None, f"{what}: {failed}: " + "\n".join(
        f"rank {r}: ...{t[-3000:]}" for r, t in enumerate(texts)))
    head = [ln for ln in texts[0].splitlines() if "[distributed]" in ln]
    print(f"{what}: {head[0] if head else 'no backend line'}", flush=True)
    prefixes = [argv[1]] + [argv[i + 2] for i, a in enumerate(argv)
                            if a == "--next"]
    if kernels is None or isinstance(kernels[0], str):
        kernels = [kernels] * len(prefixes)
    runs = []
    for prefix, kern in zip(prefixes, kernels):
        ranks = []
        for r in range(nranks):
            with open(f"{prefix}_r{r}.json") as fh:
                ranks.append(json.load(fh))
        for rk in ranks:
            check(rk["device"].startswith(device)
                  and rk["state_on"].startswith(device),
                  f"{what} rank {rk['rank']} on {rk['device']}")
            check(rk["size"] == nranks, f"{what}: {rk['size']} ranks")
            if device == "cuda":
                for kname in kern or rk["launches"]:
                    check(rk["launches"][kname] > 0, f"{what} rank "
                          f"{rk['rank']}: {kname} kernel never launched")
        runs.append(ranks)
    return runs, wall


class Launch:
    """One configuration's launch that a sharded phase asks for (the
    phases below are generators that yield these and receive (for each
    run the ranks' json, the processes' wall seconds)): runs, each the
    argv [paramfile, json prefix, device, options...] of one run, and
    kernels, one entry a run (see launch_ranks)."""

    def __init__(self, what, nranks, env_over, runs, timeout, kernels):
        self.what, self.nranks, self.env_over = what, nranks, env_over
        self.runs, self.timeout, self.kernels = runs, timeout, kernels

    def argv(self):
        out = []
        for run in self.runs:
            out += (["--next"] if out else []) + list(run)
        return out


def drive(gen, workdir, device):
    """A sharded phase (a generator of Launch) run alone: each launch as
    it asks.  Returns the phase's result."""
    try:
        req = next(gen)
        while True:
            req = gen.send(launch_ranks(
                req.what, req.nranks, req.env_over, req.argv(), workdir,
                req.timeout, device, req.kernels))
    except StopIteration as e:
        return e.value


def drive_merged(phases, workdir, device, what="sharded phases"):
    """Sharded phases (label -> generator of Launch, each asking for the
    same configurations in the same order) with each configuration's runs
    of every phase in one launch, one after the other: one process start
    a configuration for all of them.  Returns (label -> result, label ->
    seconds: its runs' seconds on rank 0 and its own checks, the
    launches' seconds outside every run)."""
    results, seconds, reqs = {}, {}, {}

    def resume(label, gen, value):
        t0 = time.perf_counter()
        try:
            reqs[label] = next(gen) if value is None else gen.send(value)
        except StopIteration as e:
            results[label] = e.value
            reqs.pop(label, None)
        seconds[label] = seconds.get(label, 0.0) + time.perf_counter() - t0

    gens = dict(phases)
    for label, gen in gens.items():
        resume(label, gen, None)
    outside = 0.0
    while reqs:
        labels = list(reqs)
        first = reqs[labels[0]]
        check(all(reqs[lb].nranks == first.nranks
                  and reqs[lb].env_over == first.env_over for lb in labels),
              f"{what}: the phases ask for different configurations")
        runs, kernels = [], []
        for lb in labels:
            runs += reqs[lb].runs
            kernels += reqs[lb].kernels
        merged = Launch(f"{what} ({first.what})", first.nranks,
                        first.env_over, runs,
                        sum(reqs[lb].timeout for lb in labels), kernels)
        got, wall = launch_ranks(merged.what, merged.nranks, merged.env_over,
                                 merged.argv(), workdir, merged.timeout,
                                 device, merged.kernels)
        inside = 0.0
        for lb in labels:
            mine, got = got[:len(reqs[lb].runs)], got[len(reqs[lb].runs):]
            t_runs = sum(ranks[0]["run_wall"] for ranks in mine)
            inside += t_runs
            seconds[lb] = seconds.get(lb, 0.0) + t_runs
            resume(lb, gens[lb], (mine, wall))
        outside += wall - inside
    return results, seconds, outside


def sharded_phase(workdir, hres, device="cuda", configs=SHARDED_CONFIGS,
                  nmesh=None):
    """Phase 27: dm-small as it ships through the sharded driver (see the
    module's docstring), a generator of each configuration's Launch, its
    ranks in a process group of their own.  device "cpu" and a smaller
    nmesh rehearse it on the CPU (every rank on gloo)."""
    import numpy as np
    from mpgadget_tpu_torch.io.bigfile import BigFile
    from mpgadget_tpu_torch.io import snapshot as snap_io
    nmesh = nmesh or NMESH
    ic = os.path.join(workdir, "IC", "IC")      # phase 9's genic output
    ref_snap = os.path.join(workdir, "output", hres["snapshot"])
    k0, p0, n0, knyq = snapshot_power(ref_snap, device, nmesh)
    icb = BigFile(ic)
    sp = snap_io.read_species(icb, 1, snap_io.read_header(icb))
    ic_ids = np.sort(sp["pid"])
    ic_mass = float(sp["mass"].astype(np.float64).sum())
    text = open(os.path.join(HERE, "examples", "dm-small",
                             "paramfile.gadget")).read()
    text = text.replace("Nmesh = 128", f"Nmesh = {nmesh}")
    results = {}
    for name, nranks, env_over in configs:
        out = os.path.join(workdir, f"sharded_{name}")
        pf = os.path.join(workdir, f"paramfile_{name}.gadget")
        with open(pf, "w") as fh:
            fh.write(text.replace("InitCondFile = IC/IC",
                                  f"InitCondFile = {ic}")
                     .replace("OutputDir = output", f"OutputDir = {out}"))
        prefix = os.path.join(workdir, f"sharded_{name}")
        [ranks], wall = yield Launch(
            f"sharded {name}", nranks, env_over, [[pf, prefix, device]],
            SHARDED_TIMEOUT, [("pair", "walk", "neighbors")])
        r0 = ranks[0]
        check(abs(r0["atime"] - 0.25) < 1e-9, f"sharded {name} stopped at "
              f"a={r0['atime']}")
        snaps = sorted(f for f in os.listdir(out) if f.startswith("PART_"))
        pigs = sorted(f for f in os.listdir(out) if f.startswith("PIG_"))
        check(len(snaps) == 3 and len(pigs) == 3,
              f"sharded {name}: snapshots {snaps}, PIGs {pigs}")
        for sn in snaps:
            bf = BigFile(os.path.join(out, sn))
            ids = bf.open("1/ID").read()
            check(np.array_equal(np.sort(ids), ic_ids),
                  f"sharded {name} {sn}: IDs not each once")
            m = float(bf.open("1/Mass").read().astype(np.float64).sum())
            check(abs(m / ic_mass - 1) <= MASS_RTOL,
                  f"sharded {name} {sn}: mass {m} against the IC's {ic_mass}")
            check(bf.open("1/ID").Nfile == nranks,
                  f"sharded {name} {sn}: not one stripe a rank")
        groups = {}
        for pg in pigs:
            ng, bins, last = pig_check(os.path.join(out, pg), 32)
            groups[pg] = ng
        check(groups[pigs[-1]] > 0, f"sharded {name}: no halo at a = 0.25")
        k1, p1, n1, _ = snapshot_power(os.path.join(out, snaps[-1]), device,
                                       nmesh)
        check(np.array_equal(n1, n0), f"sharded {name}: P(k) mode counts")
        low = k0 < knyq / 4
        dev_pk = float(np.max(np.abs(p1[low] / p0[low] - 1)))
        print(f"sharded {name}: {snaps[-1]} P(k) against phase 10's "
              f"{hres['snapshot']} on {int(low.sum())} bins below "
              f"k_Nyquist/4 = {knyq / 4:.6f} h/Mpc: largest relative "
              f"difference {dev_pk:.6e} (tolerance {SHARDED_PK_RTOL}); all "
              f"bins {float(np.max(np.abs(p1 / p0 - 1))):.6e}", flush=True)
        check(dev_pk <= SHARDED_PK_RTOL, f"sharded {name}: P(k) off phase "
              f"10's by {dev_pk:.3e}")
        results[name] = dict(ranks=ranks, wall=wall, pk_dev=dev_pk,
                             groups=groups, snapshots=snaps)
    return results


def report_sharded(shd, card, what=f"dm-small 64^3 Nmesh {NMESH}"):
    """Phase 27's and 28's lines: per configuration the PM steps,
    substeps, seconds of steps, collective seconds and bytes per PM step,
    rank 0's walltime by layer."""
    for name, r in shd.items():
        r0 = r["ranks"][0]
        log = r0["log"]
        steps = sum(e["seconds"] for e in log)
        print(f"sharded {name} {what} on {card}: "
              f"{r0['nsteps']} PM steps to a={r0['atime']:.6f}, substeps "
              f"{[e['substeps'] for e in log]} ({sum(e['substeps'] for e in log)}"
              f" in all), {steps:.6f} s of steps, run_sharded "
              f"{r0['seconds']:.6f} s, the ranks' processes "
              f"{r['wall']:.3f} s; groups per PIG {r.get('groups')}; FOF "
              f"rounds {[f['rounds'] for f in r0['fofs']]}", flush=True)
        for rk in r["ranks"]:
            lg = rk["log"]
            cs = [e["coll_seconds"] for e in lg]
            cb = [e["coll_bytes"] for e in lg]
            print(f"  rank {rk['rank']} ({rk['backend']}, {rk['device']}): "
                  f"collective seconds per PM step {[round(x, 6) for x in cs]}"
                  f" ({sum(cs):.6f} of {sum(e['seconds'] for e in lg):.6f} s"
                  f" of steps), bytes sent per PM step {cb}; all "
                  f"collectives {rk['collectives']}; launches "
                  f"{rk['launches']}", flush=True)
        print(f"  rank 0 walltime by layer: " + ", ".join(
            f"{k} {v:.6f}" for k, v in sorted(r0["walltime"].items(),
                                               key=lambda kv: -kv[1])),
              flush=True)


def hier_bounds(res):
    """K1's and K2's bounds summed over the hierarchical run's
    evaluations, each at its own (compacted) nb, with the potential where
    it was computed (the snapshots')."""
    ser = res["series"]
    nbs = ser["active_blocks"]
    npot = ser["with_potential"]
    G, LL = res["group"], res["leaf_list_max"]
    k1 = sum(pair_bound(nb, G, s, wp)[0]
             for nb, s, wp in zip(nbs, ser["pair_sources_sum"], npot))
    k2 = sum(walk_bound(nb, G, LL, c, v, m, wp)[0]
             for nb, c, v, m, wp in zip(nbs, ser["walk_nodes"],
                                        ser["walk_visits_sum"],
                                        ser["walk_monopoles"], npot))
    return k1, k2


def refines(a, b):
    """Every class of labeling a lies inside one class of labeling b."""
    import numpy as np
    a = np.unique(a, return_inverse=True)[1].astype(np.int64)
    b = np.unique(b, return_inverse=True)[1].astype(np.int64)
    return len(np.unique(a * (b.max() + 1) + b)) == a.max() + 1


def fof_phase(sim, label, device="cuda"):
    """FOF of the final dm-small state through Simulation.run_fof (PIG
    `label`), from a cold leaf-list cache, with per-stage seconds; the
    labels held to scipy's connected components of the same positions
    (f64 from the fixed point) bracketing the linking length.  K3's
    LAUNCHES are reset just before and read just after.  Returns the
    measurements and K3's inputs."""
    import numpy as np
    import torch
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components
    from scipy.spatial import cKDTree
    from mpgadget_tpu_torch.gravity.treepm import StageTimer
    from mpgadget_tpu_torch.ops import pairs
    from mpgadget_tpu_torch.physics import fof

    captured = {}
    real = fof.fof_label

    def spy(*a, **k):
        res = real(*a, **k)
        captured.update(args=a, labels=res[0])
        return res

    timer = StageTimer()
    pairs._LL_CACHE.clear()
    fof.fof_label = spy
    try:
        pairs.LAUNCHES = 0
        t0 = time.perf_counter()
        timer.start(torch.device(device))
        cat = sim.run_fof(save=True, label=label, timer=timer)
        seconds = time.perf_counter() - t0
        launches = pairs.LAUNCHES
    finally:
        fof.fof_label = real
    if device == "cuda":
        check(launches >= 1, "FOF did not launch the neighbour kernel")
    path = os.path.join(sim.cfg.output_dir,
                        f"{sim.cfg.fof_file_base}_{label:03d}")
    ng, bins, _ = pig_check(path, sim.cfg.fof_min_group_length)
    check(ng == cat["ngroups"], "PIG group count against the catalogue")

    ipos, primary, box, ll = captured["args"][:4]
    primary = primary.cpu().numpy()
    lab = captured["labels"].cpu().numpy()[primary]
    pos = ipos.cpu().numpy()[primary].astype(np.float64) * 2.0 ** -32
    t0 = time.perf_counter()
    kd = cKDTree(pos, boxsize=1.0)
    m = len(pos)
    comps = {}
    for side, f in (("inner", 1 - 1e-5), ("outer", 1 + 1e-5)):
        prs = kd.query_pairs(ll / box * f, output_type="ndarray")
        comps[side] = connected_components(csr_matrix(
            (np.ones(len(prs)), (prs[:, 0], prs[:, 1])), shape=(m, m)),
            directed=False)[1]
    scipy_s = time.perf_counter() - t0
    inside = refines(comps["inner"], lab)
    within = refines(lab, comps["outer"])
    st, ser = timer.seconds, timer.series
    print(f"FOF of the final dm-small state ({m} primaries, linking length "
          f"{ll:.6f} kpc/h = {ll / box:.9f} box) on {device}: "
          f"{seconds:.6f} s through Simulation.run_fof; stages "
          + ", ".join(f"{k} {v:.6f}" for k, v in st.items())
          + f" s; leaf lists from 64 (cache cleared) to LL "
          f"{ser['leaf_list_max'][-1]}; {ser['rounds'][-1]} min-label rounds"
          f" of " + " ".join(f"{v:.6f}" for v in ser["round_seconds"])
          + f" s; K3 launches {launches}", flush=True)
    print(f"FOF labels against scipy (cKDTree + connected_components, "
          f"{scipy_s:.3f} s on the host): {len(np.unique(comps['inner']))} "
          f"components at ll(1-1e-5), {len(np.unique(lab))} port groups, "
          f"{len(np.unique(comps['outer']))} at ll(1+1e-5); every inner "
          f"component inside one port group: {inside}; every port group "
          f"inside one outer component: {within}; {ng} halos of >= "
          f"{sim.cfg.fof_min_group_length}, per log10(M/Msun) bin {bins}",
          flush=True)
    check(inside and within, "FOF labels outside the scipy bracket")
    return dict(seconds=seconds, stages=dict(st), series=dict(ser),
                launches=launches, groups=ng, ll=ll, box=box,
                ipos=ipos, primary=captured["args"][1],
                leaf_list_max=ser["leaf_list_max"][-1])


def kernel_split(fn, calls):
    """Mean device milliseconds per call of each CUDA kernel that fn
    launches, by torch.profiler ({} where the profiler records no device
    time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0:
            out[ev.key.split("(")[0].split("<")[0].replace("void ", "")] = \
                us * 1e-3 / calls
    return out


def serial_neighbors_fn():
    """The serial neighbour walk's entry point (csrc/neighbors_serial.cu),
    a yardstick that only this script loads."""
    import ctypes
    from mpgadget_tpu_torch import kernels
    fn = kernels.load("neighbors_serial").find_neighbors_serial_f32
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    return fn


def serial_neighbors(fn, packed, tree, group_nodes, center, half, radius,
                     hmax, LL, symmetric):
    """One call of the serial neighbour walk as the port first launched
    it: the lists filled with C, then one thread per group; returns
    (leaf_idx, n_leaves, overflow, visits)."""
    import torch
    nodes, meta = packed
    ng = group_nodes.shape[0]
    dev = center.device
    out = (torch.full((ng, LL), tree.capacity, dtype=torch.int32,
                      device=dev),
           torch.empty(ng, dtype=torch.int32, device=dev),
           torch.empty(ng, dtype=torch.bool, device=dev),
           torch.empty(ng, dtype=torch.int32, device=dev))
    rc = fn(nodes.data_ptr(), (hmax if symmetric else nodes).data_ptr(),
            meta.data_ptr(), tree.n_nodes.data_ptr(), group_nodes.data_ptr(),
            center.data_ptr(), half.data_ptr(), radius.data_ptr(),
            *(t.data_ptr() for t in out), ng, tree.capacity, LL,
            int(bool(symmetric)), torch.cuda.current_stream(dev).cuda_stream)
    check(rc == 0, f"serial neighbour walk launch failed: CUDA error {rc}")
    return out


NEIGHBOR_FIELDS = ("leaf_idx", "n_leaves", "overflow", "visits")


def neighbor_case(name, tree, groups, radius, hmax, LL, symmetric, l2_ns,
                  serial_fn):
    """K3 against its plain version on one set: the same lists, counts,
    flags and visits, two launches and the serial yardstick the same
    bits; device times by graph replays, the kernel's beside the serial
    walk's, and each one's critical path."""
    import torch
    from mpgadget_tpu_torch.ops import pairs
    nodes, gc, gh = groups[:3]
    args = (tree, nodes, gc, gh, radius, hmax, LL)
    res = pairs.find_neighbors(*args, symmetric=symmetric)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = pairs.find_neighbors_reference(*args, symmetric=symmetric)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    for f in NEIGHBOR_FIELDS:
        check(torch.equal(getattr(res, f), getattr(ref, f)),
              f"neighbour kernel {f} differs from the plain version ({name})")
    abs_err = max(int((getattr(res, f).long() - getattr(ref, f).long())
                      .abs().max()) for f in NEIGHBOR_FIELDS)
    packed = pairs.pack_neighbor_nodes(tree)
    again, stats = pairs.neighbor_kernel(*args, symmetric=symmetric,
                                         packed=packed)
    check(all(torch.equal(getattr(res, f), getattr(again, f))
              for f in NEIGHBOR_FIELDS), f"two launches of K3 differ ({name})")
    check(int(stats["serial"].sum()) == 0,
          f"K3's stack ran out of room ({name})")
    ser = serial_neighbors(serial_fn, packed, *args, symmetric)
    check(all(torch.equal(a, getattr(res, f))
              for a, f in zip(ser, NEIGHBOR_FIELDS)),
          f"K3 and the serial neighbour walk differ in some bit ({name})")
    ms = graph_ms(lambda: pairs.find_neighbors(*args, symmetric=symmetric),
                  20)
    alone_ms = graph_ms(lambda: pairs.neighbor_kernel(
        *args, symmetric=symmetric, packed=packed), 20)
    serial_ms = graph_ms(lambda: serial_neighbors(
        serial_fn, packed, *args, symmetric), 20)
    split = kernel_split(lambda: pairs.neighbor_kernel(
        *args, symmetric=symmetric, packed=packed), 10)
    ng = int(nodes.shape[0])
    real = int((nodes < tree.n_nodes).sum())
    visits = int(res.visits.sum())
    vmax = int(res.visits.max())
    n_nodes = int(tree.n_nodes)
    listed = int(res.n_leaves.sum())
    rounds = int(stats["rounds"].max())
    loads = int(stats["loads"].max())
    bound_ms, bound_by = neighbor_bound(ng, LL, n_nodes, visits, symmetric)
    walk_ms, walk_by = neighbor_bound(ng, LL, n_nodes, visits, symmetric,
                                      listed)
    path_ms = loads * l2_ns * 1e-6
    serial_path_ms = vmax * l2_ns * 1e-6
    print(f"kernel find_neighbors {name} groups {real} of {ng} slots "
          f"LL={LL} symmetric={symmetric}: identical leaf lists, counts, "
          f"flags and visits, max_abs_err={abs_err} ({listed} leaves, "
          f"{int(res.overflow.sum())} groups overflowed); two launches "
          f"and the serial walk bit-identical; tree nodes {n_nodes}, "
          f"visits {visits} (longest group {vmax}); kernel_ms={ms:.6f} "
          f"(graph replays, with pack_neighbor_nodes; the kernel alone "
          f"{alone_ms:.6f}) serial_walk_ms={serial_ms:.6f} "
          f"plain_ms={plain_ms:.6f} bound_ms={bound_ms:.6f} ({bound_by}, "
          f"the whole {ng} x {LL} lists written); the walk's own bound "
          f"{walk_ms:.6f} ms ({walk_by}, the {listed} listed leaves "
          f"written); critical path {path_ms:.6f} ms (longest group "
          f"{loads} dependent loads in {rounds} rounds x one L2 round "
          f"trip; mean group {float(stats['loads'].float().mean()):.1f} "
          f"loads in {float(stats['rounds'].float().mean()):.1f} rounds), "
          f"the serial walk's {serial_path_ms:.6f} ms (longest group "
          f"{vmax} visits); per kernel of K3 (torch.profiler, mean of 10 "
          f"calls): " + (", ".join(f"{k} {v:.6f} ms" for k, v in
                                     split.items()) or "not measured"),
          flush=True)
    return dict(case=name, ms=ms, alone_ms=alone_ms, serial_ms=serial_ms,
                split_ms=split,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                walk_bound_ms=walk_ms, visits=visits, visits_max=vmax,
                groups=real, LL=LL, rounds_max=rounds, loads_max=loads,
                path_ms=path_ms, serial_path_ms=serial_path_ms,
                overflowed=int(res.overflow.sum()), max_abs_err=abs_err)


def neighbor_serial_mode_case(name, tree, groups, radius, hmax, LL,
                              symmetric, stack_cap=1):
    """K3 with a stack too small for its rounds, so that its serial mode
    walks the groups: held to the plain version bit for bit."""
    import torch
    from mpgadget_tpu_torch.ops import pairs
    args = (tree, *groups[:3], radius, hmax, LL)
    res, stats = pairs.neighbor_kernel(*args, symmetric=symmetric,
                                       stack_cap=stack_cap)
    ref = pairs.find_neighbors_reference(*args, symmetric=symmetric)
    for f in NEIGHBOR_FIELDS:
        check(torch.equal(getattr(res, f), getattr(ref, f)),
              f"K3's serial mode: {f} differs from the plain version")
    serial = int(stats["serial"].sum())
    check(serial > 0, "K3's serial mode was not taken")
    ms = graph_ms(lambda: pairs.neighbor_kernel(
        *args, symmetric=symmetric, stack_cap=stack_cap), 5)
    abs_err = max(int((getattr(res, f).long() - getattr(ref, f).long())
                      .abs().max()) for f in NEIGHBOR_FIELDS)
    print(f"kernel find_neighbors {name}, stack_cap={stack_cap} (serial "
          f"mode): identical leaf lists, counts, flags and visits; "
          f"{serial} of {int(res.visits.sum())} visits serial; "
          f"kernel_ms={ms:.6f} (the kernel alone, graph replays)",
          flush=True)
    return dict(case=f"{name} serial mode", ms=ms, serial=serial,
                max_abs_err=abs_err)


def neighbor_phase(fres, l2_ns, seed=43, device="cuda"):
    """K3 against its plain version on the card: the final dm-small
    state's FOF inputs (asymmetric, radius the linking length, at the LL
    the FOF phase reached), and the 64^3 clustered particles, symmetric,
    with a seeded hmax on a fifth of the nodes, at an LL that some groups
    overflow; each beside the serial walk K3 began as; then the clustered
    set again with a stack too small for the rounds (the serial mode)."""
    import numpy as np
    import torch
    from mpgadget_tpu_torch.physics import fof

    serial_fn = serial_neighbors_fn() if device == "cuda" else None
    cfg = fof.FOFParams()
    out = []
    _, _, _, tree, groups = fof._sorted_tree(fres["ipos"], fres["primary"],
                                             cfg)
    ll_box = float(np.float32(fres["ll"] / fres["box"]))
    radius = torch.full((groups[0].shape[0],), ll_box, device=device)
    out.append(neighbor_case("dm-small final state", tree, groups, radius,
                             None, fres["leaf_list_max"], False, l2_ns,
                             serial_fn))
    n = int(fres["ipos"].shape[0])
    ipos = torch.as_tensor(clustered_ipos(n), device=device)
    _, _, _, tree, groups = fof._sorted_tree(
        ipos, torch.ones(n, dtype=torch.bool, device=device), cfg)
    rng = np.random.RandomState(seed)
    C = tree.capacity
    hmax = torch.as_tensor((rng.uniform(0, 3 * ll_box, C)
                            * (rng.rand(C) < 0.2)).astype(np.float32),
                           device=device)
    radius = torch.full((groups[0].shape[0],), ll_box, device=device)
    res = neighbor_case("clusters", tree, groups, radius, hmax, 16, True,
                        l2_ns, serial_fn)
    check(res["overflowed"] > 0, "no clustered group overflowed LL = 16")
    out.append(res)
    out.append(neighbor_serial_mode_case("clusters", tree, groups, radius,
                                         hmax, 16, True))
    return out


def restart_phase(workdir, snapnum, in_process, device="cuda",
                  paramfile=None, cli=True):
    """RestartFlag 3 through the port's CLI, python -m
    mpgadget_tpu_torch.main paramfile.gadget 3 <snapnum>, in workdir (the
    paramfile's paths are relative): its PIG must read back and pass the
    PIG checks.  cli=False runs the CLI's body (main.run_cli) in this
    process instead, without a process start of its own (the gas phases;
    phase 13 runs the CLI).  On the CPU, where the CLI refuses to run, the
    calls it makes run in-process.  paramfile: dm-small's by default."""
    paramfile = paramfile or os.path.join(HERE, "examples", "dm-small",
                                          "paramfile.gadget")
    t0 = time.perf_counter()
    if device == "cuda" and not cli:
        from mpgadget_tpu_torch.main import run_cli as cli_body
        cwd = os.getcwd()
        os.chdir(workdir)
        try:
            cli_body(paramfile, 3, snapnum, device=device)
        finally:
            os.chdir(cwd)
    elif device == "cuda":
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (HERE, os.environ.get("PYTHONPATH")) if p))
        out = subprocess.run(
            [sys.executable, "-m", "mpgadget_tpu_torch.main", paramfile,
             "3", str(snapnum)], cwd=workdir, env=env, capture_output=True,
            text=True, timeout=600)
        check(out.returncode == 0, "RestartFlag 3 CLI failed: "
              + (out.stdout + out.stderr)[-2000:])
    else:
        from mpgadget_tpu_torch.main import build_simulation
        cwd = os.getcwd()
        os.chdir(workdir)
        try:
            sim, ps = build_simulation(paramfile, snapshot=os.path.join(
                "output", f"PART_{snapnum:03d}"), device=device)
            sim.run_fof(save=True, label=snapnum)
        finally:
            os.chdir(cwd)
    seconds = time.perf_counter() - t0
    from mpgadget_tpu_torch.params import create_gadget_parameter_set
    ps = create_gadget_parameter_set()
    ps.parse_file(paramfile)
    ng, bins, largest = pig_check(
        os.path.join(workdir, ps["OutputDir"], f"PIG_{snapnum:03d}"),
        ps["FOFHaloMinLength"])
    how = ("the CLI process, its start included" if device == "cuda"
           and cli else "the CLI's body in this process" if device == "cuda"
           else "the in-process calls")
    print(f"RestartFlag 3 on PART_{snapnum:03d}: {seconds:.6f} s for {how}"
          f"; PIG_{snapnum:03d} read back and consistent: {ng} groups "
          f"(the in-process FOF of the same state: {in_process}); halos per "
          f"log10(M/Msun) bin {bins}; largest {largest:.6e} Msun",
          flush=True)
    return dict(seconds=seconds, groups=ng)


# -- the dark-matter options: neutrinos, hybrid neutrinos, the light cone,
#    potential planes, OutputEnergyDebug, RestartFlag 1/2/4/99, and one IC
#    through both packages --------------------------------------------------

NU_SWITCHES = {"MassiveNuLinRespOn": 1, "MNue": 0.2,
               "PlaneOutputList": "0.2,0.25", "OutputEnergyDebug": 1}
HYBRID_GENIC = {"NgridNu": 32, "Max_nuvel": 3000, "MNue": 0.2, "MNum": 0.2,
                "MNut": 0.2}
HYBRID_SWITCHES = {"MassiveNuLinRespOn": 1, "HybridNeutrinosOn": 1,
                   "Vcrit": 3000, "NuPartTime": 0.2, "MNue": 0.2,
                   "MNum": 0.2, "MNut": 0.2,
                   # depth: to a = 0.22, past NuPartTime (dm-small: 0.25)
                   "OutputList": "0.22", "TimeMax": 0.22}
# dm-small's IC in a 500 Mpc/h box: its replicas reach the horizon from
# z = 9 (a 64 Mpc/h box, with BoxBoost 20, reaches 2.2 Gpc/h: no row
# before z ~ 3); depth to a = 0.15 (dm-small's first output)
LIGHTCONE_GENIC = {"BoxSize": 500000}
LIGHTCONE_SWITCHES = {"LightconeOn": 1, "OutputList": "0.15",
                      "TimeMax": 0.15}
# RestartFlag 99 on dm-small's final state: the accuracy phase's limits
GRAVITY_TEST_LIMITS = {"mean_rel_err": 5e-3, "p99_rel_err": 5e-2}
# one IC through both packages (tests/test_torch_parity.py): the reduced
# dm-small (Ngrid 24) IC made once by the port's genic, and the JAX
# package's outputs from it on the CPU
PARITY_DIR = os.path.join(HERE, "tests", "torch_parity")
PARITY_NMESH = 48
# the card's P(k) against the JAX package's and against a second card run
# of the same IC: the CPU test's tolerance (tests/test_torch_parity.py
# PK_RTOL, 5x the 9.8e-6 by which the port on the CPU differs from the
# JAX package), which also covers the card's run-to-run spread (2.0e-6
# and 4.7e-6 in two smoke runs on the card: the sums in no fixed order) ten
# times over
PARITY_PK_RTOL = 5e-5
# RestartFlag 4's P(k) of the final snapshot against the in-run P(k) of
# the same a, below half the mesh's Nyquist k: the snapshot's positions
# lack the run's random box shift, which moves the CIC window's aliasing;
# the resumed runs' P(k) against the uninterrupted run's likewise (their
# box shifts differ from the restart on).  ~5x the 4.2e-3 / 4.6e-3
# measured on the card (64^3; 4.9e-2 at 16^3 on the CPU, shot noise)
FLAG4_PK_RTOL = 0.02
# a resumed run's positions against the uninterrupted run's, and flag 1's
# against flag 2's: the 99th percentile of the per-particle distance, in
# box units.  Their random box shifts differ from the restart on, and
# with them the tree's force errors over 5 PM steps: 5.1e-6 on the card
# (flag 1 against flag 2, the card's sums alone: 9.9e-10); 20x that.  A
# resumed run that lost its state would miss by the displacements
# themselves, 1e-3 of the box and more
RESUME_POS_TOL = 1e-4


def dm_variant(workdir, device, genic_over=None, gadget_over=None, ic=None,
               spy=None, ngrid=None, nmesh=None):
    """dm-small from its own paramfiles with the overrides named: genic
    (in-process, GENIC_OVERRIDE and genic_over) unless ic names an IC,
    then Simulation.run() to the paramfile's TimeMax, every kernel's
    LAUNCHES reset just before the run and read just after.  spy(sim) may
    wrap the simulation's methods before it runs.  Returns a dict."""
    import torch
    from mpgadget_tpu_torch.genic.main import run_genic
    from mpgadget_tpu_torch.gravity import pairkernel as pk
    from mpgadget_tpu_torch.gravity import treewalk as tw
    from mpgadget_tpu_torch.main import build_simulation
    from mpgadget_tpu_torch.ops import pairs
    from mpgadget_tpu_torch.params import create_genic_parameter_set

    os.makedirs(workdir, exist_ok=True)
    gadget_over = dict(gadget_over or {})
    if nmesh is not None:      # a smaller rehearsal on the CPU
        gadget_over["Nmesh"] = nmesh
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        t0 = time.perf_counter()
        if ic is None:
            over = dict(GENIC_OVERRIDE, **(genic_over or {}))
            if ngrid is not None:
                over["Ngrid"] = ngrid
            gps = create_genic_parameter_set()
            gps.parse_file(paramfile_copy(
                os.path.join(HERE, "examples", "dm-small", "paramfile.genic"),
                "paramfile.genic", over))
            run_genic(gps, device=device)
        else:
            gadget_over["InitCondFile"] = ic
        genic_seconds = time.perf_counter() - t0
        paramfile = os.path.abspath(paramfile_copy(
            os.path.join(HERE, "examples", "dm-small", "paramfile.gadget"),
            "paramfile.gadget", gadget_over))
        sim, _ = build_simulation(paramfile, device=device)
        if spy is not None:
            spy(sim)
        pk.LAUNCHES = tw.LAUNCHES = pairs.LAUNCHES = 0
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        nsteps = sim.run(verbose=False)
        if device == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {"pair": pk.LAUNCHES, "walk": tw.LAUNCHES,
                    "neighbors": pairs.LAUNCHES}
    finally:
        os.chdir(cwd)
    out = os.path.join(workdir, sim.cfg.output_dir)
    check(sim.ti_current == sim.timeline.ti_end,
          f"{workdir}: ran {nsteps} PM steps to a={sim.atime}")
    if device == "cuda":
        for name in ("pair", "walk"):
            check(launches[name] >= sim.tree_force_calls > 0,
                  f"{workdir}: {name} kernel launched {launches[name]} times "
                  f"for {sim.tree_force_calls} tree-force evaluations")
        if sim.cfg.snapshot_with_fof:
            check(launches["neighbors"] > 0,
                  f"{workdir}: the neighbour kernel was not launched")
    return dict(sim=sim, nsteps=nsteps, seconds=seconds, out=out,
                launches=launches, paramfile=paramfile,
                genic_seconds=genic_seconds,
                walltime=dict(sim.walltime.totals))


def read_fits(path):
    """(header cards as {key: value text}, float array) of a FITS image of
    io/fits.py: one header block of 80-byte cards, big-endian data."""
    import numpy as np
    with open(path, "rb") as fh:
        raw = fh.read()
    cards, pos = {}, 0
    while True:
        block = raw[pos:pos + 2880].decode("ascii")
        pos += 2880
        done = False
        for i in range(0, 2880, 80):
            card = block[i:i + 80]
            key = card[:8].strip()
            if key == "END":
                done = True
                break
            if card[8:10] == "= ":
                cards[key] = card[10:].split("/")[0].strip()
        if done:
            break
    dtype = {"-32": ">f4", "-64": ">f8"}[cards["BITPIX"]]
    n0, n1 = int(cards["NAXIS1"]), int(cards["NAXIS2"])
    data = np.frombuffer(raw[pos:pos + n0 * n1 * int(dtype[-1])], dtype)
    return cards, data.reshape(n1, n0)


def neutrino_phase(workdir, hres_out, device="cuda", ngrid=None, nmesh=None):
    """dm-small with massive neutrinos in linear response (NU_SWITCHES in
    both paramfiles: MNue 0.2; planes at a = 0.2 and 0.25;
    OutputEnergyDebug) to a = 0.25: the delta_tot history holds an entry
    for each PM step, grav_pm is finite, the multiplier nufac is above 1
    at the lowest k (tests/test_neutrinos.py:141-153); its P(k) beside
    the no-neutrino run's (hres_out) at the same a, bin by bin;
    energy.txt printed and checked; the planes read back and checked."""
    import copy
    import numpy as np
    import torch
    from mpgadget_tpu_torch.physics import neutrinos_lra
    table_step = neutrinos_lra.DeltaTotTable.step
    host = []

    def timed_step(self, *a, **k):
        t0 = time.perf_counter()
        out = table_step(self, *a, **k)
        host.append(time.perf_counter() - t0)
        return out

    neutrinos_lra.DeltaTotTable.step = timed_step
    try:
        res = dm_variant(workdir, device, genic_over={"MNue": 0.2},
                         gadget_over=NU_SWITCHES, ngrid=ngrid, nmesh=nmesh)
    finally:
        neutrinos_lra.DeltaTotTable.step = table_step
    sim = res["sim"]
    table = sim._nu_table_state
    check(table is not None, "no neutrino table")
    check(len(table.scalefact) == res["nsteps"] + 1,
          f"delta_tot history of {len(table.scalefact)} entries for "
          f"{res['nsteps']} PM steps and the first forces")
    check(bool(torch.isfinite(sim.pdata.grav_pm).all()), "grav_pm not finite")
    ps = sim.last_power
    _, nufac = copy.deepcopy(table).step(
        sim.atime, np.sqrt(np.maximum(ps.power[ps.nmodes > 0], 0)))
    check(nufac[0] > 1.0, f"nufac at the lowest k {nufac[0]} <= 1")
    name = f"powerspectrum-{sim.atime:0.4f}.txt"
    nu = np.loadtxt(os.path.join(res["out"], name))
    plain = np.loadtxt(os.path.join(hres_out, name))
    print(f"neutrinos (MNue 0.2) dm-small to a={sim.atime:.6f}: "
          f"{res['nsteps']} PM steps in {res['seconds']:.6f} s (genic "
          f"{res['genic_seconds']:.6f} s); walltime PMgrav (the neutrino "
          f"response included) {res['walltime'].get('PMgrav', 0.0):.6f} s, "
          f"of it the host's DeltaTotTable.step {sum(host):.6f} s in "
          f"{len(host)} calls; Planes {res['walltime'].get('Planes', 0.0):.6f}"
          f" s; delta_tot "
          f"history {len(table.scalefact)} entries; nufac at the lowest k "
          f"{nufac[0]:.6f}, at the highest {nufac[-1]:.6f}; kernel launches "
          f"{res['launches']}", flush=True)
    print(f"{name}, k [h/Mpc], P with MNue 0.2 (total matter) and without, "
          f"ratio: " + "; ".join(
              f"{a[0]:g} {a[1]:g} {b[1]:g} {a[1] / b[1]:.4f}"
              for a, b in zip(nu, plain)), flush=True)
    with open(os.path.join(res["out"], "energy.txt")) as fh:
        energy = fh.read()
    print("energy.txt:\n" + energy.rstrip(), flush=True)
    rows = np.loadtxt(os.path.join(res["out"], "energy.txt"), ndmin=2)
    check(rows.shape == (sim.snapshot_count, 29) and np.isfinite(rows).all()
          and (rows[:, 3] < 0).all() and (rows[:, 4] > 0).all(),
          f"energy.txt rows {rows.shape}: one a snapshot, 29 columns, "
          "EnergyPot < 0 < EnergyKin")
    planes = sorted(f for f in os.listdir(res["out"]) if f.endswith(".fits"))
    check(len(planes) == 6, f"planes written: {planes}")
    for f in planes:
        cards, pix = read_fits(os.path.join(res["out"], f))
        res_ = int(cards["NAXIS1"])
        rms = float(np.sqrt(np.mean(pix.astype(np.float64) ** 2)))
        # the slab is the whole box (PlaneThickness <= 0): every particle
        # but those on its boundary, |dn| = 0.5 exactly
        npart = int(cards["NPART"])
        check(pix.shape == (res_, res_) and np.isfinite(pix).all() and rms > 0
              and abs(float(pix.astype(np.float64).mean())) < 1e-4 * rms
              and 0.999 * int(sim.pdata.num_valid) <= npart
              <= int(sim.pdata.num_valid)
              and cards["UNIT"] == "'rad2    '",
              f"plane {f}: {res_}^2 pixels, rms {rms}, cards {cards}")
        print(f"plane {f}: {res_}^2 pixels, rms {rms:.6e} rad^2, zero "
              f"mean, NPART {cards['NPART']}, Z {cards['Z']}, CHI "
              f"{cards['CHI']} Mpc/h", flush=True)
    return res


def hybrid_phase(workdir, device="cuda", ngrid=None, nmesh=None,
                 ngrid_nu=None):
    """dm-small with hybrid neutrinos (HYBRID_GENIC: 32^3 type-2
    particles beside the 64^3 DM; HYBRID_SWITCHES: NuPartTime 0.2 inside
    the run): before NuPartTime the type-2 particles are tracers with
    zero grav_pm, after it they gravitate (nonzero grav_pm)."""
    import numpy as np
    import torch
    seen = []

    def spy(sim):
        forces = sim.compute_forces

        def recorded(*a, **k):
            forces(*a, **k)
            nu = sim.pdata.valid & (sim.pdata.ptype == 2)
            seen.append((sim.atime, float(sim.pdata.grav_pm[nu].abs().max()),
                         sim.CP.hybrid_nu_tracer(sim.atime)))
        sim.compute_forces = recorded

    genic = dict(HYBRID_GENIC)
    if ngrid_nu is not None:
        genic["NgridNu"] = ngrid_nu
    res = dm_variant(workdir, device, genic_over=genic,
                     gadget_over=HYBRID_SWITCHES, spy=spy, ngrid=ngrid,
                     nmesh=nmesh)
    sim = res["sim"]
    n_nu = int((sim.pdata.valid & (sim.pdata.ptype == 2)).sum())
    check(n_nu == genic["NgridNu"] ** 3, f"{n_nu} type-2 particles")
    before = [s for s in seen if s[2]]
    after = [s for s in seen if not s[2]]
    check(before and after, f"NuPartTime not inside the run: {seen}")
    check(all(s[1] == 0 for s in before),
          f"tracers with grav_pm before NuPartTime: {before}")
    check(all(s[1] > 0 for s in after),
          f"type-2 grav_pm zero after NuPartTime: {after}")
    print(f"hybrid neutrinos ({n_nu} type-2 beside "
          f"{int((sim.pdata.ptype == 1).sum())} DM, NuPartTime "
          f"{HYBRID_SWITCHES['NuPartTime']}): {res['nsteps']} PM steps to "
          f"a={sim.atime:.6f} in {res['seconds']:.6f} s; max |grav_pm| of "
          f"type 2 is 0 at {len(before)} force calls before NuPartTime, "
          f"{min(s[1] for s in after):.6e}..{max(s[1] for s in after):.6e} "
          f"at {len(after)} after; kernel launches {res['launches']}",
          flush=True)
    return res


def lightcone_phase(workdir, device="cuda", ngrid=None, nmesh=None):
    """dm-small's IC in a 500 Mpc/h box with LightconeOn to a = 0.15: rows
    were written, each inside the shell of horizon distances the run
    crossed, with a sample fraction in (0, 1]."""
    import numpy as np
    from mpgadget_tpu_torch.physics import lightcone
    replicas = lightcone.Lightcone.replicas
    counts = []

    def counted(self):
        reps = replicas(self)
        counts.append(len(reps))
        return reps

    lightcone.Lightcone.replicas = counted
    try:
        res = dm_variant(workdir, device, genic_over=LIGHTCONE_GENIC,
                         gadget_over=LIGHTCONE_SWITCHES, ngrid=ngrid,
                         nmesh=nmesh)
    finally:
        lightcone.Lightcone.replicas = replicas
    sim = res["sim"]
    lc = sim._lightcone
    rows = np.fromfile(os.path.join(workdir, lc.path),
                       np.float64).reshape(-1, 4)
    check(len(rows) > 0 and len(rows) == lc.n_written,
          f"light cone rows: {len(rows)} in the file, {lc.n_written} counted")
    d = np.linalg.norm(rows[:, :3], axis=1)
    lo, hi = lc.get_horizon(sim.atime), lc.get_horizon(sim.time_ic)
    check(bool(((d >= lo * (1 - 1e-6)) & (d <= hi * (1 + 1e-6))).all()
               & ((rows[:, 3] > 0) & (rows[:, 3] <= 1)).all()),
          f"light cone rows outside the shell [{lo}, {hi}]")
    print(f"light cone (dm-small's IC, BoxSize 500 Mpc/h) to "
          f"a={sim.atime:.6f}: {res['nsteps']} PM steps in "
          f"{res['seconds']:.6f} s; {len(rows)} rows written at "
          f"{d.min() / 1000:.3f}..{d.max() / 1000:.3f} Mpc/h, sample "
          f"fraction {rows[:, 3].min():.6f}..{rows[:, 3].max():.6f}; "
          f"replicas straddling the shell per PM step {counts}; "
          f"walltime Lightcone {res['walltime'].get('Lightcone', 0.0):.6f} s"
          f", PMgrav {res['walltime'].get('PMgrav', 0.0):.6f} s; kernel "
          f"launches {res['launches']}", flush=True)
    return res


def snapshot_positions(path):
    """Type-1 positions of a snapshot in ID order."""
    import numpy as np
    from mpgadget_tpu_torch.io.bigfile import BigFile
    from mpgadget_tpu_torch.io import snapshot as snap_io
    bf = BigFile(path)
    sp = snap_io.read_species(bf, 1, snap_io.read_header(bf))
    return sp["pos"][np.argsort(sp["pid"])]


def box_diff(a, b, box):
    """The largest and the 99th percentile of the particles' minimum-image
    distances, over the box."""
    import numpy as np
    d = (a - b + box / 2) % box - box / 2
    r = np.sqrt(np.sum(d * d, axis=1)) / box
    return float(r.max()), float(np.percentile(r, 99))


def restart_flags_phase(workdir, snapnum, device="cuda", nmesh=None):
    """RestartFlags 1, 2, 4 and 99 through the port's CLI on the
    hierarchical dm-small run in workdir (snapshots 0..2 at a = 0.15, 0.2,
    0.25, and the smoke's own last, snapnum), each in a copy of its
    output, the four processes at once: flag 2 resumes from PART_001 and
    flag 1 from the last snapshot Snapshots.txt lists, cut to PART_001;
    both must reach a = 0.25 and write PART_002 again, whose positions
    are held to the uninterrupted run's and to each other's (the card's
    sums in no fixed order make the resumed runs differ).  Flag 4's P(k)
    of the final snapshot against the in-run P(k) of the same a
    (FLAG4_PK_RTOL); flag 99 on it (GRAVITY_TEST_LIMITS).  On the CPU
    the calls run in-process (mpgadget_tpu_torch.main.run_cli).  nmesh:
    the hierarchical run's, for a smaller rehearsal on the CPU."""
    import shutil
    import numpy as np
    from mpgadget_tpu_torch.main import run_cli as port_cli
    paramfile = os.path.join(HERE, "examples", "dm-small", "paramfile.gadget")
    if nmesh is not None:
        paramfile = paramfile_copy(paramfile, os.path.join(
            workdir, "paramfile.gadget"), {"Nmesh": nmesh})
    src = os.path.join(workdir, "output")
    jobs = {"1": ["1"], "2": ["2", "1"], "4": ["4", str(snapnum)],
            "99": ["99", str(snapnum)]}
    dirs = {}
    for flag in jobs:
        d = os.path.join(workdir, f"restart{flag}")
        shutil.copytree(src, os.path.join(d, "output"), ignore=(
            shutil.ignore_patterns("PIG_*") if flag in ("4", "99")
            else None))
        dirs[flag] = d
    with open(os.path.join(dirs["1"], "output", "Snapshots.txt")) as fh:
        lines = fh.read().splitlines()
    with open(os.path.join(dirs["1"], "output", "Snapshots.txt"), "w") as fh:
        fh.write("\n".join(lines[:2]) + "\n")
    for flag in ("1", "2"):
        out = os.path.join(dirs[flag], "output")
        os.rename(os.path.join(out, "PART_002"), os.path.join(out, "full_002"))
    a_end = float(lines[-1].split()[1])
    inrun_name = f"powerspectrum-{a_end:0.4f}.txt"
    inrun = np.loadtxt(os.path.join(src, inrun_name))
    t0 = time.perf_counter()
    logs = {}
    if device == "cuda":
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (HERE, os.environ.get("PYTHONPATH")) if p))
        procs = {flag: subprocess.Popen(
            [sys.executable, "-m", "mpgadget_tpu_torch.main", paramfile,
             *args], cwd=dirs[flag], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for flag, args in jobs.items()}
        for flag, p in procs.items():
            try:
                logs[flag], _ = p.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                for q in procs.values():
                    q.kill()
                raise SmokeFailure(f"RestartFlag {flag} CLI timed out")
            check(p.returncode == 0, f"RestartFlag {flag} CLI failed: "
                  + logs[flag][-2000:])
    else:
        import contextlib
        import io
        for flag, args in jobs.items():
            cwd = os.getcwd()
            os.chdir(dirs[flag])
            buf = io.StringIO()
            try:
                with contextlib.redirect_stdout(buf):
                    port_cli(paramfile, int(args[0]),
                             int(args[1]) if len(args) > 1 else None,
                             device=device)
            finally:
                os.chdir(cwd)
            logs[flag] = buf.getvalue()
    seconds = time.perf_counter() - t0
    from mpgadget_tpu_torch.io.bigfile import BigFile
    from mpgadget_tpu_torch.io import snapshot as snap_io
    full = os.path.join(dirs["2"], "output", "full_002")
    box = snap_io.read_header(BigFile(full)).BoxSize
    full = snapshot_positions(full)
    pos = {}
    for flag in ("1", "2"):
        out = os.path.join(dirs[flag], "output")
        check(os.path.isdir(os.path.join(out, "PART_002")),
              f"RestartFlag {flag} wrote no PART_002")
        pos[flag] = snapshot_positions(os.path.join(out, "PART_002"))
    d2 = box_diff(pos["2"], full, box)
    d1 = box_diff(pos["1"], full, box)
    d12 = box_diff(pos["1"], pos["2"], box)
    from mpgadget_tpu_torch.params import create_gadget_parameter_set
    ps = create_gadget_parameter_set()
    ps.parse_file(paramfile)
    k_half_ny = 0.5 * np.pi * ps["Nmesh"] / (box / 1000.0)
    low = inrun[:, 0] < k_half_ny

    def pk_off(flag):
        got = np.loadtxt(os.path.join(dirs[flag], "output", inrun_name))
        check(np.array_equal(got[:, 2], inrun[:, 2]),
              f"RestartFlag {flag}'s P(k) bins differ from the in-run's")
        return np.abs(got[:, 1] / inrun[:, 1] - 1)

    r4 = pk_off("4")
    r2, r1 = pk_off("2")[low].max(), pk_off("1")[low].max()
    acc = [ln for ln in logs["99"].splitlines()
           if ln.startswith("Force accuracy")]
    direct = [ln for ln in logs["99"].splitlines()
              if ln.startswith("Direct summation")]
    check(len(acc) == 1 and len(direct) == 1,
          f"RestartFlag 99 printed {acc} {direct}")
    stats = {k: float(v) for k, v in
             (kv.split("=") for kv in acc[0].split(":")[1].split())}
    print(f"RestartFlags 1, 2, 4, 99 through the CLI on {src}, four "
          f"processes at once: {seconds:.6f} s; flag 2 (from PART_001) "
          f"and flag 1 (Snapshots.txt cut to PART_001) reached a = "
          f"{a_end:g}: PART_002's positions against the uninterrupted "
          f"run's (largest, 99th percentile) {d2[0]:.3e}, {d2[1]:.3e} / "
          f"{d1[0]:.3e}, {d1[1]:.3e} of the box, against each other "
          f"{d12[0]:.3e}, {d12[1]:.3e}; their P(k) at a = {a_end:g} "
          f"against the uninterrupted run's {r2:.3e} / {r1:.3e} below half "
          f"the Nyquist k; flag 4 on PART_{snapnum:03d} against the in-run "
          f"{inrun_name}: largest relative difference {r4[low].max():.3e} "
          f"below half the Nyquist k ({low.sum()} bins; "
          f"{r4.max():.3e} over all {len(r4)}); flag 99 on "
          f"PART_{snapnum:03d}: {acc[0]}; {direct[0]}", flush=True)
    check(r4[low].max() <= FLAG4_PK_RTOL and max(r1, r2) <= FLAG4_PK_RTOL,
          f"RestartFlag 4's, 2's and 1's P(k) off the in-run P(k) by "
          f"{r4[low].max():.3e}, {r2:.3e}, {r1:.3e}")
    check(max(d1[1], d2[1], d12[1]) <= RESUME_POS_TOL,
          f"resumed runs' positions off by {d2[1]:.3e}, {d1[1]:.3e}, "
          f"{d12[1]:.3e} of the box (99th percentile)")
    check(stats["mean"] < GRAVITY_TEST_LIMITS["mean_rel_err"]
          and stats["p99"] < GRAVITY_TEST_LIMITS["p99_rel_err"],
          f"RestartFlag 99 statistics {stats} above {GRAVITY_TEST_LIMITS}")
    direct_s = float(direct[0].rsplit(",", 1)[1].split()[0])
    return dict(seconds=seconds, flag2=d2, flag1=d1, flag12=d12,
                direct_seconds=direct_s,
                flag2_pk=float(r2), flag1_pk=float(r1),
                flag4=float(r4[low].max()), flag99=stats)


def parity_pk(outdir):
    """{file name: (k, P, N) rows} of a run's power spectra."""
    import numpy as np
    return {f: np.loadtxt(os.path.join(outdir, f), ndmin=2)[:, :3]
            for f in sorted(os.listdir(outdir))
            if f.startswith("powerspectrum-")}


def pk_diff(a, b):
    """The largest relative difference of P over the runs' common files;
    fails unless both hold the same files, mode counts and k."""
    import numpy as np
    check(sorted(a) == sorted(b), f"power spectra {sorted(a)} / {sorted(b)}")
    worst = 0.0
    for f in a:
        check(np.array_equal(a[f][:, 2], b[f][:, 2])
              and np.allclose(a[f][:, 0], b[f][:, 0], rtol=1e-5, atol=0),
              f"{f}: modes or k differ")
        worst = max(worst, float(np.abs(a[f][:, 1] / b[f][:, 1] - 1).max()))
    return worst


def parity_phase(workdir, device="cuda"):
    """The committed reduced dm-small IC (tests/torch_parity/IC, Ngrid 24)
    run twice on the card with dm-small's paramfile at Nmesh 48 to a =
    0.25: each run's power spectra and PIGs against the JAX package's
    (tests/torch_parity/jax_outputs.json, from the same IC on the CPU) and
    against each other, P within PARITY_PK_RTOL bin by bin, the same
    group counts, lengths and masses (1e-5)."""
    import numpy as np
    with open(os.path.join(PARITY_DIR, "jax_outputs.json")) as fh:
        jax_out = json.load(fh)
    want = {f: np.asarray(v)[:, :3] for f, v in jax_out["powerspectra"].items()}
    runs = []
    for i in (1, 2):
        res = dm_variant(os.path.join(workdir, f"parity{i}"), device,
                         ic=os.path.join(PARITY_DIR, "IC"),
                         gadget_over={"Nmesh": PARITY_NMESH})
        res["pk"] = parity_pk(res["out"])
        res["pigs"] = {}
        for name in sorted(f for f in os.listdir(res["out"])
                           if f.startswith("PIG_")):
            from mpgadget_tpu_torch.io.bigfile import BigFile
            bf = BigFile(os.path.join(res["out"], name))
            mass = bf.open("FOFGroups/Mass").read()
            lbt = bf.open("FOFGroups/LengthByType").read()
            res["pigs"][name] = (sorted(int(x) for x in lbt.sum(axis=1)),
                                 np.sort(mass.astype(np.float64)))
        runs.append(res)
    spread = pk_diff(runs[0]["pk"], runs[1]["pk"])
    to_jax = [pk_diff(r["pk"], want) for r in runs]
    for r in runs:
        check(sorted(r["pigs"]) == sorted(jax_out["pigs"]),
              f"PIGs {sorted(r['pigs'])}")
        for name, w in jax_out["pigs"].items():
            lengths, mass = r["pigs"][name]
            check(lengths == w["lengths"] and np.allclose(
                mass, w["masses"], rtol=1e-5, atol=0),
                f"{name}: groups {lengths} against the JAX package's "
                f"{w['lengths']}")
    print(f"parity (tests/torch_parity/IC, 24^3, Nmesh {PARITY_NMESH}, to "
          f"a={runs[0]['sim'].atime:.6f}): {len(want)} power spectra, "
          f"PIGs {[len(v['lengths']) for v in jax_out['pigs'].values()]} "
          f"groups; two card runs {runs[0]['seconds']:.6f} / "
          f"{runs[1]['seconds']:.6f} s; P(k) card against card (the "
          f"run-to-run spread) {spread:.3e}, card against the JAX package "
          f"on the CPU {to_jax[0]:.3e} / {to_jax[1]:.3e} (rtol "
          f"{PARITY_PK_RTOL:g})", flush=True)
    check(spread <= PARITY_PK_RTOL,
          f"two card runs' P(k) differ by {spread:.3e}")
    check(max(to_jax) <= PARITY_PK_RTOL,
          f"the card's P(k) differs from the JAX package's by {max(to_jax)}")
    return dict(runs=runs, spread=spread, to_jax=to_jax)


# -- the gas phase: examples/star-small without its subgrid physics ------

GAS_SWITCHES_OFF = {"CoolingOn": 0, "StarformationOn": 0, "BlackHoleOn": 0,
                    "WindOn": 0, "MetalReturnOn": 0}
GAS_STEPS = None      # PM steps of the star-small run (None: to TimeMax)
GAS_TIME_MAX = 0.15   # the depth cut (as shipped 0.2: 152 PM steps; to
                      # 0.15 36 of them)
MOMENTUM_TOL = 1e-4   # |sum m a_hydro| / sum m |a_hydro|
# the IC's SPH density, volume-weighted (sum m / sum m/rho), against the
# mean baryon density Omega_b rho_crit.  star-small's IC (z = 9, a 5
# Mpc/h box, 156 kpc/h between particles) is already nonlinear at the
# kernel's scale: its particle mean lies ~40% above, by the density's
# variance, and SPH volumes m/rho do not tile the box exactly there; a
# wrong unit (a^3, h, the box) would miss by far more than 10%.  The
# bigger IC (dm-small's box with gas, 1 Mpc/h between particles) is near
# linear and is held to 3%.
IC_RHO_TOL = {"star-small": 0.10, "dm-small": 0.03}
# P(k) growth against D1^2 on the linear scales only: dm-small's six
# lowest-k bins end at 0.6 h/Mpc, star-small's (a 5 Mpc/h box) reach 7.5
# h/Mpc, where the growth from z = 9 to 4 is nonlinear (4.4-6.0 against
# D1^2's 3.55 in this PR's first full run on the card); its bins up to 3
# h/Mpc are held to the same rtol 0.18
GAS_PK_KMAX = 3.0
SPH_TOL = 1e-5        # K4, K5 against their plain versions, by norm
MAXSIG_TOL = 1e-6     # K5's maxsig: a max of the same pair terms (and
                      # bit for bit besides)
# FP32 operations per (target, source) pair, counted from the kernels (a
# division or square root counted as one): a pair that counts (u < 1 for
# K4; r < H_i or r < H_j for K5) and one that does not (its distance
# and the decision)
DENSITY_PAIR_OPS = 116
DENSITY_DISTANCE_OPS = 17
HYDRO_PAIR_OPS = 165
HYDRO_DISTANCE_OPS = 19
# bytes per particle read (src, tgt, valid) and per target written
DENSITY_PARTICLE_BYTES = (32 + 16 + 1, 36)
HYDRO_PARTICLE_BYTES = (64 + 32 + 1, 20)


def paramfile_copy(src, dst, over):
    """Copy a paramfile with the parameters in `over` replaced."""
    with open(src) as fh:
        lines = [ln for ln in fh.read().splitlines()
                 if ln.split("=")[0].strip() not in over]
    with open(dst, "w") as fh:
        fh.write("\n".join(lines + [f"{k} = {v}" for k, v in over.items()])
                 + "\n")
    return dst


def run_cli(module, args, workdir, what):
    """python -m <module> <args> in workdir with the checkout on the path;
    fails the smoke if it fails.  Returns its seconds."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", module, *args], cwd=workdir,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    check(out.returncode == 0, f"{what} failed: "
          + (out.stdout + out.stderr)[-2000:])
    return time.perf_counter() - t0


def gas_genic(workdir, example, over, device="cuda"):
    """examples/<example>/paramfile.genic with `over` written into a copy
    in workdir, through the port's genic CLI (on the CPU the function it
    calls); checks the gas + DM IC's header, IDs and masses.  Returns
    (IC path, particles per species, seconds)."""
    import numpy as np
    from mpgadget_tpu_torch.cosmology import Cosmology
    from mpgadget_tpu_torch.genic.main import run_genic
    from mpgadget_tpu_torch.io.bigfile import BigFile
    from mpgadget_tpu_torch.io import snapshot as snap_io
    from mpgadget_tpu_torch.params import create_genic_parameter_set
    from mpgadget_tpu_torch.utils import get_unitsystem

    paramfile = paramfile_copy(
        os.path.join(HERE, "examples", example, "paramfile.genic"),
        os.path.join(workdir, "paramfile.genic"), over)
    ps = create_genic_parameter_set()
    ps.parse_file(paramfile)
    t0 = time.perf_counter()
    if device == "cuda":
        run_cli("mpgadget_tpu_torch.genic.main", [paramfile], workdir,
                f"{example} genic CLI")
    else:
        cwd = os.getcwd()
        os.chdir(workdir)
        try:
            run_genic(ps, device=device)
        finally:
            os.chdir(cwd)
    seconds = time.perf_counter() - t0
    path = os.path.join(workdir, ps["OutputDir"], ps["FileBase"])
    bf = BigFile(path)
    hdr = snap_io.read_header(bf)
    n = ps["Ngrid"] ** 3
    check(list(np.asarray(hdr.TotNumPart, np.int64)) == [n, n, 0, 0, 0, 0],
          f"{example} IC TotNumPart {hdr.TotNumPart}")
    units = get_unitsystem(hdr.UnitLength_in_cm, hdr.UnitMass_in_g,
                           hdr.UnitVelocity_in_cm_per_s)
    cp = Cosmology(Omega0=ps["Omega0"], OmegaBaryon=ps["OmegaBaryon"],
                   OmegaLambda=ps["OmegaLambda"],
                   HubbleParam=ps["HubbleParam"],
                   TimeBegin=hdr.Time).init_units(units)
    vol = ps["BoxSize"] ** 3
    pids = []
    for t, omega in ((0, cp.OmegaBaryon), (1, cp.Omega0 - cp.OmegaBaryon)):
        sp = snap_io.read_species(bf, t, hdr)
        want = omega * cp.RhoCrit * vol / n
        check(len(sp["pid"]) == n and np.allclose(sp["mass"], want,
                                                  rtol=1e-5, atol=0),
              f"{example} IC type {t} masses {sp['mass'][:1]} vs {want}")
        check(np.isfinite(sp["pos"]).all() and np.isfinite(sp["vel"]).all(),
              f"{example} IC type {t} positions/velocities")
        pids.append(sp["pid"])
    check(len(np.unique(np.concatenate(pids))) == 2 * n,
          f"{example} IC IDs are not unique")
    print(f"genic {example} (Ngrid {ps['Ngrid']}, ProduceGas 1, BoxSize "
          f"{ps['BoxSize']:g} kpc/h, z={ps['Redshift']:g}; cuts {over}): "
          f"{seconds:.6f} s on {device}; {n} gas + {n} DM particles",
          flush=True)
    return path, n, seconds


class SphSpy:
    """Wraps sph.density.sph_density and the two pair-sum entry points
    (density_sums, hydro_sums) and sph.hydra.hydro_force: checks every
    density solve's neighbour numbers and every hydro call's momentum,
    counts bisection passes and keeps pair-sum inputs: K5's last call
    (the run's final gas state) and K4's first pass of the last solve
    that targets every gas particle (its later passes list only the
    unconverged groups)."""

    def __init__(self, device):
        from mpgadget_tpu_torch.sph import density, hydra
        self.mods = (density, hydra)
        self.device = device
        self.solves = []       # (passes, unconverged, targets, worst dev)
        self.momentum = []     # |sum m a| / sum m |a| per hydro call
        self.last = {}
        self.real = {}
        self._targets = None     # targets of the solve in progress

    def __enter__(self):
        import torch
        density, hydra = self.mods
        self.real = dict(sph_density=density.sph_density,
                         density_sums=density.density_sums,
                         hydro_force=hydra.hydro_force,
                         hydro_sums=hydra.hydro_sums)

        def sph_density(ipos, mass, valid_gas, hsml, vel, velpred, entvar,
                        par, boxsize, update_hsml=True, **kw):
            tm = kw.get("target_mask")
            tgt = valid_gas if tm is None else valid_gas & tm
            self._targets = (int(tgt.sum()), int(valid_gas.sum()))
            res = self.real["sph_density"](
                ipos, mass, valid_gas, hsml, vel, velpred, entvar, par,
                boxsize, update_hsml=update_hsml, **kw)
            if update_hsml:
                dev = (res["numngb"] - par.desnumngb).abs()
                worst = float(torch.where(tgt, dev, 0.0).max())
                self.solves.append((res["iterations"], res["unconverged"],
                                    int(tgt.sum()), worst,
                                    par.max_ngb_deviation))
            return res

        def hydro_force(ipos, mass, valid_gas, *a, **kw):
            res = self.real["hydro_force"](ipos, mass, valid_gas, *a, **kw)
            m = torch.where(valid_gas, mass, 0.0)[:, None].double()
            ma = m * res["hydro_accel"].double()
            self.momentum.append(float(
                ma.sum(dim=0).norm() / ma.norm(dim=1).sum().clamp(
                    min=1e-300)))
            return res

        def keep(name):
            def fn(*a, **kw):
                if name == "hydro_sums":
                    self.last[name] = (a, kw)
                elif self._targets is not None:
                    if self._targets[0] == self._targets[1]:
                        self.last[name] = (a, kw)
                    self._targets = None        # later passes: not kept
                return self.real[name](*a, **kw)
            return fn

        density.sph_density = sph_density
        hydra.hydro_force = hydro_force
        density.density_sums = keep("density_sums")
        hydra.hydro_sums = keep("hydro_sums")
        return self

    def __exit__(self, *exc):
        density, hydra = self.mods
        density.sph_density = self.real["sph_density"]
        density.density_sums = self.real["density_sums"]
        hydra.hydro_force = self.real["hydro_force"]
        hydra.hydro_sums = self.real["hydro_sums"]
        return False

    def check(self, what):
        bad = [s for s in self.solves if s[1] or s[3] > s[4]]
        passes = [s[0] for s in self.solves]
        print(f"{what}: {len(self.solves)} density solves, bisection passes "
              f"per solve {passes} (targets {[s[2] for s in self.solves]}), "
              f"largest |numngb - DesNumNgb| {max(s[3] for s in self.solves):.6f}"
              f" (MaxNumNgbDeviation {self.solves[0][4]:g}); "
              f"{len(self.momentum)} hydro calls, largest |sum m a_hydro| / "
              f"sum m |a_hydro| {max(self.momentum):.6e} (tol "
              f"{MOMENTUM_TOL:g})", flush=True)
        check(not bad, f"{what}: density solves with targets outside "
              f"DesNumNgb +- dev (passes, unconverged at max_iter, targets, "
              f"worst deviation, dev): {bad}")
        check(max(self.momentum) < MOMENTUM_TOL, f"{what}: hydro force "
              f"does not conserve momentum: {max(self.momentum):.3e}")


def gas_run_phase(workdir, device="cuda", max_steps=GAS_STEPS, ngrid=None,
                  nmesh=None):
    """examples/star-small from its own two paramfiles, without its
    subgrid physics: genic (GENIC_OVERRIDE) through the CLI, then
    paramfile.gadget with GAS_SWITCHES_OFF written into a copy ->
    build_simulation -> Simulation.run() (hierarchical, a snapshot and a
    PIG at each output) -> write_snapshot, K1-K5's launch counts reset
    just before and read just after.  Checks: every density solve's
    targets within DesNumNgb +- MaxNumNgbDeviation; every hydro call's
    momentum; the IC's mean SPH density against Omega_b rho_crit; the
    entropy floor; the growth of P(k) against D1^2; each snapshot's gas
    blocks and each PIG read back.  Returns the measurements and the
    simulation."""
    import numpy as np
    import torch
    from mpgadget_tpu_torch.gravity import pairkernel as pk
    from mpgadget_tpu_torch.gravity import treewalk as tw
    from mpgadget_tpu_torch.gravity.treepm import StageTimer
    from mpgadget_tpu_torch.io.bigfile import BigFile
    from mpgadget_tpu_torch.io import snapshot as snap_io
    from mpgadget_tpu_torch.main import build_simulation
    from mpgadget_tpu_torch.ops import pairs
    from mpgadget_tpu_torch.sph import density, hydra
    from mpgadget_tpu_torch.utils.constants import GAMMA_MINUS1

    over = dict(GENIC_OVERRIDE)
    if ngrid is not None:           # a smaller rehearsal on the CPU
        over["Ngrid"] = ngrid
    _, ngas, genic_s = gas_genic(workdir, "star-small", over, device)
    gover = dict(GAS_SWITCHES_OFF, TimeMax=GAS_TIME_MAX)
    if nmesh is not None:
        gover["Nmesh"] = nmesh
    paramfile = paramfile_copy(
        os.path.join(HERE, "examples", "star-small", "paramfile.gadget"),
        os.path.join(workdir, "paramfile.gadget"), gover)
    cwd = os.getcwd()
    os.chdir(workdir)
    first = {}
    try:
        sim, _ = build_simulation(paramfile, device=device)
        c = sim.cfg
        check(c.hydro_on and c.density_independent_sph
              and c.split_gravity_timesteps and c.snapshot_with_fof,
              "star-small's paramfile.gadget no longer sets HydroOn, "
              "DensityIndependentSphOn, SplitGravityTimestepsOn and "
              "SnapshotWithFOF")
        out = os.path.abspath(c.output_dir)
        real_hydro = sim.compute_hydro

        def first_hydro(*a, **k):
            real_hydro(*a, **k)
            if not first:
                gas = sim.gas_mask
                rho = sim.sph.density[gas].double()
                m = sim.pdata.mass[gas].double()
                first["rho"] = float(rho.mean())
                # the mass over the particles' SPH volumes m / rho: the
                # volume-weighted mean (the particle mean is weighted by
                # mass, so above it by the variance of the density)
                first["rho_vol"] = float(m.sum() / (m / rho).sum())
        sim.compute_hydro = first_hydro
        sim.tree_timer = StageTimer()
        step_seconds = []
        run_step = sim.step_hierarchical

        def timed_step(dti):
            if device == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            n_sub = run_step(dti)
            if device == "cuda":
                torch.cuda.synchronize()
            step_seconds.append(time.perf_counter() - t0)
            return n_sub

        sim.step_hierarchical = timed_step
        for mod in (pk, tw, pairs, density, hydra):
            mod.LAUNCHES = 0
        t0 = time.perf_counter()
        with SphSpy(device) as spy:
            nsteps = sim.run(max_steps=max_steps, verbose=True)
            snap = os.path.abspath(sim.write_snapshot())
            if device == "cuda":
                torch.cuda.synchronize()
        run_seconds = time.perf_counter() - t0
        launches = {"pair": pk.LAUNCHES, "walk": tw.LAUNCHES,
                    "neighbors": pairs.LAUNCHES, "density": density.LAUNCHES,
                    "hydro": hydra.LAUNCHES}
    finally:
        os.chdir(cwd)

    check(nsteps == max_steps or sim.ti_current == sim.timeline.ti_end,
          f"star-small ran {nsteps} PM steps to a={sim.atime}")
    spy.check("star-small")
    n_solves = len(spy.solves)
    if device == "cuda":
        check(launches["density"] >= n_solves and launches["hydro"]
              >= len(spy.momentum) and min(launches.values()) > 0,
              f"a kernel of the gas path was not launched: {launches}")
    for i, (log, sec) in enumerate(zip(sim.step_log, step_seconds)):
        hist = {b: cnt for b, cnt in enumerate(log["bins"]) if cnt}
        print(f"star-small PM step {i + 1}: {sec:.6f} s, {log['n_sub']} "
              f"substeps, bins {hist}, closing targets {log['actives']}",
              flush=True)
    pd = sim.pdata
    gas = sim.gas_mask
    check(int(pd.valid.sum()) == 2 * ngas and int(gas.sum()) == ngas,
          "particles lost")
    sph = sim.sph
    check(bool(torch.isfinite(pd.vel[pd.valid]).all()
               & torch.isfinite(sph.entropy[gas]).all()
               & torch.isfinite(sph.hydro_accel[gas]).all()
               & (sph.entropy[gas] > 0).all()),
          "gas state not finite or entropy not positive")
    # IC: mean comoving SPH density against the mean baryon density
    want = sim.CP.OmegaBaryon * sim.CP.RhoCrit
    rho_err = first["rho_vol"] / want - 1
    # the entropy floor (MinGasTemp), as the kicks apply it
    a3 = sim.atime ** 3
    minent = GAMMA_MINUS1 * sim._min_egy_spec / torch.clamp(
        sph.density / a3, min=1e-30) ** GAMMA_MINUS1
    floor_ratio = float((sph.entropy[gas] / minent[gas]).min())
    print(f"star-small IC: SPH density, volume-weighted mean (sum m / sum "
          f"m/rho) {first['rho_vol']:.9g} against Omega_b rho_crit "
          f"{want:.9g}: {rho_err:+.6f} (particle mean {first['rho']:.9g}); "
          f"final state: least entropy / floor {floor_ratio:.6f}",
          flush=True)
    check(abs(rho_err) < IC_RHO_TOL["star-small"], f"IC mean SPH density off "
          f"Omega_b rho_crit by {rho_err:+.4f}")
    check(floor_ratio >= 1.0, f"entropy below the MinGasTemp floor "
          f"({floor_ratio:.6f})")
    # every snapshot's gas blocks read back
    snaps = sorted(f for f in os.listdir(out) if f.startswith("PART_"))
    for name in snaps:
        bf = BigFile(os.path.join(out, name))
        hdr = snap_io.read_header(bf)
        check(int(hdr.TotNumPart[0]) == ngas, f"{name}: gas count")
        for block in ("Density", "SmoothingLength", "InternalEnergy",
                      "EgyWtDensity"):
            v = bf.open(f"0/{block}").read()
            check(len(v) == ngas and np.isfinite(v).all() and (v > 0).all(),
                  f"{name}: 0/{block} does not read back")
    pigs = sorted(f for f in os.listdir(out) if f.startswith("PIG_"))
    check(len(pigs) == sim.snapshot_count - 1 >= 1,
          f"star-small PIGs written: {pigs}")
    pig_groups = {}
    for name in pigs:
        ng, bins, last = pig_check(os.path.join(out, name),
                                   sim.cfg.fof_min_group_length)
        pig_groups[name] = ng
        print(f"{name}: read back and consistent; {ng} groups; halos per "
              f"log10(M/Msun) bin {bins}; largest {last:.6e} Msun",
              flush=True)
    files = sorted(f for f in os.listdir(out)
                   if f.startswith("powerspectrum-"))
    check(len(files) >= 2, f"power spectra written: {files}")
    kk, pk0, d0 = read_power(os.path.join(out, files[0]))
    kk1, pk1, d1 = read_power(os.path.join(out, files[-1]))
    nbins = min(6, len(kk))
    growth = np.interp(kk[:nbins], kk1, pk1) / pk0[:nbins]
    want_g = (d1 / d0) ** 2
    lin = kk[:nbins] <= GAS_PK_KMAX
    check(lin.sum() >= 2, f"star-small: fewer than two P(k) bins below "
          f"k = {GAS_PK_KMAX}")
    growth_err = float(np.max(np.abs(growth[lin] / want_g - 1)))
    print(f"star-small matter P(k) growth {files[0]} -> {files[-1]} over "
          f"{nbins} lowest-k bins k={kk[:nbins].tolist()}: {growth.tolist()}"
          f" against D1^2 ratio {want_g:.6f}; largest deviation at k <= "
          f"{GAS_PK_KMAX} h/Mpc ({int(lin.sum())} bins) {growth_err:.6f} "
          f"(rtol 0.18)", flush=True)
    check(growth_err <= 0.18, f"star-small P(k) growth off D1^2 by "
          f"{growth_err:.3f}")
    wt = dict(sim.walltime.totals)
    return dict(nsteps=nsteps, atime=sim.atime, launches=launches,
                step_seconds=step_seconds, run_seconds=run_seconds,
                genic_seconds=genic_s, walltime=wt, spy=spy,
                n_solves=n_solves, passes=[s[0] for s in spy.solves],
                rho_err=rho_err, floor_ratio=floor_ratio,
                momentum=max(spy.momentum), growth_err=growth_err,
                snapshots=snaps, pig_groups=pig_groups, sim=sim,
                stages=dict(sim.tree_timer.seconds), ngas=ngas,
                paramfile=paramfile,
                snapnum=int(os.path.basename(snap).split("_")[-1]))


def sph_stream_shape():
    """K4's and K5's CTA shape as csrc/sph_stream.cuh fixes it: (warps on
    a group, list entries a segment, sources a tile)."""
    import re
    from mpgadget_tpu_torch import kernels
    text = (kernels.CSRC / "sph_stream.cuh").read_text()
    warps = int(re.search(r"constexpr int WARPS = (\d+);", text).group(1))
    tile = int(re.search(r"constexpr int TILE = (\d+);", text).group(1))
    return warps, warps * 32, tile


def sph_critical_paths(tree, nbr, which):
    """The longest group's chain of dependent global loads in K4 (which
    "density") or K5 ("hydro"): (the redesign's, the first design's).
    Both begin with group_nodes -> the node's pstart/pcount -> the target
    rows (3 loads).  The first design then takes list[l] -> the leaf's
    pstart/pcount -> its rows, leaf after leaf, and one load more for
    every further 32 particles of a leaf.  The redesign takes list ->
    pstart/pcount once a segment, then the tiles of its busiest warp, one
    in flight ahead of the one computed: a load a tile (K5: two, the
    staged rows, then the first counted pair's body rows)."""
    import torch
    warps, seg, tile = sph_stream_shape()
    ng, LL = nbr.leaf_idx.shape
    nl = nbr.n_leaves.long()
    listed = torch.arange(LL, device=nl.device)[None, :] < nl[:, None]
    leaf = torch.clamp(nbr.leaf_idx.long(), 0, tree.capacity - 1)
    pc = torch.where(listed, tree.pcount[leaf], 0)
    simple = 3 + 2 * nl + ((pc + 31) // 32).sum(dim=1)
    nseg = (LL + seg - 1) // seg
    tot = torch.nn.functional.pad(pc, (0, nseg * seg - LL)).view(
        ng, nseg, seg).sum(dim=2)
    present = torch.arange(nseg, device=nl.device)[None, :] * seg \
        < nl[:, None]
    per_tile = 1 if which == "density" else 2
    busiest = ((tot + tile - 1) // tile + warps - 1) // warps
    new = 3 + torch.where(present, 2 + per_tile * busiest, 0).sum(dim=1)
    return int(new.max()), int(simple.max())


def simple_sums(which, args):
    """One launch of the first design of K4 (which "density",
    csrc/sph_density_simple.cu) or K5 ("hydro", csrc/sph_hydro_simple.cu)
    on a wrapper's arguments: the wrapper's checks and output, its entry
    point swapped for the yardstick's for this call; its launch count is
    left as it was."""
    import ctypes
    from mpgadget_tpu_torch import kernels
    from mpgadget_tpu_torch.sph import density, hydra

    mod = density if which == "density" else hydra
    kern = mod.density_kernel if which == "density" else mod.hydro_kernel
    name = f"sph_{which}_simple"
    fn = getattr(kernels.load(name), f"{name}_f32")
    fn.restype = ctypes.c_int
    fn.argtypes = mod._kernel().argtypes
    real, launches = mod._fn, mod.LAUNCHES
    mod._fn = fn
    try:
        return kern(*args)
    finally:
        mod._fn, mod.LAUNCHES = real, launches


def sph_errors(name, which, got, ref):
    """K4's or K5's outputs against the plain version's: the relative
    error by norm of each column and the largest absolute error; fails
    unless K5's maxsig is -inf at the same rows and equal bit for bit."""
    import torch
    from mpgadget_tpu_torch.sph import density, hydra

    names = (density if which == "density" else hydra).OUTPUTS
    rels = {}
    abs_err = 0.0
    for i, k in enumerate(names):
        x, y = got[:, i], ref[:, i]
        if k == "maxsig":
            fx, fy = torch.isfinite(x), torch.isfinite(y)
            check(bool(torch.equal(fx, fy)), f"{name}: maxsig -inf rows "
                  "differ from the plain version's")
            check(bool(torch.equal(x, y)), f"{name}: maxsig differs from "
                  "the plain version's in some bit")
            x, y = x[fx], y[fy]
        rels[k] = rel_norm(x.double(), y.double())
        abs_err = max(abs_err, float((x - y).abs().max()) if x.numel()
                      else 0.0)
    tol = {k: (MAXSIG_TOL if k == "maxsig" else SPH_TOL) for k in names}
    return rels, abs_err, {k: v for k, v in rels.items() if not v <= tol[k]}


def sph_kernel_case(name, which, args, G, l2_ns, reps=20):
    """K4 (which "density") or K5 ("hydro") on the inputs of one of its
    calls (tree, nbr, src, tgt, valid, ...) against its plain version on
    the card: outputs by norm within SPH_TOL (K5's maxsig within
    MAXSIG_TOL and bit for bit, -inf at the same rows), two launches
    bit-identical; the first design (simple_sums) held to the same; device
    times of the three (the two designs by CUDA graph replays, in turns:
    first, new, new, first), the pair counts, the bound and both designs'
    critical paths."""
    import torch
    from mpgadget_tpu_torch.ops import pairs
    from mpgadget_tpu_torch.sph import density, hydra

    mod = density if which == "density" else hydra
    kern = mod.density_kernel if which == "density" else mod.hydro_kernel
    plain = (mod.density_sums_reference if which == "density"
             else mod.hydro_sums_reference)
    tree, nbr, src, tgt, valid = args[:5]
    rest = args[5:]
    a = kern(*args)
    b = kern(*args)
    first = simple_sums(which, args)
    torch.cuda.synchronize()
    ref = plain(*args)
    torch.cuda.synchronize()
    same_bits = bool(torch.equal(a, b))
    check(same_bits, f"{name}: two launches of {which} kernel differ")
    rels, abs_err, bad = sph_errors(name, which, a, ref)
    first_rels, _, first_bad = sph_errors(f"{name} (first design)", which,
                                          first, ref)
    # the pair counts this run's data needs
    n = src.shape[0]
    gn = torch.clamp(nbr.group_nodes, max=tree.capacity - 1)
    tpc = torch.clamp(tree.pcount[gn], max=G)
    LL = nbr.leaf_idx.shape[1]
    listed = torch.arange(LL, device=gn.device)[None, :] \
        < nbr.n_leaves[:, None].long()
    leaf = torch.clamp(nbr.leaf_idx.long(), max=tree.capacity - 1)
    lsrc = torch.where(listed, tree.pcount[leaf], 0).sum(dim=1)
    total = int((tpc * lsrc).sum())
    n_listed = int(nbr.n_leaves.long().sum())
    le = max(1, int(tree.pcount[tree.is_leaf].max()))
    if which == "density":
        # pairs inside H: the plain engine counts them
        def fn(dx, r, tm, sm, tf, sf):
            return {"c": ((r * tf["hinv"] < 1.0) & sf["ok"]).float()}
        hinv = 1.0 / torch.clamp(tgt[:, 0], min=1e-30)
        within = int(pairs.pair_reduce(
            fn, nbr, tree, src[:, :3].contiguous(), {"hinv": hinv},
            {"ok": valid.bool()}, {"c": "sum"}, G, le)["c"].sum())
        ops = within * DENSITY_PAIR_OPS \
            + (total - within) * DENSITY_DISTANCE_OPS
        pb = DENSITY_PARTICLE_BYTES
    else:
        L = rest[1][0]
        def fn(dx, r, tm, sm, tf, sf):
            ri = r * L
            return {"c": (((ri < tf["h"]) | (ri < sf["h"])) & (ri > 0)
                          & sf["ok"]).float()}
        within = int(pairs.pair_reduce(
            fn, nbr, tree, src[:, :3].contiguous(), {"h": src[:, 7]},
            {"h": src[:, 7], "ok": valid.bool()}, {"c": "sum"}, G,
            le)["c"].sum())
        ops = within * HYDRO_PAIR_OPS + (total - within) * HYDRO_DISTANCE_OPS
        pb = HYDRO_PARTICLE_BYTES
    nbytes = (n * (pb[0] + pb[1]) + n_listed * 4 + nbr.n_leaves.shape[0] * 12
              + tree.capacity * 16)
    bound_ms, bound_by = bound(ops, nbytes)
    path, simple_path = sph_critical_paths(tree, nbr, which)
    # graph replays, so that the host's time to enqueue the wrapper's
    # call does not count
    turns = [graph_ms(lambda: simple_sums(which, args), reps),
             graph_ms(lambda: kern(*args), reps),
             graph_ms(lambda: kern(*args), reps),
             graph_ms(lambda: simple_sums(which, args), reps)]
    ms = 0.5 * (turns[1] + turns[2])
    simple_ms = 0.5 * (turns[0] + turns[3])
    plain_ms = time_ms(lambda: plain(*args), 2)
    path_ms = path * l2_ns * 1e-6
    simple_path_ms = simple_path * l2_ns * 1e-6
    print(f"kernel {which} ({name}): {nbr.n_leaves.shape[0]} groups, "
          f"{n_listed} listed leaves, {total} pairs evaluated, {within} "
          f"count; rel err by norm " + ", ".join(
              f"{k} {v:.3e}" for k, v in rels.items())
          + f" (tol {SPH_TOL:g}, maxsig {MAXSIG_TOL:g} and bit for bit); "
          f"max_abs_err {abs_err:.6e}; two launches bit-identical "
          f"{same_bits}; the first design's rel err " + ", ".join(
              f"{k} {v:.3e}" for k, v in first_rels.items())
          + f"; kernel_ms={ms:.6f} simple_ms={simple_ms:.6f} (turns "
          + " ".join(f"{t:.6f}" for t in turns) + f") plain_ms="
          f"{plain_ms:.6f} bound_ms={bound_ms:.6f} ({bound_by}); critical "
          f"path {path_ms:.6f} ms (longest group {path} dependent loads x "
          f"{l2_ns:.3f} ns), the first design's {simple_path_ms:.6f} ms "
          f"({simple_path} loads)", flush=True)
    check(not bad, f"{name}: {which} kernel disagrees with its plain "
          f"version: {bad}")
    check(not first_bad, f"{name}: the first design of the {which} kernel "
          f"disagrees with its plain version: {first_bad}")
    return dict(ms=ms, simple_ms=simple_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=abs_err,
                rel=rels, pairs=total, within=within,
                groups=nbr.n_leaves.shape[0], listed=n_listed,
                path_ms=path_ms, simple_path_ms=simple_path_ms,
                path_loads=path, simple_path_loads=simple_path)


def big_gas_case(workdir, l2_ns):
    """A bigger IC for K4 and K5: dm-small's paramfile.genic with
    ProduceGas 1 (2 x 64^3), one density solve from the initial hsml
    guess (setup_gas's) and one hydro call with unit entropy; the last
    pair-sum inputs of each, held to the plain versions."""
    import numpy as np
    import torch
    from mpgadget_tpu_torch.io.bigfile import BigFile
    from mpgadget_tpu_torch.io import snapshot as snap_io
    from mpgadget_tpu_torch.particles import pos_to_fixed
    from mpgadget_tpu_torch.sph import density, hydra

    over = dict(GENIC_OVERRIDE, ProduceGas=1)
    path, n, _ = gas_genic(workdir, "dm-small", over)
    bf = BigFile(path)
    hdr = snap_io.read_header(bf)
    sp = snap_io.read_species(bf, 0, hdr)
    box = hdr.BoxSize
    dev = torch.device("cuda")
    ipos = torch.as_tensor(pos_to_fixed(sp["pos"], box).astype(np.int64),
                           device=dev)
    mass = torch.as_tensor(sp["mass"], dtype=torch.float32, device=dev)
    vel = torch.as_tensor(sp["vel"], dtype=torch.float32, device=dev)
    gas = torch.ones(n, dtype=torch.bool, device=dev)
    hsml = torch.full((n,), float(np.float32(2.0 * box / np.cbrt(n))),
                      device=dev)
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    with SphSpy("cuda") as spy:
        t0 = time.perf_counter()
        d = density.sph_density(ipos, mass, gas, hsml, vel, vel, ones,
                                density.DensityParams(), box)
        torch.cuda.synchronize()
        dens_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        hydra.hydro_force(ipos, mass, gas, d["hsml"], vel, ones,
                          d["density"], d["egy_wt_density"], d["div_vel"],
                          d["curl_vel"], d["dhsml_egy_factor"],
                          hydra.HydroParams(), box, hdr.Time, 10.0, 0.01)
        torch.cuda.synchronize()
        hydro_s = time.perf_counter() - t0
    spy.check("dm-small with gas (2 x 64^3)")
    rho = d["density"].double()
    m = mass.double()
    rho_err = float(m.sum() / (m / rho).sum()) / float(m.sum() / box ** 3) - 1
    print(f"dm-small with gas: density solve {dens_s:.6f} s "
          f"({spy.solves[0][0]} bisection passes), hydro call "
          f"{hydro_s:.6f} s; IC SPH density, volume-weighted, against the "
          f"mean gas density (Omega_b rho_crit): {rho_err:+.6f} (particle "
          f"mean {float(rho.mean() / (m.sum() / box ** 3)) - 1:+.6f})",
          flush=True)
    check(abs(rho_err) < IC_RHO_TOL["dm-small"], f"dm-small gas IC mean SPH "
          f"density off by {rho_err:+.4f}")
    a, kw = spy.last["density_sums"]
    k4 = sph_kernel_case("dm-small 2 x 64^3 gas", "density", a, a[6], l2_ns)
    a, kw = spy.last["hydro_sums"]
    k5 = sph_kernel_case("dm-small 2 x 64^3 gas", "hydro", a,
                         a[5].group_max, l2_ns)
    return dict(k4=k4, k5=k5, density_s=dens_s, hydro_s=hydro_s,
                passes=spy.solves[0][0], n=n)


# -- lya: cooling, star formation and quick Lyman-alpha (K6) -------------

LYA_SWITCHES = {"TreeCoolFile": ""}   # the absent TREECOOL_ep_2018p: no UVB
LYA_STEPS = None      # PM steps of the lya run (None: to TimeMax)
LYA_TIME_MAX = 0.2    # the depth cut (as shipped 0.33333: 766 PM steps,
                      # 182 s; to 0.25 414 PM steps, 93 s, 390 stars; to
                      # 0.2 198 PM steps, 46 s, 95 stars)
# K6 against its plain version on the card (the CPU parity tolerances of
# tests/test_torch_cooling.py): do_cooling's u_new relative, its ne/nh
# relative and absolute; the net rate relative and of the largest |rate|;
# float64 relative
COOL_TOL = {"u": 2e-5, "ne_rel": 2e-3, "ne_abs": 2e-6, "rate": 4e-6,
            "rate_scale": 1e-7, "f64": 1e-9}
# K6's operations per particle (a transcendental, division or square root
# counted as one), counted from csrc/cooling.cu for the rate options lya
# runs (Verner96 recombination, Sherwood cooling, self-shielding on):
# one network evaluation (ne_internal: temperature 9, self-shielding 15,
# the ion network 139, the sum 5); a Steffensen iteration beside its two
# evaluations (two scalings around each, the step 11); the net rate after
# the fixed point (329); a bisection step beside the rate (8).  alphaHep
# (one call an evaluation, two in the tail) is counted with one of its two
# Verner96 fits: the kernel evaluates both and the interpolation between
# them, 17 operations (4 of them sqrt and pow) more a call, which only gas
# between 6e5 and 8e5 K needs
COOL_NE_OPS = 151
COOL_STEFF_OPS = 15
COOL_TAIL_OPS = 329
COOL_BISECT_OPS = 8
# of which exp, log, pow and sqrt: 27 an evaluation, 62 in the tail
COOL_NE_TRANSC = 27
COOL_TAIL_TRANSC = 62
# The closing terms of the net rate beside its evaluation as csrc/cooling.cu
# computes them (closing(): the rates come from the evaluation), counted for
# the same options: 86 operations, of which 9 exp, log, pow and sqrt
COOL_CLOSE_OPS = 86
COOL_CLOSE_TRANSC = 9
ROWS_PER_WARP = 8     # csrc/cooling.cu: 4 lanes a row


def cooling_work(bisect, metal=False):
    """(operations, transcendentals) per particle of one K6 call at the
    full trip counts (every iteration run, the first design's work):
    do_cooling's bisection when bisect, else one net rate; with metal, the
    metal table's lookup in every net rate (COOL_METAL_OPS)."""
    from mpgadget_tpu_torch.physics.cooling import BISECT_ITERS, NE_ITERS
    ops = NE_ITERS * (2 * COOL_NE_OPS + COOL_STEFF_OPS) + 4 + COOL_TAIL_OPS
    trans = NE_ITERS * 2 * COOL_NE_TRANSC + COOL_TAIL_TRANSC
    if metal:
        ops += COOL_METAL_OPS
        trans += COOL_METAL_TRANSC
    if bisect:
        return (BISECT_ITERS * (ops + COOL_BISECT_OPS) + 10,
                BISECT_ITERS * trans)
    return ops, trans


class CoolingSpy:
    """Wraps physics.cooling.do_cooling (run.py imports it at each call):
    counts the calls and keeps the arguments of the last call and of the
    call that listed the fewest rows (a substep's closing gas off the
    effective EOS)."""

    def __init__(self):
        from mpgadget_tpu_torch.physics import cooling
        self.mod = cooling
        self.calls = 0
        self.last = None
        self.fewest = None

    def __enter__(self):
        real = self.real = self.mod.do_cooling

        def do_cooling(*a, rows=None, **kw):
            out = real(*a, rows=rows, **kw)
            self.calls += 1
            if rows is not None:
                self.last = (a, kw, rows, int(rows.sum()))
                if self.fewest is None or self.last[3] < self.fewest[3]:
                    self.fewest = self.last
            return out

        self.mod.do_cooling = do_cooling
        return self

    def __exit__(self, *exc):
        self.mod.do_cooling = self.real
        return False


def lya_phase(workdir, device="cuda", max_steps=LYA_STEPS, ngrid=None,
              nmesh=None):
    """examples/lya from its own two paramfiles: genic (GENIC_OVERRIDE)
    through the CLI, then paramfile.gadget with LYA_SWITCHES written into a
    copy -> build_simulation -> Simulation.run() (hierarchical, a snapshot
    at each output, cooling and quick-Lyman-alpha star formation per
    closing bin, sfr.txt) -> write_snapshot, the six kernels' launch
    counts reset just before and read just after.  Checks: stars formed;
    each snapshot reads back with its type-4 blocks; no particle lost; the
    gas state finite; the entropy floor.  Returns the measurements and the
    simulation."""
    import numpy as np
    import torch
    from mpgadget_tpu_torch.gravity import pairkernel as pk
    from mpgadget_tpu_torch.gravity import treewalk as tw
    from mpgadget_tpu_torch.io.bigfile import BigFile
    from mpgadget_tpu_torch.io import snapshot as snap_io
    from mpgadget_tpu_torch.main import build_simulation
    from mpgadget_tpu_torch.ops import pairs
    from mpgadget_tpu_torch.physics import cooling
    from mpgadget_tpu_torch.sph import density, hydra
    from mpgadget_tpu_torch.utils.constants import GAMMA_MINUS1

    over = dict(GENIC_OVERRIDE)
    if ngrid is not None:           # a smaller rehearsal on the CPU
        over["Ngrid"] = ngrid
    _, ngas, genic_s = gas_genic(workdir, "lya", over, device)
    gover = dict(LYA_SWITCHES, TimeMax=LYA_TIME_MAX)
    if nmesh is not None:
        gover["Nmesh"] = nmesh
    paramfile = paramfile_copy(
        os.path.join(HERE, "examples", "lya", "paramfile.gadget"),
        os.path.join(workdir, "paramfile.gadget"), gover)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        sim, _ = build_simulation(paramfile, device=device)
        c = sim.cfg
        check(c.hydro_on and c.cooling_on and c.starformation_on
              and c.quick_lya_probability == 1 and not c.treecool_file
              and not c.density_independent_sph,
              "lya's paramfile.gadget no longer sets HydroOn, CoolingOn, "
              "StarformationOn, QuickLymanAlphaProbability 1 and "
              "DensityIndependentSphOn 0")
        out = os.path.abspath(c.output_dir)
        step_seconds = []
        name = "step_hierarchical" if c.split_gravity_timesteps else "step"
        run_step = getattr(sim, name)

        def timed_step(dti):
            if device == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run_step(dti)
            if device == "cuda":
                torch.cuda.synchronize()
            step_seconds.append(time.perf_counter() - t0)
            return res

        setattr(sim, name, timed_step)
        mods = {"pair": pk, "walk": tw, "neighbors": pairs,
                "density": density, "hydro": hydra, "cooling": cooling}
        for mod in mods.values():
            mod.LAUNCHES = 0
        t0 = time.perf_counter()
        with CoolingSpy() as spy:
            nsteps = sim.run(max_steps=max_steps, verbose=False)
            snap = os.path.abspath(sim.write_snapshot())
            if device == "cuda":
                torch.cuda.synchronize()
        run_seconds = time.perf_counter() - t0
        launches = {k: mod.LAUNCHES for k, mod in mods.items()}
    finally:
        os.chdir(cwd)

    check(nsteps == max_steps or sim.ti_current == sim.timeline.ti_end,
          f"lya ran {nsteps} PM steps to a={sim.atime}")
    if device == "cuda":
        check(min(launches.values()) > 0 and launches["cooling"]
              >= spy.calls, f"a kernel of the lya path was not launched: "
              f"{launches} ({spy.calls} cooling calls)")
    pd = sim.pdata
    gas = sim.gas_mask
    stars = pd.valid & (pd.ptype == 4)
    check(int(pd.valid.sum()) == 2 * ngas, "particles lost or spawned "
          "(quick Lyman-alpha converts whole)")
    sph = sim.sph
    check(bool(torch.isfinite(pd.vel[pd.valid]).all()
               & torch.isfinite(sph.entropy[gas]).all()
               & torch.isfinite(sph.ne[gas]).all()
               & (sph.entropy[gas] > 0).all() & (sph.ne[gas] >= 0).all()),
          "lya gas state not finite, entropy not positive or ne negative")
    a3 = sim.atime ** 3
    minent = GAMMA_MINUS1 * sim._min_egy_spec / torch.clamp(
        sph.density / a3, min=1e-30) ** GAMMA_MINUS1
    floor_ratio = float((sph.entropy[gas] / minent[gas]).min())
    check(floor_ratio >= 1.0 - 1e-6, f"lya entropy below the MinGasTemp "
          f"floor ({floor_ratio:.6f})")
    # each snapshot with its stars read back
    snaps = sorted(f for f in os.listdir(out) if f.startswith("PART_"))
    per_snap = {}
    for sname in snaps:
        bf = BigFile(os.path.join(out, sname))
        hdr = snap_io.read_header(bf)
        n4 = int(hdr.TotNumPart[4])
        check(int(hdr.TotNumPart[0]) + n4 == ngas, f"{sname}: gas + stars "
              f"{int(hdr.TotNumPart[0])} + {n4} against {ngas}")
        mstar = 0.0
        if n4:
            m = bf.open("4/Mass").read()
            for block in ("StarFormationTime", "BirthDensity", "Metallicity",
                          "Metals", "Position", "ID"):
                v = bf.open(f"4/{block}").read()
                check(len(v) == n4 and np.isfinite(
                    np.asarray(v, np.float64)).all(),
                    f"{sname}: 4/{block} does not read back")
            ft = bf.open("4/StarFormationTime").read()
            check(bool((ft > 0).all() & (ft <= hdr.Time * (1 + 1e-6)).all()),
                  f"{sname}: star formation times outside (0, a]")
            mstar = float(np.asarray(m, np.float64).sum()) * 1e10 \
                / hdr.HubbleParam
        per_snap[sname] = (round(float(hdr.Time), 6), n4, mstar)
        print(f"lya {sname} at a={hdr.Time:.6f}: {n4} stars, stellar mass "
              f"{mstar:.6e} Msun; its gas and star blocks read back",
              flush=True)
    check(int(stars.sum()) > 0 and per_snap[snaps[-1]][1] > 0,
          "lya formed no stars")
    with open(os.path.join(out, "sfr.txt")) as fh:
        sfr_lines = fh.read().splitlines()
    check(len(sfr_lines) > 0 and all(len(ln.split()) == 8
                                     for ln in sfr_lines),
          "lya sfr.txt missing or not 8 columns")
    wt = dict(sim.walltime.totals)
    return dict(nsteps=nsteps, atime=sim.atime, launches=launches,
                step_seconds=step_seconds, run_seconds=run_seconds,
                genic_seconds=genic_s, walltime=wt, sim=sim, spy=spy,
                snapshots=per_snap, sfr_last=sfr_lines[-1],
                sfr_lines=len(sfr_lines), floor_ratio=floor_ratio,
                ngas=ngas, nstars=int(stars.sum()), paramfile=paramfile,
                snapnum=int(os.path.basename(snap).split("_")[-1]))


LYA_SHARDED_TIMEOUT = 600   # seconds for each configuration's ranks
LYA_FOF_MIN_LENGTH = 8      # phase 28's FOF check: lya's 32 would leave
                            # few groups of its 32^3 dark matter at a = 0.2
# phase 28 against phase 16, relative, each about three times what was
# measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6, PR 15;
# (a) one NCCL rank, (b) two gloo ranks): the sharded run keeps the box
# unshifted and takes longer PM steps (bounded by the displacement alone,
# the gas's Courant limit in its bins), so its gas follows another path
LYA_SHARDED_TOL = {
    "pk": 0.05,             # measured 1.72e-2 (a), 1.71e-2 (b)
    "stars": 0.35,          # 107 and 109 against 95: 0.126, 0.147
    "star_mass": 0.35,      # quick Lyman-alpha converts whole: as stars
    "gas_density": 0.10,    # 2.83e-2, 4.53e-2 (the densest gas converts)
    "gas_entropy": 0.075}   # 2.35e-2, 2.48e-2
# sfr.txt holds a row for each step that formed stellar mass (the
# effective EOS's sm > 0): in lya a rare event before quick Lyman-alpha
# converts the gas (measured: 5 rows of phase 16's, none in (a) and (b)),
# so the rows' count is held to phase 16's within LYA_SFR_ROWS_TOL
LYA_SFR_ROWS_TOL = 10


def lya_sharded_phase(workdir, lres, device="cuda", configs=SHARDED_CONFIGS,
                      nmesh=None):
    """Phase 28: lya through the sharded driver (see the module's
    docstring), from phase 16's IC and paramfile copy (lres: lya_phase's
    result, its workdir this one), a generator of each configuration's
    Launch.  device "cpu" rehearses it on the CPU (every rank on gloo;
    chip_smoke.LYA_TIME_MAX cut as phase 16's)."""
    import numpy as np
    from mpgadget_tpu_torch.io.bigfile import BigFile
    from mpgadget_tpu_torch.io import snapshot as snap_io
    from mpgadget_tpu_torch.params import create_gadget_parameter_set
    nmesh_pk = nmesh or 64
    ps = create_gadget_parameter_set()
    ps.parse_file(lres["paramfile"])
    ic = os.path.join(workdir, ps["InitCondFile"])
    out16 = os.path.join(workdir, ps["OutputDir"])
    ref_snap = os.path.join(out16, f"PART_{lres['snapnum']:03d}")
    k0, p0, n0, knyq = snapshot_power(ref_snap, device, nmesh_pk)
    with open(os.path.join(out16, "sfr.txt")) as fh:
        # the rows of steps that formed stellar mass (the sharded loop
        # writes only those, sfr_eff.c:356)
        ref_sfr = [ln.split() for ln in fh.read().splitlines()
                   if float(ln.split()[1]) > 0]
    sim16 = lres["sim"]
    g16 = sim16.gas_mask
    ref = dict(stars=lres["nstars"],
               star_mass=lres["snapshots"][f"PART_{lres['snapnum']:03d}"][2],
               gas_density=float(sim16.sph.density[g16].double().mean()),
               gas_entropy=float(sim16.sph.entropy[g16].double().mean()))
    icb = BigFile(ic)
    ih = snap_io.read_header(icb)
    sp = [snap_io.read_species(icb, t, ih) for t in (0, 1)]
    ic_ids = np.sort(np.concatenate([x["pid"] for x in sp]))
    ic_mass = sum(float(x["mass"].astype(np.float64).sum()) for x in sp)
    text = open(lres["paramfile"]).read()
    results = {}
    for name, nranks, env_over in configs:
        out = os.path.join(workdir, f"sharded_lya_{name}")
        pf = os.path.join(workdir, f"paramfile_lya_{name}.gadget")
        lines = []
        for ln in text.splitlines():
            key = ln.split("=")[0].strip()
            if key == "InitCondFile":
                ln = f"InitCondFile = {ic}"
            elif key == "OutputDir":
                ln = f"OutputDir = {out}"
            lines.append(ln)
        with open(pf, "w") as fh:
            fh.write("\n".join(lines) + "\n")
        prefix = os.path.join(workdir, f"sharded_lya_{name}")
        [ranks], wall = yield Launch(
            f"sharded lya {name}", nranks, env_over,
            [[pf, prefix, device, "gas"]], LYA_SHARDED_TIMEOUT, [None])
        r0 = ranks[0]
        check(abs(r0["atime"] - sim16.atime) < 1e-9, f"sharded lya {name} "
              f"stopped at a={r0['atime']}, phase 16 at {sim16.atime}")
        snaps = sorted(f for f in os.listdir(out) if f.startswith("PART_"))
        check(snaps, f"sharded lya {name}: no snapshot")
        last = os.path.join(out, snaps[-1])
        bf = BigFile(last)
        hdr = snap_io.read_header(bf)
        check(abs(hdr.Time - sim16.atime) < 1e-9, f"sharded lya {name}: "
              f"{snaps[-1]} at a={hdr.Time}")
        ids = np.sort(np.concatenate([bf.open(f"{t}/ID").read()
                                      for t in (0, 1, 4)
                                      if hdr.TotNumPart[t]]))
        check(np.array_equal(ids, ic_ids), f"sharded lya {name}: the IDs "
              "are not the IC's, each once")
        m = sum(float(bf.open(f"{t}/Mass").read().astype(np.float64).sum())
                for t in (0, 1, 4) if hdr.TotNumPart[t])
        check(abs(m / ic_mass - 1) <= MASS_TOL, f"sharded lya {name}: mass "
              f"{m!r} against the IC's {ic_mass!r}")
        check(bf.open("0/ID").Nfile == nranks,
              f"sharded lya {name}: not one stripe a rank")
        k1, p1, n1, _ = snapshot_power(last, device, nmesh_pk)
        check(np.array_equal(n1, n0), f"sharded lya {name}: P(k) modes")
        low = k0 < knyq / 4
        sfr_path = os.path.join(out, "sfr.txt")
        sfr = []
        if os.path.exists(sfr_path):
            with open(sfr_path) as fh:
                sfr = [ln.split() for ln in fh.read().splitlines()]
        check(all(len(r) == 8 and float(r[1]) > 0 for r in sfr),
              f"sharded lya {name}: sfr.txt not 8 columns or with a line "
              "that formed no stellar mass")
        mstar = 0.0
        if hdr.TotNumPart[4]:
            mstar = float(bf.open("4/Mass").read().astype(np.float64)
                          .sum()) * 1e10 / hdr.HubbleParam
        got = dict(stars=r0["nstars"], star_mass=mstar,
                   gas_density=r0["gas_mean_density"],
                   gas_entropy=r0["gas_mean_entropy"])
        dev = {k: abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-300)
               for k in ref}
        dev["pk"] = float(np.max(np.abs(p1[low] / p0[low] - 1)))
        print(f"sharded lya {name} against phase 16 at a={r0['atime']:.6f}"
              f": " + ", ".join(
                  f"{k} {got.get(k, 'P(k)')} vs {ref.get(k, '')} "
                  f"(relative {dev[k]:.6e}, tolerance {LYA_SHARDED_TOL[k]})"
                  for k in LYA_SHARDED_TOL) + f"; P(k) on {int(low.sum())} "
              f"bins below k_Nyquist/4 = {knyq / 4:.6f} h/Mpc", flush=True)
        print(f"sharded lya {name} sfr.txt: {len(sfr)} rows, the last "
              f"{sfr[-3:]}; phase 16's with total_sm > 0: {len(ref_sfr)} "
              f"rows, the last {ref_sfr[-3:]} (tolerance "
              f"{LYA_SFR_ROWS_TOL} rows)", flush=True)
        check(abs(len(sfr) - len(ref_sfr)) <= LYA_SFR_ROWS_TOL,
              f"sharded lya {name}: {len(sfr)} sfr.txt rows against phase "
              f"16's {len(ref_sfr)}")
        for k, tol in LYA_SHARDED_TOL.items():
            check(dev[k] <= tol, f"sharded lya {name}: {k} off phase 16's "
                  f"by {dev[k]:.3e} (tolerance {tol})")
        check(r0["nstars"] > 0, f"sharded lya {name} formed no stars")
        if nranks > 1:
            formed = [rk["formed_here"] for rk in ranks]
            check(min(formed) > 0, f"sharded lya {name}: stars formed on "
                  f"the ranks' slabs {formed}: not on every rank")
            f1, f0 = r0["fof"], r0["fof_single"]
            check(f1["ngroups"] == f0["ngroups"] > 0, f"sharded lya {name}:"
                  f" the distributed FOF found {f1['ngroups']} groups, "
                  f"run_fof {f0['ngroups']}")
            lb1 = np.array(f1["len_by_type"]).reshape(-1, 6)
            lb0 = np.array(f0["len_by_type"]).reshape(-1, 6)
            o1, o0 = np.lexsort(lb1.T[::-1]), np.lexsort(lb0.T[::-1])
            check(np.array_equal(lb1[o1], lb0[o0]), f"sharded lya {name}: "
                  "FOF lengths by type differ from run_fof's")
            mb1 = np.array(f1["mass_by_type"]).reshape(-1, 6)
            mb0 = np.array(f0["mass_by_type"]).reshape(-1, 6)
            check(np.allclose(mb1[o1], mb0[o0], rtol=1e-5, atol=0),
                  f"sharded lya {name}: FOF masses by type differ from "
                  "run_fof's")
            print(f"sharded lya {name}: the distributed FOF of the final "
                  f"rows {f1['ngroups']} groups ({f1['seconds']:.6f} s), "
                  f"members by type {lb1.sum(axis=0).tolist()}, as "
                  f"run_fof's; stars formed per rank {formed}", flush=True)
        results[name] = dict(ranks=ranks, wall=wall, dev=dev, got=got,
                             snapshots=snaps)
    return dict(configs=results, ref=ref)


def lya_pig_stars(workdir, snapnum):
    """The PIG that RestartFlag 3 wrote for lya's last snapshot: its
    grouped stars (secondaries, FOFSecondaryLinkTypes 1 + 16 + 32) carry
    their star blocks.  Returns the grouped star count."""
    import numpy as np
    from mpgadget_tpu_torch.io.bigfile import BigFile
    bf = BigFile(os.path.join(workdir, "output", f"PIG_{snapnum:03d}"))
    n4 = int(np.asarray(bf.open("Header").attrs["NumPartInGroupTotal"])[4])
    for block in ("StarFormationTime", "BirthDensity", "Metallicity"):
        if n4:
            check(len(bf.open(f"4/{block}").read()) == n4,
                  f"PIG_{snapnum:03d}: 4/{block} does not read back")
    return n4


def simple_cooling(call):
    """call() (a K6 wrapper's call) with the first design's entry points
    (csrc/cooling_simple.cu) in place of the kernel's for this call: the
    wrapper's checks and output; its launch count is left as it was."""
    import ctypes
    from mpgadget_tpu_torch import kernels
    from mpgadget_tpu_torch.physics import cooling

    lib = kernels.load("cooling_simple")
    fns = {}
    for name, n_io in cooling.N_PTRS.items():
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"{name}_{suffix}")
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * (n_io + 1) + [ctypes.c_int64] \
                + [ctypes.c_void_p] * 3
            fns[f"{name}_{suffix}"] = first_design_call(fn, n_io)
    real, launches = cooling._fns, cooling.LAUNCHES
    cooling._fns = fns
    try:
        return call()
    finally:
        cooling._fns, cooling.LAUNCHES = real, launches


def first_design_call(fn, n_io):
    """The first design's entry point fn as the wrapper calls K6's: its
    optional per-row inputs (which the first design does not take) must be
    null and are dropped."""
    from mpgadget_tpu_torch.physics import cooling

    def call(*args):
        extra = args[n_io:n_io + cooling.N_EXTRA]
        check(all(x is None for x in extra), "the first design of K6 takes "
              "no per-row UV rates, metallicity or metal table")
        return fn(*args[:n_io], *args[n_io + cooling.N_EXTRA:])
    return call


def same_bits(a, b):
    """a and b (tensors of one float type) hold the same bits."""
    import torch
    it = torch.int32 if a.dtype == torch.float32 else torch.int64
    return bool(torch.equal(a.view(it), b.view(it)))


def cooling_designs(name, kern, launch, outs, reps):
    """K6's outputs against its first design's (simple_cooling) on the
    same call, bit for bit, and both designs' times: (ms, simple_ms), each
    the mean of reps CUDA graph replays of launch (the entry point alone,
    its rows checked and its arguments made beforehand)."""
    simple = simple_cooling(kern)
    check(all(same_bits(x, y) for x, y in zip(outs, simple)),
          f"K6 {name}: the kernel differs from its first design "
          "(csrc/cooling_simple.cu) in some bit")
    return (graph_ms(launch, reps),
            simple_cooling(lambda: graph_ms(launch, reps)))


def cooling_launch(name, rows, args, ins, outs, extra=None):
    """A call of K6's entry point `name` alone (physics.cooling._launch)
    on these inputs (extra: its optional per-row inputs, kernel_extra's),
    rows checked once here and outputs made once: what cooling_designs
    times."""
    from mpgadget_tpu_torch.physics import cooling
    n = ins[0].shape[0]
    rows = cooling._as_rows(rows, n, ins[0].device)
    n_rows = n if rows is None else rows.shape[0]
    ins = [x.contiguous() for x in ins]
    outs = [x.clone() for x in outs]
    extra = extra or (None,) * cooling.N_EXTRA
    return lambda: cooling._launch(name, n_rows, rows, args, ins, outs,
                                   extra)


def same_elems(a, b):
    """Elementwise: a and b hold the same bits and are no NaN."""
    import torch
    it = torch.int32 if a.dtype == torch.float32 else torch.int64
    return (a == b) & (a.view(it) == b.view(it))


def first_repeat(hist, eq, period):
    """Per row, where a loop over hist (its iterates, hist[0] the first)
    that stops as csrc/cooling.cu's cycle_end does stops: (steps, p), steps
    the first i whose iterate repeats one of the last `period` (p the
    distance back, the cycle's period), else the cap len(hist) - 1 with
    p = 0."""
    import torch
    cap = len(hist) - 1
    shape = eq(hist[0], hist[0])
    steps = torch.full(shape.shape, cap, dtype=torch.int64,
                       device=shape.device)
    per = torch.zeros_like(steps)
    for i in range(cap, 0, -1):
        hit = torch.zeros_like(per)
        for q in range(min(period, i), 0, -1):
            hit = torch.where(eq(hist[i], hist[i - q]), q, hit)
        steps = torch.where(hit > 0, i, steps)
        per = torch.where(hit > 0, hit, per)
    return steps, per


def steffensen_exits(cr, nh, ienergy, ne_init, uvbg):
    """K6's Steffensen loop on these rows (csrc/cooling.cu: solve_row),
    from the plain step function run to the cap: per row (iterations,
    network evaluations).  An iteration evaluates the network at its
    iterate, and at the iterate's image unless that is the iterate itself;
    the closing rate evaluates it at the iterate the loop ends on unless
    that is the last iteration's own."""
    import torch
    from mpgadget_tpu_torch.physics import cooling
    x = [torch.where(ne_init <= 0, 1.0, ne_init)]
    fixed = []
    repeated = torch.zeros_like(x[0], dtype=torch.bool)
    for _ in range(cooling.NE_ITERS):
        ne1 = cr._ne_internal(nh, ienergy, x[-1] * nh, cr.helium, uvbg) / nh
        fixed.append(same_elems(ne1 * nh, x[-1] * nh))
        x.append(cr.equilib_ne_step(nh, ienergy, x[-1], cr.helium, uvbg))
        i = len(x) - 1
        for q in range(1, min(cooling.NE_PERIOD, i) + 1):
            repeated |= same_elems(x[i], x[i - q])
        if bool(repeated.all()):
            # every row's loop has stopped: later iterates change nothing
            # below (no row reaches the cap)
            break
    n, per = first_repeat(x, same_elems, cooling.NE_PERIOD)
    X = torch.stack(x, 1)
    safe = per.clamp(min=1)
    m = (cooling.NE_ITERS - n) % safe
    at = torch.where((per > 0) & (m > 0), n - per + m, n)
    fin = X.gather(1, at[:, None])[:, 0]
    last = X.gather(1, (n - 1)[:, None])[:, 0]
    taken = torch.arange(len(fixed), device=n.device)[None, :] \
        < n[:, None]
    image = ((~torch.stack(fixed, 1)) & taken).sum(1)
    closing = (~same_elems(fin * nh, last * nh)).long()
    return n, n + image + closing


def dist(x):
    """median, 99th percentile and maximum of x."""
    x = x.double()
    return {"median": float(x.median()), "p99": float(x.quantile(0.99)),
            "max": float(x.max())}


def exits_summary(name, steps, its, evals, taken):
    """The exit census of a K6 case (cooling_exits, rate_exits), printed."""
    from mpgadget_tpu_torch.physics import cooling
    res = {"rows": int(evals.shape[0])}
    if steps is not None:
        res["bisection_steps"] = dist(steps)
    res["steffensen_iterations"] = dist(its[taken])
    res["steffensen_iterations"]["at_cap"] = float(
        (its[taken] == cooling.NE_ITERS).double().mean())
    res["evaluations"] = dist(evals)
    m = evals.shape[0] // ROWS_PER_WARP * ROWS_PER_WARP
    res["evaluations_warp_max"] = dist(
        evals[:m].view(-1, ROWS_PER_WARP).max(1).values if m else evals)
    print(f"K6 exits, {name} ({res['rows']} rows, plain step functions on "
          f"the card): " + (f"bisection steps {res['bisection_steps']}; "
                            if steps is not None else "")
          + f"Steffensen iterations a rate {res['steffensen_iterations']}; "
          f"network evaluations a row {res['evaluations']} (the largest of "
          f"{ROWS_PER_WARP} consecutive rows {res['evaluations_warp_max']})",
          flush=True)
    return res


def cooling_exits(name, cr, redshift, uvbg, ins, rows, min_egy, units,
                  metallicity=None):
    """Where K6's loops stop on these do_cooling inputs, row by row, and
    the work that leaves: the plain step functions (physics/cooling.py)
    run to the caps on the card, the bisection stopped where (u_lo, u_hi,
    ne) repeats one of the last BISECT_PERIOD states, each of its rates as
    steffensen_exits.  uvbg's rates may be per row; with a metallicity
    (and the metal table) each net rate adds its lookup.  Returns the
    census and, per row, the operations and transcendentals K6 makes
    (COOL_* counts)."""
    import torch
    from mpgadget_tpu_torch.physics import cooling

    u, rho, dt, ne = [x[rows] for x in ins]
    uvbg = cooling.uvbg_rows(uvbg, rows)
    metal = metallicity is not None and cr.metal_table is not None
    br = cooling.cooling_bracket(u, rho, dt, min_egy, units,
                                 metallicity[rows] if metal else None)
    nh = br.rho_cgs * (1 - cr.helium)
    states = [(br.u_lo, br.u_hi, ne)]
    its, evs = [], []

    def same_state(a, b):
        return same_elems(a[0], b[0]) & same_elems(a[1], b[1]) \
            & same_elems(a[2], b[2])

    repeated = torch.zeros_like(ne, dtype=torch.bool)
    for _ in range(cooling.BISECT_ITERS):
        lo, hi, e = states[-1]
        n, ev = steffensen_exits(cr, nh, 0.5 * (lo + hi), e, uvbg)
        its.append(n)
        evs.append(ev)
        states.append(cooling.bisection_step(cr, redshift, uvbg, br, lo, hi,
                                             e))
        i = len(states) - 1
        for q in range(1, min(cooling.BISECT_PERIOD, i) + 1):
            repeated |= same_state(states[i], states[i - q])
        if bool(repeated.all()):
            break       # every row has stopped (none at the cap)
    steps = first_repeat(states, same_state, cooling.BISECT_PERIOD)[0]
    taken = torch.arange(len(its), device=steps.device)[None, :] \
        < steps[:, None]
    its, evs = torch.stack(its, 1), torch.stack(evs, 1)
    per_step = evs * COOL_NE_OPS + its * COOL_STEFF_OPS + 4 \
        + COOL_CLOSE_OPS + COOL_BISECT_OPS + (COOL_METAL_OPS if metal else 0)
    ops = (per_step * taken).sum(1) + 10
    trans = ((evs * COOL_NE_TRANSC + COOL_CLOSE_TRANSC
              + (COOL_METAL_TRANSC if metal else 0)) * taken).sum(1)
    res = exits_summary(name, steps, its, (evs * taken).sum(1), taken)
    return res, ops, trans


def rate_exits(name, cr, uvbg, dens, u, ne, rows):
    """The same for heatingcooling_rate's inputs: one rate a row."""
    import torch
    sel = rows if rows is not None else slice(None)
    nh = dens[sel] * (1 - cr.helium)
    its, evs = steffensen_exits(cr, nh, u[sel], ne[sel], uvbg)
    res = exits_summary(name, None, its[:, None], evs,
                        torch.ones_like(its[:, None], dtype=torch.bool))
    ops = evs * COOL_NE_OPS + its * COOL_STEFF_OPS + 4 + COOL_CLOSE_OPS
    return res, ops, evs * COOL_NE_TRANSC + COOL_CLOSE_TRANSC


def k6_bounds(nrows, ops, trans, esize, n_io, full, extra_bytes=0):
    """K6's bound from the operations its exits leave on these rows (ops,
    trans: per row) and, for comparing designs, from the full trip counts
    (full: cooling_work's pair); n_io values of esize bytes a row and its
    index, and extra_bytes read once (the metal table)."""
    peak = FP64_OPS_PER_S if esize == 8 else FP32_OPS_PER_S
    nbytes = nrows * (n_io * esize + 8) + extra_bytes
    bms, by = bound(int(ops.sum()), nbytes, peak)
    full_ms, _ = bound(nrows * full[0], nbytes, peak)
    return dict(bound_ms=bms, bound_by=by, full_work_bound_ms=full_ms,
                ops=int(ops.sum()) / nrows,
                transcendentals=int(trans.sum()) / nrows,
                full_work_ops=full[0], full_work_transcendentals=full[1])


def cooling_case(name, cr, redshift, uvbg, ins, rows, min_egy, units,
                 reps=5, plain=None, exits=None):
    """K6's do_cooling on the given inputs (u, rho, dt, ne) and rows,
    against its plain version on the card: u_new and ne/nh within COOL_TOL
    on the listed rows, unlisted rows untouched, two launches
    bit-identical, and bit for bit its first design's (cooling_designs);
    the kernel's time and the first design's (CUDA graph replays), the
    plain version's (one call) and the bound, from the operations the
    exits leave (cooling_exits), the full work's beside it.  plain: the
    plain version's (u_new, ne) on these rows from an earlier case on the
    same inputs (elementwise, so the same values), not timed again;
    exits: that case's exits on these rows, (census, operations and
    transcendentals a row), not counted again."""
    import torch
    from mpgadget_tpu_torch.physics import cooling
    f64 = ins[0].dtype == torch.float64

    def kern():
        return cooling.do_cooling(cr, redshift, *ins[:3], uvbg, ins[3],
                                  min_egy, units, rows=rows)

    u1, n1 = kern()
    u2, n2 = kern()
    check(torch.equal(u1, u2) and torch.equal(n1, n2),
          f"K6 {name}: two launches differ")
    sel = rows if rows is not None else slice(None)
    if plain is None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ur, nr = cooling.do_cooling_reference(
            cr, redshift, *[x[sel] for x in ins[:3]], uvbg, ins[3][sel],
            min_egy, units)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
    else:
        (ur, nr), plain_ms = plain, None
    launch = cooling_launch(
        "do_cooling", rows, cooling.kernel_args(cr, redshift, uvbg, min_egy,
                                                units),
        ins, [ins[0], ins[3]])
    ms, simple_ms = cooling_designs(name, kern, launch, (u1, n1), reps)
    if rows is not None:
        rest = torch.ones(ins[0].shape[0], dtype=torch.bool,
                          device=ins[0].device)
        rest[rows] = False
        check(torch.equal(u1[rest], ins[0][rest])
              and torch.equal(n1[rest], ins[3][rest]),
              f"K6 {name}: unlisted rows changed")
    u, n = u1[sel].double(), n1[sel].double()
    urd, nrd = ur.double(), nr.double()
    rel_u = float(((u - urd).abs() / urd.abs().clamp(min=1e-300)).max())
    err_n = (n - nrd).abs()
    rel_n = float((err_n / nrd.abs().clamp(min=1e-300)).max())
    tol_u = COOL_TOL["f64"] if f64 else COOL_TOL["u"]
    ok_n = err_n <= (COOL_TOL["f64"] * nrd.abs() if f64 else
                     COOL_TOL["ne_abs"] + COOL_TOL["ne_rel"] * nrd.abs())
    check(rel_u <= tol_u and bool(ok_n.all()),
          f"K6 {name}: u_new rel {rel_u:.3e}, ne rel {rel_n:.3e} (abs "
          f"{float(err_n.max()):.3e}) against the plain version")
    nrows = int(u.shape[0])
    exits, ops, trans = exits or cooling_exits(name, cr, redshift, uvbg,
                                               ins, sel, min_egy, units)
    b = k6_bounds(nrows, ops, trans, 8 if f64 else 4, 6,
                  cooling_work(True))
    plain_s = "not timed again" if plain_ms is None else \
        f"{plain_ms:.6f} ms (one call)"
    print(f"K6 do_cooling {name} ({'float64' if f64 else 'float32'}, "
          f"{nrows} rows): {ms:.6f} ms (CUDA graph replays, mean of {reps}),"
          f" {100 * b['bound_ms'] / ms:.2f}% of the bound; first design "
          f"{simple_ms:.6f} ms ({simple_ms / ms:.2f}x), bit for bit the "
          f"same; plain {plain_s}; bound {b['bound_ms']:.6f} ms "
          f"({b['bound_by']}: {b['ops']:.1f} operations a row the exits "
          f"leave, {b['transcendentals']:.1f} of them exp/log/pow/sqrt); "
          f"full-work bound {b['full_work_bound_ms']:.6f} ms "
          f"({b['full_work_ops']} a row); u_new rel err {rel_u:.3e}, ne/nh "
          f"max abs err {float(err_n.max()):.3e} (rel {rel_n:.3e}); two "
          "launches bit-identical", flush=True)
    return dict(ms=ms, simple_ms=simple_ms, plain_ms=plain_ms,
                bound_share=b["bound_ms"] / ms, rows=nrows, exits=exits,
                max_abs_err=float((u - urd).abs().max()), rel_u=rel_u,
                ne_abs_err=float(err_n.max()), plain=(ur, nr),
                row_exits=(ops, trans), **b)


def rate_case(name, cr, redshift, uvbg, dens, u, ne, rows, reps=5):
    """K6's heatingcooling_rate (get_cooling_time's call) against the plain
    version on the card: ne/nh within COOL_TOL["ne_abs"] and the rate
    within COOL_TOL["rate"] plus COOL_TOL["rate_scale"] of its largest
    value (float64: COOL_TOL["f64"]); bit for bit its first design's, both
    timed (cooling_designs); the bound as cooling_case's (rate_exits)."""
    import torch
    from mpgadget_tpu_torch.physics import cooling
    f64 = dens.dtype == torch.float64

    def kern():
        return cooling.heatingcooling_rate(cr, dens, u, redshift, uvbg, ne,
                                           rows=rows)

    l1, n1 = kern()
    l2, n2 = kern()
    check(torch.equal(l1, l2) and torch.equal(n1, n2),
          f"K6 rate {name}: two launches differ")
    sel = rows if rows is not None else slice(None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lr, nr = cr.get_heatingcooling_rate(dens[sel], u[sel], redshift, uvbg,
                                        ne[sel])
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    launch = cooling_launch("heatingcooling_rate", rows,
                            cooling.kernel_args(cr, redshift, uvbg),
                            [dens, u, ne], [torch.zeros_like(dens), ne])
    ms, simple_ms = cooling_designs(f"rate {name}", kern, launch, (l1, n1),
                                    reps)
    lk, nk = l1[sel].double(), n1[sel].double()
    lr, nr = lr.double(), nr.double()
    scale = float(lr.abs().max())
    err_l = (lk - lr).abs()
    err_n = (nk - nr).abs()
    if f64:
        ok = bool((err_l <= COOL_TOL["f64"] * lr.abs() + 1e-12 * scale).all()
                  & (err_n <= COOL_TOL["f64"] * nr.abs() + 1e-12).all())
    else:
        ok = bool((err_l <= COOL_TOL["rate"] * lr.abs()
                   + COOL_TOL["rate_scale"] * scale).all()
                  & (err_n <= COOL_TOL["ne_abs"]).all())
    check(ok, f"K6 rate {name}: rate err {float(err_l.max()):.3e} (scale "
          f"{scale:.3e}), ne err {float(err_n.max()):.3e}")
    nrows = int(lk.shape[0])
    exits, ops, trans = rate_exits(f"rate {name}", cr, uvbg, dens, u, ne,
                                   rows)
    b = k6_bounds(nrows, ops, trans, 8 if f64 else 4, 5, cooling_work(False))
    print(f"K6 heatingcooling_rate {name} ({'float64' if f64 else 'float32'},"
          f" {nrows} rows): {ms:.6f} ms (CUDA graph replays, mean of {reps}),"
          f" {100 * b['bound_ms'] / ms:.2f}% of the bound; first design "
          f"{simple_ms:.6f} ms, bit for bit the same; plain {plain_ms:.6f} "
          f"ms; bound {b['bound_ms']:.6f} ms ({b['bound_by']}, "
          f"{b['ops']:.1f} operations a row the exits leave); full-work "
          f"bound {b['full_work_bound_ms']:.6f} ms; rate max abs err "
          f"{float(err_l.max()):.3e} of {scale:.3e}, ne/nh "
          f"{float(err_n.max()):.3e}", flush=True)
    return dict(ms=ms, simple_ms=simple_ms, plain_ms=plain_ms,
                bound_share=b["bound_ms"] / ms, rows=nrows, exits=exits,
                max_abs_err=float(err_l.max()), **b)


def cooling_phase(lres):
    """K6 against its plain version on the card on the gas state of the lya
    run: do_cooling on the inputs of the run's last cooling call over
    every gas particle, over its first 128 gas rows (one row's chain of
    dependent instructions sets the time of so small a launch) and in
    float64, and on the call that listed the fewest rows (a substep's
    closing gas) over those rows; the net rate (get_cooling_time's call)
    on every gas particle; and init_sfr's float64 threshold, one
    particle.  Each case also runs the first design (cooling_designs) and
    counts where K6's loops stop (cooling_exits, rate_exits)."""
    import torch
    from mpgadget_tpu_torch.physics import cooling
    from mpgadget_tpu_torch.utils import constants as C

    sim = lres["sim"]
    spy = lres["spy"]
    check(spy.last is not None, "lya made no cooling call to keep")
    cr, redshift, u, rho, dt, uvbg, ne, min_egy, units = spy.last[0]
    gas = torch.nonzero(sim.gas_mask).flatten()
    ins = [u, rho, dt, ne]
    fa = spy.fewest[0]
    every = cooling_case("lya final state, all gas", cr, redshift, uvbg,
                         ins, gas, min_egy, units)
    cases = {
        "all gas": every,
        "128 rows": cooling_case(
            "lya final state, 128 gas rows", cr, redshift, uvbg, ins,
            gas[:128], min_egy, units, reps=20,
            plain=tuple(x[:128] for x in every["plain"]),
            exits=({"rows": 128, "as": "the all-gas case's first 128"},)
            + tuple(x[:128] for x in every["row_exits"])),
        "closing": cooling_case(
            f"lya's smallest cooling call (closing gas, z={fa[1]:.3f})",
            fa[0], fa[1], fa[5], [fa[2], fa[3], fa[4], fa[6]],
            spy.fewest[2], fa[7], fa[8], reps=20),
        "all gas f64": cooling_case(
            "lya final state, all gas", cr, redshift, uvbg,
            [x.double() for x in ins], gas, min_egy, units, reps=2)}
    rho_cgs = rho * units.density_in_phys_cgs / C.PROTONMASS
    rate = rate_case("lya final state, all gas", cr, redshift, uvbg,
                     rho_cgs, u * units.uu_in_cgs, ne, gas)
    # init_sfr's self-consistent threshold: one particle, float64
    par = sim._sfr
    egyhot = par.EgySpecSN / par.FactorEVP
    dens = 1.0e6 * sim.CP.RhoCrit

    def one(x):
        return torch.tensor([x], dtype=torch.float64, device=sim.device)

    thresh = rate_case("init_sfr threshold", cr, 0.0, cooling.UVBG(),
                       one(dens * units.density_in_phys_cgs / C.PROTONMASS),
                       one(egyhot * units.uu_in_cgs), one(1.0), None)
    return dict(cases=cases, rate=rate, thresh=thresh)



# -- phases 23-24: star-small as it ships (winds, metal return, black holes)

# the absent TREECOOL_fg_june11: no UV background (the cut lya carries)
STAR_SMALL_SWITCHES = {"TreeCoolFile": ""}
STAR_SMALL_STEPS = None   # PM steps of phase 23 (None: to TimeMax)
STAR_SMALL_TIME_MAX = 0.15  # the depth cut that pays for phases 28 (first
                            # to 0.18) and 29: as shipped 0.2 (486 PM steps,
                            # 207 s of the smoke on an H100; to 0.18 119 s);
                            # its outputs at 0.125 and 0.15 (phases 24, 26
                            # and 29 resume or compare with the latter)
                            # stay
MASS_TOL = 1e-5           # the total mass against the IC's, relative
# phase 24: global steps from phase 23's snapshot at a = 0.15 (RestartFlag
# 2), where ofjt10's dispersion is computed; its cuts: the seeding
# thresholds lowered so that the first FOF after the restart (at a = 0.151)
# seeds a BH in every halo; star formation's density threshold lowered
# (CritOverDensity 1, CritPhysDensity 1e-3 cm^-3: star-small's own forms
# 3 stars by a = 0.15 and none on 19 global steps after it) and
# Generations 64 (star-small's 4: new stars 16 times as often, each a
# 64th of a mean gas particle), so that stars spawn on the steps the phase
# runs; an output at a = 0.151 and one at TimeMax, 0.152 (the depth cut,
# since PR 17: 0.154 took 16 global steps; the seeded BHs accrete from the
# step after 0.151 on, and the winds kick on the first steps); at most
# GLOBAL_STEPS steps
GLOBAL_SWITCHES = {"SplitGravityTimestepsOn": 0, "MinFoFMassForNewSeed": 0,
                   "MinMStarForNewSeed": -1, "CritOverDensity": 1,
                   "CritPhysDensity": 1e-3, "Generations": 64,
                   "OutputList": "0.151,0.152", "TimeMax": 0.152}
GLOBAL_STEPS = 30         # at most this many global steps (the depth cut)
# the callers of the subgrid passes' walks (K3) and pair sums, as
# ops/pairs.spanned names them
SUBGRID_CALLERS = ("vdisp", "wind weight", "wind kick", "metal count",
                   "metal spread", "BH sums", "BH dynfric", "BH vdisp",
                   "swallow", "minpot")


def subgrid_spans(device):
    """Start timing the subgrid passes (ops/pairs.SPANS) on the card."""
    from mpgadget_tpu_torch.ops import pairs
    pairs.SPANS = {} if device == "cuda" else None


def read_spans(device):
    """The subgrid passes' card time by caller: {caller: {"K3": (ms,
    calls), "pair_reduce": (ms, calls)}}; timing stops."""
    from mpgadget_tpu_torch.ops import pairs
    if pairs.SPANS is None:
        return {}
    spans = pairs.span_ms()
    pairs.SPANS = None
    out = {}
    for (caller, kind), v in spans.items():
        out.setdefault(caller, {})[kind] = v
    return out


def print_spans(what, spans, card):
    for caller in SUBGRID_CALLERS:
        s = spans.get(caller)
        if not s:
            continue
        k3, pr = s.get("K3", (0.0, 0)), s.get("pair_reduce", (0.0, 0))
        print(f"{what} {caller}: pair_reduce {pr[0]:.6f} ms in {pr[1]} "
              f"calls, K3 {k3[0]:.6f} ms in {k3[1]} searches (CUDA events "
              f"around each call, the host's gaps inside) on {card}",
              flush=True)


def total_mass(sim):
    pd = sim.pdata
    return float(pd.mass[pd.valid].double().sum())


def check_bh_blocks(name, bf, hdr, skip=()):
    """A snapshot's or PIG's type-5 blocks read back: every registered
    block (but those in skip) with one row per BH, finite."""
    import numpy as np
    from mpgadget_tpu_torch.io.registry import blocks_for_type
    n5 = int(hdr.TotNumPart[5]) if hdr is not None else int(np.asarray(
        bf.open("Header").attrs["NumPartInGroupTotal"])[5])
    for spec in blocks_for_type(5):
        if n5 == 0:
            break
        if spec.name in skip:
            continue
        v = np.asarray(bf.open(f"5/{spec.name}").read(), np.float64)
        check(v.shape[0] == n5 and np.isfinite(v).all(),
              f"{name}: 5/{spec.name} does not read back")
    return n5


def read_bh_details(out):
    """BlackholeDetails/BH-Details-R0: float64 records of 12 (ID, a, BH
    mass, mdot, density, position, mass, Mtrack, progenitors, kinetic
    energy); None where no BH was ever stepped."""
    import numpy as np
    path = os.path.join(out, "BlackholeDetails", "BH-Details-R0")
    if not os.path.exists(path):
        return None
    rec = np.fromfile(path, np.float64)
    check(rec.size % 12 == 0, "BH-Details-R0 is not whole records")
    rec = rec.reshape(-1, 12)
    check(bool(np.isfinite(rec).all() & (rec[:, 2] > 0).all()),
          "BH-Details-R0 records not finite or a BH mass not positive")
    return rec


def star_small_phase(workdir, device="cuda", max_steps=STAR_SMALL_STEPS,
                     ngrid=None, nmesh=None):
    """Phase 23: examples/star-small as it ships, its subgrid physics on:
    genic (GENIC_OVERRIDE) through the CLI, then paramfile.gadget with
    STAR_SMALL_SWITCHES written into a copy -> build_simulation ->
    Simulation.run() (hierarchical; cooling, star formation, ofjt10 winds,
    metal return and black holes; a snapshot and a PIG at each output, BHs
    seeded from each catalogue) -> write_snapshot, the six kernels' launch
    counts reset just before and read just after, the subgrid passes'
    K3 and pair_reduce card time by caller.  Checks: stars formed; the
    total mass kept; the gas state finite; each snapshot's star and BH
    blocks and each PIG read back; blackholes.txt and BH-Details-R0
    read back where BHs were stepped.  Returns the measurements."""
    import numpy as np
    import torch
    from mpgadget_tpu_torch.gravity import pairkernel as pk
    from mpgadget_tpu_torch.gravity import treewalk as tw
    from mpgadget_tpu_torch.io.bigfile import BigFile
    from mpgadget_tpu_torch.io import snapshot as snap_io
    from mpgadget_tpu_torch.main import build_simulation
    from mpgadget_tpu_torch.ops import pairs
    from mpgadget_tpu_torch.physics import cooling
    from mpgadget_tpu_torch.sph import density, hydra

    over = dict(GENIC_OVERRIDE)
    if ngrid is not None:           # a smaller rehearsal on the CPU
        over["Ngrid"] = ngrid
    _, ngas, genic_s = gas_genic(workdir, "star-small", over, device)
    gover = dict(STAR_SMALL_SWITCHES, TimeMax=STAR_SMALL_TIME_MAX)
    if nmesh is not None:
        gover["Nmesh"] = nmesh
    paramfile = paramfile_copy(
        os.path.join(HERE, "examples", "star-small", "paramfile.gadget"),
        os.path.join(workdir, "paramfile.gadget"), gover)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        sim, _ = build_simulation(paramfile, device=device)
        c = sim.cfg
        check(c.hydro_on and c.cooling_on and c.starformation_on
              and c.wind_on and c.wind_model == 6 and c.metal_return_on
              and c.black_hole_on and c.split_gravity_timesteps
              and c.snapshot_with_fof and not c.treecool_file,
              "star-small's paramfile.gadget no longer sets HydroOn, "
              "CoolingOn, StarformationOn, WindOn (ofjt10), MetalReturnOn, "
              "BlackHoleOn, SplitGravityTimestepsOn and SnapshotWithFOF")
        out = os.path.abspath(c.output_dir)
        m_ic = total_mass(sim)
        step_seconds = []
        run_step = sim.step_hierarchical

        def timed_step(dti):
            if device == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            n_sub = run_step(dti)
            if device == "cuda":
                torch.cuda.synchronize()
            step_seconds.append(time.perf_counter() - t0)
            return n_sub

        sim.step_hierarchical = timed_step
        mods = {"pair": pk, "walk": tw, "neighbors": pairs,
                "density": density, "hydro": hydra, "cooling": cooling}
        for mod in mods.values():
            mod.LAUNCHES = 0
        subgrid_spans(device)
        t0 = time.perf_counter()
        nsteps = sim.run(max_steps=max_steps, verbose=False)
        snap = os.path.abspath(sim.write_snapshot())
        if device == "cuda":
            torch.cuda.synchronize()
        run_seconds = time.perf_counter() - t0
        spans = read_spans(device)
        launches = {k: mod.LAUNCHES for k, mod in mods.items()}
    finally:
        os.chdir(cwd)

    check(nsteps == max_steps or sim.ti_current == sim.timeline.ti_end,
          f"star-small ran {nsteps} PM steps to a={sim.atime}")
    if device == "cuda":
        check(min(launches.values()) > 0, f"a kernel of the star-small "
              f"path was not launched: {launches}")
    pd = sim.pdata
    gas = sim.gas_mask
    stars = pd.valid & (pd.ptype == 4)
    bhs = pd.valid & (pd.ptype == 5)
    sph = sim.sph
    check(bool(torch.isfinite(pd.vel[pd.valid]).all()
               & torch.isfinite(sph.entropy[gas]).all()
               & (sph.entropy[gas] > 0).all()),
          "star-small gas state not finite or entropy not positive")
    check(int(stars.sum()) > 0, "star-small formed no stars")
    m_end = total_mass(sim)
    mass_err = m_end / m_ic - 1
    check(abs(mass_err) < MASS_TOL, f"star-small total mass {m_end!r} "
          f"against the IC's {m_ic!r}: {mass_err:+.3e}")
    # each snapshot's star and BH blocks, each PIG
    snaps = sorted(f for f in os.listdir(out) if f.startswith("PART_"))
    per_snap = {}
    for name in snaps:
        bf = BigFile(os.path.join(out, name))
        hdr = snap_io.read_header(bf)
        n4 = int(hdr.TotNumPart[4])
        for block in ("StarFormationTime", "Metallicity", "Metals",
                      "TotalMassReturned", "StarVelDisp"):
            if n4:
                v = np.asarray(bf.open(f"4/{block}").read(), np.float64)
                check(v.shape[0] == n4 and np.isfinite(v).all(),
                      f"{name}: 4/{block} does not read back")
        n5 = check_bh_blocks(name, bf, hdr)
        per_snap[name] = (round(float(hdr.Time), 6), n4, n5)
    pigs = sorted(f for f in os.listdir(out) if f.startswith("PIG_"))
    check(len(pigs) >= 1, f"star-small PIGs written: {pigs}")
    pig_groups = {}
    for name in pigs:
        ng, bins, last = pig_check(os.path.join(out, name),
                                   sim.cfg.fof_min_group_length)
        n5 = check_bh_blocks(name, BigFile(os.path.join(out, name)), None)
        pig_groups[name] = (ng, n5)
    bh_lines = []
    if os.path.exists(os.path.join(out, "blackholes.txt")):
        with open(os.path.join(out, "blackholes.txt")) as fh:
            bh_lines = fh.read().splitlines()
        check(all(len(ln.split()) == 5 for ln in bh_lines),
              "blackholes.txt not 5 columns")
    details = read_bh_details(out)
    with open(os.path.join(out, "sfr.txt")) as fh:
        sfr_lines = fh.read().splitlines()
    wt = dict(sim.walltime.totals)
    return dict(nsteps=nsteps, atime=sim.atime, launches=launches,
                step_seconds=step_seconds, run_seconds=run_seconds,
                genic_seconds=genic_s, walltime=wt, sim=sim, spans=spans,
                ngas=ngas, nstars=int(stars.sum()), nbh=int(bhs.sum()),
                seeded=list(sim.bh_seeded), wind_kicks=sim.wind_kicks,
                swallowed=sim.bh_swallowed, mergers=sim.bh_mergers,
                bh_lines=len(bh_lines), details=0 if details is None
                else len(details), sfr_lines=len(sfr_lines),
                m_ic=m_ic, m_end=m_end, mass_err=mass_err,
                snapshots=per_snap, pig_groups=pig_groups,
                paramfile=paramfile, out=out,
                snapnum=int(os.path.basename(snap).split("_")[-1]))


def global_subgrid_phase(workdir, star, device="cuda", max_steps=GLOBAL_STEPS,
                         nmesh=None):
    """Phase 24: winds and black holes on global steps.  Phase 23's
    snapshot at a = 0.15, copied into workdir, resumed through the CLI's
    body (main.run_cli, RestartFlag 2) with GLOBAL_SWITCHES written into a
    copy of phase 23's paramfile (at most max_steps global steps: the
    depth cut), the kernels' launch counts and the subgrid passes' card
    time read around it.  Checks: wind kicks, and every decoupled gas row
    without hydro force at each hydro call; at least one BH seeded, every
    BH with mdot > 0 after its steps; BH-Details-R0 read back; the last
    snapshot's BH blocks read back by from_snapshot.  Returns the
    measurements."""
    import shutil
    import numpy as np
    import torch
    from mpgadget_tpu_torch import main as tmain
    from mpgadget_tpu_torch.gravity import pairkernel as pk
    from mpgadget_tpu_torch.gravity import treewalk as tw
    from mpgadget_tpu_torch.io.bigfile import BigFile
    from mpgadget_tpu_torch.io.registry import blocks_for_type
    from mpgadget_tpu_torch.io import snapshot as snap_io
    from mpgadget_tpu_torch.ops import pairs
    from mpgadget_tpu_torch.physics import cooling
    from mpgadget_tpu_torch.run import Simulation
    from mpgadget_tpu_torch.sph import density, hydra

    # the output at 0.15 (the run's last snapshot stands at 0.15 too)
    src = sorted(n for n, v in star["snapshots"].items()
                 if abs(v[0] - 0.15) < 1e-6)[:1]
    check(len(src) == 1, f"phase 23 wrote no snapshot at a = 0.15: "
          f"{star['snapshots']}")
    snapnum = int(src[0].split("_")[-1])
    os.makedirs(os.path.join(workdir, "output"), exist_ok=True)
    shutil.copytree(os.path.join(star["out"], src[0]),
                    os.path.join(workdir, "output", src[0]))
    gover = dict(GLOBAL_SWITCHES)
    if nmesh is not None:
        gover["Nmesh"] = nmesh
    paramfile = paramfile_copy(star["paramfile"],
                               os.path.join(workdir, "paramfile.gadget"),
                               gover)
    real_run, real_hydro = Simulation.run, Simulation.compute_hydro
    real_step = Simulation.step
    hydro_checks = []
    per_step = []       # (seconds, new stars, wind kicks, BHs)

    def run(self, max_steps=None, verbose=True):
        return real_run(self, max_steps=GLOBAL_STEPS if max_steps is None
                        else max_steps, verbose=verbose)

    def step(self, dti):
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        n4 = int((self.pdata.valid & (self.pdata.ptype == 4)).sum())
        kicks = self.wind_kicks
        real_step(self, dti)
        if device == "cuda":
            torch.cuda.synchronize()
        per_step.append((
            time.perf_counter() - t0,
            int((self.pdata.valid & (self.pdata.ptype == 4)).sum()) - n4,
            self.wind_kicks - kicks,
            int((self.pdata.valid & (self.pdata.ptype == 5)).sum())))

    def compute_hydro(self, *a, **k):
        real_hydro(self, *a, **k)
        if self.cfg.wind_on and self._gas_initialized:
            dec = self.gas_mask & (self.sph.delay_time > 0)
            acc = self.sph.hydro_accel[dec]
            hydro_checks.append((int(dec.sum()),
                                 float(acc.abs().max()) if acc.numel()
                                 else 0.0))

    mods = {"pair": pk, "walk": tw, "neighbors": pairs,
            "density": density, "hydro": hydra, "cooling": cooling}
    for mod in mods.values():
        mod.LAUNCHES = 0
    Simulation.run, Simulation.compute_hydro = run, compute_hydro
    Simulation.step = step
    subgrid_spans(device)
    cwd = os.getcwd()
    os.chdir(workdir)
    t0 = time.perf_counter()
    try:
        sim = tmain.run_cli(paramfile, 2, snapnum, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
    finally:
        os.chdir(cwd)
        Simulation.run, Simulation.compute_hydro = real_run, real_hydro
        Simulation.step = real_step
        print("phase 24 per global step (seconds, new stars, wind kicks, "
              f"BHs): {per_step}", flush=True)
    seconds = time.perf_counter() - t0
    spans = read_spans(device)
    launches = {k: mod.LAUNCHES for k, mod in mods.items()}
    out = os.path.join(workdir, "output")
    nsteps = sim._nstep_total
    check(not sim.cfg.split_gravity_timesteps, "phase 24 ran hierarchical")
    check(sim.wind_kicks > 0, f"no wind kick on global steps "
          f"({sim.wind_kicks})")
    bad = [h for h in hydro_checks if h[1] != 0.0]
    check(any(h[0] > 0 for h in hydro_checks) and not bad,
          f"decoupled gas rows with hydro force (rows, max |a|): {bad}; "
          f"per hydro call {hydro_checks}")
    check(sum(sim.bh_seeded) > 0, f"no BH seeded: {sim.bh_seeded}")
    bh = (sim.pdata.valid & (sim.pdata.ptype == 5)).cpu().numpy()
    mdot = sim.bh.mdot.cpu().numpy()[bh]
    check(bh.sum() > 0 and bool((mdot > 0).any()),
          f"no BH accretes: mdot {mdot}")
    details = read_bh_details(out)
    if details is None:
        details = np.zeros((0, 12))
    # every BH seeded before the last step has its records (the last
    # output's FOF seeds BHs that no step has seen yet)
    stepped = bh & (sim.bh.formation_time.cpu().numpy() < sim.atime * (
        1 - 1e-6))
    pids = set(sim.pdata.pid.cpu().numpy()[stepped].tolist())
    check(len(details) > 0 and len(pids) > 0 and pids <= set(
        details[:, 0].astype(np.int64).tolist()),
        f"BH-Details-R0 not written or lacks a BH: {len(details)} records")
    snaps = sorted(f for f in os.listdir(out) if f.startswith("PART_"))
    last = os.path.join(out, snaps[-1])
    bf = BigFile(last)
    hdr = snap_io.read_header(bf)
    n5 = check_bh_blocks(snaps[-1], bf, hdr)
    check(n5 > 0, f"{snaps[-1]} holds no BH")
    metal_rows = snapshot_counts(bf, hdr)[2]
    cfgk = {"starformation_on": True, "black_hole_on": True,
            "part_alloc_factor": sim.cfg.part_alloc_factor,
            "nmesh": sim.cfg.nmesh, "output_dir": out,
            "timeline": sim.timeline}
    back = Simulation.from_snapshot(last, cfgk, device=device)
    rows = (back.pdata.valid & (back.pdata.ptype == 5)).cpu().numpy()
    for spec in blocks_for_type(5) if n5 else ():
        want = bf.open(f"5/{spec.name}").read()
        got = getattr(back.bh, spec.field).cpu().numpy()[rows]
        check(np.array_equal(got.astype(spec.dtype).reshape(want.shape),
                             want), f"{snaps[-1]}: 5/{spec.name} not "
              f"restored by from_snapshot")
    wt = dict(sim.walltime.totals)
    return dict(nsteps=nsteps, atime=sim.atime, seconds=seconds,
                per_step=per_step, launches=launches, spans=spans,
                walltime=wt,
                wind_kicks=sim.wind_kicks, seeded=list(sim.bh_seeded),
                swallowed=sim.bh_swallowed, mergers=sim.bh_mergers,
                nbh=int(bh.sum()), mdot=mdot.tolist(),
                details=len(details), decoupled=max(h[0] for h in
                                                   hydro_checks),
                snapshot=snaps[-1], snapnum=snapnum, metal_rows=metal_rows)


def report_star_small(star, srres, card):
    """Phase 23's printout."""
    sst = star["step_seconds"]
    wt = star["walltime"]
    layers = ("SPH/Density", "SPH/Hydro", "Cooling/SFR", "Winds",
              "MetalReturn", "BH", "FOF")
    print(f"phase 23, star-small as it ships (2 x {star['ngas']} particles; "
          f"cuts {GENIC_OVERRIDE} in genic and {STAR_SMALL_SWITCHES} in the "
          f"run) on {card}: {star['nsteps']} PM steps to "
          f"a={star['atime']:.6f} in {sum(sst):.6f} s of steps "
          f"({star['run_seconds']:.6f} s with the gas set-up, the first "
          f"forces and the last snapshot); walltime "
          + ", ".join(f"{k} {wt.get(k, 0.0):.6f}" for k in layers)
          + f" s (all layers: "
          + ", ".join(f"{k} {v:.6f}" for k, v in sorted(wt.items()))
          + f"); kernel launches {star['launches']}", flush=True)
    print(f"phase 23: stars {star['nstars']}, wind kicks "
          f"{star['wind_kicks']} (hierarchical steps compute no dispersion, "
          f"as in the JAX package: ROADMAP.md §3 item 9), BHs seeded at "
          f"each FOF {star['seeded']}, BHs {star['nbh']}, gas swallowed "
          f"{star['swallowed']}, mergers {star['mergers']}, blackholes.txt "
          f"lines {star['bh_lines']}, BH-Details-R0 records "
          f"{star['details']}, sfr.txt lines {star['sfr_lines']}; total "
          f"mass {star['m_end']:.9g} against the IC's {star['m_ic']:.9g} "
          f"({star['mass_err']:+.3e}, swallowed gas in the BHs); snapshots "
          f"(a, stars, BHs) {star['snapshots']}; PIGs (groups, BHs) "
          f"{star['pig_groups']}; RestartFlag 3 {srres['seconds']:.6f} s",
          flush=True)
    print_spans("phase 23", star["spans"], card)


def report_global(glob, card):
    """Phase 24's printout."""
    layers = ("SPH/Density", "SPH/Hydro", "Cooling/SFR", "Winds",
              "MetalReturn", "BH", "FOF")
    gw = glob["walltime"]
    print(f"phase 24, global steps from phase 23's PART_"
          f"{glob['snapnum']:03d} (RestartFlag 2, cuts {GLOBAL_SWITCHES}, at "
          f"most {GLOBAL_STEPS} steps) on {card}: {glob['nsteps']} global "
          f"steps to a={glob['atime']:.6f} in {glob['seconds']:.6f} s (the "
          f"restart included); walltime "
          + ", ".join(f"{k} {gw.get(k, 0.0):.6f}" for k in layers)
          + f" s; wind kicks {glob['wind_kicks']}, decoupled gas rows at "
          f"most {glob['decoupled']} (zero hydro force), BHs seeded "
          f"{glob['seeded']}, BHs {glob['nbh']} with mdot {glob['mdot']}, "
          f"gas swallowed {glob['swallowed']}, mergers {glob['mergers']}, "
          f"BH-Details-R0 records {glob['details']}; {glob['snapshot']}'s BH "
          f"blocks read back by from_snapshot; kernel launches "
          f"{glob['launches']}", flush=True)
    print_spans("phase 24", glob["spans"], card)


# -- phase 29: star-small's subgrid physics through the sharded driver -------

# (i) runs phase 23's paramfile copy and IC to STAR_SHARDED_TIME_MAX and is
# held to phase 23's snapshot there; its depth cut: as shipped 0.2, cut
# first (then phase 23's, STAR_SMALL_TIME_MAX) so that the smoke keeps
# within its time with phase 29's two configurations (0.15 is the earliest
# output at which star-small has formed stars).  (ii) resumes phase 23's
# a = 0.15 snapshot with phase 24's
# GLOBAL_SWITCHES (RestartFlag 2, at most GLOBAL_STEPS global steps) and is
# held to phase 24.
STAR_SHARDED_TIME_MAX = 0.15
STAR_SHARDED_TIMEOUT = 600  # seconds for each configuration's ranks
# (i) against phase 23 at a = 0.15: P(k) about four times what was
# measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6);
# the sharded run keeps the box unshifted, bounds its PM step by the
# displacement alone and kicks ofjt10 winds on the hierarchical path
# (ROADMAP.md section 3 item 9: phase 23 kicks none), so its gas and stars
# follow another path.  The counts are small, so each is held to phase 23's
# by an absolute slack below the reference itself (measured: P(k)
# 7.60e-4 (a) and 7.69e-4 (b); stars 3 and 3 against 3, BHs 0 and 0
# against 0, gas rows with Z > 0 17 and 17 against 17; the same at four
# ranks): stars and enriched gas rows must be there (> 0) and within the
# slack; BHs equal (the shipped seeding wants a halo above
# MinFoFMassForNewSeed, 2e10 Msun/h, that no run has at a = 0.15)
STAR_SHARDED_TOL = {"pk": 3e-3, "stars": 2, "bhs": 0, "metal_rows": 5}
# (ii) against phase 24 at the same a: the gas rows with Z > 0 and the
# stars' TotalMassReturned grow past the start snapshot's, and the enriched
# rows are within this fraction of phase 24's, about seven times what was
# measured (the same card: 997 against 983 in (a) and (b), 17 at the
# start; TotalMassReturned 4.43e-3 from 2.14e-4)
STAR_SHARDED_METAL_TOL = 0.1
TWO40 = 1 << 40
# the sharded state carries no minimum-potential position (the JAX
# package's sharded run neither): its snapshots write the other BH blocks
SHARDED_BH_SKIP = ("BlackholeMinPotPos",)


def snapshot_species(bf, hdr):
    """The species of a snapshot or IC present, types 0, 1, 4 and 5
    (io/snapshot.read_species: an IC's masses may stand in the header)."""
    from mpgadget_tpu_torch.io import snapshot as snap_io
    return {t: snap_io.read_species(bf, t, hdr) for t in (0, 1, 4, 5)
            if hdr.TotNumPart[t]}


def snapshot_ids(bf, hdr):
    """Every ID of a snapshot, types 0, 1, 4 and 5."""
    import numpy as np
    return np.concatenate([sp["pid"].astype(np.int64)
                           for sp in snapshot_species(bf, hdr).values()])


def snapshot_mass(bf, hdr):
    import numpy as np
    return sum(float(sp["mass"].astype(np.float64).sum())
               for sp in snapshot_species(bf, hdr).values())


def check_ids(what, ids, ic_ids, ic_gas):
    """Every ID of the IC at most once (swallowed gas gone, converted and
    seeded rows keep theirs); spawned stars' IDs are a gas parent's + 2^40
    and may repeat (ROADMAP.md section 3 item 13)."""
    import numpy as np
    own = ids[ids < TWO40]
    check(len(np.unique(own)) == len(own) and np.isin(own, ic_ids).all(),
          f"{what}: an ID of the IC twice or not the IC's")
    check(np.isin(ids[ids >= TWO40] - TWO40, ic_gas).all(),
          f"{what}: a spawned star's ID is not a gas parent's + 2^40")
    return int(len(ids) - len(own))


def snapshot_counts(bf, hdr):
    """(stars, BHs, gas rows with metallicity > 0) of a snapshot."""
    import numpy as np
    n0 = int(hdr.TotNumPart[0])
    z = bf.open("0/Metallicity").read() if n0 else np.zeros(0)
    return int(hdr.TotNumPart[4]), int(hdr.TotNumPart[5]), int((z > 0).sum())


def star_mass_returned(bf, hdr):
    """The sum of a snapshot's stars' TotalMassReturned."""
    import numpy as np
    if not hdr.TotNumPart[4]:
        return 0.0
    return float(np.asarray(bf.open("4/TotalMassReturned").read(),
                            np.float64).sum())


def star_sharded_phase(workdir, star, glob, device="cuda",
                       configs=SHARDED_CONFIGS, nmesh_pk=64, parts="i ii"):
    """Phase 29, a generator of each configuration's Launch: star-small
    as it ships through the sharded driver, from
    phase 23's IC and paramfile copy (star: star_small_phase's result; glob:
    global_subgrid_phase's), in phase 27's two configurations, each rank
    this script (launch_ranks): (i) to STAR_SHARDED_TIME_MAX,
    held to phase 23's snapshot at that a; (ii) phase 23's a = 0.15
    snapshot resumed (RestartFlag 2) on at most GLOBAL_STEPS global steps
    with GLOBAL_SWITCHES, held to phase 24 (parts: "i" runs (i) alone).
    device "cpu" rehearses it (every rank on gloo)."""
    import shutil
    import numpy as np
    from mpgadget_tpu_torch.io.bigfile import BigFile
    from mpgadget_tpu_torch.io import snapshot as snap_io
    from mpgadget_tpu_torch.params import create_gadget_parameter_set
    os.makedirs(workdir, exist_ok=True)
    ps = create_gadget_parameter_set()
    ps.parse_file(star["paramfile"])
    base = os.path.dirname(os.path.abspath(star["paramfile"]))
    ic = os.path.join(base, ps["InitCondFile"])
    ref_name = sorted(n for n, v in star["snapshots"].items()
                      if abs(v[0] - STAR_SHARDED_TIME_MAX) < 1e-6)[:1]
    check(len(ref_name) == 1, f"phase 23 wrote no snapshot at a = "
          f"{STAR_SHARDED_TIME_MAX}: {star['snapshots']}")
    ref_snap = os.path.join(star["out"], ref_name[0])
    snapnum = int(ref_name[0].split("_")[-1])
    rbf = BigFile(ref_snap)
    rhdr = snap_io.read_header(rbf)
    ref = dict(zip(("stars", "bhs", "metal_rows"),
                   snapshot_counts(rbf, rhdr)))
    ref_returned = star_mass_returned(rbf, rhdr)
    k0, p0, n0, knyq = snapshot_power(ref_snap, device, nmesh_pk)
    icb = BigFile(ic)
    ih = snap_io.read_header(icb)
    ic_ids = snapshot_ids(icb, ih)
    ic_gas = snapshot_species(icb, ih)[0]["pid"].astype(np.int64)
    ic_mass = snapshot_mass(icb, ih)
    text = open(star["paramfile"]).read()

    def paramfile(name, out, over):
        lines = []
        for ln in text.splitlines():
            key = ln.split("=")[0].strip()
            if key == "InitCondFile":
                ln = f"InitCondFile = {ic}"
            elif key == "OutputDir":
                ln = f"OutputDir = {out}"
            elif key in over:
                continue
            lines.append(ln)
        lines += [f"{k} = {v}" for k, v in over.items()]
        pf = os.path.join(workdir, f"paramfile_29_{name}.gadget")
        with open(pf, "w") as fh:
            fh.write("\n".join(lines) + "\n")
        return pf

    results = {}
    for name, nranks, env_over in configs:
        # (i) from the IC and (ii) from phase 23's a = 0.15 snapshot, one
        # run after the other in one launch of the ranks
        out = os.path.join(workdir, f"star_{name}")
        pf = paramfile(name, out, {"TimeMax": STAR_SHARDED_TIME_MAX})
        prefix = os.path.join(workdir, f"star_{name}")
        what = f"sharded star-small {name}"
        argv = [[pf, prefix, device, "star"]]
        out2 = os.path.join(workdir, f"star_global_{name}")
        prefix2 = os.path.join(workdir, f"star_global_{name}")
        what2 = f"sharded global subgrid {name}"
        if "ii" in parts.split():
            os.makedirs(out2)
            shutil.copytree(ref_snap, os.path.join(out2, ref_name[0]))
            pf2 = paramfile(f"global_{name}", out2, GLOBAL_SWITCHES)
            argv.append([pf2, prefix2, device, "star", f"restart={snapnum}",
                         f"max_steps={GLOBAL_STEPS}"])
        runs, wall = yield Launch(what, nranks, env_over, argv,
                                  STAR_SHARDED_TIMEOUT, [None] * len(argv))
        ranks = runs[0]
        r0 = ranks[0]
        check(abs(r0["atime"] - STAR_SHARDED_TIME_MAX) < 1e-9,
              f"{what} stopped at a={r0['atime']}")
        snaps = sorted(f for f in os.listdir(out) if f.startswith("PART_"))
        last = os.path.join(out, snaps[-1])
        bf = BigFile(last)
        hdr = snap_io.read_header(bf)
        check(abs(hdr.Time - STAR_SHARDED_TIME_MAX) < 1e-9,
              f"{what}: {snaps[-1]} at a={hdr.Time}")
        check(bf.open("1/ID").Nfile == nranks,
              f"{what}: not one stripe a rank")
        dup = check_ids(what, snapshot_ids(bf, hdr), ic_ids, ic_gas)
        m = snapshot_mass(bf, hdr)
        check(abs(m / ic_mass - 1) <= MASS_TOL, f"{what}: mass {m!r} "
              f"against the IC's {ic_mass!r}")
        for t, blocks in ((4, ("StarFormationTime", "Metallicity", "Metals",
                               "TotalMassReturned")), (0, ("Metals",))):
            for block in blocks if hdr.TotNumPart[t] else ():
                v = np.asarray(bf.open(f"{t}/{block}").read(), np.float64)
                check(v.shape[0] == hdr.TotNumPart[t]
                      and np.isfinite(v).all(),
                      f"{what}: {t}/{block} does not read back")
        check_bh_blocks(f"{what} {snaps[-1]}", bf, hdr, SHARDED_BH_SKIP)
        got = dict(zip(("stars", "bhs", "metal_rows"),
                       snapshot_counts(bf, hdr)))
        k1, p1, n1, _ = snapshot_power(last, device, nmesh_pk)
        check(np.array_equal(n1, n0), f"{what}: P(k) mode counts")
        low = k0 < knyq / 4
        dev = {"pk": float(np.max(np.abs(p1[low] / p0[low] - 1)))}
        print(f"{what} (i) against phase 23's {ref_name[0]} at a="
              f"{STAR_SHARDED_TIME_MAX}: P(k) on {int(low.sum())} bins below "
              f"k_Nyquist/4 = {knyq / 4:.6f} h/Mpc relative "
              f"{dev['pk']:.6e} (tolerance {STAR_SHARDED_TOL['pk']}); "
              + ", ".join(f"{k} {got[k]} vs {ref[k]} (tolerance "
                          f"+-{STAR_SHARDED_TOL[k]})" for k in ref)
              + f"; spawned-star IDs {dup}; mass {m!r} against the IC's "
              f"{ic_mass!r}; wind kicks {r0['wind_kicks']} (phase 23: "
              f"{star['wind_kicks']}), gas swallowed {r0['swallowed']}, "
              f"mergers {r0['mergers']}, BHs seeded {r0['seeded']}, stars "
              f"formed per rank {[rk['formed_here'] for rk in ranks]}",
              flush=True)
        check(dev["pk"] <= STAR_SHARDED_TOL["pk"], f"{what}: P(k) off "
              f"phase 23's by {dev['pk']:.3e}")
        for k in ref:
            check(abs(got[k] - ref[k]) <= STAR_SHARDED_TOL[k],
                  f"{what}: {k} {got[k]} against phase 23's {ref[k]}")
        check(got["stars"] > 0 and got["metal_rows"] > 0
              and r0["wind_kicks"] > 0,
              f"{what}: stars {got['stars']}, gas rows with Z > 0 "
              f"{got['metal_rows']}, wind kicks {r0['wind_kicks']}")
        res = dict(ranks=ranks, wall=wall, dev=dev, got=got,
                   snapshots=snaps)
        results[name] = res
        if len(runs) == 1:
            continue
        # ---- (ii) global steps from phase 23's a = 0.15 snapshot ----
        ranks2 = runs[1]
        g0 = ranks2[0]
        seeded_mdot = [md for md, af in zip(g0["bh_mdot"], g0["bh_formed"])
                       if af > 0.15 + 1e-7]
        snaps2 = sorted(f for f in os.listdir(out2) if f.startswith("PART_")
                        and f != ref_name[0])
        check(snaps2, f"{what2}: no snapshot")
        bf2 = BigFile(os.path.join(out2, snaps2[-1]))
        hdr2 = snap_io.read_header(bf2)
        n5 = check_bh_blocks(f"{what2} {snaps2[-1]}", bf2, hdr2,
                             SHARDED_BH_SKIP)
        for block in ("StarFormationTime", "Metals", "TotalMassReturned"):
            if hdr2.TotNumPart[4]:
                v = np.asarray(bf2.open(f"4/{block}").read(), np.float64)
                check(v.shape[0] == hdr2.TotNumPart[4]
                      and np.isfinite(v).all(),
                      f"{what2}: 4/{block} does not read back")
        metal_rows2 = snapshot_counts(bf2, hdr2)[2]
        returned2 = star_mass_returned(bf2, hdr2)
        print(f"{what2} (ii) against phase 24: {g0['nsteps']} global steps "
              f"to a={g0['atime']:.6f} ({glob['nsteps']} to "
              f"{glob['atime']:.6f}); wind kicks {g0['wind_kicks']} "
              f"({glob['wind_kicks']}), BHs seeded {g0['seeded']} "
              f"({glob['seeded']}), the seeded BHs' mdot {seeded_mdot}, gas "
              f"swallowed {g0['swallowed']} ({glob['swallowed']}), mergers "
              f"{g0['mergers']} ({glob['mergers']}); {snaps2[-1]}: {n5} BHs, "
              f"{int(hdr2.TotNumPart[4])} stars, their blocks read back, gas "
              f"rows with Z > 0 {metal_rows2} ({glob['metal_rows']}; "
              f"{ref['metal_rows']} at the start, tolerance "
              f"{STAR_SHARDED_METAL_TOL} relative), the stars' "
              f"TotalMassReturned {returned2!r} ({ref_returned!r} at the "
              f"start)", flush=True)
        check(g0["wind_kicks"] > 0, f"{what2}: no wind kick")
        check(sum(g0["seeded"]) > 0 and any(md > 0 for md in seeded_mdot),
              f"{what2}: no seeded BH accretes: seeded {g0['seeded']}, "
              f"mdot {seeded_mdot}")
        check(n5 > 0, f"{what2}: {snaps2[-1]} holds no BH")
        check(metal_rows2 > ref["metal_rows"] and returned2 > ref_returned
              and abs(metal_rows2 - glob["metal_rows"])
              <= STAR_SHARDED_METAL_TOL * glob["metal_rows"],
              f"{what2}: metal return: gas rows with Z > 0 {metal_rows2} "
              f"against phase 24's {glob['metal_rows']} and the start's "
              f"{ref['metal_rows']}; TotalMassReturned {returned2!r} against "
              f"the start's {ref_returned!r}")
        # (ii)'s processes are (i)'s: the launch's wall seconds stand in both
        res["global"] = dict(ranks=ranks2, wall=wall)
    return results


def report_star_sharded(p29, card):
    """Phase 29's lines: per configuration and part the PM steps,
    substeps, seconds, collectives and rank 0's walltime by layer (Winds,
    BH and MetalReturn among them), and rank 0's K3 and pair_reduce card
    time by caller."""
    for name, r in p29.items():
        for part, rr, what in (("i", r, f"star-small to a="
                                f"{STAR_SHARDED_TIME_MAX}"),
                               ("ii", r.get("global"),
                                "global subgrid steps")):
            if rr is None:
                continue
            report_sharded({f"{name} ({part})": rr}, card, what)
            print_spans(f"phase 29 {name} ({part}) rank 0",
                        {c: {k: tuple(v) for k, v in d.items()}
                         for c, d in rr["ranks"][0].get("spans", {}).items()},
                        card)


# -- phase 30: the sharded options --------------------------------------------

# Phase 30 runs phases 18, 20, 21 and 26's configurations through the
# sharded driver in phase 27's two configurations, each configuration's
# ranks started once for the four runs.  Depth cuts (the widths are the
# phases' own): the neutrino run to a = 0.2 (phase 18 runs to dm-small's
# 0.25; the planes at 0.2), the hybrid run to 0.205 (phase 20: 0.22;
# NuPartTime 0.2 stays inside it), the reionization run to 0.16 (phase 26:
# 0.17; the excursion epoch and the HeII history both cover it).
OPT_NU_TIME_MAX = 0.2
OPT_HYBRID_TIME_MAX = 0.205
OPT_REION_TIME_MAX = 0.16
OPT_SHARDED_TIMEOUT = 900   # seconds for each configuration's ranks
# about 3x what was measured on an NVIDIA H100 80GB HBM3 at 700 W (first
# run, both configurations): the neutrino run's P(k) at a = 0.2 against
# phase 18's on the bins below k_Nyquist/4, 1.28e-3 (the sharded run keeps
# the box unshifted, phase 18 shifts it every PM step, as in phase 27);
# the light cone's rows against phase 21's, relative: 1.6e-6 (19 of 11.6
# million rows: float32 rounding at the shell's edges)
OPT_SHARDED_TOL = {"pk": 4e-3, "lc_rows": 5e-6}


def options_sharded_phase(workdir, nu, hyb, lcone, reion, star,
                          device="cuda", configs=SHARDED_CONFIGS,
                          nmesh_pk=None):
    """Phase 30, a generator of each configuration's Launch: the
    dark-matter options and reionization through the
    sharded driver, in phase 27's two configurations, each configuration's
    ranks (this script, --sharded-rank) started once for four runs: (1)
    phase 18's neutrino run (its IC and paramfile, planes) to
    OPT_NU_TIME_MAX: every rank's delta_tot history an entry a PM step
    and one for the first forces, the P(k) rank 0 wrote at the end
    against phase 18's at the same a on the bins below k_Nyquist/4, the
    planes finite with zero mean; (2) phase 20's hybrid run to
    OPT_HYBRID_TIME_MAX: on every rank the type-2 rows' PM acceleration
    zero at each PM refresh before NuPartTime and not after; (3) phase 21's
    light cone: one stripe a rank, every row inside the shell the run
    crossed, as many rows as phase 21's within OPT_SHARDED_TOL; (4) phase
    26's reionization run, phase 23's a = 0.15 snapshot resumed to
    OPT_REION_TIME_MAX: K1-K6 launched on every rank, the excursion set
    updated, gas with J21 > 0 each with zreion set, HeIII-ionized gas each
    row inside the bubble that ionized it, the mass against the
    snapshot's, the last snapshot's J21, ZReionized and HeIIIIonized
    blocks read back.  device "cpu" rehearses it (every rank on gloo)."""
    import shutil
    import numpy as np
    from mpgadget_tpu_torch.io.bigfile import BigFile
    from mpgadget_tpu_torch.io import snapshot as snap_io
    os.makedirs(workdir, exist_ok=True)
    nmesh_pk = nmesh_pk or nu["sim"].cfg.nmesh

    def ic_of(res):
        """The absolute IC path of a dm_variant run's paramfile."""
        with open(res["paramfile"]) as fh:
            ic = [ln.split("=", 1)[1].strip() for ln in fh
                  if ln.split("=")[0].strip() == "InitCondFile"][-1]
        return os.path.join(os.path.dirname(res["paramfile"]), ic)

    name_pk = f"powerspectrum-{OPT_NU_TIME_MAX:0.4f}.txt"
    p0 = np.loadtxt(os.path.join(nu["out"], name_pk))
    box_mpc = (nu["sim"].cfg.boxsize * nu["sim"].cfg.units.UnitLength_in_cm
               / 3.085678e24)
    knyq = np.pi * nmesh_pk / box_mpc
    nvalid = int(nu["sim"].pdata.num_valid)
    lc_ref = lcone["sim"]._lightcone
    lc_rows_ref = lc_ref.n_written
    lo = lc_ref.get_horizon(lcone["sim"].atime)
    hi = lc_ref.get_horizon(lcone["sim"].time_ic)
    snapnum = reion["snapnum"]
    src = os.path.join(star["out"], f"PART_{snapnum:03d}")
    results = {}
    for name, nranks, env_over in configs:
        outs = {k: os.path.join(workdir, f"{k}_{name}")
                for k in ("nu", "hybrid", "lightcone", "reion")}
        pfs = {
            "nu": paramfile_copy(nu["paramfile"], outs["nu"] + ".gadget", {
                "InitCondFile": ic_of(nu), "OutputDir": outs["nu"],
                "TimeMax": OPT_NU_TIME_MAX,
                "OutputList": f"0.15,{OPT_NU_TIME_MAX}",
                "PlaneOutputList": OPT_NU_TIME_MAX}),
            "hybrid": paramfile_copy(
                hyb["paramfile"], outs["hybrid"] + ".gadget", {
                    "InitCondFile": ic_of(hyb), "OutputDir": outs["hybrid"],
                    "TimeMax": OPT_HYBRID_TIME_MAX,
                    "OutputList": OPT_HYBRID_TIME_MAX}),
            "lightcone": paramfile_copy(
                lcone["paramfile"], outs["lightcone"] + ".gadget", {
                    "InitCondFile": ic_of(lcone),
                    "OutputDir": outs["lightcone"]}),
            "reion": paramfile_copy(
                reion["paramfile"], outs["reion"] + ".gadget", {
                    "OutputDir": outs["reion"],
                    "TimeMax": OPT_REION_TIME_MAX,
                    "OutputList": f"0.125,0.15,{OPT_REION_TIME_MAX}"})}
        os.makedirs(outs["reion"])
        shutil.copytree(src, os.path.join(outs["reion"],
                                          os.path.basename(src)))
        argv = [[pfs[key], os.path.join(workdir, f"p30_{key}_{name}"),
                 device] + extra
                for key, extra in (("nu", ["nu"]), ("hybrid", ["hybrid"]),
                                   ("lightcone", []),
                                   ("reion", ["reion",
                                              f"restart={snapnum}"]))]
        what = f"sharded options {name}"
        runs, wall = yield Launch(what, nranks, env_over, argv,
                                  OPT_SHARDED_TIMEOUT,
                                  [("pair", "walk", "neighbors")] * 4)
        res = dict(zip(("nu", "hybrid", "lightcone", "reion"),
                       ({"ranks": r, "wall": wall} for r in runs)))
        # ---- (1) neutrinos ----
        r0 = runs[0][0]
        check(abs(r0["atime"] - OPT_NU_TIME_MAX) < 1e-9,
              f"{what} neutrinos stopped at a={r0['atime']}")
        for rk in runs[0]:
            check(rk["nu_entries"] == rk["nsteps"] + 1, f"{what} rank "
                  f"{rk['rank']}: delta_tot history of {rk['nu_entries']} "
                  f"entries for {rk['nsteps']} PM steps and the first forces")
        p1 = np.loadtxt(os.path.join(outs["nu"], name_pk))
        check(p1.shape == p0.shape and np.allclose(p1[:, 0], p0[:, 0],
                                                   rtol=1e-5),
              f"{what}: {name_pk} bins {p1.shape} against {p0.shape}")
        low = p0[:, 0] < knyq / 4
        dev_pk = float(np.max(np.abs(p1[low, 1] / p0[low, 1] - 1)))
        planes = sorted(f for f in os.listdir(outs["nu"])
                        if f.endswith(".fits"))
        check(len(planes) == 3, f"{what}: planes written {planes}")
        prms = []
        for f in planes:
            cards, pix = read_fits(os.path.join(outs["nu"], f))
            rms = float(np.sqrt(np.mean(pix.astype(np.float64) ** 2)))
            npart = int(cards["NPART"])
            check(np.isfinite(pix).all() and rms > 0
                  and abs(float(pix.astype(np.float64).mean())) < 1e-4 * rms
                  and 0.999 * nvalid <= npart <= nvalid,
                  f"{what}: plane {f}: rms {rms}, cards {cards}")
            prms.append(rms)
        res["nu"].update(pk_dev=dev_pk, planes=len(planes), plane_rms=prms)
        print(f"{what} (1) neutrinos to a={r0['atime']:.6f}: {r0['nsteps']} "
              f"PM steps, delta_tot history {r0['nu_entries']} entries; "
              f"{name_pk} against phase 18's on {int(low.sum())} bins below "
              f"k_Nyquist/4 = {knyq / 4:.6f} h/Mpc: largest relative "
              f"difference {dev_pk:.6e} (tolerance {OPT_SHARDED_TOL['pk']}),"
              f" all bins {float(np.max(np.abs(p1[:, 1] / p0[:, 1] - 1))):.6e};"
              f" planes {planes}: finite, zero mean, rms "
              + ", ".join(f"{x:.6e}" for x in prms) + " rad^2", flush=True)
        check(dev_pk <= OPT_SHARDED_TOL["pk"], f"{what}: neutrino P(k) off "
              f"phase 18's by {dev_pk:.3e}")
        # ---- (2) hybrid neutrinos ----
        r0 = runs[1][0]
        check(abs(r0["atime"] - OPT_HYBRID_TIME_MAX) < 1e-9,
              f"{what} hybrid stopped at a={r0['atime']}")
        for rk in runs[1]:
            seen = rk["tracer_pm"]
            before = [x for x in seen if x[1]]
            after = [x for x in seen if not x[1]]
            check(before and after and all(x[2] == 0 for x in before)
                  and all(x[2] > 0 for x in after)
                  and all(x[0] <= 0.2 + 1e-9 for x in before)
                  and all(x[0] > 0.2 for x in after),
                  f"{what} hybrid rank {rk['rank']}: type-2 PM acceleration "
                  f"at the PM refreshes {seen}")
        res["hybrid"]["tracer_pm"] = [rk["tracer_pm"] for rk in runs[1]]
        print(f"{what} (2) hybrid to a={r0['atime']:.6f}: {r0['nsteps']} PM "
              f"steps; per rank the type-2 rows' largest |PM acceleration| "
              + "; ".join(
                  f"rank {rk['rank']}: 0 at {sum(x[1] for x in rk['tracer_pm'])}"
                  f" refreshes before NuPartTime, "
                  f"{min(x[2] for x in rk['tracer_pm'] if not x[1]):.6e}.."
                  f"{max(x[2] for x in rk['tracer_pm'] if not x[1]):.6e} at "
                  f"{sum(not x[1] for x in rk['tracer_pm'])} after"
                  for rk in runs[1]), flush=True)
        # ---- (3) the light cone ----
        r0 = runs[2][0]
        ldir = os.path.join(outs["lightcone"], "lightcone", "000")
        stripes = sorted(os.listdir(ldir))
        check(stripes == [f"lightcone-{r:05d}.raw" for r in range(nranks)],
              f"{what}: light cone stripes {stripes}")
        rows = np.concatenate([np.fromfile(os.path.join(ldir, f), np.float64)
                               .reshape(-1, 4) for f in stripes])
        d = np.linalg.norm(rows[:, :3], axis=1)
        check(len(rows) > 0 and bool(
            ((d >= lo * (1 - 1e-6)) & (d <= hi * (1 + 1e-6))).all()
            & ((rows[:, 3] > 0) & (rows[:, 3] <= 1)).all()),
              f"{what}: light cone rows outside the shell [{lo}, {hi}]")
        lc_dev = abs(len(rows) / lc_rows_ref - 1)
        res["lightcone"].update(rows=len(rows), dev=lc_dev,
                                per_stripe=[os.path.getsize(
                                    os.path.join(ldir, f)) // 32
                                    for f in stripes])
        print(f"{what} (3) light cone to a={r0['atime']:.6f}: {len(rows)} "
              f"rows (phase 21: {lc_rows_ref}, relative {lc_dev:.6e}, "
              f"tolerance {OPT_SHARDED_TOL['lc_rows']}), per stripe "
              f"{res['lightcone']['per_stripe']}, all inside "
              f"{lo / 1000:.3f}..{hi / 1000:.3f} Mpc/h", flush=True)
        check(lc_dev <= OPT_SHARDED_TOL["lc_rows"], f"{what}: {len(rows)} "
              f"light cone rows against phase 21's {lc_rows_ref}")
        # ---- (4) reionization ----
        r0 = runs[3][0]
        check(abs(r0["atime"] - OPT_REION_TIME_MAX) < 1e-9,
              f"{what} reionization stopped at a={r0['atime']}")
        if device == "cuda":
            for rk in runs[3]:
                check(min(rk["launches"].values()) > 0, f"{what} "
                      f"reionization rank {rk['rank']}: a kernel was not "
                      f"launched: {rk['launches']}")
        bub = [b for rk in runs[3] for b in rk.get("bubbles", [])]
        worst = max((b[0] for b in bub), default=0.0)
        m_err = r0["mass"] / reion["m_snap"] - 1
        check(r0["uvbg_updates"] and r0["n_j21"] > 0 and r0["n_zre"] > 0
              and r0["n_j21_no_zre"] == 0,
              f"{what}: excursion set: updates {r0['uvbg_updates']}, gas "
              f"with J21 > 0 {r0['n_j21']}, zreion set {r0['n_zre']}, J21 > 0"
              f" without zreion {r0['n_j21_no_zre']}")
        check(r0["n_heiii"] > 0 and r0["qso_bubbles"] > 0
              and worst < 1 + 1e-5
              and r0["n_heiii"] <= sum(b[1] for b in bub),
              f"{what}: HeIII rows {r0['n_heiii']}, bubbles "
              f"{r0['qso_bubbles']}, rows ionized by the bubbles "
              f"{sum(b[1] for b in bub)}, largest distance over radius "
              f"{worst}")
        check(abs(m_err) < MASS_TOL, f"{what}: reionization mass "
              f"{r0['mass']!r} against the snapshot's {reion['m_snap']!r}")
        snaps = sorted(f for f in os.listdir(outs["reion"])
                       if f.startswith("PART_") and f != os.path.basename(src))
        check(snaps, f"{what}: the reionization run wrote no snapshot")
        bf = BigFile(os.path.join(outs["reion"], snaps[-1]))
        hdr = snap_io.read_header(bf)
        blk = {}
        for bname in ("J21", "ZReionized", "HeIIIIonized"):
            v = bf.open(f"0/{bname}").read()
            check(v.shape[0] == hdr.TotNumPart[0] and np.isfinite(
                v.astype(np.float64)).all()
                  and bf.open(f"0/{bname}").Nfile == nranks,
                  f"{what}: {snaps[-1]} 0/{bname} does not read back")
            blk[bname] = v
        check(((blk["J21"] > 0) <= (blk["ZReionized"] >= 0)).all()
              and (blk["J21"] > 0).sum() > 0
              and (blk["HeIIIIonized"] > 0).sum() > 0,
              f"{what}: {snaps[-1]}: J21 > 0 rows {(blk['J21'] > 0).sum()} "
              f"without zreion, HeIII rows {(blk['HeIIIIonized'] > 0).sum()}")
        res["reion"].update({k: r0[k] for k in (
            "n_j21", "n_zre", "n_heiii", "n_metal", "ngas", "qso_bubbles",
            "uvbg_updates")}, worst=worst, mass_err=m_err,
            blocks={k: int((v > 0).sum()) for k, v in blk.items()})
        print(f"{what} (4) reionization from phase 23's a = 0.15 to "
              f"a={r0['atime']:.6f}: {r0['nsteps']} PM steps; UVBG updates "
              f"{len(r0['uvbg_updates'])} (z, vol xHI, mass xHI) "
              f"{r0['uvbg_updates']}; gas {r0['ngas']}: J21 > 0 "
              f"{r0['n_j21']}, zreion set {r0['n_zre']}, HeIII "
              f"{r0['n_heiii']} from {r0['qso_bubbles']} bubbles (phase 26: "
              f"{reion['n_j21']}, {reion['n_zre']}, {reion['n_heiii']} to "
              f"a={reion['atime']:.6f}), rows no farther than "
              f"{worst:.6f} of their bubble's radius, Z > 0 "
              f"{r0['n_metal']}; mass {m_err:+.3e} against the snapshot's; "
              f"{snaps[-1]} blocks read back, rows > 0 {res['reion']['blocks']}",
              flush=True)
        results[name] = res
    return results


def report_options_sharded(p30, card):
    """Phase 30's lines: per configuration and run the PM steps, seconds,
    collectives and rank 0's walltime by layer (Lightcone, Planes, HeIII,
    UVBG and PMgrav among them)."""
    for name, r in p30.items():
        for key, what in (("nu", f"neutrinos to a={OPT_NU_TIME_MAX}"),
                          ("hybrid", f"hybrid to a={OPT_HYBRID_TIME_MAX}"),
                          ("lightcone", "light cone in 500 Mpc/h"),
                          ("reion", f"reionization to a="
                                    f"{OPT_REION_TIME_MAX}")):
            report_sharded({f"{name} ({key})": r[key]}, card, what)


# -- phases 25-26: travis as it ships, and reionization on star-small -------

# phase 25 runs travis to its TimeMax; its cuts beyond the spectrum
# (travis_phase's): the absent cooling_metal_UVB (the stand-in of
# write_metal_table in its place) and TREECOOL_fg_june11 (no UV background,
# as lya and star-small run).
# phase 26: phase 23's snapshot at a = 0.15 resumed (RestartFlag 2,
# hierarchical as shipped) to REION_TIME_MAX with the four switches on,
# each reading a stand-in the smoke writes from a closed form; the
# excursion epoch z 6 to 5.35 ends inside the run, and the late patch of
# the z_reion grid switches on at REION_ZRE_LATE (a = 0.16); QSOMinMass and
# QSOMaxMass bracket the largest halo of the snapshot's PIG
# (REION_QSO_BRACKET) and the bubbles are REION_BUBBLE kpc/h (the 20 Mpc/h
# default covers the 5 Mpc/h box).  The depth cut: star-small ends at
# a = 0.2; 0.162 keeps the smoke within its time (a FOF at every PM step of
# the HeII epoch: 285 s to 0.2, 192 s to 0.19, 152-184 s to 0.185 and
# 75-93 s to 0.17 on an NVIDIA H100 80GB HBM3, 700 W), with the epoch's end
# (z 5.35, a = 0.1575) and the late patch (z_re 5.25, a = 0.16) moved
# before it (to 0.17 until PR 17, with z 5.2 and 5)
REION_TIME_MAX = 0.162
REION_ZRE_EARLY = 20.0
REION_ZRE_LATE = 5.25
REION_ZRE_TOL = 1e-3
REION_BUBBLE = 1000.0
REION_QSO_BRACKET = (0.5, 2.0)
REION_SWITCHES = {"ExcursionSetReionOn": 1, "ExcursionSetZStart": 6,
                  "ExcursionSetZStop": 5.35, "QSOLightupOn": 1,
                  "QSOMeanBubble": REION_BUBBLE,
                  # star-small's outputs to the depth cut
                  "TimeMax": REION_TIME_MAX,
                  "OutputList": f"0.125,0.15,{REION_TIME_MAX}"}
# the HeII history (z, XHeIII, LMFP heating erg/s/cm^3): z 5.6 to 4, below
# the finish fraction at its end (no flash ionization)
REION_HEII = ((5.6, 0.0, 0.0), (4.8, 0.3, 1e-33), (4.0, 0.6, 2e-33))
# K6 with its per-row inputs (the metal lookup in closing(): the two log10
# of its coordinates (2 logs, 2 scalings, 2 maxima, 2 roundings), per axis
# the scaled coordinate, its two clamps, the corner cell's conversion and
# two clamps and the weight (8 a coordinate), per corner the weight's two
# products, its three selects and the index (5), the load and the sum (12
# a corner), then Z times the rate and the subtraction; 2 of them logs)
COOL_METAL_OPS = 8 + 3 * 8 + 8 * 12 + 2
COOL_METAL_TRANSC = 2


def write_metal_table(path):
    """A Cloudy-layout metal cooling table from a closed form (the absent
    cooling_metal_UVB): 1e-23 (1 + z) exp(-(log nH + 2)^2) exp(-(log T -
    5)^2) erg cm^3/s on z 0..10 (6 bins), log nH -6..3 (10), log T 2..9
    (15), as tests/test_torch_reion.py writes it."""
    import numpy as np
    from mpgadget_tpu_torch.io.bigfile import BigFile
    z = np.linspace(0.0, 10.0, 6)
    lognh = np.linspace(-6.0, 3.0, 10)
    logt = np.linspace(2.0, 9.0, 15)
    zz, nn, tt = np.meshgrid(z, lognh, logt, indexing="ij")
    tab = 1e-23 * (1 + zz) * np.exp(-(nn + 2) ** 2) * np.exp(-(tt - 5) ** 2)
    bf = BigFile(path, create=True)
    bf.create_from_array("MetallicityInSolar_bins", np.array([0.0]))
    bf.create_from_array("Redshift_bins", z)
    bf.create_from_array("HydrogenNumberDensity_bins", lognh)
    bf.create_from_array("Temperature_bins", logt)
    bf.create_from_array("NetCoolingRate", tab.ravel())
    return path


def write_reion_inputs(workdir, box_mpc):
    """Phase 26's stand-ins in workdir: the metal table; a TreeCool table,
    Gamma_X = 10^(-12 - X - lz / 2), Qdot_X = 10^(-24 - X - lz / 2) (X = 0,
    1, 2 for HI, HeI, HeII) at lz = log10(1 + z) in 0 .. 1.2, so that the UV
    background is not zero; a z_reion grid at Nmesh 8 for the box, z_re =
    REION_ZRE_LATE on x >= box / 2 and REION_ZRE_EARLY elsewhere; the HeII
    history REION_HEII (alpha_q 1.7, Emax 150 eV).  Returns their paths."""
    import numpy as np
    from mpgadget_tpu_torch.io.bigfile import BigFile
    paths = {"MetalCoolFile": write_metal_table(
        os.path.join(workdir, "metalcool"))}
    lz = np.linspace(0.0, 1.2, 25)
    cols = [lz] + [10 ** (-12 - c - lz / 2) for c in range(3)] \
        + [10 ** (-24 - c - lz / 2) for c in range(3)]
    paths["TreeCoolFile"] = os.path.join(workdir, "TREECOOL")
    with open(paths["TreeCoolFile"], "w") as fh:
        for row in np.stack(cols, axis=1):
            fh.write(" ".join(f"{x:.6e}" for x in row) + "\n")
    tab = np.full((8, 8, 8), REION_ZRE_EARLY)
    tab[4:] = REION_ZRE_LATE
    paths["UVFluctuationFile"] = os.path.join(workdir, "zreion")
    bf = BigFile(paths["UVFluctuationFile"], create=True)
    blk = bf.create_from_array("Zreion_Table", tab.ravel())
    blk.attrs["Nmesh"] = np.asarray([8], "<u8")
    blk.attrs["BoxSize"] = np.asarray([box_mpc], "<f8")
    blk.attrs["Redshift"] = np.asarray([7.0], "<f8")
    paths["ReionHistFile"] = os.path.join(workdir, "heii.txt")
    with open(paths["ReionHistFile"], "w") as fh:
        fh.write("1.7\n150.0\n")
        for z, x, lm in REION_HEII:
            fh.write(f"{z} {x} {lm}\n")
    return paths


def kernel_modules():
    """The six kernels' modules, by the name their launch counts go by."""
    from mpgadget_tpu_torch.gravity import pairkernel as pk
    from mpgadget_tpu_torch.gravity import treewalk as tw
    from mpgadget_tpu_torch.ops import pairs
    from mpgadget_tpu_torch.physics import cooling
    from mpgadget_tpu_torch.sph import density, hydra
    return {"pair": pk, "walk": tw, "neighbors": pairs, "density": density,
            "hydro": hydra, "cooling": cooling}


def travis_phase(workdir, device="cuda", ngrid=None, nmesh=None):
    """Phase 25: examples/travis as it ships: genic (GENIC_OVERRIDE) through
    the CLI, then paramfile.gadget with its MetalCoolFile pointing at the
    stand-in table and TreeCoolFile empty -> build_simulation ->
    Simulation.run() (hierarchical; cooling with the metal table, star
    formation, ofjt10 winds, metal return, black holes, FOF at each output)
    -> write_snapshot, the six kernels' launch counts reset just before and
    read just after.  Checks: every kernel launched, the metal table read
    and the gas's metallicity fed to K6 (CoolingSpy), the total mass kept,
    the gas state finite, each snapshot and PIG read back.  Returns the
    measurements."""
    import numpy as np
    import torch
    from mpgadget_tpu_torch.io.bigfile import BigFile
    from mpgadget_tpu_torch.io import snapshot as snap_io
    from mpgadget_tpu_torch.main import build_simulation

    over = dict(GENIC_OVERRIDE)
    if ngrid is not None:           # a smaller rehearsal on the CPU
        over["Ngrid"] = ngrid
    _, ngas, genic_s = gas_genic(workdir, "travis", over, device)
    cuts = {"MetalCoolFile": write_metal_table(
        os.path.join(workdir, "metalcool")), "TreeCoolFile": ""}
    gover = dict(cuts)
    if nmesh is not None:
        gover["Nmesh"] = nmesh
    paramfile = paramfile_copy(
        os.path.join(HERE, "examples", "travis", "paramfile.gadget"),
        os.path.join(workdir, "paramfile.gadget"), gover)
    mods = kernel_modules()
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        sim, _ = build_simulation(paramfile, device=device)
        c = sim.cfg
        check(c.hydro_on and c.cooling_on and c.starformation_on
              and c.wind_on and c.metal_return_on and c.black_hole_on
              and c.split_gravity_timesteps and c.snapshot_with_fof
              and c.metal_cool_file, "travis's paramfile.gadget no longer "
              "sets HydroOn, CoolingOn, StarformationOn, WindOn, "
              "MetalReturnOn, BlackHoleOn, SplitGravityTimestepsOn, "
              "SnapshotWithFOF and MetalCoolFile")
        out = os.path.abspath(c.output_dir)
        m_ic = total_mass(sim)
        for mod in mods.values():
            mod.LAUNCHES = 0
        t0 = time.perf_counter()
        with CoolingSpy() as spy:
            nsteps = sim.run(verbose=False)
            sim.write_snapshot()
        if device == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: mod.LAUNCHES for k, mod in mods.items()}
    finally:
        os.chdir(cwd)
    check(sim.ti_current == sim.timeline.ti_end,
          f"travis ran {nsteps} PM steps to a={sim.atime}")
    if device == "cuda":
        check(min(launches.values()) > 0, f"a kernel of the travis path "
              f"was not launched: {launches}")
    check(sim._cooling.metal_table is not None and spy.calls > 0
          and spy.last is not None
          and spy.last[1].get("metallicity") is not None,
          "travis's cooling ran without the metal table or metallicity")
    pd, sph, gas = sim.pdata, sim.sph, sim.gas_mask
    check(bool(torch.isfinite(pd.vel[pd.valid]).all()
               & torch.isfinite(sph.entropy[gas]).all()
               & (sph.entropy[gas] > 0).all()),
          "travis gas state not finite or entropy not positive")
    m_end = total_mass(sim)
    mass_err = m_end / m_ic - 1
    check(abs(mass_err) < MASS_TOL, f"travis total mass {m_end!r} against "
          f"the IC's {m_ic!r}: {mass_err:+.3e}")
    snaps = sorted(f for f in os.listdir(out) if f.startswith("PART_"))
    per_snap = {}
    for name in snaps:
        bf = BigFile(os.path.join(out, name))
        hdr = snap_io.read_header(bf)
        n0 = int(hdr.TotNumPart[0])
        for block in ("Metallicity", "ElectronAbundance", "InternalEnergy"):
            v = np.asarray(bf.open(f"0/{block}").read(), np.float64)
            check(v.shape[0] == n0 and np.isfinite(v).all(),
                  f"{name}: 0/{block} does not read back")
        per_snap[name] = (round(float(hdr.Time), 6), n0,
                          int(hdr.TotNumPart[4]), check_bh_blocks(
                              name, bf, hdr))
    check(len(snaps) >= 3, f"travis snapshots: {snaps}")
    pigs = {}
    for name in sorted(f for f in os.listdir(out) if f.startswith("PIG_")):
        ng, _, _ = pig_check(os.path.join(out, name),
                             sim.cfg.fof_min_group_length)
        pigs[name] = ng
    check(len(pigs) >= 1, "travis wrote no PIG")
    zmet = sph.metallicity[gas]
    return dict(nsteps=nsteps, atime=sim.atime, seconds=seconds,
                genic_seconds=genic_s, launches=launches, ngas=ngas,
                walltime=dict(sim.walltime.totals), cuts=cuts,
                nstars=int((pd.valid & (pd.ptype == 4)).sum()),
                nbh=int((pd.valid & (pd.ptype == 5)).sum()),
                seeded=list(sim.bh_seeded), wind_kicks=sim.wind_kicks,
                cooling_calls=spy.calls, metal_gas=int((zmet > 0).sum()),
                m_ic=m_ic, m_end=m_end, mass_err=mass_err,
                snapshots=per_snap, pigs=pigs)


class UvSpy:
    """Wraps Simulation._source_setup: per call, the redshift and where the
    per-row UV rates come from (the excursion set's J21, the z_reion grid's
    gating, or the global scalars), and for the rows of the z_reion grid's
    late patch (zreion within REION_ZRE_TOL of REION_ZRE_LATE: the float32
    interpolation's weights sum to 1 within an ulp) how many see a zero
    and a nonzero HI rate."""

    def __init__(self):
        from mpgadget_tpu_torch.run import Simulation
        self.cls = Simulation
        self.calls = []

    def __enter__(self):
        import torch
        real = self.real = self.cls._source_setup
        spy = self

        def setup(sim, active):
            res = real(sim, active)
            gas, _, z, _, uvbg = res
            uvf = sim._uvf
            if uvf is not None and isinstance(uvbg.gJH0, torch.Tensor):
                late = gas & ((uvf.zreion(sim.pdata.ipos) - REION_ZRE_LATE)
                              .abs() < REION_ZRE_TOL)
                j21 = sim.cfg.excursion_set_zstop <= z \
                    <= sim.cfg.excursion_set_zstart
                on = uvbg.gJH0 > 0
                n = torch.stack([late.sum(), (late & on).sum()]).cpu()
                spy.calls.append((z, "J21" if j21 else "z_reion",
                                  int(n[0]) - int(n[1]), int(n[1])))
            return res

        self.cls._source_setup = setup
        return self

    def __exit__(self, *exc):
        self.cls._source_setup = self.real
        return False


class BubbleSpy:
    """Wraps physics.qso_lightup._ionize_bubble: per bubble its centre and
    radius (box units) and the pid and float64 minimum-image distance of
    each row it ionized."""

    def __init__(self):
        from mpgadget_tpu_torch.physics import qso_lightup
        self.mod = qso_lightup
        self.bubbles = []
        self.pid = None

    def __enter__(self):
        import numpy as np
        real = self.real = self.mod._ionize_bubble
        spy = self

        def ionize(ipos, is_gas, ionized, *a):
            out = real(ipos, is_gas, ionized, *a)
            center, radius = a[2], a[3]
            new = (out[0] & ~ionized).cpu().numpy()
            d = ipos.cpu().numpy()[new] / 2.0 ** 32 \
                - center.cpu().numpy().astype(np.float64)
            d -= np.round(d)
            spy.bubbles.append((center.cpu().numpy(), float(radius),
                                spy.pid()[new], np.sqrt((d ** 2).sum(1))))
            return out

        self.mod._ionize_bubble = ionize
        return self

    def __exit__(self, *exc):
        self.mod._ionize_bubble = self.real
        return False


def reion_phase(workdir, star, device="cuda"):
    """Phase 26: reionization on star-small.  Phase 23's snapshot at a =
    0.15, copied into workdir, resumed through the CLI's body (RestartFlag
    2, hierarchical as shipped) to REION_TIME_MAX with the metal cooling
    table, the z_reion grid, the excursion set (REION_SWITCHES: its epoch
    z 6 to 5 ends inside the run) and QSO lightup on, each reading a stand-in
    (write_reion_inputs); QSOMinMass and QSOMaxMass bracket the largest
    halo of the snapshot's PIG.  The kernels' launch counts are read around
    it, the cooling calls' UV rates (UvSpy), the bubbles (BubbleSpy) and
    the last cooling call (CoolingSpy, K6's case on this gas).  Checks: the
    excursion set updated, gas with J21 > 0 and zreion set; the late patch
    dark on every call between the end of the epoch and z_re, lit on every
    call after; HeIII-ionized rows, each ionized inside a placed bubble;
    gas with metallicity > 0; the mass against the snapshot's; the last
    snapshot's J21, ZReionized and HeIIIIonized restored by from_snapshot.
    Returns the measurements."""
    import shutil
    import numpy as np
    import torch
    from mpgadget_tpu_torch import main as tmain
    from mpgadget_tpu_torch.io.bigfile import BigFile
    from mpgadget_tpu_torch.io import snapshot as snap_io
    from mpgadget_tpu_torch.run import Simulation

    # the run's output at a = 0.15, beside its PIG
    # the output at 0.15 (the run's last snapshot stands at 0.15 too)
    src = sorted(n for n, v in star["snapshots"].items()
                 if abs(v[0] - 0.15) < 1e-6)[:1]
    check(len(src) == 1, f"phase 23 wrote no snapshot at a = 0.15: "
          f"{star['snapshots']}")
    snapnum = int(src[0].split("_")[-1])
    os.makedirs(os.path.join(workdir, "output"), exist_ok=True)
    shutil.copytree(os.path.join(star["out"], src[0]),
                    os.path.join(workdir, "output", src[0]))
    snap_bf = BigFile(os.path.join(workdir, "output", src[0]))
    hdr = snap_io.read_header(snap_bf)
    m_snap = sum(float(snap_io.read_species(snap_bf, t, hdr)["mass"].astype(
        np.float64).sum()) for t in range(6) if int(hdr.TotNumPart[t]))
    pig = os.path.join(star["out"], f"PIG_{snapnum:03d}")
    masses = np.asarray(BigFile(pig).open("FOFGroups/Mass").read(),
                        np.float64)
    check(masses.size > 0, f"phase 23's PIG_{snapnum:03d} holds no halo")
    largest = float(masses.max()) if masses.size else 0.0
    qso = {"QSOMinMass": REION_QSO_BRACKET[0] * largest,
           "QSOMaxMass": REION_QSO_BRACKET[1] * largest}
    inputs = write_reion_inputs(workdir, hdr.BoxSize * hdr.UnitLength_in_cm
                                / 3.085678e24)
    gover = dict(REION_SWITCHES, **inputs, **qso)
    paramfile = paramfile_copy(star["paramfile"],
                               os.path.join(workdir, "paramfile.gadget"),
                               gover)
    mods = kernel_modules()
    for mod in mods.values():
        mod.LAUNCHES = 0
    cwd = os.getcwd()
    os.chdir(workdir)
    t0 = time.perf_counter()
    holder = {}
    real_run = Simulation.run

    def run(self, max_steps=None, verbose=True):
        holder["sim"] = self
        return real_run(self, max_steps=max_steps, verbose=False)

    Simulation.run = run
    try:
        with CoolingSpy() as spy, UvSpy() as uv, BubbleSpy() as bub:
            bub.pid = lambda: holder["sim"].pdata.pid.cpu().numpy()
            sim = tmain.run_cli(paramfile, 2, snapnum, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
    finally:
        os.chdir(cwd)
        Simulation.run = real_run
    seconds = time.perf_counter() - t0
    launches = {k: mod.LAUNCHES for k, mod in mods.items()}
    out = os.path.join(workdir, "output")
    check(sim.ti_current == sim.timeline.ti_end,
          f"phase 26 stopped at a={sim.atime}")
    if device == "cuda":
        check(min(launches.values()) > 0, f"a kernel of the reionization "
              f"path was not launched: {launches}")
    gas = sim.gas_mask
    sph = sim.sph
    cnt = torch.stack([
        (gas & (sph.local_j21 > 0)).sum(), (gas & (sph.zreion >= 0)).sum(),
        (gas & (sph.he_iii_ionized > 0)).sum(),
        (gas & (sph.metallicity > 0)).sum(), gas.sum()]).cpu().tolist()
    n_j21, n_zre, n_heiii, n_metal, ngas = cnt
    check(len(sim.uvbg_updates) > 0, "the excursion set never updated")
    check(n_j21 > 0 and n_zre > 0, f"no gas row with J21 > 0 ({n_j21}) or "
          f"zreion set ({n_zre})")
    zstop = sim.cfg.excursion_set_zstop
    dark = [c for c in uv.calls if c[1] == "z_reion"
            and REION_ZRE_LATE + REION_ZRE_TOL < c[0] < zstop]
    lit = [c for c in uv.calls if c[1] == "z_reion"
           and c[0] < REION_ZRE_LATE - REION_ZRE_TOL]
    check(any(c[1] == "J21" for c in uv.calls) and dark and lit,
          f"the cooling calls did not cover the J21 epoch, the dark late "
          f"patch and its switching on: {len(uv.calls)} calls")
    # (a substep's call may update no late-patch row)
    check(all(c[3] == 0 for c in dark) and sum(c[2] for c in dark) > 0
          and all(c[2] == 0 for c in lit) and sum(c[3] for c in lit) > 0,
          "late-patch rows: UV rates not zero before z_re or not nonzero "
          f"after: dark {dark[:3]}..., lit {lit[:3]}...")
    check(n_heiii > 0 and sum(n for _, n in sim.qso_bubbles) > 0,
          f"no HeIII-ionized gas ({n_heiii}) or no bubble")
    hit = {}
    for center, radius, pids, dist in bub.bubbles:
        out_of = dist[dist >= radius * (1 + 1e-5)]
        check(out_of.size == 0, f"rows ionized at {out_of} from a bubble's "
              f"centre, radius {radius}")
        hit.update(dict.fromkeys(pids.tolist()))
    ion_pid = sim.pdata.pid[gas & (sph.he_iii_ionized > 0)].cpu().numpy()
    check(set(ion_pid.tolist()) <= set(hit), "a HeIII-ionized row that no "
          "bubble ionized")
    check(n_metal > 0, "no gas with metallicity > 0")
    m_end = total_mass(sim)
    mass_err = m_end / m_snap - 1
    check(abs(mass_err) < MASS_TOL, f"phase 26 total mass {m_end!r} "
          f"against the snapshot's {m_snap!r}: {mass_err:+.3e}")
    snaps = sorted(f for f in os.listdir(out) if f.startswith("PART_"))
    last = os.path.join(out, snaps[-1])
    bf = BigFile(last)
    check(abs(float(snap_io.read_header(bf).Time) - sim.atime) < 1e-6,
          f"{snaps[-1]} is not the final state")
    back = Simulation.from_snapshot(last, {
        "starformation_on": True, "black_hole_on": True,
        "part_alloc_factor": sim.cfg.part_alloc_factor,
        "nmesh": sim.cfg.nmesh, "output_dir": out,
        "timeline": sim.timeline}, device=device)
    back._restore_gas()
    rows = back.gas_mask
    # the run's rows of the snapshot's gas, by ID (the FOF after the last
    # snapshot may have turned gas rows into BHs)
    pid = sim.pdata.pid.cpu().numpy()
    order = np.argsort(pid)
    at = order[np.searchsorted(pid[order], bf.open("0/ID").read().astype(
        pid.dtype))]
    blocks = {}
    for name, field in (("J21", "local_j21"), ("ZReionized", "zreion"),
                        ("HeIIIIonized", "he_iii_ionized")):
        want = bf.open(f"0/{name}").read()
        got = getattr(back.sph, field)[rows].cpu().numpy()
        mine = getattr(sph, field).cpu().numpy()[at]
        check(np.array_equal(got.astype(want.dtype), want)
              and np.array_equal(mine.astype(want.dtype), want),
              f"{snaps[-1]}: 0/{name} not the final state or not restored")
        blocks[name] = int((want > 0).sum())
    wt = dict(sim.walltime.totals)
    return dict(seconds=seconds, nsteps=sim._nstep_total, atime=sim.atime,
                launches=launches, walltime=wt, spy=spy, sim=sim,
                updates=list(sim.uvbg_updates), n_j21=n_j21, n_zre=n_zre,
                n_heiii=n_heiii, n_metal=n_metal, ngas=ngas,
                bubbles=len(bub.bubbles), qso=qso, inputs=inputs,
                dark=len(dark), lit=len(lit),
                j21_calls=sum(c[1] == "J21" for c in uv.calls),
                m_snap=m_snap, m_end=m_end, mass_err=mass_err,
                blocks=blocks, snapshot=snaps[-1], snapnum=snapnum,
                paramfile=os.path.abspath(paramfile))


def report_travis(trav, card):
    wt = trav["walltime"]
    layers = ("SPH/Density", "SPH/Hydro", "Cooling/SFR", "Winds",
              "MetalReturn", "BH", "FOF")
    print(f"phase 25, travis as it ships (2 x {trav['ngas']} particles; cuts "
          f"{GENIC_OVERRIDE} in genic and {trav['cuts']} in the run: the "
          f"stand-in metal table in place of the absent cooling_metal_UVB, "
          f"no TREECOOL_fg_june11) on {card}: {trav['nsteps']} PM steps to "
          f"a={trav['atime']:.6f} in {trav['seconds']:.6f} s (genic "
          f"{trav['genic_seconds']:.6f} s); walltime "
          + ", ".join(f"{k} {wt.get(k, 0.0):.6f}" for k in layers)
          + f" s; stars {trav['nstars']}, BHs {trav['nbh']} (seeded "
          f"{trav['seeded']}), wind kicks {trav['wind_kicks']}, cooling calls "
          f"{trav['cooling_calls']}, gas rows with metallicity > 0 "
          f"{trav['metal_gas']}; total mass {trav['m_end']:.9g} against the "
          f"IC's {trav['m_ic']:.9g} ({trav['mass_err']:+.3e}); snapshots (a, "
          f"gas, stars, BHs) {trav['snapshots']}; PIGs (groups) "
          f"{trav['pigs']}; kernel launches {trav['launches']}", flush=True)


def report_reion(reion, card):
    wt = reion["walltime"]
    layers = ("SPH/Density", "SPH/Hydro", "Cooling/SFR", "UVBG", "HeIII",
              "Winds", "MetalReturn", "BH", "FOF")
    print(f"phase 26, reionization on star-small from phase 23's PART_"
          f"{reion['snapnum']:03d} (RestartFlag 2, hierarchical; switches "
          f"{REION_SWITCHES}; stand-ins {sorted(reion['inputs'])} written "
          f"from closed forms: z_reion {REION_ZRE_EARLY} / {REION_ZRE_LATE}, "
          f"HeII history {REION_HEII}; cuts: QSOMinMass/QSOMaxMass "
          f"{REION_QSO_BRACKET} times the PIG's largest halo = "
          f"{reion['qso']}, QSOMeanBubble {REION_BUBBLE}) on {card}: "
          f"{reion['nsteps']} PM steps to a={reion['atime']:.6f} in "
          f"{reion['seconds']:.6f} s (the restart included); walltime "
          + ", ".join(f"{k} {wt.get(k, 0.0):.6f}" for k in layers)
          + f" s; kernel launches {reion['launches']}", flush=True)
    print(f"phase 26: UVBG updates (z, volume xHI, mass xHI) "
          f"{reion['updates']}; gas rows {reion['ngas']}: J21 > 0 "
          f"{reion['n_j21']}, zreion set {reion['n_zre']}, HeIII-ionized "
          f"{reion['n_heiii']} (each inside one of {reion['bubbles']} "
          f"bubbles), metallicity > 0 {reion['n_metal']}; cooling calls on "
          f"J21 rates {reion['j21_calls']}, with the late patch dark "
          f"{reion['dark']} and lit {reion['lit']}; total mass "
          f"{reion['m_end']:.9g} against the snapshot's "
          f"{reion['m_snap']:.9g} ({reion['mass_err']:+.3e}); "
          f"{reion['snapshot']}'s blocks read back by from_snapshot (rows > "
          f"0) {reion['blocks']}", flush=True)


def reion_cooling_case(reion, reps=5):
    """K6 with its per-row inputs on phase 26's final gas: the inputs of the
    run's last cooling call (per-row UV rates gated by the z_reion grid,
    per-row metallicity, the metal table) over every gas row, against its
    plain version (COOL_TOL), two launches bit-identical; the same rows
    with the tables off (the global scalar rates, no metallicity) bit for
    bit the first design's, and with per-row rates equal to the scalars
    and a zero metallicity bit for bit that; both timed (CUDA graph
    replays), the exits and the bound with the lookup counted
    (cooling_exits, COOL_METAL_OPS)."""
    import torch
    from mpgadget_tpu_torch.physics import cooling
    sim, spy = reion["sim"], reion["spy"]
    check(spy.last is not None, "phase 26 made no cooling call to keep")
    a, kw = spy.last[0], spy.last[1]
    cr, redshift, u, rho, dt, uvbg, ne, min_egy, units = a
    zmet = kw.get("metallicity")
    check(cooling.per_row(uvbg) and zmet is not None
          and cr.metal_table is not None,
          "phase 26's last cooling call had no per-row rates, metallicity "
          "or metal table")
    gas = torch.nonzero(sim.gas_mask).flatten()
    ins = [u, rho, dt, ne]

    def kern(uv=uvbg, z=zmet):
        return cooling.do_cooling(cr, redshift, *ins[:3], uv, ins[3],
                                  min_egy, units, rows=gas, metallicity=z)

    u1, n1 = kern()
    u2, n2 = kern()
    check(same_bits(u1, u2) and same_bits(n1, n2),
          "K6 with per-row inputs: two launches differ")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ur, nr = cooling.do_cooling_reference(
        cr, redshift, *[x[gas] for x in ins[:3]],
        cooling.uvbg_rows(uvbg, gas), ins[3][gas], min_egy, units,
        metallicity=zmet[gas])
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    uk, nk = u1[gas].double(), n1[gas].double()
    urd, nrd = ur.double(), nr.double()
    rel_u = float(((uk - urd).abs() / urd.abs().clamp(min=1e-300)).max())
    err_n = (nk - nrd).abs()
    check(rel_u <= COOL_TOL["u"] and bool((err_n <= COOL_TOL["ne_abs"]
                                           + COOL_TOL["ne_rel"]
                                           * nrd.abs()).all()),
          f"K6 with per-row inputs: u_new rel {rel_u:.3e}, ne abs "
          f"{float(err_n.max()):.3e} against the plain version")
    # the tables off: the global scalars, no metallicity; then per-row
    # rates equal to the scalars and a zero metallicity
    glob = sim._treecool.get_global_uvbg(redshift)
    off = cooling.do_cooling(cr, redshift, *ins[:3], glob, ins[3], min_egy,
                             units, rows=gas)
    simple = simple_cooling(lambda: cooling.do_cooling(
        cr, redshift, *ins[:3], glob, ins[3], min_egy, units, rows=gas))
    check(all(same_bits(x, y) for x, y in zip(off, simple)),
          "K6 with the tables off differs from its first design in some bit")
    n = u.shape[0]
    uniform = cooling.UVBG(**{k: torch.full((n,), float(
        torch.tensor(getattr(glob, k), dtype=u.dtype)), dtype=u.dtype,
        device=u.device) for k in cooling.UV_RATES},
        self_shield_dens=glob.self_shield_dens)
    same = kern(uniform, torch.zeros_like(zmet))
    check(all(same_bits(x, y) for x, y in zip(same, off)),
          "K6 with per-row rates equal to the scalars and zero metallicity "
          "differs from K6 without them in some bit")
    args = cooling.kernel_args(cr, redshift, uvbg, min_egy, units)
    on_launch = cooling_launch("do_cooling", gas, args, ins, [u, ne],
                               cooling.kernel_extra(cr, uvbg, zmet, u))
    off_launch = cooling_launch(
        "do_cooling", gas, cooling.kernel_args(cr, redshift, glob, min_egy,
                                               units), ins, [u, ne])
    ms_on, ms_off = graph_ms(on_launch, reps), graph_ms(off_launch, reps)
    exits, ops, trans = cooling_exits(
        "phase 26 final state, per-row inputs", cr, redshift, uvbg, ins,
        gas, min_egy, units, metallicity=zmet)
    steps = exits["bisection_steps"]
    nrows = int(gas.shape[0])
    nbytes_table = cr.metal_table.table.numel() * 4
    # the lookup runs once a bisection step (the net rate's closing terms):
    # in ops and in the full work; u, rho, dt, ne in, u, ne out, six rates
    # and the metallicity a row, all 4 bytes
    b = k6_bounds(nrows, ops, trans, 4, 6 + 6 + 1,
                  cooling_work(True, metal=True), nbytes_table)
    print(f"K6 do_cooling with per-row UV rates, metallicity and the metal "
          f"table, phase 26 final state ({nrows} gas rows, z={redshift:.4f}):"
          f" {ms_on:.6f} ms (CUDA graph replays, mean of {reps}) against "
          f"{ms_off:.6f} ms with the tables off (global scalars, no "
          f"metallicity) on the same rows; plain {plain_ms:.6f} ms (one "
          f"call); bound {b['bound_ms']:.6f} ms ({b['bound_by']}: "
          f"{b['ops']:.1f} operations a row the exits leave, the lookup "
          f"{COOL_METAL_OPS} a bisection step, 13 values a row read and "
          f"written, the {nbytes_table}-byte table through the read-only "
          f"cache), {100 * b['bound_ms'] / ms_on:.2f}% of it; u_new rel err "
          f"{rel_u:.3e}, ne/nh max abs err {float(err_n.max()):.3e}; tables "
          f"off bit for bit the first design; uniform rates and zero "
          f"metallicity bit for bit the tables off; bisection steps "
          f"{steps}", flush=True)
    return dict(ms=ms_on, ms_tables_off=ms_off, plain_ms=plain_ms,
                rows=nrows, rel_u=rel_u,
                max_abs_err=float((uk - urd).abs().max()),
                ne_abs_err=float(err_n.max()), exits=exits,
                table_bytes=nbytes_table, **b)


def sph_entry(name, which, gas, lya, case, big, new):
    """The kernels line's entry of K4 or K5: times at the star-small run's
    final state, the bigger IC beside them; launches in the star-small
    (without and with its subgrid physics), lya and phase 24 runs."""
    src = {"density": ("sph_density.cu", "mpgadget_tpu/sph/density.py:52"),
           "hydro": ("sph_hydro.cu", "mpgadget_tpu/sph/hydra.py:45")}[which]
    keys = ("ms", "simple_ms", "plain_ms", "bound_ms", "bound_by", "pairs",
            "within", "groups", "listed", "path_ms", "simple_path_ms")
    return {
        "name": name, "route": "cuda",
        "source": f"mpgadget_tpu_torch/csrc/{src[0]}",
        "replaces": "mpgadget_tpu/ops/pairs.py:355", "pair_function": src[1],
        "launches": (gas["launches"][which] + lya["launches"][which]
                     + sum(r[which] for r in new.values())),
        "launches_by_path": {"star_small": gas["launches"][which],
                             "lya": lya["launches"][which]} | {
            k: r[which] for k, r in new.items()},
        "density_solves": gas["n_solves"],
        "bisection_passes": sum(gas["passes"]),
        "max_abs_err": max(case["max_abs_err"], big["max_abs_err"]),
        "max_rel_err": max(list(case["rel"].values())
                           + list(big["rel"].values())),
        "pairs": case["pairs"], "pairs_counted": case["within"],
        "dm_small_2x64": {k: big[k] for k in keys},
        "simple_source": f"mpgadget_tpu_torch/csrc/{src[0][:-3]}_simple.cu",
        "simple_ms": case["simple_ms"],
        "critical_path_ms": case["path_ms"],
        "simple_critical_path_ms": case["simple_path_ms"],
        "ms": case["ms"], "plain_ms": case["plain_ms"],
        "bound_ms": case["bound_ms"], "bound_by": case["bound_by"],
        "library_ms": None}


def cooling_entry(lya, k6, new, k6r):
    """The kernels line's entry of K6: times on lya's final gas state, the
    closing subset, float64 and the net rate beside them, each with the
    first design's; launches in lya, star-small and phase 24."""
    keys = ("ms", "simple_ms", "plain_ms", "bound_ms", "bound_by",
            "bound_share", "full_work_bound_ms", "ops", "rows", "exits")
    case = k6["cases"]["all gas"]
    return {
        "name": "cooling_network", "route": "cuda",
        "source": "mpgadget_tpu_torch/csrc/cooling.cu",
        "replaces": "mpgadget_tpu/physics/cooling.py:584",
        "loops": ["mpgadget_tpu/physics/cooling.py:462 (get_equilib_ne)",
                  "mpgadget_tpu/physics/cooling.py:584 (do_cooling)"],
        "launches": (lya["launches"]["cooling"]
                     + sum(r["cooling"] for r in new.values())),
        "launches_by_path": {"lya": lya["launches"]["cooling"]} | {
            k: r["cooling"] for k, r in new.items()},
        "max_abs_err": max([c["max_abs_err"] for c in k6["cases"].values()]
                           + [k6r["max_abs_err"]]),
        "max_rel_err": max([c["rel_u"] for c in k6["cases"].values()]
                           + [k6r["rel_u"]]),
        "rows": case["rows"], "operations_per_row": case["ops"],
        "transcendentals_per_row": case["transcendentals"],
        "full_work_operations_per_row": case["full_work_ops"],
        "full_work_bound_ms": case["full_work_bound_ms"],
        "exits": case["exits"],
        "closing_subset": {k: k6["cases"]["closing"][k] for k in keys},
        "rows_128": {k: k6["cases"]["128 rows"][k] for k in keys},
        "float64": {k: k6["cases"]["all gas f64"][k] for k in keys},
        "heatingcooling_rate": {k: k6["rate"][k] for k in keys},
        "init_sfr_float64": {k: k6["thresh"][k] for k in keys},
        # phase 26's final gas with per-row UV rates, metallicity and the
        # metal table, and the same rows with them off
        "per_row_inputs": {k: k6r[k] for k in (
            "ms", "ms_tables_off", "plain_ms", "bound_ms", "bound_by",
            "full_work_bound_ms", "ops", "rows", "rel_u", "table_bytes",
            "exits")},
        "simple_source": "mpgadget_tpu_torch/csrc/cooling_simple.cu",
        "simple_ms": case["simple_ms"], "bound_share": case["bound_share"],
        "ms": case["ms"], "plain_ms": case["plain_ms"],
        "bound_ms": case["bound_ms"], "bound_by": case["bound_by"],
        "library_ms": None}


# -- phase 31: the tools and the examples' checkers -------------------------
#
# Each tool runs as this script with --no-jax in a process of its own,
# which fails any import of jax, jaxlib or mpgadget_tpu (NoJax) and then
# runs the tool as python -m does, or calls one of its functions.

TOOLS = "mpgadget_tpu_torch.tools."
TOOL_PROCESSES = 8       # tool processes at a time
TOOL_TIMEOUT = 600       # seconds for one tool process
BLOCKED = ("jax", "jaxlib", "mpgadget_tpu")
# (a): genic's IC from make_class_power's table against phase 9's / 16's
# IC from the Eisenstein-Hu override, per species: the velocities' gap by
# norm, relative, and the positions' rms gap over the mean spacing, about
# three times the card's 2.0e-5 and 1.7e-5 for dm-small (lya: 9.6e-6 and
# 7.5e-7): the table's log-log interpolation
IC_TABLE_TOL = {"vel": 6e-5, "pos": 5e-5}
# (c): the two parity runs' final positions, the largest distance in box
# units, about ten times the card's 4.4e-8 (the sums in no fixed order;
# PARITY_PK_RTOL leaves the same room over their P(k))
COMPARE_POS_TOL = 5e-7
REION_ZBAR = 7.5         # (e): make_HI_reionization_table's --zbar
REION_NGRID = 16


class NoJax:
    """A sys.meta_path finder that fails every import of BLOCKED."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked: the port imports no JAX")
        return None


def no_jax(argv):
    """chip_smoke.py --no-jax CALLS RESULTS: under NoJax, each entry of the
    json list in CALLS in order: {"module", "argv"} runs the module as
    python -m does, {"module", "call", "args"} calls one of its functions;
    the calls' results are pickled to RESULTS as a list."""
    import importlib
    import pickle
    import runpy
    sys.meta_path.insert(0, NoJax())
    with open(argv[0]) as fh:
        calls = json.load(fh)
    results = []
    for c in calls:
        if "call" in c:
            print(f"== {c['module']}.{c['call']}{tuple(c['args'])}",
                  flush=True)
            fn = getattr(importlib.import_module(c["module"]), c["call"])
            results.append(fn(*c["args"]))
        else:
            print(f"== python -m {c['module']} {' '.join(c['argv'])}",
                  flush=True)
            sys.argv = [c["module"]] + c["argv"]
            runpy.run_module(c["module"], run_name="__main__",
                             alter_sys=True)
            results.append(None)
    bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    check(not bad, f"imported {bad}")
    with open(argv[1], "wb") as fh:
        pickle.dump(results, fh)
    return 0


def tool(name, *argv):
    return {"module": TOOLS + name, "argv": [str(a) for a in argv]}


def tool_call(name, fn, *args):
    return {"module": TOOLS + name, "call": fn, "args": list(args)}


def run_tools(jobs, workdir):
    """jobs: {name: (cwd, [calls], names of the jobs it waits for)}; each
    job is this script with --no-jax in a process of its own,
    TOOL_PROCESSES at a time, each started in order once those it waits
    for have ended.  Fails the smoke if a job fails.  Returns {name:
    (stdout, results, seconds)}."""
    import pickle
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p))
    todo = list(jobs.items())
    running, done, ended = {}, {}, set()
    while todo or running:
        ready = [job for job in todo if ended.issuperset(job[1][2])]
        while ready and len(running) < TOOL_PROCESSES:
            job = ready.pop(0)
            todo.remove(job)
            name, (cwd, calls, _) = job
            stem = os.path.join(workdir, "job-" + name.replace(" ", "-"))
            with open(stem + ".json", "w") as fh:
                json.dump(calls, fh)
            out = open(stem + ".log", "w+")
            proc = subprocess.Popen(
                [sys.executable, os.path.join(HERE, "chip_smoke.py"),
                 "--no-jax", stem + ".json", stem + ".pkl"], cwd=cwd,
                env=env, stdout=out, stderr=subprocess.STDOUT, text=True)
            running[name] = (proc, out, stem, time.perf_counter())
        time.sleep(0.05)
        for name, (proc, out, stem, t0) in list(running.items()):
            secs = time.perf_counter() - t0
            if proc.poll() is None and secs < TOOL_TIMEOUT:
                continue
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            del running[name]
            ended.add(name)
            out.seek(0)
            text = out.read()
            out.close()
            if proc.returncode != 0:
                try:
                    check(False, f"tool job {name} failed (exit "
                          f"{proc.returncode} after {secs:.1f} s): "
                          f"{text[-3000:]}")
                except SmokeFailure:
                    for p, o, _, _ in running.values():
                        p.kill()
                        p.wait()
                        o.close()
                    raise
                continue        # a rehearsal's lenient check
            with open(stem + ".pkl", "rb") as fh:
                done[name] = (text, pickle.load(fh), secs)
    return done


def last_output(outdir, prefix):
    names = sorted(f for f in os.listdir(outdir) if f.startswith(prefix))
    check(names, f"no {prefix}* in {outdir}")
    return os.path.join(outdir, names[-1])


def ic_species(path):
    """{ptype: (positions, velocities, IDs) sorted by ID} of an IC, and its
    box."""
    import numpy as np
    from mpgadget_tpu_torch.io.bigfile import BigFile
    from mpgadget_tpu_torch.io import snapshot as snap_io
    bf = BigFile(path)
    hdr = snap_io.read_header(bf)
    out = {}
    for t in range(6):
        if int(hdr.TotNumPart[t]):
            sp = snap_io.read_species(bf, t, hdr)
            order = np.argsort(sp["pid"])
            out[t] = sp["pos"][order], sp["vel"][order], sp["pid"][order]
    return out, hdr.BoxSize


def ic_gap(table_ic, eh_ic, ngrid):
    """Per species (velocities' gap by norm relative, positions' rms gap
    over the mean spacing) of two ICs of one realisation."""
    import numpy as np
    a, box = ic_species(table_ic)
    b, _ = ic_species(eh_ic)
    check(sorted(a) == sorted(b), f"species {sorted(a)} / {sorted(b)}")
    gaps = {}
    for t in a:
        (pa, va, ida), (pb, vb, idb) = a[t], b[t]
        check(np.array_equal(ida, idb), f"type {t}: the ICs' IDs differ")
        d = pa - pb
        d -= np.round(d / box) * box
        gaps[t] = (float(np.linalg.norm(va - vb) / np.linalg.norm(vb)),
                   float(np.sqrt((d ** 2).sum(axis=1).mean())
                         / (box / ngrid)))
    return gaps


def write_gadget1(path, seed=4):
    """A Gadget-1 file (tests/test_tools.py's): 4 gas particles with a mass
    block and u, 8 DM with MassTable 2.5, a = 0.25.  Returns its arrays."""
    import struct
    import numpy as np
    rng = np.random.RandomState(seed)
    n0, n1 = 4, 8
    npart = [n0, n1, 0, 0, 0, 0]
    a = 0.25
    arrays = dict(pos=rng.uniform(0, 1000.0, (n0 + n1, 3)).astype("<f4"),
                  vel=rng.randn(n0 + n1, 3).astype("<f4"),
                  ids=np.arange(1, n0 + n1 + 1, dtype="<u4"),
                  mass=np.full(n0, 0.5, "<f4"),
                  u=np.linspace(10, 40, n0).astype("<f4"), a=a, n0=n0)
    hdr = struct.pack("<6i", *npart) + struct.pack(
        "<6d", 0.0, 2.5, 0, 0, 0, 0)
    hdr += struct.pack("<dd", a, 1 / a - 1) + struct.pack("<2i", 0, 0)
    hdr += struct.pack("<6I", *npart) + struct.pack("<2i", 0, 1)
    hdr += struct.pack("<4d", 1000.0, 0.3, 0.7, 0.7)
    hdr += struct.pack("<2i", 0, 0) + struct.pack("<6I", 0, 0, 0, 0, 0, 0)
    hdr += b"\x00" * (256 - len(hdr))
    with open(path, "wb") as fh:
        for p in (hdr, arrays["pos"].tobytes(), arrays["vel"].tobytes(),
                  arrays["ids"].tobytes(), arrays["mass"].tobytes(),
                  arrays["u"].tobytes()):
            fh.write(struct.pack("<i", len(p)) + p + struct.pack("<i", len(p)))
    return arrays


def table_rows(stdout, job):
    """The count column (the last) summed over a halo tool's rows."""
    rows = [ln.split() for ln in stdout.splitlines()
            if ln and not ln.startswith(("#", "=="))]
    check(all(len(r) == 3 for r in rows), f"{job}: rows {rows[:3]}")
    return sum(int(r[-1]) for r in rows)


def tools_phase(workdir, dm, lya, star, travis, parity, device="cuda",
                ngrid=None):
    """Phase 31 (module docstring).  dm, lya, star, travis: the work
    directories of phases 9-10, 16, 23 and 25; parity: phase 22's two
    runs' output directories.  A rehearsal on the CPU passes device "cpu"
    (the tools get --device cpu, genic runs as run_genic) and ngrid, {example:
    Ngrid} written into the paramfile copies to match its smaller phases.
    Returns a dict."""
    import importlib.util
    import shutil
    import numpy as np
    from mpgadget_tpu_torch.io.bigfile import BigFile
    from mpgadget_tpu_torch.params import create_genic_parameter_set
    from mpgadget_tpu_torch.physics import yield_tables as yt
    from mpgadget_tpu_torch.tools import check_examples as ce

    # (a) the shipped paramfile.genic of dm-small and lya, and travis's
    # (its table feeds travis's checker), copied unchanged
    params = {}
    for ex in ("dm-small", "lya", "travis"):
        d = os.path.join(workdir, ex)
        os.makedirs(d)
        pf = shutil.copy(os.path.join(HERE, "examples", ex,
                                      "paramfile.genic"), d)
        if ngrid:               # a smaller rehearsal on the CPU
            paramfile_copy(pf, pf, {"Ngrid": ngrid[ex]})
        ps = create_genic_parameter_set()
        ps.parse_file(pf)
        params[ex] = (d, pf, os.path.join(d, ps["FileWithInputSpectrum"]),
                      os.path.join(d, ps["OutputDir"], ps["FileBase"]),
                      ps["Ngrid"])
    out = {k: os.path.join(v, "output")
           for k, v in (("dm-small", dm), ("lya", lya), ("star-small", star),
                        ("travis", travis))}
    pigs = {ex: last_output(out[ex], "PIG_") for ex in ("dm-small",
                                                        "star-small")}
    parts = [last_output(p, "PART_") for p in parity]
    lya_snap = BigFile(last_output(out["lya"], "PART_"))
    lya_z = 1.0 / float(np.asarray(lya_snap.open("Header").attrs["Time"])
                        .reshape(-1)[0]) - 1.0
    lya_ne = float(np.median(lya_snap.open("0/ElectronAbundance").read()))
    dm_pig = BigFile(pigs["dm-small"])
    dm_hh = float(np.asarray(dm_pig.open("Header").attrs["HubbleParam"])
                  .reshape(-1)[0])
    dm_mass = dm_pig.open("FOFGroups/Mass").read()
    dm_max = float(dm_mass.max() * 1e10 / dm_hh) if len(dm_mass) else 0.0
    # (b) the checks each checker runs here, and those it leaves out
    left_out = {
        ("dm-small", "check_hmf"): f"the last PIG's largest halo "
        f"{dm_max:.6e} Msun, the reference's 9e12 not reached with the "
        "Eisenstein-Hu spectrum at 64^3 (phase 10: not enforced)",
        ("lya", "check_lya_redshift"): f"the last snapshot at z "
        f"{lya_z:.4f}: the run stops at a = {LYA_TIME_MAX} (LYA_TIME_MAX, "
        "the depth cut), the check asks z < 3.1",
        ("lya", "check_lya_igm"): "no UV background (TreeCoolFile empty: "
        "TREECOOL_ep_2018p is absent), so no photo-heated IGM to fit "
        "T0 and gamma to",
        ("lya", "check_lya_ionized"): f"the median electron abundance "
        f"{lya_ne:.6g}: no UV background ionizes the gas (TreeCoolFile "
        "empty)",
        ("travis", "check_linear_growth"): None}    # after the table
    checks = {"dm-small": (("check_power", out["dm-small"],
                            params["dm-small"][2]),
                           ("check_hmf", out["dm-small"])),
              "lya": tuple((f.__name__, out["lya"]) for f in ce.LYA_PARTS),
              "star-small": (("check_sfr_history", out["star-small"]),
                             ("check_stars_in_snapshot", out["star-small"])),
              "travis": (("check_linear_growth", out["travis"],
                          params["travis"][2]),
                         ("check_gas_state", out["travis"]))}
    ran = {ex: [c for c in cs if (ex, c[0]) not in left_out]
           for ex, cs in checks.items()}

    def checker(ex, after=()):
        return (workdir, [tool_call("check_examples", *c) for c in ran[ex]],
                after)

    box_mpc = 5.0      # phase 26's box (star-small, 5000 kpc/h)
    g1 = write_gadget1(os.path.join(workdir, "gadget1"))
    # the tables first: genic and dm-small's checks wait for theirs
    genic = "mpgadget_tpu_torch.genic.main"
    jobs = {f"make_class_power {ex}": (params[ex][0], [tool(
        "make_class_power", params[ex][1], "--backend", "eh")], ())
        for ex in params}
    for ex in ("dm-small", "lya"):
        jobs[f"genic {ex}"] = (params[ex][0], [
            {"module": genic, "argv": [params[ex][1]]} if device == "cuda"
            else {"module": genic, "call": "run_genic",
                  "args": [params[ex][1], None, "cpu"]}],
            (f"make_class_power {ex}",))
    jobs["check_examples dm-small"] = checker(
        "dm-small", ("make_class_power dm-small",))
    for ex in ("lya", "star-small", "travis"):
        jobs[f"check_examples {ex}"] = checker(ex)
    for ex, pig in pigs.items():
        jobs[f"hmf_from_fof {ex}"] = (workdir, [tool("hmf_from_fof", pig)],
                                      ())
        jobs[f"plot_gsmf {ex}"] = (workdir, [tool("plot_gsmf", pig)], ())
    jobs["compare_snap"] = (workdir, [tool_call(
        "compare_snap", "compare", *parts, 1, device)], ())
    jobs["make_HI_reionization_table"] = (workdir, [tool(
        "make_HI_reionization_table", os.path.join(workdir, "zreion"),
        "--ngrid", REION_NGRID, "--box", box_mpc, "--zbar", REION_ZBAR,
        "--device", device)], ())
    jobs["make_yield_tables"] = (workdir, [tool(
        "make_yield_tables", "--npz", os.path.join(workdir, "yields.npz"),
        "--device", device)], ())
    jobs["convert_from_gadget_1"] = (workdir, [tool(
        "convert_from_gadget_1", os.path.join(workdir, "gadget1"),
        os.path.join(workdir, "gadget1_bf"))], ())
    h5 = importlib.util.find_spec("h5py") is not None
    if h5:
        jobs["convert_hdf5"] = (workdir, [tool(
            "convert_hdf5", parts[0], os.path.join(workdir, "part.hdf5"))],
            ())
    t0 = time.perf_counter()
    got = run_tools(jobs, workdir)
    t_tools = time.perf_counter() - t0
    # travis's first output against the table over check_linear_growth's
    # large-scale bins (on the card 0.39 to 1.58 of their mean, rtol 0.25)
    kk0, pk0, _ = ce._read_power(ce._power_files(out["travis"])[0],
                                 ndesired=16)
    lin = np.loadtxt(params["travis"][2])
    shape = pk0[:5] / np.interp(kk0[:5], lin[:, 0], lin[:, 1])
    left_out[("travis", "check_linear_growth")] = (
        "its first output's P(k) over the table at k = "
        + ", ".join(f"{k:.1f}" for k in kk0[:5]) + " h/Mpc is "
        + ", ".join(f"{r:.3f}" for r in shape / shape.mean())
        + " of their mean (rtol 0.25): the Eisenstein-Hu stand-in gives gas "
        "and dark matter the total-matter spectrum where the paramfile "
        "asks for CLASS's transfer functions (DifferentTransferFunctions "
        "1, class_tk_99.dat absent), and the EH table ends at "
        f"{lin[-1, 0]:.1f} h/Mpc (np.interp holds its last value beyond)")
    print("phase 31 tool processes (seconds, each its own process under "
          "the import blocker): " + ", ".join(
              f"{k} {v[2]:.3f}" for k, v in got.items())
          + f"; all in {t_tools:.3f} s", flush=True)

    # (a)
    ic_gaps = {}
    for ex, eh_ic in (("dm-small", os.path.join(dm, "IC", "IC")),
                      ("lya", os.path.join(lya, "output", "IC"))):
        d, pf, spec, ic, ngrid = params[ex]
        with open(spec) as fh:
            head = fh.readline().strip()
        gaps = ic_gap(ic, eh_ic, ngrid)
        ic_gaps[ex] = gaps
        print(f"tools (a) {ex}: make_class_power wrote {spec} ({head}, "
              f"{len(np.loadtxt(spec))} rows); genic on the shipped "
              f"paramfile.genic unchanged ({got['genic ' + ex][2]:.3f} s) "
              f"against phase {9 if ex == 'dm-small' else 16}'s IC from the "
              "Eisenstein-Hu override, per type (velocities by norm, "
              "positions' rms over the spacing): "
              + ", ".join(f"{t}: {v:.3e}, {p:.3e}"
                          for t, (v, p) in gaps.items())
              + f" (tolerances {IC_TABLE_TOL['vel']:g}, "
              f"{IC_TABLE_TOL['pos']:g})", flush=True)
        for t, (v, p) in gaps.items():
            check(v <= IC_TABLE_TOL["vel"] and p <= IC_TABLE_TOL["pos"],
                  f"{ex} type {t}: the table's IC off the override's by "
                  f"{v:.3e} (velocities), {p:.3e} (positions)")
    # (b)
    for ex, cs in checks.items():
        print(f"tools (b) check_examples {ex}: ran "
              + ", ".join(c[0] for c in ran[ex]) + "; left out "
              + ("; ".join(f"{c[0]} ({left_out[(ex, c[0])]})" for c in cs
                           if (ex, c[0]) in left_out) or "none"), flush=True)
    # (c)
    dr, ratio = got["compare_snap"][1][0]
    box = float(np.asarray(BigFile(parts[0]).open("Header").attrs["BoxSize"])
                .reshape(-1)[0])
    pk_dev = float(np.abs(ratio - 1).max())
    print(f"tools (c) compare_snap {parts[0]} against {parts[1]} on "
          f"{device}: {len(dr)} particles, displacement max "
          f"{dr.max() / box:.3e} and rms "
          f"{np.sqrt((dr ** 2).mean()) / box:.3e} of the box (tolerance "
          f"{COMPARE_POS_TOL:g}), P(k) ratio over {len(ratio)} bins off 1 "
          f"by {pk_dev:.3e} at most (PARITY_PK_RTOL {PARITY_PK_RTOL:g})",
          flush=True)
    check(dr.max() <= COMPARE_POS_TOL * box,
          f"compare_snap: displacement {dr.max()} of a {box} box")
    check(len(ratio) > 0 and pk_dev <= PARITY_PK_RTOL,
          f"compare_snap: P(k) ratio off 1 by {pk_dev:.3e}")
    # (d)
    halos = {}
    for ex, pig in pigs.items():
        ng = pig_check(pig, 1)[0]
        bf = BigFile(pig)
        starry = int((bf.open("FOFGroups/MassByType").read()[:, 4] > 0)
                     .sum()) if ng else 0
        nh = table_rows(got[f"hmf_from_fof {ex}"][0], "hmf_from_fof")
        ns = table_rows(got[f"plot_gsmf {ex}"][0], "plot_gsmf")
        halos[ex] = (ng, nh, starry, ns)
        print(f"tools (d) {ex} {os.path.basename(pig)}: hmf_from_fof counts "
              f"{nh} halos, the PIG holds {ng}; plot_gsmf counts {ns} with "
              f"stars, the PIG {starry}", flush=True)
        check(nh == ng and ns == starry, f"{ex}: the halo tools count "
              f"{nh} and {ns} groups against {ng} and {starry}")
    # (e)
    blk = BigFile(os.path.join(workdir, "zreion")).open("Zreion_Table")
    zre = blk.read()
    med = float(np.median(zre))
    print(f"tools (e) make_HI_reionization_table --ngrid {REION_NGRID} --box "
          f"{box_mpc:g}: Nmesh {np.asarray(blk.attrs['Nmesh']).tolist()}, "
          f"BoxSize {np.asarray(blk.attrs['BoxSize']).tolist()}, "
          f"{zre.size} values in [{zre.min():.4f}, {zre.max():.4f}], median "
          f"{med:.4f} (--zbar {REION_ZBAR})", flush=True)
    check(int(np.asarray(blk.attrs["Nmesh"]).reshape(-1)[0]) == REION_NGRID
          and float(np.asarray(blk.attrs["BoxSize"]).reshape(-1)[0])
          == box_mpc and zre.size == REION_NGRID ** 3
          and bool(np.isfinite(zre).all()) and abs(med - REION_ZBAR) <= 0.5,
          "make_HI_reionization_table's table")
    # (f)
    with np.load(os.path.join(workdir, "yields.npz")) as z:
        want = dict(snii_masses=yt.SNII_MASSES, snii_z=yt.SNII_Z,
                    agb_masses=yt.AGB_MASSES, agb_z=yt.AGB_Z)
        for name, grids in (("snii", yt._SNII), ("agb", yt._AGB)):
            want.update({f"{name}_{k}": np.asarray(v)
                         for k, v in grids.items()})
        check(sorted(z.files) == sorted(want) and all(
            np.array_equal(z[k], want[k]) for k in want),
            "make_yield_tables' npz against physics/yield_tables")
        nyield = len(z.files)
    bf = BigFile(os.path.join(workdir, "gadget1_bf"))
    n0 = g1["n0"]
    check(np.allclose(bf.open("1/Position").read(), g1["pos"][n0:],
                      rtol=1e-6)
          and np.allclose(bf.open("1/Velocity").read(),
                          g1["vel"][n0:] * np.sqrt(g1["a"]), rtol=1e-6)
          and np.allclose(bf.open("0/Mass").read(), g1["mass"], rtol=1e-6)
          and np.allclose(bf.open("0/InternalEnergy").read(), g1["u"],
                          rtol=1e-6)
          and np.array_equal(bf.open("1/ID").read(), g1["ids"][n0:]),
          "convert_from_gadget_1's bigfile does not read back")
    print(f"tools (f) make_yield_tables --npz: {nyield} arrays equal to "
          "physics/yield_tables'; convert_from_gadget_1: the Gadget-1 file's "
          "positions, velocities (x sqrt(a)), IDs, gas masses and u read "
          "back; convert_hdf5 " + ("ran on " + parts[0] if h5 else
                                   "left out: h5py is not installed here"),
          flush=True)
    return dict(gaps=ic_gaps, jobs={k: v[2] for k, v in got.items()},
                halos=halos, pk_dev=pk_dev, median=med,
                left_out=sorted(left_out))


def main():
    if not os.path.isdir(os.path.join(HERE, "mpgadget_tpu_torch")):
        print("chip_smoke.py: mpgadget_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    if sys.argv[1:2] == ["--no-jax"]:         # a tool process of phase 31
        try:
            return no_jax(sys.argv[2:])
        except SmokeFailure as e:
            print(f"chip_smoke.py --no-jax: FAILED: {e}", file=sys.stderr)
            return 1
    import torch
    if sys.argv[1:2] == ["--sharded-rank"] and sys.argv[4:5] == ["cpu"]:
        return sharded_rank(sys.argv[2:])      # a rehearsal's rank
    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 2
    try:
        if sys.argv[1:2] == ["--sharded-rank"]:
            return sharded_rank(sys.argv[2:])
        return run()
    except SmokeFailure as e:
        print(f"chip_smoke.py: FAILED: {e}", file=sys.stderr)
        return 1


T_START = time.perf_counter()
PHASE_SECONDS = {}


def timed(label, fn, *args, **kw):
    """fn(*args, **kw) with its seconds added to PHASE_SECONDS[label] and
    printed (a phase may be several calls)."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    dt = time.perf_counter() - t0
    PHASE_SECONDS[label] = PHASE_SECONDS.get(label, 0.0) + dt
    print(f"phase {label}: {dt:.3f} s of the smoke", flush=True)
    return out


def run():
    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_run = time.perf_counter()
    card = timed("1 (the card)", card_line)
    kind = torch.cuda.get_device_name(0)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    print(card, flush=True)

    from mpgadget_tpu_torch import kernels
    from mpgadget_tpu_torch.gravity.tree import TreeConfig
    from mpgadget_tpu_torch.gravity.treewalk import WalkConfig
    t0 = time.perf_counter()
    timed("2 (build)", kernels.build_all)
    print(f"build (nvcc per source, in parallel): "
          f"{time.perf_counter() - t0:.3f} s; per source "
          f"{kernels.BUILD_SECONDS}", flush=True)
    for name, log in kernels.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # the main path's shapes and scalars for dm-small
    G = TreeConfig().group_max
    S = WalkConfig().src_cap
    nb = NGRID ** 3 // G
    rs_inv = float(np.float32(NMESH / 3.0))
    rcut = float(np.float32(6.0 * 1.5 / NMESH))
    soft = 2.8 * (1.0 / 30.0) * BOXSIZE / NGRID
    h_inv = float(np.float32(BOXSIZE / soft))
    kres = [timed("3 (K1)", kernel_phase, nb, G, S, rs_inv, h_inv, rcut),
            timed("3 (K1)", kernel_phase, nb, G, S, rs_inv, h_inv, rcut,
                  counts=True)]

    l2_ns = timed("4 (L2)", l2_phase)
    with tempfile.TemporaryDirectory() as work:
        wres = timed("5 (K2)", walk_phase, work, l2_ns)

    timed("6 (accuracy)", accuracy_phase, "cuda")

    with tempfile.TemporaryDirectory() as work:
        res = timed("7 (slice)", slice_phase, work, "cuda")
    if (res["src_cap"], res["group"], res["capacity"] // res["group"]) \
            != (S, G, nb):
        # an overflow retry changed the kernel's shapes: compare there too
        nb2, S2 = res["capacity"] // res["group"], res["src_cap"]
        kres += [timed("7 (slice)", kernel_phase, nb2, res["group"], S2,
                       rs_inv, h_inv, rcut),
                 timed("7 (slice)", kernel_phase, nb2, res["group"], S2,
                       rs_inv, h_inv, rcut, counts=True)]
    steps = res["step_seconds"]
    print(f"slice dm-small 64^3 Nmesh {NMESH} on {card}: {res['nsteps']} "
          f"global KDK steps to a={res['atime']:.6f}; "
          f"tree-force evaluations {res['tree_force_calls']}, "
          f"kernel launches {res['launches']}", flush=True)
    print("step seconds: " + " ".join(f"{s:.6f}" for s in steps))
    print(f"particle-steps/s: {res['npart'] * len(steps) / sum(steps):.1f} "
          f"(all steps), {res['npart'] / min(steps):.1f} (fastest step) "
          f"on {card}")
    st = res["stages"]
    print("tree stage seconds, summed over all evaluations: " + ", ".join(
        f"{k} {v:.6f}" for k, v in st.items()) + f" on {card}")
    print(f"walk stage {st.get('walk', 0.0):.6f} s, K1 (pair) stage "
          f"{st.get('pair', 0.0):.6f} s on {card}")
    ser = res["series"]
    print("per evaluation: K1 sum(count) " + str(ser["pair_sources_sum"])
          + ", max(count) " + str(ser["pair_sources_max"])
          + "; walk tree nodes " + str(ser["walk_nodes"]) + ", visits "
          + str(ser["walk_visits_sum"]) + ", monopoles "
          + str(ser["walk_monopoles"]))
    npot = ser["with_potential"]      # the snapshot's evaluation
    k1_bound = sum(pair_bound(nb, G, s, wp)[0]
                   for s, wp in zip(ser["pair_sources_sum"], npot))
    k2_bound = sum(walk_bound(nb, G, WalkConfig().leaf_list_max, c, v, m,
                              wp)[0]
                   for c, v, m, wp in zip(ser["walk_nodes"],
                                          ser["walk_visits_sum"],
                                          ser["walk_monopoles"], npot))
    k2_serial = res["counts"]["walk_iterations"] * l2_ns * 1e-6
    print(f"slice bounds, all evaluations: K1 {k1_bound:.6f} ms for the "
          f"real sources at the full pair cost; walk {k2_bound:.6f} ms (a "
          f"serial walk's critical path would be {k2_serial:.6f} ms: "
          f"longest blocks' visits x one L2 round trip)")
    print(f"tree counts: {res['counts']}; overflow retries (capacities "
          f"that overflowed): {res['retries']}; final src_cap "
          f"{res['src_cap']}")
    wt = res["walltime"]
    print(f"PM seconds (all evaluations): {wt.get('PMgrav', 0.0):.6f}; "
          f"tree seconds: {wt.get('Tree', 0.0):.6f} on {card}")
    print(f"snapshot {res['snapshot']} read back; "
          f"{res['powerspectra']} power spectra written", flush=True)

    cres = timed("8 (compaction)", compaction_phase, l2_ns)
    # the outputs that phases 27-30 read stay until their launches, which
    # start each configuration's ranks once for the four phases
    keep = tempfile.TemporaryDirectory()
    work_dm = os.path.join(keep.name, "dm-small")
    work_lya = os.path.join(keep.name, "lya")
    work_star = os.path.join(keep.name, "star-small")
    for d in (work_dm, work_lya, work_star):
        os.makedirs(d)
    work = work_dm
    gres = timed("9 (genic)", genic_phase, work)
    hres = timed("10 (hierarchical dm-small)", hier_phase, work)
    fres = timed("11 (FOF)", fof_phase, hres["sim"], hres["snapnum"])
    nres = timed("12 (K3)", neighbor_phase, fres, l2_ns)
    rres = timed("13 (RestartFlag 3)", restart_phase, work,
                 hres["snapnum"], fres["groups"])
    nu = timed("18 (neutrinos)", neutrino_phase,
               os.path.join(keep.name, "nu"),
               os.path.join(work, "output"))
    rflags = timed("19 (RestartFlags 1, 2, 4, 99)", restart_flags_phase,
                   work, hres["snapnum"])
    hyb = timed("20 (hybrid)", hybrid_phase, os.path.join(keep.name, "hyb"))
    lcone = timed("21 (light cone)", lightcone_phase,
                  os.path.join(keep.name, "lc"))
    par = timed("22 (parity)", parity_phase, os.path.join(keep.name,
                                                           "parity"))
    dm_paths = {"neutrinos": nu, "hybrid": hyb, "lightcone": lcone,
                "parity_1": par["runs"][0], "parity_2": par["runs"][1]}
    hsteps = hres["step_seconds"]
    print(f"hierarchical dm-small 64^3 Nmesh {NMESH} from the genic IC on "
          f"{card}: {hres['nsteps']} PM steps to a={hres['atime']:.6f} in "
          f"{sum(hsteps):.6f} s of steps ({hres['run_seconds']:.6f} s with "
          f"the first forces and the last snapshot); tree-force evaluations "
          f"{hres['tree_force_calls']}, kernel launches {hres['launches']}",
          flush=True)
    print(f"force_evals {hres['force_evals']}: "
          f"{hres['force_evals'] / sum(hsteps):.1f} per second; PM steps "
          f"per second {hres['nsteps'] / sum(hsteps):.6f}; particle-steps/s "
          f"{hres['npart'] * hres['nsteps'] / sum(hsteps):.1f} on {card}")
    hst = hres["stages"]
    print("hierarchical tree stage seconds, summed over all evaluations: "
          + ", ".join(f"{k} {v:.6f}" for k, v in hst.items())
          + f"; PM seconds {hres['walltime'].get('PMgrav', 0.0):.6f}, tree "
          f"seconds {hres['walltime'].get('Tree', 0.0):.6f} on {card}")
    hser = hres["series"]
    print("per evaluation: active blocks " + str(hser["active_blocks"])
          + "; K1 sum(count) " + str(hser["pair_sources_sum"])
          + "; walk visits " + str(hser["walk_visits_sum"])
          + ", monopoles " + str(hser["walk_monopoles"]))
    hk1, hk2 = hier_bounds(hres)
    print(f"hierarchical bounds, all evaluations at their compacted nb: "
          f"K1 {hk1:.6f} ms (real sources at the full pair cost), K2 "
          f"{hk2:.6f} ms; overflow retries {hres['retries']}", flush=True)
    print(f"FOF in the hierarchical run: {len(hres['pig_groups'])} PIGs "
          f"{hres['pig_groups']}, {hres['walltime'].get('FOF', 0.0):.6f} s "
          f"(walltime 'FOF'); the final state's FOF {fres['seconds']:.6f} s "
          f"in-process, RestartFlag 3 {rres['seconds']:.6f} s as a process; "
          f"K3 launches {hres['launches']['neighbors']} (run), "
          f"{fres['launches']} (final state) on {card}", flush=True)


    with tempfile.TemporaryDirectory() as work:
        gas = timed("14 (star-small without subgrid)", gas_run_phase, work)
        spy = gas["spy"]
        a = spy.last["density_sums"][0]
        gk4 = timed("15 (K4, K5)", sph_kernel_case, "star-small final state",
                    "density", a, a[6], l2_ns)
        a = spy.last["hydro_sums"][0]
        gk5 = timed("15 (K4, K5)", sph_kernel_case, "star-small final state",
                    "hydro", a, a[5].group_max, l2_ns)
        grres = timed("14 (star-small without subgrid)", restart_phase, work,
                      gas["snapnum"], "not run", paramfile=gas["paramfile"],
                      cli=False)
    with tempfile.TemporaryDirectory() as work:
        big = timed("15 (K4, K5)", big_gas_case, work, l2_ns)
    work = work_lya
    lya = timed("16 (lya)", lya_phase, work)
    k6 = timed("17 (K6)", cooling_phase, lya)
    lrres = timed("16 (lya)", restart_phase, work, lya["snapnum"],
                  "not run", paramfile=lya["paramfile"], cli=False)
    lya_pig = timed("16 (lya)", lya_pig_stars, work, lya["snapnum"])
    gst = gas["step_seconds"]
    gwt = gas["walltime"]
    print(f"star-small (2 x {gas['ngas']} particles, cuts "
          f"{GENIC_OVERRIDE} in genic and {GAS_SWITCHES_OFF} in the run) on "
          f"{card}: {gas['nsteps']} PM steps to a={gas['atime']:.6f} in "
          f"{sum(gst):.6f} s of steps ({gas['run_seconds']:.6f} s with the "
          f"gas set-up, the first forces and the last snapshot); walltime "
          + ", ".join(f"{k} {v:.6f}" for k, v in sorted(gwt.items()))
          + f" s; {gas['n_solves']} density solves, bisection passes "
          f"{sum(gas['passes'])} in all; kernel launches {gas['launches']}; "
          f"RestartFlag 3 {grres['seconds']:.6f} s", flush=True)
    print("star-small tree stage seconds: " + ", ".join(
        f"{k} {v:.6f}" for k, v in gas["stages"].items()), flush=True)
    lst = lya["step_seconds"]
    lwt = lya["walltime"]
    print(f"lya (2 x {lya['ngas']} particles, cuts {GENIC_OVERRIDE} in genic "
          f"and {LYA_SWITCHES}, TimeMax {LYA_TIME_MAX} in the run) on "
          f"{card}: {lya['nsteps']} PM "
          f"steps to a={lya['atime']:.6f} in {sum(lst):.6f} s of steps "
          f"({lya['run_seconds']:.6f} s with the gas set-up, the first "
          f"forces and the last snapshot); walltime Cooling/SFR "
          f"{lwt.get('Cooling/SFR', 0.0):.6f} s "
          f"({100 * lwt.get('Cooling/SFR', 0.0) / sum(lst):.1f}% of the "
          f"steps); walltime by layer "
          + ", ".join(f"{k} {v:.6f}" for k, v in sorted(lwt.items()))
          + f" s; K6 launches {lya['launches']['cooling']} "
          f"({lya['spy'].calls} cooling calls, {lya['sfr_lines']} sfr.txt "
          f"lines); kernel launches {lya['launches']}; stars "
          f"{lya['nstars']}; per snapshot (a, stars, Msun) "
          f"{lya['snapshots']}; RestartFlag 3 {lrres['seconds']:.6f} s, "
          f"{lrres['groups']} groups holding {lya_pig} stars", flush=True)
    print(f"lya sfr.txt last line: {lya['sfr_last']}", flush=True)

    work = work_star
    t0 = time.perf_counter()
    star = timed("23 (star-small)", star_small_phase, work)
    srres = timed("23 (star-small)", restart_phase, work,
                  star["snapnum"], "not run",
                  paramfile=star["paramfile"], cli=False)
    t23 = time.perf_counter() - t0
    report_star_small(star, srres, card)
    t0 = time.perf_counter()
    glob = timed("24 (global subgrid steps)", global_subgrid_phase,
                 os.path.join(work, "global"), star)
    t24 = time.perf_counter() - t0
    t0 = time.perf_counter()
    reion = timed("26 (reionization)", reion_phase,
                  os.path.join(work, "reion"), star)
    t26 = time.perf_counter() - t0
    k6r = timed("26 (reionization)", reion_cooling_case, reion)
    # phases 27-30: each configuration's ranks started once for all four
    labels = ("27 (sharded dm-small)", "28 (sharded lya)",
              "29 (sharded star-small)", "30 (sharded options)")
    t0 = time.perf_counter()
    got, secs, outside = drive_merged({
        labels[0]: sharded_phase(work_dm, hres),
        labels[1]: lya_sharded_phase(work_lya, lya),
        labels[2]: star_sharded_phase(
            os.path.join(work_star, "sharded"), star, glob),
        labels[3]: options_sharded_phase(
            os.path.join(work_star, "options"), nu, hyb, lcone, reion,
            star)}, keep.name, "cuda", "sharded phases 27-30")
    t2730 = time.perf_counter() - t0
    for lb in labels:
        PHASE_SECONDS[lb] = secs[lb]
        print(f"phase {lb}: {secs[lb]:.3f} s of the smoke (its runs in "
              "the shared launches, rank 0, and its checks)", flush=True)
    PHASE_SECONDS["27-30 (the shared launches' process start)"] = outside
    print(f"phases 27-30 in {t2730:.3f} s: their launches' processes "
          f"outside every run (start and exit) {outside:.3f} s", flush=True)
    shd, l28, p29, p30 = (got[lb] for lb in labels)
    report_sharded(shd, card)
    report_sharded(l28["configs"], card,
                   f"lya (2 x {lya['ngas']} particles, TimeMax "
                   f"{LYA_TIME_MAX})")
    report_global(glob, card)
    work_travis = os.path.join(keep.name, "travis")
    os.makedirs(work_travis)
    t0 = time.perf_counter()
    trav = timed("25 (travis)", travis_phase, work_travis)
    t25 = time.perf_counter() - t0
    report_travis(trav, card)
    report_reion(reion, card)
    print(f"phases 23-26: {t23:.3f} s, {t24:.3f} s, {t25:.3f} s and "
          f"{t26:.3f} s of the smoke", flush=True)
    report_star_sharded(p29, card)
    report_options_sharded(p30, card)
    work = os.path.join(keep.name, "tools")
    os.makedirs(work)
    timed("31 (tools)", tools_phase, work, work_dm, work_lya, work_star,
          work_travis, [r["out"] for r in par["runs"]])
    keep.cleanup()
    total = time.perf_counter() - t_run
    print("phase seconds: " + json.dumps(
        {k: round(v, 3) for k, v in PHASE_SECONDS.items()})
          + f"; the phases {sum(PHASE_SECONDS.values()):.3f} s, run() "
          f"{total:.3f} s, the process {time.perf_counter() - T_START:.3f} "
          f"s on {card}", flush=True)
    new = {"star_small_full": star["launches"],
           "subgrid_global": glob["launches"], "travis": trav["launches"],
           "reion": reion["launches"]}
    for name, r in shd.items():     # phase 27, summed over its ranks
        new[f"sharded_{name}"] = {k: sum(rk["launches"][k]
                                         for rk in r["ranks"])
                                  for k in r["ranks"][0]["launches"]}
    for name, r in l28["configs"].items():     # phase 28, the same
        new[f"sharded_lya_{name}"] = {k: sum(rk["launches"][k]
                                             for rk in r["ranks"])
                                      for k in r["ranks"][0]["launches"]}
    for name, r in p29.items():     # phase 29, (i) and (ii)
        new[f"sharded_star_{name}"] = {k: sum(
            rk["launches"][k] for rk in r["ranks"] + r["global"]["ranks"])
            for k in r["ranks"][0]["launches"]}
    for name, r in p30.items():     # phase 30, its four runs
        for key, rr in r.items():
            new[f"sharded_options_{name}_{key}"] = {
                k: sum(rk["launches"][k] for rk in rr["ranks"])
                for k in rr["ranks"][0]["launches"]}

    check("jax" not in sys.modules, "jax was imported")
    k1 = kres[1][False]             # per-block counts, S = 4096
    k2 = wres[0]                    # the lattice's first tree, LL = 512
    launches = {k: res["launches"][k] + hres["launches"][k]
                + gas["launches"][k] + lya["launches"][k]
                + sum(r["launches"][k] for r in dm_paths.values())
                + sum(r[k] for r in new.values())
                for k in ("pair", "walk")}
    k3 = nres[0]                    # the final dm-small state's FOF inputs
    print(json.dumps({"kernels": [{
        "name": "block_pair_accumulate", "route": "cuda",
        "source": "mpgadget_tpu_torch/csrc/pairkernel.cu",
        "replaces": "mpgadget_tpu/gravity/pairkernel.py:129",
        "launches": launches["pair"],
        "launches_by_path": {"global": res["launches"]["pair"],
                             "hierarchical": hres["launches"]["pair"],
                             "star_small": gas["launches"]["pair"],
                             "lya": lya["launches"]["pair"]} | {
            k: r["launches"]["pair"] for k, r in dm_paths.items()} | {
            k: r["pair"] for k, r in new.items()},
        "max_abs_err": max([r[wp]["max_abs_err"] for r in kres
                            for wp in (False, True)]
                           + [cres["pair"]["max_abs_err"]]),
        "max_rel_err": max([r[wp]["rel"] for r in kres
                            for wp in (False, True)]
                           + [cres["pair"]["rel"]]),
        "compacted": {k: cres["pair"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by")} | {"nb": cres["nb"]},
        "hierarchical_bound_ms": hk1,
        "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": None}, {
        "name": "traverse_fused", "route": "cuda",
        "source": "mpgadget_tpu_torch/csrc/treewalk.cu",
        "replaces": "mpgadget_tpu/gravity/treewalk.py:114",
        "launches": launches["walk"],
        "launches_by_path": {"global": res["launches"]["walk"],
                             "hierarchical": hres["launches"]["walk"],
                             "star_small": gas["launches"]["walk"],
                             "lya": lya["launches"]["walk"]} | {
            k: r["launches"]["walk"] for k, r in dm_paths.items()} | {
            k: r["walk"] for k, r in new.items()},
        # over all walk cases, the clustered one's monopoles included
        "max_abs_err": max([r["max_abs_err"] for r in wres]
                           + [cres["walk"]["max_abs_err"]]),
        "max_rel_err": max([r["rel"] for r in wres]
                           + [cres["walk"]["rel"]]),
        "compacted": {k: cres["walk"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by")} | {"nb": cres["nb"]},
        "hierarchical_bound_ms": hk2,
        "monopoles_compared": sum(r["monopoles"] for r in wres),
        "critical_path_ms": k2["path_ms"],
        "serial_critical_path_ms": k2["serial_path_ms"],
        "serial_walk_ms": k2["serial_ms"],
        "kernel_alone_ms": k2["alone_ms"], "eager_ms": k2["eager_ms"],
        "ms": k2["ms"], "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
        "library_ms": None}, {
        "name": "find_neighbors", "route": "cuda",
        "source": "mpgadget_tpu_torch/csrc/neighbors.cu",
        "replaces": "mpgadget_tpu/ops/pairs.py:108",
        "launches": (hres["launches"]["neighbors"] + fres["launches"]
                     + gas["launches"]["neighbors"]
                     + lya["launches"]["neighbors"]
                     + sum(r["launches"]["neighbors"]
                           for r in dm_paths.values())
                     + sum(r["neighbors"] for r in new.values())),
        "launches_by_path": {"hierarchical": hres["launches"]["neighbors"],
                             "fof_final_state": fres["launches"],
                             "star_small": gas["launches"]["neighbors"],
                             "lya": lya["launches"]["neighbors"]} | {
            k: r["launches"]["neighbors"] for k, r in dm_paths.items()} | {
            k: r["neighbors"] for k, r in new.items()},
        # leaf lists, counts, flags and visits: identical on both sets
        # and in the serial mode
        "max_abs_err": max(r["max_abs_err"] for r in nres),
        "groups": k3["groups"], "leaf_list_max": k3["LL"],
        "visits": k3["visits"], "kernel_alone_ms": k3["alone_ms"],
        "critical_path_ms": k3["path_ms"],
        "serial_critical_path_ms": k3["serial_path_ms"],
        "serial_walk_ms": k3["serial_ms"],
        "walk_bound_ms": k3["walk_bound_ms"],
        "clusters": {k: nres[1][k] for k in (
            "ms", "alone_ms", "serial_ms", "plain_ms", "bound_ms",
            "bound_by", "walk_bound_ms", "path_ms", "serial_path_ms", "LL",
            "overflowed")},
        "serial_mode_ms": nres[2]["ms"],
        "kernel_split_ms": k3["split_ms"],
        "ms": k3["ms"], "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
        "library_ms": None}] + [sph_entry(name, which, gas, lya, gk, big[key],
                                          new)
                                for name, which, gk, key in (
            ("sph_density_pairs", "density", gk4, "k4"),
            ("sph_hydro_pairs", "hydro", gk5, "k5"))]
        + [cooling_entry(lya, k6, new, k6r)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
