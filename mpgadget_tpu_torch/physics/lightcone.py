"""Past light cone particle output (libgadget/lightcone.c:30-268), PyTorch
port of mpgadget_tpu/physics/lightcone.py on one device.

The observer sits at the box origin; the box is tiled into the positive
octant (BoxBoost^3 replicas) and at each step the DM particles that cross
the shrinking comoving horizon shell between their old and drifted
positions are interpolated onto the crossing and appended to
``lightcone/000/lightcone-00000.raw`` as float64 (x, y, z, SampleFraction)
rows, the reference's layout.

Above ReferenceRedshift only a SampleFraction subsample is kept (the
angular-resolution rule, lightcone.c:200-210), drawn per (particle,
replica) by the JAX package's uint32 hash of the ID.  torch has no uint32
arithmetic: the hash is carried in int64 and masked to 32 bits after every
add and multiply.  The horizon test is one elementwise pass per replica
that straddles the shell; only the crossing rows go to the host.  In the
sharded run each rank tests its own rows and appends to its own stripe
(``Lightcone(..., task=rank)``, :meth:`Lightcone.compute_sharded`).
"""

import os

import numpy as np
import torch
from scipy import integrate

from ..utils import constants as C

ZMIN = 0.1
ZMAX = 80.0
REFERENCE_REDSHIFT = 2.0
BOX_BOOST = 20
MASK32 = 0xFFFFFFFF


def _draw(pid, rep):
    """The subsample draw u in [0, 1) of each (particle, replica): the JAX
    package's hash, x = id + 12345 * uint32(rep0 + 3 rep1 + 9 rep2 + 1)
    (the sum in float32), two xor-shifts and a multiply, then
    float32(x) * 2^-32."""
    r = np.asarray(rep, np.float32)
    key = int(((r[0] + np.float32(3) * r[1]) + np.float32(9) * r[2])
              + np.float32(1)) & MASK32
    x = ((pid & MASK32) + ((12345 * key) & MASK32)) & MASK32
    x = x ^ (x >> 16)
    # a value below 2^32 times 0x7feb352d stays below 2^63
    x = (x * 0x7feb352d) & MASK32
    x = x ^ (x >> 15)
    return x.to(torch.float32) * float(2.0 ** -32)


def cross_mask(pos, vel, rep, ddrift, hd_prev2, hd2, hd_prev, hd,
               samplefrac, pid):
    """Per-particle horizon-crossing test and interpolation for one
    replica (lightcone_cross, lightcone.c:219-268).  pos, vel: float32
    [N, 3]; the scalars are float32 values.  Returns (hit bool[N],
    p3 float32[N, 3])."""
    rep_t = torch.as_tensor(np.asarray(rep, np.float32), device=pos.device)
    pold = pos + rep_t[None, :]
    pnew = pold + vel * ddrift
    dold2 = (pold[:, 0] * pold[:, 0] + pold[:, 1] * pold[:, 1]) \
        + pold[:, 2] * pold[:, 2]
    dnew2 = (pnew[:, 0] * pnew[:, 0] + pnew[:, 1] * pnew[:, 1]) \
        + pnew[:, 2] * pnew[:, 2]
    u = _draw(pid, rep)
    hit = (dold2 <= hd_prev2) & (dnew2 >= hd2) & (u < samplefrac)
    cnew = torch.sqrt(dnew2) - hd
    cold = torch.sqrt(dold2) - hd_prev
    denom = cnew - cold
    safe = torch.abs(denom) > 1e-20
    den = torch.where(safe, denom, 1.0)
    u1 = torch.where(safe, -cold / den, 0.5)
    u2 = torch.where(safe, cnew / den, 0.5)
    return hit, pold * u2[:, None] + pnew * u1[:, None]


def _f32(x):
    return float(np.float32(x))


def rank_crossers(ipos, vel, ptype, pid, off, boxsize, rep, ddrift,
                  hd_prev2, hd2, hd_prev, hd, samplefrac):
    """The sharded light cone's crossing test of one rank's rows
    (build_sharded_cross of the JAX package, lightcone_compute at scale,
    lightcone.c:176-221: each rank tests only its own rows, as the
    reference does): the type-1 rows that cross the shell of replica rep,
    as float64 (x, y, z) host rows.  ipos: int64 [n, 3] holding [0, 2^32)
    with the random offset off (3 ints) still applied; positions go to
    float32 directly, as the JAX package's sharded path (its
    single-device path rounds through float64); the scalars are rounded
    to float32 here."""
    o = torch.as_tensor(np.asarray(off, np.int64), device=ipos.device)
    pos = ((ipos - o[None, :]) & MASK32).to(torch.float32) \
        * float(2.0 ** -32) * _f32(boxsize)
    hit, p3 = cross_mask(pos, vel, rep, _f32(ddrift), _f32(hd_prev2),
                         _f32(hd2), _f32(hd_prev), _f32(hd),
                         _f32(samplefrac), pid)
    return p3[hit & (ptype == 1)].cpu().numpy().astype(np.float64)


class Lightcone:
    def __init__(self, CP, time_begin, unit_velocity_in_cm_s, outdir,
                 boxsize, task=0):
        self.CP = CP
        self.boxsize = boxsize
        nentry = 512
        self.tab_loga = np.linspace(np.log(max(time_begin, 1e-4)), 0.0,
                                    nentry)
        # comoving distance table in internal length units
        # (lightcone_init_entry, lightcone.c:64-90):
        # (c/unit_vel) * int dloga / (a H_internal)
        light = C.LIGHTCGS / unit_velocity_in_cm_s
        dc = np.zeros(nentry)
        for i, la in enumerate(self.tab_loga):
            val, _ = integrate.quad(
                lambda x: 1.0 / (np.exp(x) * CP.hubble_function(np.exp(x))),
                la, 0.0, epsabs=0, epsrel=1e-7, limit=200)
            dc[i] = light * val
        self.tab_dc = dc
        # one raw stripe per task, the reference's per-rank layout
        # (lightcone.c:99-108 "%03d/lightcone-%05d.raw")
        d = os.path.join(outdir, "lightcone", f"{task // 1000:03d}")
        os.makedirs(d, exist_ok=True)
        self.path = os.path.join(d, f"lightcone-{task:05d}.raw")
        self.fd = open(self.path, "ab")
        self.hd = self.hd2 = 0.0
        self.hd_prev = self.hd_prev2 = 0.0
        self.sample_fraction = 0.0
        self.hd_ref = self.get_horizon(1.0 / (1 + REFERENCE_REDSHIFT))
        self.n_written = 0

    def get_horizon(self, a):
        """Comoving horizon distance (lightcone_get_horizon)."""
        return float(np.interp(np.log(a), self.tab_loga, self.tab_dc))

    def set_time(self, a):
        """Advance the horizon shell (lightcone_set_time)."""
        z = 1.0 / a - 1.0
        if not (ZMIN < z < ZMAX):
            self.sample_fraction = 0.0
            return
        self.hd_prev, self.hd_prev2 = self.hd, self.hd2
        self.hd = self.get_horizon(a)
        self.hd2 = self.hd * self.hd
        if self.hd_prev == 0.0:
            self.hd_prev, self.hd_prev2 = self.hd, self.hd2
        if z < REFERENCE_REDSHIFT:
            self.sample_fraction = 1.0
        else:
            self.sample_fraction = (self.hd_ref / self.hd) ** 4

    def replicas(self):
        """Box replicas straddling the horizon shell (update_replicas,
        lightcone.c:135-172)."""
        reps = []
        L = self.boxsize
        nmax = min(int(np.ceil(self.hd_prev / L)) + 1, BOX_BOOST)
        for rx in range(nmax):
            for ry in range(nmax):
                for rz in range(nmax):
                    d1 = (rx * rx + ry * ry + rz * rz) * L * L
                    d2 = ((rx + 1) ** 2 + (ry + 1) ** 2
                          + (rz + 1) ** 2) * L * L
                    if d1 <= self.hd_prev2 and d2 >= self.hd2:
                        reps.append((rx * L, ry * L, rz * L))
        return reps

    def append_rows(self, rows_xyz):
        """Append crossing rows (float64 x, y, z on the host) to this
        task's stripe with the current SampleFraction column (the raw
        append of lightcone_cross, for the sharded path, whose ranks find
        their own crossers); returns the rows written."""
        if len(rows_xyz) == 0:
            return 0
        out = np.concatenate(
            [np.asarray(rows_xyz, np.float64),
             np.full((len(rows_xyz), 1), self.sample_fraction)], axis=1)
        self.fd.write(out.tobytes())
        self.fd.flush()
        self.n_written += len(rows_xyz)
        return len(rows_xyz)

    def compute_sharded(self, a, ddrift, ipos, vel, ptype, pid, off):
        """lightcone_compute on one rank's rows (:func:`rank_crossers` for
        each replica straddling the shell), appended to this task's
        stripe; returns the rows written."""
        self.set_time(a)
        if self.sample_fraction <= 0:
            return 0
        wrote = 0
        for rep in self.replicas():
            wrote += self.append_rows(rank_crossers(
                ipos, vel, ptype, pid, off, self.boxsize, rep, ddrift,
                self.hd_prev2, self.hd2, self.hd_prev, self.hd,
                self.sample_fraction))
        return wrote

    def compute(self, a, ddrift, pos, vel, is_dm, pid):
        """Write the particles crossing the horizon this step
        (lightcone_compute).  pos: float32 positions in internal units
        (random offset already removed), vel float32, is_dm bool, pid
        int64, all on one device; returns rows written."""
        self.set_time(a)
        if self.sample_fraction <= 0:
            return 0
        wrote = 0
        for rep in self.replicas():
            hit, p3 = cross_mask(
                pos, vel, rep, _f32(ddrift), _f32(self.hd_prev2),
                _f32(self.hd2), _f32(self.hd_prev), _f32(self.hd),
                _f32(self.sample_fraction), pid)
            rows = p3[hit & is_dm].cpu().numpy().astype(np.float64)
            if len(rows) == 0:
                continue
            out = np.concatenate(
                [rows, np.full((len(rows), 1), self.sample_fraction)],
                axis=1)
            self.fd.write(out.tobytes())
            wrote += len(rows)
        if wrote:
            self.fd.flush()
            self.n_written += wrote
        return wrote
