"""Dense block pair interactions (direct forces): CUDA kernel + plain version.

The direct (opened-leaf) part of the short-range gravity is a dense
(G targets) x (S sources) pair sum per target block.  On CUDA tensors
:func:`block_pair_accumulate` launches the hand-written kernel in
``csrc/pairkernel.cu`` (the port of the Pallas kernel
``mpgadget_tpu/gravity/pairkernel.py:block_pair_accumulate``); on CPU
tensors it runs :func:`block_pair_accumulate_reference`, the same math in
plain PyTorch.  There is no switch between the two other than the
device of the tensors: a CUDA tensor launches the kernel or raises.

The kernel is compiled with ``nvcc`` for ``sm_90a`` at first use into
``build/kernels/`` beside the package (cached by a hash of the source)
and loaded through ``ctypes``.  ``LAUNCHES`` counts kernel launches.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from .shortrange import (shortrange_force_window, shortrange_pot_window,
                         softened_force_factor, softened_pot_factor)

SRC = Path(__file__).resolve().parent.parent / "csrc" / "pairkernel.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_G = 1024
PLAIN_BLOCK_BATCH = 512   # blocks per plain-version batch (bounds memory)

LAUNCHES = 0          # kernel launches (not plain-version calls)
BUILD_SECONDS = None  # wall time of the nvcc call (None: cached or unbuilt)
BUILD_LOG = ""        # nvcc's output (ptxas register / smem report)
_lib = None


def _wrap(d):
    """Minimum image for box-unit coordinate differences."""
    return d - torch.round(d)


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the pair kernel cannot be built")


def build():
    """Compile (if not cached) and load the kernel library; returns it."""
    global _lib, BUILD_SECONDS, BUILD_LOG
    if _lib is not None:
        return _lib
    src = SRC.read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"libpairkernel_{tag}.so"
    if not so.exists():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SRC)],
                              capture_output=True, text=True)
        BUILD_SECONDS = time.perf_counter() - t0
        BUILD_LOG = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed on {SRC}:\n{BUILD_LOG}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    fn = lib.block_pair_accumulate_f32
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 11
                   + [ctypes.c_int] * 3 + [ctypes.c_float] * 3
                   + [ctypes.c_int, ctypes.c_void_p])
    _lib = lib
    return lib


def _check(name, t, shape):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")


def _launch(tx, ty, tz, sx, sy, sz, sm, acc0, pot0, rs_inv, h_inv, rcut,
            with_potential):
    global LAUNCHES
    nb, G = tx.shape
    S = sx.shape[1]
    if G > MAX_G:
        raise ValueError(f"group size {G} > {MAX_G} threads per block")
    if any(t.device != tx.device for t in (ty, tz, sx, sy, sz, sm, acc0,
                                           pot0)):
        raise ValueError("pair kernel inputs must be on one device")
    for name, t, shape in (("tx", tx, (nb, G)), ("ty", ty, (nb, G)),
                           ("tz", tz, (nb, G)), ("sx", sx, (nb, S)),
                           ("sy", sy, (nb, S)), ("sz", sz, (nb, S)),
                           ("sm", sm, (nb, S)), ("acc0", acc0, (nb, 3, G)),
                           ("pot0", pot0, (nb, G))):
        _check(name, t, shape)
    lib = build()
    acc = torch.empty_like(acc0)
    pot = torch.empty_like(pot0)
    with torch.cuda.device(tx.device):
        rc = lib.block_pair_accumulate_f32(
            tx.data_ptr(), ty.data_ptr(), tz.data_ptr(), sx.data_ptr(),
            sy.data_ptr(), sz.data_ptr(), sm.data_ptr(), acc0.data_ptr(),
            pot0.data_ptr(), acc.data_ptr(), pot.data_ptr(), nb, G, S,
            float(rs_inv), float(h_inv), float(rcut), int(with_potential),
            torch.cuda.current_stream(tx.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pair kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return acc, pot


def block_pair_accumulate_reference(tx, ty, tz, sx, sy, sz, sm, acc0, pot0,
                                    rs_inv, h_inv, rcut, chunk=512,
                                    with_potential=False):
    """Plain PyTorch version: chunked over S, batched over blocks (the
    jnp branch of mpgadget_tpu's evaluate_leaves).  Same contract as
    :func:`block_pair_accumulate`."""
    nb, G = tx.shape
    S = sx.shape[1]
    CH = min(chunk, S)
    if S % CH:
        CH = S
    acc = acc0.clone()
    pot = pot0.clone()
    for b0 in range(0, nb, PLAIN_BLOCK_BATCH):
        bs = slice(b0, min(nb, b0 + PLAIN_BLOCK_BATCH))
        txb = tx[bs, :, None]
        tyb = ty[bs, :, None]
        tzb = tz[bs, :, None]
        ax, ay, az = acc[bs, 0], acc[bs, 1], acc[bs, 2]
        pb = pot[bs]
        for c0 in range(0, S, CH):
            cs = slice(c0, c0 + CH)
            dx = _wrap(sx[bs, None, cs] - txb)
            dy = _wrap(sy[bs, None, cs] - tyb)
            dz = _wrap(sz[bs, None, cs] - tzb)
            m = sm[bs, None, cs]
            rr = torch.sqrt(dx * dx + dy * dy + dz * dz)      # (B, G, CH)
            ff = softened_force_factor(rr, h_inv) \
                * shortrange_force_window(rr, rs_inv) * m
            ff = torch.where(rr < rcut, ff, 0.0)
            ax += torch.sum(ff * dx, dim=2)
            ay += torch.sum(ff * dy, dim=2)
            az += torch.sum(ff * dz, dim=2)
            if with_potential:
                pp = softened_pot_factor(rr, h_inv) \
                    * shortrange_pot_window(rr, rs_inv) * m
                pp = torch.where((rr > 0) & (rr < rcut), pp, 0.0)
                pb += torch.sum(pp, dim=2)
    return acc, pot


def block_pair_accumulate(tx, ty, tz, sx, sy, sz, sm, acc0, pot0, rs_inv,
                          h_inv, rcut, chunk=512, with_potential=False):
    """acc0 (nb,3,G) += dense pair forces of (nb,S) sources on (nb,G)
    targets; returns (acc (nb,3,G), pot (nb,G)).  Geometry in box units,
    minimum-image wrap per component.  CPU tensors run the plain version;
    any other tensor launches the CUDA kernel or raises."""
    if tx.device.type == "cpu":
        return block_pair_accumulate_reference(
            tx, ty, tz, sx, sy, sz, sm, acc0, pot0, rs_inv, h_inv, rcut,
            chunk=chunk, with_potential=with_potential)
    return _launch(tx, ty, tz, sx, sy, sz, sm, acc0, pot0, rs_inv, h_inv,
                   rcut, with_potential)
