"""Build and load the port's hand-written CUDA kernels.

Every source in ``csrc/`` that holds kernels (``SOURCES``) is compiled by
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface,
and loaded with ``ctypes``.  The first :func:`load` builds every library
that is not cached yet, one ``nvcc`` process per source, all started
together.  Libraries land in ``build/kernels/`` beside the package, named
by one hash of every source and header in ``csrc/`` and every flag, so a
change to any of them rebuilds all.

Nothing is built or loaded at import: the CPU tests import every module,
and there is no ``nvcc`` without a card.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# library name -> (source, flags of that source alone)
SOURCES = {
    "pairkernel": ("pairkernel.cu", ()),
    # the walk's open/discard decisions must round as the plain version's
    # separate PyTorch operations do: no multiply-add contraction
    "treewalk": ("treewalk.cu", ("-fmad=false",)),
    # the neighbour walk (K3): the same rule for its near/far decisions
    "neighbors": ("neighbors.cu", ("-fmad=false",)),
    # the SPH pair sums (K4 density, K5 hydro): their u < 1 and r < H
    # decisions (and K5's v_sig) are spelled with never-contracted,
    # correctly rounded intrinsics, so the sums' products may fuse and
    # their divisions be approximate (2 ulp)
    "sph_density": ("sph_density.cu", ("-prec-div=false",)),
    "sph_hydro": ("sph_hydro.cu", ("-prec-div=false",)),
    # the cooling network (K6): no contraction, and (as everywhere) no fast
    # math: IEEE division and square root, denormals kept, so that it
    # rounds as the plain version's separate PyTorch operations do
    "cooling": ("cooling.cu", ("-fmad=false",)),
    # measurement aids that only chip_smoke.py loads: the serial walks the
    # port began with (K2's and K3's) and the first designs of K4, K5 and
    # K6, as yardsticks, and an L2 pointer chase
    "treewalk_serial": ("treewalk_serial.cu", ("-fmad=false",)),
    "neighbors_serial": ("neighbors_serial.cu", ("-fmad=false",)),
    "sph_density_simple": ("sph_density_simple.cu", ("-fmad=false",)),
    "sph_hydro_simple": ("sph_hydro_simple.cu", ("-fmad=false",)),
    "cooling_simple": ("cooling_simple.cu", ("-fmad=false",)),
    "l2chase": ("l2chase.cu", ()),
}

BUILD_SECONDS = {}   # library name -> wall seconds of its nvcc process
BUILD_LOG = {}       # library name -> nvcc's output (ptxas report)
_libs = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _tag():
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for name, (src, flags) in sorted(SOURCES.items()):
        h.update(f"{name} {src} {' '.join(flags)}".encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _library_path(name, tag):
    return BUILD_DIR / f"lib{name}_{tag}.so"


def build_all():
    """Compile every library not yet cached, in parallel; raise with
    nvcc's output if any build fails."""
    tag = _tag()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in SOURCES if not _library_path(n, tag).exists()]
    if not todo:
        return
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        src, flags = SOURCES[name]
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, *flags, "-I", str(CSRC), "-o", tmp,
               str(CSRC / src)]
        procs[name] = (tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (tmp, t0, proc) in procs.items():
        out, _ = proc.communicate()
        BUILD_SECONDS[name] = time.perf_counter() - t0
        BUILD_LOG[name] = out
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed on {SOURCES[name][0]}:\n{out}")
        else:
            os.replace(tmp, _library_path(name, tag))
    if failed:
        raise RuntimeError("\n".join(failed))


def check_tensor(name, t, shape, dtype):
    """Raise ValueError unless t is a contiguous CUDA tensor of the given
    shape and dtype: what a kernel's raw pointer may stand for."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def load(name):
    """The ctypes library of kernel source ``name`` (built on first use)."""
    if name not in _libs:
        tag = _tag()
        if not _library_path(name, tag).exists():
            build_all()
        _libs[name] = ctypes.CDLL(str(_library_path(name, tag)))
    return _libs[name]
