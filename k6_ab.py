"""K6 without its per-row inputs, against an older K6, on one card.

    python3 k6_ab.py OLD_COOLING_CU

OLD_COOLING_CU is a csrc/cooling.cu from before the per-row inputs (its
entry points take no uv, met and tab pointers, 22 doubles and 4 ints), for
example `git show 5b1f5dc:mpgadget_tpu_torch/csrc/cooling.cu`.  Builds it,
this tree's csrc/cooling.cu, and this tree's with its entry points forced to
the EXT = true instantiation (the per-row code, taking its scalars from
CoolArgs when the pointers are null), each with one nvcc for sm_90a into
build/k6_ab/; holds the three do_cooling_f32 outputs bit for bit on 31470
rows of two kinds (random over n_H 1e-6 ... 1e2 cm^-3 and T 1e2 ... 1e7 K,
and diffuse gas near equilibrium), without and with a scalar UV
background, and prints each version's CUDA-graph-replay milliseconds, three
rounds in alternating order.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402  (graph_ms, card_line)
from mpgadget_tpu_torch import kernels  # noqa: E402
from mpgadget_tpu_torch.physics import cooling as cool  # noqa: E402
from mpgadget_tpu_torch.utils import constants as C  # noqa: E402
from mpgadget_tpu_torch.utils import get_unitsystem  # noqa: E402

ROWS = 31470            # lya's gas rows
ENTRY = "        return uv || met                "


def build(old_src):
    """{"old", "new", "forced"} -> the loaded library."""
    out = os.path.join(HERE, "build", "k6_ab")
    os.makedirs(out, exist_ok=True)
    src = (kernels.CSRC / "cooling.cu").read_text()
    assert src.count(ENTRY) == 2, "the entry points' dispatch moved"
    with open(old_src) as fh:
        sources = {"old": fh.read(), "new": src,
                   "forced": src.replace(ENTRY, "        return true")}
    procs = {}
    for name, text in sources.items():
        cu = os.path.join(out, f"{name}.cu")
        with open(cu, "w") as fh:
            fh.write(text)
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-fmad=false", "-o",
             os.path.join(out, f"lib{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            sys.exit(f"nvcc failed on {name}:\n{log}")
        libs[name] = ctypes.CDLL(os.path.join(out, f"lib{name}.so"))
    return libs


def inputs(kind, cu, seed=7):
    """do_cooling's inputs on the card: (min_egy, [u, rho, dt, ne])."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        nh = 10 ** rng.uniform(-6, 2, ROWS)
        nh[::5] *= 1e4
        temp = 10 ** rng.uniform(2, 7, ROWS)
        ne = rng.uniform(0, 1.2, ROWS)
        dt = 10 ** rng.uniform(-6, -2, ROWS)
    else:
        nh = 10 ** rng.uniform(-5, -1, ROWS)
        temp = 10 ** rng.uniform(3.8, 4.5, ROWS)
        ne = rng.uniform(1.0, 1.16, ROWS)
        dt = 10 ** rng.uniform(-4, -3, ROWS)
    ucgs = temp * C.BOLTZMANN / (C.GAMMA_MINUS1 * 0.6 * C.PROTONMASS)
    min_egy = 100 * C.BOLTZMANN / C.PROTONMASS / C.GAMMA_MINUS1 \
        / cu.uu_in_cgs / (4 / (1 + 3 * C.HYDROGEN_MASSFRAC))

    def put(x):
        return torch.as_tensor(x, dtype=torch.float32, device="cuda")
    return min_egy, [put(ucgs / cu.uu_in_cgs),
                     put(nh * C.PROTONMASS / C.HYDROGEN_MASSFRAC
                         / cu.density_in_phys_cgs), put(dt), put(ne)]


def launcher(name, lib, ins, outs, args):
    """One do_cooling_f32 launch on the current stream, as a closure."""
    fn = lib.do_cooling_f32
    fn.restype = ctypes.c_int
    d, k = args
    ptrs = [t.data_ptr() for t in ins + outs]
    if name == "old":
        d, k = np.ascontiguousarray(d[:22]), np.ascontiguousarray(k[:4])
    else:
        ptrs += [None] * cool.N_EXTRA
    fn.argtypes = [ctypes.c_void_p] * (len(ptrs) + 1) + [ctypes.c_int64] \
        + [ctypes.c_void_p] * 3

    def call():
        rc = fn(*ptrs, None, ROWS, d.ctypes.data, k.ctypes.data,
                torch.cuda.current_stream().cuda_stream)
        assert rc == 0, f"{name}: CUDA error {rc}"
    return call


def main():
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        sys.exit(__doc__)
    libs = build(sys.argv[1])
    print(chip_smoke.card_line(), flush=True)
    units = get_unitsystem(C.CM_PER_KPC, 1.989e43, 1e5)
    cu = cool.CoolingUnits(units.UnitDensity_in_cgs * 0.49,
                           units.UnitInternalEnergy_in_cgs,
                           units.UnitTime_in_s / 0.7)
    p = cool.CoolingParams(MinGasTemp=100.0)
    cr = cool.CoolingRates(p, cool.TreeCool(None, p))
    uvs = {"no UV background": cool.UVBG(),
           "scalar UV background": cool.UVBG(
               gJH0=1e-12, gJHe0=8e-13, gJHep=3e-14, epsH0=5e-24,
               epsHe0=6e-24, epsHep=2e-25, self_shield_dens=5e-3)}
    for kind in ("random", "near equilibrium"):
        min_egy, ins = inputs(kind, cu)
        for uv_name, uvbg in uvs.items():
            args = cool.kernel_args(cr, 3.0, uvbg, min_egy, cu)
            outs, calls = {}, {}
            for name, lib in libs.items():
                outs[name] = [torch.empty_like(ins[0]) for _ in range(2)]
                calls[name] = launcher(name, lib, ins, outs[name], args)
                calls[name]()
            torch.cuda.synchronize()
            for name in ("new", "forced"):
                for a, b in zip(outs["old"], outs[name]):
                    if not torch.equal(a.view(torch.int32),
                                       b.view(torch.int32)):
                        sys.exit(f"{name} differs from old: {kind}, "
                                 f"{uv_name}")
            ms = {name: [] for name in libs}
            for rnd in range(3):
                order = list(libs) if rnd % 2 == 0 else list(libs)[::-1]
                for name in order:
                    ms[name].append(chip_smoke.graph_ms(calls[name], 20))
            print(f"K6 do_cooling_f32, {kind}, {uv_name}, {ROWS} rows, "
                  f"the three bit for bit: " + "; ".join(
                      f"{name} {np.mean(v):.6f} ms (" + " ".join(
                          f"{x:.6f}" for x in v) + ")"
                      for name, v in ms.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
