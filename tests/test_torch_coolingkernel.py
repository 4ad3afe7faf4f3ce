"""K6's procedure on the CPU: csrc/cooling.cu compiled for the host.

There is no card here, so this compiles the kernel's own source with the
host's C++ compiler against a small stand-in for the CUDA runtime (the
lanes of a lane group fibers on the calling thread, __shfl_sync an
exchange within the group at which each lane passes control to the
next), and csrc/cooling_simple.cu (the first design, a thread a row, no
early exit) the same way.  Both run the same C entry points on the same
inputs; the redesign must equal the first design bit for bit, as
tests/test_torch_cuda.py holds them on a card.  This checks the
procedure: the exact exits, the lanes' slots and shuffles, the reuse of
an evaluation.  The redesign's optional per-row inputs (UV rates,
metallicity with the metal table), which the first design lacks, are
held to the outputs without them where they reduce to them, bit for bit,
and otherwise to the plain version.  The host's libm stands in for CUDA's, so the outputs are
compared with each other, and with the plain version only to the
tolerance of tests/test_torch_cooling.py.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from mpgadget_tpu_torch import kernels
from mpgadget_tpu_torch.physics import cooling as cool

torch.set_num_threads(1)

HOST_CUDA = r"""
#pragma once
#include <cmath>
#include <atomic>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <functional>
#include <ucontext.h>
#include <vector>
#define __host__
#define __device__
#define __global__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(x)
struct dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3 threadIdx, blockIdx, blockDim;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
inline unsigned __float_as_uint(float x) {
    unsigned u; std::memcpy(&u, &x, 4); return u; }
inline long long __double_as_longlong(double x) {
    long long u; std::memcpy(&u, &x, 8); return u; }
using std::exp; using std::log; using std::pow; using std::sqrt;
template <typename T> T __ldg(const T* p) { return *p; }
struct LaneGroup {   // the group's lanes, fibers, and their slots
    int n = 1, done = 0;
    ucontext_t* ctx = nullptr;
    ucontext_t home;
    unsigned char slot[32][8];
    void wait();
};
inline thread_local LaneGroup* lane_group;
inline thread_local int lane_index;
// a barrier of the group: every lane passes it the same number of times,
// in turn, so each passes control to the next and resumes when all have
inline void LaneGroup::wait() {
    int me = lane_index;
    dim3 t = threadIdx;
    swapcontext(&ctx[me], &ctx[(me + 1) % n]);
    lane_index = me;
    threadIdx = t;
}
template <typename T> T __shfl_sync(unsigned, T v, int src, int width) {
    std::memcpy(lane_group->slot[lane_index], &v, sizeof(T));
    lane_group->wait();
    T r; std::memcpy(&r, lane_group->slot[src % width], sizeof(T));
    lane_group->wait();
    return r;
}
inline thread_local std::function<void(int)>* lane_entry;
inline void lane_start(int k) { (*lane_entry)(k); }
template <typename F, typename... A>
void host_launch(int lanes, unsigned blocks, int threads, int, cudaStream_t,
                 F f, A... args) {
    // one lane group at a time: a fiber a lane where lanes exchange
    // values, the calling thread where a row has one lane
    std::vector<ucontext_t> ctx(lanes);
    std::vector<std::vector<char>> stacks(lanes,
                                          std::vector<char>(1 << 20));
    for (unsigned b = 0; b < blocks; ++b)
        for (int first = 0; first < threads; first += lanes) {
            LaneGroup group;
            group.n = lanes;
            group.ctx = ctx.data();
            auto lane = [&](int k) {
                threadIdx.x = first + k; blockIdx.x = b;
                blockDim.x = threads;
                lane_group = &group; lane_index = k;
                f(args...);
            };
            if (lanes == 1) {
                lane(0);
                continue;
            }
            std::function<void(int)> run = [&](int k) {
                lane(k);
                if (++group.done == lanes)      // the last lane to return
                    setcontext(&group.home);
                swapcontext(&ctx[k], &ctx[(k + 1) % lanes]);
            };
            lane_entry = &run;
            for (int k = 0; k < lanes; ++k) {
                getcontext(&ctx[k]);
                ctx[k].uc_stack.ss_sp = stacks[k].data();
                ctx[k].uc_stack.ss_size = stacks[k].size();
                ctx[k].uc_link = &group.home;
                makecontext(&ctx[k], (void (*)())lane_start, 1, k);
            }
            swapcontext(&group.home, &ctx[0]);
        }
}
"""


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """{"new": cooling.cu, "first": cooling_simple.cu}, each compiled for
    the host (a launch runs a thread a lane: LANES for the new one)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    tmp = tmp_path_factory.mktemp("k6_host")
    (tmp / "host_cuda.h").write_text(HOST_CUDA)
    builds = {}
    for key, name, lanes in (("new", "cooling.cu", "LANES"),
                             ("first", "cooling_simple.cu", "1")):
        src = (kernels.CSRC / name).read_text().replace(
            "#include <cuda_runtime.h>", '#include "host_cuda.h"')
        src, n = re.subn(r"(\w+<[^<>]*>)<<<([^>]*)>>>\(",
                         lambda m: f"host_launch({lanes}, {m.group(2)}, "
                         f"{m.group(1)}, ", src)
        assert n == 2
        (tmp / f"{key}.cpp").write_text(src)
        lib = tmp / f"lib{key}.so"
        builds[key] = lib, subprocess.Popen(   # both compiles at once
            [cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared",
             "-fPIC", "-pthread", "-I", str(tmp), "-o", str(lib),
             str(tmp / f"{key}.cpp")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for key, (lib, proc) in builds.items():
        out = proc.communicate()[0]
        assert proc.returncode == 0, out
        libs[key] = ctypes.CDLL(str(lib))
    return libs


def _call(lib, name, ins, outs, rows, args, extra=None):
    """One entry point of a host build; extra: the redesign's optional
    inputs (per-row UV rates, metallicity, metal table; each a tensor or
    None), absent from the first design's entry points."""
    suffix = "f32" if ins[0].dtype == torch.float32 else "f64"
    fn = getattr(lib, f"{name}_{suffix}")
    fn.restype = ctypes.c_int
    ptrs = [t.data_ptr() for t in ins] + [None] * len(outs)
    if extra is not None:
        ptrs += [None if t is None else t.data_ptr() for t in extra]
    fn.argtypes = [ctypes.c_void_p] * (len(ptrs) + 1) \
        + [ctypes.c_int64] + [ctypes.c_void_p] * 3
    outs = [o.clone() for o in outs]
    ptrs[len(ins):len(ins) + len(outs)] = [o.data_ptr() for o in outs]
    n = ins[0].shape[0] if rows is None else rows.shape[0]
    assert fn(*ptrs, None if rows is None else rows.data_ptr(), n,
              args[0].ctypes.data, args[1].ctypes.data, None) == 0
    return outs


def _bits(x):
    return x.view(torch.int32 if x.dtype == torch.float32 else torch.int64)


def _inputs(dtype, n, seed):
    """do_cooling's and the rate's inputs over n_H 1e-6 ... 1e2 cm^-3 (a
    fifth of the rows 1e4 times denser, self-shielded), T 1e2 ... 1e7 K,
    with rows at min_u, zero ne and a NaN row."""
    from mpgadget_tpu_torch.utils import constants as C
    from mpgadget_tpu_torch.utils import get_unitsystem
    units = get_unitsystem(C.CM_PER_KPC, 1.989e43, 1e5)
    cu = cool.CoolingUnits(units.UnitDensity_in_cgs * 0.49,
                           units.UnitInternalEnergy_in_cgs,
                           units.UnitTime_in_s / 0.7)
    rng = np.random.default_rng(seed)
    nh = 10 ** rng.uniform(-6, 2, n)
    nh[::5] *= 1e4
    ucgs = 10 ** rng.uniform(2, 7, n) * C.BOLTZMANN \
        / (C.GAMMA_MINUS1 * 0.6 * C.PROTONMASS)
    min_egy = 100 * C.BOLTZMANN / C.PROTONMASS / C.GAMMA_MINUS1 \
        / cu.uu_in_cgs / (4 / (1 + 3 * C.HYDROGEN_MASSFRAC))
    u = ucgs / cu.uu_in_cgs
    u[1::9] = 0.5 * min_egy
    ne = rng.uniform(0, 1.2, n)
    ne[::7] = 0.0
    u[4] = np.nan

    def put(x):
        return torch.as_tensor(x, dtype=dtype)
    return dict(cu=cu, min_egy=min_egy, u=put(u),
                rho=put(nh * C.PROTONMASS / C.HYDROGEN_MASSFRAC
                        / cu.density_in_phys_cgs),
                dt=put(10 ** rng.uniform(-6, -2, n)), ne=put(ne),
                dens=put(nh / C.HYDROGEN_MASSFRAC), ucgs=put(ucgs))


def _both(host_libs, cr, uvbg, c, rows):
    """Both entry points through both host builds: each output pair bit
    for bit; returns the new build's do_cooling outputs."""
    got = {}
    for name, ins, outs, args in (
            ("do_cooling", [c["u"], c["rho"], c["dt"], c["ne"]],
             [c["u"], c["ne"]],
             cool.kernel_args(cr, 1.5, uvbg, c["min_egy"], c["cu"])),
            ("heatingcooling_rate", [c["dens"], c["ucgs"], c["ne"]],
             [torch.zeros_like(c["u"]), c["ne"]],
             cool.kernel_args(cr, 3.0, uvbg))):
        new = _call(host_libs["new"], name, ins, outs, rows, args,
                    (None,) * cool.N_EXTRA)
        first = _call(host_libs["first"], name, ins, outs, rows, args)
        for x, y in zip(new, first):
            assert torch.equal(_bits(x), _bits(y)), name
        got[name] = new
    return got["do_cooling"]


@pytest.mark.parametrize("dtype,uv", [(torch.float32, False),
                                      (torch.float32, True),
                                      (torch.float64, True)])
def test_host_build_matches_first_design(host_libs, dtype, uv):
    """The redesign against the first design, both compiled for the host,
    on 61 rows (no multiple of a row's lanes), all and a listed third;
    the NaN row NaN, and the others' u_new within the plain version's
    float32 tolerance (tests/test_torch_cooling.py: 2e-5, host libm
    against PyTorch's)."""
    p = cool.CoolingParams(MinGasTemp=100.0)
    cr = cool.CoolingRates(p, cool.TreeCool(None, p))
    uvbg = cool.UVBG(gJH0=1e-12, gJHe0=8e-13, gJHep=3e-14, epsH0=5e-24,
                     epsHe0=6e-24, epsHep=2e-25, self_shield_dens=5e-3) \
        if uv else cool.UVBG()
    c = _inputs(dtype, 61, 37)
    u, _ = _both(host_libs, cr, uvbg, c, None)
    _both(host_libs, cr, uvbg, c, torch.arange(0, 61, 3))
    assert torch.isnan(u[4]) and bool(torch.isfinite(u[5:]).all())
    ok = ~torch.isnan(c["u"])
    ur, _ = cool.do_cooling_reference(cr, 1.5, c["u"][ok], c["rho"][ok],
                                      c["dt"][ok], uvbg, c["ne"][ok],
                                      c["min_egy"], c["cu"])
    torch.testing.assert_close(u[ok], ur, rtol=2e-5, atol=0)


@pytest.mark.parametrize("kind", [(r, k) for r in range(3) for k in range(3)]
                         + ["helium"])
def test_host_build_options_match_first_design(host_libs, kind):
    """Every recombination x cooling option, and HeliumHeatOn: the
    redesign's host build against the first design's, bit for bit
    (float32, UV background on, 13 rows)."""
    kw = dict(HeliumHeatOn=True, HeliumHeatThresh=10.0, HeliumHeatAmp=1.5,
              HeliumHeatExp=-0.5) if kind == "helium" \
        else dict(recomb=kind[0], cooling=kind[1])
    p = cool.CoolingParams(MinGasTemp=100.0, **kw)
    cr = cool.CoolingRates(p, cool.TreeCool(None, p))
    uvbg = cool.UVBG(gJH0=1e-12, gJHe0=8e-13, gJHep=3e-14, epsH0=5e-24,
                     epsHe0=6e-24, epsHep=2e-25, self_shield_dens=5e-3)
    _both(host_libs, cr, uvbg, _inputs(torch.float32, 13, 41), None)


def _metal_table():
    """A metal cooling table from tests/test_torch_reion.py's closed form,
    built in memory."""
    z = np.linspace(0.0, 10.0, 6)
    lognh = np.linspace(-6.0, 3.0, 10)
    logt = np.linspace(2.0, 9.0, 15)
    zz, nn, tt = np.meshgrid(z, lognh, logt, indexing="ij")
    return cool.MetalCoolingTable(
        z, lognh, logt,
        1e-23 * (1 + zz) * np.exp(-(nn + 2) ** 2) * np.exp(-(tt - 5) ** 2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_host_build_per_row_inputs(host_libs, dtype):
    """The redesign's optional inputs on the host build, 25 rows: per-row
    UV rates equal to the scalars on every row and a zero metallicity with
    the metal table give the outputs without them bit for bit; rows whose
    rates are gated off (local_uvbg) give the scalar call without a UV
    background bit for bit; with a metallicity in [0, 0.02] and a third of
    the rows gated off, both entry points match the plain version within
    tests/test_torch_cooling.py's tolerances (u_new 2e-5; the rate 4e-6
    plus 1e-7 of its largest value, ne/nh 1e-6; float64 1e-9), the metal
    term lowering the net rate."""
    p = cool.CoolingParams(MinGasTemp=100.0)
    cr = cool.CoolingRates(p, cool.TreeCool(None, p),
                           metal_table=_metal_table())
    uvbg = cool.UVBG(gJH0=1e-12, gJHe0=8e-13, gJHep=3e-14, epsH0=5e-24,
                     epsHe0=6e-24, epsHep=2e-25, self_shield_dens=5e-3)
    n = 25
    c = _inputs(dtype, n, 43)
    rng = np.random.default_rng(5)
    zmet = torch.as_tensor(rng.uniform(0, 0.02, n).astype(np.float32))
    gated = cool.local_uvbg(uvbg, torch.as_tensor(
        np.where(np.arange(n) % 3 == 0, 1.0, 20.0).astype(np.float32)), 3.0)
    calls = {
        "do_cooling": ([c["u"], c["rho"], c["dt"], c["ne"]],
                       [c["u"], c["ne"]], 1.5, (c["min_egy"], c["cu"])),
        "heatingcooling_rate": ([c["dens"], c["ucgs"], c["ne"]],
                                [torch.zeros_like(c["u"]), c["ne"]], 3.0,
                                ())}

    def run(name, uv, zm, scalars=None):
        ins, outs, z, extra = calls[name]
        args = cool.kernel_args(cr if scalars is None else scalars, z,
                                uv, *extra)
        return _call(host_libs["new"], name, ins, outs, None, args,
                     cool.kernel_extra(cr, uv, zm, ins[0]))

    # the scalars on every row, in the rows' type (local_uvbg's float32
    # rates would promote to other float64 values)
    same = cool.UVBG(**{k: torch.full((n,), getattr(uvbg, k), dtype=dtype)
                        for k in cool.UV_RATES},
                     self_shield_dens=uvbg.self_shield_dens)
    for name in calls:
        want = run(name, uvbg, None)
        for x, y in zip(run(name, same, torch.zeros(n)), want):
            assert torch.equal(_bits(x), _bits(y)), name
        off = gated.gJH0 == 0
        dark = run(name, cool.UVBG(), None)
        for x, y in zip(run(name, gated, None), dark):
            assert torch.equal(_bits(x[off]), _bits(y[off])), name
    ok = ~torch.isnan(c["u"])
    u, ne = run("do_cooling", gated, zmet)
    ur, _ = cool.do_cooling_reference(
        cr, 1.5, c["u"][ok], c["rho"][ok], c["dt"][ok],
        cool.uvbg_rows(gated, ok), c["ne"][ok], c["min_egy"], c["cu"],
        metallicity=zmet[ok])
    f64 = dtype == torch.float64
    torch.testing.assert_close(u[ok], ur, rtol=1e-9 if f64 else 2e-5,
                               atol=0)
    lam, ne = run("heatingcooling_rate", gated, zmet)
    lr, nr = cr.get_heatingcooling_rate(c["dens"][ok], c["ucgs"][ok], 3.0,
                                        cool.uvbg_rows(gated, ok),
                                        c["ne"][ok], metallicity=zmet[ok])
    scale = float(lr.abs().max())
    torch.testing.assert_close(lam[ok], lr, rtol=1e-9 if f64 else 4e-6,
                               atol=(1e-12 if f64 else 1e-7) * scale)
    torch.testing.assert_close(ne[ok], nr, rtol=1e-9 if f64 else 0,
                               atol=1e-12 if f64 else 1e-6)
    lam0, _ = run("heatingcooling_rate", gated, torch.zeros(n))
    assert (lam[ok] < lam0[ok]).sum() > 5
