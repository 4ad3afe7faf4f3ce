"""K6's procedure on the CPU: csrc/cooling.cu compiled for the host.

There is no card here, so this compiles the kernel's own source with the
host's C++ compiler against a small stand-in for the CUDA runtime (each
thread of a block a std::thread, __shfl_sync an exchange within the lane
group), and csrc/cooling_simple.cu (the first design, a thread a row, no
early exit) the same way.  Both run the same C entry points on the same
inputs; the redesign must equal the first design bit for bit, as
tests/test_torch_cuda.py holds them on a card.  This checks the
procedure: the exact exits, the lanes' slots and shuffles, the reuse of
an evaluation.  The host's libm stands in for CUDA's, so the outputs are
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
#include <thread>
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
struct LaneGroup {   // a barrier of the group's n threads, and their slots
    std::atomic<int> count{0}, gen{0};
    int n = 1;
    unsigned char slot[32][8];
    void wait() {
        int g = gen.load();
        if (count.fetch_add(1) + 1 == n) {
            count.store(0);
            gen.fetch_add(1);
        } else {
            while (gen.load() == g) std::this_thread::yield();
        }
    }
};
inline thread_local LaneGroup* lane_group;
inline thread_local int lane_index;
template <typename T> T __shfl_sync(unsigned, T v, int src, int width) {
    std::memcpy(lane_group->slot[lane_index], &v, sizeof(T));
    lane_group->wait();
    T r; std::memcpy(&r, lane_group->slot[src % width], sizeof(T));
    lane_group->wait();
    return r;
}
template <typename F, typename... A>
void host_launch(int lanes, unsigned blocks, int threads, int, cudaStream_t,
                 F f, A... args) {
    // one lane group at a time: a thread a lane where lanes exchange values,
    // the calling thread where a row has one lane
    for (unsigned b = 0; b < blocks; ++b)
        for (int first = 0; first < threads; first += lanes) {
            LaneGroup group;
            group.n = lanes;
            auto run = [&](int t) {
                threadIdx.x = t; blockIdx.x = b; blockDim.x = threads;
                lane_group = &group; lane_index = t - first;
                f(args...);
            };
            if (lanes == 1) {
                run(first);
                continue;
            }
            std::vector<std::thread> pool;
            for (int t = first; t < first + lanes; ++t)
                pool.emplace_back(run, t);
            for (auto& th : pool) th.join();
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


def _call(lib, name, ins, outs, rows, args):
    suffix = "f32" if ins[0].dtype == torch.float32 else "f64"
    fn = getattr(lib, f"{name}_{suffix}")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * (len(ins) + len(outs) + 1) \
        + [ctypes.c_int64] + [ctypes.c_void_p] * 3
    outs = [o.clone() for o in outs]
    n = ins[0].shape[0] if rows is None else rows.shape[0]
    assert fn(*[t.data_ptr() for t in ins + outs],
              None if rows is None else rows.data_ptr(), n,
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
        new = _call(host_libs["new"], name, ins, outs, rows, args)
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
