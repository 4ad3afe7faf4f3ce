// Measurement aid, not on the simulation's path (chip_smoke.py loads it):
// one thread follows a chain of dependent loads through `next`, cached in
// L2 only (__ldcg), so with the chain resident in L2 the time per step is
// one L2 round trip: the latency that bounds each of the tree walk's
// dependent node visits (csrc/treewalk.cu).

#include <cuda_runtime.h>

__global__ void l2_chase_kernel(const int* __restrict__ next, int steps,
                                int* __restrict__ out) {
    int j = 0;
    for (int s = 0; s < steps; ++s) j = __ldcg(next + j);
    *out = j;
}

extern "C" int l2_chase(const int* next, int steps, int* out, void* stream) {
    l2_chase_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(next, steps, out);
    return (int)cudaGetLastError();
}
