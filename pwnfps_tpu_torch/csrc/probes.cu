// The two probe kernels of the port's tools, for Hopper (sm_90a).
//
//  * add_one_kernel (entry pwnfps_add_one) replaces the TPU kernel of
//    tools/launch_probe.py (main.kern, pallas_call :41): o = x + 1 over a
//    flat f32 array.  The tool chains n launches to read the cost of one
//    (pwnfps_tpu_torch/tools/launch_probe.py).  It is CUDA C++ behind
//    ctypes, not Triton, although an elementwise pass would serve equally
//    well in either: the probe's point is the cost of the port's own launch
//    route (a ctypes call into an nvcc-built library, then
//    cudaGetLastError), so it must take that route.  What bounds it on the
//    H100: memory, 8 bytes an element (one read, one write); the default
//    [16320, 128] array (the 1080p trace call's grid on the TPU) moves
//    16.7 MB, about 5 us at 3.35 TB/s, so a launch costs about as much as
//    the kernel.  Design: a grid-stride loop, 256 threads a block, at
//    most 2048 blocks; no vector loads.
//
//  * vpu_chains_kernel (entry pwnfps_vpu_chains) replaces the TPU kernel
//    of tools/vpu_probe.py (main.make_kernel, inner kern :48, pallas_call
//    :79): S independent chains over one f32 (8, 128) plane, T iterations
//    of U = 32 updates of every chain, m = a*0.9999 + 1e-7, chain s
//    starting at a + s; `fma` updates acc*m + a (two operations), `sel`
//    updates where(acc > a, acc*m, a) (three); the output is the chains'
//    sum in order.  It reads the card's FP32 and select issue rates, which
//    every bound in PERF.md divides by.  What bounds it: operations, by
//    design.  One thread per plane element, 1024 threads a block (one
//    plane), its S accumulators in registers, U and S unrolled so that
//    the loop's own cost is amortised 32x; each block works on its own
//    copy of the plane and writes its own [8, 128] result, so one block
//    is one SM (the TPU kernel's one core) and as many blocks as SMs are
//    the whole card.
//
// Numerics: built with --fmad=false (_build.py), so acc*m + a is an FMUL
// and an FADD with two roundings, as on the TPU and in eager torch: the
// instruction mix the tracer runs.  The constants 0.9999 and 1e-7 come
// from the host as f32, so kernel and plain version share their bits.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int ADD_BLOCK = 256, ADD_MAX_GRID = 2048;
constexpr int PLANE = 8 * 128;   // one (8, 128) plane, one thread each
constexpr int U = 32;            // chained updates a chain an iteration

__global__ void __launch_bounds__(ADD_BLOCK)
add_one_kernel(const float* __restrict__ x, float* __restrict__ o, int n) {
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += gridDim.x * blockDim.x)
        o[i] = x[i] + 1.0f;
}

template <bool SEL, int S>
__global__ void __launch_bounds__(PLANE)
vpu_chains_kernel(const float* __restrict__ a_in, float* __restrict__ out,
                  int T, float mul, float add) {
    const int t = threadIdx.x;
    const float a = a_in[t];
    const float m = a * mul + add;
    float acc[S];
#pragma unroll
    for (int s = 0; s < S; ++s) acc[s] = a + (float)s;
    for (int it = 0; it < T; ++it) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
            for (int s = 0; s < S; ++s)
                acc[s] = SEL ? (acc[s] > a ? acc[s] * m : a)
                             : acc[s] * m + a;
        }
    }
    float r = acc[0];
#pragma unroll
    for (int s = 1; s < S; ++s) r = r + acc[s];
    out[blockIdx.x * PLANE + t] = r;
}

template <bool SEL>
int launch_chains(const float* a, float* out, int S, int T, int blocks,
                  float mul, float add, cudaStream_t stream) {
    switch (S) {
    case 1:
        vpu_chains_kernel<SEL, 1><<<blocks, PLANE, 0, stream>>>(
            a, out, T, mul, add);
        break;
    case 4:
        vpu_chains_kernel<SEL, 4><<<blocks, PLANE, 0, stream>>>(
            a, out, T, mul, add);
        break;
    case 16:
        vpu_chains_kernel<SEL, 16><<<blocks, PLANE, 0, stream>>>(
            a, out, T, mul, add);
        break;
    default:
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // namespace

// o = x + 1 over n f32 (x, o device pointers).  Launches on `stream`;
// returns cudaGetLastError().
extern "C" int pwnfps_add_one(const void* x, void* o, int n, void* stream) {
    if (n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const int need = (n + ADD_BLOCK - 1) / ADD_BLOCK;
    const int grid = need < ADD_MAX_GRID ? need : ADD_MAX_GRID;
    add_one_kernel<<<grid, ADD_BLOCK, 0, (cudaStream_t)stream>>>(
        (const float*)x, (float*)o, n);
    return (int)cudaGetLastError();
}

// The chains probe: a f32 [8 * 128] in, out f32 [blocks * 8 * 128];
// sel 0 runs the fma variant, 1 the sel variant; S in {1, 4, 16}; T >= 0
// iterations; mul, add: f32(0.9999), f32(1e-7).  Launches on `stream`;
// returns cudaGetLastError().
extern "C" int pwnfps_vpu_chains(const void* a, void* out, int sel, int S,
                                 int T, int blocks, float mul, float add,
                                 void* stream) {
    if (T < 0 || blocks < 1 || (sel != 0 && sel != 1))
        return (int)cudaErrorInvalidValue;
    return sel ? launch_chains<true>((const float*)a, (float*)out, S, T,
                                     blocks, mul, add, (cudaStream_t)stream)
               : launch_chains<false>((const float*)a, (float*)out, S, T,
                                      blocks, mul, add,
                                      (cudaStream_t)stream);
}
