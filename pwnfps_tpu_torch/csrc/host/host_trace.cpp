// The parity instances' trace_ray (csrc/tracer_body.cuh) on the host, one
// ray after another, for tools/host_trace.py: built by a host C++
// compiler against the cuda_runtime.h beside this file, called with the
// card's Args (ops/tracer.py _pack).  The cell tables, sphere records and
// compact SSE tables are read where the caller's pointers point (the
// read-only path, T = false), and the unwind records take a vector of
// the block's stride.
#include <vector>

#include "tracer_body.cuh"

dim3 threadIdx, blockIdx, blockDim, gridDim;
uint32_t smem[1];

// Trace a.n rays in parity mode; 0, or 1 when the Args are refused
extern "C" int pwnfps_host_trace(const void* args) {
    const Args& g = *(const Args*)args;
    const Params a = params_of(g);
    if (bad_params(a, true) || !g.parity || a.fused) return 1;
    World w = {};
    w.ent = a.ent;
    w.word = a.word;
    w.sph = a.sph;
    w.n_spheres = a.n_spheres;
    w.n_pages = a.n_pages;
    w.sphere_page = a.sphere_page;
    w.buckets = a.buckets;
    w.k_bucket = a.k_bucket;
    w.sse = a.sse;
    constexpr int B1 = Block<true, false, false>::threads;
    constexpr int BS = Block<true, true, false>::threads;
    std::vector<float> rec(REC * MAX_WAVES * std::max(B1, BS));
    for (int i = 0; i < a.n; ++i) {
        if (a.samples > 1)
            trace_ray<true, true, false, VAR_NONE, false>(w, a, i,
                                                          rec.data());
        else
            trace_ray<true, false, false, VAR_NONE, false>(w, a, i,
                                                           rec.data());
    }
    return 0;
}
