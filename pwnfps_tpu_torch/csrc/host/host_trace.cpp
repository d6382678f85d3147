// The parity instances' trace_ray (csrc/tracer_body.cuh) on the host, one
// ray after another, for tools/host_trace.py - the rendering instances
// and the measurement instances of every knob: built by a host C++
// compiler against the cuda_runtime.h beside this file, called with the
// card's Args (ops/tracer.py _pack).  The cell tables, sphere records and
// compact SSE tables are read where the caller's pointers point (the
// read-only path, T = false), and the unwind records take a vector of
// the block's stride.
#include <vector>

#include "tracer_body.cuh"

dim3 threadIdx, blockIdx, blockDim, gridDim;
uint32_t smem[1];

namespace {

// every ray through the parity instance <S, V> the Args select
template <int V>
void trace_all(const World& w, const Params& a, float* rec) {
    for (int i = 0; i < a.n; ++i) {
        if constexpr (V == VAR_NONE || V == VAR_FLAGS) {
            if (a.samples > 1) {
                trace_ray<true, true, false, V, false>(w, a, i, rec);
                continue;
            }
        }
        trace_ray<true, false, false, V, false>(w, a, i, rec);
    }
}

}  // namespace

// Trace a.n rays in parity mode through the instance that Args.variant
// names: the rendering instance (VAR_NONE), a one-knob measurement
// instance (VAR_NOWATER .. VAR_CMP64, one sample) or VAR_FLAGS with
// Args.flags; out_tstep and out_col as on the card.  0, or 1 when the
// Args are refused
extern "C" int pwnfps_host_trace(const void* args) {
    const Args& g = *(const Args*)args;
    const Params a = params_of(g);
    if (bad_params(a, true) || !g.parity || a.fused) return 1;
    if (g.variant != VAR_NONE && g.variant != VAR_FLAGS && a.samples != 1)
        return 1;
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
    w.flags = a.flags;
    constexpr int B1 = Block<true, false, false>::threads;
    constexpr int BS = Block<true, true, false>::threads;
    std::vector<float> rec(REC * MAX_WAVES * std::max(B1, BS));
    switch (g.variant) {
        case VAR_NONE: trace_all<VAR_NONE>(w, a, rec.data()); break;
        case VAR_NOWATER: trace_all<VAR_NOWATER>(w, a, rec.data()); break;
        case VAR_PROFILE: trace_all<VAR_PROFILE>(w, a, rec.data()); break;
        case VAR_FIRE1: trace_all<VAR_FIRE1>(w, a, rec.data()); break;
        case VAR_FETCH2X: trace_all<VAR_FETCH2X>(w, a, rec.data()); break;
        case VAR_PAD64: trace_all<VAR_PAD64>(w, a, rec.data()); break;
        case VAR_PAD64D: trace_all<VAR_PAD64D>(w, a, rec.data()); break;
        case VAR_SEL64: trace_all<VAR_SEL64>(w, a, rec.data()); break;
        case VAR_BOOL128: trace_all<VAR_BOOL128>(w, a, rec.data()); break;
        case VAR_INT128: trace_all<VAR_INT128>(w, a, rec.data()); break;
        case VAR_CMP64: trace_all<VAR_CMP64>(w, a, rec.data()); break;
        case VAR_FLAGS: trace_all<VAR_FLAGS>(w, a, rec.data()); break;
        default: return 1;
    }
    return 0;
}
