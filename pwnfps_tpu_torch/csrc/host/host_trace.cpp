// The tracer's trace_ray (csrc/tracer_body.cuh) on the host, one ray after
// another, for tools/host_trace.py - in both modes, the rendering
// instances and the measurement instances of every knob: built by a host
// C++ compiler against the cuda_runtime.h beside this file, called with
// the card's Args (ops/tracer.py _pack).  The cell tables, sphere records
// and (parity) compact SSE tables are read where the caller's pointers
// point (the read-only path, T = false), and the unwind records take a
// vector of the block's stride.
#include <vector>

#include "tracer_body.cuh"

dim3 threadIdx, blockIdx, blockDim, gridDim;
uint32_t smem[1];

namespace {

// every ray through the instance <P, S, F, V> the Args select
template <bool P, int V>
void trace_all(const World& w, const Params& a, float* rec) {
    for (int i = 0; i < a.n; ++i) {
        if constexpr (V == VAR_NONE || V == VAR_FLAGS) {
            if (a.samples > 1) {
                trace_ray<P, true, false, V, false>(w, a, i, rec);
                continue;
            }
            if constexpr (!P) {
                if (a.fused) {
                    trace_ray<false, false, true, V, false>(w, a, i, rec);
                    continue;
                }
            }
        }
        trace_ray<P, false, false, V, false>(w, a, i, rec);
    }
}

template <bool P>
int trace_mode(const World& w, const Params& a, int variant, float* rec) {
    switch (variant) {
        case VAR_NONE: trace_all<P, VAR_NONE>(w, a, rec); break;
        case VAR_NOWATER: trace_all<P, VAR_NOWATER>(w, a, rec); break;
        case VAR_PROFILE: trace_all<P, VAR_PROFILE>(w, a, rec); break;
        case VAR_FIRE1: trace_all<P, VAR_FIRE1>(w, a, rec); break;
        case VAR_FETCH2X: trace_all<P, VAR_FETCH2X>(w, a, rec); break;
        case VAR_PAD64: trace_all<P, VAR_PAD64>(w, a, rec); break;
        case VAR_PAD64D: trace_all<P, VAR_PAD64D>(w, a, rec); break;
        case VAR_SEL64: trace_all<P, VAR_SEL64>(w, a, rec); break;
        case VAR_BOOL128: trace_all<P, VAR_BOOL128>(w, a, rec); break;
        case VAR_INT128: trace_all<P, VAR_INT128>(w, a, rec); break;
        case VAR_CMP64: trace_all<P, VAR_CMP64>(w, a, rec); break;
        case VAR_FLAGS: trace_all<P, VAR_FLAGS>(w, a, rec); break;
        default: return 1;
    }
    return 0;
}

}  // namespace

// Trace a.n rays through the instance that Args.parity, samples, fused
// and variant name: a rendering instance (VAR_NONE), a one-knob
// measurement instance (VAR_NOWATER .. VAR_CMP64, one sample, unfused) or
// VAR_FLAGS with Args.flags; out_tstep and out_col as on the card.  0, or
// 1 when the Args are refused
extern "C" int pwnfps_host_trace(const void* args) {
    const Args& g = *(const Args*)args;
    const Params a = params_of(g);
    const bool parity = g.parity != 0;
    if (bad_params(a, parity)) return 1;
    if (g.variant != VAR_NONE && g.variant != VAR_FLAGS
        && (a.samples != 1 || a.fused))
        return 1;
    World w = {};
    w.ent = a.ent;
    w.word = a.word;
    w.sph = a.sph;
    w.n_spheres = a.n_spheres;
    w.n_pages = a.n_pages;
    w.sphere_page = a.sphere_page;
    w.flags = a.flags;
    if (parity) {
        w.buckets = a.buckets;
        w.k_bucket = a.k_bucket;
        w.sse = a.sse;
    } else {
        w.bx = a.bound[0];
        w.bz = a.bound[2];
        w.brq2 = a.bound[3] * a.bound[3] + a.slack;
        w.skip = a.skip != 0;
    }
    constexpr int B = std::max({Block<true, false, false>::threads,
                                Block<true, true, false>::threads,
                                Block<false, false, false>::threads,
                                Block<false, true, false>::threads});
    std::vector<float> rec(REC * MAX_WAVES * B);
    return parity ? trace_mode<true>(w, a, g.variant, rec.data())
                  : trace_mode<false>(w, a, g.variant, rec.data());
}

// The host's rsqrtf, sqrtf, sinf, cosf and expf (fn 0-4), the functions
// this build's fast mode calls, over y[k] = f(x[k]), k < n: the plain
// tracer takes them in place of torch's to hold the host build bit for
// bit (tools/host_trace.py host_math).  0, or 1 for an unknown fn
extern "C" int pwnfps_host_math(int fn, const float* x, float* y, int n) {
    for (int k = 0; k < n; ++k) {
        switch (fn) {
            case 0: y[k] = rsqrtf(x[k]); break;
            case 1: y[k] = sqrtf(x[k]); break;
            case 2: y[k] = sinf(x[k]); break;
            case 3: y[k] = cosf(x[k]); break;
            case 4: y[k] = expf(x[k]); break;
            default: return 1;
        }
    }
    return 0;
}
