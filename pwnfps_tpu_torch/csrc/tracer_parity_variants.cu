// Entry point of parity mode's measurement instances (tracer_body.cuh,
// trace_kernel<true, false, false, V>, V != VAR_NONE), one page or a
// paged world, one sample: one instance a knob of RenderConfig - nowater,
// profile and the eight probes, each the counterpart of the fast
// instance in tracer_variants.cu.  They build in their own translation
// unit, in parallel with the others.

#include "tracer_body.cuh"

namespace {

template <int V>
int launch_parity_variant(const Params& a, void* stream) {
    return launch_instance<true, false, false, V>(a, stream);
}

}  // namespace

// Trace n rays in parity mode with measurement instance Args.variant
// (VAR_*: 1 nowater, 2 profile, 3 fire1, 4 fetch2x, 5 pad64, 6 pad64d,
// 7 sel64, 8 bool128, 9 int128, 10 cmp64).  Arguments as pwnfps_trace's
// in parity mode with one sample; the profile instance also writes
// out_tstep i32 [reflect + 1, n], each wave's terminal step count a ray
// (0 for a wave its chain did not reach).  Launches on `stream`;
// returns cudaGetLastError().
extern "C" int pwnfps_trace_parity_variant(const void* args, void* stream) {
    const Args& g = *(const Args*)args;
    const Params a = params_of(g);
    const int variant = g.variant;
    if (bad_params(a, true) || a.samples != 1 || !g.parity
        || (variant == VAR_PROFILE && !a.out_tstep))
        return (int)cudaErrorInvalidValue;
    if (a.n <= 0) return (int)cudaGetLastError();
    switch (variant) {
        case VAR_NOWATER: return launch_parity_variant<VAR_NOWATER>(a, stream);
        case VAR_PROFILE: return launch_parity_variant<VAR_PROFILE>(a, stream);
        case VAR_FIRE1: return launch_parity_variant<VAR_FIRE1>(a, stream);
        case VAR_FETCH2X: return launch_parity_variant<VAR_FETCH2X>(a, stream);
        case VAR_PAD64: return launch_parity_variant<VAR_PAD64>(a, stream);
        case VAR_PAD64D: return launch_parity_variant<VAR_PAD64D>(a, stream);
        case VAR_SEL64: return launch_parity_variant<VAR_SEL64>(a, stream);
        case VAR_BOOL128: return launch_parity_variant<VAR_BOOL128>(a, stream);
        case VAR_INT128: return launch_parity_variant<VAR_INT128>(a, stream);
        case VAR_CMP64: return launch_parity_variant<VAR_CMP64>(a, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}
