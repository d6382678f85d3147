// Entry point of the tracer's measurement instances (tracer_body.cuh,
// V != VAR_NONE), one page or a paged world: in fast mode, one sample,
// the per-wave structure, one instance a variant of RenderConfig -
// profile, nowater and the eight probes; in either mode, one sample, the
// phases instance.  They build in their own translation unit,
// in parallel with tracer.cu, so the rendering instances' build does not
// wait for ten more instances of the march.

#include "tracer_body.cuh"

namespace {

template <int V>
int launch_variant(const Params& a, void* stream) {
    return launch_instance<false, false, false, V>(a, stream);
}

}  // namespace

// Trace n rays with measurement instance Args.variant (VAR_*: 1 nowater,
// 2 profile, 3 fire1, 4 fetch2x, 5 pad64, 6 pad64d, 7 sel64, 8 bool128,
// 9 int128, 10 cmp64 in fast mode; 11 phases in the mode Args.parity
// names).  Arguments as pwnfps_trace's with one sample and no fused loop;
// the profile instance also writes out_tstep i32 [reflect + 1, n], each
// wave's terminal step count a ray (0 for a wave its chain did not
// reach), the phases instance adds its warp-cycles to out_tstep u64
// [PHASE_ROWS, N_PHASES]; the others ignore it.  Launches on `stream`;
// returns cudaGetLastError().
extern "C" int pwnfps_trace_variant(const void* args, void* stream) {
    const Args& g = *(const Args*)args;
    const Params a = params_of(g);
    const int variant = g.variant;
    const bool phases = variant == VAR_PHASES;
    const bool parity = g.parity != 0;
    if (bad_params(a, parity) || a.samples != 1 || a.fused
        || (parity && !phases)
        || ((variant == VAR_PROFILE || phases) && !a.out_tstep))
        return (int)cudaErrorInvalidValue;
    if (a.n <= 0) return (int)cudaGetLastError();
    switch (variant) {
        case VAR_NOWATER: return launch_variant<VAR_NOWATER>(a, stream);
        case VAR_PROFILE: return launch_variant<VAR_PROFILE>(a, stream);
        case VAR_FIRE1: return launch_variant<VAR_FIRE1>(a, stream);
        case VAR_FETCH2X: return launch_variant<VAR_FETCH2X>(a, stream);
        case VAR_PAD64: return launch_variant<VAR_PAD64>(a, stream);
        case VAR_PAD64D: return launch_variant<VAR_PAD64D>(a, stream);
        case VAR_SEL64: return launch_variant<VAR_SEL64>(a, stream);
        case VAR_BOOL128: return launch_variant<VAR_BOOL128>(a, stream);
        case VAR_INT128: return launch_variant<VAR_INT128>(a, stream);
        case VAR_CMP64: return launch_variant<VAR_CMP64>(a, stream);
        case VAR_PHASES:
            return parity
                ? launch_instance<true, false, false, VAR_PHASES>(a, stream)
                : launch_variant<VAR_PHASES>(a, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}
