// Entry point of the measurement instances that read their knobs at run
// time (tracer_body.cuh, V = VAR_FLAGS): one a structure - fast mode with
// one sample, with samples > 1 and the fused wave loop, parity mode with
// one sample and with samples > 1 - each on one page or a paged world.
// They run every combination of RenderConfig's measurement knobs that no
// one-knob instance (tracer_variants.cu, tracer_parity_variants.cu) runs:
// several knobs at once, a knob with samples > 1 or with the fused loop.
// A knob costs a uniform branch here, and the instance holds every pad's
// code, so the one-knob instances are the ones that price a pad.

#include "tracer_body.cuh"

// Trace n rays with the knobs of Args.flags: a probe's VAR_* (3 fire1 ..
// 10 cmp64, 0 none) in the low 4 bits, and FLAG_NOWATER for the flat
// water normal.  Args.variant must be VAR_FLAGS; other arguments as
// pwnfps_trace's (parity, samples, fused select the structure).  Where
// out_tstep is set, the one-sample unfused instances write each wave's
// terminal step count a ray there, i32 [reflect + 1, n] (the profile
// knob).  Launches on `stream`; returns cudaGetLastError().
extern "C" int pwnfps_trace_flags(const void* args, void* stream) {
    const Args& g = *(const Args*)args;
    const Params a = params_of(g);
    const bool parity = g.parity != 0;
    const int probe = a.flags & 15;
    if (bad_params(a, parity) || g.variant != VAR_FLAGS
        || (probe != VAR_NONE && (probe < VAR_FIRE1 || probe > VAR_CMP64))
        || (a.flags & ~(15 | FLAG_NOWATER)) != 0)
        return (int)cudaErrorInvalidValue;
    if (a.n <= 0) return (int)cudaGetLastError();
    if (parity)
        return a.samples > 1
            ? launch_instance<true, true, false, VAR_FLAGS>(a, stream)
            : launch_instance<true, false, false, VAR_FLAGS>(a, stream);
    if (a.fused)
        return launch_instance<false, false, true, VAR_FLAGS>(a, stream);
    return a.samples > 1
        ? launch_instance<false, true, false, VAR_FLAGS>(a, stream)
        : launch_instance<false, false, false, VAR_FLAGS>(a, stream);
}
