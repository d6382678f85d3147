// Entry point of the tracer's rendering instances (pwnfps_trace): fast
// mode (one sample, samples > 1, the fused wave loop) and parity mode (one
// sample, samples > 1), each on one page or a paged world.  The kernel,
// and what bounds it, is in tracer_body.cuh; the measurement instances
// build apart, in tracer_variants.cu, tracer_parity_variants.cu and
// tracer_flags.cu.

#include "tracer_body.cuh"

namespace {

template <bool P>
int launch(const Params& a, void* stream) {
    if (bad_params(a, P)) return (int)cudaErrorInvalidValue;
    if (a.n <= 0) return (int)cudaGetLastError();
    if (P)
        return a.samples > 1 ? launch_instance<true, true>(a, stream)
                             : launch_instance<true, false>(a, stream);
    if (a.fused) return launch_instance<false, false, true>(a, stream);
    return a.samples > 1 ? launch_instance<false, true>(a, stream)
                         : launch_instance<false, false>(a, stream);
}

}  // namespace

// Trace n rays, or report the launch (Args.query).  Fast mode (parity
// 0): origins (ox, oy, oz) and directions (dx, dy, dz) f32 [n], seeds i32
// [n] (uint32 bits); the world tables of ops/world.py:world_to_torch (ent
// and word [n_pages * 4096], sph, bound); every ray starts on page page0;
// samples bounce chains a ray, inv = f32(1 / samples); fused = 1 runs the
// fused wave loop (samples must be 1), its cap checked every step_chunk
// iterations.  Parity mode (parity 1) also reads the bucket table
// [n_pages * 4096 * k_bucket] i32 and the SSE tables' compact form sse
// [4096] u16 (core/approx.py compact_tables; 16-byte aligned), and
// ignores bound, skip and slack.  Output: out_fb i32 [n] packed BGRA of the chains' mean
// (or, with out_col set, out_col f32 [4, n], the mean's B, G, R and A
// planes) and out_dist f32 [n] primary-wave distance.  width: the rays are a
// row-major image this wide (each warp traces an 8x4-pixel tile of it),
// or 0 (each warp 32 consecutive rays); queue: i32 [2] of zeros that only
// launches on `stream` use, from which the persistent instances (samples
// in either mode, fused) take tiles and which they leave zero.  Launches on
// `stream`; returns cudaGetLastError().  With query set, what the launch
// would take on the current device goes to query i32 [4]: the dynamic
// shared memory bytes a block, the resident blocks an SM, the threads a
// block and the blocks.
extern "C" int pwnfps_trace(const void* args, void* stream) {
    const Args& g = *(const Args*)args;
    const Params a = params_of(g);
    return g.parity ? launch<true>(a, stream) : launch<false>(a, stream);
}
