// Entry points of the tracer's rendering instances: fast mode
// (pwnfps_trace: one sample, samples > 1, the fused wave loop) and parity
// mode (pwnfps_trace_parity: one sample, samples > 1), each on one page or
// a paged world.  The kernel, and what bounds it, is in tracer_body.cuh;
// the measurement instances build apart, in tracer_variants.cu.

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

// Trace n rays in fast mode.  Inputs: origins (ox, oy, oz) and directions
// (dx, dy, dz) f32 [n], seeds i32 [n] (uint32 bits); the world tables of
// ops/world.py:world_to_torch (ent and word [n_pages * 4096]); every ray
// starts on page page0; samples bounce chains a ray, inv = f32(1 /
// samples); fused = 1 runs the fused wave loop (samples must be 1), its
// cap checked every step_chunk iterations.  Output: out_fb i32 [n] packed
// BGRA of the chains' mean and out_dist f32 [n] primary-wave distance.
// width: the rays are a row-major image this wide (each warp traces an
// 8x4-pixel tile of it), or 0 (each warp 32 consecutive rays); queue: i32
// [2] of zeros that only launches on `stream` use, from which the
// persistent instances (samples, fused) take tiles and which they leave
// zero.  Launches on `stream`; returns cudaGetLastError().
extern "C" int pwnfps_trace(const void* ox, const void* oy, const void* oz,
                            const void* dx, const void* dy, const void* dz,
                            const void* seeds, const void* ent,
                            const void* word, const void* sph,
                            const void* bound, int n, int n_spheres,
                            int maxsteps, int reflect, int skip,
                            int n_pages, int sphere_page, int page0,
                            int samples, int fused, int step_chunk,
                            float sec, float slack, float inv_mod,
                            float inv, void* out_fb, void* out_dist,
                            int width, void* queue, void* stream) {
    Params a = {};
    a.ox = (const float*)ox;
    a.oy = (const float*)oy;
    a.oz = (const float*)oz;
    a.dx = (const float*)dx;
    a.dy = (const float*)dy;
    a.dz = (const float*)dz;
    a.seeds = (const int32_t*)seeds;
    a.ent = (const int32_t*)ent;
    a.word = (const int32_t*)word;
    a.sph = (const float*)sph;
    a.bound = (const float*)bound;
    a.n = n;
    a.n_spheres = n_spheres;
    a.maxsteps = maxsteps;
    a.reflect = reflect;
    a.skip = skip;
    a.n_pages = n_pages;
    a.sphere_page = sphere_page;
    a.page0 = page0;
    a.samples = samples;
    a.fused = fused;
    a.step_chunk = step_chunk;
    a.sec = sec;
    a.slack = slack;
    a.inv_mod = inv_mod;
    a.inv = inv;
    a.out_fb = (int32_t*)out_fb;
    a.out_dist = (float*)out_dist;
    a.queue = (int*)queue;
    set_tiles(a, width);
    return launch<false>(a, stream);
}

// Trace n rays in parity mode (persistent warps on the queue).  As
// pwnfps_trace, less the bound, the skip and the fused loop, plus the
// bucket table [n_pages * 4096 * k_bucket] i32 and the SSE rsqrt [8192]
// and rcp [4096] tables (uint32 bits).
extern "C" int pwnfps_trace_parity(
        const void* ox, const void* oy, const void* oz, const void* dx,
        const void* dy, const void* dz, const void* seeds, const void* ent,
        const void* word, const void* sph, const void* buckets,
        const void* rsq_tab, const void* rcp_tab, int n, int n_spheres,
        int k_bucket, int maxsteps, int reflect, int n_pages,
        int sphere_page, int page0, int samples, float sec, float inv_mod,
        float inv, void* out_fb, void* out_dist, int width, void* queue,
        void* stream) {
    Params a = {};
    a.ox = (const float*)ox;
    a.oy = (const float*)oy;
    a.oz = (const float*)oz;
    a.dx = (const float*)dx;
    a.dy = (const float*)dy;
    a.dz = (const float*)dz;
    a.seeds = (const int32_t*)seeds;
    a.ent = (const int32_t*)ent;
    a.word = (const int32_t*)word;
    a.sph = (const float*)sph;
    a.buckets = (const int32_t*)buckets;
    a.rsq_tab = (const uint32_t*)rsq_tab;
    a.rcp_tab = (const uint32_t*)rcp_tab;
    a.n = n;
    a.n_spheres = n_spheres;
    a.k_bucket = k_bucket;
    a.maxsteps = maxsteps;
    a.reflect = reflect;
    a.n_pages = n_pages;
    a.sphere_page = sphere_page;
    a.page0 = page0;
    a.samples = samples;
    a.inv = inv;
    a.sec = sec;
    a.inv_mod = inv_mod;
    a.out_fb = (int32_t*)out_fb;
    a.out_dist = (float*)out_dist;
    a.queue = (int*)queue;
    set_tiles(a, width);
    return launch<true>(a, stream);
}

// What pwnfps_trace (parity 0) or pwnfps_trace_parity (parity 1) would
// launch for n rays of an image `width` wide on the current device:
// out i32 [4] gets the dynamic shared memory bytes a block, the resident
// blocks an SM, the threads a block and the blocks.  Returns a CUDA error
// code.
extern "C" int pwnfps_trace_query(int parity, int n, int width,
                                  int reflect, int n_pages, int samples,
                                  int fused, void* out) {
    Params a = {};
    a.n = n;
    a.reflect = reflect;
    a.n_pages = n_pages;
    a.samples = samples;
    a.fused = fused;
    a.query = (int*)out;
    set_tiles(a, width);
    return parity ? launch<true>(a, nullptr) : launch<false>(a, nullptr);
}
