// Entry point of the tracer's measurement instances (tracer_body.cuh,
// V != VAR_NONE): fast mode, one sample, the per-wave structure, one page
// or a paged world, one instance a variant of RenderConfig - profile,
// nowater and the eight probes.  They build in their own translation unit,
// in parallel with tracer.cu, so the rendering instances' build does not
// wait for ten more instances of the march.

#include "tracer_body.cuh"

namespace {

template <int V>
int launch_variant(const Params& a, void* stream) {
    return launch_instance<false, false, false, V>(a, stream);
}

}  // namespace

// Trace n rays in fast mode with measurement instance `variant` (VAR_*:
// 1 nowater, 2 profile, 3 fire1, 4 fetch2x, 5 pad64, 6 pad64d, 7 sel64,
// 8 bool128, 9 int128, 10 cmp64).  Inputs and outputs as pwnfps_trace
// with one sample and no fused loop; the profile instance also writes
// out_tstep i32 [reflect + 1, n], each wave's terminal step count a ray
// (0 for a wave its chain did not reach); the others ignore it.  width
// as pwnfps_trace's.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int pwnfps_trace_variant(
        const void* ox, const void* oy, const void* oz, const void* dx,
        const void* dy, const void* dz, const void* seeds, const void* ent,
        const void* word, const void* sph, const void* bound, int n,
        int n_spheres, int maxsteps, int reflect, int skip, int n_pages,
        int sphere_page, int page0, int variant, float sec, float slack,
        float inv_mod, void* out_fb, void* out_dist, void* out_tstep,
        int width, void* stream) {
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
    a.samples = 1;
    a.sec = sec;
    a.slack = slack;
    a.inv_mod = inv_mod;
    a.inv = 1.0f;
    a.out_fb = (int32_t*)out_fb;
    a.out_dist = (float*)out_dist;
    a.out_tstep = (int32_t*)out_tstep;
    set_tiles(a, width);
    if (bad_params(a, false) || (variant == VAR_PROFILE && !out_tstep))
        return (int)cudaErrorInvalidValue;
    if (n <= 0) return (int)cudaGetLastError();
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
        default: return (int)cudaErrorInvalidValue;
    }
}
