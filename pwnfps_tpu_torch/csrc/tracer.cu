// Multi-bounce wavefront tracer for Hopper (sm_90a): fast mode on one
// page or a paged world atlas, parity mode on one page.
//
// Replaces the TPU kernel pwnfps_tpu/ops/tracer_pallas.py:_kernel (behind
// trace_wave_pallas): for each ray, the whole trace_wave_env of
// pwnfps_tpu/ops/tracer_core.py - DDA march, ramps, fog, 2-high walls,
// quarter-turn portals, spheres, water-normal shading, the 5-draw reflect
// jitter, the exp-fog unwind blend and the BGRA8 pack.  It follows the
// plain torch tracer pwnfps_tpu_torch/ops/tracer_core.py expression for
// expression, in instances of one template:
//
//   * fast (entry pwnfps_trace): the empty-space skip, hoisted sphere
//     candidates, and the device functions torch's CUDA ops call (rsqrtf,
//     IEEE 1/x and sqrtf, sinf, cosf, expf), so kernel and plain tracer
//     agree bit for bit wherever those functions do.  Paged worlds (the
//     paged branch of the TPU kernel's _compact_fetch, tracer_pallas.py:
//     321-368, and fetch_portal's dpage, :570-596): each thread keeps its
//     ray's page in a register, starting on page0 (:648); a fetch reads
//     page*4096 + the clamped local index, a portal moves the ray to the
//     target page in bits 26-29 of its word, spheres exist only on
//     sphere_page, and each bounce wave starts on the page where the wave
//     before it ended.  A one-page world is page 0 throughout.  With
//     samples > 1 (distribution path tracing, trace_wave_env's samples
//     branch, tracer_core.py:1804-1817; the TPU kernel writes the mean
//     unpacked, tracer_pallas.py:657-662) a thread marches its primary
//     segment once, runs one bounce chain from it per sample with seed
//     + k*0x9E3779B9, and packs the chains' mean: a second instance of
//     the same template (S = true), so samples = 1 keeps its code;
//   * parity (entry pwnfps_trace_parity; the TPU kernel's _parity_math,
//     tracer_pallas.py:446, and _sphere_pass_pallas, :491): unit steps,
//     the reference's per-cell sphere-bucket scan, and bit-exact math -
//     the SSE rsqrt/rcp tables (core/approx.py), integer-exact division
//     and sqrt (core/ieee.py) and the pinned libm (core/detmath.py), all
//     in integer ops and single IEEE adds and multiplies, so its bits
//     depend on no device math library: it equals the plain parity
//     tracer, which the CPU tests hold bit for bit to the scalar spec
//     ops/tracer_ref.ScalarTracer(pinned=True).  With samples > 1 the
//     parity march runs once and each sample's parity chain runs from
//     it, as in fast mode: a fourth instance (P = S = true), whose SSE
//     tables stay in shared memory across the chains.
//
// What bounds it on the H100: divergence and latency, not bandwidth.  A
// ray's work is a data-dependent loop (a few steps for a wall hit, up to
// the 1000-step budget for sky rays, per bounce), every step a dependent
// gather from the cell table (16 KB a page; the 4-page maze's two tables
// are 128 KB, which L1 and L2 hold), and ~40 scalars of march state plus
// the unwind records live in registers.  So a warp runs as long as its
// longest ray, and occupancy is set by the register count.  With samples
// it lasts as long as its longest ray's S chains of up to reflect waves
// each; the kept primary segment (the ~17 fields shade reads) adds
// registers, where re-marching it per sample would add a primary march
// per sample instead.
//
// Parity mode adds integer work: a 27-step restoring division and two
// 25-step square roots per bucket slot a lane's ray hits, and table
// gathers for every rsqrt and rcp.  The two tables (48 KB) sit in shared
// memory, loaded once per block: their index is data dependent, so
// __constant__ memory would serialise a warp's lookups.
//
// Design, kept simple: one thread per ray over the flat [n] ray list
// (row-major pixels on the main path), 128 threads a block.  The TPU
// kernel's tile-uniform branches (lax.cond on any-lane flags, the
// whole-tile sphere-hoist gate, the while loop's any-active test) become
// per-thread branches: every such branch body is per-lane masked and a
// dead lane is frozen, so a thread that takes a branch when its own event
// bit is set computes the same bits.  The sphere records sit in shared
// memory; the cell tables are read through the read-only cache.  Each
// thread marches its own bounce chain to the end and unwinds it backward
// (tracer_core.py:1795-1801).  Warp-coherent scheduling, ray compaction
// and shared-memory cell tables are later work.
//
// Numerics: build with --fmad=false, -prec-div=true, -prec-sqrt=true and
// -ftz=false (_build.py) so a*b+c rounds twice, as on the TPU and in
// eager torch, and / and sqrtf are IEEE; float literals carry the f
// suffix so nothing is promoted to double, and the pinned libm's
// constants are given by their bits; float-to-int conversions saturate
// (__float2int_rz); maxima propagate NaN like jnp.maximum.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// face directions (core/config.py)
constexpr int FXP = 0, FZP = 1, FXN = 2, FZN = 3, FYP = 4, FYN = 5;
// refined cell classes (ops/worlddev.py)
constexpr int WALL = 0, FLOOR = 1, FOG = 2, LOWER = 3, TALL = 4,
              TALLFOG = 5, RAMP_GT = 6, RAMP_LT = 7, RAMP_CM = 8,
              RAMP_CR = 9, PORTAL = 10;
constexpr int FLOORISH = (1 << FLOOR) | (1 << FOG) | (1 << LOWER);
constexpr int TALLS = (1 << TALL) | (1 << TALLFOG);
constexpr int RAMPS = (1 << (RAMP_CR + 1)) - (1 << RAMP_GT);
constexpr int FOGC = (1 << FOG) | (1 << TALLFOG);
// terminal kinds, wall colour ids
constexpr int T_WALL = 1, T_SPHERE = 2, T_SKY = 3;
constexpr int C_CEIL = 0, C_FLOOR = 1, C_WALL = 2, C_MAGENTA = 3;

constexpr float EPS = 1e-13f;            // core/config.py EPSILON
constexpr float FIRE_NONE = 3.0e38f;
constexpr float PI_F = 3.14159265358979323846f;
constexpr int NSPH_MAX = 16;
constexpr int SPH_COLS = 16;
// sphere-record columns (ops/world.py)
constexpr int SX = 0, SY = 1, SZ = 2, SR = 3, SREFL = 4, SCB = 5,
              SBX1 = 8, SBX2 = 9, SBZ1 = 10, SBZ2 = 11, SRAD2 = 12,
              SINVR2 = 13;
constexpr int MAX_WAVES = 8;
constexpr int BLOCK = 128;
// SSE emulation tables (core/approx.py): rsqrt [2 * 4096], rcp [4096]
constexpr int RSQ_N = 8192, RCP_N = 4096, APPROX_BLOCK = 11;

// palette (b, g, r) per colour id (core/config.py COL_*)
__constant__ float PAL[4][3] = {{30.0f, 30.0f, 0.0f},
                                {1.0f, 1.0f, 1.0f},
                                {0.8f, 0.8f, 1.0f},
                                {5.0f, 0.0f, 5.0f}};

struct World {
    const int32_t* ent;      // [n_pages * 4096] compact cell entries
    const int32_t* word;     // [n_pages * 4096] full channel words
    const float* sph;        // [n, 16] sphere records (shared memory)
    float bx, bz, brq2;      // bound circle centre and radius^2 + slack
    int n_spheres;
    int n_pages;             // 1: one 64x64 grid
    int sphere_page;         // the page every sphere lives on
    bool skip;
    // parity mode only
    const int32_t* buckets;  // [4096 * k_bucket] sphere ids, -1 pad
    int k_bucket;
    const uint32_t* rsq_tab; // shared memory
    const uint32_t* rcp_tab; // shared memory
};

struct Seg {
    float px, py, pz, rx, ry, rz, ix, iy, iz, wx, wy, wz;
    int ent, gx, gy, gz, cx, cz, page;
    float cdist, fog;
    int ldir;
    bool active;
    float aux_dist, aux_t0;
    int sph_dirty;
    float apx, apy, apz;
    int aux_idx;
    float aux_diff;
    int tmeta;
};

__device__ __forceinline__ float fmax_nan(float a, float b) {
    return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ bool bit(int bits, int c) {
    return ((bits >> c) & 1) != 0;
}

// an out-of-bounds cell reads cell 0 of the ray's page
__device__ __forceinline__ int flat_index(int cx, int cz, int page) {
    const bool inb = cx >= 0 && cx < 64 && cz >= 0 && cz < 64;
    return (inb ? cz * 64 + cx : 0) + page * 4096;
}

__device__ __forceinline__ int fetch(const World& w, int cx, int cz,
                                     int page) {
    return __ldg(w.ent + flat_index(cx, cz, page));
}

// ---- parity math: bit-exact emulations (core/approx.py, core/ieee.py,
// core/detmath.py), integer ops and single IEEE adds and multiplies ----

// _mm_rsqrt_ps: table by exponent parity and the top 12 mantissa bits,
// times 2^-k; the scale's bits wrap in 32 bits as in uint32
__device__ __forceinline__ float rsq_emu(const World& w, float x) {
    const uint32_t bits = __float_as_uint(x);
    const int d = (int)(bits >> 23) - 127;
    const int k = d >> 1;                 // arithmetic: floor(d / 2)
    const int p = d - 2 * k;
    const float y = __uint_as_float(
        w.rsq_tab[p * 4096 + (int)((bits & 0x7FFFFFu) >> APPROX_BLOCK)]);
    return y * __uint_as_float((uint32_t)(127 - k) << 23);
}

// _mm_rcp_ps: table by the top 12 mantissa bits, times 2^-k
__device__ __forceinline__ float rcp_emu(const World& w, float x) {
    const uint32_t bits = __float_as_uint(x);
    const int k = (int)(bits >> 23) - 127;
    const float y = __uint_as_float(
        w.rcp_tab[(bits & 0x7FFFFFu) >> APPROX_BLOCK]);
    return y * __uint_as_float((uint32_t)(127 - k) << 23);
}

// round to nearest even on guard bit g and the sticky flag; returns the
// f32 bits, or ok = false when the exponent leaves the normal range
__device__ __forceinline__ uint32_t round_pack(int e, int m24, int g,
                                               bool sticky) {
    if (g == 1 && (sticky || (m24 & 1) == 1)) m24 += 1;
    if (m24 >= (1 << 24)) {
        m24 >>= 1;
        e += 1;
    }
    return (e > 0 && e < 255)
        ? ((uint32_t)e << 23) | (uint32_t)(m24 & 0x7FFFFF) : 0xFFFFFFFFu;
}

// correctly rounded a / b for positive normal f32 (ieee.div_rn): 27-step
// restoring division of the mantissas; other lanes take IEEE a / b
__device__ float div_rn(float a, float b) {
    const int ab = __float_as_int(a), bb = __float_as_int(b);
    const int ea = (ab >> 23) & 0xFF, eb = (bb >> 23) & 0xFF;
    const int ma = (ab & 0x7FFFFF) | 0x800000;
    const int mb = (bb & 0x7FFFFF) | 0x800000;
    int q = ma >= mb ? 1 : 0;
    int r = q ? ma - mb : ma;
#pragma unroll
    for (int i = 0; i < 27; ++i) {
        r <<= 1;
        const int ge = r >= mb ? 1 : 0;
        if (ge) r -= mb;
        q = (q << 1) | ge;
    }
    const bool big = q >= (1 << 27);
    const int e = ea - eb + (big ? 127 : 126);
    const int m24 = big ? q >> 4 : q >> 3;
    const int g = big ? (q >> 3) & 1 : (q >> 2) & 1;
    const int low = big ? q & 7 : q & 3;
    const uint32_t out = round_pack(e, m24, g, low != 0 || r != 0);
    const bool ok = ea > 0 && ea < 255 && eb > 0 && eb < 255 && ab >= 0
        && bb >= 0 && out != 0xFFFFFFFFu;
    return ok ? __uint_as_float(out) : a / b;
}

// correctly rounded sqrt for positive normal f32 (ieee.sqrt_rn):
// digit-by-digit root of the mantissa; other lanes take IEEE sqrtf
__device__ float sqrt_rn(float x) {
    const int xb = __float_as_int(x);
    const int e = (xb >> 23) & 0xFF;
    const int m = (xb & 0x7FFFFF) | 0x800000;
    const int d = e - 127;
    const int odd = d & 1;
    const int mm = odd ? m << 1 : m;      // < 2^25
    const int k = (d - odd) >> 1;         // floor((e - 127) / 2)
    int root = 0, rem = 0;
#pragma unroll
    for (int p = 0; p < 25; ++p) {
        const int sft = 23 - 2 * p;
        const int pair = sft >= 0 ? (mm >> sft) & 3
            : (sft == -1 ? (mm & 1) << 1 : 0);
        rem = (rem << 2) | pair;
        const int trial = (root << 2) | 1;
        const int ge = rem >= trial ? 1 : 0;
        if (ge) rem -= trial;
        root = (root << 1) | ge;
    }
    const uint32_t out = round_pack(127 + k, root >> 1, root & 1, rem != 0);
    const bool ok = e > 0 && e < 255 && xb >= 0 && out != 0xFFFFFFFFu;
    return ok ? __uint_as_float(out) : sqrtf(x);
}

// the pinned libm (detmath.py): Cody-Waite reduction by pi/2 split in
// three, fdlibm float kernels; constants by their f32 bits
__device__ __forceinline__ float cf(uint32_t bits) {
    return __uint_as_float(bits);
}

__device__ __forceinline__ void reduce_pio2(float x, float& r, int& n) {
    const float j = floorf((x * cf(0x3f22f983u)) + 0.5f);  // 2/pi
    r = x - (j * cf(0x3fc90000u));
    r = r - (j * cf(0x39fda000u));
    r = r - (j * cf(0x33a22169u));
    n = __float2int_rz(j) & 3;
}

__device__ __forceinline__ float kernel_sin(float r, float r2) {
    float p = cf(0xb9500d01u) + (r2 * cf(0x3638ef1bu));
    p = cf(0x3c088889u) + (r2 * p);
    p = cf(0xbe2aaaabu) + (r2 * p);
    return r + ((r * r2) * p);
}

__device__ __forceinline__ float kernel_cos(float r, float r2) {
    float p = cf(0x37d00d01u) + (r2 * cf(0xb493f27cu));
    p = cf(0xbab60b61u) + (r2 * p);
    p = cf(0x3d2aaaabu) + (r2 * p);
    return (1.0f - (r2 * 0.5f)) + ((r2 * r2) * p);
}

__device__ float sin_det(float x) {
    float r;
    int n;
    reduce_pio2(x, r, n);
    const float r2 = r * r;
    const float ks = kernel_sin(r, r2), kc = kernel_cos(r, r2);
    return n == 0 ? ks : n == 1 ? kc : n == 2 ? -ks : -kc;
}

__device__ float cos_det(float x) {
    float r;
    int n;
    reduce_pio2(x, r, n);
    const float r2 = r * r;
    const float ks = kernel_sin(r, r2), kc = kernel_cos(r, r2);
    return n == 0 ? kc : n == 1 ? -ks : n == 2 ? -kc : ks;
}

__device__ float exp_det(float x) {
    const float k = floorf((x * cf(0x3fb8aa3bu)) + 0.5f);   // 1/ln2
    float r = x - (k * cf(0x3f317000u));
    r = r - (k * cf(0x3805f000u));
    r = r - (k * cf(0x325f473eu));
    float p = cf(0x3d2aaaabu) + (r * cf(0x3c088889u));
    p = cf(0x3e2aaaabu) + (r * p);
    p = 0.5f + (r * p);
    p = 1.0f + (r * p);
    p = 1.0f + (r * p);
    // int32 wraparound as in the plain version's int32 add
    const int e = min(max((int)((uint32_t)__float2int_rz(k) + 127u), 0),
                      254);
    const float out = p * __uint_as_float((uint32_t)e << 23);
    return e <= 1 ? 0.0f : out;
}

// ---- the two modes' math --------------------------------------------------

template <bool P>
__device__ __forceinline__ float m_rsq(const World& w, float x) {
    return P ? rsq_emu(w, x) : rsqrtf(x);
}

template <bool P>
__device__ __forceinline__ float m_rcp(const World& w, float x) {
    return P ? rcp_emu(w, x) : 1.0f / x;
}

template <bool P>
__device__ __forceinline__ float m_div(float a, float b) {
    return P ? div_rn(a, b) : a / b;
}

template <bool P>
__device__ __forceinline__ float m_sin(float x) {
    return P ? sin_det(x) : sinf(x);
}

template <bool P>
__device__ __forceinline__ float m_cos(float x) {
    return P ? cos_det(x) : cosf(x);
}

template <bool P>
__device__ __forceinline__ float m_exp(float x) {
    return P ? exp_det(x) : expf(x);
}

// v_normalise: s = (x^2 + z^2) + y^2, times rsqrt
template <bool P>
__device__ __forceinline__ void normalise(const World& w, float& x,
                                          float& y, float& z) {
    const float s = (x * x + z * z) + y * y;
    const float r = m_rsq<P>(w, s);
    x = x * r;
    y = y * r;
    z = z * r;
}

// XZ line vs the bound circle, on the sphere page only
// (tracer_core.make_sphere_rel)
__device__ __forceinline__ bool sphere_rel(const World& w, float px,
                                           float pz, float vx, float vz,
                                           int page) {
    const float rx = w.bx - px;
    const float rz = w.bz - pz;
    const float d2xz = rx * rx + rz * rz;
    const float dtxz = rx * vx + rz * vz;
    const float l2 = vx * vx + vz * vz;
    return (d2xz - w.brq2) * l2 < dtxz * dtxz && page == w.sphere_page;
}

// Hoisted sphere candidates of the lane's current line
// (tracer_core.make_sphere_all run_full); `run` is the lane's mask &
// active, and only a lane on the sphere page has candidates.  Returns
// the relevance bit (0 or 2).
__device__ int sphere_all(const World& w, Seg& s, bool run, bool merge) {
    if (run && s.page == w.sphere_page) {
        float fire, best_aux;
        if (merge && s.aux_dist != -1.0f) {
            fire = fmax_nan(s.aux_dist, s.aux_t0);
            best_aux = s.aux_dist;
        } else {
            fire = FIRE_NONE;
            best_aux = FIRE_NONE;
        }
        bool nw = false;
        float w_te = 0.0f, w_sd = 0.0f;
        int w_idx = 0;
        const bool sxp = s.rx >= 0.0f;
        const bool szp = s.rz >= 0.0f;
        const float ivx_s = sxp ? s.ix : -s.ix;
        const float ivz_s = szp ? s.iz : -s.iz;
        for (int si = 0; si < w.n_spheres; ++si) {
            const float* r = w.sph + si * SPH_COLS;
            const float tx = ((sxp ? r[SBX1] : r[SBX2]) - s.px) * ivx_s;
            const float tz = ((szp ? r[SBZ1] : r[SBZ2]) - s.pz) * ivz_s;
            const float t_entry = fmax_nan(fmax_nan(tx, tz), 0.0f);
            const float ex = s.px + s.rx * t_entry;
            const float ey = s.py + s.ry * t_entry;
            const float ez = s.pz + s.rz * t_entry;
            const float relx = r[SX] - ex, rely = r[SY] - ey,
                        relz = r[SZ] - ez;
            const float dist2 = (relx * relx + relz * relz) + rely * rely;
            const float dot = (relx * s.rx + relz * s.rz) + rely * s.ry;
            const float calcrad2 = dist2 - dot * dot;
            const float sph_dist = sqrtf(dist2) - sqrtf(fmax_nan(
                1.0f - calcrad2 * r[SINVR2], 0.0f));
            const float te_d = s.cdist + t_entry;
            const float aux_c = sph_dist + te_d;
            const float fire_c = fmax_nan(aux_c, te_d);
            const bool upd = dot > 0.0f && calcrad2 < r[SRAD2]
                && (fire_c < fire || (fire_c == fire && aux_c < best_aux));
            if (upd) {
                fire = fire_c;
                best_aux = aux_c;
                nw = true;
                w_te = t_entry;
                w_sd = sph_dist;
                w_idx = si;
            }
        }
        if (nw) {
            const float* r = w.sph + w_idx * SPH_COLS;
            const float fx = s.px + s.rx * w_te;
            const float fy = s.py + s.ry * w_te;
            const float fz = s.pz + s.rz * w_te;
            const float ax = fx + s.rx * w_sd;
            const float ay = fy + s.ry * w_sd;
            const float az = fz + s.rz * w_sd;
            float nx = ax - r[SX], ny = ay - r[SY], nz = az - r[SZ];
            normalise<false>(w, nx, ny, nz);
            float diff = fmax_nan(-((s.rx * nx + s.rz * nz) + s.ry * ny),
                                  0.0f);
            diff = 0.2f + 0.8f * diff;
            s.aux_dist = best_aux;
            s.apx = ax;
            s.apy = ay;
            s.apz = az;
            s.aux_idx = w_idx;
            s.aux_diff = diff;
            s.aux_t0 = s.cdist + w_te;
        }
    }
    return sphere_rel(w, s.px, s.pz, s.rx, s.rz, s.page) ? 2 : 0;
}

// Parity mode: the reference's per-cell sphere tests (trace.h:252-296,
// tracer_core.sphere_pass).  An active lane in a bucketed cell tests the
// cell's slots k = 0 .. k_bucket-1 in order (valid: k < the cell's count
// and a sphere in the slot); the last strictly closer hit wins.
__device__ void sphere_pass(const World& w, Seg& s) {
    if (s.cx < 0 || s.cx >= 64 || s.cz < 0 || s.cz >= 64) return;
    const int nsph = min((s.ent >> 15) & 0x1F, w.k_bucket);
    const int32_t* slots = w.buckets + (s.cz * 64 + s.cx) * w.k_bucket;
    bool nw = false;
    float w_sd = 0.0f;
    int w_idx = 0;
    for (int k = 0; k < nsph; ++k) {
        int si = __ldg(slots + k);
        if (si < 0) continue;
        si = min(si, w.n_spheres - 1);
        const float* r = w.sph + si * SPH_COLS;
        const float rad2 = r[SR] * r[SR];
        const float relx = r[SX] - s.px, rely = r[SY] - s.py,
                    relz = r[SZ] - s.pz;
        const float dist2 = (relx * relx + relz * relz) + rely * rely;
        const float dot = (relx * s.rx + relz * s.rz) + rely * s.ry;
        const float calcrad2 = dist2 - dot * dot;
        if (!(dot > 0.0f && calcrad2 < rad2)) continue;
        const float sph_dist = sqrt_rn(dist2) - sqrt_rn(fmax_nan(
            1.0f - div_rn(calcrad2, rad2 > 0.0f ? rad2 : 1.0f), 0.0f));
        const float cand = sph_dist + s.cdist;
        if (s.aux_dist == -1.0f || cand < s.aux_dist) {
            s.aux_dist = cand;
            nw = true;
            w_sd = sph_dist;
            w_idx = si;
        }
    }
    if (nw) {
        const float* r = w.sph + w_idx * SPH_COLS;
        const float ax = s.px + s.rx * w_sd;
        const float ay = s.py + s.ry * w_sd;
        const float az = s.pz + s.rz * w_sd;
        float nx = ax - r[SX], ny = ay - r[SY], nz = az - r[SZ];
        normalise<true>(w, nx, ny, nz);
        float diff = fmax_nan(-((s.rx * nx + s.rz * nz) + s.ry * ny),
                              0.0f);
        diff = 0.2f + 0.8f * diff;
        s.apx = ax;
        s.apy = ay;
        s.apz = az;
        s.aux_idx = w_idx;
        s.aux_diff = diff;
    }
}

// segment prologue (tracer_core._init_march + init_segment)
template <bool P>
__device__ void init_segment(const World& w, Seg& s, float fx, float fy,
                             float fz, float irx, float iry, float irz,
                             bool active, int page) {
    float rx = irx, ry = iry, rz = irz;
    normalise<P>(w, rx, ry, rz);
    auto clamp = [](float c) {
        return (c > -EPS && c < EPS) ? (c < 0.0f ? -EPS : EPS) : c;
    };
    rx = clamp(rx);
    ry = clamp(ry);
    rz = clamp(rz);
    s.cx = __float2int_rz(fx);
    s.cz = __float2int_rz(fz);
    s.gx = irx < 0.0f ? -1 : 1;
    s.gy = iry < 0.0f ? -1 : 1;
    s.gz = irz < 0.0f ? -1 : 1;
    s.ix = m_rcp<P>(w, fabsf(rx));
    s.iy = m_rcp<P>(w, fabsf(ry));
    s.iz = m_rcp<P>(w, fabsf(rz));
    const float wdx = fx - (float)s.cx;
    const float wdz = fz - (float)s.cz;
    s.wx = (rx >= 0.0f ? 1.0f - wdx : wdx) * s.ix;
    s.wy = (ry >= 0.0f ? 1.0f - fy : fy) * s.iy;
    s.wz = (rz >= 0.0f ? 1.0f - wdz : wdz) * s.iz;
    s.page = page;
    s.ent = fetch(w, s.cx, s.cz, page);
    s.px = fx;
    s.py = fy;
    s.pz = fz;
    s.rx = rx;
    s.ry = ry;
    s.rz = rz;
    s.cdist = 0.0f;
    s.fog = 0.0f;
    s.ldir = FYN;
    s.active = active;
    s.aux_dist = -1.0f;
    s.aux_t0 = -1.0f;
    s.sph_dirty = 0;
    s.apx = s.apy = s.apz = 0.0f;
    s.aux_idx = 0;
    s.aux_diff = 0.0f;
    s.tmeta = 0;
}

// One DDA step of an active lane (tracer_core.segment_body).  Fast mode
// refreshes its hoisted candidates after line changes (has_sph: hoisted
// candidates exist); parity mode scans the cell's sphere buckets.
template <bool P>
__device__ void segment_body(const World& w, Seg& s) {
    const bool has_sph = !P && w.n_spheres > 0;
    const int cls = s.ent & 0xF;

    // ---- rare events: sphere refresh or scan, portal targets, ramp ----
    if (P) {
        if (w.k_bucket > 0) sphere_pass(w, s);
    } else if (has_sph && (s.sph_dirty & 1)) {
        s.sph_dirty = sphere_all(w, s, true, true);
    }
    const bool is_portal = cls == PORTAL;
    const bool is_ramp = bit(RAMPS, cls);
    int pkind = 0, ldir_p = 0, gx_r = 0, gz_r = 0, cx_f = 0, cz_f = 0;
    int dpage = s.page;
    float px_f = 0.0f, pz_f = 0.0f, vx_r = 0.0f, vz_r = 0.0f,
          wx_r = 0.0f, wz_r = 0.0f, ix_r = 0.0f, iz_r = 0.0f;
    bool nr = false;
    if (is_portal) {
        const int pw = __ldg(w.word + flat_index(s.cx, s.cz, s.page));
        // a one-page world's bits 26-29 count spheres, not a page
        if (w.n_pages > 1) dpage = (pw >> 26) & 0xF;
        pkind = (pw >> 4) & 3;
        const int prot = (pw >> 6) & 3;
        const int pdcx = ((pw >> 12) & 0x7F) - 64;
        const int pdcz = ((pw >> 19) & 0x7F) - 64;
        const int cxp = s.cx + pdcx;
        const int czp = s.cz + pdcz;
        const float px_t = s.px + (float)pdcx;
        const float pz_t = s.pz + (float)pdcz;
        ldir_p = (s.ldir - prot) & 3;
        const float cxh = (float)cxp + 0.5f;
        const float czh = (float)czp + 0.5f;
        const bool r1 = prot == 1, r2 = prot == 2, r3 = prot == 3;
        const float px_r = r1 ? cxh + (pz_t - czh)
            : r2 ? cxh * 2.0f - px_t : r3 ? cxh - (pz_t - czh) : px_t;
        const float pz_r = r1 ? czh - (px_t - cxh)
            : r2 ? czh * 2.0f - pz_t : r3 ? czh + (px_t - cxh) : pz_t;
        vx_r = r1 ? s.rz : r2 ? -s.rx : r3 ? -s.rz : s.rx;
        vz_r = r1 ? -s.rx : r2 ? -s.rz : r3 ? s.rx : s.rz;
        gx_r = r1 ? s.gz : r2 ? -s.gx : r3 ? -s.gz : s.gx;
        gz_r = r1 ? -s.gx : r2 ? -s.gz : r3 ? s.gx : s.gz;
        const bool swap = r1 || r3;
        wx_r = swap ? s.wz : s.wx;
        wz_r = swap ? s.wx : s.wz;
        ix_r = swap ? s.iz : s.ix;
        iz_r = swap ? s.ix : s.iz;
        const int step_dx = ldir_p == FZP ? 0 : ldir_p == FXN ? -1
            : ldir_p == FZN ? 0 : 1;
        const int step_dz = ldir_p == FZP ? 1 : ldir_p == FZN ? -1 : 0;
        cx_f = cxp + step_dx;
        cz_f = czp + step_dz;
        px_f = px_r + (float)step_dx;
        pz_f = pz_r + (float)step_dz;
        if (has_sph) nr = sphere_rel(w, px_f, pz_f, vx_r, vz_r, dpage);
    }
    // tilt is exactly 0 on non-ramp lanes (tracer_core.py:922-925)
    float tilt = 0.0f, wy_ramp = 0.0f;
    if (is_ramp) {
        const float coef_x = cls == RAMP_GT ? -0.5f
            : cls == RAMP_LT ? 0.5f : 0.0f;
        const float coef_z = cls == RAMP_CM ? -0.5f
            : cls == RAMP_CR ? 0.5f : 0.0f;
        const bool rampx = cls == RAMP_GT || cls == RAMP_LT;
        tilt = rampx ? coef_x * s.rx : coef_z * s.rz;
        const float ry2 = s.ry + tilt;
        const float ay2 = ry2 < 0.0f ? -ry2 : ry2;
        wy_ramp = (ry2 >= 0.0f ? 1.0f - s.py : s.py) * m_div<P>(1.0f, ay2);
    }

    const bool is_floorish = bit(FLOORISH, cls);
    const bool is_tall = bit(TALLS, cls);
    const bool is_wall = cls == WALL;
    const bool is_fogc = bit(FOGC, cls);
    const bool has_aux = s.aux_dist != -1.0f;
    const float fire = has_sph ? fmax_nan(s.aux_dist, s.aux_t0)
                               : s.aux_dist;
    const float ray_y2 = s.ry + tilt;

    // ---- empty-space skip ----
    const float wx = s.wx, wy0 = s.wy, wz = s.wz;
    float wxe = wx, wze = wz;
    int kx = 0, kz = 0;
    if (!P && w.skip) {
        const int runx = (s.ent >> 7) & 0xF;
        const int runz = (s.ent >> 11) & 0xF;
        const int jx = __float2int_rz(floorf((wz - wx) * fabsf(s.rx)));
        const int jz = __float2int_rz(floorf((wx - wz) * fabsf(s.rz)));
        kx = min(max(min(runx, jx), 0), 15);
        kz = min(max(min(runz, jz), 0), 15);
        wxe = wx + (float)kx * s.ix;
        wze = wz + (float)kz * s.iz;
    }
    const float wy_tall = s.gy > 0 ? wy0 + s.iy : wy0;
    const float wy = is_tall ? wy_tall : (is_ramp ? wy_ramp : wy0);

    // ---- ramps: sphere exit before stepping ----
    bool a = true;
    const bool sgt = s.cdist > fire;
    const bool m_presph = is_ramp && has_aux && sgt;
    a = a && !m_presph;

    // ---- min-axis crossing ----
    const bool ymin = wy < wxe && wy < wze;
    const bool xmin = !ymin && wxe < wze;
    const bool zmin = !(ymin || xmin);
    const float t = ymin ? wy : (xmin ? wxe : wze);
    const int gsel = is_ramp ? s.gy : s.gx;
    const int ldir2 = ymin ? (s.gy < 0 ? FYN : FYP)
        : xmin ? (gsel < 0 ? FXN : FXP) : (s.gz < 0 ? FZN : FZP);
    const bool marchable = is_floorish || is_tall || is_ramp;
    const float cdist2 = s.cdist + t;
    const float p2x = s.px + s.rx * t;
    const float p2y = s.py + ray_y2 * t;
    const float p2z = s.pz + s.rz * t;

    // ---- floor/tall: fog + sphere exit + Y hit ----
    bool ft = a && (is_floorish || is_tall);
    const bool m_sph2 = ft && has_aux && cdist2 > fire;
    const float extra = (is_fogc && s.aux_dist > s.cdist)
        ? s.aux_dist - s.cdist : 0.0f;
    a = a && !m_sph2;
    ft = a && (is_floorish || is_tall);
    const float fog2 = (ft && is_fogc) ? s.fog + (cdist2 - s.cdist)
                                       : s.fog;
    const bool isY2 = ldir2 == FYN || ldir2 == FYP;
    const bool m_yhit = ft && isY2;
    a = a && !m_yhit;

    // ---- ramp Y hit ----
    const bool ramp_go = a && is_ramp;
    const bool m_ryhit = ramp_go && isY2;
    a = a && !m_ryhit;

    // ---- X/Z continuation ----
    const bool cont = a && marchable;
    const bool xstep = cont && xmin;
    const bool zstep = cont && zmin;
    const bool stepped = xstep || zstep;
    const float sub = xstep ? wxe : wze;
    const float wnx = xstep ? s.ix : wx - sub;
    float wny = wy - sub;
    const float wnz = zstep ? s.iz : wz - sub;
    if (stepped && is_tall && s.gy > 0) wny = wny - s.iy;
    const int cx2 = s.cx + (xstep ? s.gx * (1 + kx) : 0);
    const int cz2 = s.cz + (zstep ? s.gz * (1 + kz) : 0);
    const int ldir3 = (ramp_go && xstep) ? (s.rx < 0.0f ? FXN : FXP)
        : (ramp_go && zstep) ? (s.rz < 0.0f ? FZN : FZP) : ldir2;
    const bool rgs = ramp_go && stepped;
    const float ray_y3 = rgs ? ray_y2 - tilt : ray_y2;
    if (rgs) wny = (ray_y3 >= 0.0f ? 1.0f - p2y : p2y) * s.iy;

    // ---- portal traversal + the one per-step fetch ----
    const bool pgo = a && is_portal && pkind == 1;
    int f_next = s.ent;
    if (stepped || pgo) {
        f_next = pgo ? fetch(w, cx_f, cz_f, dpage)
                     : fetch(w, cx2, cz2, s.page);
    }

    // ---- transitions ----
    const int ncls = f_next & 0xF;
    float pos3y = p2y;
    const bool tr1 = stepped && cls == LOWER && bit(TALLS, ncls);
    if (tr1) {
        pos3y = pos3y + 1.0f;
        wny = s.gy < 0 ? wny + s.iy : wny - s.iy;
    }
    const bool tr2 = stepped && is_tall && ncls == LOWER;
    if (tr2) {
        pos3y = pos3y - 1.0f;
        wny = s.gy > 0 ? wny + s.iy : wny - s.iy;
    }

    // ---- 2-high wall check ----
    const int xc = (f_next >> 4) & 3;
    const bool chk = stepped && is_tall && (pos3y < 0.0f || pos3y > 1.0f);
    if (chk && xc == 2) {
        pos3y = pos3y + 1.0f;
        wny = s.gy > 0 ? wny - s.iy : wny + s.iy;
    }
    const bool m_wall2 = chk && xc != 1;
    a = a && !m_wall2;

    // ---- portal cells + plain wall ----
    const bool p_bad = a && is_portal && pkind == 2;
    const bool p_wrong = a && is_portal && pkind == 3;
    const bool wall0 = a && is_wall;
    const bool sphfire = has_aux && sgt;
    a = a && !(p_bad || p_wrong || wall0);
    const bool m_pww = p_wrong && !sphfire;
    const bool m_wallm = wall0 && !sphfire;

    // ---- merged terminal + survivor writes ----
    const bool sphm = m_presph || m_sph2 || ((p_bad || p_wrong || wall0)
                                             && sphfire);
    const bool term = sphm || m_yhit || m_ryhit || m_wall2
        || ((p_bad || p_wrong || wall0) && !sphfire);
    const bool near = m_yhit || m_ryhit || m_wall2;
    const bool my2 = m_yhit || m_ryhit;
    const bool cont2 = a && stepped;
    const bool pgo2 = a && pgo;
    const bool cn = cont2 || near;
    const bool cw = cont2 || m_wall2;
    if (term) {
        const int colid = m_yhit ? (s.gy > 0 ? C_CEIL : C_FLOOR)
            : m_ryhit ? (ray_y2 >= 0.0f ? C_CEIL : C_FLOOR)
            : m_pww ? C_MAGENTA
            : (m_wallm && s.ldir == FYP) ? C_CEIL : C_WALL;
        s.tmeta = sphm ? T_SPHERE : (T_WALL | (colid << 2));
    }
    const float npx = pgo2 ? px_f : (cn ? p2x : s.px);
    const float npy = cw ? pos3y : (my2 ? p2y : s.py);
    const float npz = pgo2 ? pz_f : (cn ? p2z : s.pz);
    const float nry = cont2 ? ray_y3
        : ((m_presph || m_ryhit) ? ray_y2 : s.ry);
    const float nrx = pgo2 ? vx_r : s.rx;
    const float nrz = pgo2 ? vz_r : s.rz;
    const float nwx = pgo2 ? wx_r : (cont2 ? wnx : wx);
    const float nwy = cont2 ? wny : wy0;
    const float nwz = pgo2 ? wz_r : (cont2 ? wnz : wz);
    const float nix = pgo2 ? ix_r : s.ix;
    const float niz = pgo2 ? iz_r : s.iz;
    const int ngx = pgo2 ? gx_r : s.gx;
    const int ngz = pgo2 ? gz_r : s.gz;
    const int ncx = cont2 ? cx2 : (pgo2 ? cx_f : s.cx);
    const int ncz = cont2 ? cz2 : (pgo2 ? cz_f : s.cz);
    const float ncd = cn ? cdist2 : (sphm ? s.aux_dist : s.cdist);
    const float nfog = (cont2 || m_yhit || m_wall2) ? fog2
        : (m_sph2 ? s.fog + extra : s.fog);
    const int nld = cont2 ? ldir3 : pgo2 ? ldir_p
        : m_ryhit ? (ray_y2 < 0.0f ? FYN : FYP)
        : (m_yhit || m_wall2) ? ldir2 : s.ldir;
    if (cont2 || pgo2) s.ent = f_next;
    if (pgo2) s.page = dpage;
    s.px = npx;
    s.py = npy;
    s.pz = npz;
    s.rx = nrx;
    s.ry = nry;
    s.rz = nrz;
    s.wx = nwx;
    s.wy = nwy;
    s.wz = nwz;
    s.ix = nix;
    s.iz = niz;
    s.gx = ngx;
    s.gz = ngz;
    s.cx = ncx;
    s.cz = ncz;
    s.cdist = ncd;
    s.fog = nfog;
    s.ldir = nld;
    s.active = !term;

    // ---- hoisted-sphere line-change bookkeeping ----
    if (has_sph) {
        const bool ev_shift = stepped && (tr1 || tr2 || ramp_go)
            && ((s.sph_dirty >> 1) & 1);
        const bool drop = (pgo2 || ev_shift) && s.aux_dist != -1.0f
            && s.cdist < s.aux_t0;
        s.sph_dirty = pgo2 ? (nr ? 3 : 0)
            : (ev_shift ? (s.sph_dirty | 1) : s.sph_dirty);
        if (drop) s.aux_dist = -1.0f;
    }

    // ---- end-of-iteration sphere check ----
    if (s.active && s.aux_dist != -1.0f && s.cdist > fire) {
        s.tmeta = T_SPHERE;
        s.cdist = s.aux_dist;
        s.active = false;
    }
}

struct Shade {
    float b, g, r, a;     // base colour
    float refl, fog;
    bool bounce;
};

__device__ __forceinline__ float randfs(uint32_t& seed, float inv_mod) {
    seed = (seed * 25739u + 4u) & 0x7FFFFFFFu;
    const float f = (float)(seed % 3759u) * inv_mod;
    return f * 2.0f - 1.0f;
}

// Terminal shading + bounce prep of a finished segment (seg_out_view +
// shade_and_bounce).  icol: the parent's base colour; on return
// (fx..rz) hold the bounce ray's origin and direction.
template <bool P>
__device__ Shade shade(const World& w, const Seg& s, const float icol[4],
                       uint32_t& seed, float sec, bool depth_ok,
                       float inv_mod, float& fx, float& fy, float& fz,
                       float& rx_o, float& ry_o, float& rz_o) {
    const int tkind = s.tmeta & 3;
    const int tcolid = (s.tmeta >> 2) & 3;
    const int ld = s.ldir;
    const float rx = s.rx, ry = s.ry, rz = s.rz;
    // sphere winner rematerialization (make_sphere_view)
    float refl_s = 0.25f, nx = 0.0f, ny = 0.0f, nz = 0.0f;
    float cb = 1.0f, cg = 1.0f, cr = 1.0f, ca = 1.0f;
    if (w.n_spheres > 0 && s.aux_dist != -1.0f) {
        const float* r = w.sph + s.aux_idx * SPH_COLS;
        nx = s.apx - r[SX];
        ny = s.apy - r[SY];
        nz = s.apz - r[SZ];
        normalise<P>(w, nx, ny, nz);
        refl_s = r[SREFL];
        cb = s.aux_diff * r[SCB];
        cg = s.aux_diff * r[SCB + 1];
        cr = s.aux_diff * r[SCB + 2];
        ca = 0.0f;
    }
    const float apx = w.n_spheres > 0 ? s.apx : 0.0f;
    const float apy = w.n_spheres > 0 ? s.apy : 0.0f;
    const float apz = w.n_spheres > 0 ? s.apz : 0.0f;

    float d = ld == FYP ? ry : ld == FZP ? rz : ld == FXN ? -rx
        : ld == FYN ? -ry : ld == FZN ? -rz : rx;
    d = fmax_nan(d, 0.0f);
    d = 0.9f * d + 0.1f;
    const bool is_wall = tkind == T_WALL;
    const bool is_sph = tkind == T_SPHERE;
    Shade o;
    if (is_wall) {
        o.b = (icol[0] * PAL[tcolid][0]) * d;
        o.g = (icol[1] * PAL[tcolid][1]) * d;
        o.r = (icol[2] * PAL[tcolid][2]) * d;
        o.a = (icol[3] * 0.0f) * d;
        o.refl = ld == FYN ? 0.7f : 0.25f;
    } else if (is_sph) {
        o.b = cb;
        o.g = cg;
        o.r = cr;
        o.a = ca;
        o.refl = refl_s;
    } else {
        o.b = rx;
        o.g = ry;
        o.r = rz;
        o.a = 0.0f;
        o.refl = 0.0f;
    }
    o.bounce = (is_wall || is_sph) && o.refl != 0.0f && depth_ok;
    o.fog = s.fog;

    // mirror + nudge (trace_hit_bounce)
    const float eps = 0.001f;
    const bool negx = ld == FXP || ld == FXN;
    const bool negz = ld == FZP || ld == FZN;
    float mrx = (is_wall && negx) ? -rx : rx;
    float mry = (is_wall && ld == FYP) ? -ry : ry;
    float mrz = (is_wall && negz) ? -rz : rz;
    float mpx = s.px, mpy = s.py, mpz = s.pz;
    if (is_wall) {
        mpx = s.px + (ld == FXP ? -eps : ld == FXN ? eps : 0.0f);
        mpy = s.py + ((ld == FYP || ld == FYN) ? -eps : 0.0f);
        mpz = s.pz + (ld == FZP ? -eps : ld == FZN ? eps : 0.0f);
    }
    // water floor: normal from the nudged position
    const bool is_water = is_wall && ld == FYN;
    if (is_water) {
        const float ang = (PI_F * 2.0f)
            * ((m_sin<P>((PI_F * 0.5f) * mpx)
                + m_cos<P>((PI_F * 0.5f) * mpz)) + sec);
        nx = m_sin<P>(ang);
        ny = 38.0f;
        nz = m_cos<P>(ang);
        normalise<P>(w, nx, ny, nz);
    }
    if (is_sph) {
        mpx = apx - rx * 0.001f;
        mpy = apy - ry * 0.001f;
        mpz = apz - rz * 0.001f;
    }
    if (is_water || is_sph) {
        const float rmul = -2.0f * (((0.0f + rx * nx) + ry * ny) + rz * nz);
        mrx = nx * rmul + rx;
        mry = ny * rmul + ry;
        mrz = nz * rmul + rz;
        normalise<P>(w, mrx, mry, mrz);
    }
    // reflect blur: 5 draws, 2 discarded (trace.h:77-84)
    const float rb = 0.03f;
    rx_o = mrx + randfs(seed, inv_mod) * rb;
    ry_o = mry + randfs(seed, inv_mod) * rb;
    randfs(seed, inv_mod);
    rz_o = mrz + randfs(seed, inv_mod) * rb;
    randfs(seed, inv_mod);
    fx = mpx;
    fy = mpy;
    fz = mpz;
    return o;
}

__device__ __forceinline__ uint32_t pack_chan(float c, int shift) {
    const float v = c * 255.0f;
    if (v >= 2147483648.0f || v != v) return 0u;
    const float r = fminf(fmaxf(rintf(v), 0.0f), 255.0f);
    return ((uint32_t)r) << shift;
}

// Kernel arguments (one struct, so both entry points share a launcher)
struct Params {
    const float *ox, *oy, *oz, *dx, *dy, *dz;
    const int32_t* seeds;
    const int32_t* ent;
    const int32_t* word;
    const float* sph;
    const float* bound;       // fast mode only
    const int32_t* buckets;   // parity mode only
    const uint32_t* rsq_tab;  // parity mode only
    const uint32_t* rcp_tab;  // parity mode only
    int n, n_spheres, k_bucket, maxsteps, reflect, skip;
    int n_pages, sphere_page, page0;
    int samples;              // bounce chains a ray
    float sec, slack, inv_mod;
    float inv;                // f32(1 / samples), rounded on the host
    int32_t* out_fb;
    float* out_dist;
};

// Weyl increment between the seed streams of two samples
// (tracer_core.py:1810)
constexpr uint32_t WEYL = 0x9E3779B9u;

template <bool P>
constexpr size_t smem_bytes() {
    return sizeof(float) * NSPH_MAX * SPH_COLS
        + (P ? sizeof(uint32_t) * (RSQ_N + RCP_N) : 0);
}

// March one segment from origin (fx, fy, fz) along (rx, ry, rz), starting
// on `page`, until it terminates or the step budget runs out
// (tracer_core.run_segment)
template <bool P>
__device__ __forceinline__ void march(const World& w, const Params& a,
                                      Seg& s, float fx, float fy, float fz,
                                      float rx, float ry, float rz,
                                      int page) {
    init_segment<P>(w, s, fx, fy, fz, rx, ry, rz, true, page);
    if (!P && a.n_spheres > 0) s.sph_dirty = sphere_all(w, s, true, false);
    for (int step = 0; step < a.maxsteps && s.active; ++step)
        segment_body<P>(w, s);
    if (s.active) s.tmeta = T_SKY;
}

// One bounce chain (trace_wave_env's chain, tracer_core.py:1774-1802):
// shade the finished primary segment s0 with this chain's seed, march
// waves 1..reflect (each on the page where the wave before it ended)
// until a wave does not bounce, then unwind the blend backward into col.
template <bool P>
__device__ __forceinline__ void chain(const World& w, const Params& a,
                                      const Seg& s0, uint32_t seed,
                                      float col[4]) {
    float icol[4] = {1.0f, 1.0f, 1.0f, 1.0f};
    float base[MAX_WAVES][4], refl[MAX_WAVES], fog[MAX_WAVES];
    float fx, fy, fz, rx, ry, rz;
    const int n_waves = a.reflect + 1;
    int last = 0;
    Seg s = s0;
    for (int k = 0; k < n_waves; ++k) {
        if (k > 0) march<P>(w, a, s, fx, fy, fz, rx, ry, rz, s.page);
        const Shade o = shade<P>(w, s, icol, seed, a.sec, k < a.reflect,
                                 a.inv_mod, fx, fy, fz, rx, ry, rz);
        base[k][0] = o.b;
        base[k][1] = o.g;
        base[k][2] = o.r;
        base[k][3] = o.a;
        refl[k] = o.refl;
        fog[k] = o.fog;
        icol[0] = o.b;
        icol[1] = o.g;
        icol[2] = o.r;
        icol[3] = o.a;
        last = k;
        if (!o.bounce) break;
    }
    // backward unwind blend (tracer_core.py:1795-1801): every wave below
    // `last` bounced
    for (int c = 0; c < 4; ++c) col[c] = base[last][c];
    for (int k = last - 1; k >= 0; --k) {
        const float fogf = m_exp<P>(-0.6f * fog[k]);
        for (int c = 0; c < 4; ++c) {
            const float blended = col[c] * refl[k]
                + base[k][c] * (1.0f - refl[k]);
            col[c] = fog[k] != 0.0f ? blended * fogf + (1.0f - fogf)
                                    : blended;
        }
    }
}

// S: a.samples > 1.  The primary wave consumes no RNG, so it is marched
// once and kept (the fields shade reads stay in registers); each sample k
// runs its chain from it with seed + k*WEYL, the chains' colours are
// summed in sample order ((c0 + c1) + c2) + ..., and the sum is scaled by
// the host's f32(1 / samples) before the pack (tracer_core.py:1804-1817).
// S = false is the one-chain trace.
template <bool P, bool S>
__global__ void __launch_bounds__(BLOCK) trace_kernel(const Params a) {
    // shared memory: the sphere records, then (parity) the SSE tables
    extern __shared__ uint32_t smem[];
    float* sph = reinterpret_cast<float*>(smem);
    uint32_t* rsq = smem + NSPH_MAX * SPH_COLS;
    uint32_t* rcp = rsq + RSQ_N;
    for (int k = threadIdx.x; k < a.n_spheres * SPH_COLS; k += blockDim.x)
        sph[k] = a.sph[k];
    if (P) {
        for (int k = threadIdx.x; k < RSQ_N; k += blockDim.x)
            rsq[k] = __ldg(a.rsq_tab + k);
        for (int k = threadIdx.x; k < RCP_N; k += blockDim.x)
            rcp[k] = __ldg(a.rcp_tab + k);
    }
    __syncthreads();
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= a.n) return;

    World w;
    w.ent = a.ent;
    w.word = a.word;
    w.sph = sph;
    w.n_spheres = a.n_spheres;
    w.n_pages = a.n_pages;
    w.sphere_page = a.sphere_page;
    if (P) {
        w.bx = w.bz = w.brq2 = 0.0f;
        w.skip = false;
        w.buckets = a.buckets;
        w.k_bucket = a.k_bucket;
        w.rsq_tab = rsq;
        w.rcp_tab = rcp;
    } else {
        w.bx = a.bound[0];
        w.bz = a.bound[2];
        w.brq2 = a.bound[3] * a.bound[3] + a.slack;
        w.skip = a.skip != 0;
        w.buckets = nullptr;
        w.k_bucket = 0;
        w.rsq_tab = w.rcp_tab = nullptr;
    }

    const uint32_t seed = (uint32_t)a.seeds[i];
    Seg s;
    march<P>(w, a, s, a.ox[i], a.oy[i], a.oz[i], a.dx[i], a.dy[i], a.dz[i],
             a.page0);
    const float dist0 = s.cdist;
    float col[4];
    for (int k = 0; k < (S ? a.samples : 1); ++k) {
        float c[4];
        chain<P>(w, a, s, seed + (uint32_t)k * WEYL, c);
        for (int j = 0; j < 4; ++j) col[j] = k == 0 ? c[j] : col[j] + c[j];
    }
    if (S) {
        for (int j = 0; j < 4; ++j) col[j] = col[j] * a.inv;
    }
    a.out_dist[i] = dist0;
    a.out_fb[i] = (int32_t)(pack_chan(col[0], 0) | pack_chan(col[1], 8)
                            | pack_chan(col[2], 16)
                            | pack_chan(col[3], 24));
}

template <bool P, bool S>
int launch_instance(const Params& a, void* stream) {
    constexpr size_t smem = smem_bytes<P>();
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            trace_kernel<P, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const int grid = (a.n + BLOCK - 1) / BLOCK;
    trace_kernel<P, S><<<grid, BLOCK, smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

template <bool P>
int launch(const Params& a, void* stream) {
    if (a.n_spheres < 0 || a.n_spheres > NSPH_MAX || a.reflect < 0
            || a.reflect + 1 > MAX_WAVES || a.n_pages < 1 || a.n_pages > 16
            || a.sphere_page < 0 || a.sphere_page >= a.n_pages
            || a.page0 < 0 || a.page0 >= a.n_pages || (P && a.n_pages != 1)
            || a.samples < 1
            || (P && (a.k_bucket < 0 || (a.k_bucket > 0
                                         && a.n_spheres == 0))))
        return (int)cudaErrorInvalidValue;
    if (a.n <= 0) return (int)cudaGetLastError();
    if (P)
        return a.samples > 1 ? launch_instance<true, true>(a, stream)
                             : launch_instance<true, false>(a, stream);
    return a.samples > 1 ? launch_instance<false, true>(a, stream)
                         : launch_instance<false, false>(a, stream);
}

}  // namespace

// Trace n rays in fast mode.  Inputs: origins (ox, oy, oz) and directions
// (dx, dy, dz) f32 [n], seeds i32 [n] (uint32 bits); the world tables of
// ops/world.py:world_to_torch (ent and word [n_pages * 4096]); every ray
// starts on page page0; samples bounce chains a ray, inv = f32(1 /
// samples).  Output: out_fb i32 [n] packed BGRA of the chains' mean and
// out_dist f32 [n] primary-wave distance.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int pwnfps_trace(const void* ox, const void* oy, const void* oz,
                            const void* dx, const void* dy, const void* dz,
                            const void* seeds, const void* ent,
                            const void* word, const void* sph,
                            const void* bound, int n, int n_spheres,
                            int maxsteps, int reflect, int skip,
                            int n_pages, int sphere_page, int page0,
                            int samples, float sec, float slack,
                            float inv_mod, float inv, void* out_fb,
                            void* out_dist, void* stream) {
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
    a.sec = sec;
    a.slack = slack;
    a.inv_mod = inv_mod;
    a.inv = inv;
    a.out_fb = (int32_t*)out_fb;
    a.out_dist = (float*)out_dist;
    return launch<false>(a, stream);
}

// Trace n rays in parity mode.  As pwnfps_trace, less the bound, the
// skip and the pages, plus the bucket table [4096 * k_bucket] i32 and the
// SSE rsqrt [8192] and rcp [4096] tables (uint32 bits).
extern "C" int pwnfps_trace_parity(
        const void* ox, const void* oy, const void* oz, const void* dx,
        const void* dy, const void* dz, const void* seeds, const void* ent,
        const void* word, const void* sph, const void* buckets,
        const void* rsq_tab, const void* rcp_tab, int n, int n_spheres,
        int k_bucket, int maxsteps, int reflect, int samples, float sec,
        float inv_mod, float inv, void* out_fb, void* out_dist,
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
    a.n_pages = 1;
    a.samples = samples;
    a.inv = inv;
    a.sec = sec;
    a.inv_mod = inv_mod;
    a.out_fb = (int32_t*)out_fb;
    a.out_dist = (float*)out_dist;
    return launch<true>(a, stream);
}
