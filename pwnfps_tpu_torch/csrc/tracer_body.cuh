// Multi-bounce wavefront tracer for Hopper (sm_90a), the kernel body that
// csrc/tracer.cu and csrc/tracer_variants.cu instantiate: fast mode and
// parity mode, each on one page or a paged world atlas.
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
//     segment and shades it once, runs one bounce chain from that
//     shading per sample with seed + k*0x9E3779B9, and packs the chains'
//     mean: a second instance of the same template (S = true), so
//     samples = 1 keeps its code;
//   * parity (entry pwnfps_trace with parity set; the TPU kernel's
//     _parity_math, tracer_pallas.py:446, and _sphere_pass_pallas,
//     :491): unit steps, the reference's per-cell
//     sphere-bucket scan, and bit-exact math - the SSE rsqrt/rcp tables
//     (core/approx.py, in their 8 KB compact form), IEEE
//     round-to-nearest-even division and square root (__fdiv_rn,
//     __fsqrt_rn: the bits of core/ieee.py's integer div_rn and sqrt_rn,
//     which csrc/ieee_check.cu holds them to on the card) and the pinned
//     libm (core/detmath.py), in integer ops and single IEEE operations,
//     so its bits depend on no device math library's approximations: it
//     equals the plain parity tracer, which the CPU tests hold bit for
//     bit to the scalar spec ops/tracer_ref.ScalarTracer(pinned=True).
//     With samples > 1 the parity march runs once and each sample's
//     parity chain runs from it, as in fast mode: a fourth instance
//     (P = S = true), whose SSE tables stay in shared memory across the
//     chains.  Both parity
//     instances take paged worlds as the fast ones do (the paged branch of
//     _sphere_pass_pallas, :502-504): the bucket scan reads the ray's
//     page of the [n_pages * 4096 * k_bucket] bucket table, and only
//     sphere_page's cells have a count;
//   * fused (entry pwnfps_trace with fused = 1; run_fused of
//     tracer_core.py:1592, which the TPU kernel runs inside _kernel when
//     RenderConfig.fused is set, tracer_pallas.py:650): fast mode, one
//     sample, one page or paged.  run_fused shades a segment that ended
//     at the start of its lane's next iteration and steps the restart in
//     that iteration, so a lane's bits depend only on its own iteration
//     count: each lane here marches its segment to its end counting those
//     iterations, the warp's lanes shade together, and the unwind blend
//     is a forward affine col = acc_a + acc_b * child.  A lane ends when
//     its colour is final, or at the cap maxsteps * n_waves + 8 * n_waves
//     rounded up to step_chunk, held per lane (a segment ending on the
//     last iteration is still shaded).  A fifth instance (F = true) of
//     the same march, step body and shading;
//   * the measurement instances (V != VAR_NONE), each the TPU kernel's
//     instance for its RenderConfig knobs - profile (each wave's
//     terminal DDA step count a ray, tracer_core.py:1436-1456, written to
//     a third output), nowater (the flat floor normal, :1719-1722) and the
//     eight calibration pads of RenderConfig.probe (fire1 :717, fetch2x
//     :1082, pad64 .. cmp64 :1217-1290): one knob in fast mode with one
//     sample (entry pwnfps_trace_variant of tracer_variants.cu) and in
//     parity mode with one sample (pwnfps_trace_parity_variant of
//     tracer_parity_variants.cu), one instance a knob; every other
//     combination - several knobs, samples > 1 in either mode, the fused
//     loop - in one instance a structure that reads its knobs at run
//     time (VAR_FLAGS, pwnfps_trace_flags of tracer_flags.cu), whose
//     uniform branches leave the one-knob instances to price a pad.  A
//     pad's result replaces fog or tmeta only where cdist > -1e30f is
//     false, which the compiler cannot know is never, so the pad is
//     computed and the bits stay those of the base instance; dda_step
//     runs the pads over segment_body's operands and masks, those of the
//     lane's outcome.  One more, phases (VAR_PHASES), is each mode's
//     one-chain instance with clock64() counters around its regions
//     (phase_add), for tools/phase_split.py.  Each `if constexpr` on V
//     compiles away in the other instances, so they keep their code.
//
// Every instance packs the colour to BGRA8, or with Params.out_col set
// writes it unpacked, four f32 planes B, G, R, A (the TPU kernel's
// pack=False outputs, tracer_pallas.py:652-661): a uniform branch at the
// end of a ray, which left every rendering instance's registers, stack
// and spills as they were (ptxas, nvcc 12.8).
//
// What bounds it on the H100: issue and latency, not bandwidth.  A ray's
// work is a data-dependent loop (a few steps for a wall hit, up to the
// 1000-step budget for sky rays, per bounce), every step a dependent
// gather from the cell table, and ~40 scalars of march state live in
// registers.  A warp runs as long as its longest ray's chain, and the
// warps an SM keeps resident are set by the registers (92 in the fast
// one-page instance).  The flagship's 1080p frame counts 4.56 G
// operations, 0.07 ms at the card's FP32 rate: the kernel issues far more
// instructions than that (the IEEE sqrtf and division sequences, selects,
// the rare-event checks of every step) through warps whose lanes mask off
// as their rays finish.  Tensor cores, wgmma and clusters have no work
// here: a ray march has no matrix product.  With samples a ray runs S
// chains of up to reflect waves from one primary segment, marched and
// shaded once: its shading draws no random number, so its colour,
// reflectance and fog stay in the unwind records' wave 0 and 8 values
// (whether it bounces, the bounce origin, the mirrored ray, the end page)
// in registers across the chains, and each chain begins with the jitter.
//
// Parity mode adds the bucket scan's slot tests and a table gather for
// every rsqrt and rcp.  The two tables sit in shared memory in their
// compact form, 8 KB (every entry is 0x3F000000 | (12 bits << 11), one
// a group of 4 or 2 equal entries; core/approx.py compact_tables),
// loaded once a block by a bulk copy: their index is data dependent, so
// __constant__ memory would serialise a warp's lookups.  Its division
// and roots are the card's IEEE ones, a few instructions each (the
// integer emulations are 27- and 25-step loops).
//
// Design.  Each thread traces one ray to the end of its chain and unwinds
// it backward (tracer_core.py:1795-1801); the TPU kernel's tile-uniform
// branches (lax.cond on any-lane flags, the whole-tile sphere-hoist gate,
// the while loop's any-active test) are per-thread branches whose bodies
// are per-lane masked, so a thread computes its own ray's bits.  Around
// that, each step was timed on the 1080p flagship (tools/instance_times.py
// run against copies of the package with one step undone; PERF.md has
// the numbers):
//   * warp tiles: each warp traces an 8x4-pixel tile of the image
//     (tile_ray; set_tiles takes the width), not a 32x1 strip, so its
//     rays share cells, walls, sphere hits and bounce counts: ~7% off the
//     kernel's time, more than the step occupancy alone moves;
//   * persistent warps: resident blocks whose warps take tiles off an
//     atomic queue, which the last block to finish resets.  Slower on the
//     one-chain instances, which launch a block for every 12 tiles (fast)
//     or 14 (parity); kept for samples and fused, whose long chains it
//     balances;
//   * a one-page world's cell tables (32 KB) in shared memory, in both
//     modes, copied by TMA bulk copies completing on an mbarrier (with
//     parity's compact SSE tables): fetch becomes a shared load.  Paged
//     worlds keep the read-only cache;
//   * the unwind records in shared memory, [wave][record][thread], where
//     no run-time index sends them to local memory: the stack falls from
//     224 to 32 bytes, which are the device sinf/cosf's buffer for their
//     large-argument reduction (the nowater instance, which calls
//     neither, and the parity ones have none);
//   * blocks of 384 threads, two an SM, for the one-chain fast
//     instances: 24 warps at 79 registers with no spill, 3-5% faster
//     than 320 x 2 and than 256 x 3 (before the one-outcome step they
//     needed 92 registers, and 24 warps spilled 28 bytes).  The samples
//     instances keep 320 x 2.  The fused loop keeps 128-thread blocks
//     (Block): in 320-thread blocks it was 3% faster at 1080p, but
//     10-12% slower on the 720p portal chain and at 320x180.  The
//     one-chain parity instance takes 448-thread blocks, two an SM: 28
//     warps at 67 registers, no spill (512 threads spill);
//   * one DDA step for both modes (step_core) that takes one branch for
//     the one outcome a lane's step has, where segment_body computes
//     every outcome's mask and selects among them: with some 30 masks
//     live, ptxas kept them as bits of a register and a parity step's
//     common path ran to about 400 instructions.  About 2x off every
//     parity frame, and fast mode steps through the same function
//     (PERF.md);
//   * fast mode takes each sphere's two square roots only where its
//     candidate test can pass (sphere_all), at a segment's start and in
//     a step's refresh: 5% off config #5's frame at the starts, about
//     1.2x off the flagship's and the fused loop's 1080p frames with the
//     refresh (PERF.md);
//   * the samples instances shade the primary segment once a pixel
//     (3% off config #5's frame in parity mode).  They
//     run each sample's chain after the last, in every lane of a warp
//     together.  Lanes that each start their next
//     chain as soon as their own ends, with a warp vote that batches the
//     shading (Aila and Laine's while-while loop), took 1.49x fewer step
//     slots on config #5's frame but ran 1.16-2.3x slower, per-pixel
//     refill off the queue 3.8x: every pixel there shades 25 segments,
//     which lockstep chains shade all lanes at once and desynchronised
//     lanes do not.
//   * the fused loop: each lane marches its segment to its end, then the
//     warp shades all lanes together, once a segment, as chain() does
//     (1.19x faster at 1080p than shading each lane at the start of its
//     next iteration, which ran the shading once for every iteration in
//     which some lane of the warp ended a segment).  Compacting the rays
//     that bounce into a block-wide queue between waves ran 6-17%
//     slower: every ray of the flagship, portal chain and maze frames
//     lives through every wave (tools/occupancy.py), so it drops no lane
//     and pays a block barrier a wave (PERF.md).
// Sphere records sit in shared memory in every instance, NSPH_MAX of
// them (4 KB) a block.
//
// Numerics: build with --fmad=false, -prec-div=true, -prec-sqrt=true and
// -ftz=false (_build.py) so a*b+c rounds twice, as on the TPU and in
// eager torch, and / and sqrtf are IEEE; float literals carry the f
// suffix so nothing is promoted to double, and the pinned libm's
// constants are given by their bits; float-to-int conversions saturate
// (__float2int_rz); maxima propagate NaN like jnp.maximum.

#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>


// the block's dynamic shared memory (its layout: off_sph .. off_rec)
extern __shared__ __align__(128) uint32_t smem[];

namespace {

// measurement instances (ops/tracer.py VARIANTS has the same values)
constexpr int VAR_NONE = 0, VAR_NOWATER = 1, VAR_PROFILE = 2, VAR_FIRE1 = 3,
              VAR_FETCH2X = 4, VAR_PAD64 = 5, VAR_PAD64D = 6, VAR_SEL64 = 7,
              VAR_BOOL128 = 8, VAR_INT128 = 9, VAR_CMP64 = 10,
              VAR_PHASES = 11, VAR_FLAGS = 12;
// VAR_FLAGS reads its knobs at run time from Params.flags: a probe's
// VAR_* (0: none) in the low 4 bits, and FLAG_NOWATER
constexpr int FLAG_NOWATER = 16;

// a calibration pad's instance: pad64 .. cmp64
__host__ __device__ constexpr bool is_pad(int V) {
    return V >= VAR_PAD64 && V <= VAR_CMP64;
}
// VAR_PHASES's regions (ops/tracer.py PHASES, in this order): the block's
// prologue, a tile's trace, a segment's march (its start, its steps and
// their loop), the DDA steps, a wave's shading, the unwind, and the whole
// kernel; their counters take PHASE_ROWS rows of N_PHASES, a row for each
// warp modulo PHASE_ROWS
constexpr int PH_PROLOGUE = 0, PH_TILE = 1, PH_MARCH = 2, PH_STEPS = 3,
              PH_SHADE = 4, PH_UNWIND = 5, PH_KERNEL = 6, N_PHASES = 7;
constexpr int PHASE_ROWS = 8192;

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
// spheres a world may hold: the object pool's NS_MAX
// (world/objects.py), all of which the JAX package's jnp backend traces
constexpr int NSPH_MAX = 64;
constexpr int SPH_COLS = 16;
// sphere-record columns (ops/world.py)
constexpr int SX = 0, SY = 1, SZ = 2, SR = 3, SREFL = 4, SCB = 5,
              SBX1 = 8, SBX2 = 9, SBZ1 = 10, SBZ2 = 11, SRAD2 = 12,
              SINVR2 = 13;
constexpr int MAX_WAVES = 8;
constexpr int WARP = 32;
// Threads a block and the blocks an SM that __launch_bounds__ keeps
// resident, by instance <P, S, F>: the one-chain fast instances 384 x 2,
// 24 warps at 80 registers or fewer; the one-chain parity instance
// 448 x 2, 28 warps at 72 or fewer; the samples instances 320 x 2, 20
// warps at 96 or fewer; the fused loop 128 x 1, which measured faster
// for it than 320 x 2 on the 720p portal chain and at 320x180 (PERF.md).
// The unwind records' stride is the block's threads.
template <bool P, bool S, bool F>
struct Block {
    static constexpr int threads = F ? 128 : S ? 320 : P ? 448 : 384;
    static constexpr int min_blocks = F ? 1 : 2;
    static constexpr int warps = threads / WARP;
};
constexpr int TILE_W = 8, TILE_H = 4;  // a warp's pixel tile
constexpr int CELLS = 4096;            // the cells of a page
constexpr int REC = 6;                 // unwind floats a wave
// SSE emulation tables (core/approx.py), compact: rsqrt's 12-bit
// entries R [2 * 1024] (one an aligned group of 4 indices), then rcp's
// C [2048] (one a group of 2), 16 bits each (compact_tables)
constexpr int SSE_RCP = 2048, SSE_ENTRIES = 4096, APPROX_BLOCK = 11;
constexpr int SSE_BYTES = SSE_ENTRIES * 2;
constexpr uint32_t SSE_HALF = 0x3F000000u;  // every entry's sign, exponent

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
    const int32_t* buckets;  // [n_pages * 4096 * k_bucket] ids, -1 pad
    int k_bucket;
    const uint16_t* sse;     // shared memory: the compact SSE tables
    unsigned long long* phases;  // VAR_PHASES: [PHASE_ROWS, N_PHASES]
    int flags;               // VAR_FLAGS: Params.flags
};

// The probe instance V runs (a VAR_* pad or probe, or VAR_NONE): V
// itself, or the one VAR_FLAGS's Params.flags names
template <int V>
__device__ __forceinline__ int probe_of(const World& w) {
    if constexpr (V == VAR_FLAGS) return w.flags & 15;
    return V;
}

// whether instance V shades the water floor with the flat normal
template <int V>
__device__ __forceinline__ bool nowater(const World& w) {
    if constexpr (V == VAR_FLAGS) return (w.flags & FLAG_NOWATER) != 0;
    return V == VAR_NOWATER;
}

// whether instance V counts each wave's terminal step (VAR_FLAGS writes
// them where Params.out_tstep is set)
__host__ __device__ constexpr bool profiles(int V) {
    return V == VAR_PROFILE || V == VAR_FLAGS;
}

// A value the compiler must compute here and may not fold: an empty asm
// statement that takes it in a register (the host build's SSE register
// for a float)
__device__ __forceinline__ void keep(float& x) {
#ifdef __CUDACC__
    asm volatile("" : "+f"(x));
#else
    asm volatile("" : "+x"(x));
#endif
}

__device__ __forceinline__ void keep(int& x) {
    asm volatile("" : "+r"(x));
}

// VAR_PHASES: the clock at a region's start, and (phase_add) the warp's
// lowest active lane adding the cycles since then to region k of its
// warp's row, so a region counts once a warp each time the warp runs it,
// whichever lanes take it.  A region run once a step adds into a register
// instead (phase_lead: the cycles of the runs this lane led), summed over
// the warp's lanes once a segment (phase_sum).  Nothing in the other
// instances.
template <int V>
__device__ __forceinline__ long long phase_clock() {
    if constexpr (V == VAR_PHASES) return clock64();
    return 0;
}

__device__ __forceinline__ bool warp_leader() {
    return (int)(threadIdx.x % WARP) == __ffs(__activemask()) - 1;
}

__device__ __forceinline__ void phase_store(const World& w, int k,
                                            unsigned long long v) {
    const unsigned row = (blockIdx.x * blockDim.x + threadIdx.x) / WARP
        % PHASE_ROWS;
    atomicAdd(w.phases + row * N_PHASES + k, v);
}

template <int V>
__device__ __forceinline__ void phase_add(const World& w, int k,
                                          long long t0) {
    if constexpr (V == VAR_PHASES) {
        const long long dt = clock64() - t0;
        if (warp_leader()) phase_store(w, k, (unsigned long long)dt);
    }
}

template <int V>
__device__ __forceinline__ void phase_lead(unsigned& acc, long long t0) {
    if constexpr (V == VAR_PHASES) {
        const unsigned dt = (unsigned)(clock64() - t0);
        if (warp_leader()) acc += dt;
    }
}

template <int V>
__device__ __forceinline__ void phase_sum(const World& w, int k,
                                          unsigned acc) {
    if constexpr (V == VAR_PHASES) {
        const unsigned total = __reduce_add_sync(__activemask(), acc);
        if (warp_leader()) phase_store(w, k, total);
    }
}

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

// A cell's compact entry (fetch) and full channel word (fetch_word).  T:
// a one-page world's tables sit in shared memory (the block's prologue
// copies them there); else they are read through the read-only cache.
template <bool T>
__device__ __forceinline__ int fetch(const World& w, int cx, int cz,
                                     int page) {
    const int k = flat_index(cx, cz, page);
    return T ? (int)smem[k] : __ldg(w.ent + k);
}

template <bool T>
__device__ __forceinline__ int fetch_word(const World& w, int cx, int cz,
                                          int page) {
    const int k = flat_index(cx, cz, page);
    return T ? (int)smem[CELLS + k] : __ldg(w.word + k);
}

// ---- parity math: bit-exact emulations (core/approx.py, core/ieee.py,
// core/detmath.py), integer ops and single IEEE adds and multiplies ----

// _mm_rsqrt_ps: table by exponent parity and the top 12 mantissa bits,
// times 2^-k; the table's entry is 0x3F000000 | (R << 11), one R an
// aligned group of 4; the scale's bits wrap in 32 bits as in uint32
__device__ __forceinline__ float rsq_emu(const World& w, float x) {
    const uint32_t bits = __float_as_uint(x);
    const int d = (int)(bits >> 23) - 127;
    const int k = d >> 1;                 // arithmetic: floor(d / 2)
    const int p = d - 2 * k;
    const uint32_t r = w.sse[p * 1024 + (int)((bits & 0x7FFFFFu)
                                              >> (APPROX_BLOCK + 2))];
    const float y = __uint_as_float(SSE_HALF | (r << APPROX_BLOCK));
    return y * __uint_as_float((uint32_t)(127 - k) << 23);
}

// _mm_rcp_ps: table by the top 12 mantissa bits, times 2^-k; one C an
// aligned group of 2
__device__ __forceinline__ float rcp_emu(const World& w, float x) {
    const uint32_t bits = __float_as_uint(x);
    const int k = (int)(bits >> 23) - 127;
    const uint32_t c = w.sse[SSE_RCP + (int)((bits & 0x7FFFFFu)
                                             >> (APPROX_BLOCK + 1))];
    const float y = __uint_as_float(SSE_HALF | (c << APPROX_BLOCK));
    return y * __uint_as_float((uint32_t)(127 - k) << 23);
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
// the relevance bit (0 or 2).  A sphere's two square roots are taken only
// where its candidate test can pass (the line ahead within its radius),
// the only place their result is read; ROOTS (fire1's full pass,
// tracer_core.py:717) takes them for every sphere.
template <bool ROOTS = false>
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
            const bool near = dot > 0.0f && calcrad2 < r[SRAD2];
            float sph_dist = 0.0f;
            if (ROOTS || near)
                sph_dist = sqrtf(dist2) - sqrtf(fmax_nan(
                    1.0f - calcrad2 * r[SINVR2], 0.0f));
            if constexpr (ROOTS) keep(sph_dist);
            const float te_d = s.cdist + t_entry;
            const float aux_c = sph_dist + te_d;
            const float fire_c = fmax_nan(aux_c, te_d);
            const bool upd = near
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
// and a sphere in the slot); the last strictly closer hit wins.  The
// cell's slots sit at page * 4096 + cz * 64 + cx of the bucket table.
__device__ void sphere_pass(const World& w, Seg& s) {
    if (s.cx < 0 || s.cx >= 64 || s.cz < 0 || s.cz >= 64) return;
    const int nsph = min((s.ent >> 15) & 0x1F, w.k_bucket);
    const int32_t* slots = w.buckets
        + (s.page * 4096 + s.cz * 64 + s.cx) * w.k_bucket;
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
        // IEEE round-to-nearest-even root and quotient: the bits of
        // core/ieee.py's integer sqrt_rn and div_rn
        const float sph_dist = __fsqrt_rn(dist2) - __fsqrt_rn(fmax_nan(
            1.0f - __fdiv_rn(calcrad2, rad2 > 0.0f ? rad2 : 1.0f), 0.0f));
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
template <bool P, bool T>
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
    s.ent = fetch<T>(w, s.cx, s.cz, page);
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

// A portal cell's jump (tracer_core.fetch_portal): the target page, the
// portal's kind (pkind), and the ray's state one step past the far
// portal, turned by its quarter turns (ldir, g*, c*, p*, v*, w*, i*)
struct Jump {
    int dpage, pkind, ldir, gx, gz, cx, cz;
    float px, pz, vx, vz, wx, wz, ix, iz;
};

template <bool T>
__device__ __forceinline__ Jump portal_jump(const World& w, const Seg& s) {
    Jump j;
    const int pw = fetch_word<T>(w, s.cx, s.cz, s.page);
    // a one-page world's bits 26-29 count spheres, not a page
    j.dpage = w.n_pages > 1 ? (pw >> 26) & 0xF : s.page;
    j.pkind = (pw >> 4) & 3;
    const int prot = (pw >> 6) & 3;
    const int pdcx = ((pw >> 12) & 0x7F) - 64;
    const int pdcz = ((pw >> 19) & 0x7F) - 64;
    const int cxp = s.cx + pdcx;
    const int czp = s.cz + pdcz;
    const float px_t = s.px + (float)pdcx;
    const float pz_t = s.pz + (float)pdcz;
    j.ldir = (s.ldir - prot) & 3;
    const float cxh = (float)cxp + 0.5f;
    const float czh = (float)czp + 0.5f;
    const bool r1 = prot == 1, r2 = prot == 2, r3 = prot == 3;
    const float px_r = r1 ? cxh + (pz_t - czh)
        : r2 ? cxh * 2.0f - px_t : r3 ? cxh - (pz_t - czh) : px_t;
    const float pz_r = r1 ? czh - (px_t - cxh)
        : r2 ? czh * 2.0f - pz_t : r3 ? czh + (px_t - cxh) : pz_t;
    j.vx = r1 ? s.rz : r2 ? -s.rx : r3 ? -s.rz : s.rx;
    j.vz = r1 ? -s.rx : r2 ? -s.rz : r3 ? s.rx : s.rz;
    j.gx = r1 ? s.gz : r2 ? -s.gx : r3 ? -s.gz : s.gx;
    j.gz = r1 ? -s.gx : r2 ? -s.gz : r3 ? s.gx : s.gz;
    const bool swap = r1 || r3;
    j.wx = swap ? s.wz : s.wx;
    j.wz = swap ? s.wx : s.wz;
    j.ix = swap ? s.iz : s.ix;
    j.iz = swap ? s.ix : s.iz;
    const int step_dx = j.ldir == FZP ? 0 : j.ldir == FXN ? -1
        : j.ldir == FZN ? 0 : 1;
    const int step_dz = j.ldir == FZP ? 1 : j.ldir == FZN ? -1 : 0;
    j.cx = cxp + step_dx;
    j.cz = czp + step_dz;
    j.px = px_r + (float)step_dx;
    j.pz = pz_r + (float)step_dz;
    return j;
}

// A ramp cell's tilt of the ray's Y slope and its Y wall distance
// (tracer_core.py:922-925); tilt is exactly 0 on other cells.  P: the
// division is the IEEE round-to-nearest-even one, the bits of
// core/ieee.py's div_rn
template <bool P>
__device__ __forceinline__ void ramp_tilt(const Seg& s, int cls, float& tilt,
                                          float& wy_ramp) {
    const float coef_x = cls == RAMP_GT ? -0.5f
        : cls == RAMP_LT ? 0.5f : 0.0f;
    const float coef_z = cls == RAMP_CM ? -0.5f
        : cls == RAMP_CR ? 0.5f : 0.0f;
    const bool rampx = cls == RAMP_GT || cls == RAMP_LT;
    tilt = rampx ? coef_x * s.rx : coef_z * s.rz;
    const float ry2 = s.ry + tilt;
    const float ay2 = ry2 < 0.0f ? -ry2 : ry2;
    wy_ramp = (ry2 >= 0.0f ? 1.0f - s.py : s.py)
        * (P ? __fdiv_rn(1.0f, ay2) : 1.0f / ay2);
}

// Calibration pad K (tracer_core.py:1217-1290) over a step's values vs
// (pos, ray, wx, wz), its live masks ms and cell-class masks ns, the
// mul+add chains by mul and add: the result replaces fog (pad64, pad64d,
// sel64, cmp64) or tmeta (bool128, int128) only where opq is false
template <int K>
__device__ __forceinline__ void pad(const float vs[8], float mul, float add,
                                    const bool ms[8], const bool ns[8],
                                    bool opq, float& fog, int& tmeta) {
    if constexpr (K == VAR_PAD64) {             // 8 x 8 mul+add chains
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            float u = vs[j];
#pragma unroll
            for (int k = 0; k < 8; ++k) u = u * mul + add;
            acc = j == 0 ? u : acc + u;
        }
        fog = opq ? fog : acc;
    } else if constexpr (K == VAR_PAD64D) {     // one 64-step chain
        float u = vs[0];
#pragma unroll
        for (int k = 0; k < 64; ++k) u = u * mul + add;
        fog = opq ? fog : u;
    } else if constexpr (K == VAR_SEL64 || K == VAR_CMP64) {
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            float u = vs[j];
#pragma unroll
            for (int k = 0; k < 8; ++k) {
                if constexpr (K == VAR_SEL64) {     // 8-deep select chains
                    // every link's alternate opaque to the compiler:
                    // with one repeated operand, a chain folds into an
                    // and-reduction and one select
                    float alt = vs[(j + 1) % 8];
                    keep(alt);
                    u = ms[k] ? u : alt;
                } else                              // compare + select
                    u = u < vs[(j + k + 1) % 8] ? u : vs[(j + k) % 8];
            }
            acc = j == 0 ? u : acc + u;
        }
        fog = opq ? fog : acc;
    } else {        // bool128 on predicates, int128 on {0, 1} words
        using M = std::conditional_t<K == VAR_INT128, int, bool>;
        M acc = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const M m = ms[j];
            M u = m;
#pragma unroll
            for (int k = 0; k < 8; ++k) u = u ^ (m & (M)ns[k]);
            acc = j == 0 ? u : (M)(acc | u);
        }
        tmeta = opq ? tmeta : (acc ? 1 : 2);
    }
}

// The pad of instance V, if it has one (VAR_FLAGS: the one its flags
// name); pad's arguments
template <int V>
__device__ __forceinline__ void apply_pad(const World& w, const float vs[8],
                                          float mul, float add,
                                          const bool ms[8], const bool ns[8],
                                          bool opq, float& fog, int& tmeta) {
    if constexpr (V == VAR_FLAGS) {
        switch (w.flags & 15) {
            case VAR_PAD64:
                pad<VAR_PAD64>(vs, mul, add, ms, ns, opq, fog, tmeta);
                break;
            case VAR_PAD64D:
                pad<VAR_PAD64D>(vs, mul, add, ms, ns, opq, fog, tmeta);
                break;
            case VAR_SEL64:
                pad<VAR_SEL64>(vs, mul, add, ms, ns, opq, fog, tmeta);
                break;
            case VAR_BOOL128:
                pad<VAR_BOOL128>(vs, mul, add, ms, ns, opq, fog, tmeta);
                break;
            case VAR_INT128:
                pad<VAR_INT128>(vs, mul, add, ms, ns, opq, fog, tmeta);
                break;
            case VAR_CMP64:
                pad<VAR_CMP64>(vs, mul, add, ms, ns, opq, fog, tmeta);
                break;
            default:
                break;
        }
    } else if constexpr (is_pad(V)) {
        pad<V>(vs, mul, add, ms, ns, opq, fog, tmeta);
    }
}

// The masks of segment_body (tracer_core.py) that a calibration pad reads
// (its ms and ns), as step_core reports the lane's outcome
constexpr int O_XSTEP = 1, O_ZSTEP = 2, O_TERM = 4, O_PGO = 8, O_CONT = 16,
              O_MY2 = 32, O_FT = 64, O_NEAR = 128, O_SPHM = 256,
              O_WALLT = 512;

// A step's X and Z wall distances after fast mode's empty-space skip
// (tracer_core.py segment_body): kx (kz) more cells of the floor run
// ahead in X (Z), as far as the other axis allows; none in parity mode
struct Skip {
    float wxe, wze;
    int kx, kz;
};

template <bool P>
__device__ __forceinline__ Skip skip_of(const World& w, const Seg& s) {
    Skip k = {s.wx, s.wz, 0, 0};
    if constexpr (!P) {
        if (w.skip) {
            const int runx = (s.ent >> 7) & 0xF;
            const int runz = (s.ent >> 11) & 0xF;
            const int jx = __float2int_rz(floorf((s.wz - s.wx)
                                                 * fabsf(s.rx)));
            const int jz = __float2int_rz(floorf((s.wx - s.wz)
                                                 * fabsf(s.rz)));
            k.kx = min(max(min(runx, jx), 0), 15);
            k.kz = min(max(min(runz, jz), 0), 15);
            k.wxe = s.wx + (float)k.kx * s.ix;
            k.wze = s.wz + (float)k.kz * s.iz;
        }
    }
    return k;
}

// Fast mode's hoisted-sphere bookkeeping after a line change (a portal
// jump, or a step that moved the ray to another Y line where bit 1 of
// sph_dirty asks for it): the refresh bits become `dirty`, and a
// candidate whose entry lies behind the new position is dropped
template <bool P>
__device__ __forceinline__ void line_change(const World& w, Seg& s,
                                            int dirty) {
    if constexpr (!P) {
        if (w.n_spheres > 0) {
            if (s.aux_dist != -1.0f && s.cdist < s.aux_t0)
                s.aux_dist = -1.0f;
            s.sph_dirty = dirty;
        }
    }
}

// One DDA step of an active lane in either mode (tracer_core.
// segment_body), up to the end-of-iteration sphere check: segment_body
// computes every outcome's mask and selects among them; here a lane
// takes one branch for its one outcome, each computing its fields by the
// same float operations on the same operands, so the bits are
// segment_body's.  First the spheres: parity mode scans the cell's
// buckets, fast mode refreshes its hoisted candidates where sph_dirty
// asks.  Then in order: the sphere exit before a ramp step, on a floor or
// 2-high cell the sphere exit and the Y hit, a ramp's Y hit, then on any
// marchable cell the X/Z step (fast mode: past the empty-space skip's
// cells) or the 2-high wall it meets, else a portal cell's jump or end, a
// wall, or nothing.  T: as fetch.  V: the measurement instance (VAR_*):
// fire1 runs the event bodies every step (tracer_core.py:717) - fast
// mode's sphere refresh, every sphere's roots taken, on a copy that the
// lane keeps only where its own bit asks, the portal jump and the target line's sphere relevance;
// parity mode's jump and ramp tilt - fetch2x fetches twice.  Returns the
// masks of the lane's outcome (O_*), and in `fire` the distance the
// end-of-iteration check compares with.
template <bool P, int V, bool T>
__device__ int step_core(const World& w, Seg& s, float& fire) {
    // the pads' data-opaque select: true unless cdist is NaN
    const bool opq = s.cdist > -1e30f;
    const bool has_sph = !P && w.n_spheres > 0;
    const bool fire1 = probe_of<V>(w) == VAR_FIRE1;
    if constexpr (P) {
        if (w.k_bucket > 0) sphere_pass(w, s);
    } else if (fire1) {
        if (has_sph) {
            Seg t = s;
            const int rel = sphere_all<true>(w, t, true, true);
            if (s.sph_dirty & 1) {
                s = t;
                s.sph_dirty = rel;
            }
        }
    } else if (has_sph && (s.sph_dirty & 1)) {
        s.sph_dirty = sphere_all(w, s, true, true);
    }
    const int cls = s.ent & 0xF;
    const bool is_ramp = bit(RAMPS, cls);
    const bool has_aux = s.aux_dist != -1.0f;
    fire = has_sph ? fmax_nan(s.aux_dist, s.aux_t0) : s.aux_dist;
    const bool sgt = s.cdist > fire;
    if (fire1) {
        // the event bodies' results, kept in registers and read only where
        // the cell's class asks
        Jump jf = portal_jump<T>(w, s);
        keep(jf.dpage);
        keep(jf.pkind);
        keep(jf.ldir);
        keep(jf.cx);
        keep(jf.cz);
        keep(jf.px);
        keep(jf.pz);
        keep(jf.vx);
        keep(jf.vz);
        if constexpr (P) {
            float tf = 0.0f, wf = 0.0f;
            ramp_tilt<true>(s, cls, tf, wf);
            keep(tf);
            keep(wf);
        } else if (has_sph) {
            int nr = sphere_rel(w, jf.px, jf.pz, jf.vx, jf.vz, jf.dpage);
            keep(nr);
        }
    }
    float tilt = 0.0f, wy_ramp = 0.0f;
    if (is_ramp) ramp_tilt<P>(s, cls, tilt, wy_ramp);
    const float ray_y2 = s.ry + tilt;
    if (is_ramp && has_aux && sgt) {         // the sphere exits first
        s.tmeta = T_SPHERE;
        s.ry = ray_y2;
        s.cdist = s.aux_dist;
        s.active = false;
        return O_TERM | O_SPHM;
    }
    const bool is_tall = bit(TALLS, cls);
    const bool is_fogc = bit(FOGC, cls);
    if (bit(FLOORISH, cls) || is_tall || is_ramp) {
        const float wx = s.wx, wz = s.wz;
        const Skip k = skip_of<P>(w, s);
        const float wy_tall = s.gy > 0 ? s.wy + s.iy : s.wy;
        const float wy = is_tall ? wy_tall : (is_ramp ? wy_ramp : s.wy);
        const bool ymin = wy < k.wxe && wy < k.wze;
        const bool xstep = !ymin && k.wxe < k.wze;
        const float t = ymin ? wy : (xstep ? k.wxe : k.wze);
        const int gsel = is_ramp ? s.gy : s.gx;
        const int ldir2 = ymin ? (s.gy < 0 ? FYN : FYP)
            : xstep ? (gsel < 0 ? FXN : FXP) : (s.gz < 0 ? FZN : FZP);
        const float cdist2 = s.cdist + t;
        const float p2x = s.px + s.rx * t;
        const float p2y = s.py + ray_y2 * t;
        const float p2z = s.pz + s.rz * t;
        if (!is_ramp && has_aux && cdist2 > fire) {   // sphere exit
            const float extra = (is_fogc && s.aux_dist > s.cdist)
                ? s.aux_dist - s.cdist : 0.0f;
            s.tmeta = T_SPHERE;
            s.cdist = s.aux_dist;
            s.fog = s.fog + extra;
            s.active = false;
            return O_TERM | O_SPHM;
        }
        const float fog2 = is_fogc ? s.fog + (cdist2 - s.cdist) : s.fog;
        if (ymin) {                          // floor, ceiling or ramp hit
            s.tmeta = T_WALL | ((is_ramp ? (ray_y2 >= 0.0f ? C_CEIL : C_FLOOR)
                                         : (s.gy > 0 ? C_CEIL : C_FLOOR))
                                << 2);
            s.px = p2x;
            s.py = p2y;
            s.pz = p2z;
            if (is_ramp) s.ry = ray_y2;
            s.cdist = cdist2;
            s.fog = fog2;
            s.ldir = is_ramp ? (ray_y2 < 0.0f ? FYN : FYP) : ldir2;
            s.active = false;
            return O_TERM | O_NEAR | O_MY2 | O_WALLT | (is_ramp ? 0 : O_FT);
        }
        // the X/Z step and the one fetch
        const float sub = xstep ? k.wxe : k.wze;
        const float wnx = xstep ? s.ix : wx - sub;
        float wny = wy - sub;
        const float wnz = xstep ? wz - sub : s.iz;
        if (is_tall && s.gy > 0) wny = wny - s.iy;
        const int cx2 = s.cx + (xstep ? s.gx * (1 + k.kx) : 0);
        const int cz2 = s.cz + (xstep ? 0 : s.gz * (1 + k.kz));
        const float ray_y3 = is_ramp ? ray_y2 - tilt : ray_y2;
        if (is_ramp) wny = (ray_y3 >= 0.0f ? 1.0f - p2y : p2y) * s.iy;
        int f_next = fetch<T>(w, cx2, cz2, s.page);
        if (probe_of<V>(w) == VAR_FETCH2X) {
            // a second fetch at a runtime-equal index (tracer_core.py:1082)
            const int dup = fetch<T>(w, cx2, cz2 + (opq ? 0 : 1), s.page);
            f_next = opq ? f_next : dup;
        }
        // transitions: a step between a lower and a 2-high cell moves the
        // ray's Y line (tr)
        const int ncls = f_next & 0xF;
        float pos3y = p2y;
        bool tr = false;
        if (cls == LOWER && bit(TALLS, ncls)) {
            pos3y = pos3y + 1.0f;
            wny = s.gy < 0 ? wny + s.iy : wny - s.iy;
            tr = true;
        }
        if (is_tall && ncls == LOWER) {
            pos3y = pos3y - 1.0f;
            wny = s.gy > 0 ? wny + s.iy : wny - s.iy;
            tr = true;
        }
        // the 2-high wall check
        const int xc = (f_next >> 4) & 3;
        const bool chk = is_tall && (pos3y < 0.0f || pos3y > 1.0f);
        if (chk && xc == 2) {
            pos3y = pos3y + 1.0f;
            wny = s.gy > 0 ? wny - s.iy : wny + s.iy;
        }
        s.px = p2x;
        s.py = pos3y;
        s.pz = p2z;
        s.cdist = cdist2;
        s.fog = fog2;
        const bool shift = (tr || is_ramp) && (s.sph_dirty & 2);
        const int o_step = (xstep ? O_XSTEP : O_ZSTEP)
            | (is_ramp ? 0 : O_FT);
        if (chk && xc != 1) {                // a 2-high wall
            s.tmeta = T_WALL | (C_WALL << 2);
            s.ldir = ldir2;
            s.active = false;
            if (shift) line_change<P>(w, s, s.sph_dirty | 1);
            return o_step | O_TERM | O_NEAR | O_WALLT;
        }
        s.ent = f_next;
        s.ry = ray_y3;
        s.wx = wnx;
        s.wy = wny;
        s.wz = wnz;
        s.cx = cx2;
        s.cz = cz2;
        s.ldir = is_ramp ? (xstep ? (s.rx < 0.0f ? FXN : FXP)
                                  : (s.rz < 0.0f ? FZN : FZP))
                         : ldir2;
        if (shift) line_change<P>(w, s, s.sph_dirty | 1);
        return o_step | O_CONT;
    }
    if (cls != PORTAL && cls != WALL) return 0;
    const Jump j = cls == PORTAL ? portal_jump<T>(w, s) : Jump{};
    if (cls == PORTAL && j.pkind == 1) {     // through the portal
        s.ent = fetch<T>(w, j.cx, j.cz, j.dpage);
        if (probe_of<V>(w) == VAR_FETCH2X) {
            const int dup = fetch<T>(w, j.cx, j.cz + (opq ? 0 : 1), j.dpage);
            s.ent = opq ? s.ent : dup;
        }
        s.page = j.dpage;
        s.px = j.px;
        s.pz = j.pz;
        s.rx = j.vx;
        s.rz = j.vz;
        s.wx = j.wx;
        s.wz = j.wz;
        s.ix = j.ix;
        s.iz = j.iz;
        s.gx = j.gx;
        s.gz = j.gz;
        s.cx = j.cx;
        s.cz = j.cz;
        s.ldir = j.ldir;
        // the line past the portal: its sphere relevance
        if (has_sph)
            line_change<P>(w, s, sphere_rel(w, s.px, s.pz, s.rx, s.rz,
                                            s.page) ? 3 : 0);
        return O_PGO;
    }
    if (cls == WALL || j.pkind >= 2) {       // a wall, a bad portal
        if (has_aux && sgt) {
            s.tmeta = T_SPHERE;
            s.cdist = s.aux_dist;
        } else {
            const int colid = cls == PORTAL
                ? (j.pkind == 3 ? C_MAGENTA : C_WALL)
                : (s.ldir == FYP ? C_CEIL : C_WALL);
            s.tmeta = T_WALL | (colid << 2);
        }
        s.active = false;
        return O_TERM | (has_aux && sgt ? O_SPHM : O_WALLT);
    }
    return 0;
}

// One DDA step of an active lane, in the instance's mode: step_core, for
// the pad instances the pad over segment_body's operands (the step's
// starting state, its X/Z distances past the skip) and the masks of the
// lane's outcome, then the end-of-iteration sphere check, in
// segment_body's order.
template <bool P, int V, bool T>
__device__ __forceinline__ void dda_step(const World& w, Seg& s) {
    float fire;
    bool padded = false;
    if constexpr (is_pad(V) || V == VAR_FLAGS) padded = is_pad(probe_of<V>(w));
    if (padded) {
        const int cls = s.ent & 0xF;
        const bool is_ramp = bit(RAMPS, cls);
        const bool is_tall = bit(TALLS, cls);
        float tilt = 0.0f, wy_ramp = 0.0f;
        if (is_ramp) ramp_tilt<P>(s, cls, tilt, wy_ramp);
        const Skip k = skip_of<P>(w, s);
        const float wy = is_tall ? (s.gy > 0 ? s.wy + s.iy : s.wy)
                                 : (is_ramp ? wy_ramp : s.wy);
        const bool ymin = wy < k.wxe && wy < k.wze;
        const bool xmin = !ymin && k.wxe < k.wze;
        const float t = ymin ? wy : (xmin ? k.wxe : k.wze);
        const float vs[8] = {s.px, s.py, s.pz, s.rx, s.ry, s.rz, s.wx, s.wz};
        const float mul = s.rx, add = s.pz + s.rz * t;
        const bool opq = s.cdist > -1e30f;
        const int o = step_core<P, V, T>(w, s, fire);
        const bool ms[8] = {(o & O_XSTEP) != 0, (o & O_ZSTEP) != 0,
                            (o & O_TERM) != 0, (o & O_PGO) != 0,
                            (o & O_CONT) != 0, (o & O_MY2) != 0, ymin, xmin};
        const bool ns[8] = {cls == WALL, is_tall, is_ramp, cls == PORTAL,
                            (o & O_FT) != 0, (o & O_NEAR) != 0,
                            (o & O_SPHM) != 0, (o & O_WALLT) != 0};
        apply_pad<V>(w, vs, mul, add, ms, ns, opq, s.fog, s.tmeta);
    } else {
        step_core<P, V, T>(w, s, fire);
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
// shade_and_bounce) up to the reflect jitter, the only part that draws
// random numbers.  icol: the parent's base colour; on return (fx, fy, fz)
// hold the bounce ray's origin and (mrx, mry, mrz) its direction before
// the jitter.  VAR_NOWATER (and VAR_FLAGS with FLAG_NOWATER): the flat
// floor normal (0, 1, 0), not normalised (tracer_core.py:1719-1722).
template <bool P, int V = VAR_NONE>
__device__ __forceinline__ Shade shade_hit(const World& w, const Seg& s,
                                           const float icol[4], float sec,
                                           bool depth_ok, float& fx,
                                           float& fy, float& fz,
                                           float& mrx_o, float& mry_o,
                                           float& mrz_o) {
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
    if (nowater<V>(w) && is_water) {
        nx = 0.0f;
        ny = 1.0f;
        nz = 0.0f;
    } else if (is_water) {
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
    mrx_o = mrx;
    mry_o = mry;
    mrz_o = mrz;
    fx = mpx;
    fy = mpy;
    fz = mpz;
    return o;
}

// The reflect blur of a bounce direction: 5 draws, 2 discarded
// (trace.h:77-84)
__device__ __forceinline__ void jitter(uint32_t& seed, float inv_mod,
                                       float mrx, float mry, float mrz,
                                       float& rx_o, float& ry_o,
                                       float& rz_o) {
    const float rb = 0.03f;
    rx_o = mrx + randfs(seed, inv_mod) * rb;
    ry_o = mry + randfs(seed, inv_mod) * rb;
    randfs(seed, inv_mod);
    rz_o = mrz + randfs(seed, inv_mod) * rb;
    randfs(seed, inv_mod);
}

// shade_hit and the jitter: on return (fx..rz) hold the bounce ray's
// origin and direction
template <bool P, int V = VAR_NONE>
__device__ Shade shade(const World& w, const Seg& s, const float icol[4],
                       uint32_t& seed, float sec, bool depth_ok,
                       float inv_mod, float& fx, float& fy, float& fz,
                       float& rx_o, float& ry_o, float& rz_o) {
    float mrx, mry, mrz;
    const Shade o = shade_hit<P, V>(w, s, icol, sec, depth_ok, fx, fy, fz,
                                    mrx, mry, mrz);
    jitter(seed, inv_mod, mrx, mry, mrz, rx_o, ry_o, rz_o);
    return o;
}

__device__ __forceinline__ uint32_t pack_chan(float c, int shift) {
    const float v = c * 255.0f;
    if (v >= 2147483648.0f || v != v) return 0u;
    const float r = fminf(fmaxf(rintf(v), 0.0f), 255.0f);
    return ((uint32_t)r) << shift;
}

// Kernel arguments (one struct, so every entry point shares a launcher)
struct Params {
    const float *ox, *oy, *oz, *dx, *dy, *dz;
    const int32_t* seeds;
    const int32_t* ent;
    const int32_t* word;
    const float* sph;
    const float* bound;       // fast mode only
    const int32_t* buckets;   // parity mode only
    const uint16_t* sse;      // parity mode only: compact SSE tables
    int n, n_spheres, k_bucket, maxsteps, reflect, skip;
    int n_pages, sphere_page, page0;
    int samples;              // bounce chains a ray
    int fused, step_chunk;    // the fused wave loop, and its cap's chunk
    float sec, slack, inv_mod;
    float inv;                // f32(1 / samples), rounded on the host
    int32_t* out_fb;
    float* out_dist;
    int32_t* out_tstep;       // VAR_PROFILE: [reflect + 1, n];
                              // VAR_PHASES: the counters
    // the warps' work (set_tiles): n_tiles tiles of WARP rays, 8x4-pixel
    // tiles of a [rows, width] image (tiles_x tiles a tile row), or runs
    // of WARP consecutive rays when tiles_x is 0
    int width, rows, tiles_x, n_tiles;
    int* queue;               // [2] next tile, blocks done (0 after)
    int* query;               // set: report the launch here, do not launch
    float* out_col;           // set: the colour unpacked, f32 [4, n] (B, G,
                              // R, A planes), in place of out_fb
    int flags;                // VAR_FLAGS: its knobs (FLAG_*, a probe)
};

// Weyl increment between the seed streams of two samples
// (tracer_core.py:1810)
constexpr uint32_t WEYL = 0x9E3779B9u;

// Offsets in 4-byte words into the dynamic shared memory, in order: (T)
// the one-page cell tables ent and word, the sphere records, (P) the
// compact SSE tables, then (unless F) the unwind records, REC floats a
// wave for each of the block's threads, [wave][record][thread].
template <bool T>
__host__ __device__ constexpr int off_sph() {
    return T ? 2 * CELLS : 0;
}
template <bool T>
__host__ __device__ constexpr int off_sse() {
    return off_sph<T>() + NSPH_MAX * SPH_COLS;
}
template <bool P, bool T>
__host__ __device__ constexpr int off_rec() {
    return off_sse<T>() + (P ? SSE_BYTES / 4 : 0);
}
template <bool P, bool S, bool F, bool T>
__host__ __device__ constexpr size_t smem_bytes(int n_waves) {
    return sizeof(uint32_t) * (off_rec<P, T>()
        + (F ? 0 : n_waves * REC * Block<P, S, F>::threads));
}

// ---- the tables' bulk copy: one TMA transfer a table, completing on an
// mbarrier in shared memory ----
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive once, expecting `bytes` of transfers
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// global -> shared, `bytes` a multiple of 16 from 16-byte aligned addresses
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::"
                 "complete_tx::bytes [%0], [%1], %2, [%3];\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(bytes),
                    "r"(smem_addr(bar)) : "memory");
}

// wait until the barrier's phase `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done = 0;
    while (!done) {
        asm volatile("{\n\t.reg .pred p;\n\t"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
                     "%2;\n\t"
                     "selp.u32 %0, 1, 0, p;\n\t}\n"
                     : "=r"(done) : "r"(smem_addr(bar)), "r"(parity)
                     : "memory");
    }
}

// Start a segment from origin (fx, fy, fz) along (rx, ry, rz) on `page`:
// its marching state and, in fast mode, its line's sphere candidates
// (tracer_core.run_segment's prologue)
template <bool P, bool T>
__device__ __forceinline__ void start(const World& w, const Params& a,
                                      Seg& s, float fx, float fy, float fz,
                                      float rx, float ry, float rz,
                                      int page) {
    init_segment<P, T>(w, s, fx, fy, fz, rx, ry, rz, true, page);
    if (!P && a.n_spheres > 0)
        s.sph_dirty = sphere_all(w, s, true, false);
}

// March one segment until it terminates or the step budget runs out
// (tracer_core.run_segment).  profiles(V) returns the terminal step count
// (tracer_core.py:1436-1456): step + 1 on the step the ray died, maxsteps
// if the budget ran out; the other instances return 0.
template <bool P, int V, bool T>
__device__ __forceinline__ int march(const World& w, const Params& a,
                                     Seg& s, float fx, float fy, float fz,
                                     float rx, float ry, float rz,
                                     int page) {
    const long long t_march = phase_clock<V>();
    start<P, T>(w, a, s, fx, fy, fz, rx, ry, rz, page);
    int tstep = 0;
    unsigned steps_cycles = 0;     // VAR_PHASES
    for (int step = 0; step < a.maxsteps && s.active; ++step) {
        const long long t0 = phase_clock<V>();
        dda_step<P, V, T>(w, s);
        phase_lead<V>(steps_cycles, t0);
        if constexpr (profiles(V)) {
            if (!s.active) tstep = step + 1;
        }
    }
    if (s.active) {
        s.tmeta = T_SKY;
        if constexpr (profiles(V)) tstep = a.maxsteps;
    }
    phase_sum<V>(w, PH_STEPS, steps_cycles);
    phase_add<V>(w, PH_MARCH, t_march);
    return tstep;
}

// Wave k's shaded colour, reflectance and fog to the thread's column of
// the unwind records (rec[(k * REC + c) * B], B the block's threads);
// icol gets the colour
template <int B>
__device__ __forceinline__ void record(float* rec, int k, const Shade& o,
                                       float icol[4]) {
    float* r = rec + k * REC * B;
    r[0] = o.b;
    r[B] = o.g;
    r[2 * B] = o.r;
    r[3 * B] = o.a;
    r[4 * B] = o.refl;
    r[5 * B] = o.fog;
    icol[0] = o.b;
    icol[1] = o.g;
    icol[2] = o.r;
    icol[3] = o.a;
}

// Backward unwind blend (tracer_core.py:1795-1801) of a chain whose last
// wave, `last`, has colour icol: every wave below it bounced; B: as
// record's
template <bool P, int B>
__device__ __forceinline__ void unwind(const float* rec, int last,
                                       const float icol[4], float col[4]) {
    for (int c = 0; c < 4; ++c) col[c] = icol[c];
    for (int k = last - 1; k >= 0; --k) {
        const float* r = rec + k * REC * B;
        const float refl = r[4 * B], fog = r[5 * B];
        const float fogf = m_exp<P>(-0.6f * fog);
        for (int c = 0; c < 4; ++c) {
            const float blended = col[c] * refl
                + r[c * B] * (1.0f - refl);
            col[c] = fog != 0.0f ? blended * fogf + (1.0f - fogf)
                                 : blended;
        }
    }
}

// One bounce chain (trace_wave_env's chain, tracer_core.py:1774-1802):
// shade the finished primary segment s0 with this chain's seed, march
// waves 1..reflect (each on the page where the wave before it ended)
// until a wave does not bounce, then unwind the blend backward into col.
// Wave k's shaded colour, reflectance and fog go to rec[(k * REC + c) *
// B], the thread's column of the block's unwind records in shared memory
// (B: the block's threads), where no run-time index sends them to local
// memory.  profiles(V): ts[k] gets wave k's terminal step count (k >= 1).
template <bool P, int V, bool T, int B>
__device__ __forceinline__ void chain(const World& w, const Params& a,
                                      const Seg& s0, uint32_t seed,
                                      float col[4], float* rec,
                                      int* ts = nullptr) {
    float icol[4] = {1.0f, 1.0f, 1.0f, 1.0f};
    float fx, fy, fz, rx, ry, rz;
    const int n_waves = a.reflect + 1;
    int last = 0;
    Seg s = s0;
    for (int k = 0; k < n_waves; ++k) {
        if (k > 0) {
            const int t = march<P, V, T>(w, a, s, fx, fy, fz, rx, ry, rz,
                                         s.page);
            if constexpr (profiles(V)) ts[k] = t;
        }
        const long long t0 = phase_clock<V>();
        const Shade o = shade<P, V>(w, s, icol, seed, a.sec, k < a.reflect,
                                    a.inv_mod, fx, fy, fz, rx, ry, rz);
        record<B>(rec, k, o, icol);
        phase_add<V>(w, PH_SHADE, t0);
        last = k;
        if (!o.bounce) break;
    }
    const long long t0 = phase_clock<V>();
    unwind<P, B>(rec, last, icol, col);
    phase_add<V>(w, PH_UNWIND, t0);
}

// Sample chain k of trace_ray's samples loop from the primary segment's
// shading (shade_hit: it draws no random number, so it is the same in
// every chain), which stays in the unwind records' wave 0 (its colour,
// reflectance and fog) and in registers (bounce, whether it bounces; its
// bounce origin px, py, pz, mirrored ray mx, my, mz and end page): the
// jitter with this chain's seed, then waves 1..reflect and the unwind as
// chain() runs them.  B: as chain's; V: the measurement instance.
template <bool P, int V, bool T, int B>
__device__ __forceinline__ void chain_from(const World& w, const Params& a,
                                           bool bounce, float px, float py,
                                           float pz, float mx, float my,
                                           float mz, int page,
                                           uint32_t seed, float col[4],
                                           float* rec) {
    float icol[4] = {rec[0], rec[B], rec[2 * B], rec[3 * B]};
    int last = 0;
    if (bounce) {
        float fx = px, fy = py, fz = pz, rx, ry, rz;
        jitter(seed, a.inv_mod, mx, my, mz, rx, ry, rz);
        Seg s;
        for (int k = 1; k <= a.reflect; ++k) {
            march<P, V, T>(w, a, s, fx, fy, fz, rx, ry, rz, page);
            const Shade o = shade<P, V>(w, s, icol, seed, a.sec,
                                        k < a.reflect, a.inv_mod, fx, fy,
                                        fz, rx, ry, rz);
            record<B>(rec, k, o, icol);
            last = k;
            page = s.page;
            if (!o.bounce) break;
        }
    }
    unwind<P, B>(rec, last, icol, col);
}

// The fused wave loop (tracer_core.run_fused, _process_deaths), fast mode,
// one sample: the state a ray carries from one segment to the next.  The
// unwind blend is carried forward as an affine, col = acc_a + acc_b *
// child; a final colour is composed into acc_a.
struct Fused {
    int wave = 0;                       // segment index (0: the primary)
    int it = 0;                         // iterations of run_fused's loop
    uint32_t seed;
    float icol[4] = {1.0f, 1.0f, 1.0f, 1.0f};
    float acc_a[4] = {0.0f, 0.0f, 0.0f, 0.0f}, acc_b = 1.0f;
    float dist0 = 0.0f;
    bool done = false;
};

// Shade the segment that s finished; finalize the colour or compose this
// wave's blend into the affine and restart s on the bounce ray; V: the
// measurement instance
template <int V, bool T>
__device__ __forceinline__ void fused_death(const World& w, const Params& a,
                                            Seg& s, Fused& f) {
    float fx, fy, fz, rx, ry, rz;
    const Shade o = shade<false, V>(w, s, f.icol, f.seed, a.sec,
                                 f.wave < a.reflect, a.inv_mod, fx, fy, fz,
                                 rx, ry, rz);
    if (f.wave == 0) f.dist0 = s.cdist;
    const float base[4] = {o.b, o.g, o.r, o.a};
    if (!o.bounce) {
        for (int c = 0; c < 4; ++c)
            f.acc_a[c] = f.acc_a[c] + base[c] * f.acc_b;
        f.done = true;
        return;
    }
    // refl * child + (1 - refl) * base, then f * blended + (1 - f) only
    // where fog != 0
    float ab[4], bb = o.refl;
    for (int c = 0; c < 4; ++c) ab[c] = base[c] * (1.0f - o.refl);
    if (o.fog != 0.0f) {
        const float fogf = expf(-0.6f * o.fog);
        for (int c = 0; c < 4; ++c) ab[c] = ab[c] * fogf + (1.0f - fogf);
        bb = bb * fogf;
    }
    for (int c = 0; c < 4; ++c) {
        f.acc_a[c] = f.acc_a[c] + ab[c] * f.acc_b;
        f.icol[c] = base[c];
    }
    f.acc_b = f.acc_b * bb;
    start<false, T>(w, a, s, fx, fy, fz, rx, ry, rz, s.page);
    ++f.wave;
}

// The fused loop of the ray from (fx, fy, fz) along (rx, ry, rz): col
// gets its final colour (0 if the cap cut it short).  run_fused steps a
// lane in every iteration it is live and shades a segment that ended at
// the start of the next iteration, so a lane's result depends only on
// its own iteration count.  Here each lane marches its segment to its
// end, counting run_fused's iterations (f.it), and the warp's lanes then
// shade together, once a segment, as the one-chain instances do: the
// same bits, with the cap maxsteps * n_waves + 8 * n_waves rounded up to
// step_chunk held per lane.  A segment the cap cuts is never shaded; one
// that ends on the last iteration is shaded (the drain) and its restart
// never steps.  V: the measurement instance.
template <int V, bool T>
__device__ __forceinline__ void fused(const World& w, const Params& a,
                                      float fx, float fy, float fz,
                                      float rx, float ry, float rz,
                                      Fused& f, float col[4]) {
    Seg s;
    start<false, T>(w, a, s, fx, fy, fz, rx, ry, rz, a.page0);
    const int n_waves = a.reflect + 1;
    const int chunk = max(a.step_chunk, 1);
    const int cap = a.maxsteps * n_waves + 8 * n_waves;
    const int n_it = (cap + chunk - 1) / chunk * chunk;
    while (true) {
        for (int segsteps = 0; s.active && f.it < n_it;) {
            dda_step<false, V, T>(w, s);
            ++f.it;
            // the per-segment step budget -> sky (trace.h:247,678)
            if (s.active && ++segsteps >= a.maxsteps) {
                s.tmeta = T_SKY;
                s.active = false;
            }
        }
        if (s.active) break;            // cut by the cap: not shaded
        fused_death<V, T>(w, a, s, f);
        if (f.done || f.it >= n_it) break;
    }
    for (int c = 0; c < 4; ++c) col[c] = f.done ? f.acc_a[c] : 0.0f;
}

// Trace ray i and write its packed colour and primary distance.  S:
// a.samples > 1.  The primary wave consumes no RNG, so it is marched and
// shaded once (shade_hit, its record rec[0]) and only its shading's
// results are kept; each sample k runs its chain from them with seed +
// k*WEYL (chain_from), the chains' colours are summed in sample order
// ((c0 + c1) + c2) + ..., and the sum is scaled by the host's f32(1 /
// samples) before the pack (tracer_core.py:1804-1817).  S = false is the
// one-chain trace.  F: the fused wave loop (P = S = false).  V: a
// measurement instance (VAR_*), whose per-wave step counts (profiles(V))
// go to out_tstep in the one-chain trace where it is set.  The colour is
// packed to out_fb, or with out_col set written there unpacked.
template <bool P, bool S, bool F, int V, bool T>
__device__ __forceinline__ void trace_ray(const World& w, const Params& a,
                                          int i, float* rec) {
    constexpr int B = Block<P, S, F>::threads;
    const uint32_t seed = (uint32_t)a.seeds[i];
    float col[4], dist0;
    if constexpr (F) {
        Fused f;
        f.seed = seed;
        fused<V, T>(w, a, a.ox[i], a.oy[i], a.oz[i], a.dx[i], a.dy[i],
                    a.dz[i], f, col);
        dist0 = f.dist0;
    } else if constexpr (S) {
        Seg s;
        march<P, V, T>(w, a, s, a.ox[i], a.oy[i], a.oz[i], a.dx[i],
                             a.dy[i], a.dz[i], a.page0);
        // the distance now: it need not stay live across the chains
        a.out_dist[i] = s.cdist;
        const float one[4] = {1.0f, 1.0f, 1.0f, 1.0f};
        float px, py, pz, mx, my, mz, icol[4];
        const Shade o0 = shade_hit<P, V>(w, s, one, a.sec, 0 < a.reflect,
                                         px, py, pz, mx, my, mz);
        record<B>(rec, 0, o0, icol);
        for (int k = 0; k < a.samples; ++k) {
            float c[4];
            chain_from<P, V, T, B>(w, a, o0.bounce, px, py, pz, mx, my, mz,
                                   s.page, seed + (uint32_t)k * WEYL, c,
                                   rec);
            for (int j = 0; j < 4; ++j)
                col[j] = k == 0 ? c[j] : col[j] + c[j];
        }
        for (int j = 0; j < 4; ++j) col[j] = col[j] * a.inv;
    } else {
        Seg s;
        int ts[profiles(V) ? MAX_WAVES : 1] = {};
        ts[0] = march<P, V, T>(w, a, s, a.ox[i], a.oy[i], a.oz[i], a.dx[i],
                               a.dy[i], a.dz[i], a.page0);
        dist0 = s.cdist;
        chain<P, V, T, B>(w, a, s, seed, col, rec, ts);
        if constexpr (profiles(V)) {
            if (a.out_tstep)
                for (int k = 0; k <= a.reflect; ++k)
                    a.out_tstep[(size_t)k * a.n + i] = ts[k];
        }
    }
    if constexpr (!S) a.out_dist[i] = dist0;
    if (a.out_col) {
        for (int c = 0; c < 4; ++c) a.out_col[(size_t)c * a.n + i] = col[c];
    } else {
        a.out_fb[i] = (int32_t)(pack_chan(col[0], 0) | pack_chan(col[1], 8)
                                | pack_chan(col[2], 16)
                                | pack_chan(col[3], 24));
    }
}

// The ray that `lane` of the warp holding `tile` traces, or -1 (a masked
// lane of a ragged tile, or a tile past the last).  ops/tracer.py:
// warp_tiles is the same map.
__device__ __forceinline__ int tile_ray(const Params& a, int tile,
                                        int lane) {
    if (tile >= a.n_tiles) return -1;
    if (a.tiles_x == 0) {
        const int i = tile * WARP + lane;
        return i < a.n ? i : -1;
    }
    const int ty = tile / a.tiles_x;
    const int x = (tile - ty * a.tiles_x) * TILE_W + lane % TILE_W;
    const int y = ty * TILE_H + lane / TILE_W;
    return x < a.width && y < a.rows ? y * a.width + x : -1;
}

// Persistent warps, which take tiles off a queue, for the instances whose
// rays run several chains or the fused loop; one tile a warp, block b
// holding tiles b * warps .. + warps - 1, for the one-chain instances.
template <bool P, bool S, bool F>
__host__ __device__ constexpr bool persistent() {
    return S || F;
}

// lane 0 takes the next tile off the queue; every lane gets it
__device__ __forceinline__ int take_tile(int* queue, int lane) {
    int tile = 0;
    if (lane == 0) tile = atomicAdd(queue, 1);
    return __shfl_sync(0xffffffffu, tile, 0);
}

// The block's prologue loads what every ray reads: by bulk copies, (T)
// the one-page cell tables and (P) the compact SSE tables; the sphere
// records by the block's threads.  VAR_PHASES (one tile a warp) adds its
// counters to out_tstep, read as u64 [PHASE_ROWS, N_PHASES].
template <bool P, bool S, bool F, int V, bool T>
__global__ void __launch_bounds__(Block<P, S, F>::threads,
                                  Block<P, S, F>::min_blocks)
trace_kernel(const Params a) {
    const long long t_kernel = phase_clock<V>();
    constexpr int threads = Block<P, S, F>::threads;
    constexpr uint32_t bulk = (T ? 2 * CELLS * sizeof(int32_t) : 0)
        + (P ? SSE_BYTES : 0);
    __shared__ uint64_t tables_ready;
    float* sph = reinterpret_cast<float*>(smem + off_sph<T>());
    uint32_t* sse = smem + off_sse<T>();
    if constexpr (bulk > 0) {
        if (threadIdx.x == 0) {
            mbar_init(&tables_ready);
            mbar_expect(&tables_ready, bulk);
            if constexpr (T) {
                bulk_load(smem, a.ent, CELLS * sizeof(int32_t),
                          &tables_ready);
                bulk_load(smem + CELLS, a.word, CELLS * sizeof(int32_t),
                          &tables_ready);
            }
            if constexpr (P) bulk_load(sse, a.sse, SSE_BYTES, &tables_ready);
        }
    }
    for (int k = threadIdx.x; k < a.n_spheres * SPH_COLS; k += threads)
        sph[k] = a.sph[k];
    __syncthreads();     // also publishes the initialised barrier
    if constexpr (bulk > 0) mbar_wait(&tables_ready, 0);

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
        w.sse = reinterpret_cast<const uint16_t*>(sse);
    } else {
        w.bx = a.bound[0];
        w.bz = a.bound[2];
        w.brq2 = a.bound[3] * a.bound[3] + a.slack;
        w.skip = a.skip != 0;
        w.buckets = nullptr;
        w.k_bucket = 0;
        w.sse = nullptr;
    }
    if constexpr (V == VAR_PHASES) {
        w.phases = reinterpret_cast<unsigned long long*>(a.out_tstep);
        phase_add<V>(w, PH_PROLOGUE, t_kernel);
    }
    if constexpr (V == VAR_FLAGS) w.flags = a.flags;
    float* rec = reinterpret_cast<float*>(smem + off_rec<P, T>())
        + threadIdx.x;
    const int lane = threadIdx.x % WARP;
    if constexpr (persistent<P, S, F>()) {
        for (int tile = take_tile(a.queue, lane); tile < a.n_tiles;
             tile = take_tile(a.queue, lane)) {
            const int i = tile_ray(a, tile, lane);
            if (i >= 0) trace_ray<P, S, F, V, T>(w, a, i, rec);
        }
        // the last block to finish resets the queue for the next launch:
        // every other warp has taken its last tile by then
        __syncthreads();
        if (threadIdx.x == 0) {
            __threadfence();
            if (atomicAdd(a.queue + 1, 1) == (int)gridDim.x - 1) {
                atomicExch(a.queue, 0);
                atomicExch(a.queue + 1, 0);
            }
        }
    } else {
        const int i = tile_ray(
            a, blockIdx.x * Block<P, S, F>::warps + threadIdx.x / WARP,
            lane);
        const long long t0 = phase_clock<V>();
        if (i >= 0) trace_ray<P, S, F, V, T>(w, a, i, rec);
        phase_add<V>(w, PH_TILE, t0);
        phase_add<V>(w, PH_KERNEL, t_kernel);
    }
}

// The warps' work for n rays of an image `width` wide (0: not an image):
// 8x4-pixel tiles where width divides n, else runs of WARP rays.
__host__ inline void set_tiles(Params& a, int width) {
    const bool image = width > 0 && a.n % width == 0;
    a.width = image ? width : 0;
    a.rows = image ? a.n / width : 0;
    a.tiles_x = image ? (width + TILE_W - 1) / TILE_W : 0;
    a.n_tiles = image ? a.tiles_x * ((a.rows + TILE_H - 1) / TILE_H)
                      : (a.n + WARP - 1) / WARP;
}

constexpr int MAX_DEVICES = 64;

// Launch instance <P, S, F, V, T>: a block for every warps tiles, or, for
// the persistent instances, as many blocks as stay resident (the
// occupancy calculator's blocks an SM, computed once a device and wave
// count, times the SMs) when there are more tiles.  With a.query set,
// write there what the launch takes - dynamic shared memory bytes a
// block, resident blocks an SM, threads a block, blocks - and do not
// launch.
template <bool P, bool S, bool F, int V, bool T>
int launch_tiles(const Params& a, void* stream) {
    // the dynamic shared memory each device allows this instance so far,
    // and its resident blocks an SM by wave count
    static int allowed[MAX_DEVICES];
    static int per_sm[MAX_DEVICES][MAX_WAVES + 1];
    static int sms[MAX_DEVICES];
    const auto kernel = trace_kernel<P, S, F, V, T>;
    constexpr int threads = Block<P, S, F>::threads;
    constexpr int warps = Block<P, S, F>::warps;
    const int n_waves = a.reflect + 1;
    const int smem = (int)smem_bytes<P, S, F, T>(n_waves);
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    if (smem > 48 * 1024 && smem > allowed[dev]) {
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
        allowed[dev] = smem;
    }
    if (per_sm[dev][n_waves] == 0) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm[dev][n_waves], kernel, threads, smem);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(
                &sms[dev], cudaDevAttrMultiProcessorCount, dev);
        if (err != cudaSuccess) return (int)err;
        if (per_sm[dev][n_waves] <= 0)
            return (int)cudaErrorInvalidConfiguration;
    }
    int grid = (a.n_tiles + warps - 1) / warps;
    if (persistent<P, S, F>() && grid > per_sm[dev][n_waves] * sms[dev])
        grid = per_sm[dev][n_waves] * sms[dev];
    if (a.query) {
        a.query[0] = smem;
        a.query[1] = per_sm[dev][n_waves];
        a.query[2] = threads;
        a.query[3] = grid;
        return 0;
    }
    if (persistent<P, S, F>() && a.queue == nullptr)
        return (int)cudaErrorInvalidValue;
#ifdef __CUDACC__   // csrc/host compiles this file without a launch
    kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(a);
#endif
    return (int)cudaGetLastError();
}

// A one-page world takes the instance with its cell tables in shared
// memory, in both modes; a paged world's stay in the read-only cache.
// A table that a bulk copy loads (the one-page ent and word, parity's
// compact SSE tables) must be 16-byte aligned.
template <bool P, bool S, bool F = false, int V = VAR_NONE>
int launch_instance(const Params& a, void* stream) {
    if (P && (uintptr_t)a.sse % 16 != 0)
        return (int)cudaErrorMisalignedAddress;
    if (a.n_pages > 1) return launch_tiles<P, S, F, V, false>(a, stream);
    if (((uintptr_t)a.ent | (uintptr_t)a.word) % 16 != 0)
        return (int)cudaErrorMisalignedAddress;
    return launch_tiles<P, S, F, V, true>(a, stream);
}

// The entry points' one argument, which ops/tracer.py packs (_ARGS):
// the pointers, then the 32-bit ints, then the floats, so that no field
// is padded.  parity selects the parity instances, variant the
// measurement instance (VAR_*) of the measurement entries and flags
// VAR_FLAGS's knobs; out_col set: the colour unpacked (Params.out_col);
// query set: report the launch there and do not launch (launch_tiles).
struct Args {
    const void *ox, *oy, *oz, *dx, *dy, *dz, *seeds, *ent, *word, *sph,
        *bound, *buckets, *sse;
    void *out_fb, *out_dist, *out_tstep, *queue, *query, *out_col;
    int32_t n, n_spheres, k_bucket, maxsteps, reflect, skip, n_pages,
        sphere_page, page0, samples, fused, step_chunk, width, parity,
        variant, flags;
    float sec, slack, inv_mod, inv;
};
static_assert(sizeof(Args) == 19 * 8 + 16 * 4 + 4 * 4,
              "Args must match ops/tracer.py's _ARGS");

__host__ inline Params params_of(const Args& g) {
    Params a = {};
    a.ox = (const float*)g.ox;
    a.oy = (const float*)g.oy;
    a.oz = (const float*)g.oz;
    a.dx = (const float*)g.dx;
    a.dy = (const float*)g.dy;
    a.dz = (const float*)g.dz;
    a.seeds = (const int32_t*)g.seeds;
    a.ent = (const int32_t*)g.ent;
    a.word = (const int32_t*)g.word;
    a.sph = (const float*)g.sph;
    a.bound = (const float*)g.bound;
    a.buckets = (const int32_t*)g.buckets;
    a.sse = (const uint16_t*)g.sse;
    a.n = g.n;
    a.n_spheres = g.n_spheres;
    a.k_bucket = g.k_bucket;
    a.maxsteps = g.maxsteps;
    a.reflect = g.reflect;
    a.skip = g.skip;
    a.n_pages = g.n_pages;
    a.sphere_page = g.sphere_page;
    a.page0 = g.page0;
    a.samples = g.samples;
    a.fused = g.fused;
    a.step_chunk = g.step_chunk;
    a.sec = g.sec;
    a.slack = g.slack;
    a.inv_mod = g.inv_mod;
    a.inv = g.inv;
    a.out_fb = (int32_t*)g.out_fb;
    a.out_dist = (float*)g.out_dist;
    a.out_tstep = (int32_t*)g.out_tstep;
    a.queue = (int*)g.queue;
    a.query = (int*)g.query;
    a.out_col = (float*)g.out_col;
    a.flags = g.flags;
    set_tiles(a, g.width);
    return a;
}

// The parameter checks of every entry point: out of range or a combination
// no instance runs -> true
__host__ inline bool bad_params(const Params& a, bool parity) {
    return a.n_spheres < 0 || a.n_spheres > NSPH_MAX || a.reflect < 0
        || a.reflect + 1 > MAX_WAVES || a.n_pages < 1 || a.n_pages > 16
        || a.sphere_page < 0 || a.sphere_page >= a.n_pages
        || a.page0 < 0 || a.page0 >= a.n_pages || a.samples < 1
        || (a.fused && (parity || a.samples != 1))
        || (parity && (a.k_bucket < 0 || (a.k_bucket > 0
                                          && a.n_spheres == 0)));
}

}  // namespace
