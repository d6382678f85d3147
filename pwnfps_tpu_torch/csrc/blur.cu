// Depth-of-field blur pass for Hopper (sm_90a).
//
// Replaces the TPU kernel pwnfps_tpu/ops/blur_pallas.py:_blur_kernel in
// both of its forms, with one kernel body, dof_blur_tiles:
//
//  * the full-frame form (_dof_blur_auto, blur_pallas.py:504), on one
//    frame or on C camera frames stacked vertically (frame_h,
//    blur_pallas.py:510-520): each frame is blurred within its own rows
//    - row seeds from the frame-local row, taps clamped to the frame,
//    fstr from frame_h - in one launch over all of them.  Bit-equal to
//    pwnfps_tpu_torch/ops/blur.py:dof_blur_plain (and so to
//    pwnfps_tpu/ops/blur.py:dof_blur of each frame alone).
//  * the band form (_dof_blur_band, blur_pallas.py:405-479) that the
//    multi-device path runs on each device's rows after a halo exchange:
//    cl cameras' bands of hb rows, each with H halo rows above and below,
//    in one launch.  Bit-equal to ops/blur.py:dof_blur_band_plain and so
//    to rows [y0, y0+hb) of the full-frame blur.  The caller decides that
//    the taps of real rows reach no further than the halo (the reach
//    check of parallel/sharding._dof_blur_mesh); the kernel clips the
//    flat tap index to the camera's buffer, as jnp.take(mode="clip")
//    does, so the rows past the frame (their taps clamp to the frame's
//    last row, which may lie outside the buffer) never read past it.
//
// The two forms differ only in their geometry (struct Form): a "unit" is
// a frame or a camera's band; its output rows, its source buffer's rows,
// and the frame row and source row of its first output row.  The TPU
// kernel's dyn/ring/v2 modes are VMEM scan structures with no
// counterpart here.
//
// What bounds the kernel on the H100: its own arithmetic.  DRAM asks 12
// bytes a pixel (the zbuf word, the framebuffer word, the output word;
// the taps hit cache), 7.5 us at 1080p; the first design (one thread a
// pixel, every tap and jump-table word a load from global memory, 22
// loads a pixel) took 29.4 us there.  Reading every tap from one
// address took 8% off it and hoisting the table 19%: the loads were not
// what bound it.  A pixel's two LCG jumps a tap (a multiply-add, a mask,
// a modulo by 3759 as multiply-high, shift and multiply-add), six float
// operations and a clamped truncation a coordinate come to some 170
// SASS instructions a pixel, most of them integer instructions, and a
// design that reads every tap from one shared word still takes 24.8 us
// at 1080p.
// PERF.md has the measured steps.  This design:
//
//  * Tiles.  A block of 256 threads covers a tile of TW columns (64, or
//    32 where 64-column tiles would leave more of the last one idle) and
//    TH rows of one unit; each thread owns one column and walks
//    TH * TW / 256 rows of it, unrolled.  Its 16 jump-table words do not
//    depend on the row (ops/blur.py:draw_tables), so it loads them once,
//    into registers, and its zbuf words once, into registers.
//  * A tap window in shared memory, in the 64 x 32 instance (1080p
//    frames).  The block takes its own reach, fstr x max |z - 1| over
//    its tile, and from it the window's radius r; it copies the source
//    rows and columns [tile +- r] (clamped to the unit's buffer) into
//    shared memory with cp.async (16-byte copies where the rows are
//    16-byte aligned, else 4-byte ones).  TMA is not used: the window is
//    a small ragged rectangle whose first column is not 16-byte aligned
//    in general, and cp.async needs no descriptor.  Over a reach of
//    RCAP - 2 the block stages nothing.  The other instances stage
//    nothing (stages_window): a 16-row tile's window of 16 + 2r rows
//    costs more to copy than its taps save (720p frames, the mesh's
//    bands), and the 160-wide camera frames' taps reach 7 px at most and
//    hit L1.
//  * Each tap's (txi, tyi) is computed as before (tap_xy; in the band
//    form the clipped flat index), and its word comes from the window
//    when it lies inside it, else from global memory.  A first pass over
//    a thread's rows reads the window only and has no branch, so the
//    compiler interleaves rows (window_blur); a pixel with a tap outside
//    the window is redone in a second pass that reads such taps from
//    global memory (mixed_blur).  Only the place a word is read from
//    changes, so the result is bit-equal by construction: no reach
//    estimate decides correctness.
//  * The truncation: two float clamps and an add rounded toward zero
//    (trunc_clamp), no conversion instruction.
//  * The tile height TH is 32 where that grid gives each SM six blocks,
//    else 16 (pick_th); the width and height come from the pass's shape
//    and the card's SM count alone: no host read of the data.  The TPU
//    kernel's near/wide choice through lax.cond has no counterpart.
//
// Numerics: every float operation of the reference's arithmetic is an
// explicit round-to-nearest intrinsic, so no multiply-add can contract
// whatever the compiler flags; the clamped truncation gives what XLA's
// saturating conversion (NaN to 0) and the clamp give.
//
// The functions above the kernel also build on the host (csrc/host/
// host_blur.cpp, tools/host_blur.py), which calls them one tile after
// another; the kernel and its launch are for nvcc only.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kMask31 = 0x7FFFFFFFu;
constexpr int NT = 256;                // threads a block
constexpr int RCAP = 24;               // widest window radius staged
constexpr int kMaxSide = 1 << 23;      // widest frame, tallest frame

// Whether tw x th tiles stage a tap window: only the 64 x 32 instance,
// which 1080p frames take; the others read every tap from global memory,
// where a window cost more than it saved (PERF.md: a 16-row
// tile's window spans 16 + 2r rows; the 160-wide camera frames, whose
// taps reach 7 px at most and hit L1, ran 11% faster without one)
__host__ __device__ constexpr bool stages_window(int tw, int th) {
    return tw == 64 && th == 32;
}

// Shared-memory words of the widest window of a tw x th tile, rows of
// tw + 2 * RCAP words (under the 48 KB a block has without opting in)
constexpr int window_words(int tw, int th) {
    return stages_window(tw, th) ? (th + 2 * RCAP) * (tw + 2 * RCAP) : 0;
}

// A pass's geometry: `units` frames or camera bands of `unit_rows`
// output rows each; unit u reads source rows [0, src_rows) of
// fb + u * src_rows * w, its output row lr is frame row yoff + lr and
// source row soff + lr, and its taps clamp to fh frame rows.
struct Form {
    const int32_t* fb;
    const float* zbuf;       // [units * unit_rows, w]
    const int32_t* tab;      // [16, w]
    int32_t* out;            // [units * unit_rows, w]
    int units, unit_rows, src_rows, w;
    int yoff, soff, fh;
    float fstr, inv2;        // inv2 = 2 * inv_mod (randfs_from_state)
    int vec;                 // rows 16-byte aligned: 16-byte staging
};

// Source rows [s0, s0 + wh) and columns [c0, c0 + ww) of a unit's
// buffer held in shared memory, row i at win[i * pitch]; wh = 0: none
struct Window {
    int s0, wh, c0, ww, pitch;
};

// One tile: unit, first output row within it, rows, first column,
// columns
struct Tile {
    int unit, lr0, nr, x0, tw;
};

__device__ __forceinline__ uint32_t avg_epu8(uint32_t a, uint32_t b) {
    return (a | b) - (((a ^ b) >> 1) & 0x7F7F7F7Fu);
}

// randfs of LCG state v: (v % 3759) * inv_mod * 2 - 1, rounded as the
// reference rounds it; inv2 = 2 * inv_mod, exact, and scaling by 2
// commutes with rounding (the product is normal or 0), so one multiply
// gives the two's bits
__device__ __forceinline__ float randfs_from_state(uint32_t v, float inv2) {
    return __fadd_rn(__fmul_rn((float)(v % 3759u), inv2), -1.0f);
}

// 31-bit base LCG state of blur row y: its seed y*y + 415135
// (screen.h:82), one draw on
__device__ __forceinline__ uint32_t row_state(int y) {
    const uint32_t s0 = (uint32_t)y * (uint32_t)y + 415135u;
    return (s0 * 25739u + 4u) & kMask31;
}

// min(max(__float2int_rz(t), 0), hi) for every float t (NaN to 0, as
// cvt.rzi's saturation gives it), without a conversion: t clamped to
// [0, hi] in float first (fmaxf drops a NaN), then c + 2^23 rounded
// toward zero holds floor(c) = trunc(c) in its low mantissa bits
// (0 <= c <= hi < 2^23, where the float spacing past 2^23 is 1)
__device__ __forceinline__ int trunc_clamp(float t, float hi) {
    const float c = fminf(fmaxf(t, 0.0f), hi);
    return __float_as_int(__fadd_rz(c, 8388608.0f)) - 0x4B000000;
}

// Column and row of tap i of pixel x in frame row yf (screen.h:92-117):
// the row's state s1 jumped to the tap's two draws (t16: the column's
// table words, draw_tables' rows 0-15), the offsets scaled by fstr and
// z = zbuf - 1, truncated and clamped to the w x fh frame (xmax = w - 1,
// ymax = fh - 1).
__device__ __forceinline__ void tap_xy(const uint32_t (&t16)[16],
                                       float xmax, float ymax, int i,
                                       uint32_t s1, float xf, float yf,
                                       float z, float fstr, float inv2,
                                       int& txi, int& tyi) {
    const float rx = randfs_from_state((s1 * t16[i] + t16[4 + i]) & kMask31,
                                       inv2);
    const float ry = randfs_from_state(
        (s1 * t16[8 + i] + t16[12 + i]) & kMask31, inv2);
    const float tx = __fadd_rn(xf, __fmul_rn(__fmul_rn(rx, fstr), z));
    const float ty = __fadd_rn(yf, __fmul_rn(__fmul_rn(ry, fstr), z));
    txi = trunc_clamp(tx, xmax);
    tyi = trunc_clamp(ty, ymax);
}

// Tile t of a pass cut into tw x th tiles, column tile bx
__device__ __forceinline__ Tile tile_of(const Form& f, int tw, int th,
                                        int t, int bx) {
    const int per = (f.unit_rows + th - 1) / th;
    Tile k;
    k.unit = t / per;
    k.lr0 = (t - k.unit * per) * th;
    k.nr = min(th, f.unit_rows - k.lr0);
    k.x0 = bx * tw;
    k.tw = tw;
    return k;
}

// The window a tile stages for its reach (fstr x max |z - 1| over its
// tile): r = (int)reach + 2 rows and columns around the tile, clamped to
// the buffer, columns widened to multiples of 4 for 16-byte copies; none
// over RCAP - 2 (an infinite reach included).
__device__ __forceinline__ Window window_of(const Form& f, const Tile& k,
                                            float reach) {
    Window v = {0, 0, 0, 0, k.tw + 2 * RCAP};
    if (!(reach <= (float)(RCAP - 2))) return v;
    const int r = (int)reach + 2;
    int c0 = max(k.x0 - r, 0), c1 = min(k.x0 + k.tw + r, f.w);
    if (f.vec) {                       // w % 4 == 0: c1 stays <= w
        c0 &= ~3;
        c1 = (c1 + 3) & ~3;
    }
    const int sr0 = f.soff + k.lr0;
    v.s0 = max(sr0 - r, 0);
    v.wh = min(sr0 + k.nr + r, f.src_rows) - v.s0;
    v.c0 = c0;
    v.ww = c1 - c0;
    return v;
}

__device__ __forceinline__ void copy16(int32_t* dst, const int32_t* src) {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(dst)),
                 "l"(src));
#else
    memcpy(dst, src, 16);
#endif
}

__device__ __forceinline__ void copy4(int32_t* dst, const int32_t* src) {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(dst)),
                 "l"(src));
#else
    *dst = *src;
#endif
}

// Copy the window's rows i = row0, row0 + drow, ... and, within each,
// its 16-byte (or 4-byte) pieces c = col0, col0 + dcol, ... from the
// unit's buffer src into win (the block's threads split the work; the
// host takes 0, 1, 0, 1).  The copies are asynchronous on the card:
// wait_copies() before reading.
__device__ __forceinline__ void stage(const Form& f, const int32_t* src,
                                      const Window& v, int32_t* win,
                                      int row0, int drow, int col0,
                                      int dcol) {
    const int n = f.vec ? v.ww >> 2 : v.ww;
    for (int i = row0; i < v.wh; i += drow) {
        const int32_t* g = src + (size_t)(v.s0 + i) * f.w + v.c0;
        int32_t* s = win + i * v.pitch;
        if (f.vec) {
            for (int c = col0; c < n; c += dcol) copy16(s + 4 * c, g + 4 * c);
        } else {
            for (int c = col0; c < n; c += dcol) copy4(s + c, g + c);
        }
    }
}

__device__ __forceinline__ void wait_copies() {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.wait_all;\n" ::);
#endif
}

// Whether source row sr, column c lies in the window
__device__ __forceinline__ bool in_window(const Window& v, int sr, int c) {
    return (unsigned)(sr - v.s0) < (unsigned)v.wh &&
           (unsigned)(c - v.c0) < (unsigned)v.ww;
}

// The word at source row sr, column c of the unit's buffer src, the flat
// index clipped to the buffer (only the band form's pad rows and taps
// past a short halo ever clip)
__device__ __forceinline__ uint32_t global_word(const Form& f,
                                                const int32_t* src, int sr,
                                                int c) {
    const long long n = (long long)f.src_rows * f.w;
    long long q = (long long)sr * f.w + c;
    q = q < 0 ? 0 : (q >= n ? n - 1 : q);
    return (uint32_t)__ldg(src + q);
}

// The four taps of a pixel: each one's source row and column
struct Taps {
    int sr[4], c[4];
};

// The taps of pixel (x, frame row fy), z = zbuf - 1
__device__ __forceinline__ Taps taps_of(const Form& f,
                                        const uint32_t (&t16)[16], int x,
                                        int fy, float z) {
    const uint32_t s1 = row_state(fy);
    Taps t;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        int tyi;
        tap_xy(t16, (float)(f.w - 1), (float)(f.fh - 1), i, s1, (float)x,
               (float)fy, z, f.fstr, f.inv2, t.c[i], tyi);
        t.sr[i] = tyi - f.yoff + f.soff;
    }
    return t;
}

__device__ __forceinline__ uint32_t avg4(const uint32_t (&w)[4]) {
    return avg_epu8(avg_epu8(w[0], w[1]), avg_epu8(w[2], w[3]));
}

// The blurred word from the window alone, with ok = every tap inside it
// (a tap outside reads word 0 instead, and the word is then not used):
// no branch, so the compiler can interleave a thread's rows
__device__ __forceinline__ uint32_t window_blur(const Window& v,
                                                const int32_t* win,
                                                const Taps& t, bool& ok) {
    uint32_t w[4];
    ok = true;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const bool in = in_window(v, t.sr[i], t.c[i]);
        w[i] = (uint32_t)win[in ? (t.sr[i] - v.s0) * v.pitch + t.c[i] - v.c0
                                : 0];
        ok = ok && in;
    }
    return avg4(w);
}

// The blurred word with each tap read from the window where it lies
// inside, else from the unit's buffer src
__device__ __forceinline__ uint32_t mixed_blur(const Form& f,
                                               const int32_t* src,
                                               const Window& v,
                                               const int32_t* win,
                                               const Taps& t) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
        w[i] = in_window(v, t.sr[i], t.c[i])
            ? (uint32_t)win[(t.sr[i] - v.s0) * v.pitch + t.c[i] - v.c0]
            : global_word(f, src, t.sr[i], t.c[i]);
    return avg4(w);
}

// The tile width: 32 columns where 64-column tiles would leave more of
// their last tile idle (a 160-wide camera frame: 5 tiles of 32, not 3 of
// 64 with a half-empty last one), else 64
__host__ __device__ inline int pick_tw(int w) {
    return (w + 31) / 32 * 32 < (w + 63) / 64 * 64 ? 32 : 64;
}

// The tile height: 32 rows where that grid still gives each of the
// card's sms SMs six blocks, else 16
__host__ __device__ inline int pick_th(int units, int unit_rows, int w,
                                       int tw, int sms) {
    const long long cols = (w + tw - 1) / tw;
    return cols * units * ((unit_rows + 31) / 32) >= 6LL * sms ? 32 : 16;
}

Form frame_form(const void* fb, const void* zbuf, const void* tab,
                void* out, int rows, int w, int frame_h, float fstr,
                float inv_mod) {
    Form f;
    f.fb = (const int32_t*)fb;
    f.zbuf = (const float*)zbuf;
    f.tab = (const int32_t*)tab;
    f.out = (int32_t*)out;
    f.units = rows / frame_h;
    f.unit_rows = f.src_rows = f.fh = frame_h;
    f.w = w;
    f.yoff = f.soff = 0;
    f.fstr = fstr;
    f.inv2 = inv_mod * 2.0f;                   // exact
    f.vec = w % 4 == 0 && ((uintptr_t)fb & 15) == 0;
    return f;
}

Form band_form(const void* fb_pad, const void* zb, const void* tab,
               void* out, int cl, int hb, int halo, int w, int y0, int fh,
               float fstr, float inv_mod) {
    Form f;
    f.fb = (const int32_t*)fb_pad;
    f.zbuf = (const float*)zb;
    f.tab = (const int32_t*)tab;
    f.out = (int32_t*)out;
    f.units = cl;
    f.unit_rows = hb;
    f.src_rows = hb + 2 * halo;
    f.w = w;
    f.yoff = y0;
    f.soff = halo;
    f.fh = fh;
    f.fstr = fstr;
    f.inv2 = inv_mod * 2.0f;                   // exact
    f.vec = w % 4 == 0 && ((uintptr_t)fb_pad & 15) == 0;
    return f;
}

#ifdef __CUDACC__

// One pass in TW x TH tiles: blockIdx.x a column tile, blockIdx.y a row
// tile of some unit (tiles beyond the grid's 65535 by a stride loop);
// thread (tx, ty) takes column x0 + tx, rows ty, ty + BY, ... of it.
template <int TW, int TH>
__global__ void __launch_bounds__(NT) dof_blur_tiles(const Form f) {
    constexpr int BY = NT / TW, RPT = TH / BY;
    extern __shared__ __align__(16) int32_t win[];
    __shared__ float red[NT / 32];
    const int tx = threadIdx.x % TW, ty = threadIdx.x / TW;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int x = blockIdx.x * TW + tx;
    const int wx = 4 * (f.w / 4);          // the last w % 4 pass through
    const int ntiles = f.units * ((f.unit_rows + TH - 1) / TH);
    uint32_t t16[16];
#pragma unroll
    for (int j = 0; j < 16; ++j)
        t16[j] = x < wx ? (uint32_t)__ldg(f.tab + j * f.w + x) : 0u;
    for (int t = blockIdx.y; t < ntiles; t += gridDim.y) {
        const Tile k = tile_of(f, TW, TH, t, blockIdx.x);
        const int32_t* src = f.fb + (size_t)k.unit * f.src_rows * f.w;
        const size_t orow = (size_t)k.unit * f.unit_rows + k.lr0;
        float z[RPT];
        float m = 0.0f;
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
            const int lr = ty + BY * j;
            z[j] = 0.0f;
            if (x < wx && lr < k.nr) {
                z[j] = __fsub_rn(__ldg(f.zbuf + (orow + lr) * f.w + x), 1.0f);
                m = fmaxf(m, fabsf(z[j]));     // NaN leaves m as it is
            }
        }
        Window v = {0, 0, 0, 0, TW + 2 * RCAP};
        if (stages_window(TW, TH)) {
#pragma unroll
            for (int o = 16; o; o >>= 1)
                m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
            if (lane == 0) red[warp] = m;
            __syncthreads();
#pragma unroll
            for (int i = 0; i < NT / 32; ++i) m = fmaxf(m, red[i]);
            v = window_of(f, k, __fmul_rn(f.fstr, m));
            stage(f, src, v, win, warp, NT / 32, lane, 32);
            wait_copies();
            __syncthreads();
        }
        // every row from the window, no branch between rows; a pixel
        // with a tap outside the window is left for the loop below
        unsigned later = 0;
        if (v.wh > 0) {
#pragma unroll
            for (int j = 0; j < RPT; ++j) {
                const int lr = ty + BY * j;
                bool ok;
                const uint32_t word = window_blur(
                    v, win, taps_of(f, t16, x, f.yoff + k.lr0 + lr, z[j]),
                    ok);
                if (ok && x < wx && lr < k.nr)
                    f.out[(orow + lr) * f.w + x] = (int32_t)word;
                later |= (unsigned)!ok << j;
            }
        } else {
            later = (1u << RPT) - 1;
        }
        if (later) {
#pragma unroll
            for (int j = 0; j < RPT; ++j) {
                const int lr = ty + BY * j;
                if (!(later >> j & 1u) || x >= wx || lr >= k.nr) continue;
                f.out[(orow + lr) * f.w + x] = (int32_t)mixed_blur(
                    f, src, v, win,
                    taps_of(f, t16, x, f.yoff + k.lr0 + lr, z[j]));
            }
        }
        if (x >= wx && x < f.w) {
            for (int lr = ty; lr < k.nr; lr += BY)
                f.out[(orow + lr) * f.w + x] =
                    src[(size_t)(f.soff + k.lr0 + lr) * f.w + x];
        }
        if (stages_window(TW, TH)) __syncthreads();
    }
}

// SM count of the current device, read once a device
int sm_count() {
    static int sms[64];
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
    if (sms[dev] == 0)
        cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    return sms[dev];
}

template <int TW, int TH>
cudaError_t launch_tile(const Form& f, cudaStream_t stream) {
    const long long tiles =
        (long long)f.units * ((f.unit_rows + TH - 1) / TH);
    const dim3 grid((f.w + TW - 1) / TW, tiles < 65535 ? tiles : 65535);
    dof_blur_tiles<TW, TH>
        <<<grid, NT, window_words(TW, TH) * 4, stream>>>(f);
    return cudaGetLastError();
}

int launch(const Form& f, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    const int tw = pick_tw(f.w);
    const int th = pick_th(f.units, f.unit_rows, f.w, tw, sm_count());
    if (tw == 64)
        return (int)(th == 32 ? launch_tile<64, 32>(f, s)
                              : launch_tile<64, 16>(f, s));
    return (int)(th == 32 ? launch_tile<32, 32>(f, s)
                          : launch_tile<32, 16>(f, s));
}

#endif  // __CUDACC__

}  // namespace

#ifdef __CUDACC__

// One blur pass over rows / frame_h stacked frames.  fb, out: [rows, w]
// int32 (uint32 BGRA bits), zbuf: [rows, w] f32, tab: [16, w] int32 jump
// coefficients (ops/blur.py:draw_tables), fstr = f32(0.002) * frame_h.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int pwnfps_dof_blur(const void* fb, const void* zbuf,
                               const void* tab, void* out, int rows, int w,
                               int frame_h, float fstr, float inv_mod,
                               void* stream) {
    if (rows <= 0 || w <= 0 || frame_h <= 0 || rows % frame_h != 0 ||
        w > kMaxSide || frame_h > kMaxSide)
        return (int)cudaErrorInvalidValue;
    return launch(frame_form(fb, zbuf, tab, out, rows, w, frame_h, fstr,
                             inv_mod), stream);
}

// One band pass over cl cameras.  fb_pad: [cl, hb+2*halo, w] int32,
// zb, out: [cl, hb, w] (int32 out), tab as above; y0 the bands' first
// camera-local row, fh the true frame height, fstr = f32(0.002) * fh.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int pwnfps_dof_blur_band(const void* fb_pad, const void* zb,
                                    const void* tab, void* out, int cl,
                                    int hb, int halo, int w, int y0, int fh,
                                    float fstr, float inv_mod,
                                    void* stream) {
    if (cl <= 0 || hb <= 0 || halo < 0 || w <= 0 || y0 < 0 || fh <= 0 ||
        w > kMaxSide || fh > kMaxSide)
        return (int)cudaErrorInvalidValue;
    return launch(band_form(fb_pad, zb, tab, out, cl, hb, halo, w, y0, fh,
                            fstr, inv_mod), stream);
}

#endif  // __CUDACC__
