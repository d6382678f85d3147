// Depth-of-field blur pass for Hopper (sm_90a).
//
// Replaces the TPU kernel pwnfps_tpu/ops/blur_pallas.py:_blur_kernel in
// both of its forms:
//
//  * dof_blur_kernel, the full-frame form (_dof_blur_auto,
//    blur_pallas.py:504), on one frame or on C camera frames stacked
//    vertically (frame_h, blur_pallas.py:510-520): each frame is blurred
//    within its own rows - row seeds from the frame-local row, taps
//    clamped to the frame, fstr from frame_h - in one launch over all of
//    them.  Bit-equal to pwnfps_tpu_torch/ops/blur.py:dof_blur_plain
//    (and so to pwnfps_tpu/ops/blur.py:dof_blur of each frame alone).
//  * dof_blur_band_kernel, the band form (_dof_blur_band,
//    blur_pallas.py:405-479) that the multi-device path runs on each
//    device's rows after a halo exchange: cl cameras' bands of hb rows,
//    each with H halo rows above and below, in one launch.  Bit-equal to
//    ops/blur.py:dof_blur_band_plain and so to rows [y0, y0+hb) of the
//    full-frame blur.  The TPU kernel's near/wide variants and its
//    dyn/ring/v2 modes are VMEM scan structures; here a tap is a load
//    from the halo buffer, so there is one variant.  The caller decides
//    that the taps of real rows reach no further than the halo (the
//    reach check of parallel/sharding._dof_blur_mesh); the kernel clips
//    the flat tap index to the camera's buffer, as jnp.take(mode="clip")
//    does, so the rows past the frame (their taps clamp to the frame's
//    last row, which may lie outside the buffer) never read past it.
//
// Both kernels take each tap's coordinates from one device function,
// tap_xy, so the seed and tap arithmetic exists once.
//
// What bounds them on the H100: memory.  Per pixel a kernel reads one
// zbuf word, four framebuffer taps and 16 jump-table words (the table
// rows are shared by every row, so they stay in L1/L2), and writes one
// word: about 12 bytes of DRAM traffic per pixel once the taps hit
// cache, 25 MB at 1080p, whose floor at the published 3.35 TB/s is
// about 7.5 us.  The band kernel also reads its halo rows.  The
// arithmetic (two LCG jumps and a few float ops per tap) is small beside
// that; the scattered tap loads are what keep it off the floor.
//
// Design, kept simple: one thread per output pixel, a 2D grid of
// 128-pixel row segments over every row of the stack (rows beyond the
// grid's 65535 take a stride loop).  The TPU kernel stages halo row
// groups in VMEM and resolves each tap by scanning rolled windows; here a
// tap is a plain load from global memory.  Neighbouring threads tap
// neighbouring columns of nearby rows, which the L1 absorbs.  The output
// goes to a separate buffer (taps read the unblurred frame).
//
// Numerics: every float operation is an explicit round-to-nearest
// intrinsic, so no multiply-add can contract whatever the compiler flags;
// truncation saturates (cvt.rzi), as XLA's conversion does.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kMask31 = 0x7FFFFFFFu;

__device__ __forceinline__ uint32_t avg_epu8(uint32_t a, uint32_t b) {
    return (a | b) - (((a ^ b) >> 1) & 0x7F7F7F7Fu);
}

__device__ __forceinline__ float randfs_from_state(uint32_t v,
                                                   float inv_mod) {
    float f = __fmul_rn((float)(v % 3759u), inv_mod);
    return __fadd_rn(__fmul_rn(f, 2.0f), -1.0f);
}

// 31-bit base LCG state of blur row y: its seed y*y + 415135
// (screen.h:82), one draw on
__device__ __forceinline__ uint32_t row_state(int y) {
    const uint32_t s0 = (uint32_t)y * (uint32_t)y + 415135u;
    return (s0 * 25739u + 4u) & kMask31;
}

// Column and row of tap i of pixel x in frame row yf (screen.h:92-117):
// the row's state s1 jumped to the tap's two draws, the offsets scaled by
// fstr and z = zbuf - 1, truncated and clamped to the w x fh frame.
__device__ __forceinline__ void tap_xy(const int32_t* __restrict__ tab,
                                       int w, int fh, int x, int i,
                                       uint32_t s1, float xf, float yf,
                                       float z, float fstr, float inv_mod,
                                       int& txi, int& tyi) {
    const uint32_t akx = (uint32_t)tab[(0 + i) * w + x];
    const uint32_t ckx = (uint32_t)tab[(4 + i) * w + x];
    const uint32_t aky = (uint32_t)tab[(8 + i) * w + x];
    const uint32_t cky = (uint32_t)tab[(12 + i) * w + x];
    const float rx = randfs_from_state((s1 * akx + ckx) & kMask31, inv_mod);
    const float ry = randfs_from_state((s1 * aky + cky) & kMask31, inv_mod);
    const float tx = __fadd_rn(xf, __fmul_rn(__fmul_rn(rx, fstr), z));
    const float ty = __fadd_rn(yf, __fmul_rn(__fmul_rn(ry, fstr), z));
    txi = min(max(__float2int_rz(tx), 0), w - 1);
    tyi = min(max(__float2int_rz(ty), 0), fh - 1);
}

// rows = C * frame_h; a frame_h of rows is the one-frame blur
__global__ void dof_blur_kernel(const int32_t* __restrict__ fb,
                                const float* __restrict__ zbuf,
                                const int32_t* __restrict__ tab,
                                int32_t* __restrict__ out, int rows, int w,
                                int frame_h, float fstr, float inv_mod) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    if (x >= w) return;
    for (int y = blockIdx.y; y < rows; y += gridDim.y) {
        const size_t p = (size_t)y * w + x;
        if (x >= 4 * (w / 4)) {       // last w % 4 pixels pass through
            out[p] = fb[p];
            continue;
        }
        const int fy = y % frame_h;   // row within its frame
        const int y0 = y - fy;        // the frame's first row
        const uint32_t s1 = row_state(fy);
        const float z = __fsub_rn(zbuf[p], 1.0f);
        uint32_t t[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            int txi, tyi;
            tap_xy(tab, w, frame_h, x, i, s1, (float)x, (float)fy, z, fstr,
                   inv_mod, txi, tyi);
            t[i] = (uint32_t)fb[(size_t)(y0 + tyi) * w + txi];
        }
        out[p] = (int32_t)avg_epu8(avg_epu8(t[0], t[1]),
                                   avg_epu8(t[2], t[3]));
    }
}

// rows = cl * hb output rows; camera c's band buffer is fb_pad rows
// [c*(hb+2*halo), (c+1)*(hb+2*halo)), its first own row at halo
__global__ void dof_blur_band_kernel(const int32_t* __restrict__ fb_pad,
                                     const float* __restrict__ zb,
                                     const int32_t* __restrict__ tab,
                                     int32_t* __restrict__ out, int rows,
                                     int hb, int halo, int w, int y0,
                                     int fh, float fstr, float inv_mod) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    if (x >= w) return;
    const long long nbuf = (long long)(hb + 2 * halo) * w;
    for (int q = blockIdx.y; q < rows; q += gridDim.y) {
        const int c = q / hb;
        const int ly = q - c * hb;    // row within the band
        const int32_t* src = fb_pad + (size_t)c * nbuf;
        const size_t p = (size_t)q * w + x;
        if (x >= 4 * (w / 4)) {       // last w % 4 pixels pass through
            out[p] = src[(size_t)(ly + halo) * w + x];
            continue;
        }
        const int y = y0 + ly;        // camera-local frame row
        const uint32_t s1 = row_state(y);
        const float z = __fsub_rn(zb[p], 1.0f);
        uint32_t t[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            int txi, tyi;
            tap_xy(tab, w, fh, x, i, s1, (float)x, (float)y, z, fstr,
                   inv_mod, txi, tyi);
            long long k = (long long)(tyi - y0 + halo) * w + txi;
            k = k < 0 ? 0 : (k >= nbuf ? nbuf - 1 : k);
            t[i] = (uint32_t)src[k];
        }
        out[p] = (int32_t)avg_epu8(avg_epu8(t[0], t[1]),
                                   avg_epu8(t[2], t[3]));
    }
}

}  // namespace

// One blur pass over rows / frame_h stacked frames.  fb, out: [rows, w]
// int32 (uint32 BGRA bits), zbuf: [rows, w] f32, tab: [16, w] int32 jump
// coefficients (ops/blur.py:draw_tables), fstr = f32(0.002) * frame_h.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int pwnfps_dof_blur(const void* fb, const void* zbuf,
                               const void* tab, void* out, int rows, int w,
                               int frame_h, float fstr, float inv_mod,
                               void* stream) {
    if (rows <= 0 || w <= 0 || frame_h <= 0 || rows % frame_h != 0)
        return (int)cudaErrorInvalidValue;
    const dim3 block(128);
    const dim3 grid((w + 127) / 128, rows < 65535 ? rows : 65535);
    dof_blur_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const int32_t*)fb, (const float*)zbuf, (const int32_t*)tab,
        (int32_t*)out, rows, w, frame_h, fstr, inv_mod);
    return (int)cudaGetLastError();
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
    if (cl <= 0 || hb <= 0 || halo < 0 || w <= 0 || y0 < 0 || fh <= 0)
        return (int)cudaErrorInvalidValue;
    const int rows = cl * hb;
    const dim3 block(128);
    const dim3 grid((w + 127) / 128, rows < 65535 ? rows : 65535);
    dof_blur_band_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const int32_t*)fb_pad, (const float*)zb, (const int32_t*)tab,
        (int32_t*)out, rows, hb, halo, w, y0, fh, fstr, inv_mod);
    return (int)cudaGetLastError();
}
