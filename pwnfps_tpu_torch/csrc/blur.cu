// Depth-of-field blur pass for Hopper (sm_90a).
//
// Replaces the TPU kernel pwnfps_tpu/ops/blur_pallas.py:_blur_kernel in
// its full-frame form (_dof_blur_auto, blur_pallas.py:504), on one frame
// or on C camera frames stacked vertically (frame_h, blur_pallas.py:
// 510-520): each frame is blurred within its own rows - row seeds from
// the frame-local row, taps clamped to the frame, fstr from frame_h - in
// one launch over all of them.  Bit-equal to the plain pass
// pwnfps_tpu_torch/ops/blur.py:dof_blur_plain (and so to
// pwnfps_tpu/ops/blur.py:dof_blur of each frame alone) for every input.
//
// What bounds it on the H100: memory.  Per pixel it reads one zbuf word,
// four framebuffer taps and 16 jump-table words (the table rows are
// shared by every row of the frame, so they stay in L1/L2), and writes one
// word: about 12 bytes of DRAM traffic per pixel once the taps hit cache,
// 25 MB at 1080p, whose floor at the published 3.35 TB/s is about 7.5 us.
// The arithmetic (two LCG jumps and a few float ops per tap) is small
// beside that; the scattered tap loads are what keep it off the floor.
//
// Design, kept simple: one thread per output pixel, a 2D grid of
// 128-pixel row segments over every row of the stack (rows beyond the
// grid's 65535 take a stride loop).  The TPU kernel stages halo row groups in VMEM
// and resolves each tap by scanning rolled windows, with near/wide
// variants and an XLA fallback for long reaches; here a tap is a plain
// load from global memory, so there is no reach limit and one kernel
// covers every depth.  Neighbouring threads tap neighbouring columns of
// nearby rows, which the L1 absorbs.  The output goes to a separate
// buffer (taps read the unblurred frame).
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
        const uint32_t s0 = (uint32_t)fy * (uint32_t)fy + 415135u;
        const uint32_t s1 = (s0 * 25739u + 4u) & kMask31;
        const float z = __fsub_rn(zbuf[p], 1.0f);
        const float xf = (float)x;
        const float yf = (float)fy;
        uint32_t t[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const uint32_t akx = (uint32_t)tab[(0 + i) * w + x];
            const uint32_t ckx = (uint32_t)tab[(4 + i) * w + x];
            const uint32_t aky = (uint32_t)tab[(8 + i) * w + x];
            const uint32_t cky = (uint32_t)tab[(12 + i) * w + x];
            const float rx = randfs_from_state((s1 * akx + ckx) & kMask31,
                                               inv_mod);
            const float ry = randfs_from_state((s1 * aky + cky) & kMask31,
                                               inv_mod);
            const float tx = __fadd_rn(xf,
                                       __fmul_rn(__fmul_rn(rx, fstr), z));
            const float ty = __fadd_rn(yf,
                                       __fmul_rn(__fmul_rn(ry, fstr), z));
            const int txi = min(max(__float2int_rz(tx), 0), w - 1);
            const int tyi = min(max(__float2int_rz(ty), 0), frame_h - 1);
            t[i] = (uint32_t)fb[(size_t)(y0 + tyi) * w + txi];
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
