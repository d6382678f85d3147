// A frame's primary rays for Hopper (sm_90a): the camera origin broadcast,
// the ray directions and the per-pixel seeds, written by one launch.
//
// Replaces no TPU kernel: the JAX package builds these with XLA
// operations (pwnfps_tpu/render/frame.py gen_rays and the origin
// broadcast, core/lcg.py pixel_seed), which XLA fuses.  The port's plain
// path (render/frame.py gen_rays, pixel_seeds) is some 85 small PyTorch
// kernels a frame (parity mode's 32 serial adds and their stack, the
// seeds' int64 LCG over every pixel), and it took the four camera
// vectors to the device with copies from pageable memory, each of which
// waits for the stream to drain.  This kernel takes the camera vectors by
// value, in its argument, and writes everything the tracer reads.
//
// What bounds it: the bytes it writes, 28 a pixel (seven planes of four
// bytes: origin x, y, z, direction x, y, z, seed), 58 MB at 1920x1080,
// 17 us at 3.35 TB/s; it reads nothing.  Each thread writes PX
// consecutive pixels of a row, one 16-byte store a plane where the
// plane's address allows (every row of a frame whose width is a multiple
// of 4, in tensors from PyTorch's allocator), else PX 4-byte stores.
//
// Numerics: every float operation is an explicit round-to-nearest
// intrinsic in the plain path's order, so the bits are the plain path's
// whatever the compiler flags:
//
//  * fast mode: component c of pixel (x, y) is
//    (rayb[c] + f32(y) * rdy[c]) + f32(x + 1) * rdx[c];
//  * parity mode (the reference's serial accumulation, screen.h:12-24):
//    pixel 32t + k starts from (rayb[c] + f32(y) * rdy[c]) + f32(32t) *
//    rdx[c] and adds rdx[c] k + 1 times, in order;
//  * the seed (screen.h:19-21): s = x + y * y * (w + 1), then s = s * (s *
//    s) twice, in wrapping uint32 arithmetic, stored as int32 bits.
//
// The functions above the kernel also build on the host (csrc/host/
// host_rays.cpp, tools/host_rays.py), which runs rays_group over every
// group of pixels; the kernel and its launch are for nvcc only.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;      // threads a block
constexpr int PX = 4;        // pixels a thread: one 16-byte store a plane

// The launch's one argument, packed by render/frame.py (_RAY_ARGS): the
// planes ox, oy, oz, dx, dy, dz (f32 [n]) and the seeds (i32 [n]); the
// image; the mode; the camera vectors.
struct RayArgs {
    unsigned long long out[7];
    int n, width, height, parity;
    float origin[3], rayb[3], rdx[3], rdy[3];
};
static_assert(sizeof(RayArgs) == 7 * 8 + 4 * 4 + 12 * 4,
              "RayArgs must match render/frame.py's _RAY_ARGS");

bool bad_args(const RayArgs& a) {
    if (a.width <= 0 || a.height <= 0 ||
        (long long)a.width * a.height != (long long)a.n)
        return true;
    for (int i = 0; i < 7; ++i)
        if (a.out[i] == 0) return true;
    return false;
}

// Groups of PX pixels: ceil(width / PX) a row
__host__ __device__ inline int groups_a_row(const RayArgs& a) {
    return (a.width + PX - 1) / PX;
}

__host__ __device__ inline uint32_t pixel_seed(uint32_t x, uint32_t y,
                                               uint32_t w) {
    uint32_t s = x + y * y * (w + 1u);
    s = s * (s * s);
    return s * (s * s);
}

// Component c of the directions of pixels x0 .. x0 + PX - 1 of row y
// (x0 a multiple of PX, so the pixels share a parity tile)
__device__ inline void direction(const RayArgs& a, int c, int y, int x0,
                                 float v[PX]) {
    const float row = __fadd_rn(a.rayb[c], __fmul_rn((float)y, a.rdy[c]));
    const float dx = a.rdx[c];
    if (!a.parity) {
#pragma unroll
        for (int k = 0; k < PX; ++k)
            v[k] = __fadd_rn(row, __fmul_rn((float)(x0 + k + 1), dx));
        return;
    }
    const int t0 = x0 & ~31;
    float acc = __fadd_rn(row, __fmul_rn((float)t0, dx));
    for (int x = t0; x <= x0; ++x) acc = __fadd_rn(acc, dx);
    v[0] = acc;
#pragma unroll
    for (int k = 1; k < PX; ++k) {
        acc = __fadd_rn(acc, dx);
        v[k] = acc;
    }
}

// cnt (<= PX) words of v to p: one 16-byte store where there are PX and
// p is 16-byte aligned
__device__ inline void put(float* p, const float v[PX], int cnt) {
    if (cnt == PX && ((uintptr_t)p & 15u) == 0) {
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
        return;
    }
    for (int k = 0; k < cnt; ++k) p[k] = v[k];
}

__device__ inline void put(int32_t* p, const int32_t v[PX], int cnt) {
    if (cnt == PX && ((uintptr_t)p & 15u) == 0) {
        *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
        return;
    }
    for (int k = 0; k < cnt; ++k) p[k] = v[k];
}

// Group g of the frame: pixels x0 .. x0 + cnt - 1 of row y, every plane
__device__ inline void rays_group(const RayArgs& a, unsigned g) {
    const unsigned gpr = (unsigned)groups_a_row(a);
    const int y = (int)(g / gpr);
    const int x0 = (int)(g - (unsigned)y * gpr) * PX;
    const int cnt = min(PX, a.width - x0);
    const size_t q = (size_t)y * a.width + x0;
    float v[PX];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
#pragma unroll
        for (int k = 0; k < PX; ++k) v[k] = a.origin[c];
        put(reinterpret_cast<float*>(a.out[c]) + q, v, cnt);
        direction(a, c, y, x0, v);
        put(reinterpret_cast<float*>(a.out[3 + c]) + q, v, cnt);
    }
    int32_t s[PX];
#pragma unroll
    for (int k = 0; k < PX; ++k)
        s[k] = (int32_t)pixel_seed((uint32_t)(x0 + k), (uint32_t)y,
                                   (uint32_t)a.width);
    put(reinterpret_cast<int32_t*>(a.out[6]) + q, s, cnt);
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(NT) frame_rays_kernel(const RayArgs a) {
    const unsigned groups = (unsigned)a.height * groups_a_row(a);
    for (unsigned g = blockIdx.x * NT + threadIdx.x; g < groups;
         g += gridDim.x * NT)
        rays_group(a, g);
}

#endif  // __CUDACC__

}  // namespace

#ifdef __CUDACC__

// Write a frame's n = width * height primary rays (Args above): the origin
// into ox, oy, oz, the directions into dx, dy, dz (fast mode with parity
// 0, parity mode's serial adds with parity 1), the seeds into seed.
// Launches on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape or an address it does not take.
extern "C" int pwnfps_frame_rays(const void* args, void* stream) {
    const RayArgs& a = *(const RayArgs*)args;
    if (bad_args(a)) return (int)cudaErrorInvalidValue;
    const long long groups = (long long)a.height * groups_a_row(a);
    const long long blocks = (groups + NT - 1) / NT;
    frame_rays_kernel<<<(unsigned)(blocks < 65535 ? blocks : 65535), NT, 0,
                        (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

#endif  // __CUDACC__
