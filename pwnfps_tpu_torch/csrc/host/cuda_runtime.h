// What csrc/tracer_body.cuh, csrc/blur.cu and csrc/rays.cu take from the
// CUDA runtime, for a host C++ compiler (tools/host_trace.py,
// tools/host_blur.py, tools/host_rays.py): the
// qualifiers vanish, the intrinsics become their host meaning (the _rn
// arithmetic the host's IEEE round-to-nearest-even operations, built
// with no contraction; __float2int_rz saturating as cvt.rzi does: NaN to
// 0, out of range to INT_MIN or INT_MAX), one thread, one lane, and the
// runtime's calls are declared, never defined: the host build calls no
// launch path.
#pragma once
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <cfenv>
#define __device__
#define __global__
#define __host__
#define __shared__
#define __constant__
#define __forceinline__ inline
#define __noinline__
#define __align__(n)
#define __launch_bounds__(...)
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaErrorInvalidConfiguration = 9, cudaErrorInvalidDevice = 101,
       cudaErrorMisalignedAddress = 716 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
struct dim3 {
    unsigned x, y, z;
    dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
extern dim3 threadIdx, blockIdx, blockDim, gridDim;
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) int4 { int x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) {
    return float4{x, y, z, w};
}
inline int4 make_int4(int x, int y, int z, int w) { return int4{x, y, z, w}; }
cudaError_t cudaGetDevice(int*);
cudaError_t cudaGetLastError();
template <class K> cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int);
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int*, K, int,
                                                          size_t);
cudaError_t cudaDeviceGetAttribute(int*, cudaDeviceAttr, int);
template <class T> T __ldg(const T* p) { return *p; }
inline float __uint_as_float(uint32_t u) { float f; memcpy(&f, &u, 4); return f; }
inline float __int_as_float(int u) { float f; memcpy(&f, &u, 4); return f; }
inline uint32_t __float_as_uint(float f) { uint32_t u; memcpy(&u, &f, 4); return u; }
inline int __float_as_int(float f) { int u; memcpy(&u, &f, 4); return u; }
inline int __float2int_rz(float f) {
    if (f != f) return 0;
    if (f >= 2147483648.0f) return 2147483647;
    if (f <= -2147483648.0f) return -2147483647 - 1;
    return (int)f;
}
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
// a + b rounded toward zero: the host's own add under FE_TOWARDZERO, its
// operands and result volatile so that the add stays between the two
// rounding-mode switches
inline float __fadd_rz(float a, float b) {
    volatile float va = a, vb = b;
    const int mode = fegetround();
    fesetround(FE_TOWARDZERO);
    volatile float r = va + vb;
    fesetround(mode);
    return r;
}
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline long long clock64() { return 0; }
inline unsigned __reduce_add_sync(unsigned, unsigned v) { return v; }
inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)p; }
inline int __ffs(unsigned m) { return m ? __builtin_ctz(m) + 1 : 0; }
inline unsigned __activemask() { return 1; }
template <class T> T atomicAdd(T* p, T v) { T o = *p; *p += v; return o; }
template <class T> T atomicExch(T* p, T v) { T o = *p; *p = v; return o; }
template <class T> T __shfl_sync(unsigned, T v, int) { return v; }
template <class T> T __shfl_xor_sync(unsigned, T v, int) { return v; }
inline void __syncthreads() {}
inline void __syncwarp(unsigned = 0xffffffffu) {}
inline void __threadfence() {}
