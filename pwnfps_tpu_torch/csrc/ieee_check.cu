// The card's check that the hardware's IEEE square root and division,
// __fsqrt_rn and __fdiv_rn, which the tracer's parity instances take for
// their exact roots and quotients (csrc/tracer_body.cuh sphere_pass,
// ramp_tilt), give the bits of core/ieee.py's integer emulations sqrt_rn
// and div_rn.  Both emulations compute the correctly rounded result for
// positive normal operands and fall back to the IEEE operation elsewhere,
// so they must equal the IEEE round-to-nearest-even operation everywhere;
// this holds them to it, bit for bit, over operand sets made on the card:
//
//   * SQRT_ALL: every positive normal f32 (0x00800000 .. 0x7F7FFFFF);
//   * DIV_RANDOM: seeded random pairs of positive normal f32;
//   * DIV_EQUAL_MANT: pairs with equal mantissas (every mantissa in turn)
//     and random exponents;
//   * DIV_EXP_EXTREMES: each pair of exponents from {1, 2, 3, 125, 126,
//     127, 128, 129, 252, 253, 254}, random mantissas;
//   * DIV_RANGE_ENDS: quotients at the normal range's ends, exponent
//     differences of -127 .. -125 and 126 .. 127;
//   * DIV_CALCRAD2: the bucket scan's calcrad2 / rad2 (a radius r in
//     [2^-7, 4), rad2 = r * r, calcrad2 = u * rad2 for u in [-2^-20, 1));
//   * DIV_RECIP: the ramp step's 1 / ay2 for every positive normal ay2
//     below 2.
//
// Built like the kernels (_build.py: --prec-div=true --prec-sqrt=true
// --ftz=false), launched through tools/ieee_check.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SQRT_ALL = 0, DIV_RANDOM = 1, DIV_EQUAL_MANT = 2,
              DIV_EXP_EXTREMES = 3, DIV_RANGE_ENDS = 4, DIV_CALCRAD2 = 5,
              DIV_RECIP = 6, N_SETS = 7;

// round to nearest even on guard bit g and the sticky flag; returns the
// f32 bits, or 0xFFFFFFFF when the exponent leaves the normal range
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
// restoring division of the mantissas; other operands take IEEE a / b
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
// digit-by-digit root of the mantissa; other operands take IEEE sqrtf
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

// 32 random bits of (i, salt) under the seed: splitmix64's finaliser
__device__ __forceinline__ uint32_t hash(uint64_t seed, uint64_t i,
                                         uint32_t salt) {
    uint64_t z = seed + (i * 4 + salt + 1) * 0x9E3779B97F4A7C15ull;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
    return (uint32_t)((z ^ (z >> 31)) >> 32);
}

__device__ __forceinline__ float normal(int e, uint32_t mant) {
    return __uint_as_float(((uint32_t)e << 23) | (mant & 0x7FFFFFu));
}

__constant__ int EXTREMES[11] = {1, 2, 3, 125, 126, 127, 128, 129, 252,
                                 253, 254};

// operand pair i of `set` (SQRT_ALL: a only)
__device__ __forceinline__ void operands(int set, uint64_t seed, uint64_t i,
                                         float& a, float& b) {
    const uint32_t h0 = hash(seed, i, 0), h1 = hash(seed, i, 1),
                   h2 = hash(seed, i, 2), h3 = hash(seed, i, 3);
    b = 1.0f;
    switch (set) {
    case SQRT_ALL:
        a = __uint_as_float(0x00800000u + (uint32_t)i);
        break;
    case DIV_RANDOM:
        a = normal(1 + (int)(h0 % 254u), h1);
        b = normal(1 + (int)(h2 % 254u), h3);
        break;
    case DIV_EQUAL_MANT: {
        const uint32_t m = (uint32_t)i & 0x7FFFFFu;
        a = normal(1 + (int)(h0 % 254u), m);
        b = normal(1 + (int)(h1 % 254u), m);
        break;
    }
    case DIV_EXP_EXTREMES: {
        const int j = (int)(i % 121u);
        a = normal(EXTREMES[j / 11], h0);
        b = normal(EXTREMES[j % 11], h1);
        break;
    }
    case DIV_RANGE_ENDS: {
        // ea - eb in {-127, -126, -125} (quotients near 2^-126) or {126,
        // 127} (near the largest f32), eb chosen so that both are normal
        const int diffs[5] = {-127, -126, -125, 126, 127};
        const int d = diffs[h2 % 5u];
        const int lo = d < 0 ? 1 - d : 1, hi = d < 0 ? 254 : 254 - d;
        const int eb = lo + (int)(h3 % (uint32_t)(hi - lo + 1));
        a = normal(eb + d, h0);
        b = normal(eb, h1);
        break;
    }
    case DIV_CALCRAD2: {
        // r in [2^-7, 4): exponents 120 .. 128
        const float r = normal(120 + (int)(h0 % 9u), h1);
        const float rad2 = r * r;
        // u in [-2^-20, 1): a uniform 24-bit fraction, shifted
        const float u = (float)(h2 >> 8) * 5.9604645e-8f - 9.5367432e-7f;
        a = u * rad2;
        b = rad2 > 0.0f ? rad2 : 1.0f;
        break;
    }
    default:  // DIV_RECIP: 1 / every positive normal below 2
        a = 1.0f;
        b = __uint_as_float(0x00800000u + (uint32_t)i);
        break;
    }
}

// out: u64 [3] = mismatches, the first mismatching index (~0 if none),
// pairs tested
__global__ void __launch_bounds__(256)
ieee_check(int set, uint64_t seed, uint64_t count,
           unsigned long long* out) {
    const uint64_t stride = (uint64_t)gridDim.x * blockDim.x;
    unsigned long long bad = 0, first = ~0ull;
    for (uint64_t i = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x;
         i < count; i += stride) {
        float a, b;
        operands(set, seed, i, a, b);
        const float want = set == SQRT_ALL ? sqrt_rn(a) : div_rn(a, b);
        const float got = set == SQRT_ALL ? __fsqrt_rn(a)
                                          : __fdiv_rn(a, b);
        if (__float_as_uint(want) != __float_as_uint(got)) {
            ++bad;
            first = first < i ? first : i;
        }
    }
    if (bad) {
        atomicAdd(out, bad);
        atomicMin(out + 1, first);
    }
    if (blockIdx.x == 0 && threadIdx.x == 0)
        atomicAdd(out + 2, (unsigned long long)count);
}

}  // namespace

// Check operand set `set` (0 .. 6, above) over `count` pairs made from
// `seed`: out u64 [3] on the card, zeroed but for out[1] = ~0 by the
// caller, gets the mismatches, the first mismatching pair's index and
// the pairs tested.  `blocks` blocks of 256 threads; launches on
// `stream`; returns cudaGetLastError().
extern "C" int pwnfps_ieee_check(int set, unsigned long long seed,
                                 unsigned long long count, int blocks,
                                 void* out, void* stream) {
    if (set < 0 || set >= N_SETS || blocks <= 0 || out == nullptr)
        return (int)cudaErrorInvalidValue;
    ieee_check<<<blocks, 256, 0, (cudaStream_t)stream>>>(
        set, seed, count, (unsigned long long*)out);
    return (int)cudaGetLastError();
}
