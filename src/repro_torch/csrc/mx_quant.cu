// FP32 -> MX converter (the paper's three steps) for Hopper, sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/mx_quant.py::_mx_quantize_2d
// (body _mx_quant_kernel -> _quant_tile).  Same function, bit for bit: the
// per-element arithmetic is mx_quant_common.cuh (integer-exact, what
// src/repro/core/convert.py computes), shared with the fused KV write.
//
// Bound.  Bytes: 4 B read and 1 + 1/32 B written per element, against a
// few dozen integer operations per element; at the weight shape
// (13696 x 4096) the byte bound is 0.084 ms and the integer pipe (64
// operations per clock per SM) is close behind it.
//
// Two kernels; the wrapper (kernels/mx_quant.py) picks one by shape
// before the launch:
//
// * mx_quant_vec_kernel: rows a multiple of 32 long, x 16-byte aligned
//   (the weight load).  Each thread converts 8 consecutive floats: two
//   16-byte loads through the read-only path, one 8-byte store of codes.
//   The 4 threads of an MX block (a quad of lanes) take its largest
//   magnitude with __shfl_xor_sync, which gives the largest exponent and
//   the any-NaN / any-Inf flags at once (a block holding a NaN or an Inf
//   takes a second, finite maximum); the quad's first lane stores the
//   E8M0 scale.  A grid of a few waves over
//   the SMs walks the tensor in a grid-stride loop.  Instantiated per
//   (INT8 or float, mode, mantissa width) so the format's constants fold
//   into the arithmetic.
// * mx_quant_kernel: any row length or alignment (a ragged N such as
//   77).  mx_quant_common.cuh::write_block, the fused KV write's
//   routine: one warp per 32-element block, one lane per element,
//   __reduce_max_sync over the biased exponents, __any_sync for the
//   flags.  No weight or serving shape of the model registry reaches it;
//   it keeps the wrapper's any-N contract.
//
// Built without --use_fast_math: nothing here is floating-point
// arithmetic, but the library shares one set of flags and the E8M0
// decode in the other kernels must keep denormals.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mx_quant_common.cuh"

namespace {

using mxq::Fmt;
using mxq::kFull;

constexpr int kVecThreads = 256;
constexpr int kVecBlocksPerSm = 8;   // grid: up to 8 x 4 blocks per SM,
constexpr int kVecWaves = 4;         // then the grid-stride loop

// One warp per 32-element block of one row: write_block with the row as
// its own destination, codes one per byte, stored up to the row's end.
__global__ void mx_quant_kernel(const float* __restrict__ x,
                                uint8_t* __restrict__ codes,
                                uint8_t* __restrict__ scales, int m, int n,
                                int nblk, Fmt f) {
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (warp >= (long long)m * nblk) return;         // uniform per warp
  const long long row = warp / nblk;
  const mxq::Side d{f, 0, n, codes, scales};
  mxq::write_block(x + row * n, d, row, n, nblk, (int)(warp % nblk),
                   threadIdx.x & 31);
}

// groups: elements / 8, a multiple of 4 (rows a multiple of 32 long).
template <bool IS_INT, bool PAPER, int MBITS>
__global__ void __launch_bounds__(kVecThreads) mx_quant_vec_kernel(
    const float4* __restrict__ x, uint2* __restrict__ codes,
    uint8_t* __restrict__ scales, long long groups, Fmt fr) {
  Fmt f = fr;                      // compile-time fields fold from here on
  f.is_int = IS_INT;
  f.paper = PAPER;
  f.mbits = MBITS;
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (kVecThreads / 32);
  // whole warps walk the groups, so every lane reaches every shuffle;
  // groups % 4 == 0, so a quad is wholly in range or wholly out
  for (long long w = ((long long)blockIdx.x * kVecThreads + threadIdx.x) >> 5;
       w * 32 < groups; w += warps) {
    const long long g = w * 32 + lane;
    const bool in = g < groups;
    float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
    if (in) {
      lo = __ldg(x + 2 * g);
      hi = __ldg(x + 2 * g + 1);
    }
    const int b[8] = {__float_as_int(lo.x), __float_as_int(lo.y),
                      __float_as_int(lo.z), __float_as_int(lo.w),
                      __float_as_int(hi.x), __float_as_int(hi.y),
                      __float_as_int(hi.z), __float_as_int(hi.w)};
    // step 1 across the quad that holds the MX block, on magnitudes: the
    // largest |bits| is the largest finite exponent's unless it is a NaN
    // (above 0x7F800000) or, with no NaN, an Inf (equal to it); any_inf
    // only matters where there is no NaN
    int amax = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) amax = max(amax, b[i] & 0x7FFFFFFF);
    amax = max(amax, __shfl_xor_sync(kFull, amax, 1));
    amax = max(amax, __shfl_xor_sync(kFull, amax, 2));
    const bool any_nan = amax > 0x7F800000, any_inf = amax == 0x7F800000;
    int ev_max = amax >> 23;
    if (amax >= 0x7F800000) {      // quad-uniform: take the finite maximum
      const unsigned quad = 0xFu << (lane & 28);
      int fmax = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int a = b[i] & 0x7FFFFFFF;
        fmax = max(fmax, a < 0x7F800000 ? a : 0);
      }
      fmax = max(fmax, __shfl_xor_sync(quad, fmax, 1));
      fmax = max(fmax, __shfl_xor_sync(quad, fmax, 2));
      ev_max = fmax >> 23;
    }
    const int xs = mxq::shared_scale(ev_max, f, any_nan, any_inf);
    unsigned word[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const unsigned c = (unsigned)mxq::encode(b[i], xs, f, any_nan, any_inf);
      word[i >> 2] |= c << (8 * (i & 3));
    }
    if (in) {
      codes[g] = make_uint2(word[0], word[1]);
      if ((lane & 3) == 0) scales[g >> 2] = (uint8_t)xs;
    }
  }
}

template <bool IS_INT, bool PAPER, int MBITS>
void launch_vec(const float4* x, uint2* codes, uint8_t* scales,
                long long groups, const Fmt& f, cudaStream_t stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const long long need = (groups + kVecThreads - 1) / kVecThreads;
  const long long cap = (long long)sms * kVecBlocksPerSm * kVecWaves;
  const unsigned blocks = (unsigned)(need < cap ? need : cap);
  mx_quant_vec_kernel<IS_INT, PAPER, MBITS>
      <<<blocks, kVecThreads, 0, stream>>>(x, codes, scales, groups, f);
}

}  // namespace

// x f32 (m, n) row-major -> codes u8 (m, n), scales u8 (m, ceil(n/32)).
// Any n; one lane per element.
extern "C" int mx_quant_launch(const void* x, void* codes, void* scales,
                               int m, int n, int mbits, int bias, int is_int,
                               int paper, int max_exp_paper, int max_exp_ocp,
                               int max_mant_top, int nan_mant, int emax_ocp,
                               int exp_mask, int sign_shift, void* stream) {
  const Fmt f{mbits,       bias,         is_int,   paper,
              max_exp_paper, max_exp_ocp, max_mant_top, nan_mant,
              emax_ocp,    exp_mask,     sign_shift};
  const int nblk = (n + 31) / 32;
  const long long warps = (long long)m * nblk;
  const int threads = 256;
  const long long blocks = (warps * 32 + threads - 1) / threads;
  if (blocks > 0) {
    mx_quant_kernel<<<(unsigned)blocks, threads, 0,
                      (cudaStream_t)stream>>>(
        (const float*)x, (uint8_t*)codes, (uint8_t*)scales, m, n, nblk, f);
  }
  return (int)cudaGetLastError();
}

// The same function for n % 32 == 0 and x 16-byte aligned (codes 8-byte
// aligned): 8 elements per thread.  Returns cudaErrorInvalidValue for a
// format the instantiations do not cover.
extern "C" int mx_quant_vec_launch(const void* x, void* codes, void* scales,
                                   int m, int n, int mbits, int bias,
                                   int is_int, int paper, int max_exp_paper,
                                   int max_exp_ocp, int max_mant_top,
                                   int nan_mant, int emax_ocp, int exp_mask,
                                   int sign_shift, void* stream) {
  const Fmt f{mbits,       bias,         is_int,   paper,
              max_exp_paper, max_exp_ocp, max_mant_top, nan_mant,
              emax_ocp,    exp_mask,     sign_shift};
  const long long groups = (long long)m * n / 8;
  if (groups == 0) return (int)cudaGetLastError();
  const float4* xv = (const float4*)x;
  uint2* cv = (uint2*)codes;
  uint8_t* sv = (uint8_t*)scales;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_int) {
    if (paper) launch_vec<true, true, 6>(xv, cv, sv, groups, f, s);
    else launch_vec<true, false, 6>(xv, cv, sv, groups, f, s);
  } else if (mbits == 1) {
    if (paper) launch_vec<false, true, 1>(xv, cv, sv, groups, f, s);
    else launch_vec<false, false, 1>(xv, cv, sv, groups, f, s);
  } else if (mbits == 2) {
    if (paper) launch_vec<false, true, 2>(xv, cv, sv, groups, f, s);
    else launch_vec<false, false, 2>(xv, cv, sv, groups, f, s);
  } else if (mbits == 3) {
    if (paper) launch_vec<false, true, 3>(xv, cv, sv, groups, f, s);
    else launch_vec<false, false, 3>(xv, cv, sv, groups, f, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
