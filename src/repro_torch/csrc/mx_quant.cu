// FP32 -> MX converter (the paper's three steps) for Hopper, sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/mx_quant.py::_mx_quantize_2d
// (body _mx_quant_kernel -> _quant_tile).  Same function, bit for bit: the
// per-element arithmetic below is the integer sequence of
// src/repro/core/convert.py (shared_scale, _quant_float_paper,
// _quant_float_ocp, _quant_int8, _marker_codes), and the port's plain
// version (repro_torch/core/convert.py) is its CPU twin.
//
// Design.  One warp per 32-element MX block, one lane per element: the
// paper's 5-level comparator tree becomes __reduce_max_sync over the
// masked biased exponents, and __any_sync gives the block's any-NaN /
// any-Inf flags.  Lane 0 writes the E8M0 scale; every lane encodes its
// own element.  Lanes past the row's end read 0.0f, which never moves a
// block's maximum exponent (the Pallas wrapper zero-pads the same way).
//
// Bound.  Bytes: 4 B read and 1 + 1/32 B written per element, with a few
// dozen integer operations per element.  Consecutive lanes read
// consecutive floats and write consecutive code bytes, so each warp moves
// one 128-byte line in and one 32-byte segment out.
//
// Built without --use_fast_math: nothing here is floating-point
// arithmetic, but the library shares one set of flags and the E8M0
// decode in the other kernels must keep denormals.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

struct Fmt {
  int mbits, bias, is_int, paper, max_exp_paper, max_exp_ocp, max_mant_top,
      nan_mant, emax_ocp, exp_mask, sign_shift;
};

__device__ __forceinline__ int shared_scale(int ev_max, const Fmt& f,
                                            bool any_nan, bool any_inf) {
  int sub = f.paper ? f.bias : f.emax_ocp;
  int x = max(ev_max - sub, 0);
  x = min(x, f.paper ? 0xFD : 0xFE);
  if (f.paper) {
    if (any_inf) x = 0xFE;
    if (any_nan) x = 0xFF;
  } else if (any_nan || any_inf) {
    x = 0xFF;
  }
  return x;
}

__device__ __forceinline__ int quant_float_paper(int sign, int exp, int man,
                                                 int xs, const Fmt& f) {
  const int R = f.mbits, mant_mask = (1 << R) - 1;
  int eb = exp - xs + f.bias;
  int kept = man >> (23 - (R + 1));
  int rnd = (kept + 1) >> 1;                       // ties-away
  int carry = rnd >> R;
  int mant = (carry > 0 ? 0 : rnd) & mant_mask;
  int eb2 = eb + carry;
  if (eb2 > f.max_exp_paper) {                     // saturate
    mant = mant_mask;
    eb2 = f.max_exp_paper;
  }
  bool zero = (eb <= 0) || (exp == 0);             // FTZ
  int body = zero ? 0 : ((eb2 << R) | mant);
  return ((sign << f.sign_shift) | body) & 0xFF;
}

__device__ __forceinline__ int quant_float_ocp(int sign, int exp, int man,
                                               int xs, const Fmt& f) {
  const int R = f.mbits;
  int eb = exp - xs + f.bias;
  int sig = (1 << 23) | man;
  int sh_sub = max(0, 1 - eb);
  int shift = min(max((23 - R) + sh_sub, 0), 30);
  int low = sig & ((1 << shift) - 1);
  int half = (1 << shift) >> 1;
  int q = sig >> shift;
  bool round_up = (low > half) || ((low == half) && (q & 1));
  q += round_up ? 1 : 0;                           // RNE with sticky bits
  int ebn = max(eb, 1);
  int ncarry = q >> (R + 1);
  int qn = ncarry > 0 ? (1 << R) : q;
  ebn += ncarry;
  int mant_n = qn - (1 << R);
  int promote = q >> R;                            // subnormal -> min normal
  int mant_s = promote > 0 ? 0 : q;
  bool is_sub = eb <= 0;
  int mant = is_sub ? mant_s : mant_n;
  int ebf = is_sub ? promote : ebn;
  bool over = (ebf > f.max_exp_ocp) ||
              ((ebf == f.max_exp_ocp) && (mant > f.max_mant_top));
  if (over) {
    mant = f.max_mant_top;
    ebf = f.max_exp_ocp;
  }
  int body = (exp == 0) ? 0 : ((ebf << R) | mant);
  return ((sign << f.sign_shift) | body) & 0xFF;
}

__device__ __forceinline__ int quant_int8(int sign, int exp, int man, int xs,
                                          const Fmt& f) {
  int e_u = exp - xs;
  int sig = (1 << 23) | man;
  int shift = min(max(17 - e_u, 0), 30);
  int low = sig & ((1 << shift) - 1);
  int half = (1 << shift) >> 1;
  int q = sig >> shift;
  if (f.paper) {
    q += (low >= half && half > 0) ? 1 : 0;        // ties-away
  } else {
    q += ((low > half) || ((low == half) && (q & 1))) ? 1 : 0;
  }
  if (exp == 0) q = 0;
  if (f.paper) return (sign << 7) | min(q, 127);   // sign-magnitude
  int s = sign ? -q : q;
  s = min(max(s, -128), 127);                      // two's complement
  return s & 0xFF;
}

__device__ __forceinline__ int marker(int sign, const Fmt& f, bool nan) {
  if (f.is_int) return (sign << 7) | (nan ? 127 : 126);
  int body = (f.exp_mask << f.mbits) | (nan ? f.nan_mant : 0);
  return ((sign << f.sign_shift) | body) & 0xFF;
}

__global__ void mx_quant_kernel(const float* __restrict__ x,
                                uint8_t* __restrict__ codes,
                                uint8_t* __restrict__ scales, int m, int n,
                                int nblk, Fmt f) {
  long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long long)m * nblk) return;         // uniform per warp
  const long long row = warp / nblk;
  const int j = (int)(warp % nblk);
  const int col = j * 32 + lane;
  const bool in = col < n;
  const float v = in ? x[row * n + col] : 0.0f;
  const int bits = __float_as_int(v);
  const int sign = (bits >> 31) & 1;
  const int exp = (bits >> 23) & 0xFF;
  const int man = bits & 0x7FFFFF;
  const bool finite = exp != 0xFF;
  // step 1: comparator tree over the finite exponents; NaN/Inf flags
  const bool any_nan = __any_sync(kFull, !finite && man != 0);
  const bool any_inf = __any_sync(kFull, !finite && man == 0);
  const int ev_max = __reduce_max_sync(kFull, finite ? exp : 0);
  // step 2: shared E8M0 scale
  const int xs = shared_scale(ev_max, f, any_nan, any_inf);
  // step 3: this lane's private element
  int code;
  if (f.is_int) {
    code = quant_int8(sign, exp, man, xs, f);
  } else if (f.paper) {
    code = quant_float_paper(sign, exp, man, xs, f);
  } else {
    code = quant_float_ocp(sign, exp, man, xs, f);
  }
  if (f.paper) {                                   // block poison markers
    if (any_inf) code = marker(sign, f, false);
    if (any_nan) code = marker(sign, f, true);
  }
  if (in) codes[row * n + col] = (uint8_t)code;
  if (lane == 0) scales[row * nblk + j] = (uint8_t)xs;
}

}  // namespace

// x f32 (m, n) row-major -> codes u8 (m, n), scales u8 (m, ceil(n/32)).
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
