// The paper's per-element FP32 -> MX arithmetic, shared by the converter
// (mx_quant.cu) and the fused KV write (mx_kv_write.cu), so both give
// codes and scales bit-identical to the plain converter by construction;
// and write_block, the one-warp-per-MX-block routine both run (the
// converter for rows its vectorized kernel does not take).
//
// Each function computes what its namesake in src/repro/core/convert.py
// computes (shared_scale, _quant_float_paper, _quant_float_ocp,
// _quant_int8, _marker_codes), in integers, bit for bit; the two float
// encoders take fewer operations than the reference's step sequence
// (the converter at the weight shape is bound by the integer pipe as
// much as by memory).  No floating-point arithmetic: an element enters
// as its sign, biased exponent and mantissa fields.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mxq {
namespace {  // internal linkage: each kernel file has its own copy

constexpr unsigned kFull = 0xffffffffu;

// One (format, mode) pair, as kernels/mx_quant.py::_format_args packs it.
struct Fmt {
  int mbits, bias, is_int, paper, max_exp_paper, max_exp_ocp, max_mant_top,
      nan_mant, emax_ocp, exp_mask, sign_shift;
};

// Step 2: the block's E8M0 scale from its largest finite biased exponent.
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

// Paper mode (_quant_float_paper): R+1 kept mantissa bits rounded to R
// ties-away, flush to zero below the normal range, saturation.  The
// rounded significand adds onto the exponent field, so a rounding carry
// moves into the exponent by the addition (the reference's carry step),
// and the min() is its saturation: codes are ordered like the values
// they encode.
__device__ __forceinline__ int quant_float_paper(int sign, int exp, int man,
                                                 int xs, const Fmt& f) {
  const int R = f.mbits;
  const int eb = exp - xs + f.bias;                // element's biased exp
  const int rnd = ((man >> (22 - R)) + 1) >> 1;    // ties-away, in [0, 2^R]
  const int body = min((eb << R) + rnd,
                       (f.max_exp_paper << R) | ((1 << R) - 1));
  return (sign << f.sign_shift) | ((eb <= 0 || exp == 0) ? 0 : body);
}

// OCP mode (_quant_float_ocp): round to nearest even with sticky bits,
// subnormals, saturation to the largest finite code.  q counts units of
// the format's last place at exponent max(eb, 1), rounded RNE by the
// add-half-minus-one-plus-lsb identity (shift >= 20, so never 0); adding
// it onto (max(eb, 1) - 1) << R gives the code body of normals,
// subnormals, a mantissa carry and a subnormal rounding up to the
// smallest normal alike, and min() saturates (codes are ordered like
// their values).  tests/test_torch_quant_arith.py holds this form and
// the paper one against the reference's step sequence.
__device__ __forceinline__ int quant_float_ocp(int sign, int exp, int man,
                                               int xs, const Fmt& f) {
  const int R = f.mbits;
  const int eb = exp - xs + f.bias;
  const int sig = (1 << 23) | man;                 // 24-bit significand
  const int shift = min((23 - R) + max(1 - eb, 0), 30);
  const int q = (sig + (1 << (shift - 1)) - 1 + ((sig >> shift) & 1)) >> shift;
  const int body = min(((max(eb, 1) - 1) << R) + q,
                       (f.max_exp_ocp << R) | f.max_mant_top);
  return (sign << f.sign_shift) | (exp == 0 ? 0 : body);
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

// Step 3 for one element (f32 bits) under the block's scale xs and flags.
__device__ __forceinline__ int encode(int bits, int xs, const Fmt& f,
                                      bool any_nan, bool any_inf) {
  const int sign = (bits >> 31) & 1;
  const int exp = (bits >> 23) & 0xFF;
  const int man = bits & 0x7FFFFF;
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
  return code;
}

// An element's contribution to step 1: its biased exponent if finite
// (else 0), and whether it is a NaN or an Inf.
__device__ __forceinline__ void classify(int bits, int& ev, bool& nan,
                                         bool& inf) {
  const int exp = (bits >> 23) & 0xFF;
  const bool finite = exp != 0xFF;
  ev = finite ? exp : 0;
  nan = !finite && (bits & 0x7FFFFF) != 0;
  inf = !finite && (bits & 0x7FFFFF) == 0;
}

// Where write_block stores one role's codes and scales.
struct Side {
  Fmt f;
  int kind;          // 0 one code per byte, 1 4-bit packed, 2 6-bit packed
  int cb;            // bytes of one code row
  uint8_t* codes;
  uint8_t* scales;
};

__device__ __forceinline__ int load_bits(const float* p) {
  return __float_as_int(*p);
}

__device__ __forceinline__ int load_bits(const __nv_bfloat16* p) {
  return (int)((unsigned)__bfloat16_as_ushort(*p) << 16);
}

// One warp, one lane per element: quantize 32-element block j of the row
// src (hd elements, f32 or bf16; a bf16 widens exactly) and store its
// codes and scale at destination row ``dst``.  Lanes past hd read 0,
// which never moves the block's maximum exponent.  Kind 0 stores the
// lanes below cb: a ragged row's end (converter) or, where cb covers
// the block, zero padding codes (KV cache).  Kinds 1 and 2 pack in
// registers: 4-bit codes 2 per byte, low nibble first; 6-bit codes 4
// per 3 bytes, little-endian.  Lane 0 stores the scale.
template <typename T>
__device__ __forceinline__ void write_block(const T* __restrict__ src,
                                            const Side& d, long long dst,
                                            int hd, int nblk, int j,
                                            int lane) {
  const int col = j * 32 + lane;
  const bool in = col < hd;
  const int bits = in ? load_bits(src + col) : 0;
  int ev;
  bool nan, inf;
  classify(bits, ev, nan, inf);
  // step 1: comparator tree over the finite exponents; NaN/Inf flags
  const bool any_nan = __any_sync(kFull, nan);
  const bool any_inf = __any_sync(kFull, inf);
  const int ev_max = __reduce_max_sync(kFull, ev);
  // step 2: shared E8M0 scale; step 3: this lane's private element
  const int xs = shared_scale(ev_max, d.f, any_nan, any_inf);
  const int code = in ? encode(bits, xs, d.f, any_nan, any_inf) : 0;
  uint8_t* row = d.codes + dst * d.cb;
  if (d.kind == 0) {
    if (col < d.cb) row[col] = (uint8_t)code;
  } else if (d.kind == 1) {
    const int next = __shfl_down_sync(kFull, code, 1);
    if ((lane & 1) == 0) row[col >> 1] = (uint8_t)(code | (next << 4));
  } else {
    const int c1 = __shfl_down_sync(kFull, code, 1);
    const int c2 = __shfl_down_sync(kFull, code, 2);
    const int c3 = __shfl_down_sync(kFull, code, 3);
    if ((lane & 3) == 0) {
      const int w = code | (c1 << 6) | (c2 << 12) | (c3 << 18);
      uint8_t* o = row + (col >> 2) * 3;
      o[0] = (uint8_t)w;
      o[1] = (uint8_t)(w >> 8);
      o[2] = (uint8_t)(w >> 16);
    }
  }
  if (lane == 0) d.scales[dst * nblk + j] = (uint8_t)xs;
}

}  // namespace
}  // namespace mxq
