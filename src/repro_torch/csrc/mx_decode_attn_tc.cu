// MX decode attention for bf16 q on Hopper's tensor cores, sm_90a, over a
// contiguous cache and over a page pool.
//
// Replaces the Pallas kernels src/repro/kernels/mx_decode_attn.py::
// _mx_decode_attention (body _decode_kernel) and ::
// _mx_paged_decode_attention (body _paged_kernel) for bf16 q, the serving
// path's type; f32 q runs the CUDA-core kernels of mx_decode_attn.cu and
// mx_paged_decode_attn.cu.  One query token per row, GQA (query head h
// reads KV head h / rep).  Contiguous: codes (B, S, Hkv, D) one per byte,
// every row attends positions <= pos.  Paged: pools (P, page, Hkv, CB),
// sub-byte codes bit-packed along D (E2M1 two per byte, low nibble
// first; E3M2/E2M3 four per three bytes, little-endian), slot b attends
// positions <= lengths[b] through its block-table row.  Scales are E8M0,
// one per 32 codes.
//
// Arithmetic.  The reference widens q to f32, dequantizes K and V to f32
// (elem * 2^(s-127)) and forms S = q K^T / sqrt(D) and P V in f32.  Every
// element value is a bf16, and so is elem * 2^(s-127) for scale codes >=
// 10 (tests/test_torch_tables.py), so each code is decoded through the
// element and scale tables (built by the plain functions), the scale is
// folded in and the product rounded once to bf16 — exact — and
// mma.sync.m16n8k16 bf16 -> f32 forms the reference's products, summed in
// another order.  The online softmax runs in f32 on the accumulator
// registers with expf: scores divided by sqrt(D), NEG_INF = -1e30 for
// masked positions, row max and sum over the quad of lanes sharing a row.
// P enters P V as two bf16 parts, hi = bf16(p) and lo = bf16(p - hi), in
// two mma (a single rounding of P costs up to 2^-9 |v| per key, above the
// bf16 criterion at outputs near 0); l sums the f32 P.  The output is
// divided by l (1 where l == 0) and rounded to bf16, as the reference's.
//
// Design.  The rep query heads of one KV head are the M of the mma: one
// m16 tile for chatglm3-6b's 32 / 2 = 16; fewer pad with zero rows that
// are never stored, more take ceil(rep / 16) m-tiles as separate blocks.
// Block (KV head x m-tile, row, split) of 4 warps walks the split's
// positions in 16-token tiles, warp w taking tiles w, w + 4, ...; a block
// reads its own block-table entries and length (paged) and no position
// past the row's last.  The contraction order over D is free, so D is
// permuted alike in Q and K: in k-step kk, lane quad t's four k values
// are D indices t*D/4 + 4kk + 0..3, so a lane's K fragments for a token
// come from one load of D/4 consecutive codes (one 32-byte load of INT8
// codes at D = 128) and one scale.  Q is read once, straight into A
// fragments in that order.  For P V the output's D is permuted instead:
// n-tile j, column g is D index g*D/8 + j, so a lane's V fragments for a
// token are D/8 consecutive codes and one scale; the permutation is undone
// when the warps' results go to shared memory.  P comes from the S
// accumulators (the m16n8 C layout is the m16k16 A layout).  The split
// kernel is built for each pair of K and V storage kinds, so a warp runs
// one decode path.  The codes of a warp's first tile are requested before
// the tables and Q are read, and those of its next tile before the mma of
// the current one.  The 4 warps' (m, l, acc) merge through shared memory in
// warp order into one record per block; a second kernel, one block per
// (query head, row) and one thread per output element, merges the
// records in split order and stores bf16.  No atomics: the result does
// not depend on the launch.
//
// Bound.  Bytes: the live positions' codes and scales once per KV head,
// plus q, the output and the records.  At the serving shape (8 rows of
// <= 576 positions, 2 KV heads) that is ~2.4 MB, well under a
// microsecond at 3.35 TB/s: latency and the number of blocks in flight
// bound these kernels, so the split fills the card (kernels/
// mx_decode_attn.py::split_tokens) and the merge spreads over Hq x B
// blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16;               // positions of one warp step
constexpr int kRows = 16;               // query heads of a block: one m16
constexpr int kPass = kWarps * kTile;   // positions of one pass of a block

struct Args {
  const __nv_bfloat16* q;   // (B, Hq, D)
  const uint8_t* kc;
  const uint8_t* ks;
  const uint8_t* vc;
  const uint8_t* vs;
  const int* bt;            // paged: (B, max_pages)
  const int* lengths;       // paged: (B,)
  const float* ktab;        // element tables, 256 entries
  const float* vtab;
  const float* stab;        // scale table, 256 entries
  float* part;              // records (B, Hkv * mtiles, nsplit, rec)
  __nv_bfloat16* out;       // (B, Hq, D)
  int hq, hkv, rep, mtiles;
  const int* pos_p;         // contiguous: pos in device memory, or null
  int s_len, pos;           // contiguous (pos when pos_p is null)
  int page, max_pages;      // paged
  int cb_k, cb_v, kkind, vkind;   // bytes per code row; 0 u8, 1 4-bit, 2 6-bit
  int split_tokens, nsplit;
};

// record of one block: [kRows m | kRows l | kRows x D acc]
template <int D>
__host__ __device__ constexpr int rec_floats() {
  return 2 * kRows + kRows * D;
}

// positions 0 .. live - 1 that row b attends
template <bool PAGED>
__device__ __forceinline__ int live_of(const Args& a, int b) {
  if (PAGED) return min(a.lengths[b] + 1, a.max_pages * a.page);
  return min((a.pos_p != nullptr ? *a.pos_p : a.pos) + 1, a.s_len);
}

// token-head row of position tok of row b, KV head g
template <bool PAGED>
__device__ __forceinline__ long long token_row(const Args& a, int b, int g,
                                               int tok) {
  if (PAGED) {
    const long long phys =
        __ldg(a.bt + (long long)b * a.max_pages + tok / a.page);
    return (phys * a.page + tok % a.page) * a.hkv + g;
  }
  return ((long long)b * a.s_len + tok) * a.hkv + g;
}

__host__ __device__ constexpr int align_of(int nb) {
  return (nb & -nb) < 16 ? (nb & -nb) : 16;
}

// NB bytes at p into w (zeroed), little-endian.  p is aligned to the
// largest power of two dividing NB, up to 16: every code row starts
// 16-byte aligned and a lane's bytes start at a multiple of NB.
template <int NB>
__device__ __forceinline__ void ld_bytes(uint32_t* w, const uint8_t* p) {
  constexpr int AL = align_of(NB);
  if constexpr (AL == 16) {
#pragma unroll
    for (int i = 0; i < NB / 16; ++i) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + i);
      w[4 * i] = v.x;
      w[4 * i + 1] = v.y;
      w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
  } else if constexpr (AL == 8) {
#pragma unroll
    for (int i = 0; i < NB / 8; ++i) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p) + i);
      w[2 * i] = v.x;
      w[2 * i + 1] = v.y;
    }
  } else if constexpr (AL == 4) {
#pragma unroll
    for (int i = 0; i < NB / 4; ++i)
      w[i] = __ldg(reinterpret_cast<const unsigned int*>(p) + i);
  } else if constexpr (AL == 2) {
#pragma unroll
    for (int i = 0; i < NB / 2; ++i)
      w[i / 2] |= (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p) +
                                  i)
                  << (16 * (i & 1));
  } else {
#pragma unroll
    for (int i = 0; i < NB; ++i)
      w[i / 4] |= (uint32_t)__ldg(p + i) << (8 * (i & 3));
  }
}

// NC codes from code c0 of a code row (c0 and NC multiples of 4), stored
// as `kind`, into w (NC bytes' worth of words)
template <int NC>
__device__ __forceinline__ void ld_codes(uint32_t (&w)[NC / 4],
                                         const uint8_t* row, int c0,
                                         int kind) {
#pragma unroll
  for (int i = 0; i < NC / 4; ++i) w[i] = 0;
  if (kind == 0) {
    ld_bytes<NC>(w, row + c0);
  } else if (kind == 1) {
    ld_bytes<NC / 2>(w, row + c0 / 2);
  } else {
    ld_bytes<3 * NC / 4>(w, row + 3 * c0 / 4);
  }
}

// codes 4i .. 4i + 3 of w, one per byte
template <int NW>
__device__ __forceinline__ uint32_t quad(const uint32_t (&w)[NW], int i,
                                         int kind) {
  if (kind == 0) return w[i];
  if (kind == 1) {
    const uint32_t x = w[i >> 1] >> (16 * (i & 1));
    return (x & 0xF) | ((x >> 4) & 0xF) << 8 | ((x >> 8) & 0xF) << 16 |
           ((x >> 12) & 0xF) << 24;
  }
  const int bit = 24 * i, j = bit >> 5, s = bit & 31;
  uint32_t x = w[j] >> s;
  if (s > 8) x |= w[j + 1] << (32 - s);
  return (x & 0x3F) | ((x >> 6) & 0x3F) << 8 | ((x >> 12) & 0x3F) << 16 |
         ((x >> 18) & 0x3F) << 24;
}

// two f32 as the low / high half of a bf16x2 (round to nearest even)
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// p0, p1 as hi = bf16(p) and lo = bf16(p - hi), each a bf16x2
__device__ __forceinline__ void split_hi_lo(float p0, float p1, uint32_t& hi,
                                            uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack(p0 - hf.x, p1 - hf.y);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A lane's codes of one 16-position tile.  Lane (g, t) holds K of
// positions g and g + 8 (its D/4 codes from t*D/4) and V of positions 2t,
// 2t + 1, 2t + 8, 2t + 9 (its D/8 codes from g*D/8); byte i of ksc / vsc
// is the scale code of the i-th of those positions.  Positions past the
// split's end hold zero codes and scale codes, which decode to 0.
template <int D>
struct Tile {
  uint32_t k[2][D / 16];
  uint32_t v[4][D / 32];
  uint32_t ksc, vsc;
};

template <int D, bool PAGED, int KK, int VK>
__device__ __forceinline__ void load_tile(Tile<D>& r, const Args& a, int b,
                                          int g, int tok0, int t1, int gq,
                                          int t) {
  constexpr int kNbl = D / 32;
  r.ksc = 0;
  r.vsc = 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int tok = tok0 + gq + 8 * i;
    if (tok < t1) {
      const long long row = token_row<PAGED>(a, b, g, tok);
      ld_codes<D / 4>(r.k[i], a.kc + row * a.cb_k, t * (D / 4), KK);
      r.ksc |= (uint32_t)__ldg(a.ks + row * kNbl + t * (D / 4) / 32)
               << (8 * i);
    } else {
#pragma unroll
      for (int w = 0; w < D / 16; ++w) r.k[i][w] = 0;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int tok = tok0 + 2 * t + (i & 1) + 8 * (i >> 1);
    if (tok < t1) {
      const long long row = token_row<PAGED>(a, b, g, tok);
      ld_codes<D / 8>(r.v[i], a.vc + row * a.cb_v, gq * (D / 8), VK);
      r.vsc |= (uint32_t)__ldg(a.vs + row * kNbl + gq * (D / 8) / 32)
               << (8 * i);
    } else {
#pragma unroll
      for (int w = 0; w < D / 32; ++w) r.v[i][w] = 0;
    }
  }
}

// Fold one tile into the warp's online softmax: rows g (m[0], l[0],
// o[.][0..1]) and g + 8 (m[1], l[1], o[.][2..3]) of the m16 tile.
template <int D, int KK, int VK>
__device__ __forceinline__ void tile_step(
    const Tile<D>& r, const uint32_t (&qf)[D / 16][4], const float* ktab,
    const float* vtab, const float* stab, float (&o)[D / 8][4],
    float (&m)[2], float (&l)[2], int tok0, int t1, int t) {
  // S = Q K^T: n-tile nt holds positions tok0 + 8nt + 2t (+1)
  float s[2][4];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
  const float sk[2] = {stab[r.ksc & 0xFF], stab[(r.ksc >> 8) & 0xFF]};
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const uint32_t c = quad(r.k[nt], kk, KK);
      const uint32_t b0 = pack(ktab[c & 0xFF] * sk[nt],
                               ktab[(c >> 8) & 0xFF] * sk[nt]);
      const uint32_t b1 = pack(ktab[(c >> 16) & 0xFF] * sk[nt],
                               ktab[c >> 24] * sk[nt]);
      mma_bf16(s[nt], qf[kk], b0, b1);
    }

  // online softmax in f32, as the reference: scores / sqrt(D), masked
  const float sqrt_d = sqrtf((float)D);
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int tok = tok0 + 8 * nt + 2 * t + (e & 1);
      const float x = tok < t1 ? s[nt][e] / sqrt_d : kNegInf;
      s[nt][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    alpha[i] = expf(m[i] - mx[i]);
    m[i] = mx[i];
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = expf(s[nt][e] - mx[e >> 1]);
      rs[e >> 1] += p;
      s[nt][e] = p;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
    rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
    l[i] = l[i] * alpha[i] + rs[i];
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];

  // P as A fragments: (g, 2t), (g + 8, 2t), (g, 2t + 8), (g + 8, 2t + 8)
  uint32_t ph[4], pl[4];
  split_hi_lo(s[0][0], s[0][1], ph[0], pl[0]);
  split_hi_lo(s[0][2], s[0][3], ph[1], pl[1]);
  split_hi_lo(s[1][0], s[1][1], ph[2], pl[2]);
  split_hi_lo(s[1][2], s[1][3], ph[3], pl[3]);

  // O += P V: n-tile j, column g is D index g*D/8 + j
  float sv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) sv[i] = stab[(r.vsc >> (8 * i)) & 0xFF];
#pragma unroll
  for (int qi = 0; qi < D / 32; ++qi) {
    uint32_t c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] = quad(r.v[i], qi, VK);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = vtab[(c[i] >> (8 * jj)) & 0xFF] * sv[i];
      const uint32_t b0 = pack(v[0], v[1]), b1 = pack(v[2], v[3]);
      mma_bf16(o[4 * qi + jj], ph, b0, b1);
      mma_bf16(o[4 * qi + jj], pl, b0, b1);
    }
  }
}

// grid (Hkv * mtiles, B, nsplit): one record per block with a live split.
// KK / VK: how K and V codes are stored (a compile-time constant, so a
// warp's straight-line code holds one decode path)
template <int D, bool PAGED, int KK, int VK>
__global__ void __launch_bounds__(kThreads, 2)
    mx_decode_attn_tc_kernel(const Args a) {
  __shared__ float tab[3][256];
  __shared__ float wm[kWarps][kRows], wl[kWarps][kRows], wsc[kWarps][kRows];
  __shared__ float wacc[kWarps][kRows][D + 4];   // +4: fewer bank clashes

  const int x = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int g = x / a.mtiles, mt = x % a.mtiles;
  const int live = live_of<PAGED>(a, b);
  const int t0 = split * a.split_tokens;
  if (t0 >= live) return;                 // no live position in this split
  const int t1 = min(live, t0 + a.split_tokens);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;  // fragment row, quad lane

  // the first tile's codes in flight before the tables and Q are read
  const int first = t0 + kTile * warp;
  Tile<D> cur;
  if (first < t1) load_tile<D, PAGED, KK, VK>(cur, a, b, g, first, t1, gq, t);
  for (int i = tid; i < 256; i += kThreads) {
    tab[0][i] = a.ktab[i];
    tab[1][i] = a.vtab[i];
    tab[2][i] = a.stab[i];
  }
  // Q rows gq and gq + 8 of this m-tile (zero past rep) as A fragments
  // in the permuted D order: word 2kk (+1) of a row's D/4 values from
  // t*D/4 holds its k values 2t, 2t + 1 (2t + 8, 2t + 9) of k-step kk
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = mt * kRows + gq + 8 * h;
    uint32_t w[D / 8];
    if (row < a.rep) {
      const uint4* p = reinterpret_cast<const uint4*>(
          a.q + ((long long)b * a.hq + g * a.rep + row) * D + t * (D / 4));
#pragma unroll
      for (int i = 0; i < D / 32; ++i) {
        const uint4 v = __ldg(p + i);
        w[4 * i] = v.x;
        w[4 * i + 1] = v.y;
        w[4 * i + 2] = v.z;
        w[4 * i + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < D / 8; ++i) w[i] = 0;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qf[kk][h] = w[2 * kk];
      qf[kk][2 + h] = w[2 * kk + 1];
    }
  }

  float o[D / 8][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  __syncthreads();                        // tables in
  for (int tok0 = first; tok0 < t1; tok0 += kPass) {
    const bool more = tok0 + kPass < t1;
    Tile<D> nxt;
    if (more)
      load_tile<D, PAGED, KK, VK>(nxt, a, b, g, tok0 + kPass, t1, gq, t);
    tile_step<D, KK, VK>(cur, qf, tab[0], tab[1], tab[2], o, m, l, tok0, t1,
                         t);
    if (more) cur = nxt;
  }

  // the warps' states, D un-permuted, then merged in warp order
  if (t == 0) {
    wm[warp][gq] = m[0];
    wm[warp][gq + 8] = m[1];
    wl[warp][gq] = l[0];
    wl[warp][gq + 8] = l[1];
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      wacc[warp][gq + 8 * (e >> 1)][(2 * t + (e & 1)) * (D / 8) + j] =
          o[j][e];
  __syncthreads();
  float* rec = a.part + (((long long)b * gridDim.x + x) * a.nsplit + split) *
                            rec_floats<D>();
  if (tid < kRows) {
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, wm[w][tid]);
    float ll = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float sc = expf(wm[w][tid] - mm);
      wsc[w][tid] = sc;
      ll = fmaf(wl[w][tid], sc, ll);
    }
    rec[tid] = mm;
    rec[kRows + tid] = ll;
  }
  __syncthreads();
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int row = i / D, dd = i % D;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      acc = fmaf(wacc[w][row][dd], wsc[w][row], acc);
    rec[2 * kRows + i] = acc;
  }
}

// grid (Hq, B), D threads: one output element each, the row's live
// records merged in split order, the l == 0 -> 1 guard, bf16 out
template <int D, bool PAGED>
__global__ void __launch_bounds__(D) mx_decode_attn_merge_kernel(
    const Args a) {
  const int h = blockIdx.x, b = blockIdx.y, dd = threadIdx.x;
  const int g = h / a.rep, ri = h % a.rep;
  const int x = g * a.mtiles + ri / kRows, r = ri % kRows;
  const int live = live_of<PAGED>(a, b);
  const int ns = min(a.nsplit, (live + a.split_tokens - 1) / a.split_tokens);
  const float* base =
      a.part + ((long long)b * a.hkv * a.mtiles + x) * a.nsplit *
                   rec_floats<D>();
  float mm = kNegInf;
  for (int s = 0; s < ns; ++s) mm = fmaxf(mm, base[s * rec_floats<D>() + r]);
  float ll = 0.f, acc = 0.f;
  for (int s = 0; s < ns; ++s) {
    const float* rec = base + s * rec_floats<D>();
    const float w = expf(rec[r] - mm);
    ll = fmaf(rec[kRows + r], w, ll);
    acc = fmaf(rec[2 * kRows + r * D + dd], w, acc);
  }
  a.out[((long long)b * a.hq + h) * D + dd] =
      __float2bfloat16(acc / (ll == 0.f ? 1.f : ll));
}

template <int D, bool PAGED, int KK, int VK>
int launch_d(const Args& a, int bsz, cudaStream_t st) {
  const dim3 grid(a.hkv * a.mtiles, bsz, a.nsplit);
  mx_decode_attn_tc_kernel<D, PAGED, KK, VK><<<grid, kThreads, 0, st>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mx_decode_attn_merge_kernel<D, PAGED><<<dim3(a.hq, bsz), D, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// the paged kernel for each pair of storage kinds; the contiguous cache
// holds one code per byte
template <int D, bool PAGED>
int launch_kinds(const Args& a, int bsz, cudaStream_t st) {
  if constexpr (!PAGED) {
    return launch_d<D, false, 0, 0>(a, bsz, st);
  } else {
    switch (3 * a.kkind + a.vkind) {
      case 0: return launch_d<D, true, 0, 0>(a, bsz, st);
      case 1: return launch_d<D, true, 0, 1>(a, bsz, st);
      case 2: return launch_d<D, true, 0, 2>(a, bsz, st);
      case 3: return launch_d<D, true, 1, 0>(a, bsz, st);
      case 4: return launch_d<D, true, 1, 1>(a, bsz, st);
      case 5: return launch_d<D, true, 1, 2>(a, bsz, st);
      case 6: return launch_d<D, true, 2, 0>(a, bsz, st);
      case 7: return launch_d<D, true, 2, 1>(a, bsz, st);
      case 8: return launch_d<D, true, 2, 2>(a, bsz, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
}

template <bool PAGED>
int launch(Args& a, int bsz, int d, cudaStream_t st) {
  if (bsz == 0) return 0;
  a.rep = a.hq / a.hkv;
  a.mtiles = (a.rep + kRows - 1) / kRows;
  switch (d) {
    case 32: return launch_kinds<32, PAGED>(a, bsz, st);
    case 64: return launch_kinds<64, PAGED>(a, bsz, st);
    case 128: return launch_kinds<128, PAGED>(a, bsz, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Hq, D) bf16, 16-byte aligned; codes (B, S, Hkv, D) u8, one code
// per byte, 16-byte aligned; scales (B, S, Hkv, D/32) u8; out like q;
// D in {32, 64, 128}; 0 <= pos, read from pos_dev (one int32 in device
// memory) when that is not null.  part: B * Hkv * ceil(Hq / Hkv / 16) *
// nsplit records of 16 * (D + 2) floats; split_tokens a multiple of 64
// with nsplit * split_tokens >= S: the grid is sized from S, so a launch
// does not depend on pos, and the splits past min(pos + 1, S) return at
// once and the merge skips them.
extern "C" int mx_decode_attn_tc_launch(
    const void* q, const void* kc, const void* ks, const void* vc,
    const void* vs, const void* pos_dev, const void* ktab, const void* vtab,
    const void* stab, void* part, void* out, int bsz, int hq, int hkv, int d,
    int s_len, int pos, int split_tokens, int nsplit, void* stream) {
  Args a{};
  a.q = (const __nv_bfloat16*)q;
  a.kc = (const uint8_t*)kc;
  a.ks = (const uint8_t*)ks;
  a.vc = (const uint8_t*)vc;
  a.vs = (const uint8_t*)vs;
  a.ktab = (const float*)ktab;
  a.vtab = (const float*)vtab;
  a.stab = (const float*)stab;
  a.part = (float*)part;
  a.out = (__nv_bfloat16*)out;
  a.hq = hq;
  a.hkv = hkv;
  a.pos_p = (const int*)pos_dev;
  a.s_len = s_len;
  a.pos = pos;
  a.cb_k = a.cb_v = d;
  a.split_tokens = split_tokens;
  a.nsplit = nsplit;
  return launch<false>(a, bsz, d, (cudaStream_t)stream);
}

// q as above; pools (P, page, Hkv, CB) u8, 16-byte aligned, and (P, page,
// Hkv, D/32) u8; block_tables (B, max_pages) i32; lengths (B,) i32; kkind
// / vkind: 0 one code per byte, 1 4-bit, 2 6-bit.  part as above with
// nsplit * split_tokens >= max_pages * page.
extern "C" int mx_paged_decode_attn_tc_launch(
    const void* q, const void* kc, const void* ks, const void* vc,
    const void* vs, const void* block_tables, const void* lengths,
    const void* ktab, const void* vtab, const void* stab, void* part,
    void* out, int bsz, int hq, int hkv, int d, int page, int max_pages,
    int cb_k, int cb_v, int kkind, int vkind, int split_tokens, int nsplit,
    void* stream) {
  Args a{};
  a.q = (const __nv_bfloat16*)q;
  a.kc = (const uint8_t*)kc;
  a.ks = (const uint8_t*)ks;
  a.vc = (const uint8_t*)vc;
  a.vs = (const uint8_t*)vs;
  a.bt = (const int*)block_tables;
  a.lengths = (const int*)lengths;
  a.ktab = (const float*)ktab;
  a.vtab = (const float*)vtab;
  a.stab = (const float*)stab;
  a.part = (float*)part;
  a.out = (__nv_bfloat16*)out;
  a.hq = hq;
  a.hkv = hkv;
  a.page = page;
  a.max_pages = max_pages;
  a.cb_k = cb_k;
  a.cb_v = cb_v;
  a.kkind = kkind;
  a.vkind = vkind;
  a.split_tokens = split_tokens;
  a.nsplit = nsplit;
  return launch<true>(a, bsz, d, (cudaStream_t)stream);
}
