// MX decode attention over a contiguous cache for f32 q on Hopper's CUDA
// cores, sm_90a (bf16 q runs the tensor-core kernel of
// mx_decode_attn_tc.cu).
//
// Replaces the Pallas kernel
// src/repro/kernels/mx_decode_attn.py::_mx_decode_attention (body
// _decode_kernel).  One query token per row, GQA (query head h reads KV
// head h / rep), over a contiguous (B, S, Hkv, D) cache of MX codes (one
// code per byte, every format) + (B, S, Hkv, D/32) E8M0 scales, K and V
// each in their own element format; every row attends positions <= pos,
// a scalar shared by the batch.
//
// Design.  A block owns one (row, KV head) and computes all rep = Hq / Hkv
// query heads of that group (16 for chatglm3-6b), so the cache is read
// once per KV head, not once per query head as in the Pallas grid
// (B, Hq, S / blk_k).  The live positions 0..pos are split over blocks,
// `tokens_per_split` each (the grid's third axis); the mask is shared by
// the batch, so every block of a row has work and none walks a position
// past pos — in the Pallas kernel the masked tiles contribute exactly
// zero (alpha = 1, p = 0), so skipping them changes nothing.  A block
// walks its positions in tiles of 16 tokens: it loads K and V codes as
// words of four, dequantizes them into shared memory (code -> value table
// per role, times 2^(s-127) from the scale table: exactly the reference's
// values) and folds the tile into the online softmax in f32 with expf
// (mxattn::tile_update, shared with the paged kernel).  A second kernel
// merges the blocks' (max, sum, acc) partials of each (row, KV head) in
// split order — deterministic, no atomics — and applies the l == 0 -> 1
// guard.
//
// Bound.  Bytes: the live positions' codes and scales once per KV head,
// plus q, the output and the partials; the per-element work (a table
// lookup, a multiply and two FMAs per query head) sits under the memory
// line.  Splitting the positions over blocks is what puts enough of them
// in flight at a batch of 8.
#include "mx_decode_attn_common.cuh"

namespace {

using mxattn::kNegInf;
using mxattn::kThreads;

constexpr int kTile = 16;                      // tokens per shared tile

__global__ void __launch_bounds__(kThreads) decode_attn_split_kernel(
    const float* __restrict__ q, const uint8_t* __restrict__ kc,
    const uint8_t* __restrict__ ks, const uint8_t* __restrict__ vc,
    const uint8_t* __restrict__ vs, const float* __restrict__ ktab_g,
    const float* __restrict__ vtab_g, const float* __restrict__ stab_g,
    float* __restrict__ part, int hq, int hkv, int d, int s_len, int pos,
    int tokens_per_split) {
  extern __shared__ float smem[];
  const int rep = hq / hkv;
  const int ds = d + 1;                        // padded row: no bank clash
  float* ktab = smem;
  float* vtab = ktab + 256;
  float* stab = vtab + 256;
  float* q_s = stab + 256;                     // rep x d
  float* k_s = q_s + rep * d;                  // tile x ds
  float* v_s = k_s + kTile * ds;               // tile x d
  float* p_s = v_s + kTile * d;                // rep x tile
  float* acc = p_s + rep * kTile;              // rep x d
  float* m_s = acc + rep * d;                  // rep
  float* l_s = m_s + rep;                      // rep
  float* a_s = l_s + rep;                      // rep

  const int g = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int nsplit = gridDim.z, tid = threadIdx.x;
  const int nbl = d / 32, nq = d / 4;
  const int live = min(pos + 1, s_len);        // positions 0 .. live-1
  const int t0 = split * tokens_per_split;     // < live by the grid's size
  const int t1 = min(live, t0 + tokens_per_split);
  for (int i = tid; i < 256; i += kThreads) {
    ktab[i] = ktab_g[i];
    vtab[i] = vtab_g[i];
    stab[i] = stab_g[i];
  }
  const float* qb = q + ((long long)b * hq + g * rep) * d;
  for (int i = tid; i < rep * d; i += kThreads) {
    q_s[i] = qb[i];
    acc[i] = 0.f;
  }
  for (int h = tid; h < rep; h += kThreads) {
    m_s[h] = kNegInf;
    l_s[h] = 0.f;
  }
  for (int tt = t0; tt < t1; tt += kTile) {
    const int n = min(kTile, t1 - tt);         // tokens of this tile
    __syncthreads();                           // previous tile consumed
    for (int i = tid; i < n * nq; i += kThreads) {
      const int t = i / nq, qd = i % nq;
      const long long th = ((long long)b * s_len + tt + t) * hkv + g;
      const uint32_t kw =
          *reinterpret_cast<const uint32_t*>(kc + th * d + 4 * qd);
      const uint32_t vw =
          *reinterpret_cast<const uint32_t*>(vc + th * d + 4 * qd);
      const float sk = stab[ks[th * nbl + qd / 8]];
      const float sv = stab[vs[th * nbl + qd / 8]];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        k_s[t * ds + 4 * qd + j] = ktab[(kw >> (8 * j)) & 0xFF] * sk;
        v_s[t * d + 4 * qd + j] = vtab[(vw >> (8 * j)) & 0xFF] * sv;
      }
    }
    __syncthreads();
    mxattn::tile_update(q_s, k_s, v_s, p_s, acc, m_s, l_s, a_s, rep, d, n,
                        n);
  }
  __syncthreads();
  float* out = part + (((long long)b * hkv + g) * nsplit + split) *
                          (rep * d + 2 * rep);
  for (int i = tid; i < rep * d; i += kThreads) out[i] = acc[i];
  for (int h = tid; h < rep; h += kThreads) {
    out[rep * d + h] = m_s[h];
    out[rep * d + rep + h] = l_s[h];
  }
}

int launch(const void* q, const void* kc, const void* ks, const void* vc,
           const void* vs, const void* ktab, const void* vtab,
           const void* stab, void* part, void* out, int bsz, int hq, int hkv,
           int d, int s_len, int pos, int tokens_per_split, cudaStream_t st) {
  const int rep = hq / hkv;
  const size_t floats = 3 * 256 + (size_t)rep * d + (size_t)kTile * (d + 1) +
                        (size_t)kTile * d + (size_t)rep * kTile +
                        (size_t)rep * d + 3 * (size_t)rep;
  const size_t bytes = floats * sizeof(float);
  if (bytes > 48 * 1024) {
    cudaFuncSetAttribute(decode_attn_split_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
  }
  const int live = min(pos + 1, s_len);
  const int nsplit = (live + tokens_per_split - 1) / tokens_per_split;
  decode_attn_split_kernel<<<dim3(hkv, bsz, nsplit), kThreads, bytes,
                             st>>>(
      (const float*)q, (const uint8_t*)kc, (const uint8_t*)ks,
      (const uint8_t*)vc, (const uint8_t*)vs, (const float*)ktab,
      (const float*)vtab, (const float*)stab, (float*)part, hq, hkv, d,
      s_len, pos, tokens_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mxattn::merge_splits_kernel<<<dim3(hkv, bsz), kThreads, 0, st>>>(
      (const float*)part, (float*)out, hq, hkv, d, nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Hq, D) f32; codes (B, S, Hkv, D) u8, one code
// per byte, rows 4-byte aligned; scales (B, S, Hkv, D/32) u8; out like q;
// 0 <= pos.  part: B * Hkv * ceil(min(pos + 1, S) / tokens_per_split)
// records of (Hq/Hkv) * (D + 2) floats.
extern "C" int mx_decode_attn_launch(
    const void* q, const void* kc, const void* ks, const void* vc,
    const void* vs, const void* ktab, const void* vtab, const void* stab,
    void* part, void* out, int bsz, int hq, int hkv, int d, int s_len,
    int pos, int tokens_per_split, void* stream) {
  if (bsz == 0) return 0;
  return launch(q, kc, ks, vc, vs, ktab, vtab, stab, part, out, bsz, hq, hkv,
                d, s_len, pos, tokens_per_split, (cudaStream_t)stream);
}
