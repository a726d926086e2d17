// Paged MX decode attention for f32 q on Hopper's CUDA cores, sm_90a
// (bf16 q runs the tensor-core kernel of mx_decode_attn_tc.cu).
//
// Replaces the Pallas kernel
// src/repro/kernels/mx_decode_attn.py::_mx_paged_decode_attention (body
// _paged_kernel).  One query token per slot, GQA, over a page pool of MX
// codes + E8M0 scales reached through a per-slot block table; slot b
// attends logical positions <= lengths[b]; page 0 is the trash page.  K
// and V carry their own element formats and storage (sub-byte codes
// bit-packed along D: E2M1 two per byte, E3M2/E2M3 four per three bytes,
// as pack_codes in src/repro/core/pack.py).
//
// Design.  A block owns one (slot, KV head) and computes all rep =
// Hq / Hkv query heads of that group (16 for chatglm3-6b), so each page's
// quantized bytes are read once per KV head, not once per query head as
// in the Pallas grid (B, Hq, np_max).  The slot's pages are split over
// blocks, `pages_per_split` each (the grid's third axis): a block reads
// its own block-table entries and length and walks only pages holding
// positions <= lengths[b] — in the Pallas kernel the masked trailing
// pages contribute exactly zero (alpha = 1, p = 0), so skipping them
// changes nothing.  Per page it loads K and V codes as words of four
// elements, dequantizes them into shared memory (code -> value table per
// role, times 2^(s-127) from the scale table: exactly the reference's
// values), forms the rep x page scores and runs the TPU kernel's online
// softmax in f32 with expf (not __expf), NEG_INF = -1e30 for masked
// positions.  A second kernel merges the blocks' (max, sum, acc) partials
// of each (slot, KV head) in split order — deterministic — and applies the
// l == 0 -> 1 guard.
//
// Bound.  Bytes: the live pages' codes and scales once per KV head, plus
// q, the output and the (small) partials; the per-element work (a table
// lookup, a multiply and two FMAs per query head) sits under the memory
// line.  Splitting the pages over blocks is what puts enough of them in
// flight at small batch.
#include "mx_decode_attn_common.cuh"

namespace {

using mxattn::kNegInf;
using mxattn::kThreads;

// Codes 4q .. 4q+3 of one token-head row, packed into one word (byte i =
// code 4q+i).  kind: 0 one code per byte, 1 4-bit, 2 6-bit.
__device__ __forceinline__ uint32_t load_quad(const uint8_t* row, int q,
                                              int kind) {
  if (kind == 0) return *reinterpret_cast<const uint32_t*>(row + 4 * q);
  if (kind == 1) {
    const uint32_t b = *reinterpret_cast<const uint16_t*>(row + 2 * q);
    return (b & 0xF) | ((b >> 4) & 0xF) << 8 | ((b >> 8) & 0xF) << 16 |
           ((b >> 12) & 0xF) << 24;
  }
  const uint8_t* p = row + 3 * q;
  const uint32_t w = p[0] | (p[1] << 8) | (p[2] << 16);
  return (w & 0x3F) | ((w >> 6) & 0x3F) << 8 | ((w >> 12) & 0x3F) << 16 |
         ((w >> 18) & 0x3F) << 24;
}

__global__ void __launch_bounds__(kThreads) paged_attn_split_kernel(
    const float* __restrict__ q, const uint8_t* __restrict__ kc,
    const uint8_t* __restrict__ ks, const uint8_t* __restrict__ vc,
    const uint8_t* __restrict__ vs, const int* __restrict__ block_tables,
    const int* __restrict__ lengths, const float* __restrict__ ktab_g,
    const float* __restrict__ vtab_g, const float* __restrict__ stab_g,
    float* __restrict__ part, int hq, int hkv, int d, int page,
    int max_pages, int cb_k, int cb_v, int kpack, int vpack,
    int pages_per_split) {
  extern __shared__ float smem[];
  const int rep = hq / hkv;
  const int ds = d + 1;                        // padded row: no bank clash
  float* ktab = smem;
  float* vtab = ktab + 256;
  float* stab = vtab + 256;
  float* q_s = stab + 256;                     // rep x d
  float* k_s = q_s + rep * d;                  // page x ds
  float* v_s = k_s + page * ds;                // page x d
  float* p_s = v_s + page * d;                 // rep x page
  float* acc = p_s + rep * page;               // rep x d
  float* m_s = acc + rep * d;                  // rep
  float* l_s = m_s + rep;                      // rep
  float* a_s = l_s + rep;                      // rep

  const int g = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int nsplit = gridDim.z, tid = threadIdx.x;
  const int nbl = d / 32, nq = d / 4;
  const int len = lengths[b];
  const int npg = min(len / page + 1, max_pages);
  const int pg0 = split * pages_per_split;
  const int pg1 = min(npg, pg0 + pages_per_split);
  // partial record: [rep x d acc | rep m | rep l]
  float* out = part + (((long long)b * hkv + g) * nsplit + split) *
                          (rep * d + 2 * rep);
  if (pg0 >= pg1) {                            // no live page in this split
    for (int i = tid; i < rep * d; i += kThreads) out[i] = 0.f;
    for (int h = tid; h < rep; h += kThreads) {
      out[rep * d + h] = kNegInf;
      out[rep * d + rep + h] = 0.f;
    }
    return;
  }
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
  const int* bt = block_tables + (long long)b * max_pages;

  for (int pg = pg0; pg < pg1; ++pg) {
    const long long phys = bt[pg];
    __syncthreads();                           // previous page consumed
    for (int i = tid; i < page * nq; i += kThreads) {
      const int t = i / nq, qd = i % nq;
      const long long th = (phys * page + t) * hkv + g;  // token-head row
      const uint32_t kw = load_quad(kc + th * cb_k, qd, kpack);
      const uint32_t vw = load_quad(vc + th * cb_v, qd, vpack);
      const float sk = stab[ks[th * nbl + qd / 8]];
      const float sv = stab[vs[th * nbl + qd / 8]];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        k_s[t * ds + 4 * qd + j] = ktab[(kw >> (8 * j)) & 0xFF] * sk;
        v_s[t * d + 4 * qd + j] = vtab[(vw >> (8 * j)) & 0xFF] * sv;
      }
    }
    __syncthreads();
    mxattn::tile_update(q_s, k_s, v_s, p_s, acc, m_s, l_s, a_s, rep, d,
                        page, len - pg * page + 1);
  }
  __syncthreads();
  for (int i = tid; i < rep * d; i += kThreads) out[i] = acc[i];
  for (int h = tid; h < rep; h += kThreads) {
    out[rep * d + h] = m_s[h];
    out[rep * d + rep + h] = l_s[h];
  }
}

int launch(const void* q, const void* kc, const void* ks, const void* vc,
           const void* vs, const void* bt, const void* lengths,
           const void* ktab, const void* vtab, const void* stab, void* part,
           void* out, int bsz, int hq, int hkv, int d, int page,
           int max_pages, int cb_k, int cb_v, int kpack, int vpack,
           int pages_per_split, cudaStream_t st) {
  const int rep = hq / hkv;
  const size_t floats = 3 * 256 + (size_t)rep * d + (size_t)page * (d + 1) +
                        (size_t)page * d + (size_t)rep * page +
                        (size_t)rep * d + 3 * (size_t)rep;
  const size_t bytes = floats * sizeof(float);
  if (bytes > 48 * 1024) {
    cudaFuncSetAttribute(paged_attn_split_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
  }
  const int nsplit = (max_pages + pages_per_split - 1) / pages_per_split;
  dim3 grid(hkv, bsz, nsplit);
  paged_attn_split_kernel<<<grid, kThreads, bytes, st>>>(
      (const float*)q, (const uint8_t*)kc, (const uint8_t*)ks,
      (const uint8_t*)vc, (const uint8_t*)vs, (const int*)bt,
      (const int*)lengths, (const float*)ktab, (const float*)vtab,
      (const float*)stab, (float*)part, hq, hkv, d, page, max_pages, cb_k,
      cb_v, kpack, vpack, pages_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mxattn::merge_splits_kernel<<<dim3(hkv, bsz), kThreads, 0, st>>>(
      (const float*)part, (float*)out, hq, hkv, d, nsplit, nullptr, 0, 0, 0);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Hq, D) f32; pools (P, page, Hkv, CB) u8 and
// (P, page, Hkv, D/32) u8, code rows 4-byte aligned for one-byte codes and
// 2-byte aligned for 4-bit codes; block_tables (B, max_pages) i32; lengths
// (B,) i32; out like q.  kpack/vpack: 0 one code per byte, 1 4-bit, 2
// 6-bit.  part: B * Hkv * ceil(max_pages / pages_per_split) records of
// (Hq/Hkv) * (D + 2) floats.
extern "C" int mx_paged_decode_attn_launch(
    const void* q, const void* kc, const void* ks, const void* vc,
    const void* vs, const void* block_tables, const void* lengths,
    const void* ktab, const void* vtab, const void* stab, void* part,
    void* out, int bsz, int hq, int hkv, int d, int page, int max_pages,
    int cb_k, int cb_v, int kpack, int vpack, int pages_per_split,
    void* stream) {
  if (bsz == 0) return 0;
  return launch(q, kc, ks, vc, vs, block_tables, lengths, ktab, vtab, stab,
                part, out, bsz, hq, hkv, d, page, max_pages, cb_k, cb_v,
                kpack, vpack, pages_per_split, (cudaStream_t)stream);
}
