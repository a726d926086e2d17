// Device code shared by the two f32 MX decode-attention kernels (CUDA
// cores): mx_decode_attn.cu (contiguous cache) and
// mx_paged_decode_attn.cu (page pool); bf16 q runs the tensor-core
// kernels of mx_decode_attn_tc.cu.  Both own one (row, KV head) per
// block, dequantize a tile of
// tokens into shared memory, fold it into the running online softmax of
// the group's query heads (tile_update), and write a (acc, max, sum)
// partial per block that merge_splits_kernel combines in split order.
//
// Query heads.  q holds Hq heads, the first being global head head0:
// local head h reads KV head (head0 + h) / rep (head0 = 0 and Hq = Hkv *
// rep: every head, query head h reading KV head h / rep).  The KV heads
// read are glo = head0 / rep .. (head0 + Hq - 1) / rep, one block group
// each (group_rows gives its local heads lo .. hi - 1, at most rmax =
// min(rep, Hq) of them); a sharded rank that keeps every KV head (they
// do not divide its model axis) runs its own q heads this way.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mxattn {
namespace {  // internal linkage: each kernel file has its own copy

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;

// local query heads [lo, hi) of KV head g
__host__ __device__ __forceinline__ void group_rows(int head0, int rep,
                                                   int hq, int g, int& lo,
                                                   int& hi) {
  lo = g * rep - head0 > 0 ? g * rep - head0 : 0;
  hi = (g + 1) * rep - head0 < hq ? (g + 1) * rep - head0 : hq;
}

__host__ __device__ __forceinline__ int rows_max(int rep, int hq) {
  return rep < hq ? rep : hq;
}

// Fold one dequantized tile into the running softmax state.  k_s is
// tile x (d + 1) (padded rows: no bank clash), v_s tile x d, p_s rep x
// tile scratch, acc rep x d, m_s/l_s/a_s rep.  Tokens t >= valid get
// NEG_INF scores, as the reference's mask gives them.  The caller has
// synchronised after filling k_s and v_s; every thread of the block calls.
__device__ __forceinline__ void tile_update(
    const float* q_s, const float* k_s, const float* v_s, float* p_s,
    float* acc, float* m_s, float* l_s, float* a_s, int rep, int d,
    int tile, int valid) {
  const int tid = threadIdx.x, ds = d + 1;
  const float sqrt_d = sqrtf((float)d);
  for (int i = tid; i < rep * tile; i += kThreads) {
    const int h = i / tile, t = i % tile;
    const float* qh = q_s + h * d;
    const float* kt = k_s + t * ds;
    float dot = 0.f;
    for (int dd = 0; dd < d; ++dd) dot = fmaf(qh[dd], kt[dd], dot);
    p_s[i] = t < valid ? dot / sqrt_d : kNegInf;
  }
  __syncthreads();
  for (int h = tid; h < rep; h += kThreads) {
    float* ph = p_s + h * tile;
    const float m_prev = m_s[h];
    float m_new = m_prev;
    for (int t = 0; t < tile; ++t) m_new = fmaxf(m_new, ph[t]);
    float sum = 0.f;
    for (int t = 0; t < tile; ++t) {
      const float e = expf(ph[t] - m_new);
      ph[t] = e;
      sum += e;
    }
    const float alpha = expf(m_prev - m_new);
    l_s[h] = l_s[h] * alpha + sum;
    m_s[h] = m_new;
    a_s[h] = alpha;
  }
  __syncthreads();
  for (int i = tid; i < rep * d; i += kThreads) {
    const int h = i / d, dd = i % d;
    const float* ph = p_s + h * tile;
    float o = acc[i] * a_s[h];
    for (int t = 0; t < tile; ++t) o = fmaf(ph[t], v_s[t * d + dd], o);
    acc[i] = o;
  }
}

// Merge the nsplit partial records of each (row, KV head group) in split
// order (deterministic) and apply the l == 0 -> 1 guard.  A record is
// [rmax x d acc | rmax max | rmax sum], its first hi - lo rows used; grid
// (groups, B).  tokens_per_split > 0 (the contiguous cache): only the
// splits holding positions <= pos wrote a record, pos read from pos_p
// when that is not null.
__global__ void __launch_bounds__(kThreads) merge_splits_kernel(
    const float* __restrict__ part, float* __restrict__ out, int hq,
    int head0, int rep, int d, int nsplit, const int* __restrict__ pos_p,
    int pos, int s_len, int tokens_per_split) {
  const int gi = blockIdx.x, b = blockIdx.y;
  int lo, hi;
  group_rows(head0, rep, hq, head0 / rep + gi, lo, hi);
  const int rmax = rows_max(rep, hq), rec = rmax * d + 2 * rmax;
  const float* base =
      part + ((long long)b * gridDim.x + gi) * nsplit * rec;
  int ns = nsplit;              // records to merge
  if (tokens_per_split > 0) {   // contiguous: the splits up to pos only
    const int live = min((pos_p != nullptr ? *pos_p : pos) + 1, s_len);
    ns = min(nsplit, (live + tokens_per_split - 1) / tokens_per_split);
  }
  float* ob = out + ((long long)b * hq + lo) * d;
  for (int i = threadIdx.x; i < (hi - lo) * d; i += kThreads) {
    const int h = i / d;
    float m = kNegInf;
    for (int s = 0; s < ns; ++s) m = fmaxf(m, base[s * rec + rmax * d + h]);
    float l = 0.f, o = 0.f;
    for (int s = 0; s < ns; ++s) {
      const float* r = base + s * rec;
      const float w = expf(r[rmax * d + h] - m);
      l = fmaf(r[rmax * d + rmax + h], w, l);
      o = fmaf(r[i], w, o);
    }
    ob[i] = o / (l == 0.f ? 1.f : l);
  }
}

}  // namespace
}  // namespace mxattn
