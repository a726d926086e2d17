// Forward flash attention for f32 on Hopper's CUDA cores, sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attn.py::
// flash_attention_bhsd (body _flash_kernel; GQA wrapper _flash_bshd_fwd)
// for f32 q/k/v; bf16, the serving path's type, runs the tensor-core
// kernel of flash_attn_tc.cu.  q (B, Sq, H, D), k/v (B, Sk, Hkv, D),
// computed in f32 as the reference computes (scores * 1/sqrt(D), NEG_INF
// = -1e30), causal with top-left alignment (key col attends query row iff
// col <= row, also when Sq != Sk) or not.
//
// Design.  One block of 256 threads per (64-query tile, head, row b).
// The block stages its query tile in shared memory as f32 and loops over
// 64-key tiles of KV head h / rep — read in place, so GQA costs no
// expanded copy of K and V as the reference wrapper makes.  Per key tile:
// K into shared memory, S = Q K^T in registers (each thread a 4 x 4 patch:
// rows tr + 16i, cols tc + 16j), the online softmax per query row in f32
// (row max and sum across the 16 threads of a row group by warp shuffles,
// expf), P to shared memory, V into the buffer K used, then O += P V with
// each thread owning 4 rows x D/16 columns of the accumulator in
// registers.  Under causal masking the loop stops at the last tile the
// diagonal reaches: the Pallas kernel computes the strictly upper tiles
// and masks them to exactly zero weight, so skipping them is exact.
// Shared memory is about 86 KB at D = 128, two blocks per SM (150 KB
// and one block at D = 256).
//
// Bound.  At the serving prefill shape in f32 (B = 8, S = 512, 32 heads,
// D = 128) the function moves ~142 MB (q, k, v, o once) and does ~17
// GFLOP of causal products, ~0.26 ms at the 67 TFLOP/s f32 peak of the
// CUDA cores: operations bound it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBq = 64, kBk = 64, kThreads = 256;
constexpr int kPs = kBk + 16;     // P row stride: a warp's two row groups
//                                   fall on disjoint banks

// Rows [r0, r0 + 64) of head `head` of row b of x (B, S, nh, D) into dst
// (64 x (D + 4) f32); rows >= s read as zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* x, int b,
                                          int r0, int s, int nh, int head) {
  constexpr int kV = D / 4, kLd = D + 4;
  for (int i = threadIdx.x; i < 64 * kV; i += kThreads) {
    const int r = i / kV, c = (i % kV) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < s) {
      v = *reinterpret_cast<const float4*>(
          x + (((long long)b * s + r0 + r) * nh + head) * D + c);
    }
    *reinterpret_cast<float4*>(dst + r * kLd + c) = v;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, int sq, int sk,
    int h, int hkv, int causal, int scale_d) {
  constexpr int kLd = D + 4;       // q / kv row stride: conflict-free float4
  constexpr int kDc = D / 16;      // accumulator columns per thread
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);    // kBq x kLd
  float* kv_s = q_s + kBq * kLd;                   // kBk x kLd (K, then V)
  float* p_s = kv_s + kBk * kLd;                   // kBq x kPs

  const int iq = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int g = head / (h / hkv);
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const int q0 = iq * kBq;
  const float scale = 1.0f / sqrtf((float)scale_d);

  load_tile<D>(q_s, q, b, q0, sq, h, head);
  float acc[4][kDc], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDc; ++c) acc[i][c] = 0.f;
  }
  int nk = (sk + kBk - 1) / kBk;
  if (causal) nk = min(nk, (q0 + kBq - 1) / kBk + 1);
  for (int jk = 0; jk < nk; ++jk) {
    const int k0 = jk * kBk;
    __syncthreads();               // the previous tile's P V is done
    load_tile<D>(kv_s, k, b, k0, sk, hkv, g);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; dd += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(q_s + (tr + 16 * i) * kLd +
                                                 dd);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kb[j] = *reinterpret_cast<const float4*>(kv_s + (tc + 16 * j) * kLd +
                                                 dd);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qa[i].x, kb[j].x, a);
          a = fmaf(qa[i].y, kb[j].y, a);
          a = fmaf(qa[i].z, kb[j].z, a);
          a = fmaf(qa[i].w, kb[j].w, a);
          s[i][j] = a;
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + tr + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tc + 16 * j;
        float x = s[i][j] * scale;
        if (col >= sk || (causal && col > row)) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        p_s[(tr + 16 * i) * kPs + tc + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDc; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();               // K consumed, P written
    load_tile<D>(kv_s, v, b, k0, sk, hkv, g);
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < kBk; ++t) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(tr + 16 * i) * kPs + t];
#pragma unroll
      for (int c = 0; c < kDc; ++c) {
        const float vv = kv_s[t * kLd + tc + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr + 16 * i;
    if (row >= sq) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
    float* orow = o + (((long long)b * sq + row) * h + head) * D;
#pragma unroll
    for (int c = 0; c < kDc; ++c) orow[tc + 16 * c] = acc[i][c] / denom;
  }
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int b,
             int sq, int sk, int h, int hkv, int causal, int scale_d,
             cudaStream_t st) {
  constexpr int kLd = D + 4;
  const int bytes = (kBq * kLd + kBk * kLd + kBq * kPs) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + kBq - 1) / kBq, h, b);
  flash_fwd_kernel<D><<<grid, kThreads, bytes, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, sq, sk,
      h, hkv, causal, scale_d);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Sq, H, D), k/v (B, Sk, Hkv, D), o like q; f32, contiguous,
// 16-byte aligned; D in {32, 64, 128, 256}; H a multiple of Hkv; Sk >= 1;
// scores scaled by 1/sqrt(scale_d): D itself, or the head dim before the
// wrapper zero-padded q/k/v up to D (the padding adds nothing to S).
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* o, int b, int sq, int sk, int h,
                                 int hkv, int d, int causal, int scale_d,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (b == 0 || sq == 0) return 0;
  switch (d) {
    case 32:
      return launch_d<32>(q, k, v, o, b, sq, sk, h, hkv, causal, scale_d,
                         st);
    case 64:
      return launch_d<64>(q, k, v, o, b, sq, sk, h, hkv, causal, scale_d,
                         st);
    case 128:
      return launch_d<128>(q, k, v, o, b, sq, sk, h, hkv, causal, scale_d,
                          st);
    case 256:
      return launch_d<256>(q, k, v, o, b, sq, sk, h, hkv, causal, scale_d,
                          st);
    default: return (int)cudaErrorInvalidValue;
  }
}
