// Dequant x matmul with MX weights for Hopper, sm_90a, f32 activations:
//   out (M, N) f32 = a (M, K) f32 @ dequant(codes, scales)
//
// Replaces the Pallas kernel src/repro/kernels/mx_matmul.py::_mx_matmul_2d
// (body _mx_matmul_kernel, dequant_tile) for an f32 `a`; a bf16 `a` (the
// serving path's type) runs the tensor-core kernel of mx_matmul_tc.cu.
// codes are u8 (K, N), or bit-packed along K: E2M1 two codes per byte,
// low nibble first (K/2, N); E3M2/E2M3 four codes per three bytes,
// little-endian (3K/4, N) — the layout of pack_codes_rows
// (src/repro/core/pack.py).  scales are E8M0 (K/32, N).  Products and
// sums are f32 FMAs on the CUDA cores, as the reference computes them.
//
// Decoding.  code -> value goes through a 256-entry table per (format,
// mode) and the scale byte through a 256-entry table of 2^(s-127); both
// are built on the host by the plain decode_elements / scale_to_f32, so
// each decoded weight is exactly the reference's dequant_ref value.
// Packed codes are unpacked in registers.  Every load of codes and scales
// is a 32-bit word: four neighbouring columns (N must be a multiple of 4).
//
// Two shapes of the same arithmetic.  Decode (M <= 16, the slot batch):
// bound by the weight bytes, so each thread streams a 4-column strip of
// codes straight from device memory, several rows in flight, and keeps
// all M rows' sums for its columns in registers; the block's slice of A
// sits in shared memory.  When the strips alone cannot fill the card, K
// is split over blockIdx.y and a second pass sums the partial outputs in
// split order.  Prefill (M > 16): a 64 x 64 output tile per block, the
// weight tile decoded into shared memory one 32-row scale block at a
// time; it sums K in the same groups as the decode split and adds the
// group sums in the same order.  The grouping depends on N and K only,
// so for f32 activations both shapes give every output bit-identical
// values: a row's result never depends on the other rows of the call or
// on scheduling.  (The bf16 kernels of mx_matmul_tc.cu share the grouping
// among themselves, on the tensor cores' order of sums.)
//
// Bound.  Decode: bytes — every weight byte once per call (w1 of
// chatglm3-6b: 56 MB of e4m3 codes and 1.75 MB of scales, ~17 us at
// 3.35 TB/s).  Prefill: 2*M*N*K operations at the f32 CUDA-core rate.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mx_matmul_common.cuh"

namespace {

constexpr int kSkinnyThreads = 64;
constexpr int kSkinnyCols = 4 * kSkinnyThreads;   // N per skinny block

__device__ __forceinline__ uint32_t ld32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// four consecutive activations as f32
__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ float load1(const float* p) { return *p; }

// ---------------------------------------------------------------- decode
// acc[m][j] += a[m] * w[j] for one K row of this thread's four columns
template <int MT>
__device__ __forceinline__ void fma_row(float (&acc)[MT][4],
                                        const float* arow, const float* w) {
#pragma unroll
  for (int mm = 0; mm < MT; mm += 4) {
    const float4 av = *reinterpret_cast<const float4*>(arow + mm);
    const float a4[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
    for (int i = 0; i < 4 && mm + i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mm + i][j] = fmaf(a4[i], w[j],
                                                        acc[mm + i][j]);
  }
}

template <typename TA, int MT>
__global__ void __launch_bounds__(kSkinnyThreads) mx_matmul_skinny_kernel(
    const TA* __restrict__ a, const uint8_t* __restrict__ codes,
    const uint8_t* __restrict__ scales, const float* __restrict__ elem_tab,
    const float* __restrict__ scale_tab, float* __restrict__ out, int m,
    int n, int k, int pack_kind, int chunks_per_split) {
  constexpr int AS = MT < 4 ? 4 : MT;          // row stride of a_s
  __shared__ float etab[256];
  __shared__ float stab[256];
  extern __shared__ float a_s[];               // [rows][AS]
  const int tid = threadIdx.x;
  const int col = blockIdx.x * kSkinnyCols + 4 * tid;
  const int nchunks = k / kChunk;
  const int c_lo = blockIdx.y * chunks_per_split;
  const int c_hi = min(nchunks, c_lo + chunks_per_split);
  const int rows = (c_hi - c_lo) * kChunk;
  const int k_lo = c_lo * kChunk;
  for (int i = tid; i < 256; i += kSkinnyThreads) {
    etab[i] = elem_tab[i];
    stab[i] = scale_tab[i];
  }
  for (int i = tid; i < rows * AS; i += kSkinnyThreads) {
    const int mm = i / rows, r = i % rows;     // coalesced along K
    a_s[r * AS + mm] =
        mm < m ? load1(a + (long long)mm * k + k_lo + r) : 0.f;
  }
  __syncthreads();
  if (col >= n) return;                        // no barrier below

  float acc[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c = c_lo; c < c_hi; ++c) {
    const uint32_t sw = ld32(scales + (long long)c * n + col);
    const float s[4] = {stab[sw & 0xFF], stab[(sw >> 8) & 0xFF],
                        stab[(sw >> 16) & 0xFF], stab[sw >> 24]};
    const float* ac = a_s + (c - c_lo) * kChunk * AS;
    if (pack_kind == 0) {                      // one code per byte
      const uint8_t* cp = codes + (long long)c * kChunk * n + col;
#pragma unroll 8
      for (int r = 0; r < kChunk; ++r) {
        const uint32_t w = ld32(cp + (long long)r * n);
        float wv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = etab[(w >> (8 * j)) & 0xFF] * s[j];
        fma_row<MT>(acc, ac + r * AS, wv);
      }
    } else if (pack_kind == 1) {               // 4-bit: 2 rows per byte
      const uint8_t* cp = codes + (long long)c * (kChunk / 2) * n + col;
#pragma unroll 4
      for (int r = 0; r < kChunk / 2; ++r) {
        const uint32_t w = ld32(cp + (long long)r * n);
        float lo[4], hi[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t b = (w >> (8 * j)) & 0xFF;
          lo[j] = etab[b & 0xF] * s[j];
          hi[j] = etab[b >> 4] * s[j];
        }
        fma_row<MT>(acc, ac + (2 * r) * AS, lo);
        fma_row<MT>(acc, ac + (2 * r + 1) * AS, hi);
      }
    } else {                                   // 6-bit: 4 rows per 3 bytes
      const uint8_t* cp = codes + (long long)c * (kChunk / 4 * 3) * n + col;
#pragma unroll 2
      for (int g = 0; g < kChunk / 4; ++g) {
        const uint32_t w0 = ld32(cp + (long long)(3 * g) * n);
        const uint32_t w1 = ld32(cp + (long long)(3 * g + 1) * n);
        const uint32_t w2 = ld32(cp + (long long)(3 * g + 2) * n);
        float v[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t t = ((w0 >> (8 * j)) & 0xFF) |
                             (((w1 >> (8 * j)) & 0xFF) << 8) |
                             (((w2 >> (8 * j)) & 0xFF) << 16);
#pragma unroll
          for (int i = 0; i < 4; ++i) v[i][j] = etab[(t >> (6 * i)) & 0x3F] * s[j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) fma_row<MT>(acc, ac + (4 * g + i) * AS, v[i]);
      }
    }
  }
  float* dst = out + (long long)blockIdx.y * m * n;
  for (int mm = 0; mm < MT && mm < m; ++mm) {
    *reinterpret_cast<float4*>(dst + (long long)mm * n + col) =
        make_float4(acc[mm][0], acc[mm][1], acc[mm][2], acc[mm][3]);
  }
}

// --------------------------------------------------------------- prefill
template <typename TA>
__global__ void __launch_bounds__(256) mx_matmul_tiled_kernel(
    const TA* __restrict__ a, const uint8_t* __restrict__ codes,
    const uint8_t* __restrict__ scales, const float* __restrict__ elem_tab,
    const float* __restrict__ scale_tab, float* __restrict__ out, int m,
    int n, int k, int pack_kind, int chunks_per_group) {
  constexpr int BM = 64, BN = 64, TM = 4, TN = 4, NT = 256;
  constexpr int TX = BN / TN;
  __shared__ float etab[256];
  __shared__ float stab[256];
  __shared__ float as[kChunk][BM + 1];   // A chunk, k-major
  __shared__ float ws[kChunk][BN];       // decoded weight chunk

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int nchunks = k / kChunk;
  for (int i = tid; i < 256; i += NT) {
    etab[i] = elem_tab[i];
    stab[i] = scale_tab[i];
  }
  float acc[TM][TN], total[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = total[i][j] = 0.0f;

  for (int c = 0; c < nchunks; ++c) {
    const int k0 = c * kChunk;
    __syncthreads();                     // previous chunk fully consumed
    for (int idx = tid; idx < BM * (kChunk / 4); idx += NT) {
      const int mm = idx / (kChunk / 4), kq = idx % (kChunk / 4);
      const int row = m0 + mm;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (row < m) load4(a + (long long)row * k + k0 + 4 * kq, v);
#pragma unroll
      for (int i = 0; i < 4; ++i) as[4 * kq + i][mm] = v[i];
    }
    {
      // one 4-column group per thread: 16 groups x 16 slots of rows
      const int nq = tid % (BN / 4), slot = tid / (BN / 4);
      const int col = n0 + 4 * nq;
      const bool in = col < n;
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      if (in) {
        const uint32_t sw = ld32(scales + (long long)c * n + col);
#pragma unroll
        for (int j = 0; j < 4; ++j) s[j] = stab[(sw >> (8 * j)) & 0xFF];
      }
      if (pack_kind == 0) {              // rows slot, slot + 16
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int kk = slot + 16 * h;
          const uint32_t w = in ? ld32(codes + (long long)(k0 + kk) * n + col)
                                : 0u;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            ws[kk][4 * nq + j] = etab[(w >> (8 * j)) & 0xFF] * s[j];
        }
      } else if (pack_kind == 1) {       // byte row slot -> rows 2s, 2s+1
        const uint32_t w =
            in ? ld32(codes + (long long)(k0 / 2 + slot) * n + col) : 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t b = (w >> (8 * j)) & 0xFF;
          ws[2 * slot][4 * nq + j] = etab[b & 0xF] * s[j];
          ws[2 * slot + 1][4 * nq + j] = etab[b >> 4] * s[j];
        }
      } else if (slot < kChunk / 4) {    // group slot -> rows 4s .. 4s+3
        uint32_t w0 = 0, w1 = 0, w2 = 0;
        if (in) {
          const long long r0 = (long long)(k0 / 4 * 3 + 3 * slot) * n + col;
          w0 = ld32(codes + r0);
          w1 = ld32(codes + r0 + n);
          w2 = ld32(codes + r0 + 2 * n);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t t = ((w0 >> (8 * j)) & 0xFF) |
                             (((w1 >> (8 * j)) & 0xFF) << 8) |
                             (((w2 >> (8 * j)) & 0xFF) << 16);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            ws[4 * slot + i][4 * nq + j] = etab[(t >> (6 * i)) & 0x3F] * s[j];
        }
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kChunk; ++kk) {
      float ar[TM], br[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) ar[i] = as[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) br[j] = ws[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    if ((c + 1) % chunks_per_group == 0 || c + 1 == nchunks) {
#pragma unroll
      for (int i = 0; i < TM; ++i)      // close a group as split_sum does
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          total[i][j] += acc[i][j];
          acc[i][j] = 0.0f;
        }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty * TM + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx + j * TX;
      if (col < n) out[(long long)row * n + col] = total[i][j];
    }
  }
}

template <typename TA, int MT>
void launch_skinny(const void* a, const void* codes, const void* scales,
                   const void* etab, const void* stab, float* dst, int m,
                   int n, int k, int pack_kind, int splits, cudaStream_t st) {
  const int nchunks = k / kChunk;
  const int per = (nchunks + splits - 1) / splits;
  const int as = MT < 4 ? 4 : MT;
  const size_t smem = (size_t)per * kChunk * as * sizeof(float);
  dim3 grid((n + kSkinnyCols - 1) / kSkinnyCols, splits);
  mx_matmul_skinny_kernel<TA, MT><<<grid, kSkinnyThreads, smem, st>>>(
      (const TA*)a, (const uint8_t*)codes, (const uint8_t*)scales,
      (const float*)etab, (const float*)stab, dst, m, n, k, pack_kind, per);
}

template <typename TA>
void dispatch(const void* a, const void* codes, const void* scales,
              const void* etab, const void* stab, float* dst, int m, int n,
              int k, int pack_kind, int splits, cudaStream_t st) {
  if (m <= 1) {
    launch_skinny<TA, 1>(a, codes, scales, etab, stab, dst, m, n, k,
                         pack_kind, splits, st);
  } else if (m <= 2) {
    launch_skinny<TA, 2>(a, codes, scales, etab, stab, dst, m, n, k,
                         pack_kind, splits, st);
  } else if (m <= 4) {
    launch_skinny<TA, 4>(a, codes, scales, etab, stab, dst, m, n, k,
                         pack_kind, splits, st);
  } else if (m <= 8) {
    launch_skinny<TA, 8>(a, codes, scales, etab, stab, dst, m, n, k,
                         pack_kind, splits, st);
  } else if (m <= 16) {
    launch_skinny<TA, 16>(a, codes, scales, etab, stab, dst, m, n, k,
                          pack_kind, splits, st);
  } else {                    // one pass; K summed in the split groups
    const int nchunks = k / kChunk;
    const int per = (nchunks + splits - 1) / splits;
    dim3 grid((n + 63) / 64, (m + 63) / 64);
    mx_matmul_tiled_kernel<TA><<<grid, 256, 0, st>>>(
        (const TA*)a, (const uint8_t*)codes, (const uint8_t*)scales,
        (const float*)etab, (const float*)stab, dst, m, n, k, pack_kind,
        per);
  }
}

}  // namespace

// a (m, k) row-major f32, 16-byte aligned; k a multiple of 32; n a
// multiple of 4 with codes and scales 4-byte aligned.  pack_kind: 0 one
// code per byte, 1 4-bit packed, 2 6-bit packed.  splits: the K grouping
// of mx_matmul.py's split_count (a split holds at most 24 chunks).  For
// m <= 16 with splits > 1, `partial` needs room for splits * m * n
// floats; otherwise it is unused.
extern "C" int mx_matmul_launch(const void* a, const void* codes,
                                const void* scales, const void* elem_tab,
                                const void* scale_tab, void* out,
                                void* partial, int m, int n, int k,
                                int pack_kind, int splits, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool staged = m <= 16 && splits > 1;
  float* dst = staged ? (float*)partial : (float*)out;
  dispatch<float>(a, codes, scales, elem_tab, scale_tab, dst, m, n, k,
                  pack_kind, splits, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !staged) return (int)err;
  return (int)split_sum((const float*)partial, (float*)out,
                        (long long)m * n, splits, st);
}
