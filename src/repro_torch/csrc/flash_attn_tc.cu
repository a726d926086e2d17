// Forward flash attention for bf16 on Hopper's tensor cores, sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attn.py::
// flash_attention_bhsd (body _flash_kernel; GQA wrapper _flash_bshd_fwd)
// for bf16 q/k/v, the serving path's type; f32 runs the CUDA-core kernel
// of flash_attn.cu.  q (B, Sq, H, D), k/v (B, Sk, Hkv, D), o like q;
// causal with top-left alignment (key col attends query row iff col <=
// row, also when Sq != Sk) or not.
//
// Arithmetic.  The reference widens bf16 to f32 and forms S = Q K^T with
// an f32 sum; a bf16 x bf16 product is exact in f32, so
// mma.sync.m16n8k16 bf16 -> f32 forms the same S, summed in another
// order.  S is multiplied by 1/sqrt(D) in f32 (D before any zero
// padding), masked to NEG_INF = -1e30 (only on tiles that the diagonal or
// the Sk edge crosses), and the online softmax runs in f32 on the
// accumulator registers: the logits are taken to base 2 (times log2 e)
// so that exp is exp2f, the row max and row sum reduce over the quad of
// lanes that shares a row, and l sums the f32 P.  The one new rounding
// is P to bf16 as the A operand of O += P V (at most 2^-9 max|v| per
// output; the f32 reference's bf16 output store adds 2^-9 |o|).  The
// epilogue divides by l (1 where l == 0) and rounds to bf16, as the
// reference does.
//
// Design.  One block of 4 warps per (64-query tile, head, row b); warp w
// owns query rows 16w .. 16w + 15 of the tile, one m16 row of mma atoms.
// Its Q rows are read once from shared memory into registers as A
// fragments (ldmatrix); at D = 256 they are read from shared memory at
// each key tile instead (registers, below).  64-key tiles of KV head h / rep (read in place:
// GQA costs no expanded copy) stream through a ring of two K and two V
// stages filled with cp.async; the copies of tile j + 1 are issued before
// the work on tile j, so they overlap it.  Tiles are XOR-swizzled at
// 16-byte granularity so that ldmatrix (K) and ldmatrix.trans (V) read
// 8 rows on 8 different bank groups.  S (16 x 64 per warp) stays in
// registers; P is packed to bf16 straight from the S accumulators into
// the A fragments of the P V mma (the m16n8 C layout is the m16k16 A
// layout), so it never touches shared memory.  O (16 x D per warp)
// accumulates in f32 registers and leaves through the Q stage as 16-byte
// stores.  Under causal masking the loop stops at the last tile the
// diagonal reaches (the Pallas kernel masks the strictly upper tiles to
// exactly zero weight, so skipping them is exact), and the grid's slowest
// dimension walks query tiles from the last: the tiles with the most key
// tiles start first.  GQA: the query heads of one KV head are separate
// blocks that read the same K/V tiles, which L2 serves (4 MB of K and V
// at the serving shape); packing two heads into a block of 8 warps, so
// that each tile in shared memory feeds twice the mma, measured no faster
// (PERF.md).  No atomics: the result does not depend on the launch.
//
// Bound.  At the serving prefill shape (B = 8, S = 512, 32 heads over 2
// KV heads, D = 128, bf16) the function moves ~71 MB (q, k, v, o once)
// and does ~17 GFLOP of causal products: 21 us of bytes against 17 us at
// the bf16 tensor rate, so bytes bound it on paper.  mma.sync reaches
// well under the wgmma peak, and every warp reads its K and V tiles from
// shared memory, so in practice the tensor and shared-memory pipes bound
// it; wgmma and warp specialisation are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBq = 64;                    // query rows of a tile
// keys of a K/V tile: 64, and 32 at D = 256, where fewer S and P
// registers keep the kernel out of local memory (below)
__host__ __device__ constexpr int keys_per_tile(int d) {
  return d > 128 ? 32 : 64;
}
constexpr int kThreads = 128;              // 4 warps of 16 query rows

// Byte offset of 16-byte chunk c of row r in a tile of rows of D bf16.
// The chunk is XORed with a key of the row so that the 8 consecutive rows
// one ldmatrix matrix reads at one chunk fall on 8 different 16-byte bank
// groups (rows of 128 or 256 bytes: key r & 7; rows of 64 bytes, two to a
// 128-byte line: key (r >> 1) & 3).
template <int D>
__device__ __forceinline__ int row_key(int r) {
  return D / 8 >= 8 ? (r & 7) : ((r >> 1) & 3);
}
template <int D>
__device__ __forceinline__ int tile_off(int r, int c) {
  return r * (D * 2) + ((c ^ row_key<D>(r)) << 4);
}

// The unrolled mma loops read chunk c = 2i + lo of rows that share one
// key (row r, or r plus a multiple of 16): since the key is below 8,
// c ^ key = (c & ~7) + ((c & 7) ^ key), and the second term takes 4
// values per lane.  This lane's 4 (times 16 bytes) are computed once, so
// every address of the loops is a register plus an immediate.
struct Swizzle {
  int base;       // byte offset of row r
  int x[4];       // ((2i + lo) ^ key) * 16, i = 0..3
  __device__ __forceinline__ int at(int c) const {
    return base + ((c & ~7) << 4) + x[(c & 7) >> 1];
  }
};
template <int D>
__device__ __forceinline__ Swizzle swizzle(int r, int lo) {
  Swizzle z;
  z.base = r * (D * 2);
#pragma unroll
  for (int i = 0; i < 4; ++i) z.x[i] = ((2 * i + lo) ^ row_key<D>(r)) << 4;
  return z;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; `in` false: zero-fill, read nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(in ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 as the low / high half of a bf16x2 (round to nearest even)
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [r0, r0 + ROWS) of head `head` of row b of x (B, s, nh, D) into
// the swizzled tile at dst; rows >= s arrive as zeros.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* x, int b,
                                          int r0, int s, int nh, int head,
                                          int tid) {
  constexpr int kC = D / 8;
#pragma unroll
  for (int it = 0; it < ROWS * kC / kThreads; ++it) {
    const int i = tid + it * kThreads, r = i / kC, c = i % kC;
    const bool in = r0 + r < s;
    const __nv_bfloat16* src =
        in ? x + (((long long)b * s + r0 + r) * nh + head) * D + c * 8 : x;
    cp_async16(dst + tile_off<D>(r, c), src, in);
  }
}

// grid (H, B, query tiles); shared memory: Q tile, K ring, V ring.  At
// D = 256 a warp's O alone takes 128 f32 registers a lane, and Q held as
// fragments would take 64 more, past the 255 a thread may have (the
// build spilled): there Q's fragments are read from the Q tile at each
// k-step of every key tile instead (one ldmatrix beside those of K), and
// key tiles are 32 wide (S and P in half the registers).  Shared memory
// is then 96 KB, and the kernel runs one block per SM.
template <int D>
__global__ void __launch_bounds__(kThreads, D > 128 ? 1 : 2) flash_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    int sq, int sk, int h, int hkv, int causal, int scale_d) {
  constexpr int kBk = keys_per_tile(D);
  constexpr int kQTile = kBq * D * 2;  // bytes of the Q tile
  constexpr int kTile = kBk * D * 2;   // bytes of one K or V tile
  constexpr int kKs = D / 16;          // k-steps of S = Q K^T
  constexpr int kNb = kBk / 8;         // 8-key blocks of S
  constexpr int kPk = kBk / 16;        // k-steps of P V
  constexpr int kDn = D / 8;           // 8-column blocks of O: 16 bytes
  constexpr bool kQRegs = D <= 128;    // Q fragments held in registers
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t qs = smem_u32(smem);
  const uint32_t ks = qs + kQTile, vs = ks + 2 * kTile;

  const int head = blockIdx.x, b = blockIdx.y;
  const int iq = gridDim.z - 1 - blockIdx.z;   // longest causal tiles first
  const int g = head / (h / hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, t = lane & 3;      // fragment row, quad lane
  const int q0 = iq * kBq, wr0 = q0 + warp * 16;
  int nk = (sk + kBk - 1) / kBk;
  if (causal) nk = min(nk, (q0 + kBq - 1) / kBk + 1);   // to the diagonal

  load_tile<D, kBq>(qs, q, b, q0, sq, h, head, tid);
  load_tile<D, kBk>(ks, k, b, 0, sk, hkv, g, tid);
  cp_commit();
  load_tile<D, kBk>(vs, v, b, 0, sk, hkv, g, tid);
  cp_commit();

  // this lane's ldmatrix rows and chunks: Q and K (non-transposed), V
  const int qrow = warp * 16 + (lane & 15), qch = lane >> 4;
  const int krow = (lane & 7) + ((lane >> 4) << 3), kch = (lane >> 3) & 1;
  const int vrow = (lane & 7) + (((lane >> 3) & 1) << 3), vch = lane >> 4;
  const Swizzle qz = swizzle<D>(qrow, qch), kz = swizzle<D>(krow, kch),
                vz = swizzle<D>(vrow, vch);

  const float scale = 1.0f / sqrtf((float)scale_d);
  float oacc[kDn][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < kDn; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) oacc[n][r] = 0.f;
  uint32_t qf[kQRegs ? kKs : 1][4];

  for (int j = 0; j < nk; ++j) {
    const int st = j & 1, k0 = j * kBk;
    cp_wait<1>();       // K[j] (and Q) in for this thread
    __syncthreads();    // ... for all; stage st ^ 1 read by tile j - 1
    if (kQRegs && j == 0) {
#pragma unroll
      for (int kk = 0; kk < kKs; ++kk)
        ldmatrix_x4(qf[kk], qs + qz.at(2 * kk));
    }
    if (j + 1 < nk)
      load_tile<D, kBk>(ks + (st ^ 1) * kTile, k, b, k0 + kBk, sk, hkv, g,
                        tid);
    cp_commit();
    if (j + 1 < nk)
      load_tile<D, kBk>(vs + (st ^ 1) * kTile, v, b, k0 + kBk, sk, hkv, g,
                        tid);
    cp_commit();

    // S = Q K^T: n-block nb holds keys k0 + 8nb + 2t (+1) of rows gr, gr + 8
    float s[kNb][4];
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[nb][r] = 0.f;
    const uint32_t kt = ks + st * kTile;
#pragma unroll
    for (int kk = 0; kk < kKs; ++kk) {
      uint32_t a[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = qf[kk][r];
      } else {
        ldmatrix_x4(a, qs + qz.at(2 * kk));
      }
#pragma unroll
      for (int np = 0; np < kNb / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, kt + 16 * np * (D * 2) + kz.at(2 * kk));
        mma_bf16(s[2 * np], a, r[0], r[1]);
        mma_bf16(s[2 * np + 1], a, r[2], r[3]);
      }
    }

    // online softmax in base 2; rows gr (r = 0, 1) and gr + 8 (r = 2, 3)
    const bool edge = k0 + kBk > sk || (causal && k0 + kBk - 1 > wr0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float x = s[nb][r] * scale * kLog2e;
        if (edge) {
          const int col = k0 + 8 * nb + 2 * t + (r & 1);
          const int row = wr0 + gr + 8 * (r >> 1);
          if (col >= sk || (causal && col > row)) x = kNegInf;
        }
        s[nb][r] = x;
        mx[r >> 1] = fmaxf(mx[r >> 1], x);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p = exp2f(s[nb][r] - mx[r >> 1]);
        rs[r >> 1] += p;
        s[nb][r] = p;
      }
    // P as the A fragments of the key steps of 16: (gr, 2t), (gr + 8,
    // 2t), (gr, 2t + 8), (gr + 8, 2t + 8) = n-blocks 2kk and 2kk + 1
    uint32_t pf[kPk][4];
#pragma unroll
    for (int kk = 0; kk < kPk; ++kk) {
      pf[kk][0] = pack(s[2 * kk][0], s[2 * kk][1]);
      pf[kk][1] = pack(s[2 * kk][2], s[2 * kk][3]);
      pf[kk][2] = pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pf[kk][3] = pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l[i] = l[i] * alpha[i] + rs[i];
    }
#pragma unroll
    for (int n = 0; n < kDn; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) oacc[n][r] *= alpha[r >> 1];

    cp_wait<2>();       // V[j] in for this thread (tile j + 1 in flight)
    __syncthreads();    // ... for all
    const uint32_t vt = vs + st * kTile;
#pragma unroll
    for (int kk = 0; kk < kPk; ++kk)
#pragma unroll
      for (int dp = 0; dp < kDn / 2; ++dp) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, vt + 16 * kk * (D * 2) + vz.at(2 * dp));
        mma_bf16(oacc[2 * dp], pf[kk], r[0], r[1]);
        mma_bf16(oacc[2 * dp + 1], pf[kk], r[2], r[3]);
      }
  }
  cp_wait<0>();

  // O / l to bf16 through this warp's own 16 rows of the Q tile (only it
  // read them), then 16-byte stores of whole rows
  float den[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) den[i] = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
  for (int n = 0; n < kDn; ++n)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = warp * 16 + gr + 8 * hf;
      *reinterpret_cast<uint32_t*>(smem + tile_off<D>(row, n) + 4 * t) =
          pack(oacc[n][2 * hf] / den[hf], oacc[n][2 * hf + 1] / den[hf]);
    }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 16 * kDn / 32; ++it) {
    const int i = lane + 32 * it, r = warp * 16 + i / kDn, c = i % kDn;
    if (q0 + r < sq)
      *reinterpret_cast<uint4*>(
          o + (((long long)b * sq + q0 + r) * h + head) * D + c * 8) =
          *reinterpret_cast<const uint4*>(smem + tile_off<D>(r, c));
  }
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int b,
             int sq, int sk, int h, int hkv, int causal, int scale_d,
             cudaStream_t st) {
  constexpr int bytes = (kBq + 4 * keys_per_tile(D)) * D * 2;   // Q, K, V
  static bool configured = false;          // above 48 KB needs the attribute
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid(h, b, (sq + kBq - 1) / kBq);
  flash_tc_kernel<D><<<grid, kThreads, bytes, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, sq, sk, h, hkv, causal,
      scale_d);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Sq, H, D), k/v (B, Sk, Hkv, D), o like q; bf16, contiguous,
// 16-byte aligned; D in {32, 64, 128, 256}; H a multiple of Hkv; Sk >= 1;
// B and the number of 64-row query tiles at most 65535; scores scaled by
// 1/sqrt(scale_d): D itself, or the head dim before the wrapper
// zero-padded q/k/v up to D (the padding adds nothing to S).
extern "C" int flash_attn_tc_launch(const void* q, const void* k,
                                    const void* v, void* o, int b, int sq,
                                    int sk, int h, int hkv, int d,
                                    int causal, int scale_d, void* stream) {
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
