// Dequant x matmul with MX weights on Hopper's tensor cores, sm_90a, for
// bf16 activations:
//   out (M, N) f32 = a (M, K) bf16 @ dequant(codes, scales)
//
// Replaces the Pallas kernel src/repro/kernels/mx_matmul.py::_mx_matmul_2d
// (body _mx_matmul_kernel, dequant_tile) for a bf16 `a`, the serving
// path's type; f32 activations run the CUDA-core kernels of mx_matmul.cu.
// codes are u8 (K, N), or bit-packed along K: E2M1 two codes per byte,
// low nibble first (K/2, N); E3M2/E2M3 four codes per three bytes,
// little-endian (3K/4, N).  scales are E8M0 (K/32, N).
//
// Arithmetic.  The reference computes dot(f32(a), f32(elem * scale)) with
// an f32 sum.  Every finite element value of every format is a bf16, and
// elem * 2^(s-127) is one too unless it falls below bf16's smallest
// subnormal 2^-133 (possible only for scale codes s < 10).  So each code
// is decoded through the 256-entry element and scale tables (built by the
// plain decode_elements / scale_to_f32), the scale is folded in, and the
// product is rounded once to bf16 — exact for s >= 10 — and
// mma.sync.m16n8k16 multiplies it by bf16 `a` exactly, summing in f32:
// the reference's products, summed in another order.  (fp8 mma would need
// fp8 activations, which the reference does not compute.)
//
// Two kernels, one order of sums.  Every output element is the chain
//   acc = 0; for each 16-row K step of a group: acc = mma(a, w, acc);
//   total = total + acc                     (total starts at 0)
// over the K groups of mx_matmul.py::split_count (whole 32-row chunks; a
// function of N and K only), with the same bf16 operands in both:
// - decode (M <= 16, bound by the weight bytes): a block owns 16 rows (A
//   padded with zero rows) by 128 columns and one K group, blockIdx.z;
//   each warp decodes its 32 columns' B fragments straight into
//   registers (its columns permuted so that mma column c of n-tile j is
//   column 4c + j, and a thread's four columns are one 32-bit word of a
//   code row).  The groups' partials are summed in split order by
//   split_sum_kernel: the same ((0 + g0) + g1) + ... .
// - prefill (M > 16, bound by operations): a block owns 128 x 128 outputs
//   and all of K, 8 warps of 64 x 32, `total` in registers.  Each chunk's
//   weight tile is decoded once per block into shared memory as bf16 and
//   read with ldmatrix, like A; the decode of chunk c + 1 runs beside the
//   tensor-core work on chunk c.
// So a row's result is bit-identical whatever the batch and whichever
// kernel computes it (relying on mma.sync's result for an element not
// depending on its position in the tile; chip_smoke.py checks it).
//
// Pipeline.  A ring of 4 shared-memory stages, one 32-row chunk each (A
// tile, codes tile, one scale row).  The prefill kernel fills them with
// TMA (one thread issues three tensor-map boxes per chunk, counted on an
// mbarrier) when N is a multiple of 16 and codes and scales are 16-byte
// aligned; otherwise, and always in the decode kernel, every thread
// copies with cp.async (16-byte copies under the same condition, else
// 4-byte copies: N a multiple of 4).  Out-of-range rows and columns
// arrive as zeros.  Tiles are swizzled at 16-byte granularity (the A
// tile as TMA's 64-byte swizzle lays it) so that no read conflicts on
// banks, and the element table is kept as 32 copies, one per bank, so a
// lookup never conflicts whatever the codes.  In the prefill kernel the
// loads (cp.async stalls every issuing warp), the decode and the mma
// cost about alike per chunk; TMA takes the first off the warps, and the
// decode of chunk c + 1 is cut into four pieces between the mma of
// chunk c so that the two overlap.
//
// Bound.  Decode: bytes — every weight byte once per call (w1 of
// chatglm3-6b: 56 MB of e4m3 codes and 1.75 MB of scales, ~17 us at
// 3.35 TB/s).  Prefill: 2*M*N*K operations at the bf16 tensor-core rate.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mx_matmul_common.cuh"

namespace {

constexpr int kBN = 128;       // output columns per block: 4 warps x 32
constexpr int kStages = 4;     // ring slots of one 32-row chunk each
constexpr int kDecodeRows = 16;    // decode kernel: one m16 tile
constexpr int kPrefillRows = 128;  // prefill kernel: 2 warps x 64 rows

// storage rows of codes per 32-row chunk: one code per byte, 4-bit, 6-bit
template <int KIND>
__host__ __device__ constexpr int code_rows() {
  return KIND == 0 ? 32 : KIND == 1 ? 16 : 24;
}

// Element-table entries per format storage (codes of 8, 4 or 6 bits).
// The table sits in shared memory as 32 copies, entry e of lane l at
// e * 32 + l: a lane reads only its own bank.
template <int KIND>
__host__ __device__ constexpr int table_entries() {
  return KIND == 0 ? 256 : KIND == 1 ? 16 : 64;
}

template <int KIND>
__host__ __device__ constexpr int decode_smem() {
  return table_entries<KIND>() * 32 * 4 +
         kStages * (kDecodeRows * 64 + code_rows<KIND>() * kBN + kBN);
}

// The decode kernel's code rows that one warp-wide read touches differ in
// this key, which picks the 16-byte chunk (XOR key * 2) of a 128-byte row.
template <int KIND>
__device__ __forceinline__ int code_key(int row) {
  return KIND == 0 ? (row >> 1) & 3 : KIND == 1 ? row & 3 : (row / 3) & 3;
}
template <int KIND>
__device__ __forceinline__ int code_off(int row, int byte) {
  return row * kBN + (((byte >> 4) ^ (code_key<KIND>(row) << 1)) << 4) +
         (byte & 15);
}
// A tile (rows of M) and decoded weight tile (rows of N): 32 bf16 of K
// per row, 64 bytes in four 16-byte chunks, swizzled for ldmatrix
__device__ __forceinline__ int tile_off(int row, int ch) {
  return row * 64 + ((ch ^ ((row >> 1) & 3)) << 4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool in) {
  const int n = in ? BYTES : 0;          // 0: zero-fill, read nothing
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(n) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(dst), "l"(src), "n"(BYTES), "r"(n) : "memory");
  }
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bar_wait(uint32_t bar, int phase) {
  asm volatile(
      "{\n .reg .pred p;\n"
      "WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}\n"
      :: "r"(bar), "r"(phase) : "memory");
}
// one 2-D box of a tensor map into shared memory, counted on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(map), "r"(x), "r"(y), "r"(bar) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t lds16(const uint8_t* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

// two dequantized weights, K rows k and k + 1 of one column, as the
// low / high half of a bf16x2 (one rounding of the exact f32 product)
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy chunk c (A rows m0.., K rows 32c..; code rows; scale row) into the
// ring slot at shared address sa.  Every copy count is a compile-time
// multiple of, or below, NT.  The decode kernel's codes tile is swizzled
// (code_off), the prefill kernel's is plain.
template <int KIND, int VEC, int NT, int BM, bool SWIZZLED>
__device__ __forceinline__ void load_chunk(
    uint32_t sa, const __nv_bfloat16* a, const uint8_t* codes,
    const uint8_t* scales, int m, int n, int k, int m0, int n0, int c,
    int tid) {
  constexpr int R = code_rows<KIND>();
  constexpr int A_CP = BM * 4, C_CP = R * kBN / VEC, S_CP = kBN / VEC;
  const uint32_t sc = sa + BM * 64, ss = sc + R * kBN;
  const __nv_bfloat16* ac = a + c * kChunk;
  const uint8_t* cc = codes + (long long)c * R * n + n0;
#pragma unroll
  for (int r = 0; r < (A_CP + NT - 1) / NT; ++r) {
    const int i = tid + r * NT, row = i >> 2, ch = i & 3;
    if (A_CP % NT == 0 || i < A_CP) {
      const bool in = m0 + row < m;
      cp_async<16>(sa + tile_off(row, ch),
                   in ? ac + (long long)(m0 + row) * k + ch * 8 : a, in);
    }
  }
#pragma unroll
  for (int r = 0; r < (C_CP + NT - 1) / NT; ++r) {
    const int i = tid + r * NT;
    const int row = i / (kBN / VEC), b = i % (kBN / VEC) * VEC;
    if (C_CP % NT == 0 || i < C_CP) {
      const bool in = n0 + b < n;
      cp_async<VEC>(sc + (SWIZZLED ? code_off<KIND>(row, b) : row * kBN + b),
                    in ? cc + (long long)row * n + b : codes, in);
    }
  }
  if (tid < S_CP) {
    const int b = tid * VEC;
    const bool in = n0 + b < n;
    cp_async<VEC>(ss + b, in ? scales + (long long)c * n + n0 + b : scales,
                  in);
  }
}

template <int KIND, int NT>
__device__ __forceinline__ void fill_tables(float* etab, float* stab,
                                            const float* elem_tab,
                                            const float* scale_tab,
                                            int tid) {
  for (int i = tid; i < table_entries<KIND>() * 8; i += NT) {
    const float v = elem_tab[i >> 3];
    reinterpret_cast<float4*>(etab)[i] = make_float4(v, v, v, v);
  }
  for (int i = tid; i < 256; i += NT) stab[i] = scale_tab[i];
}

// ----------------------------------------------------------------- decode
// B fragments of one 16-row K step H of the chunk for this thread: n-tile
// j, register p holds K rows 16H + 2t + 8p (+1) of column wn*32 + 4g + j.
// Within a thread the swizzle key of every code row it reads is fixed
// (KIND 2: one per p), so the rows are compile-time offsets from cw[p],
// the thread's codes base in the stage (code_base).  et is this lane's
// column of the element table.
template <int KIND, int H>
__device__ __forceinline__ void decode_frag(const uint8_t* const (&cw)[2],
                                            int t, const float* et,
                                            const float (&s)[4],
                                            uint32_t (&b)[4][2]) {
  if constexpr (KIND == 0) {               // one code per byte
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      w[q] = lds32(cw[0] + (16 * H + (q & 1) + 8 * (q >> 1)) * kBN);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int p = 0; p < 2; ++p)
        b[j][p] = pack(et[((w[2 * p] >> (8 * j)) & 0xFF) * 32] * s[j],
                       et[((w[2 * p + 1] >> (8 * j)) & 0xFF) * 32] * s[j]);
  } else if constexpr (KIND == 1) {        // byte row r: K rows 2r, 2r + 1
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const uint32_t w = lds32(cw[0] + (8 * H + 4 * p) * kBN);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t x = (w >> (8 * j)) & 0xFF;
        b[j][p] = pack(et[(x & 0xF) * 32] * s[j], et[(x >> 4) * 32] * s[j]);
      }
    }
  } else {                                 // byte rows 3q..3q+2: K 4q..4q+3
    const int sh = 12 * (t & 1);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const uint8_t* r = cw[p] + 12 * H * kBN;
      const uint32_t x0 = lds32(r), x1 = lds32(r + kBN),
                     x2 = lds32(r + 2 * kBN);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t v = ((x0 >> (8 * j)) & 0xFF) |
                           (((x1 >> (8 * j)) & 0xFF) << 8) |
                           (((x2 >> (8 * j)) & 0xFF) << 16);
        b[j][p] = pack(et[((v >> sh) & 0x3F) * 32] * s[j],
                       et[((v >> (sh + 6)) & 0x3F) * 32] * s[j]);
      }
    }
  }
}

// Offset in a swizzled codes tile of the first code row thread (g, t) of
// warp wn reads for register p (rows 2t, t or 3q with q = t/2 + 2p).
template <int KIND>
__device__ __forceinline__ int code_base(int wn, int g, int t, int p) {
  const int byte = wn * 32 + 4 * g;
  const int row = KIND == 0 ? 2 * t : KIND == 1 ? t : 3 * ((t >> 1) + 2 * p);
  return code_off<KIND>(row, byte);
}

// 4 warps; blockIdx = (0, N tile, K group).  The group's partial, 0 + acc,
// goes to out + blockIdx.z * m * n.
template <int KIND, int VEC>
__global__ void __launch_bounds__(128, 4) mx_matmul_tc_decode_kernel(
    const __nv_bfloat16* __restrict__ a, const uint8_t* __restrict__ codes,
    const uint8_t* __restrict__ scales, const float* __restrict__ elem_tab,
    const float* __restrict__ scale_tab, float* __restrict__ out, int m,
    int n, int k, int chunks_per_group) {
  constexpr int NT = 128, BM = kDecodeRows;
  constexpr int A_BYTES = BM * 64, C_BYTES = code_rows<KIND>() * kBN;
  constexpr int STAGE = A_BYTES + C_BYTES + kBN;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float stab[256];
  float* etab = reinterpret_cast<float*>(smem);
  uint8_t* ring = smem + table_entries<KIND>() * 32 * 4;
  const int tid = threadIdx.x, lane = tid & 31, wn = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.y * kBN;
  const int c_lo = blockIdx.z * chunks_per_group;
  const int nloc = min(k / kChunk, c_lo + chunks_per_group) - c_lo;
  out += (long long)blockIdx.z * m * n;
  auto load = [&](int it) {
    load_chunk<KIND, VEC, NT, BM, true>(
        smem_u32(ring + it % kStages * STAGE), a, codes, scales, m, n, k, 0,
        n0, c_lo + it, tid);
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nloc) load(s);
    cp_commit();
  }
  fill_tables<KIND, NT>(etab, stab, elem_tab, scale_tab, tid);
  const float* et = etab + lane;
  int cwo[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) cwo[p] = code_base<KIND>(wn, g, t, p);
  int ao[2];                  // ldmatrix row of this lane, K halves 0 / 1
#pragma unroll
  for (int h = 0; h < 2; ++h)
    ao[h] = tile_off((lane & 7) + (lane & 8), 2 * h + (lane >> 4));

  float acc[4][4] = {};
  for (int it = 0; it < nloc; ++it) {
    cp_wait<kStages - 2>();
    __syncthreads();          // chunk it landed; slot of it - 1 consumed
    if (it + kStages - 1 < nloc) load(it + kStages - 1);
    cp_commit();
    const uint8_t* st = ring + (it % kStages) * STAGE;
    const uint8_t* cs = st + A_BYTES;
    const uint8_t* const cw[2] = {cs + cwo[0], cs + cwo[1]};
    const uint32_t sw = lds32(cs + C_BYTES + wn * 32 + 4 * g);
    const float s[4] = {stab[sw & 0xFF], stab[(sw >> 8) & 0xFF],
                        stab[(sw >> 16) & 0xFF], stab[sw >> 24]};
    uint32_t b[2][4][2];
    decode_frag<KIND, 0>(cw, t, et, s, b[0]);
    decode_frag<KIND, 1>(cw, t, et, s, b[1]);
    const uint32_t sa = smem_u32(st);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t af[4];
      ldmatrix_x4(af, sa + ao[h]);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_bf16(acc[j], af, b[h][j]);
    }
  }
  cp_wait<0>();
  // n-tile j's mma columns 2t, 2t + 1 are columns 8t + j, 8t + 4 + j
  const int col = n0 + wn * 32 + 8 * t;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = g + 8 * hf;
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (row < m && col + 4 * e < n)
        *reinterpret_cast<float4*>(out + (long long)row * n + col + 4 * e) =
            make_float4(0.f + acc[0][2 * hf + e], 0.f + acc[1][2 * hf + e],
                        0.f + acc[2][2 * hf + e], 0.f + acc[3][2 * hf + e]);
  }
}

// ---------------------------------------------------------------- prefill
// Decode one chunk's weight tile into the bf16 tile bt (tile_off rows =
// columns of N).  Warp w, lane l: columns 2cp and 2cp + 1 with cp =
// (w / 4) * 32 + l, K rows 8ko .. 8ko + 7 with ko = w % 4.  decode_pair
// fills K rows 8ko + 2P, + 1 of v (so the four pairs can sit between the
// tensor-core work of the chunk before); store_tile writes one
// 16-byte row chunk per column, the two in lane-dependent order so that
// each quarter warp writes eight different bank groups.
template <int KIND, int P>
__device__ __forceinline__ void decode_pair(const uint8_t* cs,
                                            const float* et,
                                            const float (&s)[2], int cp,
                                            int ko, float (&v)[2][8],
                                            uint32_t (&x)[3]) {
  if constexpr (KIND == 0) {
#pragma unroll
    for (int r = 2 * P; r < 2 * P + 2; ++r) {
      const uint32_t y = lds16(cs + (8 * ko + r) * kBN + 2 * cp);
#pragma unroll
      for (int c = 0; c < 2; ++c)
        v[c][r] = et[((y >> (8 * c)) & 0xFF) * 32] * s[c];
    }
  } else if constexpr (KIND == 1) {        // byte row P: K rows 2P, 2P + 1
    const uint32_t y = lds16(cs + (4 * ko + P) * kBN + 2 * cp);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const uint32_t z = (y >> (8 * c)) & 0xFF;
      v[c][2 * P] = et[(z & 0xF) * 32] * s[c];
      v[c][2 * P + 1] = et[(z >> 4) * 32] * s[c];
    }
  } else {            // 3 byte rows hold K rows 4q..4q+3, q = P / 2
    if constexpr (P % 2 == 0) {
      const uint8_t* r = cs + (6 * ko + 3 * (P / 2)) * kBN + 2 * cp;
      x[0] = lds16(r);
      x[1] = lds16(r + kBN);
      x[2] = lds16(r + 2 * kBN);
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const uint32_t y = ((x[0] >> (8 * c)) & 0xFF) |
                         (((x[1] >> (8 * c)) & 0xFF) << 8) |
                         (((x[2] >> (8 * c)) & 0xFF) << 16);
#pragma unroll
      for (int i = 2 * (P % 2); i < 2 * (P % 2) + 2; ++i)
        v[c][4 * (P / 2) + i] = et[((y >> (6 * i)) & 0x3F) * 32] * s[c];
    }
  }
}

__device__ __forceinline__ void store_tile(uint8_t* bt, const float (&v)[2][8],
                                           int cp, int ko, int lane) {
  uint4 w[2];
#pragma unroll
  for (int c = 0; c < 2; ++c)
    w[c] = make_uint4(pack(v[c][0], v[c][1]), pack(v[c][2], v[c][3]),
                      pack(v[c][4], v[c][5]), pack(v[c][6], v[c][7]));
  const int first = (lane >> 2) & 1;
  *reinterpret_cast<uint4*>(bt + tile_off(2 * cp + first, ko)) =
      first ? w[1] : w[0];
  *reinterpret_cast<uint4*>(bt + tile_off(2 * cp + (first ^ 1), ko)) =
      first ? w[0] : w[1];
}

// Prefill stage: A tile (1024-byte aligned, for the tensor map's 64-byte
// swizzle, which is tile_off's), codes tile, scale row.
template <int KIND>
__host__ __device__ constexpr int prefill_stage() {
  return (kPrefillRows * 64 + code_rows<KIND>() * kBN + kBN + 1023) / 1024 *
         1024;
}
template <int KIND>
__host__ __device__ constexpr int prefill_smem() {   // + 1 KB to align the ring
  return 1024 + table_entries<KIND>() * 32 * 4 +
         kStages * prefill_stage<KIND>() + 2 * kBN * 64;
}

// 8 warps, 2 (M) x 4 (N), of 64 x 32 outputs; blockIdx = (M tile, N tile).
// TMA (VEC 16: N a multiple of 16): thread 0 fills each stage with three
// tensor-map boxes counted on the stage's mbarrier, so no other thread
// spends an instruction on loads; out-of-range rows and columns arrive
// as zeros.  VEC 4: every thread copies with cp.async, as the decode
// kernel does.
template <int KIND, int VEC>
__global__ void __launch_bounds__(256, 1) mx_matmul_tc_prefill_kernel(
    const __grid_constant__ CUtensorMap tm_a,
    const __grid_constant__ CUtensorMap tm_codes,
    const __grid_constant__ CUtensorMap tm_scales,
    const __nv_bfloat16* __restrict__ a, const uint8_t* __restrict__ codes,
    const uint8_t* __restrict__ scales, const float* __restrict__ elem_tab,
    const float* __restrict__ scale_tab, float* __restrict__ out, int m,
    int n, int k, int chunks_per_group) {
  constexpr bool TMA = VEC == 16;
  constexpr int NT = 256, BM = kPrefillRows, MT = 4, R = code_rows<KIND>();
  constexpr int A_BYTES = BM * 64, C_BYTES = R * kBN;
  constexpr int STAGE = prefill_stage<KIND>(), B_BYTES = kBN * 64;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ float stab[256];
  __shared__ __align__(8) uint64_t full[kStages];    // TMA: stage filled
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* etab = reinterpret_cast<float*>(smem);
  uint8_t* ring = smem + table_entries<KIND>() * 32 * 4;
  uint8_t* btile = ring + kStages * STAGE;           // two decoded tiles
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * kBN;
  const int nloc = k / kChunk;

  auto load = [&](int c) {
    const uint32_t sa = smem_u32(ring + c % kStages * STAGE);
    if constexpr (TMA) {
      if (tid == 0) {
        const uint32_t bar = smem_u32(&full[c % kStages]);
        bar_expect(bar, A_BYTES + C_BYTES + kBN);
        tma_load(sa, &tm_a, c * kChunk, m0, bar);
        tma_load(sa + A_BYTES, &tm_codes, n0, c * R, bar);
        tma_load(sa + A_BYTES + C_BYTES, &tm_scales, n0, c, bar);
      }
    } else {
      load_chunk<KIND, VEC, NT, BM, false>(sa, a, codes, scales, m, n, k,
                                           m0, n0, c, tid);
    }
  };
  // chunks up to c resident for every thread (the caller then syncs)
  auto wait = [&](int c) {
    if constexpr (TMA)
      bar_wait(smem_u32(&full[c % kStages]), (c / kStages) & 1);
    else
      cp_wait<kStages - 3>();
  };
  auto commit = [&] {
    if constexpr (!TMA) cp_commit();
  };
  const int cp = (warp >> 2) * 32 + lane, ko = warp & 3;   // decode_pair
  const float* et = etab + lane;
  auto scales_of = [&](int c, float (&sc)[2]) {
    const uint32_t sh = lds16(ring + c % kStages * STAGE + A_BYTES +
                              C_BYTES + 2 * cp);
    sc[0] = stab[sh & 0xFF];
    sc[1] = stab[sh >> 8];
  };

  if (TMA && tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) bar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nloc) load(s);
    commit();
  }
  fill_tables<KIND, NT>(etab, stab, elem_tab, scale_tab, tid);
  int ao[2], bo[2][2];        // this lane's ldmatrix rows: A, decoded tile
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    ao[h] = tile_off(wm * MT * 16 + (lane & 7) + (lane & 8),
                     2 * h + (lane >> 4));
#pragma unroll
    for (int jp = 0; jp < 2; ++jp)   // matrices: (n 0-7 | 8-15) x (k lo | hi)
      bo[h][jp] = tile_off(wn * 32 + 16 * jp + (lane & 7) + (lane >> 4) * 8,
                           2 * h + ((lane >> 3) & 1));
  }

  float acc[MT][4][4] = {}, total[MT][4][4] = {};
  wait(0);
  __syncthreads();            // chunk 0 and the tables are in
  {
    float v[2][8], sc[2];
    uint32_t x[3];
    scales_of(0, sc);
    const uint8_t* cs = ring + A_BYTES;
    decode_pair<KIND, 0>(cs, et, sc, cp, ko, v, x);
    decode_pair<KIND, 1>(cs, et, sc, cp, ko, v, x);
    decode_pair<KIND, 2>(cs, et, sc, cp, ko, v, x);
    decode_pair<KIND, 3>(cs, et, sc, cp, ko, v, x);
    store_tile(btile, v, cp, ko, lane);
  }
  int left = chunks_per_group;      // chunks to the end of the K group
  for (int c = 0; c < nloc; ++c) {
    if (c + 1 < nloc) wait(c + 1);
    __syncthreads();  // chunk c + 1 in, tile c decoded; c - 1 all consumed
    if (c + kStages - 1 < nloc) load(c + kStages - 1);
    commit();
    // decode chunk c + 1 (past the last chunk: stale bytes into a spare
    // tile) in four pieces between the tensor-core work of chunk c
    float v[2][8], sc[2];
    uint32_t x[3];
    scales_of(c + 1, sc);
    const uint8_t* cs = ring + (c + 1) % kStages * STAGE + A_BYTES;
    const uint32_t sa = smem_u32(ring + c % kStages * STAGE);
    const uint32_t sb = smem_u32(btile + (c & 1) * B_BYTES);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t b[4][2];
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t r[4];
        ldmatrix_x4(r, sb + bo[h][jp]);
        b[2 * jp][0] = r[0];
        b[2 * jp][1] = r[1];
        b[2 * jp + 1][0] = r[2];
        b[2 * jp + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i == 0 && h == 0) decode_pair<KIND, 0>(cs, et, sc, cp, ko, v, x);
        if (i == 2 && h == 0) decode_pair<KIND, 1>(cs, et, sc, cp, ko, v, x);
        if (i == 0 && h == 1) decode_pair<KIND, 2>(cs, et, sc, cp, ko, v, x);
        if (i == 2 && h == 1) decode_pair<KIND, 3>(cs, et, sc, cp, ko, v, x);
        uint32_t af[4];
        ldmatrix_x4(af, sa + ao[h] + i * 16 * 64);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af, b[j]);
      }
    }
    store_tile(btile + ((c + 1) & 1) * B_BYTES, v, cp, ko, lane);
    if (--left == 0 || c + 1 == nloc) {    // close a K group
      left = chunks_per_group;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            total[i][j][r] += acc[i][j][r];
            acc[i][j][r] = 0.f;
          }
    }
  }
  cp_wait<0>();
  // n-tile j's mma columns 2t, 2t + 1 are columns 8j + 2t, 8j + 2t + 1
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = m0 + (wm * MT + i) * 16 + g + 8 * hf;
      if (row >= m) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn * 32 + 8 * j + 2 * t;
        if (col < n)
          *reinterpret_cast<float2*>(out + (long long)row * n + col) =
              make_float2(total[i][j][2 * hf], total[i][j][2 * hf + 1]);
      }
    }
}

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda)
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D row-major tensor (rows x cols of `type`, row stride in bytes) cut
// into boxes of box_rows x box_cols; elements past the edge read as 0.
bool make_map(CUtensorMap* map, CUtensorMapDataType type, const void* base,
              long long rows, long long cols, long long stride_bytes,
              int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)stride_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box,
                step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename Kern, typename... Args>
cudaError_t launch(Kern kern, bool& configured, int smem, dim3 grid,
                   int threads, cudaStream_t st, Args... args) {
  if (!configured) {      // shared memory above 48 KB needs the attribute
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  kern<<<grid, threads, smem, st>>>(args...);
  return cudaGetLastError();
}

template <int KIND, int VEC>
cudaError_t launch_shape(const void* a, const void* codes,
                         const void* scales, const void* etab,
                         const void* stab, float* dst, int m, int n, int k,
                         int per, int splits, cudaStream_t st) {
  static bool decode_set = false, prefill_set = false;
  const int nt = (n + kBN - 1) / kBN;
  const auto* a16 = (const __nv_bfloat16*)a;
  const auto* c8 = (const uint8_t*)codes;
  const auto* s8 = (const uint8_t*)scales;
  const auto* et = (const float*)etab;
  const auto* st32 = (const float*)stab;
  if (m <= kDecodeRows)      // one K group per blockIdx.z
    return launch(mx_matmul_tc_decode_kernel<KIND, VEC>, decode_set,
                  decode_smem<KIND>(), dim3(1, nt, splits), 128,
                  st, a16, c8, s8, et, st32, dst, m, n, k, per);
  CUtensorMap tm[3] = {};
  if (VEC == 16) {
    const int r = code_rows<KIND>();
    if (!make_map(&tm[0], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a, m, k,
                  2LL * k, kPrefillRows, kChunk, CU_TENSOR_MAP_SWIZZLE_64B) ||
        !make_map(&tm[1], CU_TENSOR_MAP_DATA_TYPE_UINT8, codes,
                  (long long)k / kChunk * r, n, n, r, kBN,
                  CU_TENSOR_MAP_SWIZZLE_NONE) ||
        !make_map(&tm[2], CU_TENSOR_MAP_DATA_TYPE_UINT8, scales, k / kChunk,
                  n, n, 1, kBN, CU_TENSOR_MAP_SWIZZLE_NONE))
      return cudaErrorInvalidValue;
  }
  return launch(mx_matmul_tc_prefill_kernel<KIND, VEC>, prefill_set,
                prefill_smem<KIND>(),
                dim3((m + kPrefillRows - 1) / kPrefillRows, nt, 1), 256, st,
                tm[0], tm[1], tm[2], a16, c8, s8, et, st32, dst, m, n, k,
                per);
}

template <int KIND>
cudaError_t launch_kind(bool v16, const void* a, const void* codes,
                        const void* scales, const void* etab,
                        const void* stab, float* dst, int m, int n, int k,
                        int per, int splits, cudaStream_t st) {
  if (v16)
    return launch_shape<KIND, 16>(a, codes, scales, etab, stab, dst, m, n, k,
                                  per, splits, st);
  return launch_shape<KIND, 4>(a, codes, scales, etab, stab, dst, m, n, k,
                               per, splits, st);
}

}  // namespace

// a (m, k) row-major bf16, 16-byte aligned; k a multiple of 32; n a
// multiple of 4 with codes and scales 4-byte aligned.  pack_kind: 0 one
// code per byte, 1 4-bit packed, 2 6-bit packed.  splits: the K grouping
// of mx_matmul.py's split_count.  For m <= 16 with splits > 1, `partial`
// needs room for splits * m * n floats; otherwise it is unused.
extern "C" int mx_matmul_tc_launch(const void* a, const void* codes,
                                   const void* scales, const void* elem_tab,
                                   const void* scale_tab, void* out,
                                   void* partial, int m, int n, int k,
                                   int pack_kind, int splits, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nchunks = k / kChunk;
  const int per = (nchunks + splits - 1) / splits;
  const bool staged = m <= kDecodeRows && splits > 1;
  float* dst = staged ? (float*)partial : (float*)out;
  const bool v16 = n % 16 == 0 && (uintptr_t)codes % 16 == 0 &&
                   (uintptr_t)scales % 16 == 0;
  cudaError_t err;
  if (pack_kind == 0)
    err = launch_kind<0>(v16, a, codes, scales, elem_tab, scale_tab, dst, m,
                         n, k, per, splits, st);
  else if (pack_kind == 1)
    err = launch_kind<1>(v16, a, codes, scales, elem_tab, scale_tab, dst, m,
                         n, k, per, splits, st);
  else
    err = launch_kind<2>(v16, a, codes, scales, elem_tab, scale_tab, dst, m,
                         n, k, per, splits, st);
  if (err != cudaSuccess || !staged) return (int)err;
  return (int)split_sum((const float*)partial, (float*)out,
                        (long long)m * n, splits, st);
}
