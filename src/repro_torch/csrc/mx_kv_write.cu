// Fused MX KV write for Hopper, sm_90a: one launch quantizes K and V of
// every (row, token, KV head), packs the codes and stores them, with
// their E8M0 scales, straight into the page pool or the contiguous cache.
//
// Replaces, on the port's decode and prefill paths, the converter kernel
// src/repro/kernels/mx_quant.py::_mx_quantize_2d in the role the port
// gave it: the reference writes the KV cache in plain jnp
// (src/repro/models/layers.py::paged_cache_write / cache_write:
// _kv_quant, pack_codes, then an indexed or sliced store).  Composed in
// torch, that write took ~18 launches per layer on the paged path (page
// and offset math, two casts, two converter launches, the packs, four
// index_put_) and 8 on the contiguous one; here it is one.
//
// Design.  One warp per 32-element MX block, one lane per element
// (mx_quant_common.cuh::write_block, which the converter runs too), over
// 2 (K, V) x rows x tokens x KV heads x blocks; the side index selects K
// or V and its format.  k and v arrive in their own dtype (bf16 or f32):
// a bf16 element widens to f32 in a register, exactly as the reference's
// astype(float32).  Lanes past the head dim read 0 and store code 0 (the
// zero-filled padding of kernels/ops.py::mx_quantize).  Codes pack in
// registers: 4-bit codes 2 per byte, low nibble first (an even lane
// takes its neighbour's code with __shfl_down_sync), 6-bit codes 4 per 3
// bytes, little-endian (the quad's first lane gathers three codes);
// 8-bit codes are stored as they are.  Lane 0 stores the block's scale.
// Codes and scales are bit-identical to the plain converter.
//
// Destinations.  Paged, one token per row (decode): the warp reads
// lengths[b] and block_tables[b, lengths[b] / page] itself and writes at
// offset lengths[b] % page, so the launch needs nothing from the host
// but pointers.  Paged, many tokens per row (the suffix prefill under
// prefix caching; the reference's paged_cache_write_tokens): token t of
// row b sits at position starts[b] + t and lands through the block
// table when that position is below ends[b], else on the trash page at
// the same offset (bucket padding).  A live position outside its table,
// or a table entry naming no page of the pool, stops the kernel with
// __trap(): the launch fails and the next synchronizing call raises, as
// the plain version's indexing raises on the same inputs (a scheduler
// fault must not drop a token's K/V in silence).  Rows that are done
// point at the trash page with length 0, and padded positions go there
// too, so their stores collide there, as the indexed stores' do;
// nothing reads that page.  Contiguous: token t of
// row b goes to position pos + t, with pos a launch argument or, when
// pos_dev is given, read from device memory (the static decode step
// replayed from a CUDA graph advances it on the device); a pos that puts
// a token outside the cache traps, as in the paged mode.
//
// Bound.  Bytes: each input element read once (2 or 4 B) and its code and
// 1/32 scale written once; at decode (8 rows x 2 KV heads x D 128) that is
// a few kilobytes, so one launch's latency is the cost.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mx_quant_common.cuh"

namespace {

using mxq::Fmt;
using mxq::Side;

template <typename T>
__global__ void mx_kv_write_kernel(const T* __restrict__ k,
                                   const T* __restrict__ v, Side sk,
                                   Side sv, int rows, int s, int n_kv,
                                   int hd, int nblk,
                                   const int* __restrict__ block_tables,
                                   const int* __restrict__ lengths,
                                   const int* __restrict__ starts,
                                   const int* __restrict__ ends, int trash,
                                   const int* __restrict__ pos_dev,
                                   int max_pages, int page, int n_pages,
                                   int s_max, int pos) {
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long per_side = (long long)rows * s * n_kv * nblk;
  if (warp >= 2 * per_side) return;                // uniform per warp
  const int side = (int)(warp / per_side);
  long long r = warp % per_side;
  const int j = (int)(r % nblk);
  r /= nblk;
  const int h = (int)(r % n_kv);
  r /= n_kv;
  const int t = (int)(r % s);
  const int b = (int)(r / s);
  // destination (token, KV head) row
  long long dst;
  if (block_tables != nullptr) {
    // the token's position, and whether it lands through the table
    const int p = starts != nullptr ? starts[b] + t : lengths[b];
    const bool live = starts == nullptr || p < ends[b];
    if (p < 0 || (live && p / page >= max_pages)) __trap();  // see
    const int pg =                                  // "Destinations"
        live ? block_tables[(long long)b * max_pages + p / page] : trash;
    if (pg < 0 || pg >= n_pages) __trap();
    dst = ((long long)pg * page + p % page) * n_kv + h;
  } else {
    const int p = pos_dev != nullptr ? *pos_dev : pos;
    if (p < 0 || p + s > s_max) __trap();          // see "Destinations"
    dst = ((long long)b * s_max + p + t) * n_kv + h;
  }
  const long long src = (((long long)b * s + t) * n_kv + h) * hd;
  if (side == 0) {             // each call reads its side's fields directly
    mxq::write_block(k + src, sk, dst, hd, nblk, j, lane);
  } else {
    mxq::write_block(v + src, sv, dst, hd, nblk, j, lane);
  }
}

Fmt fmt_of(const int* a) {
  return Fmt{a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[8], a[9],
             a[10]};
}

}  // namespace

// k, v (rows, s, n_kv, hd) f32 (is_bf16 0) or bf16 (1), contiguous.
// fk / fv: the 11 format fields of each role (kernels/mx_quant.py
// ::_format_args) followed by its pack kind and code-row bytes.
// block_tables null: contiguous cache (rows, s_max, n_kv, X), token t at
// pos + t, pos read from pos_dev when that is not null; else paged pool
// (pages, page, n_kv, X): with starts null, one token per row (s == 1) at
// lengths[b]; else token t of row b at starts[b] + t, through the table
// below ends[b], on page ``trash`` from there on.
extern "C" int mx_kv_write_launch(const void* k, const void* v, void* kc,
                                  void* ks, void* vc, void* vs,
                                  const void* block_tables,
                                  const void* lengths, const void* starts,
                                  const void* ends, int trash,
                                  const void* pos_dev,
                                  const void* fk,
                                  const void* fv, int is_bf16, int rows,
                                  int s, int n_kv, int hd, int max_pages,
                                  int page, int n_pages, int s_max, int pos,
                                  void* stream) {
  const int* ak = (const int*)fk;
  const int* av = (const int*)fv;
  const Side sk{fmt_of(ak), ak[11], ak[12], (uint8_t*)kc, (uint8_t*)ks};
  const Side sv{fmt_of(av), av[11], av[12], (uint8_t*)vc, (uint8_t*)vs};
  const int nblk = (hd + 31) / 32;
  const long long warps = 2LL * rows * s * n_kv * nblk;
  const int threads = 128;
  const long long blocks = (warps * 32 + threads - 1) / threads;
  if (blocks > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    const int* bt = (const int*)block_tables;
    const int* ln = (const int*)lengths;
    const int* st0 = (const int*)starts;
    const int* en = (const int*)ends;
    const int* pd = (const int*)pos_dev;
    if (is_bf16) {
      mx_kv_write_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, st>>>(
          (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, sk, sv, rows, s,
          n_kv, hd, nblk, bt, ln, st0, en, trash, pd, max_pages, page,
          n_pages, s_max, pos);
    } else {
      mx_kv_write_kernel<float><<<(unsigned)blocks, threads, 0, st>>>(
          (const float*)k, (const float*)v, sk, sv, rows, s, n_kv, hd, nblk,
          bt, ln, st0, en, trash, pd, max_pages, page, n_pages, s_max, pos);
    }
  }
  return (int)cudaGetLastError();
}
