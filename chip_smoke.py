#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out FILE.json]

Run from the root of a checkout.  Phases, each of which raises on any
failure (the script then exits non-zero and prints no result line):

1. the card's name and power limit; build the CUDA kernels (one source
   per kernel, the MX matmul's and flash attention's two dtypes apart) from
   ``src/repro_torch/csrc`` with nvcc (timed);
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes the serving paths give it, and time kernel, plain version, a
   PyTorch library call on dequantized inputs, and the bound; the
   converter's two kernels (vectorized, and one lane per element for
   ragged or misaligned rows) and the fused KV write (paged and
   contiguous, every format and mode, bit for bit; timed beside today's
   composition of separate launches; the paged mode that writes a span of
   tokens per row, the suffix prefill's, bit for bit and timed); the MX
   matmul, flash attention and both MX decode attentions in bf16 (tensor
   cores) and f32 (CUDA cores), and the matmul's rows bit-identical
   whatever the batch; decode attention's library call is timed under
   every SDPA backend that accepts it and the fastest reported, and the
   kernel and that call also replayed from a CUDA graph (device time
   without the host's per-call work); the contiguous KV write and decode
   attention also with pos in device memory (bit-identical to the host
   int), and bf16 q at head dim 96 (routed to the CUDA-core kernels); the
   LM head's bf16 -> f32 product, timed beside the f32 copy it replaced;
3. load full-width chatglm3-6b (28 layers, random weights from a seed,
   quantized to MX by the converter as each layer is made) and serve it
   through ``ContinuousBatchingEngine`` with 8-bit MX weights, INT8 key
   pages and packed E2M1 value pages, every decode step one replay of
   the engine's captured CUDA graph; count each kernel's launches on the
   load and on the serving run (each replay credits its captured step's
   launches) and check ``sync_every`` 1 and 8 give the same tokens,
   greedy and at temperature 0.8; hold one replayed window against the
   eager loop of the same step (identical tokens, keys and flags,
   byte-identical pools), greedy and sampled, and confirm one replay's
   launches with the profiler; quarantine a prompt with a NaN embedding
   row while its neighbour keeps its solo tokens; serve requests sharing
   a 256-token system prompt with the prefix cache off and on (greedy
   and at temperature 0.8: identical tokens, the hits' suffix prefill
   through the multi-token KV write, a copy-on-write fork, a prompt
   extending a finished conversation), and once more with the cache on
   over half the pool (admission reclaims trie pages and backs a
   tentative mapping out; the same tokens); serve SLO classes (the
   ``slo`` phase): batch-class requests preempted by interactive ones
   over half the default pool, their packed pages swapped to pinned host
   memory and restored byte-equal with the tokens of the full pool
   (greedy and T 0.8), a snapshot restored mid-stream, and
   ``AsyncServer`` reject / block / block + preempt under on/off
   arrivals (TTFT per class, SLO attainment, swap GB/s); serve under a
   seeded fault plan (the ``serve_faults`` phase): prefill_nan,
   page_corrupt, swap_corrupt and alloc_fail each aimed at its own request
   over a pool tight enough to preempt — exactly the targets quarantined
   with their pages scrubbed, every other request (the alloc_fail victim,
   swapped out and restored, among them) with the clean run's tokens, the
   same firings on a second run — then the same plan through
   ``AsyncServer(retries=1)`` (every request recovers its clean tokens), a
   120 s stall cut by the stalled-step watchdog and undone from a snapshot,
   and tracing, a metrics registry and a health sample per window on
   against off (identical tokens, nested spans, trace files written, the
   exact ``mx.scale_bytes``, no poison marker); then serve a static
   batch through ``ServeEngine`` on the same weights (its decode step
   captured on a first call, replayed on the second), once with the MX
   KV cache (contiguous MX decode attention, pos on the device) and once
   with a bf16 cache (flash prefill), counting launches of each run,
   against the eager decode loop, and check the continuous engine gives
   the static engine's tokens; then a reduced-width model at head dim
   48, which no attention kernel takes, through both engines in bf16
   (dense attention, the KV write still fused) against the CPU;
4. the continuous engine at full width but 2 layers in f32, once on the
   card and once on the CPU (the kernels' plain versions): first-prefill
   logits and greedy tokens must agree; likewise ``ServeEngine`` over an
   fp cache (flash prefill) on 2 full-width f32 layers.

Every model here runs at ``attn_impl="flash"`` (attention through the
kernels), as the reference's serving cells do.  The line before the last
is a JSON object with one entry per kernel; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet (dense, at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_CUDA_CORE_FLOPS = 67e12
# integer and compare operations per element of the converter, counted
# from csrc/mx_quant.cu (field split, block reductions, one encode path)
CONVERTER_OPS_PER_ELEMENT = 40

POLICY = "weights=e4m3@32:ocp,kv_key=int8@32:ocp,kv_value=e2m1@32:ocp"
FMTS = ("e5m2", "e4m3", "e3m2", "e2m3", "e2m1", "int8")
MODES = ("paper", "ocp")
# K x N of chatglm3-6b's projections
PROJ = {"wq/wo": (4096, 4096), "wk/wv": (4096, 256),
        "w1/w3": (4096, 13696), "w2": (13696, 4096)}
# the M of each timed e4m3 matmul row: decode (8 slots), a prefill of
# 1024 tokens, the static prefill (8 x 512) and a ragged M
TIMED_M = {"wq/wo": (8, 1024), "wk/wv": (8, 1024),
           "w1/w3": (8, 77, 1024, 4096), "w2": (8, 1024, 4096)}
MATMUL_TOL = 1e-4      # max |kernel - plain| / max |plain|: f32 sums of up
#                        to 13696 products in another order
ATTN_TOL_F32 = 2e-5    # the reference's own attention-kernel tolerance
FLASH_TOL_BF16 = 2e-2  # tests/test_kernel_flash_attn.py's bf16 tolerance
KV_WRITE_FMTS = FMTS    # value roles of check_kv_write, beside two keys
BF16_FLIP_TOL = 2e-2   # C5 run (bf16, card vs CPU): a token may differ only
#                        at a top-2 logit gap below this, a few bf16 steps
#                        (2^-8 relative) of the logits; f32 sums in another
#                        order now and then round an activation to the
#                        neighbouring bf16
LOGITS_TOL = 2e-3      # phase 4: card vs CPU, f32, two full-width layers.
#                        The two sum in other orders, so now and then a
#                        K/V element lands on the other side of an MX
#                        rounding step (one E2M1 step is 25-50% of the
#                        element); such a flip moves logits by under 1e-3

RESULTS: dict = {}


def emit(kind: str, **kw) -> None:
    """Print one JSON line and keep it for --out."""
    row = {"phase": kind, **kw}
    RESULTS.setdefault(kind, []).append(row)
    print(json.dumps(row), flush=True)


def bound(nbytes: float, ops: float, op_rate: float):
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / op_rate * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def time_ms(torch, fn, turns: int = 9, flush=None) -> float:
    """Median CUDA-event time of one call over ``turns`` calls, after a
    warm-up; ``flush`` (a large buffer) is rewritten before each call so
    inputs come from device memory, not from L2, as on the serving path."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(turns):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(torch, fn, flush=None) -> float:
    """Median time of one replay of ``fn`` captured in a CUDA graph: the
    device's time for the call without the host's per-call work (Python,
    allocation, launch), which ``time_ms`` includes."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(torch, graph.replay, flush=flush)


def sdpa_ms(torch, flush, *args, **kw):
    """The library yardstick of decode attention: one
    ``scaled_dot_product_attention`` call timed under each backend that
    accepts it.  Returns ({backend: ms}, the fastest backend, its time
    replayed from a CUDA graph or None where it cannot be captured)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def call():
        return F.scaled_dot_product_attention(*args, **kw)

    times = {}
    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
               SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        with sdpa_kernel([be]):
            try:
                times[be.name] = time_ms(torch, call, flush=flush)
            except RuntimeError:              # the backend refuses the call
                continue
    best = min(times, key=times.get)
    with sdpa_kernel([getattr(SDPBackend, best)]):
        try:
            graph = graph_ms(torch, call, flush=flush)
        except RuntimeError:
            graph = None
    return times, best, graph


# =============================================================================
# phase 2: kernels against their plain versions
# =============================================================================
def check_converter(torch, flush):
    """Both converter kernels bit for bit against the plain converter: the
    vectorized one (rows a multiple of 32, 16-byte aligned) and the one-
    lane-per-element one (a ragged row, rows starting 4 bytes in); the
    weight shape timed on each (the second through its C entry, as the
    kernel the converter ran before the vectorized one)."""
    from repro_torch.core.spec import QuantSpec
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.mx_quant import (_format_args, mx_quantize_2d,
                                              vectorized)
    gen = torch.Generator(device="cuda").manual_seed(1)
    dev = "cuda"
    special = torch.randn(64, 4096, generator=gen, device=dev)
    special[1] *= 1e-39                              # f32 subnormals
    special[2, 5] = float("nan")
    special[3, 70] = float("inf")
    special[4, 99] = -float("inf")
    special[5] = 0.0
    special[6] *= torch.exp2(torch.randint(-140, 120, (4096,),
                                           generator=gen, device=dev).float())
    special[7, :32] = 1e-45 * torch.arange(32, device=dev)
    shapes = {
        "kv_write (8 slots x 2 heads, D=128)":
            torch.randn(16, 128, generator=gen, device=dev),
        "special blocks (NaN/Inf/subnormal)": special,
        "weight load, w1^T (13696 x 4096)":
            torch.randn(13696, 4096, generator=gen, device=dev) * 0.016,
        "ragged rows (N=77)": torch.randn(33, 77, generator=gen, device=dev),
        "misaligned rows (start 4 B in)": torch.randn(
            64 * 4096 + 1, generator=gen, device=dev)[1:].view(64, 4096),
    }
    kernel_of = {name: "vectorized" if vectorized(x) else "lane"
                 for name, x in shapes.items()}
    if [n for n, k in kernel_of.items() if k == "lane"] != [
            "ragged rows (N=77)", "misaligned rows (start 4 B in)"]:
        raise AssertionError(f"converter kernel choice {kernel_of}")
    n_checked = 0
    for fmt in FMTS:
        for mode in MODES:
            spec = QuantSpec(fmt, mode)
            for name, x in shapes.items():
                c, s = mx_quantize_2d(x, spec)
                rc, rs = ref.mx_quantize_2d_ref(x, spec)
                if not (torch.equal(c, rc) and torch.equal(s, rs)):
                    raise AssertionError(
                        f"converter {spec} on {name}: kernel differs from "
                        f"the plain version")
                n_checked += 1
    emit("check", kernel="mx_quantize_2d", compared=n_checked,
         kernels=kernel_of, criterion="bit-identical codes and scales")
    rows = {}
    for name, spec in (("kv_write (8 slots x 2 heads, D=128)", "int8@32:ocp"),
                       ("weight load, w1^T (13696 x 4096)", "e4m3@32:ocp")):
        x = shapes[name]
        spec = QuantSpec.parse(spec)
        n = x.numel()
        tb, by = bound(n * (4 + 1 + 1 / 32), n * CONVERTER_OPS_PER_ELEMENT,
                       F32_CUDA_CORE_FLOPS)
        row = dict(kernel="mx_quantize_2d", shape=name, spec=str(spec),
                   ms=time_ms(torch, lambda: mx_quantize_2d(x, spec),
                              flush=flush),
                   plain_ms=time_ms(torch, lambda: ref.mx_quantize_2d_ref(
                       x, spec), flush=flush),
                   bound_ms=tb, bound_by=by, library_ms=None,
                   converter_kernel=kernel_of[name])
        if kernel_of[name] == "vectorized":
            m, n = x.shape
            codes = torch.empty((m, n), dtype=torch.uint8, device=dev)
            scales = torch.empty((m, n // 32), dtype=torch.uint8, device=dev)
            args = (x.data_ptr(), codes.data_ptr(), scales.data_ptr(), m, n,
                    *_format_args(spec))

            def lane():
                build.check(build.lib().mx_quant_launch(
                    *args, torch.cuda.current_stream().cuda_stream), "lane")

            row["lane_kernel_ms"] = time_ms(torch, lane, flush=flush)
            if not torch.equal(codes, mx_quantize_2d(x, spec)[0]):
                raise AssertionError("converter: the two kernels disagree")
        emit("time", **row)
        rows[name] = row
    return rows["weight load, w1^T (13696 x 4096)"], 0.0


def _composed_kv_write(torch, pool, k, v, block_tables, lengths, kspec,
                       vspec):
    """The paged KV write as the port composed it before the fused kernel
    (separate launches: page and offset math, the bf16 -> f32 casts, the
    converter kernel per role, the packs, four indexed stores).  A
    yardstick timed here only; the port no longer runs it."""
    from repro_torch.core.pack import pack_codes
    from repro_torch.kernels.ops import mx_quantize
    page = pool["kc_pages"].shape[1]
    pages = torch.gather(block_tables, 1, (lengths // page)[:, None].to(
        torch.int64))[:, 0].to(torch.int64)
    offsets = (lengths % page).to(torch.int64)
    out = {}
    for side, x, spec in (("k", k, kspec), ("v", v, vspec)):
        mx = mx_quantize(x, spec, axis=-1)
        c = pack_codes(mx.codes, spec.fmt) if spec.packed else mx.codes
        out[f"{side}c_pages"], out[f"{side}s_pages"] = c, mx.scales
    for name, val in out.items():
        pool[name][pages, offsets] = val[:, 0]


def _kv_rand(torch, gen, shape, dtype, special):
    """k or v on the card; ``special`` adds a NaN block and an Inf block
    (paper-mode markers) and an f32-subnormal row."""
    x = torch.randn(shape, generator=gen, device="cuda")
    if special:
        x[0, 0, 0, 5] = float("nan")
        x[-1, -1, -1, 40] = -float("inf")
        x[..., 1, :] *= 1e-39
    return x.to(dtype)


def check_kv_write(torch, flush):
    """The fused KV write (csrc/mx_kv_write.cu) bit for bit against its
    plain versions on the card: every value format x mode beside INT8 and
    E4M3 keys, packed and unpacked pools, pages of 16 (bf16 k/v, D 128)
    and 8 (f32, D 48: codes padded to 64), slots mid-page, at a page's
    last offset and at offset 0 of a fresh page, idle slots on the trash
    page (left out of the comparison: their stores collide there, in any
    order); NaN / Inf blocks in paper mode; the contiguous cache at s 1
    and 512; and the two timed writes (the paged decode write at the
    serving shape, the static prefill's 8 x 512).  Timed beside the plain
    version and today's composition of separate launches."""
    from repro_torch.core.spec import QuantSpec
    from repro_torch.kernels import ref
    from repro_torch.kernels.mx_kv_write import (mx_cache_kv_write,
                                                 mx_paged_kv_write,
                                                 mx_paged_kv_write_tokens)
    gen = torch.Generator(device="cuda").manual_seed(9)
    dev = "cuda"

    def rand_bytes(shape):
        return torch.randint(0, 256, shape, generator=gen, device=dev,
                             dtype=torch.uint8)

    def pool_of(kspec, vspec, n_pages, page, n_kv, hd):
        cl = -(-hd // 32) * 32
        return {"kc_pages": rand_bytes((n_pages, page, n_kv,
                                        kspec.storage_nbytes(cl))),
                "ks_pages": rand_bytes((n_pages, page, n_kv, cl // 32)),
                "vc_pages": rand_bytes((n_pages, page, n_kv,
                                        vspec.storage_nbytes(cl))),
                "vs_pages": rand_bytes((n_pages, page, n_kv, cl // 32))}

    def same(what, got, want):
        for n in got:
            if not torch.equal(got[n], want[n]):
                raise AssertionError(f"{what}: {n} differs from the plain "
                                     f"version")

    b, n_kv, npg = 8, 2, 4
    n_paged = n_cache = n_tokens = 0
    for kname in ("int8@32:ocp", "e4m3@32:paper"):
        kspec = QuantSpec.parse(kname)
        for fmt in KV_WRITE_FMTS:
            for mode in MODES:
                for packed in (True, False):
                    vspec = QuantSpec(fmt, mode, 32, packed)
                    for page, hd, dt in ((16, 128, torch.bfloat16),
                                         (8, 48, torch.float32)):
                        pool = pool_of(kspec, vspec, 1 + b * npg, page, n_kv,
                                       hd)
                        plain = {n: t.clone() for n, t in pool.items()}
                        bt = (1 + torch.arange(b * npg, dtype=torch.int32,
                                               device=dev)).reshape(b, npg)
                        bt[6:] = 0                       # idle slots
                        lengths = torch.tensor(
                            [5, page - 1, page, 2 * page, 3 * page + 2,
                             4 * page - 1, 0, 0], dtype=torch.int32,
                            device=dev)
                        k, v = (_kv_rand(torch, gen, (b, 1, n_kv, hd), dt,
                                         "paper" in (mode, kspec.mode))
                                for _ in range(2))
                        mx_paged_kv_write(pool, k, v, bt, lengths, kspec,
                                          vspec)
                        ref.mx_paged_kv_write_ref(plain, k, v, bt, lengths,
                                                  kspec, vspec)
                        for n in pool:
                            if not torch.equal(pool[n][1:], plain[n][1:]):
                                raise AssertionError(
                                    f"mx_paged_kv_write {kspec}/{vspec} page "
                                    f"{page} D {hd} {dt}: {n} differs from "
                                    f"the plain version")
                        n_paged += 1
                        # a span of tokens per row (the suffix prefill):
                        # starts mid-page, one row wholly padding
                        s_ = 2 * page + 3
                        starts = torch.tensor([3, page - 1, page, 2],
                                              dtype=torch.int32, device=dev)
                        ends = starts + torch.tensor(
                            [s_, s_ - 5, 1, 0], dtype=torch.int32,
                            device=dev)
                        k, v = (_kv_rand(torch, gen, (4, s_, n_kv, hd), dt,
                                         "paper" in (mode, kspec.mode))
                                for _ in range(2))
                        plain = {n: t.clone() for n, t in pool.items()}
                        mx_paged_kv_write_tokens(pool, k, v, bt[:4], starts,
                                                 ends, kspec, vspec)
                        ref.mx_paged_kv_write_tokens_ref(
                            plain, k, v, bt[:4], starts, ends, kspec, vspec)
                        same(f"mx_paged_kv_write_tokens {kspec}/{vspec} "
                             f"page {page} D {hd} {dt}",
                             {n: t[1:] for n, t in pool.items()},
                             {n: t[1:] for n, t in plain.items()})
                        n_tokens += 1
                # the contiguous cache: a prefill of 512, then a decode
                vspec = QuantSpec(fmt, mode)
                for hd, dt in ((128, torch.bfloat16), (48, torch.float32)):
                    cl = -(-hd // 32) * 32
                    cache = {n: rand_bytes((2, 520, n_kv, w)) for n, w in
                             (("k_codes", cl), ("k_scales", cl // 32),
                              ("v_codes", cl), ("v_scales", cl // 32))}
                    plain = {n: t.clone() for n, t in cache.items()}
                    # the same writes at a position read from device memory
                    on_dev = {n: t.clone() for n, t in cache.items()}
                    for pos, s_ in ((0, 512), (512, 1), (519, 1)):
                        k, v = (_kv_rand(torch, gen, (2, s_, n_kv, hd), dt,
                                         "paper" in (mode, kspec.mode))
                                for _ in range(2))
                        mx_cache_kv_write(cache, k, v, pos, kspec, vspec)
                        mx_cache_kv_write(on_dev, k, v, torch.tensor(
                            [pos], dtype=torch.int32, device=dev), kspec,
                            vspec)
                        ref.mx_cache_kv_write_ref(plain, k, v, pos, kspec,
                                                  vspec)
                    for got, how in ((cache, "host pos"),
                                     (on_dev, "device pos")):
                        for n in got:
                            if not torch.equal(got[n], plain[n]):
                                raise AssertionError(
                                    f"mx_cache_kv_write ({how}) {kspec}/"
                                    f"{vspec} D {hd} {dt}: {n} differs from "
                                    f"the plain version")
                    n_cache += 2
    # timing at the serving shape: 8 slots, 2 KV heads, D 128, bf16,
    # INT8 keys / packed E2M1 values, pages of 16 (the continuous path)
    kspec, vspec = QuantSpec.parse("int8@32:ocp"), QuantSpec.parse(
        "e2m1@32:ocp")
    b, page, npg, hd = 8, 16, 36, 128
    pool = pool_of(kspec, vspec, 1 + b * npg, page, n_kv, hd)
    bt = (1 + torch.randperm(b * npg, generator=gen, device=dev)).reshape(
        b, npg).to(torch.int32)
    lengths = torch.randint(0, npg * page, (b,), generator=gen, device=dev,
                            dtype=torch.int32)
    k, v = (_kv_rand(torch, gen, (b, 1, n_kv, hd), torch.bfloat16, False)
            for _ in range(2))
    rows = b * n_kv
    nbytes = (2 * k.numel() * k.element_size() + 2 * b * 4
              + rows * (kspec.storage_nbytes(hd) + vspec.storage_nbytes(hd)
                        + 2 * hd // 32))
    tb, by = bound(nbytes, 2 * k.numel() * CONVERTER_OPS_PER_ELEMENT,
                   F32_CUDA_CORE_FLOPS)
    args = (pool, k, v, bt, lengths, kspec, vspec)
    plain = {n: t.clone() for n, t in pool.items()}
    mx_paged_kv_write(*args)
    ref.mx_paged_kv_write_ref(plain, *args[1:])
    same("mx_paged_kv_write at the timed shape", pool, plain)
    row = dict(kernel="mx_kv_write",
               shape="paged decode write: 8 slots, Hkv 2, D 128, bf16",
               spec="int8@32:ocp/e2m1@32:ocp", max_abs_err=0.0,
               ms=time_ms(torch, lambda: mx_paged_kv_write(*args),
                          flush=flush),
               graph_ms=graph_ms(torch, lambda: mx_paged_kv_write(*args),
                                 flush=flush),
               plain_ms=time_ms(torch, lambda: ref.mx_paged_kv_write_ref(
                   *args), flush=flush),
               composed_ms=time_ms(torch, lambda: _composed_kv_write(
                   torch, *args), flush=flush),
               bound_ms=tb, bound_by=by, library_ms=None)
    try:            # a yardstick only: None where capture is refused
        row["composed_graph_ms"] = graph_ms(
            torch, lambda: _composed_kv_write(torch, *args), flush=flush)
    except RuntimeError:
        row["composed_graph_ms"] = None
    emit("time", **row)
    row["multi_token"] = _time_kv_write_tokens(torch, flush, gen, pool_of,
                                               same)
    n_tokens += 1
    # the static prefill's write: 8 rows x 512 positions
    cache = {n: rand_bytes((8, 584, n_kv, w)) for n, w in
             (("k_codes", hd), ("k_scales", hd // 32), ("v_codes", hd),
              ("v_scales", hd // 32))}
    k, v = (_kv_rand(torch, gen, (8, 512, n_kv, hd), torch.bfloat16, False)
            for _ in range(2))
    plain = {n: t.clone() for n, t in cache.items()}
    mx_cache_kv_write(cache, k, v, 0, kspec, vspec)
    ref.mx_cache_kv_write_ref(plain, k, v, 0, kspec, vspec)
    same("mx_cache_kv_write at the timed shape", cache, plain)
    emit("check", kernel="mx_kv_write", compared_paged=n_paged + 1,
         compared_contiguous=n_cache + 1, compared_multi_token=n_tokens,
         criterion="bit-identical pool and cache bytes (page 0, the trash "
                   "page, left out); the contiguous cache at a host pos and "
                   "at a pos in device memory; the timed paged and prefill "
                   "writes included")
    nbytes = 2 * k.numel() * (2 + 1 + 1 / 32)
    tb2, by2 = bound(nbytes, 2 * k.numel() * CONVERTER_OPS_PER_ELEMENT,
                     F32_CUDA_CORE_FLOPS)
    emit("time", kernel="mx_kv_write",
         shape="contiguous prefill write: 8 x 512 tokens, Hkv 2, D 128, bf16",
         spec="int8@32:ocp/e2m1@32:ocp",
         ms=time_ms(torch, lambda: mx_cache_kv_write(
             cache, k, v, 0, kspec, vspec), flush=flush),
         plain_ms=time_ms(torch, lambda: ref.mx_cache_kv_write_ref(
             cache, k, v, 0, kspec, vspec), flush=flush),
         bound_ms=tb2, bound_by=by2, library_ms=None)
    return row, 0.0


def _matmul_row(torch, ref, mx_matmul_2d, a, mw, codes, spec, pname, flush):
    """Time the kernel, its plain version and torch.matmul on the
    dequantized bf16 weight at one shape; check the kernel's error."""
    m, k = a.shape
    n = codes.shape[1]
    got = mx_matmul_2d(a, mw.codes, mw.scales, mw.spec)
    want = ref.mx_matmul_2d_ref(a, codes, mw.scales, spec)
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not err <= MATMUL_TOL * scale:
        raise AssertionError(f"mx_matmul {spec} {pname} M={m}: max error "
                             f"{err} > {MATMUL_TOL} x {scale}")
    wd = ref.dequant_ref(codes, mw.scales, spec).to(torch.bfloat16)
    nbytes = a.numel() * a.element_size() + mw.nbytes + m * n * 4
    tb, by = bound(nbytes, 2.0 * m * n * k, BF16_FLOPS)
    row = dict(
        kernel="mx_matmul_2d", shape=f"{pname} M={m}", m=m, k=k, n=n,
        spec=str(spec), act=str(a.dtype).replace("torch.", ""),
        max_abs_err=err,
        ms=time_ms(torch, lambda: mx_matmul_2d(a, mw.codes, mw.scales,
                                               mw.spec), flush=flush),
        plain_ms=time_ms(torch, lambda: ref.mx_matmul_2d_ref(
            a, codes, mw.scales, spec), flush=flush),
        library_ms=time_ms(torch, lambda: torch.matmul(a, wd), flush=flush),
        bound_ms=tb, bound_by=by)
    emit("time", **row)
    return row


def _time_kv_write_tokens(torch, flush, gen, pool_of, same):
    """The multi-token paged write at the suffix prefill's shape: 8 rows
    of a 64-token bucket, starts off page boundaries, each row's tail
    past its end on the trash page; INT8 keys / packed E2M1 values, bf16,
    D 128, pages of 16.  Bit for bit against the plain version (the trash
    page left out), then timed beside it and its byte bound."""
    from repro_torch.core.spec import QuantSpec
    from repro_torch.kernels import ref
    from repro_torch.kernels.mx_kv_write import mx_paged_kv_write_tokens
    kspec, vspec = QuantSpec.parse("int8@32:ocp"), QuantSpec.parse(
        "e2m1@32:ocp")
    g, s, n_kv, hd, page, npg = 8, 64, 2, 128, 16, 20
    dev = "cuda"
    pool = pool_of(kspec, vspec, 1 + g * npg, page, n_kv, hd)
    bt = (1 + torch.randperm(g * npg, generator=gen, device=dev)).reshape(
        g, npg).to(torch.int32)
    starts = torch.randint(0, 256, (g,), generator=gen, device=dev,
                           dtype=torch.int32)
    starts[0] = 17                                  # off a page boundary
    ends = starts + torch.randint(1, s + 1, (g,), generator=gen, device=dev,
                                  dtype=torch.int32)
    k, v = (_kv_rand(torch, gen, (g, s, n_kv, hd), torch.bfloat16, False)
            for _ in range(2))
    args = (pool, k, v, bt, starts, ends, kspec, vspec)
    plain = {n: t.clone() for n, t in pool.items()}
    mx_paged_kv_write_tokens(*args)
    ref.mx_paged_kv_write_tokens_ref(plain, *args[1:])
    same("mx_paged_kv_write_tokens at the timed shape",
         {n: t[1:] for n, t in pool.items()},
         {n: t[1:] for n, t in plain.items()})
    # the work these rows need: the live tokens' k/v read once, their
    # codes and scales written once (the padding's trash stores are waste)
    rows = int((ends - starts).sum()) * n_kv
    nbytes = (rows * hd * 2 * k.element_size() + bt.numel() * 4 + 2 * g * 4
              + rows * (kspec.storage_nbytes(hd) + vspec.storage_nbytes(hd)
                        + 2 * hd // 32))
    tb, by = bound(nbytes, 2 * rows * hd * CONVERTER_OPS_PER_ELEMENT,
                   F32_CUDA_CORE_FLOPS)
    row = dict(kernel="mx_kv_write",
               shape="paged multi-token write: 8 rows x 64 tokens, Hkv 2, "
                     "D 128, bf16",
               spec="int8@32:ocp/e2m1@32:ocp", max_abs_err=0.0,
               live_tokens=int((ends - starts).sum()),
               ms=time_ms(torch, lambda: mx_paged_kv_write_tokens(*args),
                          flush=flush),
               graph_ms=graph_ms(torch,
                                 lambda: mx_paged_kv_write_tokens(*args),
                                 flush=flush),
               plain_ms=time_ms(torch, lambda: ref
                                .mx_paged_kv_write_tokens_ref(*args),
                                flush=flush),
               bound_ms=tb, bound_by=by, library_ms=None)
    emit("time", **row)
    return row


def check_matmul(torch, flush):
    """bf16 activations (the serving path, tensor-core kernel): 6 formats x
    2 modes x 4 projections at M 8 and 1024; f32 activations (CUDA-core
    kernels): one projection per format at M 8 and 1024; timed rows for
    e4m3@32:ocp at M 8, 1024, the static prefill's 4096 and a ragged 77;
    then rows of a call must not depend on the rest of its batch."""
    from repro_torch.core.mx_weight import MXWeight
    from repro_torch.core.pack import unpack_codes_rows
    from repro_torch.core.spec import QuantSpec
    from repro_torch.kernels import ref
    from repro_torch.kernels.mx_matmul import mx_matmul_2d
    gen = torch.Generator(device="cuda").manual_seed(2)
    acts = {m: {k: torch.randn(m, k, generator=gen, device="cuda").to(
        torch.bfloat16) for k in (4096, 13696)} for m in (8, 77, 1024, 4096)}
    worst, n_checked, timed = 0.0, 0, {}
    for fi, fmt in enumerate(FMTS):
        for mode in MODES:
            spec = QuantSpec(fmt, mode)            # packed where sub-byte
            for pi, (pname, (k, n)) in enumerate(PROJ.items()):
                w = (torch.randn(k, n, generator=gen, device="cuda")
                     / math.sqrt(k)).to(torch.bfloat16)
                mw = MXWeight.quantize(w, spec)
                codes = unpack_codes_rows(mw.codes, fmt, k) if mw.packed \
                    else mw.codes
                # f32 activations through the CUDA-core kernels: one
                # projection per format
                f32_pass = mode == "ocp" and pi == fi % len(PROJ)
                for m in (8, 1024):
                    for a in ((acts[m][k], acts[m][k].float()) if f32_pass
                              else (acts[m][k],)):
                        got = mx_matmul_2d(a, mw.codes, mw.scales, mw.spec)
                        want = ref.mx_matmul_2d_ref(a, codes, mw.scales,
                                                    spec)
                        err = float((got - want).abs().max())
                        scale = float(want.abs().max())
                        if not err <= MATMUL_TOL * scale:
                            raise AssertionError(
                                f"mx_matmul {spec} {pname} M={m} {a.dtype}: "
                                f"max error {err} > {MATMUL_TOL} x {scale}")
                        worst = max(worst, err)
                        n_checked += 1
                if str(spec) != "e4m3@32:ocp":
                    continue
                for m in TIMED_M[pname]:
                    row = _matmul_row(torch, ref, mx_matmul_2d, acts[m][k],
                                      mw, codes, spec, pname, flush)
                    worst = max(worst, row["max_abs_err"])
                    n_checked += 1
                    timed[(pname, m)] = row
    emit("check", kernel="mx_matmul_2d", compared=n_checked,
         max_abs_err=worst,
         criterion=f"max|kernel-plain| <= {MATMUL_TOL} * max|plain|")
    check_batch_invariance(torch, gen)
    return timed[("w1/w3", 8)], worst


def check_batch_invariance(torch, gen):
    """bf16 rows of M=8 and M=16 calls (the decode shape) and of slices
    that cross the prefill kernel's 128-row tiles are bit-identical to the
    same rows of M=1024 and M=4096 calls (the prefill shape)."""
    from repro_torch.core.mx_weight import MXWeight
    from repro_torch.core.spec import QuantSpec
    from repro_torch.kernels.mx_matmul import mx_matmul_2d
    slices = ((0, 8), (0, 16), (120, 136), (1016, 1024), (250, 260),
              (100, 260), (1000, 1100), (2040, 2056), (4088, 4096),
              (3000, 3077))
    n_checked = 0
    for spec in ("e4m3@32:ocp", "e2m1@32:ocp", "e3m2@32:paper"):
        spec = QuantSpec.parse(spec)               # sub-byte codes packed
        for pname in ("w1/w3", "w2"):
            k, n = PROJ[pname]
            w = torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k)
            mw = MXWeight.quantize(w, spec)
            a = torch.randn(4096, k, generator=gen, device="cuda").to(
                torch.bfloat16)
            full = mx_matmul_2d(a, mw.codes, mw.scales, mw.spec)
            part = mx_matmul_2d(a[:1024].contiguous(), mw.codes, mw.scales,
                                mw.spec)
            if not torch.equal(part, full[:1024]):
                raise AssertionError(f"mx_matmul {spec} {pname}: rows of an "
                                     f"M=1024 call differ from an M=4096 "
                                     f"call")
            n_checked += 1
            for lo, hi in slices:
                part = mx_matmul_2d(a[lo:hi].contiguous(), mw.codes,
                                    mw.scales, mw.spec)
                if not torch.equal(part, full[lo:hi]):
                    raise AssertionError(
                        f"mx_matmul {spec} {pname}: rows {lo}:{hi} of an "
                        f"M={hi - lo} call differ from the M=4096 call")
                n_checked += 1
    emit("check", kernel="mx_matmul_2d", what="batch invariance",
         compared=n_checked, criterion="torch.equal")


def _paged_case(torch, kspec, vspec, gen, d=128):
    from repro_torch.core.pack import pack_codes
    from repro_torch.kernels.mx_quant import mx_quantize_2d
    b, hq, hkv, page, npg = 8, 32, 2, 16, 36
    n_pool = 1 + b * npg
    lengths = torch.randint(1, 575, (b,), generator=gen, device="cuda")
    lengths[0], lengths[1] = 575, 0                 # full 576 tokens; idle
    lengths = lengths.to(torch.int32)

    def pool(spec):
        x = torch.randn(n_pool * page * hkv, d, generator=gen, device="cuda")
        c, s = mx_quantize_2d(x, spec)
        if spec.packed:
            c = pack_codes(c, spec.fmt)
        return (c.reshape(n_pool, page, hkv, -1).contiguous(),
                s.reshape(n_pool, page, hkv, d // 32).contiguous())

    kc, ks = pool(kspec)
    vc, vs = pool(vspec)
    perm = torch.randperm(n_pool - 1, generator=gen, device="cuda") + 1
    bt = perm.reshape(b, npg).to(torch.int32)
    live = (lengths.to(torch.int64) // page + 1)[:, None]
    bt = torch.where(torch.arange(npg, device="cuda")[None, :] < live, bt,
                     0).to(torch.int32).contiguous()   # trash-padded rows
    q = torch.randn(b, 1, hq, d, generator=gen, device="cuda")
    return q, kc, ks, vc, vs, bt, lengths


def _attn_check(torch, got, want, worst):
    """f32 within ATTN_TOL_F32 (CUDA-core kernels); bf16 (tensor-core
    kernels) within torch's bf16 defaults: one bf16 rounding of f32
    results.  Keeps the worst error of each dtype in ``worst``."""
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=ATTN_TOL_F32,
                                   atol=ATTN_TOL_F32)
    else:
        torch.testing.assert_close(got, want)
    err = float((got.float() - want.float()).abs().max())
    worst[got.dtype] = max(worst[got.dtype], err)


def check_paged_attention(torch, flush):
    from repro_torch.core.spec import QuantSpec
    from repro_torch.kernels import ref
    from repro_torch.kernels.mx_decode_attn import mx_paged_decode_attention
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n_checked, row = 0, None
    for kv in ("int8@32:ocp/int8@32:ocp", "int8@32:ocp/e2m1@32:ocp"):
        kspec, vspec = (QuantSpec.parse(s) for s in kv.split("/"))
        q32, kc, ks, vc, vs, bt, lengths = _paged_case(torch, kspec, vspec,
                                                       gen)
        # f32 q; bf16 q, also with scores x8 (a peaked softmax)
        for q in (q32, q32.to(torch.bfloat16), (q32 * 8).to(torch.bfloat16)):
            args = (q, kc, ks, vc, vs, bt, lengths)
            kw = dict(key_spec=kspec, value_spec=vspec, rep=16)
            _attn_check(torch, mx_paged_decode_attention(*args, **kw),
                        ref.mx_paged_decode_attention_ref(*args, **kw),
                        worst)
            n_checked += 1
        if vspec.fmt != "e2m1":
            continue
        # timing at the serving path's types: bf16 q, INT8 K / E2M1 V
        q = q32.to(torch.bfloat16)
        args = (q, kc, ks, vc, vs, bt, lengths)
        kw = dict(key_spec=kspec, value_spec=vspec, rep=16)
        b, _, hq, d = q.shape
        page, hkv = kc.shape[1], kc.shape[2]
        tokens = int((lengths.to(torch.int64) + 1).sum())
        per_tok = hkv * (kc.shape[-1] + vc.shape[-1] + 2 * (d // 32))
        nbytes = tokens * per_tok + 2 * q.numel() * 2 + bt.numel() * 4
        tb, by = bound(nbytes, 4.0 * hq * tokens * d, BF16_FLOPS)
        # the library yardstick: SDPA over the dequantized, gathered cache
        s_max = bt.shape[1] * page
        kd, vd = _gathered(torch, ref, kc, ks, vc, vs, bt, kspec, vspec)
        mask = (torch.arange(s_max, device="cuda")[None, :]
                <= lengths[:, None].to(torch.int64))[:, None, None, :]
        qt = q.transpose(1, 2)
        sdpa, best, sdpa_graph = sdpa_ms(torch, flush, qt, kd, vd,
                                         attn_mask=mask, enable_gqa=True)
        row = dict(kernel="mx_paged_decode_attention",
                   shape="8 slots, lengths <= 576, page 16, Hq 32, Hkv 2, "
                         "D 128", spec=kv,
                   ms=time_ms(torch, lambda: mx_paged_decode_attention(
                       *args, **kw), flush=flush),
                   graph_ms=graph_ms(torch, lambda: mx_paged_decode_attention(
                       *args, **kw), flush=flush),
                   library_graph_ms=sdpa_graph,
                   plain_ms=time_ms(torch, lambda: ref
                                    .mx_paged_decode_attention_ref(
                                        *args, **kw), flush=flush),
                   library_ms=sdpa[best], library_backend=best,
                   sdpa_ms=sdpa, bound_ms=tb, bound_by=by,
                   live_tokens=tokens)
        emit("time", **row)
    emit("check", kernel="mx_paged_decode_attention", compared=n_checked,
         max_abs_err_bf16=worst[torch.bfloat16],
         max_abs_err_f32=worst[torch.float32],
         criterion=f"f32 within {ATTN_TOL_F32}; bf16 within torch's bf16 "
                   f"defaults")
    return dict(row, max_abs_err_f32=worst[torch.float32]), \
        worst[torch.bfloat16]


def check_head_dim_96(torch):
    """bf16 q at head dim 96, a multiple of 32 the tensor-core kernels are
    not built for: both decode-attention wrappers route it by its shape
    to their CUDA-core kernel on an f32 copy of q (one launch each) and
    cast back; held to torch's bf16 defaults against the plain version,
    at the serving shapes otherwise (8 slots / rows, Hq 32, Hkv 2, INT8 K
    and E2M1 V)."""
    from repro_torch.core.spec import QuantSpec
    from repro_torch.kernels import ref
    from repro_torch.kernels.mx_decode_attn import (mx_decode_attention,
                                                    mx_paged_decode_attention)
    from repro_torch.kernels.mx_quant import mx_quantize_2d
    gen = torch.Generator(device="cuda").manual_seed(96)
    kspec, vspec = (QuantSpec.parse(s) for s in ("int8@32:ocp",
                                                 "e2m1@32:ocp"))
    kw = dict(key_spec=kspec, value_spec=vspec, rep=16)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    q32, kc, ks, vc, vs, bt, lengths = _paged_case(torch, kspec, vspec, gen,
                                                   d=96)
    args = (q32.to(torch.bfloat16), kc, ks, vc, vs, bt, lengths)
    before = mx_paged_decode_attention.launches
    got = mx_paged_decode_attention(*args, **kw)
    if mx_paged_decode_attention.launches != before + 1 \
            or got.dtype != torch.bfloat16:
        raise AssertionError("paged decode attention at D 96: not one "
                             "launch with a bf16 output")
    _attn_check(torch, got, ref.mx_paged_decode_attention_ref(*args, **kw),
                worst)
    b, s, hkv, d = 8, 640, 2, 96
    cache = []
    for spec in (kspec, vspec):
        x = torch.randn(b * s * hkv, d, generator=gen, device="cuda")
        c, sc = mx_quantize_2d(x, spec)
        cache += [c.reshape(b, s, hkv, d), sc.reshape(b, s, hkv, d // 32)]
    q = torch.randn(b, 1, 32, d, generator=gen,
                    device="cuda").to(torch.bfloat16)
    for pos in (0, 63, 575, 639):
        before = mx_decode_attention.launches
        got = mx_decode_attention(q, *cache, pos, **kw)
        if mx_decode_attention.launches != before + 1:
            raise AssertionError("decode attention at D 96: not one launch")
        _attn_check(torch, got, ref.mx_decode_attention_ref(
            q, *cache, torch.full((b,), pos, dtype=torch.int32,
                                  device="cuda"), **kw), worst)
    emit("check", kernel="mx_paged_decode_attention / mx_decode_attention",
         what="bf16 q at head dim 96 (CUDA-core kernels on an f32 copy)",
         compared=5, max_abs_err_bf16=worst[torch.bfloat16],
         criterion="torch's bf16 defaults; one launch per call")


def _gathered(torch, ref, kc, ks, vc, vs, bt, kspec, vspec):
    """(B, Hkv, S, D) bf16 K and V, dequantized through the block table."""
    from repro_torch.core.pack import unpack_codes
    b, npg = bt.shape
    bt64 = bt.to(torch.int64)
    d = ks.shape[-1] * 32

    def one(codes, scales, spec):
        c = codes[bt64].reshape(b, -1, codes.shape[2], codes.shape[3])
        if spec.packed:
            c = unpack_codes(c, spec.fmt, d)
        s = scales[bt64].reshape(b, -1, scales.shape[2], scales.shape[3])
        x = ref._dequant_cache_ref(c, s, spec)
        return x.transpose(1, 2).to(torch.bfloat16).contiguous()

    return one(kc, ks, kspec), one(vc, vs, vspec)


def check_decode_attention(torch, flush):
    """Contiguous MX decode attention at the static path's shapes (8 rows,
    S 640, 32 query heads over 2 KV heads, D 128)."""
    from repro_torch.core.spec import QuantSpec
    from repro_torch.kernels import ref
    from repro_torch.kernels.mx_decode_attn import mx_decode_attention
    from repro_torch.kernels.mx_quant import mx_quantize_2d
    gen = torch.Generator(device="cuda").manual_seed(7)
    b, s, hq, hkv, d = 8, 640, 32, 2, 128
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n_checked, row = 0, None
    for kv in ("int8@32:ocp/int8@32:ocp", "int8@32:ocp/e2m1@32:ocp",
               "e4m3@32:paper/e4m3@32:paper"):
        kspec, vspec = (QuantSpec.parse(x) for x in kv.split("/"))
        cache = []
        for spec in (kspec, vspec):           # one code per byte, any format
            x = torch.randn(b * s * hkv, d, generator=gen, device="cuda")
            c, sc = mx_quantize_2d(x, spec)
            cache += [c.reshape(b, s, hkv, d), sc.reshape(b, s, hkv, d // 32)]
        q32 = torch.randn(b, 1, hq, d, generator=gen, device="cuda")
        kw = dict(key_spec=kspec, value_spec=vspec, rep=hq // hkv)
        for pos in (0, 1, 63, 64, 300, 575, 639):
            lengths = torch.full((b,), pos, dtype=torch.int32, device="cuda")
            pos_d = lengths[:1].clone()           # pos in device memory
            for q in (q32, q32.to(torch.bfloat16),
                      (q32 * 8).to(torch.bfloat16)):
                got = mx_decode_attention(q, *cache, pos, **kw)
                _attn_check(torch, got, ref.mx_decode_attention_ref(
                    q, *cache, lengths, **kw), worst)
                if not torch.equal(mx_decode_attention(q, *cache, pos_d,
                                                       **kw), got):
                    raise AssertionError(
                        f"mx_decode_attention {kv} pos {pos} {q.dtype}: a "
                        f"device pos differs from the host int")
                n_checked += 2
        if vspec.fmt != "e2m1":
            continue
        # timing at the static path's types: bf16 q, INT8 K / E2M1 V;
        # pos 63 of S 640 too, where the grid sized from S walks 9 empty
        # splits of 10
        q = q32.to(torch.bfloat16)
        for pos in (63, 575):
            row = _time_decode_attention(torch, flush, q, cache, kw, kv,
                                         pos, s, mx_decode_attention, ref)
    emit("check", kernel="mx_decode_attention", compared=n_checked,
         max_abs_err_bf16=worst[torch.bfloat16],
         max_abs_err_f32=worst[torch.float32],
         criterion=f"f32 within {ATTN_TOL_F32}; bf16 within torch's bf16 "
                   f"defaults; a pos in device memory bit-identical to the "
                   f"host int")
    return dict(row, max_abs_err_f32=worst[torch.float32]), \
        worst[torch.bfloat16]


def _time_decode_attention(torch, flush, q, cache, kw, kv, pos, s,
                           mx_decode_attention, ref):
    """One timed row of the contiguous decode attention at ``pos``: the
    kernel by CUDA events and replayed from a graph (with pos on the
    device, as the static decode step runs it), plain, SDPA, bound."""
    b, _, hq, d = q.shape
    hkv = cache[0].shape[2]
    kspec, vspec = kw["key_spec"], kw["value_spec"]
    lengths = torch.full((b,), pos, dtype=torch.int32, device="cuda")
    pos_d = lengths[:1].clone()
    live = pos + 1
    nbytes = b * live * hkv * 2 * (d + d // 32) + 2 * q.numel() * 2
    tb, by = bound(nbytes, 4.0 * b * hq * live * d, BF16_FLOPS)
    # the library yardstick: SDPA over the dequantized cache
    kd, vd = (ref._dequant_cache_ref(c, sc, spec).transpose(1, 2)
              .to(torch.bfloat16).contiguous()
              for c, sc, spec in ((cache[0], cache[1], kspec),
                                  (cache[2], cache[3], vspec)))
    mask = (torch.arange(s, device="cuda") <= pos)[None, None, None, :]
    qt = q.transpose(1, 2)
    sdpa, best, sdpa_graph = sdpa_ms(torch, flush, qt, kd, vd,
                                     attn_mask=mask, enable_gqa=True)
    row = dict(kernel="mx_decode_attention",
               shape=f"8 rows, pos {pos} of S {s}, Hq 32, Hkv 2, D 128",
               spec=kv,
               ms=time_ms(torch, lambda: mx_decode_attention(
                   q, *cache, pos, **kw), flush=flush),
               graph_ms=graph_ms(torch, lambda: mx_decode_attention(
                   q, *cache, pos_d, **kw), flush=flush),
               library_graph_ms=sdpa_graph,
               plain_ms=time_ms(torch, lambda: ref
                                .mx_decode_attention_ref(
                                    q, *cache, lengths, **kw),
                                flush=flush),
               library_ms=sdpa[best], library_backend=best,
               sdpa_ms=sdpa, bound_ms=tb, bound_by=by, live_tokens=live)
    emit("time", **row)
    return row


def check_flash(torch, flush):
    """Flash attention at the static fp-KV prefill's shapes (8 prompts of
    512, 32 heads over 2 KV heads, D 128), ragged lengths and a causal
    Sq != Sk case (top-left alignment), in f32 (CUDA-core kernel) and bf16
    (tensor-core kernel, the main path's); bf16 also at D 32 and 64, and
    with scores scaled x8 (a peaked softmax: the online rescale with P in
    bf16); both at D 48 and 16, which the wrapper zero-pads to 64 and 32.  Times bf16 and f32 at the serving shape, and bf16 with 32 KV
    heads (no K/V tile shared between heads) beside the serving 2."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attn import flash_attention
    gen = torch.Generator(device="cuda").manual_seed(8)
    h, hkv = 32, 2
    both = (torch.float32, torch.bfloat16)
    worst = {dt: 0.0 for dt in both}
    tols = {torch.float32: ATTN_TOL_F32, torch.bfloat16: FLASH_TOL_BF16}
    n_checked, errors = 0, []
    # (b, sq, sk, causal, d, scale of q, dtypes)
    cases = [(8, 512, 512, True, 128, 1.0, both),
             (8, 512, 512, False, 128, 1.0, both),
             (8, 77, 77, True, 128, 1.0, both),
             (8, 300, 300, True, 128, 1.0, both),
             (2, 256, 1024, True, 128, 1.0, both),
             (8, 512, 512, True, 32, 1.0, (torch.bfloat16,)),
             (8, 512, 512, True, 64, 1.0, (torch.bfloat16,)),
             (8, 512, 512, True, 128, 8.0, (torch.bfloat16,)),
             (8, 512, 512, True, 48, 1.0, both),       # zero-padded to 64
             (2, 77, 77, True, 16, 1.0, both)]         # zero-padded to 32
    for b, sq, sk, causal, d, qscale, dtypes in cases:
        qkv = [torch.randn(b, n, nh, d, generator=gen, device="cuda")
               for n, nh in ((sq, h), (sk, hkv), (sk, hkv))]
        qkv[0] *= qscale
        for dt in dtypes:
            args = [t.to(dt) for t in qkv]
            got = flash_attention(*args, causal=causal)
            want = ref.flash_attention_ref(*args, causal)
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=tols[dt], atol=tols[dt])
            err = float((got.float() - want.float()).abs().max())
            worst[dt] = max(worst[dt], err)
            errors.append(dict(case=f"{b}x{sq}/{sk} causal={causal} D {d} "
                                    f"q x{qscale:g}",
                               dtype=str(dt).replace("torch.", ""),
                               max_abs_err=err,
                               max_abs_want=float(want.float().abs().max())))
            n_checked += 1
    b, s, d = 8, 512, 128
    pairs = b * h * s * (s + 1) / 2            # causal (query, key) pairs
    rows = {}
    for dt, nkv, rate in ((torch.bfloat16, hkv, BF16_FLOPS),
                          (torch.float32, hkv, F32_CUDA_CORE_FLOPS),
                          (torch.bfloat16, h, BF16_FLOPS)):
        q, k, v = (torch.randn(b, s, nh, d, generator=gen, device="cuda")
                   .to(dt) for nh in (h, nkv, nkv))
        nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
        tb, by = bound(nbytes, 4.0 * pairs * d, rate)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        spec = str(dt).replace("torch.", "")
        row = dict(kernel="flash_attention",
                   shape=f"8 x 512 tokens, causal, H 32, Hkv {nkv}, D 128",
                   spec=spec, max_abs_err=worst[dt],
                   ms=time_ms(torch, lambda: flash_attention(q, k, v),
                              flush=flush),
                   plain_ms=time_ms(torch, lambda: ref.flash_attention_ref(
                       q, k, v, True), flush=flush),
                   library_ms=time_ms(torch, lambda: F
                                      .scaled_dot_product_attention(
                                          qt, kt, vt, is_causal=True,
                                          enable_gqa=True), flush=flush),
                   bound_ms=tb, bound_by=by)
        emit("time", **row)
        rows[(spec, nkv)] = row
    emit("check", kernel="flash_attention", compared=n_checked,
         max_abs_err_bf16=worst[torch.bfloat16],
         max_abs_err_f32=worst[torch.float32], cases=errors,
         criterion=f"|kernel - plain| <= tol + tol * |plain|, tol "
                   f"{ATTN_TOL_F32} (f32) / {FLASH_TOL_BF16} (bf16)")
    row = dict(rows[("bfloat16", hkv)],
               max_abs_err_f32=worst[torch.float32])
    return row, worst[torch.bfloat16]


def check_lm_head(torch, flush):
    """The LM head of a decode step (8 rows x 4096 @ 4096 x 65024, bf16),
    a plain torch product (the reference computes it outside any Pallas
    kernel): the bf16-input, f32-output GEMM the port runs on the card
    (``decoder._head``) against both sides widened to f32 (what it ran
    before: a 1.07 GB f32 copy of the head on every call).  Exact
    products, so the two differ in summation order only."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn(8, 4096, generator=gen, device="cuda").to(torch.bfloat16)
    head = (torch.randn(4096, 65024, generator=gen, device="cuda")
            / 64).to(torch.bfloat16)
    got = torch.mm(x, head, out_dtype=torch.float32)
    want = torch.matmul(x.to(torch.float32), head.to(torch.float32))
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not err <= MATMUL_TOL * scale:
        raise AssertionError(f"bf16 -> f32 LM head differs by {err} "
                             f"(max |logit| {scale})")
    nbytes = head.numel() * 2 + x.numel() * 2 + got.numel() * 4
    tb, by = bound(nbytes, 2.0 * 8 * 4096 * 65024, BF16_FLOPS)
    emit("time", kernel="lm_head (torch, not a port kernel)",
         shape="8 x 4096 @ 4096 x 65024, bf16 in, f32 out",
         max_abs_err=err, max_abs=scale,
         ms=time_ms(torch, lambda: torch.mm(x, head,
                                            out_dtype=torch.float32),
                    flush=flush),
         graph_ms=graph_ms(torch, lambda: torch.mm(
             x, head, out_dtype=torch.float32), flush=flush),
         f32_cast_ms=time_ms(torch, lambda: torch.matmul(
             x.to(torch.float32), head.to(torch.float32)), flush=flush),
         bound_ms=tb, bound_by=by, head_bytes=head.numel() * 2,
         f32_copy_bytes=head.numel() * 4)
    del head


# =============================================================================
# phase 3: full-width serving
# =============================================================================
def _counters():
    """Kernel name -> the wrappers that launch it (the KV write has one
    wrapper per destination)."""
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.kernels.mx_decode_attn import (mx_decode_attention,
                                                    mx_paged_decode_attention)
    from repro_torch.kernels.mx_kv_write import (mx_cache_kv_write,
                                                 mx_paged_kv_write,
                                                 mx_paged_kv_write_tokens)
    from repro_torch.kernels.mx_matmul import mx_matmul_2d
    from repro_torch.kernels.mx_quant import mx_quantize_2d
    return {"mx_quantize_2d": (mx_quantize_2d,),
            "mx_kv_write": (mx_paged_kv_write, mx_paged_kv_write_tokens,
                            mx_cache_kv_write),
            "mx_matmul_2d": (mx_matmul_2d,),
            "mx_paged_decode_attention": (mx_paged_decode_attention,),
            "mx_decode_attention": (mx_decode_attention,),
            "flash_attention": (flash_attention,)}


def _drive(torch, fn):
    """Run ``fn`` as a main path: every launch count set to 0 just before,
    read just after.  Returns (fn's result, launches, wall seconds)."""
    counters = _counters()
    for fns in counters.values():
        for c in fns:
            c.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, {name: sum(c.launches for c in fns)
                 for name, fns in counters.items()}, wall


# the kernels each wrapper launches, as the profiler names them
# (template arguments and all), by family: a replay's device kernels of
# a family must number the launches credited to the family's wrappers
KERNEL_FAMILIES = {
    "matmul": (("mx_matmul_2d",), ("mx_matmul_tc_decode_kernel",
                                   "mx_matmul_tc_prefill_kernel",
                                   "mx_matmul_skinny_kernel",
                                   "mx_matmul_tiled_kernel")),
    "kv_write": (("mx_paged_kv_write", "mx_paged_kv_write_tokens",
                  "mx_cache_kv_write"),
                 ("mx_kv_write_kernel",)),
    "decode_attention": (("mx_paged_decode_attention",
                          "mx_decode_attention"),
                         ("mx_decode_attn_tc_kernel",
                          "paged_attn_split_kernel",
                          "decode_attn_split_kernel")),
    "flash": (("flash_attention",), ("flash_tc_kernel", "flash_fwd_kernel")),
    "converter": (("mx_quantize_2d",), ("mx_quant_kernel",
                                        "mx_quant_vec_kernel")),
}


def check_replay(torch, path, step, want, replay=None):
    """The launches one replay of a captured step credits
    (``CapturedStep.launches``) are ``want`` per wrapper, and
    ``torch.profiler`` over one replay (``replay``, by default ``step``
    itself) sees the device run exactly that many kernels of each
    family."""
    credited = {w.__name__: n for w, n in step.launches.items()}
    if credited != want:
        raise AssertionError(f"{path}: one replay credits {credited}, "
                             f"expected {want}")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        (replay or step)()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    seen, expect = {}, {}
    for fam, (wrappers, kernels) in KERNEL_FAMILIES.items():
        seen[fam] = sum(any(k in n for k in kernels) for n in names)
        expect[fam] = sum(credited.get(w, 0) for w in wrappers)
    if seen != expect:
        raise AssertionError(f"{path}: the profiler saw {seen} kernels in "
                             f"one replay, the wrappers credit {expect}")
    emit("replay_check", path=path, launches_per_replay=credited,
         profiled_kernels=seen, device_kernels=len(names))


def _check_launches(path, launches, want):
    """Each kernel launched exactly as often as the path implies; every
    kernel the path runs at least once."""
    for name, n in launches.items():
        if n != want.get(name, 0):
            raise AssertionError(f"{path}: {name} launched {n} times, "
                                 f"expected {want.get(name, 0)}")


def _flips(torch, model, params, prompts, got, want, tol=LOGITS_TOL):
    """Token streams ``got`` against ``want`` per prompt: a stream may
    differ only from a step where the logits that chose the token have a
    top-2 gap below ``tol`` (traced through ``model`` on ``want``'s
    context); returns those steps, raises on any other difference."""
    import numpy as np
    vocab = model.cfg.vocab
    flips = []
    for prompt, a, b in zip(prompts, got, want):
        a, b = list(a), list(b)
        if a == b:
            continue
        i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        ctx = np.concatenate([prompt, np.asarray(b[:i], np.int32)])
        lg, _, _ = model.prefill(params, torch.from_numpy(ctx[None]).to(
            model.device), max_len=len(ctx))
        top2 = torch.topk(lg[0, -1, :vocab], 2).values
        gap = float(top2[0] - top2[1])
        if gap >= tol:
            raise AssertionError(f"tokens differ at step {i} with a top-2 "
                                 f"logit gap of {gap}")
        flips.append({"step": i, "top2_gap": gap})
    return flips


def _serve(eng, prompts, new_tokens):
    rids = [eng.add_request(p, new_tokens) for p in prompts]
    out = eng.run()
    return [out[r] for r in rids]


def serve_full_width(torch):
    import numpy as np
    from repro_torch.launch.serve import build_model
    from repro_torch.serve import ContinuousBatchingEngine, GenerationConfig
    (model, params), load, load_s = _drive(torch, lambda: build_model(
        "chatglm3_6b", reduced=False, quant=POLICY, weight_resident=True,
        device="cuda", seed=0, attn_impl="flash"))
    cfg = model.cfg
    n_l = cfg.n_layers
    _check_launches("model load", load, {"mx_quantize_2d": 7 * n_l})
    emit("serve_setup", config=cfg.name, layers=cfg.n_layers,
         d_model=cfg.d_model, d_ff=cfg.d_ff, vocab=cfg.vocab,
         policy=str(cfg.mx), build_s=load_s, launches=load,
         device_mem_gib=torch.cuda.memory_allocated() / 2 ** 30)
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 513, size=16)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
               for n in lens]
    new = 64
    t0 = time.perf_counter()
    eng = ContinuousBatchingEngine(       # captures the decode step
        model, params, max_slots=8, page_size=16,
        max_len=int(lens.max()) + new + 1, sync_every=8, prefill_bucket=64)
    capture_s = time.perf_counter() - t0
    outs, launches, wall = _drive(torch, lambda: _serve(eng, prompts, new))
    ph = eng.phase
    steps, batches = eng.n_steps, eng.n_prefill_batches
    decode_tokens = eng.n_generated - len(prompts)
    emit("serve", requests=len(prompts), prompt_lens=[int(n) for n in lens],
         new_tokens=new, wall_s=wall, prefill_s=ph["prefill"],
         decode_s=ph["decode"], host_sync_s=ph["sync"],
         tokens=eng.n_generated,
         tokens_per_s=eng.n_generated / wall,
         decode_tokens_per_s=decode_tokens / ph["decode"],
         decode_steps=steps, windows=eng.n_syncs, prefill_batches=batches,
         graph_capture_s=capture_s, quarantined=eng.n_quarantined,
         kv_pool_nbytes=eng.kv_pool_nbytes,
         weight_pool_nbytes=eng.weight_pool_nbytes, launches=launches,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    # every decode step is one replay: the launches of its captured step
    # once per step, plus the eager prefill batches
    _check_launches("continuous serving", launches, {
        "mx_matmul_2d": 7 * n_l * (steps + batches),
        "mx_kv_write": n_l * (steps + batches),
        "mx_paged_decode_attention": n_l * steps})
    if eng.n_quarantined or eng.scheduler.failed:
        raise AssertionError("continuous serving quarantined a healthy "
                             "request")
    for p, o in zip(prompts, outs):
        if len(o) != new or o.min() < 0 or o.max() >= cfg.vocab:
            raise AssertionError(f"bad output for a {len(p)}-token prompt")
    # first-prefill logits of one prompt are finite and of the full vocab
    logits, _, _ = model.prefill(params, torch.from_numpy(
        prompts[0][None]).cuda(), max_len=len(prompts[0]))
    if logits.shape[-1] < cfg.vocab or not bool(torch.isfinite(
            logits).all()):
        raise AssertionError("non-finite or short prefill logits")
    del logits, eng
    # sync_every must not change the tokens (all 8 admitted at once),
    # greedy or sampled: a slot's keys advance with its own steps only
    short = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
             for n in rng.integers(64, 257, size=8)]
    for temperature in (0.0, 0.8):
        toks = []
        for se in (1, 8):
            e = ContinuousBatchingEngine(
                model, params, max_slots=8, page_size=16, max_len=256 + 17,
                sync_every=se, prefill_bucket=64,
                gen=GenerationConfig(temperature=temperature, seed=3))
            toks.append([o.tolist() for o in _serve(e, short, 16)])
            del e
        if toks[0] != toks[1]:
            raise AssertionError(f"sync_every=1 and sync_every=8 disagree "
                                 f"at temperature {temperature}")
        emit("sync_check", requests=8, new_tokens=16,
             temperature=temperature, identical=True)
    for temperature in (0.0, 0.8):
        check_graph_window(torch, model, params, short, temperature)
    check_quarantine(torch, model, params, short[:2])
    tokens_launches = serve_prefix(torch, model, params)
    serve_slo(torch, model, params)
    drill = serve_faults(torch, model, params)
    static = serve_static(torch, model, params)
    del params, model
    torch.cuda.empty_cache()
    # the kernels line counts the continuous run's and the fault drill's
    # launches (each a main path of its own, driven from 0)
    launches = {k: n + drill.get(k, 0) for k, n in launches.items()}
    return {**launches, **static,
            "mx_quantize_2d": load["mx_quantize_2d"],
            "mx_kv_write_tokens": tokens_launches}


def check_graph_window(torch, model, params, prompts, temperature):
    """One decode window of the continuous engine (8 replays of its
    captured step) against ``paged_decode_multi_step`` run eagerly from
    the same state: identical tokens, lengths, budgets, keys and flags,
    and byte-identical pools (page 0, the trash page, left out: the
    capture's warm-up step writes it).  Then the launches one replay
    credits, confirmed by the profiler."""
    from repro_torch.serve import ContinuousBatchingEngine, GenerationConfig
    from repro_torch.serve.paging import TRASH_PAGE
    n_l = model.cfg.n_layers
    eng = ContinuousBatchingEngine(
        model, params, max_slots=8, page_size=16, max_len=256 + 33,
        sync_every=8, prefill_bucket=64,
        gen=GenerationConfig(temperature=temperature, seed=7))
    for p in prompts:
        eng.add_request(p, 32)
    eng.step()                          # admission, prefill, first window
    window = eng.scheduler.plan_window(eng._lengths, eng.sync_every)
    eng._upload_tables()
    w = eng.window
    state = [torch.from_numpy(a.copy()).cuda()
             for a in (eng._cur_tok, eng._lengths, eng._remaining)]
    pool = {k: v.clone() for k, v in eng.pool.items()}
    t0 = time.perf_counter()
    toks, pool, lengths, remaining, keys, bad = \
        model.paged_decode_multi_step(
            params, state[0], pool, w.block_tables.clone(), state[1],
            state[2], w.keys.clone(), n_steps=window,
            temperature=temperature, trash_page=TRASH_PAGE, health=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    eng.step()                          # the same window, replayed
    t2 = time.perf_counter()
    same = {"tokens": torch.equal(w.tokens[:window], toks),
            "lengths": torch.equal(w.state[1], lengths),
            "remaining": torch.equal(w.state[2], remaining),
            "keys": torch.equal(w.keys, keys),
            "flags": torch.equal(w.bad, bad),
            "pool": all(torch.equal(eng.pool[k][:, 1:], pool[k][:, 1:])
                        for k in pool)}
    if not all(same.values()):
        raise AssertionError(f"graph and eager windows differ at "
                             f"temperature {temperature}: {same}")
    emit("graph_vs_eager", path="continuous", temperature=temperature,
         steps=window, eager_s=t1 - t0, graph_step_s=t2 - t1, **same)
    if temperature == 0.0:
        # a window of one step: run() resets the step's token index
        check_replay(torch, "continuous decode step", w.step, {
            "mx_matmul_2d": 7 * n_l, "mx_paged_kv_write": n_l,
            "mx_paged_decode_attention": n_l}, replay=lambda: w.run(1))


def check_quarantine(torch, model, params, prompts):
    """Full width, health checks on: a prompt holding a token whose
    embedding row is NaN is quarantined at admission with a diagnostic,
    and its neighbour gets the tokens it gets served alone."""
    import numpy as np
    from repro_torch.serve import ContinuousBatchingEngine
    bad_tok = 7
    poisoned_params = dict(params, embed=params["embed"].clone())
    poisoned_params["embed"][bad_tok] = float("nan")
    healthy = prompts[0][prompts[0] != bad_tok]
    poisoned = prompts[1].copy()
    poisoned[len(poisoned) // 2] = bad_tok

    def engine():
        return ContinuousBatchingEngine(model, poisoned_params, max_slots=8,
                                        page_size=16, max_len=256 + 17,
                                        sync_every=8, prefill_bucket=64)

    solo = engine()
    rid = solo.add_request(healthy, 16)
    want = solo.run()[rid]
    del solo
    eng = engine()
    rh, rp = eng.add_request(healthy, 16), eng.add_request(poisoned, 16)
    out = eng.run()
    failed = {r.rid: r.error for r in eng.scheduler.failed}
    if set(failed) != {rp} or "health guard" not in failed[rp] \
            or eng.n_quarantined != 1 or rp in out:
        raise AssertionError(f"the poisoned request was not quarantined: "
                             f"failed {failed}")
    if not np.array_equal(out[rh], want):
        raise AssertionError("the poisoned request's neighbour lost its "
                             "solo tokens")
    emit("quarantine", requests=2, quarantined=[rp], error=failed[rp],
         neighbour_tokens_identical=True, tokens=out[rh].tolist())
    del eng, poisoned_params
    torch.cuda.empty_cache()


PREFIX_LEN = 256       # the prefix phase's shared system prompt: 16 pages


def _prefix_traffic(vocab):
    """16 prompts: the shared system prompt and a seeded tail of 16-256
    tokens (the fourth 64 long, so its prompt is page-aligned)."""
    import numpy as np
    rng = np.random.default_rng(11)
    system = rng.integers(0, vocab, size=PREFIX_LEN).astype(np.int32)
    tails = rng.integers(16, 257, size=16)
    tails[3] = 64
    prompts = [np.concatenate([system, rng.integers(0, vocab, size=int(t))
                               .astype(np.int32)]) for t in tails]
    return prompts, rng.integers(0, vocab, size=24).astype(np.int32)


def _serve_prefix_run(torch, model, params, prefix_cache, temperature,
                      record, num_pages=None):
    """One serving run of the prefix phase: the 16 prompts, then (once
    they finished) a repeat of the page-aligned prompt (fully cached on
    the prefix path: a copy-on-write fork) and a prompt extending the
    shortest first-wave request's prompt and output (cached through the
    pages its release published).  The pool is the engine's default
    (full occupancy) unless ``num_pages`` is given.  Returns (tokens per
    request, engine, launches, wall s, {rid: (prefill start, prompt K/V
    bytes as the prefill left them)} when ``record``, {"reclaimed":
    pages the trie's reclaim freed, "backouts": admissions whose
    tentative prefix mapping was undone})."""
    import numpy as np
    from repro_torch.serve import ContinuousBatchingEngine, GenerationConfig
    new = 32
    prompts, ext_tail = _prefix_traffic(model.cfg.vocab)
    first_wave = min(range(8), key=lambda i: len(prompts[i]))
    max_len = len(prompts[first_wave]) + new + len(ext_tail) + new + 1
    max_len = max(max_len, max(len(p) for p in prompts) + new + 1)
    recorded = {}

    class Recorder(ContinuousBatchingEngine):
        """Keeps each request's prompt K/V bytes as its prefill left
        them, for the byte comparison of the two runs; read after the
        engine's timed prefill phase returns, before the first decode
        window writes."""

        def _batched_prefill(self, admitted, emitted):
            super()._batched_prefill(admitted, emitted)
            for r in admitted:
                if self.scheduler.running.get(r.slot) is not r:
                    continue
                ids = torch.tensor(self.blocks.slot_page_ids(r.slot),
                                   device=self.device)
                recorded[r.rid] = (r.prefill_start, {
                    n: t[:, ids].reshape((t.shape[0], -1) + t.shape[3:])
                    [:, :r.prompt_len] for n, t in self.pool.items()})

    cls = Recorder if record else ContinuousBatchingEngine
    eng = cls(model, params, max_slots=8, page_size=16, max_len=max_len,
              num_pages=num_pages, sync_every=8, prefill_bucket=64,
              prefix_cache=prefix_cache,
              gen=GenerationConfig(temperature=temperature, seed=5))
    pressure = {"reclaimed": 0, "backouts": 0}
    if prefix_cache:
        # count what admission under pool pressure does: the trie's
        # reclaim and the undoing of a tentative mapping (a release of a
        # slot with pages inside admit)
        reclaim, release, admit = (eng.prefix.reclaim, eng.blocks.release,
                                   eng.scheduler.admit)
        in_admit = [False]

        def counted_reclaim(n):
            freed = reclaim(n)
            pressure["reclaimed"] += freed
            return freed

        def counted_release(slot):
            if in_admit[0] and eng.blocks.slot_pages(slot):
                pressure["backouts"] += 1
            return release(slot)

        def counted_admit():
            in_admit[0] = True
            try:
                return admit()
            finally:
                in_admit[0] = False

        eng.prefix.reclaim = counted_reclaim
        eng.blocks.release = counted_release
        eng.scheduler.admit = counted_admit

    def serve():
        out = _serve(eng, prompts, new)
        ext = np.concatenate([prompts[first_wave], out[first_wave],
                              ext_tail])
        return out + _serve(eng, [prompts[3].copy(), ext], new)

    outs, launches, wall = _drive(torch, serve)
    return ([o.tolist() for o in outs], eng, launches, wall, recorded,
            pressure)


def _equal_share(on, off, suffix):
    """Share of equal K/V bytes between the two runs' pages at the hits'
    suffix positions (``suffix``) or at their cached prefix positions."""
    same = total = 0
    for rid, (start, pages) in on.items():
        if start == 0:
            continue
        for n, t in pages.items():
            a, b = t, off[rid][1][n]
            if suffix:
                a, b = a[:, start:], b[:, start:]
            else:
                a, b = a[:, :start], b[:, :start]
            same += int((a == b).sum())
            total += a.numel()
    return same / total if total else None


def serve_prefix(torch, model, params):
    """Prefix caching at full width (the model of phase 3, MX weights,
    INT8 / E2M1 KV pages of 16, 8 slots, bucket 64, sync_every 8, the
    engine's default pool): the traffic of ``_serve_prefix_run`` with the
    cache off and on, greedy and at temperature 0.8, then once more
    greedy with the cache on over half that pool (4 slots' worth of
    pages), where admission must reclaim trie pages and back a tentative
    mapping out; each run a main path of its own.  Raises unless the
    tokens of every on-run are those of the off-run at its temperature,
    the default-pool on-run has at least 8 hits, at least one
    copy-on-write fork, and computes at least 8 x 256 fewer prefill
    tokens, the half-pool run has at least 8 hits, reclaims pages and
    backs out at least once, and every run launches its kernels as often
    as its steps and prefill batches imply (the hits' suffix prefill
    through the multi-token KV write, once per layer per hit batch).
    Reports prefill seconds, decode tokens/s, hit rate, effective pool
    bytes and launches per run, and the share of equal K/V bytes between
    the pages the hits' suffix prefill wrote and the off-run's pages at
    the same positions (a measurement, not a gate).  Returns the
    multi-token write's launches in the greedy default-pool on-run."""
    from repro_torch.kernels.mx_kv_write import mx_paged_kv_write_tokens
    n_l = model.cfg.n_layers

    def run(pc, temperature, record=False, num_pages=None):
        toks, eng, launches, wall, rec, pressure = _serve_prefix_run(
            torch, model, params, pc, temperature, record, num_pages)
        steps, batches = eng.n_steps, eng.n_prefill_batches
        hit_batches = eng.n_hit_batches
        tok_launches = mx_paged_kv_write_tokens.launches
        path = (f"prefix cache {'on' if pc else 'off'}, T {temperature}, "
                f"{eng.blocks.num_pages} pages")
        _check_launches(path, launches, {
            "mx_matmul_2d": 7 * n_l * (steps + batches),
            "mx_kv_write": n_l * (steps + batches),
            "mx_paged_decode_attention": n_l * steps})
        if tok_launches != n_l * hit_batches:
            raise AssertionError(f"{path}: the multi-token KV write "
                                 f"launched {tok_launches} times, "
                                 f"expected {n_l * hit_batches}")
        if eng.n_quarantined:
            raise AssertionError(f"{path}: a healthy request was "
                                 f"quarantined")
        ph = eng.phase
        px = eng.prefix
        emit("prefix", prefix_cache=pc, temperature=temperature,
             num_pages=eng.blocks.num_pages, requests=len(toks),
             new_tokens=32, wall_s=wall, prefill_s=ph["prefill"],
             decode_s=ph["decode"],
             decode_tokens_per_s=(eng.n_generated - len(toks))
             / ph["decode"],
             prefill_tokens_computed=eng.prefill_tokens_computed,
             prefill_batches=batches, hit_batches=hit_batches,
             decode_steps=steps, hits=px.hits if px else 0,
             lookups=px.lookups if px else 0,
             hit_rate=eng.prefix_hit_rate, cow_forks=eng.n_cow_forks,
             reclaimed_pages=pressure["reclaimed"],
             backouts=pressure["backouts"],
             peak_shared_pages=eng.peak_shared_pages,
             kv_pool_bytes_effective=eng.kv_pool_bytes_effective,
             kv_pool_nbytes=eng.kv_pool_nbytes, launches=launches,
             multi_token_kv_write_launches=tok_launches)
        return toks, eng, rec, pressure, tok_launches

    def same(on, off, what):
        if on != off:
            bad = [i for i, (a, b) in enumerate(zip(on, off)) if a != b]
            raise AssertionError(f"{what} gives other tokens than the "
                                 f"cache off: requests {bad}")

    tokens_launches = greedy_off = None
    for temperature in (0.0, 0.8):
        record = temperature == 0.0
        off, eng_off, rec_off, _, _ = run(False, temperature, record)
        on, eng_on, rec_on, _, launched = run(True, temperature, record)
        same(on, off, f"prefix cache on at temperature {temperature}")
        saved = eng_off.prefill_tokens_computed \
            - eng_on.prefill_tokens_computed
        if eng_on.prefix.hits < 8 or eng_on.n_cow_forks < 1 \
                or saved < 8 * PREFIX_LEN:
            raise AssertionError(
                f"prefix cache at temperature {temperature}: "
                f"{eng_on.prefix.hits} hits, {eng_on.n_cow_forks} forks, "
                f"{saved} prefill tokens saved")
        row = dict(temperature=temperature, num_pages=eng_on.blocks
                   .num_pages, identical=True, hits=eng_on.prefix.hits,
                   cow_forks=eng_on.n_cow_forks,
                   prefill_tokens_saved=saved)
        if record:
            tokens_launches, greedy_off = launched, off
            off_prefill = eng_off.prefill_tokens_computed
            half = 1 + 4 * eng_on.max_pages_per_slot
            row["suffix_bytes_equal_share"] = _equal_share(
                rec_on, rec_off, suffix=True)
            row["prefix_bytes_equal_share"] = _equal_share(
                rec_on, rec_off, suffix=False)
        emit("prefix_check", **row)
        del eng_off, eng_on, rec_off, rec_on
        torch.cuda.empty_cache()
    on, eng, _, pressure, _ = run(True, 0.0, num_pages=half)
    same(on, greedy_off, f"prefix cache on over {half} pages")
    if eng.prefix.hits < 8 or pressure["reclaimed"] < 1 \
            or pressure["backouts"] < 1:
        raise AssertionError(
            f"prefix cache over {half} pages: {eng.prefix.hits} hits, "
            f"{pressure['reclaimed']} pages reclaimed, "
            f"{pressure['backouts']} back-outs")
    emit("prefix_check", temperature=0.0, num_pages=half, identical=True,
         hits=eng.prefix.hits, cow_forks=eng.n_cow_forks,
         reclaimed_pages=pressure["reclaimed"],
         backouts=pressure["backouts"],
         prefill_tokens_saved=off_prefill - eng.prefill_tokens_computed)
    del eng
    torch.cuda.empty_cache()
    return tokens_launches


# the slo phase's two-class mix: (priority, prompt lengths, new tokens)
SLO_BATCH = (1, (384, 513), 128)
SLO_INTERACTIVE = (0, (64, 257), 32)
SLO_DEADLINE_S = 0.5   # the interactive class's TTFT target
SLO_MAX_LEN = SLO_BATCH[1][1] - 1 + SLO_BATCH[2]
SLO_REQUEST_PAGES = -(-SLO_MAX_LEN // 16)   # a slot's pages of 16


def _slo_prompts(vocab, cls, n, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    lo, hi = cls[1]
    return [rng.integers(1, vocab, size=int(m)).astype(np.int32)
            for m in rng.integers(lo, hi, size=n)]


def _slo_engine(torch, model, params, num_pages, temperature, saved):
    """The slo phase's engine (8 slots, pages of 16, bucket 64, preempt on):
    ``saved`` (a dict) makes it keep a clone of each swap-out's host copy
    and hold every restored slot's pages, just after the restore, byte
    for byte against it."""
    from repro_torch.serve import ContinuousBatchingEngine, GenerationConfig

    class Checked(ContinuousBatchingEngine):
        def _swap_out(self, req):
            super()._swap_out(req)
            saved[req.rid] = {k: v.clone() for k, v in
                              self.swap_store._entries[req.rid].pages.items()}

        def _restore_swapped(self, reqs):
            super()._restore_swapped(reqs)
            for r in reqs:
                ids = torch.tensor(self.blocks.slot_page_ids(r.slot),
                                   device=self.device)
                host = saved.pop(r.rid)
                for k, leaf in self.pool.items():
                    if not torch.equal(leaf.index_select(1, ids).cpu(),
                                       host[k]):
                        raise AssertionError(
                            f"request {r.rid}: restored {k} pages differ "
                            f"from the copy taken at swap-out")
                saved["checked"] = saved.get("checked", 0) + 1

    cls = Checked if saved is not None else ContinuousBatchingEngine
    return cls(model, params, max_slots=8, page_size=16,
               max_len=SLO_MAX_LEN, num_pages=num_pages, sync_every=8,
               prefill_bucket=64,
               preempt=True,
               gen=GenerationConfig(temperature=temperature, seed=9))


def _slo_script(eng, batch, interactive):
    """Batch-class requests decode until each admitted one has 16 tokens;
    then the interactive ones arrive.  Returns {rid: tokens}."""
    pb, _, nb = SLO_BATCH
    pi, _, ni = SLO_INTERACTIVE
    rids = [eng.add_request(p, nb, priority=pb) for p in batch]
    reqs = [r for r in eng.scheduler.waiting if r.rid in rids]
    eng.step()
    while min(len(r.out) for r in reqs if r.t_admitted is not None) < 16:
        eng.step()
    rids += [eng.add_request(p, ni, priority=pi, deadline_s=SLO_DEADLINE_S)
             for p in interactive]
    out = eng.run()
    return {r: out[r].tolist() for r in rids}


def _swap_row(eng):
    sw = eng.swap_store
    moved = sw.bytes_out + sw.bytes_in
    swap_s = eng.phase["swap"]
    return dict(preemptions=eng.n_preemptions, restores=eng.n_restores,
                swap_bytes_out=sw.bytes_out, swap_bytes_in=sw.bytes_in,
                swap_mb=moved / 1e6, swap_s=swap_s,
                swap_gb_per_s=moved / swap_s / 1e9 if swap_s else None,
                swap_bytes_per_preemption=(sw.bytes_out / eng.n_preemptions
                                           if eng.n_preemptions else None),
                peak_resident_bytes=sw.peak_resident_bytes)


def _slo_launches_ok(path, eng, launches):
    """The path's kernels launched as its steps and prefill batches imply
    (restores prefill nothing), and no healthy request quarantined."""
    n_l = eng.model.cfg.n_layers
    steps, batches = eng.n_steps, eng.n_prefill_batches
    _check_launches(path, launches, {
        "mx_matmul_2d": 7 * n_l * (steps + batches),
        "mx_kv_write": n_l * (steps + batches),
        "mx_paged_decode_attention": n_l * steps})
    if eng.n_quarantined:
        raise AssertionError(f"{path}: a healthy request was quarantined")


def _class_latency(fin):
    from repro_torch.serve import latency_summary
    out = {}
    for name, prio in (("interactive", SLO_INTERACTIVE[0]),
                       ("batch", SLO_BATCH[0])):
        summ = latency_summary([r for r in fin if r.priority == prio])
        out[name] = {k: summ.get(k) for k in (
            "n_requests", "ttft_p50_ms", "ttft_p99_ms", "itl_p50_ms",
            "itl_p99_ms", "slo_attainment")}
    return out


def serve_slo(torch, model, params):
    """SLO-class serving at full width (the model of phase 3, MX weights,
    INT8 / E2M1 KV pages of 16, 8 slots, bucket 64, sync_every 8):

    (a) 5 batch-class requests (priority 1, prompts of 384-512 tokens,
        128 new) decode; 3 interactive ones (priority 0, prompts of
        64-256, 32 new, TTFT target 0.5 s) arrive mid-generation.  Over
        half the engine's default pool a batch request must be swapped
        out (its packed pages to pinned host memory) and restored; over
        the full pool none is.  Greedy and at T 0.8, each run a main path
        of its own: the tokens must be identical per rid, preemptions >= 1
        with as many restores, bytes in = bytes out, the swap store empty
        at the end, and every restored slot's pages byte-equal to the copy
        taken at swap-out.
    (b) Snapshot at T 0.8, graphs on: capture mid-stream, run to the end,
        restore, run again: the same tokens.
    (c) ``AsyncServer`` (steps in an executor thread) under two on/off
        streams of the two-class mix (``_slo_arrivals``) over three batch
        requests' worth of pages: ``reject``, ``block`` and ``block`` +
        preempt.  Reports served and rejected counts, TTFT p50/p99 per
        class, SLO attainment, preemptions, swap MB, swap-phase seconds
        and the GB/s they imply.
    """
    vocab = model.cfg.vocab
    batch = _slo_prompts(vocab, SLO_BATCH, 5, 21)
    interactive = _slo_prompts(vocab, SLO_INTERACTIVE, 3, 22)
    full = 1 + 8 * SLO_REQUEST_PAGES    # the engine's default pool
    half = (full + 1) // 2

    for temperature in (0.0, 0.8):
        runs = {}
        for pages in (half, full):
            saved = {}
            eng = _slo_engine(torch, model, params, pages, temperature,
                              saved)
            toks, launches, wall = _drive(
                torch, lambda: _slo_script(eng, batch, interactive))
            path = f"slo script, T {temperature}, {pages} pages"
            _slo_launches_ok(path, eng, launches)
            sw = eng.swap_store
            if pages == half and (
                    eng.n_preemptions < 1
                    or eng.n_restores != eng.n_preemptions
                    or saved.get("checked", 0) != eng.n_restores):
                raise AssertionError(f"{path}: {eng.n_preemptions} "
                                     f"preemptions, {eng.n_restores} "
                                     f"restores, {saved.get('checked', 0)} "
                                     f"restores checked")
            if pages == full and eng.n_preemptions:
                raise AssertionError(f"{path}: preempted over the full "
                                     f"pool")
            if sw.bytes_in != sw.bytes_out or len(sw):
                raise AssertionError(f"{path}: swap bytes in "
                                     f"{sw.bytes_in} / out {sw.bytes_out}, "
                                     f"{len(sw)} left in the store")
            ph = eng.phase
            emit("slo_script", temperature=temperature, num_pages=pages,
                 requests=len(toks), wall_s=wall, prefill_s=ph["prefill"],
                 decode_s=ph["decode"], host_sync_s=ph["sync"],
                 decode_steps=eng.n_steps,
                 prefill_batches=eng.n_prefill_batches,
                 restores_byte_checked=saved.get("checked", 0),
                 latency=_class_latency(eng.finished_in_window),
                 launches=launches, **_swap_row(eng))
            runs[pages] = toks
            del eng
        if runs[half] != runs[full]:
            bad = [r for r in runs[full] if runs[half][r] != runs[full][r]]
            raise AssertionError(f"slo script at T {temperature}: the "
                                 f"tight pool changed the tokens of "
                                 f"requests {bad}")
        emit("slo_check", temperature=temperature, identical=True,
             requests=len(runs[full]))
        torch.cuda.empty_cache()
    check_snapshot(torch, model, params, batch, interactive, half)
    # three batch requests' worth of pages: the batch burst fills the pool
    serve_async(torch, model, params, 1 + 3 * SLO_REQUEST_PAGES)


def check_snapshot(torch, model, params, batch, interactive, num_pages):
    """Capture mid-stream (a batch request swapped out, graphs on, T 0.8),
    run to the end, restore, run again: the same tokens."""
    from repro_torch.serve import capture, restore
    eng = _slo_engine(torch, model, params, num_pages, 0.8, None)
    pb, _, nb = SLO_BATCH
    pi, _, ni = SLO_INTERACTIVE
    for p in batch:
        eng.add_request(p, nb, priority=pb)
    for _ in range(3):
        eng.step()
    for p in interactive:
        eng.add_request(p, ni, priority=pi)
    eng.step()
    swapped = len(eng.swap_store)
    t0 = time.perf_counter()
    snap = capture(eng)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    want = {r: v.tolist() for r, v in eng.run().items()}
    t0 = time.perf_counter()
    restore(eng, snap)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    got = {r: v.tolist() for r, v in eng.run().items()}
    if got != want or not swapped:
        raise AssertionError(f"snapshot restore: {swapped} swapped out at "
                             f"capture; tokens identical {got == want}")
    emit("slo_snapshot", temperature=0.8, requests=len(got),
         swapped_at_capture=swapped, identical=True,
         snapshot_mb=snap.nbytes / 1e6, capture_s=capture_s,
         restore_s=restore_s)
    del eng, snap
    torch.cuda.empty_cache()


SLO_ARRIVAL = ("batch onoff:32:0.25:2.0 x6, interactive onoff:16:0.5:1.0 "
               "x16 from 0.5 s")


def _slo_arrivals(vocab):
    """The two-class mix as two on/off streams: a burst of 6 batch-class
    requests (32/s for 0.25 s), and from 0.5 s on 16 interactive ones in
    bursts of 0.5 s at 16/s, 1 s apart — bursts that land on a pool the
    batch requests fill."""
    from repro_torch.serve import TrafficClass, on_off_times, synthesize
    batch = synthesize(
        on_off_times(32.0, 6, on_s=0.25, off_s=2.0, seed=3),
        [TrafficClass("batch", SLO_BATCH[1], (SLO_BATCH[2], SLO_BATCH[2] + 1),
                      priority=SLO_BATCH[0])], vocab, seed=3)
    interactive = synthesize(
        [0.5 + t for t in on_off_times(16.0, 16, on_s=0.5, off_s=1.0,
                                       seed=4)],
        [TrafficClass("interactive", SLO_INTERACTIVE[1],
                      (SLO_INTERACTIVE[2], SLO_INTERACTIVE[2] + 1),
                      priority=SLO_INTERACTIVE[0],
                      deadline_s=SLO_DEADLINE_S)], vocab, seed=4)
    return sorted(batch + interactive, key=lambda a: a.t)


def serve_async(torch, model, params, num_pages):
    """``AsyncServer`` under on/off arrivals of the two-class mix, over
    ``num_pages`` pages: reject-on-full, block, and block + preempt,
    each a main path of its own.  Block must serve every arrival; every
    run must serve at least one."""
    import asyncio
    from repro_torch.serve import (AsyncServer, ContinuousBatchingEngine,
                                   latency_summary, replay)
    arrivals = _slo_arrivals(model.cfg.vocab)
    for admission, preempt in (("reject", False), ("block", False),
                               ("block", True)):
        eng = ContinuousBatchingEngine(
            model, params, max_slots=8, page_size=16, max_len=SLO_MAX_LEN,
            num_pages=num_pages, sync_every=8, prefill_bucket=64,
            preempt=preempt)

        async def run():
            async with AsyncServer(eng, admission=admission,
                                   use_executor=True) as srv:
                return await replay(srv, arrivals, speedup=1.0)

        (streams, rejected), launches, wall = _drive(
            torch, lambda: asyncio.run(run()))
        path = f"async {admission}{' + preempt' if preempt else ''}"
        _slo_launches_ok(path, eng, launches)
        fin = eng.finished_in_window
        if len(fin) + len(rejected) != len(arrivals) or not fin \
                or (admission == "block" and rejected):
            raise AssertionError(f"{path}: {len(fin)} served, "
                                 f"{len(rejected)} rejected of "
                                 f"{len(arrivals)}")
        for r in fin:
            if len(r.out) != r.max_new_tokens or min(r.out) < 0 \
                    or max(r.out) >= model.cfg.vocab:
                raise AssertionError(f"{path}: bad output for request "
                                     f"{r.rid}")
        ph = eng.phase
        emit("slo_async", admission=admission, preempt=preempt,
             arrival=SLO_ARRIVAL, arrivals=len(arrivals),
             num_pages=num_pages, served=len(fin), rejected=len(rejected),
             wall_s=wall, prefill_s=ph["prefill"], decode_s=ph["decode"],
             host_sync_s=ph["sync"], decode_steps=eng.n_steps,
             all_classes=latency_summary(fin),
             latency=_class_latency(fin), launches=launches,
             **_swap_row(eng))
        del eng
        torch.cuda.empty_cache()


# =============================================================================
# the serve_faults phase: fault drill, retries, watchdog, observability
# =============================================================================
# (priority, prompt lengths, new tokens) of the drill's two classes
FAULT_BATCH = (1, (256, 385), 64)
FAULT_INTERACTIVE = (0, (64, 193), 16)
FAULT_MAX_LEN = FAULT_BATCH[1][1] - 1 + FAULT_BATCH[2]
FAULT_PAGES = 113       # a tight pool: the interactive arrivals preempt
# one fault per site, each at its own request (rids 0-4 batch, 5-7
# interactive), chosen by a CPU rehearsal with the reduced model: the host
# schedule depends only on prompt lengths and pages.  page_corrupt writes
# one live scale position of rid 1 at the 3rd step; the interactive
# arrivals preempt rid 3, and swap_corrupt poisons its host copy (caught
# after its restore); prefill_nan poisons rid 6's prompt pages at
# admission; alloc_fail fails the 5th mid-decode page grant, whose slot
# (rid 2) swaps out and resumes.
FAULT_PLAN = ("prefill_nan:rid=6,page_corrupt:nth=2:rid=1,"
              "swap_corrupt:rid=3,alloc_fail:nth=4")
FAULT_TARGETS = {6, 1, 3}
FAULT_SEED = 17
FAULT_STALL = "stall:nth=2:stall_s=120"


def _sync(torch, model):
    if model.device.type == "cuda":
        torch.cuda.synchronize()


def _fault_prompts(vocab):
    import numpy as np
    out = []
    for cls, n, seed in ((FAULT_BATCH, 5, 31), (FAULT_INTERACTIVE, 3, 32)):
        rng = np.random.default_rng(seed)
        lo, hi = cls[1]
        out += [(cls[0], rng.integers(1, vocab, size=int(m)).astype(np.int32),
                 cls[2]) for m in rng.integers(lo, hi, size=n)]
    return out


def _fault_engine(model, params, plan=None, **kw):
    """The drill's engine (chip_smoke's configuration, preempt on, over
    ``FAULT_PAGES``), recording each swap-out's rid beside the plan's
    firings at that moment and checking, as each quarantined request's
    pages return to the free list, that they were scrubbed to zeros."""
    from repro_torch.serve import ContinuousBatchingEngine

    class Drill(ContinuousBatchingEngine):
        def _swap_out(self, req):
            n = len(self.faults.fired) if self.faults is not None else 0
            self.swaps.append((req.rid, n))
            super()._swap_out(req)

        def _quarantine(self, req, diag):
            ids = self.blocks.slot_page_ids(req.slot)
            super()._quarantine(req, diag)
            dead = [i for i in ids if self.blocks.page_refcount(i) == 0]
            self.scrubbed.append((req.rid, len(dead), all(
                not bool(leaf[:, dead].any()) for leaf in self.pool.values())))

    kw.setdefault("num_pages", FAULT_PAGES)
    eng = Drill(model, params, max_slots=8, page_size=16,
                max_len=FAULT_MAX_LEN, sync_every=8, prefill_bucket=64,
                preempt=True, faults=plan, **kw)
    eng.swaps, eng.scrubbed = [], []
    return eng


def _fault_script(eng, prompts):
    """Batch-class requests decode until each running one has 8 tokens;
    then the interactive ones arrive.  Returns {rid: tokens}."""
    rids = [eng.add_request(p, n, priority=pr)
            for pr, p, n in prompts if pr == FAULT_BATCH[0]]
    for _ in range(64):
        eng.step()
        if all(len(r.out) >= 8 for r in eng.scheduler.running.values()):
            break
    rids += [eng.add_request(p, n, priority=pr)
             for pr, p, n in prompts if pr != FAULT_BATCH[0]]
    out = eng.run()
    return {r: out[r].tolist() for r in rids if r in out}


def _alloc_victim(eng):
    """The rid the alloc_fail firing swapped out: the first swap-out made
    right after that firing was recorded."""
    plan = eng.faults
    idx = next(i for i, f in enumerate(plan.fired) if f[0] == "alloc_fail")
    return next(rid for rid, n in eng.swaps if n == idx + 1)


def _fault_drill(torch, model, params, clean):
    """(a): the plan over the tight pool, twice; returns the first run's
    engine, tokens and launches."""
    from repro_torch.serve import FaultPlan
    prompts = _fault_prompts(model.cfg.vocab)
    runs = []
    for i in range(2):
        plan = FaultPlan.parse(FAULT_PLAN, seed=FAULT_SEED)
        eng = _fault_engine(model, params, plan)
        if i == 0:
            toks, launches, wall = _drive(
                torch, lambda: _fault_script(eng, prompts))
        else:
            toks, wall = _fault_script(eng, prompts), None
        runs.append((eng, toks, launches, wall))
    eng, toks, launches, wall = runs[0]
    plan = eng.faults
    failed = {r.rid: r.error for r in eng.scheduler.failed}
    sites = {s for s, _, _ in plan.fired}
    if sites != {"prefill_nan", "page_corrupt", "swap_corrupt",
                 "alloc_fail"} or set(failed) != FAULT_TARGETS:
        raise AssertionError(f"fault drill: fired {plan.fired}, "
                             f"quarantined {sorted(failed)}, expected "
                             f"{sorted(FAULT_TARGETS)}")
    victim = _alloc_victim(eng)
    healthy = set(clean) - FAULT_TARGETS
    if set(toks) != healthy or any(toks[r] != clean[r] for r in healthy):
        raise AssertionError("fault drill: a healthy request's tokens "
                             "differ from the clean run's")
    if victim not in healthy or eng.n_restores != eng.n_preemptions \
            or len(eng.swap_store):
        raise AssertionError(f"fault drill: alloc_fail victim {victim}, "
                             f"{eng.n_preemptions} swap-outs, "
                             f"{eng.n_restores} restores")
    if not eng.scrubbed or not all(ok and n for _, n, ok in eng.scrubbed):
        raise AssertionError(f"fault drill: scrub {eng.scrubbed}")
    again = runs[1][0]
    if again.faults.fired != plan.fired or runs[1][1] != toks:
        raise AssertionError("fault drill: a second run of the same plan "
                             "fired or served differently")
    if eng.model.device.type == "cuda":
        n_l = eng.model.cfg.n_layers
        steps, batches = eng.n_steps, eng.n_prefill_batches
        _check_launches("fault drill", launches, {
            "mx_matmul_2d": 7 * n_l * (steps + batches),
            "mx_kv_write": n_l * (steps + batches),
            "mx_paged_decode_attention": n_l * steps})
    ph = eng.phase
    emit("faults_drill", plan=FAULT_PLAN, seed=FAULT_SEED,
         num_pages=FAULT_PAGES, requests=len(clean), fired=plan.fired,
         quarantined=failed, alloc_fail_victim=victim,
         swap_outs=eng.swaps, restores=eng.n_restores,
         scrubbed_pages=sum(n for _, n, _ in eng.scrubbed),
         healthy_identical=True, replay_fired_identical=True, wall_s=wall,
         prefill_s=ph["prefill"], decode_s=ph["decode"],
         swap_s=ph["swap"], decode_steps=eng.n_steps,
         prefill_batches=eng.n_prefill_batches, launches=launches)
    return launches


def _fault_async(model, params, prompts, engine_kw, **server_kw):
    """Every prompt through ``AsyncServer`` at once (in rid order);
    returns (server, {rid: tokens}, seconds)."""
    import asyncio
    from repro_torch.serve import AsyncServer
    eng = _fault_engine(model, params, **engine_kw)

    async def run():
        async with AsyncServer(eng, **server_kw) as srv:
            streams = [await srv.submit(p, n, priority=pr)
                       for pr, p, n in prompts]
            toks = [await s.tokens() for s in streams]
            return srv, {s.rid: [int(t) for t in tk]
                         for s, tk in zip(streams, toks)}

    t0 = time.perf_counter()
    srv, toks = asyncio.run(asyncio.wait_for(run(), 600))
    return eng, srv, toks, time.perf_counter() - t0


def _fault_retry(torch, model, params, clean):
    """(b): the plan through ``AsyncServer(retries=1)``: every request,
    the quarantined ones too, ends with the clean run's tokens."""
    from repro_torch.serve import FaultPlan
    prompts = _fault_prompts(model.cfg.vocab)
    plan = FaultPlan.parse(FAULT_PLAN, seed=FAULT_SEED)
    eng, srv, toks, wall = _fault_async(
        model, params, prompts, dict(plan=plan), retries=1,
        retry_backoff_s=0.01)
    if toks != clean or not srv.n_retried or srv.n_failed:
        raise AssertionError(f"fault retry: {srv.n_retried} retries, "
                             f"{srv.n_failed} failures, tokens identical "
                             f"{toks == clean}")
    emit("faults_retry", plan=FAULT_PLAN, requests=len(toks),
         fired=plan.fired, quarantined=eng.n_quarantined,
         retried=srv.n_retried, failed=srv.n_failed, identical=True,
         wall_s=wall)


def _fault_watchdog(torch, model, params, clean):
    """(c): a 120 s stall at the third step, cut by the watchdog, the
    engine restored from its last snapshot in place.  The watchdog is
    set well above both the engine's graph capture (measured here) and
    a healthy first step (prefill of 8 prompts and a window)."""
    from repro_torch.serve import FaultPlan
    prompts = _fault_prompts(model.cfg.vocab)
    t0 = time.perf_counter()
    probe = _fault_engine(model, params, num_pages=None)   # captures
    _sync(torch, model)
    capture_s = time.perf_counter() - t0
    for pr, p, n in prompts:
        probe.add_request(p, n, priority=pr)
    t0 = time.perf_counter()
    probe.step()
    _sync(torch, model)
    first_step_s = time.perf_counter() - t0
    del probe
    watchdog_s = max(10.0, 4 * max(capture_s, first_step_s))
    plan = FaultPlan.parse(FAULT_STALL, seed=FAULT_SEED)
    eng, srv, toks, wall = _fault_async(
        model, params, prompts, dict(plan=plan, num_pages=None),
        use_executor=True, watchdog_s=watchdog_s, snapshot_every=1)
    if toks != clean or srv.n_recoveries < 1 or wall > 60:
        raise AssertionError(f"watchdog: {srv.n_recoveries} recoveries in "
                             f"{wall:.1f} s, tokens identical "
                             f"{toks == clean}")
    emit("faults_watchdog", plan=FAULT_STALL, watchdog_s=watchdog_s,
         graph_capture_s=capture_s, first_step_s=first_step_s,
         recoveries=srv.n_recoveries, fired=plan.fired, identical=True,
         wall_s=wall)


def _obs_run(torch, model, params, prompts, temperature, on):
    """The drill's prompts, all at once, without faults, observability
    off or fully on; returns (engine, tokens, per-sample record).  A
    health sample runs after a window's decode phase ends (its time is
    in the sync phase), so beside decode tokens/s the wall of the run is
    kept (``eng.wall_s``)."""
    from repro_torch.obs import MetricsRegistry, Tracer
    from repro_torch.serve import GenerationConfig
    kw = dict(num_pages=None, gen=GenerationConfig(temperature=temperature,
                                                   seed=5))
    if on:
        kw.update(tracer=Tracer(meta={"phase": "serve_faults"}),
                  metrics=MetricsRegistry(), obs_interval=1)
    eng = _fault_engine(model, params, **kw)
    samples = []
    if on:
        sample = eng._sample_mx_health

        def timed():
            lengths = eng._lengths.copy()
            t0 = time.perf_counter()
            sample()        # ends in its host transfer
            samples.append((time.perf_counter() - t0, lengths))

        eng._sample_mx_health = timed
    t0 = time.perf_counter()
    rids = [eng.add_request(p, n, priority=pr) for pr, p, n in prompts]
    out = eng.run()
    _sync(torch, model)
    eng.wall_s = time.perf_counter() - t0
    return eng, {r: out[r].tolist() for r in rids}, samples


def _fault_obs(torch, model, params, out_dir):
    """(d): tracer, registry and a health sample per window against all
    off, greedy and T 0.8: identical tokens, well-nested spans, the
    trace/v1 JSONL and Chrome files written, no poison marker, and
    ``mx.scale_bytes`` per role equal to the exact count at the last
    sample: its lengths x 2 KV heads x 4 scale bytes x 28 layers."""
    import json
    from repro_torch.obs import validate_nesting
    cfg = model.cfg
    prompts = _fault_prompts(cfg.vocab)
    per_pos = cfg.n_kv_heads * (cfg.hd // 32) * cfg.n_layers
    for temperature in (0.0, 0.8):
        off, want, _ = _obs_run(torch, model, params, prompts, temperature,
                                False)
        on, got, samples = _obs_run(torch, model, params, prompts,
                                    temperature, True)
        if got != want:
            raise AssertionError(f"observability on changed the tokens at "
                                 f"T {temperature}")
        on.finalize_trace()
        roots = validate_nesting(on.tracer.events)
        if any(roots.get(r) != ["request"] for r in got):
            raise AssertionError("observability: a request track is "
                                 "malformed")
        tag = f"t{temperature:g}"
        paths = (out_dir / f"trace_{tag}.jsonl",
                 out_dir / f"trace_{tag}.chrome.json")
        on.tracer.write_jsonl(paths[0])
        on.tracer.write_chrome(paths[1])
        header = json.loads(paths[0].read_text().splitlines()[0])
        if header["schema"] != "trace/v1" \
                or not json.loads(paths[1].read_text())["traceEvents"]:
            raise AssertionError("observability: trace files not written")
        g = on.metrics.snapshot()["gauges"]
        exact = int(samples[-1][1].sum()) * per_pos
        want_bytes = {"role=kv_key": exact, "role=kv_value": exact}
        if g["mx.poison_markers"] != {"role=kv_key": 0, "role=kv_value": 0} \
                or g["mx.scale_bytes"] != want_bytes:
            raise AssertionError(f"observability: gauges {g}, expected "
                                 f"scale bytes {want_bytes}")
        ms = sorted(1e3 * s for s, _ in samples)
        dec = {n: (e.n_generated - len(prompts)) / e.phase["decode"]
               for n, e in (("off", off), ("on", on))}
        emit("faults_obs", temperature=temperature, identical=True,
             events=len(on.tracer.events),
             trace_bytes=paths[0].stat().st_size,
             chrome_bytes=paths[1].stat().st_size, samples=len(samples),
             last_sample_positions=int(samples[-1][1].sum()),
             scale_bytes=g["mx.scale_bytes"], exact_scale_bytes=exact,
             poison_markers=g["mx.poison_markers"],
             saturation_rate=g["mx.saturation_rate"],
             underflow_rate=g["mx.underflow_rate"],
             health_sample_ms_median=ms[len(ms) // 2],
             health_sample_ms_max=ms[-1],
             decode_tokens_per_s_off=dec["off"],
             decode_tokens_per_s_on=dec["on"],
             decode_s_off=off.phase["decode"],
             decode_s_on=on.phase["decode"],
             host_sync_s_off=off.phase["sync"],
             host_sync_s_on=on.phase["sync"],
             wall_s_off=off.wall_s, wall_s_on=on.wall_s)
        del off, on


def serve_faults(torch, model, params):
    """The ``serve_faults`` phase (chip_smoke's configuration: e4m3
    weights, INT8 K / E2M1 V in pages of 16, 8 slots, sync_every 8, health
    checks on, graph replay; preempt on).  5 batch-class requests (prompts
    of 256-384 tokens, 64 new) decode; 3 interactive ones (64-192 tokens,
    16 new) arrive.

    (a) Fault drill over ``FAULT_PAGES`` pages, twice, under
        ``FAULT_PLAN``: the quarantine set is the plan's targets, every
        other request's tokens (the alloc_fail victim's among them) equal
        the clean run's, every quarantined request's pages are zeros as
        they return to the free list, and the two runs fire identically.
    (b) The plan through ``AsyncServer(retries=1)``: every request ends
        with the clean run's tokens.
    (c) ``AsyncServer(use_executor=True, watchdog_s=W, snapshot_every=1)``
        under a 120 s stall: a recovery, the clean run's tokens, well
        under 120 s.
    (d) Observability on against off, greedy and T 0.8.
    Returns the drill's launches (its first run is a main path)."""
    import tempfile
    prompts = _fault_prompts(model.cfg.vocab)
    eng = _fault_engine(model, params)
    clean = _fault_script(eng, prompts)
    if eng.n_preemptions < 1 or eng.n_quarantined:
        raise AssertionError(f"fault drill, clean run: "
                             f"{eng.n_preemptions} preemptions, "
                             f"{eng.n_quarantined} quarantined")
    emit("faults_clean", requests=len(clean), num_pages=FAULT_PAGES,
         preemptions=eng.n_preemptions, swaps=eng.swaps,
         decode_steps=eng.n_steps)
    del eng
    launches = _fault_drill(torch, model, params, clean)
    _fault_retry(torch, model, params, clean)
    _fault_watchdog(torch, model, params, clean)
    with tempfile.TemporaryDirectory() as d:
        _fault_obs(torch, model, params, Path(d))
    if model.device.type == "cuda":
        torch.cuda.empty_cache()
    return launches


def _static_eager(torch, model, params, tokens, new, max_len):
    """The static decode loop, eagerly: prefill, then ``decode_step`` at
    host positions with greedy sampling."""
    import numpy as np
    vocab = model.cfg.vocab
    logits, cache, pos = model.prefill(
        params, torch.from_numpy(tokens).cuda(), max_len=max_len)
    tok = torch.argmax(logits[:, -1, :vocab], -1).to(torch.int32)
    out = [tok]
    del logits
    for i in range(new - 1):
        lg, cache = model.decode_step(params, tok, cache, pos + i)
        tok = torch.argmax(lg[:, -1, :vocab], -1).to(torch.int32)
        out.append(tok)
    return np.asarray(torch.stack(out, dim=1).cpu())


def serve_static(torch, model, params):
    """``ServeEngine`` on the full-width weights: 8 equal prompts of 512
    tokens, 64 new tokens, greedy; once over the MX KV cache of ``model``'s
    policy (decode through the contiguous MX decode kernel) and once over a
    bf16 cache (prefill through the flash kernel), each a main path of its
    own.  A first call captures the decode step; the second, driven, call
    replays it once per token and must give the eager loop's tokens.  Then
    the continuous engine serves the same prompts under the MX policy and
    must give the static engine's tokens."""
    import dataclasses
    import numpy as np
    from repro_torch.core.spec import QuantPolicy
    from repro_torch.models import Model
    from repro_torch.serve import (ContinuousBatchingEngine,
                                   GenerationConfig, ServeEngine)
    cfg = model.cfg
    b, s, new, n_l = 8, 512, 64, cfg.n_layers
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, size=(b, s))
    tokens = tokens.astype(np.int32)
    fp_kv = Model(dataclasses.replace(cfg, mx=QuantPolicy(
        weights=cfg.mx.weights)), device=model.device)
    runs = (("mx_kv", model, {"mx_decode_attention": n_l * (new - 1),
                              "mx_matmul_2d": 7 * n_l * new,
                              "mx_kv_write": n_l * new},
             {"mx_matmul_2d": 7 * n_l, "mx_cache_kv_write": n_l,
              "mx_decode_attention": n_l}),
            ("bf16_kv", fp_kv, {"flash_attention": n_l,
                                "mx_matmul_2d": 7 * n_l * new},
             {"mx_matmul_2d": 7 * n_l}))
    gen = GenerationConfig(max_new_tokens=new)
    outs, counts = {}, {}
    for name, m, want, per_step in runs:
        eng = ServeEngine(m, params, max_len=s + new + 8)
        eng.generate({"tokens": tokens}, gen)       # captures the step
        captured = eng.n_captures
        out, launches, wall = _drive(
            torch, lambda: eng.generate({"tokens": tokens}, gen))
        if eng.n_captures != captured or captured != 1:
            raise AssertionError(f"static serving, {name}: captured "
                                 f"{eng.n_captures} decode steps")
        _check_launches(f"static serving, {name}", launches, want)
        if out.shape != (b, new) or out.min() < 0 or out.max() >= cfg.vocab:
            raise AssertionError(f"static serving, {name}: bad output")
        ph = eng.phase
        emit("serve_static", kv=name, policy=str(m.cfg.mx), batch=b,
             prompt_len=s, new_tokens=new, wall_s=wall,
             prefill_s=ph["prefill"], decode_s=ph["decode"],
             decode_tokens_per_s=b * (new - 1) / ph["decode"],
             kv_cache_nbytes=eng.kv_cache_nbytes,
             weight_pool_nbytes=eng.weight_pool_nbytes, launches=launches)
        t0 = time.perf_counter()
        eager = _static_eager(torch, m, params, tokens, new, s + new + 8)
        eager_s = time.perf_counter() - t0
        if not np.array_equal(out, eager):
            raise AssertionError(f"static serving, {name}: graph and eager "
                                 f"decode loops give other tokens")
        emit("graph_vs_eager", path=f"static {name}", steps=new - 1,
             eager_s=eager_s, graph_decode_s=ph["decode"], tokens=True)
        check_replay(torch, f"static {name} decode step",
                     eng._graphs[(b, 0.0)].step, per_step)
        outs[name], counts[name] = out, launches
        del eng
        torch.cuda.empty_cache()
    eng = ContinuousBatchingEngine(model, params, max_slots=8, page_size=16,
                                   max_len=s + new + 1, sync_every=8,
                                   prefill_bucket=64)
    prompts = list(tokens)
    cont = _serve(eng, prompts, new)
    flips = _flips(torch, model, params, prompts, cont, outs["mx_kv"])
    emit("static_vs_continuous", requests=b, new_tokens=new,
         identical=not flips, flips=flips)
    return {"mx_decode_attention": counts["mx_kv"]["mx_decode_attention"],
            "flash_attention": counts["bf16_kv"]["flash_attention"]}


def serve_c5(torch):
    """A head dim that no decode-attention kernel takes (48: K/V codes
    padded to 64): a reduced-width chatglm3-6b (2 layers, d 128, 4 heads
    over 2 KV heads) in bf16 with e4m3 weights, INT8 keys and E2M1 values
    serves through both engines on the card, with decode attention dense
    by the kernels' predicates (as in the reference) and the KV write
    fused, and gives the CPU's greedy tokens (a flip only at a top-2 logit
    gap below BF16_FLIP_TOL); the static engine over a bf16 cache too,
    its prompt through flash attention zero-padded to head dim 64."""
    import dataclasses
    import numpy as np
    from repro_torch.core.spec import QuantPolicy
    from repro_torch.launch.serve import build_model
    from repro_torch.models import Model
    from repro_torch.serve import (ContinuousBatchingEngine,
                                   GenerationConfig, ServeEngine)
    model, params = build_model("chatglm3_6b", reduced=True, quant=POLICY,
                                weight_resident=True, device="cuda", seed=3,
                                head_dim=48, dtype="bfloat16",
                                attn_impl="flash")
    cfg, n_l, new = model.cfg, model.cfg.n_layers, 8
    cpu_params = _to_cpu(params)
    fp_cfg = dataclasses.replace(cfg, mx=QuantPolicy(weights=cfg.mx.weights))
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab, size=(4, 24)).astype(np.int32)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
               for n in (5, 17, 30, 9, 24, 12)]

    # each engine here captures its decode step inside the driven run,
    # and the capture's warm-up step launches every kernel of a step
    # once more (one step on the card, none on the CPU)
    def static(m, p):
        eng = ServeEngine(m, p, max_len=24 + new + 8)
        out = eng.generate({"tokens": tokens},
                           GenerationConfig(max_new_tokens=new))
        n = new + eng.n_captures
        want = {"mx_matmul_2d": 7 * n_l * n}
        if m.cfg.mx.kv_key is not None:
            want["mx_kv_write"] = n_l * n
        else:
            want["flash_attention"] = n_l          # the prompts' prefill
        return out.tolist(), want

    def continuous(m, p):
        eng = ContinuousBatchingEngine(m, p, max_slots=4, page_size=16,
                                       max_len=30 + new + 1, sync_every=4,
                                       prefill_bucket=16)
        out = [o.tolist() for o in _serve(eng, prompts, new)]
        warm = int(eng.window.step.graph is not None)
        n = eng.n_steps + eng.n_prefill_batches + warm
        return out, {"mx_matmul_2d": 7 * n_l * n, "mx_kv_write": n_l * n}

    for name, c, fn, ps in (("static, MX KV", cfg, static, list(tokens)),
                            ("continuous, MX KV", cfg, continuous, prompts),
                            ("static, bf16 KV", fp_cfg, static,
                             list(tokens))):
        m = Model(c, device="cuda")
        (got, want_launches), launches, wall = _drive(
            torch, lambda: fn(m, params))
        _check_launches(f"head dim 48, {name}", launches, want_launches)
        cpu, _ = fn(Model(c, device="cpu"), cpu_params)
        flips = _flips(torch, m, params, ps, got, cpu, tol=BF16_FLIP_TOL)
        emit("c5_head_dim_48", path=name, head_dim=cfg.hd, dtype="bfloat16",
             layers=n_l, d_model=cfg.d_model, policy=str(c.mx),
             requests=len(ps), new_tokens=new, wall_s=wall,
             launches=launches, identical=not flips, flips=flips,
             tokens=got[:2])
    del params, model
    torch.cuda.empty_cache()


# =============================================================================
# phase 4: card against CPU
# =============================================================================
def _to_cpu(tree):
    import dataclasses
    from repro_torch.core.mx_weight import MXWeight
    if isinstance(tree, MXWeight):
        return dataclasses.replace(tree, codes=tree.codes.cpu(),
                                   scales=tree.scales.cpu())
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


def card_vs_cpu(torch):
    import numpy as np
    from repro_torch.launch.serve import build_model
    from repro_torch.models import Model
    from repro_torch.serve import ContinuousBatchingEngine
    model, params = build_model("chatglm3_6b", reduced=False, quant=POLICY,
                                weight_resident=True, device="cuda", seed=1,
                                n_layers=2, dtype="float32",
                                attn_impl="flash")
    cpu_model = Model(model.cfg, device="cpu")
    cpu_params = _to_cpu(params)
    vocab = model.cfg.vocab
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, vocab, size=n).astype(np.int32)
               for n in (40, 61)]
    tok = torch.from_numpy(prompts[1][None])
    t0 = time.perf_counter()
    lg, _, _ = model.prefill(params, tok.cuda(), max_len=tok.shape[1])
    lc, _, _ = cpu_model.prefill(cpu_params, tok, max_len=tok.shape[1])
    err = float((lg.cpu()[..., :vocab] - lc[..., :vocab]).abs().max())
    if not err <= LOGITS_TOL:
        raise AssertionError(f"card vs CPU prefill logits differ by {err}")
    outs = []
    for m, p in ((model, params), (cpu_model, cpu_params)):
        eng = ContinuousBatchingEngine(m, p, max_slots=2, page_size=16,
                                       max_len=64 + 4, sync_every=8,
                                       prefill_bucket=64)
        outs.append([o.tolist() for o in _serve(eng, prompts, 3)])
    # a token flip is accepted only where the logits that chose it have a
    # top-2 gap below the tolerance (traced on the card)
    flips = _flips(torch, model, params, prompts, *outs)
    emit("card_vs_cpu", layers=2, dtype="float32",
         logits_max_abs_err=err, tolerance=LOGITS_TOL, tokens=outs[0],
         cpu_tokens=outs[1], flips=flips, seconds=time.perf_counter() - t0)
    del params, model
    torch.cuda.empty_cache()
    static_card_vs_cpu(torch)


def static_card_vs_cpu(torch):
    """``ServeEngine`` over an fp KV cache (the f32 of the layers; prefill
    through the flash kernel) on 2 full-width f32 layers with fp weights,
    card against CPU."""
    import numpy as np
    from repro_torch.launch.serve import build_model
    from repro_torch.models import Model
    from repro_torch.serve import GenerationConfig, ServeEngine
    model, params = build_model("chatglm3_6b", reduced=False, quant="none",
                                weight_resident=False, device="cuda", seed=2,
                                n_layers=2, dtype="float32",
                                attn_impl="flash")
    cpu_model = Model(model.cfg, device="cpu")
    cpu_params = _to_cpu(params)
    vocab = model.cfg.vocab
    tokens = np.random.default_rng(6).integers(0, vocab, size=(2, 61))
    tokens = tokens.astype(np.int32)
    t0 = time.perf_counter()
    tok = torch.from_numpy(tokens[:1])
    lg, _, _ = model.prefill(params, tok.cuda(), max_len=tok.shape[1])
    lc, _, _ = cpu_model.prefill(cpu_params, tok, max_len=tok.shape[1])
    err = float((lg.cpu()[..., :vocab] - lc[..., :vocab]).abs().max())
    if not err <= LOGITS_TOL:
        raise AssertionError(f"card vs CPU fp-KV prefill logits differ by "
                             f"{err}")
    gen = GenerationConfig(max_new_tokens=4)
    outs = [ServeEngine(m, p, max_len=61 + 4 + 8).generate(
        {"tokens": tokens}, gen).tolist()
        for m, p in ((model, params), (cpu_model, cpu_params))]
    flips = _flips(torch, model, params, list(tokens), *outs)
    emit("static_card_vs_cpu", layers=2, dtype="float32", kv="fp (f32)",
         logits_max_abs_err=err, tolerance=LOGITS_TOL, tokens=outs[0],
         cpu_tokens=outs[1], flips=flips, seconds=time.perf_counter() - t0)
    del params, model
    torch.cuda.empty_cache()


# =============================================================================
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every result row to this JSON file")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port "
              "on an NVIDIA GPU", file=sys.stderr)
        return 1
    src = ROOT / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.lib()
    emit("build", nvcc_s=build.build_seconds,
         load_s=time.perf_counter() - t0, torch=torch.__version__,
         cuda=torch.version.cuda, card=smi)
    print(build.build_log, flush=True)

    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    q_row, q_err = check_converter(torch, flush)
    w_row, w_err = check_kv_write(torch, flush)
    m_row, m_err = check_matmul(torch, flush)
    a_row, a_err = check_paged_attention(torch, flush)
    d_row, d_err = check_decode_attention(torch, flush)
    check_head_dim_96(torch)
    f_row, f_err = check_flash(torch, flush)
    check_lm_head(torch, flush)
    del flush
    torch.cuda.empty_cache()
    launches = serve_full_width(torch)
    serve_c5(torch)
    card_vs_cpu(torch)

    sources = {"mx_quantize_2d": "src/repro_torch/csrc/mx_quant.cu",
               "mx_kv_write": "src/repro_torch/csrc/mx_kv_write.cu",
               "mx_matmul_2d": "src/repro_torch/csrc/mx_matmul_tc.cu",
               "mx_paged_decode_attention":
                   "src/repro_torch/csrc/mx_decode_attn_tc.cu",
               "mx_decode_attention":
                   "src/repro_torch/csrc/mx_decode_attn_tc.cu",
               "flash_attention": "src/repro_torch/csrc/flash_attn_tc.cu"}
    replaces = {
        "mx_quantize_2d": "src/repro/kernels/mx_quant.py:117",
        "mx_kv_write": "src/repro/kernels/mx_quant.py:117",
        "mx_matmul_2d": "src/repro/kernels/mx_matmul.py:140",
        "mx_paged_decode_attention":
            "src/repro/kernels/mx_decode_attn.py:310",
        "mx_decode_attention": "src/repro/kernels/mx_decode_attn.py:162",
        "flash_attention": "src/repro/kernels/flash_attn.py:99"}
    kernels = []
    for name, row, err in (("mx_quantize_2d", q_row, q_err),
                           ("mx_kv_write", w_row, w_err),
                           ("mx_matmul_2d", m_row, m_err),
                           ("mx_paged_decode_attention", a_row, a_err),
                           ("mx_decode_attention", d_row, d_err),
                           ("flash_attention", f_row, f_err)):
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": err, "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": row["shape"]})
        for key in ("max_abs_err_f32", "library_backend", "composed_ms"):
            if key in row:      # the f32 kernel's error; SDPA's backend;
                #                 the KV write's composed yardstick
                kernels[-1][key] = row[key]
        if "multi_token" in row:    # the KV write's suffix-prefill mode,
            mt = row["multi_token"]  # launched on the prefix path
            kernels[-1]["multi_token"] = {
                "shape": mt["shape"],
                "launches": launches["mx_kv_write_tokens"],
                "max_abs_err": mt["max_abs_err"], "ms": mt["ms"],
                "plain_ms": mt["plain_ms"], "bound_ms": mt["bound_ms"],
                "bound_by": mt["bound_by"], "library_ms": mt["library_ms"]}
    RESULTS["kernels"] = kernels
    RESULTS["seconds"] = time.perf_counter() - t_start
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(RESULTS, indent=1))
    print(f"total {RESULTS['seconds']:.1f}s", flush=True)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
