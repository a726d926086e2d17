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
   then the kernels at the shapes of the rest of the GQA family: the MX
   matmul at moonshot-v1-16b-a3b's expert shapes (K 2048 x N 1408 and
   1408 x 2048) through ``MXWeight.take`` views of a 64-expert stack at M
   1 and M 480 (rows bit-identical across the two), one MoE layer's 64
   expert launches against their plain version, replayed from a graph
   beside their byte bound and one batched torch.matmul, and
   yi-34b's w1 (7168 x 20480) at M 8; both decode attentions at GQA
   groups 1 (16 heads over 16) and 7 (56 over 8); the fused KV write at 16
   and 8 KV heads; flash attention at head dim 192 (the head-dim-256
   build, which may not spill registers) in f32 and bf16;
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
   launches in the captured graph's kernel nodes and with the profiler;
   quarantine a prompt with a NaN embedding
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
   fp cache (flash prefill) on 2 full-width f32 layers;
5. the rest of the GQA family at full width (run right after phase 2, so
   that the MoE step's profile of ~24k kernels is the process's first;
   the MoE card-vs-CPU check last), each model freed before the next
   loads and its peak device memory printed: moonshot-v1-16b-a3b
   (cut to MOE_LAYERS of 48 layers, 64 experts of d_ff 1408, top-6, 2
   shared; about 30 GB of MX weights whole) through the continuous engine (prefill buckets of 256,
   greedy and T 0.8; every expert's three matmuls launched per step, the
   predicted 9,360 per step counted and confirmed by the profiler on one
   replay; a replayed window against the eager loop) and through
   ``ServeEngine`` over the MX KV cache (launches counted and confirmed
   on one replay, graph against eager); yi-34b (60
   layers, d 7168, about 36 GB) through the continuous engine (a window
   against the eager loop); then moonshot at full width but 2 layers (the
   dense one and one MoE layer) in f32, card against CPU as in phase 4.

6. calibration and per-layer policy tables (``serve_policy``, after
   phase 3's chatglm3-6b runs): full-width chatglm3-6b with fp bf16
   weights from seed 0 through ``collect_model_stats`` (4 batches of 8 x
   512, attention through flash), ``search_kv_policy`` at 10,348 B/token
   (0.7 x uniform INT8) and ``search_weights_policy`` at 0.75 B/param,
   each table required to mix formats across layers; each served through
   the continuous engine after quantizing per layer (launches 7 / 1 / 1
   a layer and step, confirmed in the graph and by the profiler, and each
   format's matmul and attention launches counted by spec; pool bytes
   exactly each layer's own account; a window against the eager loop;
   ``sync_every`` 1 = 8; prefix cache on = off), the KV table also
   through ``ServeEngine`` against the continuous engine; a uniform table
   naming the base policy gives the base policy's continuous tokens and
   pool
   bytes; 2 full-width f32 layers under a mixed table, card against CPU
   (all five roles' statistics, grads through flash's autograd backward,
   the searched table's JSON, logits and tokens); and the MX matmul and
   paged attention timed at the formats the tables picked.

7. training (``train``): full-width chatglm3-6b cut to 4 of its
   28 layers (AdamW's f32 state), bf16, flash, remat, batches of 8 x 512
   from ``SyntheticLM``: the fake-quant route (``ops.fake_quantize``, the
   converter kernel then the port's dequantize) bit for bit against the
   plain round trip at every weight shape of a layer in e4m3, e2m1, e2m3
   and int8 (NaN/Inf blocks in), the kernel launch timed; 20 baseline
   steps at lr 3e-4, 20 QAT steps (weights and activations E4M3) and 2
   weights-only QAT steps, each driven from 0 with the converter's and
   flash's launches per step exact (remat recomputes a layer's kernels
   only where the backward needs a tensor of it: not under weights +
   activations, ROADMAP C9), the loss on a held-out batch falling by
   5e-3 over the 20-step runs at 3e-4, ms per step, tokens/s and peak
   memory; the QAT run's leaves without gradient exactly every layer's,
   with moments 0 and masters decayed by the weight decay alone, bit for
   bit; at 1 layer, 10 steps through ``train_loop`` against 5 with a
   checkpoint at step 5 resumed in a fresh state to 10 (params and AdamW
   state bit for bit); one full-width layer at 2 x 64 card against CPU:
   two f32 QAT steps, then with no quant every leaf's gradient and
   first-step ``m`` in f32 and in bf16 (the card's bf16 LM head backward,
   ROADMAP C10), in a subprocess of its own (``--check``) beside the
   resume, as is the launcher, twice (``--reduced``, and ``--reduced
   --quant auto:0.75 --save-policy``).

8. training the other families (``train_families``, last): the converter
   at their fake-quant weight shapes (zamba2's in_proj / out_proj and
   shared w1, RWKV6's channel-mix wk and time-mix projections, seamless's
   w1, MLA's w_uq and w_dkv) bit for bit against the plain round trip in
   four formats and timed; then at published widths, bf16, flash, remat,
   8 x 512 tokens a step (seamless: as many frames; internvl2: 256 patch
   embeddings before them): zamba2-1.2b at 20 of its 38 layers (20 steps at
   the launcher's lr 1e-3, its held-out loss falling by 5e-3, which
   rules out a frozen optimizer; ROADMAP C13), seamless-m4t-medium
   whole, rwkv6-7b at 4 of 32 layers,
   deepseek-v2-236b's layer 0 (dense, MLA) and internvl2-76b at 1 of 80
   layers (3 steps each), each also 2 QAT steps (weights and activations
   E4M3), every run driven from 0 with the converter's and flash's
   launches per step exactly ``family_train_launches``' count, losses and
   grad norms finite, ms per step, tokens/s and peak memory; then card
   against CPU at full width, 2 x 128 tokens, f32 and bf16, every leaf's
   gradient and first-step ``m``: one RWKV6 block, and one zamba2 group
   (its shared block and two Mamba2 layers), whose bf16 gradients are
   held to the f32 ones of the same params: the card's no further from
   them than the CPU's.

9. MX-compressed data-parallel training (``train_dp``, last): the
   kernels at the shapes one rank gives them, each against its plain
   version and timed beside its bound: the converter's launch on the
   rank's shard of chatglm3-6b's w1 gradient at world 2 (28,049,408 f32;
   as (1, L) and as (L/32, 32) rows, bit for bit), the converter on the
   rank's QAT activations (2048 rows of 4096 and of 13696 bf16, codes,
   scales and values bit for bit) and flash attention at the rank's
   batch (4 x 512, H 32, Hkv 2, D 128, bf16, beside SDPA); then two
   ranks on the one card (``dist.spawn``; gloo, staged through pinned
   host memory, so no wire speed is measured): the exchange
   (``mx_allreduce_mean``) of the w1 gradient and of a ragged leaf in
   every format x mode, each rank's output bit for bit against the same
   exchange on the CPU (the plain converter), its wall ms and
   ``exchanged_bytes``; then ``build_train_step_compressed_dp`` on
   full-width chatglm3-6b cut to DP_LAYERS layers, bf16, flash, remat,
   global
   batches of 8 x 512 split over the ranks, 3 baseline and 2 QAT steps
   (weights and activations E4M3), each driven from 0 in each rank: the
   converter's launches per step exactly the exchanged leaves plus the
   QAT launches, flash's exact, losses finite, ms per step and peak
   memory per rank, and every leaf of params and AdamW state the same on
   both ranks after each step (64-bit digests); then world one through
   NCCL, in this process: the wire's reduce-scatter and all-gathers on
   the card through NCCL (the identity at world one), and the step bit
   for bit against ``build_train_step``,
   beside the launcher's ``--compressed-dp --devices 2`` on the reduced
   config.

10. Sharded serving (``serve_shard``, last): B2 at one rank's
   projections of chatglm3-6b at model 2 (wq 4096 x 2048, wo 2048 x
   4096, w1 / w3 4096 x 6848, w2 6848 x 4096, M 8) and B3 at its heads
   (Hq 16 over Hkv 1), each timed beside its plain version, torch.matmul
   or SDPA and its bound; B3 and B4 with q a slice of the heads from
   ``head0`` (8 and 24 of 32, over both KV heads) against their plain
   versions; then full-width chatglm3-6b (28 layers, e4m3 weights
   resident, INT8 KV in pages of 16, flash) unsharded in this process:
   the continuous engine over 8 prompts of 64-128 tokens with 32 new
   greedy tokens, the static engine over 8 x 128 with 16 new tokens at
   MX KV and at bf16 KV, each a driven path with exact launches; the
   same sharded code on a mesh of one over NCCL (captured, the tokens
   and first-step logits bit for bit; every axis has size 1 there, so
   the layers skip their collectives, and an NCCL all-reduce and
   all-gather captured into a graph are checked apart to replay as the
   identity, bit for bit); then two ranks on the card (mesh (1, 2) =
   ("data", "model"), gloo staged, eager decode), each holding its
   shard of the weights as they are made: the same three runs, launches
   per rank and step exact (B2 7, the KV write 1, B3 1 a layer; B4 1;
   B5 1 a layer per bf16-KV prefill), both ranks' tokens and logits
   identical;
   against the unsharded runs, two f32 twins of the continuous run (the
   same weights at f32 activations): at f32 KV, where reordered f32
   sums are the only difference, its first step's logits within
   LOGITS_TOL and its tokens but where the unsharded top-2 gap at the
   first differing step is below LOGITS_TOL; at MX KV (the KV write and
   B3 on the rank's heads) the same within SHARD_MXKV_TOL; the bf16 runs
   within bf16's own noise, the whole model's bf16 first-step logits'
   distance from its f32 twin's (MX KV both; at least LOGITS_TOL):
   their first step's logits, and flips only at unsharded top-2 gaps
   below it (the gaps printed); a bf16 control of the row-parallel sum
   on each rank (w2's shard, bf16 x: its outputs differ from the whole
   weight's in at most SHARD_ROWSUM_TOL of them, where partials cast to
   bf16 before the sum would differ in more); each rank's resident
   weight and peak GiB, prefill seconds, decode ms per step, and the
   collectives' ms per step from their ``tp.*`` profiler spans.  Then,
   in the same two processes, ``--shard-pool`` on mesh (2, 1): each rank
   the whole model,
   half the slots and its own half of the page pool, which B3 reads
   through local block tables: the continuous run, launches exact, the
   ranks' tokens identical and the unsharded ones but for flips at
   top-2 gaps below LOGITS_TOL.

11. Sharded training (``train_shard``, last): B1's fake-quant of a rank's
   gathered shards of chatglm3-6b at mesh (2, 2) (w1 4096 x 6848, w2
   6848 x 4096) against the plain round trip in four formats, w2's K
   shard's codes equal to the whole weight's sliced, and B5 at a rank's
   batch and heads (2 x 512, Hq 16 / Hkv 1, D 128, bf16), each timed;
   then ``launch.cells.build_cell`` on full-width chatglm3-6b cut to 2
   layers, 4 x 512 a step, over four gloo ranks sharing the card (mesh
   ("data", "model") = (2, 2)), each holding its (data, model) chunk of
   params and AdamW state placed as they are made (16 q heads, 1 KV
   head, 6,848 FFN columns, 32,512 vocab rows, half of each again over
   "data"): the "optimized" cell (weights fake-quant through B1 on the
   gathered shards, flash through B5, ``bf16_matmul_out``, remat) 3
   steps and "baseline" 2, each driven from 0 with launches per rank and
   step exact, ranks holding the same chunk bit-identical after each
   step, every rank the same metrics, each rank's state about a quarter
   of the whole, step ms, peak GiB and the "tp.*" / "fsdp.*" spans of the
   last step; world one (the optimized cell on a mesh of one) against
   ``build_train_step`` bit for bit, whose metrics the sharded bf16 steps
   are held to within TS_BF16_GATE, which a control (the column-parallel
   input's backward sum removed) fails; an f32 twin (1 layer, 2 x 128,
   random moments) against the unsharded f32 step within TS_TWIN_TOL;
   and the "optimized" prefill cell's batch against the unsharded
   prefill (logits within TS_PREFILL_TOL, the share of differing KV-cache
   codes).

The CPU-bound card-against-CPU checks run as ``chip_smoke.py --check
NAME`` subprocesses beside GPU-bound phases (``SUB_CHECKS``): phase 4's
chatglm3-6b checks beside serve_moe and serve_yi, the other families' beside
serve_families, serve_policy's and train's beside their own paths.

Every model here runs at ``attn_impl="flash"`` (attention through the
kernels), as the reference's serving cells do, but for the baseline
train cell and its f32 twin (the reference's cells: dense attention).  The line before the last
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


def _paged_case(torch, kspec, vspec, gen, d=128, hq=32, hkv=2):
    from repro_torch.core.pack import pack_codes
    from repro_torch.kernels.mx_quant import mx_quantize_2d
    b, page, npg = 8, 16, 36
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
        row = _time_paged_attention(
            torch, flush, (q32.to(torch.bfloat16), kc, ks, vc, vs, bt,
                           lengths), kspec, vspec, kv)
    emit("check", kernel="mx_paged_decode_attention", compared=n_checked,
         max_abs_err_bf16=worst[torch.bfloat16],
         max_abs_err_f32=worst[torch.float32],
         criterion=f"f32 within {ATTN_TOL_F32}; bf16 within torch's bf16 "
                   f"defaults")
    return dict(row, max_abs_err_f32=worst[torch.float32]), \
        worst[torch.bfloat16]


def _time_paged_attention(torch, flush, args, kspec, vspec, kv):
    """One timed row of the paged decode attention: the kernel by CUDA
    events and replayed from a graph, its plain version, SDPA over the
    dequantized gathered cache (the fastest backend), and the bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.mx_decode_attn import mx_paged_decode_attention
    q, kc, ks, vc, vs, bt, lengths = args
    b, _, hq, d = q.shape
    page, hkv = kc.shape[1], kc.shape[2]
    kw = dict(key_spec=kspec, value_spec=vspec, rep=hq // hkv)
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
               shape=f"{b} slots, lengths <= {int(lengths.max()) + 1}, "
                     f"page {page}, Hq {hq}, Hkv {hkv}, D {d}", spec=kv,
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
    return row


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
               shape=f"{b} rows, pos {pos} of S {s}, Hq {hq}, Hkv {hkv}, "
                     f"D {d}",
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
# phase 2, continued: the shapes of the rest of the GQA family
# =============================================================================
# K x N of moonshot-v1-16b-a3b's expert matmuls and of yi-34b's w1/w3
EXPERT_KN = {"expert w1/w3": (2048, 1408), "expert w2": (1408, 2048)}
YI_W1 = (7168, 20480)
# an expert's rows in a prefill of 8 x 512 tokens: 16 groups of 256, each
# expert's capacity int(256 * 6 / 64 * 1.25) = 30 per group
MOE_PREFILL_M = 16 * 30
N_EXPERTS = 64


def check_family_matmul(torch, flush):
    """B2 at moonshot's expert shapes through ``MXWeight.take`` views of a
    64-expert stack (bf16 activations, e4m3): M 1 (a decode step's
    capacity of one row) and M 480 (a prefill's), rows bit-identical
    across the two; one MoE layer's 64 w1 launches at M 1 replayed from a
    graph beside their byte bound (the launch cost of the expert loop);
    yi-34b's w1 (K 7168, N 20480) at M 8.  Each against its plain version
    and torch.matmul on the dequantized bf16 weight."""
    from repro_torch.core.mx_weight import MXWeight
    from repro_torch.core.spec import QuantSpec
    from repro_torch.kernels import ref
    from repro_torch.kernels.mx_matmul import mx_matmul_2d
    from repro_torch.kernels.ops import mx_matmul_resident
    gen = torch.Generator(device="cuda").manual_seed(21)
    spec = QuantSpec.parse("e4m3@32:ocp")
    rows, worst = [], 0.0
    for pname, (k, n) in EXPERT_KN.items():
        w = (torch.randn(N_EXPERTS, k, n, generator=gen, device="cuda")
             / math.sqrt(k)).to(torch.bfloat16)
        stack = MXWeight.quantize(w, spec)
        del w
        a = torch.randn(MOE_PREFILL_M, k, generator=gen,
                        device="cuda").to(torch.bfloat16)
        wi = stack.take(N_EXPERTS - 1)      # the last expert's views
        if wi.codes.data_ptr() != stack.codes.data_ptr() \
                + (N_EXPERTS - 1) * wi.codes.numel():
            raise AssertionError("MXWeight.take copied the expert")
        full = mx_matmul_2d(a, wi.codes, wi.scales, wi.spec)
        for lo, hi in ((0, 1), (29, 30), (30, 60), (479, 480)):
            part = mx_matmul_2d(a[lo:hi].contiguous(), wi.codes, wi.scales,
                                wi.spec)
            if not torch.equal(part, full[lo:hi]):
                raise AssertionError(f"mx_matmul {pname}: rows {lo}:{hi} "
                                     f"differ from the M=480 call")
        for m in (1, MOE_PREFILL_M):
            row = _matmul_row(torch, ref, mx_matmul_2d, a[:m].contiguous(),
                              wi, wi.codes, spec, pname, flush)
            rows.append(row)
            worst = max(worst, row["max_abs_err"])
        if pname == "expert w1/w3":
            # one MoE layer's w1 launches at a decode step: 64 experts,
            # one row each, as layers.moe issues them
            xe = torch.randn(N_EXPERTS, 1, k, generator=gen,
                             device="cuda").to(torch.bfloat16)

            def layer():
                return torch.stack([mx_matmul_resident(xe[i], stack.take(i))
                                    for i in range(N_EXPERTS)])

            def plain():
                return torch.stack([ref.mx_matmul_2d_ref(
                    xe[i], t.codes, t.scales, spec)
                    for i, t in enumerate(map(stack.take, range(N_EXPERTS)))])

            got, want = layer(), plain()
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            if not err <= MATMUL_TOL * scale:
                raise AssertionError(f"mx_matmul one MoE layer's w1: max "
                                     f"error {err} > {MATMUL_TOL} x {scale}")
            # the library yardstick: one batched product over the stack
            # dequantized to bf16 once
            wd = torch.stack([ref.dequant_ref(t.codes, t.scales, spec)
                              for t in map(stack.take, range(N_EXPERTS))]
                             ).to(torch.bfloat16)

            def library():
                return torch.matmul(xe, wd)

            tb, by = bound(stack.nbytes + xe.numel() * 2 + N_EXPERTS * n * 4,
                           2.0 * N_EXPERTS * n * k, BF16_FLOPS)
            row = dict(kernel="mx_matmul_2d",
                       shape=f"{N_EXPERTS} experts x {pname} M=1 (one MoE "
                             f"layer's w1 launches)", spec=str(spec),
                       launches=N_EXPERTS, max_abs_err=err,
                       ms=time_ms(torch, layer, flush=flush),
                       graph_ms=graph_ms(torch, layer, flush=flush),
                       plain_ms=time_ms(torch, plain, flush=flush),
                       library_ms=time_ms(torch, library, flush=flush),
                       library_graph_ms=graph_ms(torch, library,
                                                 flush=flush),
                       bound_ms=tb, bound_by=by)
            row["graph_us_per_launch"] = row["graph_ms"] * 1e3 / N_EXPERTS
            worst = max(worst, err)
            del wd
            emit("time", **row)
            rows.append(row)
        del stack
    k, n = YI_W1
    w = (torch.randn(k, n, generator=gen, device="cuda")
         / math.sqrt(k)).to(torch.bfloat16)
    mw = MXWeight.quantize(w, spec)
    del w
    a = torch.randn(8, k, generator=gen, device="cuda").to(torch.bfloat16)
    row = _matmul_row(torch, ref, mx_matmul_2d, a, mw, mw.codes, spec,
                      "yi-34b w1/w3", flush)
    rows.append(row)
    worst = max(worst, row["max_abs_err"])
    emit("check", kernel="mx_matmul_2d", what="the GQA family's shapes",
         compared=len(rows), max_abs_err=worst,
         criterion=f"max|kernel-plain| <= {MATMUL_TOL} * max|plain|; rows "
                   f"of M 1 / 30 slices equal the M=480 call's")
    return rows


def check_family_attention(torch, flush):
    """B3 and B4 at moonshot's GQA group of 1 (16 query heads over 16 KV
    heads: 15 of an m16 tile's 16 rows are padding) and yi-34b's 7 (56
    over 8), bf16 q, INT8 K / E2M1 V, D 128, against their plain
    versions, timed beside SDPA (the fastest backend)."""
    from repro_torch.core.spec import QuantSpec
    from repro_torch.kernels import ref
    from repro_torch.kernels.mx_decode_attn import (mx_decode_attention,
                                                    mx_paged_decode_attention)
    from repro_torch.kernels.mx_quant import mx_quantize_2d
    gen = torch.Generator(device="cuda").manual_seed(22)
    kv = "int8@32:ocp/e2m1@32:ocp"
    kspec, vspec = (QuantSpec.parse(x) for x in kv.split("/"))
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    rows = {"mx_paged_decode_attention": [], "mx_decode_attention": []}
    for hq, hkv in ((16, 16), (56, 8)):
        kw = dict(key_spec=kspec, value_spec=vspec, rep=hq // hkv)
        q32, kc, ks, vc, vs, bt, lengths = _paged_case(
            torch, kspec, vspec, gen, hq=hq, hkv=hkv)
        for q in (q32.to(torch.bfloat16), q32):
            args = (q, kc, ks, vc, vs, bt, lengths)
            _attn_check(torch, mx_paged_decode_attention(*args, **kw),
                        ref.mx_paged_decode_attention_ref(*args, **kw),
                        worst)
        rows["mx_paged_decode_attention"].append(_time_paged_attention(
            torch, flush, (q32.to(torch.bfloat16), kc, ks, vc, vs, bt,
                           lengths), kspec, vspec, kv))
        del kc, ks, vc, vs
        b, s, d = 8, 640, 128
        cache = []
        for spec in (kspec, vspec):
            x = torch.randn(b * s * hkv, d, generator=gen, device="cuda")
            c, sc = mx_quantize_2d(x, spec)
            cache += [c.reshape(b, s, hkv, d), sc.reshape(b, s, hkv, d // 32)]
        q = torch.randn(b, 1, hq, d, generator=gen, device="cuda").to(
            torch.bfloat16)
        for pos in (0, 63, 575, 639):
            lengths = torch.full((b,), pos, dtype=torch.int32, device="cuda")
            _attn_check(torch, mx_decode_attention(q, *cache, pos, **kw),
                        ref.mx_decode_attention_ref(q, *cache, lengths,
                                                    **kw), worst)
        rows["mx_decode_attention"].append(_time_decode_attention(
            torch, flush, q, cache, kw, kv, 575, s, mx_decode_attention,
            ref))
    emit("check", kernel="mx_paged_decode_attention / mx_decode_attention",
         what="GQA groups 1 and 7", compared=12,
         max_abs_err_bf16=worst[torch.bfloat16],
         max_abs_err_f32=worst[torch.float32],
         criterion=f"f32 within {ATTN_TOL_F32}; bf16 within torch's bf16 "
                   f"defaults")
    for r in rows.values():
        for row in r:
            row["max_abs_err"] = worst[torch.bfloat16]
    return rows


def check_family_kv_write(torch, flush):
    """The fused paged KV write at moonshot's 16 and yi-34b's 8 KV heads
    (8 slots, D 128, bf16, INT8 keys / packed E2M1 values, pages of 16),
    bit for bit against its plain version (the trash page left out),
    timed beside it and its byte bound."""
    from repro_torch.core.spec import QuantSpec
    from repro_torch.kernels import ref
    from repro_torch.kernels.mx_kv_write import mx_paged_kv_write
    gen = torch.Generator(device="cuda").manual_seed(23)
    kspec, vspec = QuantSpec.parse("int8@32:ocp"), QuantSpec.parse(
        "e2m1@32:ocp")
    b, page, npg, hd = 8, 16, 36, 128
    rows = []
    for n_kv in (16, 8):
        pool = {n: torch.randint(0, 256, (1 + b * npg, page, n_kv, w),
                                 generator=gen, device="cuda",
                                 dtype=torch.uint8)
                for n, w in (("kc_pages", kspec.storage_nbytes(hd)),
                             ("ks_pages", hd // 32),
                             ("vc_pages", vspec.storage_nbytes(hd)),
                             ("vs_pages", hd // 32))}
        bt = (1 + torch.randperm(b * npg, generator=gen, device="cuda")
              ).reshape(b, npg).to(torch.int32)
        lengths = torch.randint(0, npg * page, (b,), generator=gen,
                                device="cuda", dtype=torch.int32)
        k, v = (_kv_rand(torch, gen, (b, 1, n_kv, hd), torch.bfloat16, False)
                for _ in range(2))
        args = (pool, k, v, bt, lengths, kspec, vspec)
        plain = {n: t.clone() for n, t in pool.items()}
        mx_paged_kv_write(*args)
        ref.mx_paged_kv_write_ref(plain, *args[1:])
        for n in pool:
            if not torch.equal(pool[n][1:], plain[n][1:]):
                raise AssertionError(f"mx_paged_kv_write at Hkv {n_kv}: {n} "
                                     f"differs from the plain version")
        nbytes = (2 * k.numel() * k.element_size() + 2 * b * 4
                  + b * n_kv * (kspec.storage_nbytes(hd)
                                + vspec.storage_nbytes(hd) + 2 * hd // 32))
        tb, by = bound(nbytes, 2 * k.numel() * CONVERTER_OPS_PER_ELEMENT,
                       F32_CUDA_CORE_FLOPS)
        row = dict(kernel="mx_kv_write",
                   shape=f"paged decode write: 8 slots, Hkv {n_kv}, D 128, "
                         f"bf16", spec="int8@32:ocp/e2m1@32:ocp",
                   max_abs_err=0.0,
                   ms=time_ms(torch, lambda: mx_paged_kv_write(*args),
                              flush=flush),
                   graph_ms=graph_ms(torch, lambda: mx_paged_kv_write(*args),
                                     flush=flush),
                   plain_ms=time_ms(torch, lambda: ref.mx_paged_kv_write_ref(
                       *args), flush=flush),
                   bound_ms=tb, bound_by=by, library_ms=None)
        emit("time", **row)
        rows.append(row)
    emit("check", kernel="mx_kv_write", what="Hkv 16 and 8", compared=2,
         criterion="bit-identical pool bytes (page 0, the trash page, left "
                   "out)")
    return rows


def ptxas_usage(log: str, entry: str):
    """Registers and spill-store bytes that ``ptxas -v`` reported for the
    kernel whose mangled name holds ``entry``, from the build's log."""
    import re
    for chunk in log.split("Compiling entry function")[1:]:
        name = chunk.split("'")[1]
        if entry in name:
            regs = re.search(r"Used (\d+) registers", chunk)
            spill = re.search(r"(\d+) bytes spill stores", chunk)
            return (int(regs.group(1)) if regs else None,
                    int(spill.group(1)) if spill else 0)
    raise AssertionError(f"no ptxas report for {entry} in the build log")


def check_flash_head_dim_192(torch, flush):
    """Flash attention at head dim 192, which both builds run zero-padded
    to 256 (ROADMAP C5): 8 x 512 tokens, causal, 32 heads over 2 KV
    heads, f32 within 2e-5 and bf16 within 2e-2 of the plain version (a
    ragged causal case too); timed in both dtypes beside SDPA.  Neither
    D 256 build may spill registers (ptxas's report)."""
    import torch.nn.functional as F
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.flash_attn import flash_attention
    usage = {}
    for spec, entry in (("bfloat16", "flash_tc_kernelILi256"),
                        ("float32", "flash_fwd_kernelILi256")):
        regs, spill = ptxas_usage(build.build_log, entry)
        usage[spec] = {"registers": regs, "spill_store_bytes": spill}
        if spill:
            raise AssertionError(f"the {spec} flash build at D 256 spills "
                                 f"{spill} bytes ({regs} registers)")
    emit("flash_d256_registers", **usage)
    gen = torch.Generator(device="cuda").manual_seed(24)
    tols = {torch.float32: ATTN_TOL_F32, torch.bfloat16: FLASH_TOL_BF16}
    rate = {torch.float32: F32_CUDA_CORE_FLOPS, torch.bfloat16: BF16_FLOPS}
    h, hkv, d = 32, 2, 192
    rows = []
    for b, s in ((2, 77), (8, 512)):
        qkv = [torch.randn(b, s, nh, d, generator=gen, device="cuda")
               for nh in (h, hkv, hkv)]
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = (t.to(dt) for t in qkv)
            got = flash_attention(q, k, v)
            want = ref.flash_attention_ref(q, k, v, True)
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=tols[dt], atol=tols[dt])
            if s != 512:
                continue
            pairs = b * h * s * (s + 1) / 2
            nbytes = q.element_size() * (2 * q.numel() + k.numel()
                                         + v.numel())
            tb, by = bound(nbytes, 4.0 * pairs * d, rate[dt])
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            row = dict(kernel="flash_attention",
                       shape="8 x 512 tokens, causal, H 32, Hkv 2, D 192 "
                             "(the D 256 build)",
                       spec=str(dt).replace("torch.", ""),
                       max_abs_err=float((got.float() - want.float()).abs()
                                         .max()),
                       ms=time_ms(torch, lambda: flash_attention(q, k, v),
                                  flush=flush),
                       plain_ms=time_ms(torch, lambda: ref
                                        .flash_attention_ref(q, k, v, True),
                                        flush=flush),
                       library_ms=time_ms(torch, lambda: F
                                          .scaled_dot_product_attention(
                                              qt, kt, vt, is_causal=True,
                                              enable_gqa=True), flush=flush),
                       bound_ms=tb, bound_by=by, **usage[str(dt)[6:]])
            emit("time", **row)
            rows.append(row)
    emit("check", kernel="flash_attention", what="head dim 192", compared=4,
         criterion=f"|kernel - plain| <= tol + tol * |plain|, tol "
                   f"{ATTN_TOL_F32} (f32) / {FLASH_TOL_BF16} (bf16)")
    return rows


def check_family_shapes(torch, flush):
    """Every kernel of this slice's paths at its new shapes; rows keyed
    by the kernels line's names."""
    attn = check_family_attention(torch, flush)
    return {"mx_matmul_2d": check_family_matmul(torch, flush),
            "mx_kv_write": check_family_kv_write(torch, flush),
            "flash_attention": check_flash_head_dim_192(torch, flush),
            **attn}


# the other families' new kernel shapes (serve_families): internvl2-76b's
# w1 / w3, and MLA's compressed cache rows (c_kv 512, k_rope 64)
INTERNVL_W1 = (8192, 28672)
MLA_ROWS = {"c_kv": 512, "k_rope": 64}


def check_other_family_shapes(torch, flush):
    """The kernels at the shapes the other families give them: B4 at D 64
    with zamba2-1.2b's heads (32 over 32) and seamless-m4t-medium's (16
    over 16), bf16 q, INT8 K / E2M1 V, against the plain version and
    timed beside SDPA; B2 at internvl2-76b's w1 (K 8192, N 28672) at M 8;
    the converter on MLA's c_kv and k_rope rows (one decode step of 8,
    and a prefill of 8 x 512) bit for bit against the plain converter,
    timed; the fused contiguous KV write and flash attention at the
    heads of zamba2, seamless and internvl2.  Rows keyed by the kernels
    line's names."""
    from repro_torch.core.mx_weight import MXWeight
    from repro_torch.core.spec import QuantSpec
    from repro_torch.kernels import ref
    from repro_torch.kernels.mx_decode_attn import mx_decode_attention
    from repro_torch.kernels.mx_matmul import mx_matmul_2d
    from repro_torch.kernels.mx_quant import mx_quantize_2d
    gen = torch.Generator(device="cuda").manual_seed(24)
    kv = "int8@32:ocp/e2m1@32:ocp"
    kspec, vspec = (QuantSpec.parse(x) for x in kv.split("/"))
    rows = {"mx_decode_attention": [], "mx_matmul_2d": [],
            "mx_quantize_2d": []}
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    b, s, d = 8, 576, 64
    for hq in (32, 16):
        kw = dict(key_spec=kspec, value_spec=vspec, rep=1)
        cache = []
        for spec in (kspec, vspec):
            x = torch.randn(b * s * hq, d, generator=gen, device="cuda")
            c, sc = mx_quantize_2d(x, spec)
            cache += [c.reshape(b, s, hq, d), sc.reshape(b, s, hq, d // 32)]
        q32 = torch.randn(b, 1, hq, d, generator=gen, device="cuda")
        for q in (q32.to(torch.bfloat16), q32):
            for pos in (0, 63, 543, 575):
                lengths = torch.full((b,), pos, dtype=torch.int32,
                                     device="cuda")
                _attn_check(torch, mx_decode_attention(q, *cache, pos, **kw),
                            ref.mx_decode_attention_ref(q, *cache, lengths,
                                                        **kw), worst)
        rows["mx_decode_attention"].append(_time_decode_attention(
            torch, flush, q32.to(torch.bfloat16), cache, kw, kv, 543, s,
            mx_decode_attention, ref))
    for r in rows["mx_decode_attention"]:
        r["max_abs_err"] = worst[torch.bfloat16]
    emit("check", kernel="mx_decode_attention",
         what="D 64: Hq 32 / Hkv 32 and 16 / 16", compared=16,
         max_abs_err_bf16=worst[torch.bfloat16],
         max_abs_err_f32=worst[torch.float32],
         criterion=f"f32 within {ATTN_TOL_F32}; bf16 within torch's bf16 "
                   f"defaults")
    k, n = INTERNVL_W1
    spec = QuantSpec.parse("e4m3@32:ocp")
    w = (torch.randn(k, n, generator=gen, device="cuda")
         / math.sqrt(k)).to(torch.bfloat16)
    mw = MXWeight.quantize(w, spec)
    del w
    a = torch.randn(8, k, generator=gen, device="cuda").to(torch.bfloat16)
    rows["mx_matmul_2d"].append(_matmul_row(
        torch, ref, mx_matmul_2d, a, mw, mw.codes, spec,
        "internvl2-76b w1/w3", flush))
    del mw
    spec = QuantSpec.parse("int8@32:ocp")
    for name, width in MLA_ROWS.items():
        for m in (8, 8 * 512):
            x = torch.randn(m, width, generator=gen, device="cuda") * 0.5
            c, sc = mx_quantize_2d(x, spec)
            rc, rs = ref.mx_quantize_2d_ref(x, spec)
            if not (torch.equal(c, rc) and torch.equal(sc, rs)):
                raise AssertionError(f"converter on MLA {name} rows ({m} x "
                                     f"{width}): kernel differs from the "
                                     f"plain version")
            nel = x.numel()
            tb, by = bound(nel * (4 + 1 + 1 / 32),
                           nel * CONVERTER_OPS_PER_ELEMENT,
                           F32_CUDA_CORE_FLOPS)
            row = dict(kernel="mx_quantize_2d",
                       shape=f"MLA {name} cache write, {m} x {width}",
                       spec=str(spec), max_abs_err=0.0,
                       ms=time_ms(torch, lambda: mx_quantize_2d(x, spec),
                                  flush=flush),
                       graph_ms=graph_ms(torch, lambda: mx_quantize_2d(
                           x, spec), flush=flush),
                       plain_ms=time_ms(torch, lambda: ref.mx_quantize_2d_ref(
                           x, spec), flush=flush),
                       bound_ms=tb, bound_by=by, library_ms=None)
            emit("time", **row)
            rows["mx_quantize_2d"].append(row)
    emit("check", kernel="mx_quantize_2d", what="MLA c_kv / k_rope rows",
         compared=4, criterion="bit-identical codes and scales")
    rows["mx_kv_write"] = _other_kv_write_rows(torch, flush, gen, kspec,
                                               vspec)
    rows["flash_attention"] = _other_flash_rows(torch, flush, gen)
    return rows


# (Hq, Hkv, D) of the other families' attention: zamba2's shared block,
# seamless's decoder, internvl2's layers
OTHER_HEADS = {"zamba2-1.2b": (32, 32, 64), "seamless-m4t-medium":
               (16, 16, 64), "internvl2-76b": (64, 8, 128)}


def _other_kv_write_rows(torch, flush, gen, kspec, vspec):
    """The fused contiguous KV write of one decode step (8 rows, bf16,
    INT8 K / E2M1 V, one code per byte) at the other families' heads,
    at a host and a device position, bit for bit against its plain
    version, timed."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.mx_kv_write import mx_cache_kv_write
    b, s, pos = 8, 576, 543
    rows = []
    for name, (_, hkv, d) in OTHER_HEADS.items():
        cache = {n: torch.randint(0, 256, (b, s, hkv, w), generator=gen,
                                  device="cuda", dtype=torch.uint8)
                 for n, w in (("k_codes", d), ("k_scales", d // 32),
                              ("v_codes", d), ("v_scales", d // 32))}
        k, v = (_kv_rand(torch, gen, (b, 1, hkv, d), torch.bfloat16, False)
                for _ in range(2))
        plain = {n: t.clone() for n, t in cache.items()}
        ref.mx_cache_kv_write_ref(plain, k, v, pos, kspec, vspec)
        pos_d = torch.tensor([pos], dtype=torch.int32, device="cuda")
        for at in (pos, pos_d):
            mx_cache_kv_write(cache, k, v, at, kspec, vspec)
            if not all(torch.equal(cache[n], plain[n]) for n in cache):
                raise AssertionError(f"mx_cache_kv_write at {name}'s heads: "
                                     f"the cache differs from the plain "
                                     f"version")
        nbytes = 2 * k.numel() * 2 + 2 * b * hkv * (d + d // 32)
        tb, by = bound(nbytes, 2 * k.numel() * CONVERTER_OPS_PER_ELEMENT,
                       F32_CUDA_CORE_FLOPS)

        def write():
            return mx_cache_kv_write(cache, k, v, pos_d, kspec, vspec)

        row = dict(kernel="mx_kv_write",
                   shape=f"contiguous decode write ({name}): 8 rows, Hkv "
                         f"{hkv}, D {d}, bf16",
                   spec="int8@32:ocp/e2m1@32:ocp", max_abs_err=0.0,
                   ms=time_ms(torch, write, flush=flush),
                   graph_ms=graph_ms(torch, write, flush=flush),
                   plain_ms=time_ms(torch, lambda: ref.mx_cache_kv_write_ref(
                       plain, k, v, pos, kspec, vspec), flush=flush),
                   bound_ms=tb, bound_by=by, library_ms=None)
        emit("time", **row)
        rows.append(row)
    emit("check", kernel="mx_kv_write", what="the other families' heads",
         compared=6, criterion="bit-identical cache bytes, host and device "
                               "position")
    return rows


# the other families' flash shapes (name, positions): each of
# OTHER_HEADS at 8 x 512, and internvl2's training step, whose 256 patch
# embeddings go before its 512 tokens
OTHER_FLASH = tuple((name, 512) for name in OTHER_HEADS) + (
    ("internvl2-76b", 768),)


def _flash_row(torch, flush, gen, b, s, h, hkv, d, label):
    """Flash attention at b sequences of s positions, causal, bf16, with
    H ``h``, Hkv ``hkv`` and D ``d``, against its plain version within the
    bf16 tolerance, timed beside SDPA and its bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attn import flash_attention
    q, k, v = (torch.randn(b, s, nh, d, generator=gen, device="cuda")
               .to(torch.bfloat16) for nh in (h, hkv, hkv))
    got = flash_attention(q, k, v)
    want = ref.flash_attention_ref(q, k, v, True)
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=FLASH_TOL_BF16, atol=FLASH_TOL_BF16)
    err = float((got.float() - want.float()).abs().max())
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    tb, by = bound(nbytes, 4.0 * b * h * s * (s + 1) / 2 * d, BF16_FLOPS)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    row = dict(kernel="flash_attention",
               shape=f"{b} x {s} tokens, causal ({label}): H {h}, Hkv "
                     f"{hkv}, D {d}", spec="bfloat16", max_abs_err=err,
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
    return row


def _other_flash_rows(torch, flush, gen):
    """Flash attention at the other families' prefill and training
    shapes (OTHER_FLASH: 8 sequences, causal, bf16), against its plain
    version within the bf16 tolerance, timed beside SDPA."""
    rows = [_flash_row(torch, flush, gen, 8, s, *OTHER_HEADS[name], name)
            for name, s in OTHER_FLASH]
    emit("check", kernel="flash_attention", what="the other families' "
         "prefill and training shapes", compared=len(OTHER_FLASH),
         max_abs_err_bf16=max(r["max_abs_err"] for r in rows),
         criterion=f"|kernel - plain| <= tol + tol * |plain|, tol "
                   f"{FLASH_TOL_BF16} (bf16)")
    return rows


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
    """Run ``fn`` as a main path: every launch count (and per-spec count,
    ``_spec_launches``) set to 0 just before, read just after.  Returns
    (fn's result, launches, wall seconds)."""
    counters = _counters()
    for fns in counters.values():
        for c in fns:
            c.launches = 0
            if hasattr(c, "launches_by_spec"):
                c.launches_by_spec.clear()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, {name: sum(c.launches for c in fns)
                 for name, fns in counters.items()}, wall


def _spec_key(k) -> str:
    """A per-spec count's key as text: ``e2m1@32:ocp``, or ``key/value``
    for the paged attention's pair.  Packing is left out: an 8-bit
    weight's spec says unpacked where its policy's says packed, and the
    port packs every sub-byte weight and page."""
    if isinstance(k, tuple):
        return "/".join(map(_spec_key, k))
    return f"{k.fmt}@{k.block}:{k.mode}"


def _spec_launches(counts=None):
    """The MX matmul's and the paged decode attention's launches by spec,
    as counted where they launch since the last ``_drive`` zeroed them
    (or, given ``counts``, a captured step's ``spec_launches``: one
    replay's)."""
    from repro_torch.kernels.mx_decode_attn import mx_paged_decode_attention
    from repro_torch.kernels.mx_matmul import mx_matmul_2d
    out = {}
    for w in (mx_matmul_2d, mx_paged_decode_attention):
        by = w.launches_by_spec if counts is None else counts.get(w, {})
        out[w.__name__] = {_spec_key(k): n for k, n in sorted(
            by.items(), key=lambda kv: _spec_key(kv[0]))}
    return out


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


def graph_kernel_names(graph) -> list:
    """The kernel of every kernel node of a captured CUDA graph (kept
    with ``keep_graph=True``): what one replay launches, read through the
    driver API (``cuGraphGetNodes``, ``cuGraphKernelNodeGetParams``,
    ``cuFuncGetName`` / ``cuKernelGetName``)."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    vp = ctypes.c_void_p

    class Params(ctypes.Structure):         # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", vp)] + [(f, ctypes.c_uint) for f in (
            "gx", "gy", "gz", "bx", "by", "bz", "smem")] + [
            ("kernel_params", vp), ("extra", vp), ("kern", vp),
            ("ctx", vp)]

    def check(rc, what):
        if rc != 0:
            raise AssertionError(f"{what} failed with CUresult {rc}")

    def walk(g, out):
        n = ctypes.c_size_t(0)
        check(cu.cuGraphGetNodes(vp(g), None, ctypes.byref(n)),
              "cuGraphGetNodes")
        nodes = (vp * n.value)()
        check(cu.cuGraphGetNodes(vp(g), nodes, ctypes.byref(n)),
              "cuGraphGetNodes")
        for node in nodes:
            kind = ctypes.c_int(-1)
            check(cu.cuGraphNodeGetType(vp(node), ctypes.byref(kind)),
                  "cuGraphNodeGetType")
            if kind.value == 5:                 # CU_GRAPH_NODE_TYPE_GRAPH
                child = vp()
                check(cu.cuGraphChildGraphNodeGetGraph(
                    vp(node), ctypes.byref(child)), "child graph")
                walk(child.value, out)
            if kind.value != 0:                 # CU_GRAPH_NODE_TYPE_KERNEL
                continue
            prm = Params()
            check(cu.cuGraphKernelNodeGetParams_v2(vp(node),
                                                   ctypes.byref(prm)),
                  "cuGraphKernelNodeGetParams")
            name = ctypes.c_char_p()
            rc = (cu.cuKernelGetName(ctypes.byref(name), vp(prm.kern))
                  if prm.kern else 1)
            if rc != 0:
                check(cu.cuFuncGetName(ctypes.byref(name), vp(prm.func)),
                      "cuFuncGetName")
            out.append(name.value.decode())
        return out

    return walk(graph.raw_cuda_graph(), [])


# small kernels launched inside each profile before the replay: late in
# a long process the profiler has lost the first ~10 kernel records of a
# profiled replay (PERF.md), once the first B2 launch among them
PROFILE_WARMUP_KERNELS = 32


def check_replay(torch, path, step, want, replay=None):
    """The launches one replay of a captured step credits
    (``CapturedStep.launches``) are ``want`` per wrapper; the captured
    graph holds exactly that many kernel nodes of each family; and
    ``torch.profiler`` over one replay (``replay``, by default ``step``
    itself) sees the device run exactly that many kernels of each
    family.  The profiler can drop activity records (graphs of the same
    nodes have shown a few device events more or fewer), so a replay
    whose profile falls short is profiled once more; the miss is kept in
    the printed row, and a second miss fails.  Each profile launches
    PROFILE_WARMUP_KERNELS small kernels of no family before the replay,
    so that the records the profiler loses at its start are theirs."""
    credited = {w.__name__: n for w, n in step.launches.items()}
    if credited != want:
        raise AssertionError(f"{path}: one replay credits {credited}, "
                             f"expected {want}")
    nodes = graph_kernel_names(step.graph)
    in_graph, expect = {}, {}
    for fam, (wrappers, kernels) in KERNEL_FAMILIES.items():
        in_graph[fam] = sum(any(k in n for k in kernels) for n in nodes)
        expect[fam] = sum(credited.get(w, 0) for w in wrappers)
    if in_graph != expect:
        raise AssertionError(f"{path}: the captured graph holds {in_graph} "
                             f"kernel nodes, the wrappers credit {expect}")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    misses = []
    warm = torch.zeros(1, device="cuda")
    for _ in range(2):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(PROFILE_WARMUP_KERNELS):
                warm.add_(1)
            torch.cuda.synchronize()
            (replay or step)()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        names = [e.name for e in events]
        seen = {fam: sum(any(k in n for k in kernels) for n in names)
                for fam, (_, kernels) in KERNEL_FAMILIES.items()}
        if seen == expect:
            break
        misses.append(dict(profiled_kernels=seen, device_kernels=len(names),
                           first_kernels=[n[:60] for n in names[:12]]))
    else:
        raise AssertionError(f"{path}: the profiler saw {misses} kernels "
                             f"in two replays, the wrappers credit "
                             f"{expect}")
    emit("replay_check", path=path, launches_per_replay=credited,
         graph_kernel_nodes=in_graph, graph_nodes=len(nodes),
         profiled_kernels=seen, device_kernels=len(names),
         warmup_kernels=PROFILE_WARMUP_KERNELS, profiler_misses=misses)


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




def _continuous_prompts(vocab):
    """The continuous phase's 16 prompts of 64-512 tokens (seed 0), and
    the generator that drew them (the phase draws on from it)."""
    import numpy as np
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 513, size=16)
    return [rng.integers(0, vocab, size=int(n)).astype(np.int32)
            for n in lens], rng


def serve_full_width(torch):
    import numpy as np
    from repro_torch.launch.serve import build_model
    from repro_torch.serve import ContinuousBatchingEngine, GenerationConfig
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
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
    prompts, rng = _continuous_prompts(cfg.vocab)
    lens = [len(p) for p in prompts]
    new = 64
    t0 = time.perf_counter()
    eng = ContinuousBatchingEngine(       # captures the decode step
        model, params, max_slots=8, page_size=16,
        max_len=max(lens) + new + 1, sync_every=8, prefill_bucket=64)
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
    emit("serve_family", path="chatglm3-6b peak memory", config=cfg.name,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         weight_bytes=_weight_bytes(params))
    del params, model
    _free(torch)
    # the kernels line counts the continuous run's and the fault drill's
    # launches (each a main path of its own, driven from 0)
    launches = {k: n + drill.get(k, 0) for k, n in launches.items()}
    return {**launches, **static,
            "mx_quantize_2d": load["mx_quantize_2d"],
            "mx_kv_write_tokens": tokens_launches}


def launches_per_pass(cfg, per_stack: int) -> int:
    """Launches of one pass over the layers' matmul weights: one per
    weight of a dense layer (7) and of an MoE layer's attention (4) and
    shared experts (3), and ``per_stack`` for each of an MoE layer's 3
    expert stacks."""
    moe = 4 + 3 * per_stack + (3 if cfg.n_shared_experts else 0)
    return sum(moe if cfg.moe_layer(i) else 7 for i in range(cfg.n_layers))


def matmuls_per_pass(cfg) -> int:
    """B2 launches of one decode step or prefill batch: ``layers.moe``
    launches every expert, whatever its load."""
    return launches_per_pass(cfg, cfg.n_experts)


def check_graph_window(torch, model, params, prompts, temperature,
                       bucket=64, path="continuous"):
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
        sync_every=8, prefill_bucket=bucket,
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
    emit("graph_vs_eager", path=path, temperature=temperature,
         steps=window, eager_s=t1 - t0, graph_step_s=t2 - t1, **same)
    if temperature == 0.0:
        # a window of one step: run() resets the step's token index
        check_replay(torch, f"{path} decode step", w.step, {
            "mx_matmul_2d": matmuls_per_pass(model.cfg),
            "mx_paged_kv_write": n_l, "mx_paged_decode_attention": n_l},
            replay=lambda: w.run(1))


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
# phase 3, continued: the rest of the GQA family at full width
# =============================================================================
MOE_ARCH = "moonshot_v1_16b_a3b"
# moonshot-v1-16b-a3b's depth in serve_moe: cut to 8 of 48 layers (the
# dense one and 7 MoE layers) for the clock (PERF.md §4)
MOE_LAYERS = 8
# B2 launches per decode step (one dense layer of 7, MoE layers of 4 + 3
# x 64 + 3): 9,360 at 48 layers, the prediction written before the first
# run of serve_moe
MOE_MATMULS_PER_STEP = 7 + (MOE_LAYERS - 1) * (4 + 3 * 64 + 3)
# prefill buckets of 256 tokens: a prefill batch of G prompts x bucket is
# then always a multiple of the MoE dispatch group of 256 tokens, where
# the reference's x.reshape(g, gs, d) (and the port's moe) refuses
# anything past 256 that is no multiple of it (ROADMAP C8)
MOE_BUCKET = 256


def _load(torch, arch, **over):
    """Build a full-width config with weight-resident e4m3 weights as a
    driven path (the peak memory counter reset first); check the
    converter's launches and emit the setup row."""
    from repro_torch.launch.serve import build_model
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    (model, params), load, load_s = _drive(torch, lambda: build_model(
        arch, reduced=False, quant=POLICY, weight_resident=True,
        device="cuda", seed=0, attn_impl="flash", **over))
    cfg = model.cfg
    # one converter launch per matmul weight; an expert stack is one
    # (E, K, N) launch
    _check_launches(f"{arch} load", load,
                    {"mx_quantize_2d": launches_per_pass(cfg, 1)})
    emit("serve_setup", config=cfg.name, layers=cfg.n_layers,
         d_model=cfg.d_model, d_ff=cfg.d_ff, n_experts=cfg.n_experts,
         moe_d_ff=cfg.moe_d_ff, vocab=cfg.vocab, policy=str(cfg.mx),
         build_s=load_s, launches=load,
         weight_bytes=_weight_bytes(params),
         device_mem_gib=torch.cuda.memory_allocated() / 2 ** 30)
    return model, params


def _free(torch) -> None:
    """Return a dropped model's memory to the card: a dropped engine's
    captured step is a reference cycle that holds the weights until the
    cyclic collector runs."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def _weight_bytes(params) -> int:
    from repro_torch.core.mx_weight import params_nbytes
    return params_nbytes(params)


def _continuous_run(torch, path, model, params, prompts, new, bucket,
                    temperature=0.0):
    """One driven run of the continuous engine (8 slots, pages of 16,
    ``sync_every`` 8), every decode step a replay; launches checked
    against the engine's steps and prefill batches; one result row."""
    from repro_torch.serve import ContinuousBatchingEngine, GenerationConfig
    cfg, n_l = model.cfg, model.cfg.n_layers
    t0 = time.perf_counter()
    eng = ContinuousBatchingEngine(
        model, params, max_slots=8, page_size=16,
        max_len=max(map(len, prompts)) + new + 1, sync_every=8,
        prefill_bucket=bucket,
        gen=GenerationConfig(temperature=temperature, seed=3))
    capture_s = time.perf_counter() - t0
    outs, launches, wall = _drive(torch, lambda: _serve(eng, prompts, new))
    ph = eng.phase
    steps, batches = eng.n_steps, eng.n_prefill_batches
    _check_launches(path, launches, {
        "mx_matmul_2d": matmuls_per_pass(cfg) * (steps + batches),
        "mx_kv_write": n_l * (steps + batches),
        "mx_paged_decode_attention": n_l * steps})
    if eng.n_quarantined or eng.scheduler.failed:
        raise AssertionError(f"{path}: a healthy request was quarantined")
    for p, o in zip(prompts, outs):
        if len(o) != new or o.min() < 0 or o.max() >= cfg.vocab:
            raise AssertionError(f"{path}: bad output for a {len(p)}-token "
                                 f"prompt")
    emit("serve_family", path=path, config=cfg.name,
         temperature=temperature, requests=len(prompts), new_tokens=new,
         prefill_bucket=bucket, wall_s=wall, prefill_s=ph["prefill"],
         decode_s=ph["decode"], host_sync_s=ph["sync"],
         decode_tokens_per_s=(eng.n_generated - len(prompts)) / ph["decode"],
         decode_steps=steps, step_wall_ms=ph["decode"] / steps * 1e3,
         windows=eng.n_syncs, prefill_batches=batches,
         graph_capture_s=capture_s, launches=launches,
         matmuls_per_step=matmuls_per_pass(cfg),
         kv_pool_nbytes=eng.kv_pool_nbytes,
         weight_pool_nbytes=eng.weight_pool_nbytes,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del eng
    return [o.tolist() for o in outs], launches


def _family_prompts(vocab, seed, n, lo, hi):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(m)).astype(np.int32)
            for m in rng.integers(lo, hi, size=n)]


def _static_moe(torch, model, params, new):
    """``ServeEngine`` over the MX KV cache on the MoE weights: 8 prompts
    of 512 tokens (16 dispatch groups), greedy; the first call captures
    the decode step, the second, driven, replays it once per token
    (launches counted per replay) and must give the eager loop's tokens;
    one replay's launches are confirmed in the captured graph and by the
    profiler."""
    import numpy as np
    from repro_torch.serve import GenerationConfig, ServeEngine
    cfg, n_l = model.cfg, model.cfg.n_layers
    b, s = 8, 512
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab, size=(b, s)).astype(np.int32)
    gen = GenerationConfig(max_new_tokens=new)
    eng = ServeEngine(model, params, max_len=s + new + 8)
    eng.generate({"tokens": tokens}, gen)               # captures the step
    out, launches, wall = _drive(
        torch, lambda: eng.generate({"tokens": tokens}, gen))
    if eng.n_captures != 1:
        raise AssertionError(f"static MoE serving captured "
                             f"{eng.n_captures} decode steps")
    _check_launches("static MoE serving", launches, {
        "mx_matmul_2d": matmuls_per_pass(cfg) * new,
        "mx_kv_write": n_l * new, "mx_decode_attention": n_l * (new - 1)})
    ph = eng.phase
    emit("serve_family", path="static MoE, MX KV", config=cfg.name,
         batch=b, prompt_len=s, new_tokens=new, wall_s=wall,
         prefill_s=ph["prefill"], decode_s=ph["decode"],
         decode_tokens_per_s=b * (new - 1) / ph["decode"],
         step_wall_ms=ph["decode"] / (new - 1) * 1e3,
         kv_cache_nbytes=eng.kv_cache_nbytes, launches=launches,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    t0 = time.perf_counter()
    eager = _static_eager(torch, model, params, tokens, new, s + new + 8)
    eager_s = time.perf_counter() - t0
    if not np.array_equal(out, eager):
        raise AssertionError("static MoE serving: graph and eager decode "
                             "loops give other tokens")
    emit("graph_vs_eager", path="static MoE, MX KV", steps=new - 1,
         eager_s=eager_s, graph_decode_s=ph["decode"], tokens=True)
    check_replay(torch, "static MoE decode step", eng._graphs[(b, 0.0)].step,
                 {"mx_matmul_2d": matmuls_per_pass(cfg),
                  "mx_cache_kv_write": n_l, "mx_decode_attention": n_l})
    del eng
    torch.cuda.empty_cache()
    return out, launches


def serve_moe(torch):
    """Full-width moonshot-v1-16b-a3b (MOE_LAYERS of its 48 layers: one
    dense, the rest of 64
    experts of d_ff 1408, top-6, 2 shared; random weights from a seed,
    e4m3 as each layer is made; INT8 K / E2M1 V pages) through the
    continuous engine, greedy and at T 0.8, with prefill buckets of 256;
    one replayed window against the eager loop (greedy) and one replay's
    launches (the predicted B2 count) confirmed by the profiler; then ``ServeEngine`` over the MX KV cache on the same
    weights.  ``sync_every`` 1 against 8 is not checked: at capacity 1.25
    the JAX engine does not keep that identity (a finished slot's frozen
    token still routes), tests/test_torch_archs_serve.py."""
    model, params = _load(torch, MOE_ARCH, n_layers=MOE_LAYERS)
    cfg = model.cfg
    if matmuls_per_pass(cfg) != MOE_MATMULS_PER_STEP:
        raise AssertionError(f"{matmuls_per_pass(cfg)} B2 launches per "
                             f"step, predicted {MOE_MATMULS_PER_STEP}")
    prompts = _family_prompts(cfg.vocab, 10, 16, 64, 513)
    new = 32
    launches = {}
    for temperature in (0.0, 0.8):
        _, got = _continuous_run(torch, "continuous MoE", model, params,
                                 prompts, new, MOE_BUCKET, temperature)
        if temperature == 0.0:
            launches = dict(got)        # the emitted row keeps its own
    short = _family_prompts(cfg.vocab, 11, 8, 64, 257)
    check_graph_window(torch, model, params, short, 0.0, bucket=MOE_BUCKET,
                       path="continuous MoE")
    _, static = _static_moe(torch, model, params, 8)
    emit("serve_family", path="moonshot peak memory", config=cfg.name,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         weight_bytes=_weight_bytes(params))
    del params, model
    _free(torch)
    launches["mx_decode_attention"] = static["mx_decode_attention"]
    return launches


YI_LAYERS = 30          # yi-34b cut to 30 of 60 layers for the clock
#                         (PERF.md §4)


def serve_yi(torch):
    """Full-width yi-34b (YI_LAYERS of 60 layers, d 7168, 56 heads over 8
    KV heads,
    d_ff 20480; random weights from a seed, e4m3 as each layer is made)
    through the continuous engine, greedy; one replayed window against
    the eager loop and one replay's launches confirmed by the
    profiler."""
    model, params = _load(torch, "yi_34b", n_layers=YI_LAYERS)
    cfg = model.cfg
    prompts = _family_prompts(cfg.vocab, 12, 16, 64, 513)
    _, launches = _continuous_run(torch, "continuous yi-34b", model, params,
                                  prompts, 32, 64)
    short = _family_prompts(cfg.vocab, 13, 8, 64, 257)
    check_graph_window(torch, model, params, short, 0.0,
                       path="continuous yi-34b")
    emit("serve_family", path="yi-34b peak memory", config=cfg.name,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         weight_bytes=_weight_bytes(params))
    del params, model
    _free(torch)
    return launches


# =============================================================================
# serve_families: MLA, the patch frontend, the hybrid, RWKV6, enc-dec
# =============================================================================
KV_POLICY = "kv_key=int8@32:ocp,kv_value=e2m1@32:ocp"
# (arch, depth overrides, weight-resident e4m3): published widths, depth
# cut only where named
SERVE_FAMILIES = (
    ("deepseek_v2_236b", {"n_layers": 4}, False),   # layer 0 dense + 3 MoE
    ("internvl2_76b", {"n_layers": 20}, True),
    ("zamba2_1p2b", {}, False),
    ("rwkv6_7b", {}, False),
    ("seamless_m4t_medium", {}, False),
)
FAMILY_BATCH, FAMILY_POSITIONS, FAMILY_NEW = 8, 512, 32
# the prediction written before the first run of serve_families: what one
# replay of each config's captured decode step launches under the MX KV
# cache (by wrapper); a prefill launches the same but for decode
# attention.  internvl2: 7 B2, one fused KV write and one B4 per layer;
# zamba2: one KV write and one B4 per site of its shared attention;
# seamless: the same per decoder layer (cross-attention is plain);
# deepseek-v2: the converter on c_kv and on k_rope per layer; rwkv: none
FAMILY_STEP_LAUNCHES = {
    "deepseek_v2_236b": {"mx_quantize_2d": 8},
    "internvl2_76b": {"mx_matmul_2d": 140, "mx_cache_kv_write": 20,
                      "mx_decode_attention": 20},
    "zamba2_1p2b": {"mx_cache_kv_write": 19, "mx_decode_attention": 19},
    "rwkv6_7b": {},
    "seamless_m4t_medium": {"mx_cache_kv_write": 12,
                            "mx_decode_attention": 12},
}
# flash launches per bf16-KV prefill: one per causal self-attention layer
FAMILY_FLASH_PER_PREFILL = {"deepseek_v2_236b": 0, "internvl2_76b": 20,
                            "zamba2_1p2b": 19, "seamless_m4t_medium": 12}
# kernels line name of each wrapper
WRAPPER_KERNEL = {"mx_quantize_2d": "mx_quantize_2d",
                  "mx_matmul_2d": "mx_matmul_2d",
                  "mx_cache_kv_write": "mx_kv_write",
                  "mx_decode_attention": "mx_decode_attention",
                  "flash_attention": "flash_attention"}
CARD = ""       # nvidia-smi's name and power limit, set by main


def _family_batch(cfg, b, positions, seed):
    """The family's batch of ``positions`` per row: tokens; or the patch
    frontend's prefix embeddings and the rest in tokens; or, for the
    encoder-decoder, ``positions`` frames and as many decoder tokens."""
    from repro_torch.models import make_concrete_batch
    s = 2 * positions if cfg.family == "encdec" else positions
    batch = make_concrete_batch(cfg, b, s, seed=seed)
    batch.pop("labels")
    return batch


def _n_positions(batch) -> int:
    pe = batch.get("prefix_embeds")
    return batch["tokens"].shape[1] + (0 if pe is None else pe.shape[1])


def _family_eager(torch, model, params, batch, new, max_len):
    """The static decode loop, eagerly: prefill of the batch dict, then
    ``decode_step`` at host positions with greedy sampling."""
    import numpy as np
    vocab = model.cfg.vocab
    logits, cache, pos = model.prefill(params, batch, max_len=max_len)
    tok = torch.argmax(logits[:, -1, :vocab], -1).to(torch.int32)
    out = [tok]
    del logits
    for i in range(new - 1):
        lg, cache = model.decode_step(params, tok, cache, pos + i)
        tok = torch.argmax(lg[:, -1, :vocab], -1).to(torch.int32)
        out.append(tok)
    return np.asarray(torch.stack(out, dim=1).cpu())


def _family_flips(torch, model, params, batch, got, want, tol=LOGITS_TOL):
    """``_flips`` over a family's batch: row r's streams may differ only
    from a step where the logits that chose the token (traced through
    ``model`` on ``want``'s context, the row's frames or prefix kept)
    have a top-2 gap below ``tol``."""
    import numpy as np
    vocab = model.cfg.vocab
    flips = []
    for r, (a, b) in enumerate(zip(got, want)):
        a, b = list(a), list(b)
        if a == b:
            continue
        i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        row = {k: v[r:r + 1] for k, v in batch.items()}
        row["tokens"] = np.concatenate(
            [row["tokens"], np.asarray([b[:i]], np.int32)], axis=1)
        lg, _, _ = model.prefill(params, row,
                                 max_len=_n_positions(row))
        top2 = torch.topk(lg[0, -1, :vocab], 2).values
        gap = float(top2[0] - top2[1])
        if gap >= tol:
            raise AssertionError(f"tokens differ at step {i} with a top-2 "
                                 f"logit gap of {gap}")
        flips.append({"row": r, "step": i, "top2_gap": gap})
    return flips


def _family_static(torch, arch, name, model, params, batch, per_step,
                   prefill):
    """One static run of a family: ``ServeEngine``'s first call captures
    the decode step, the second, driven, replays it once per token; its
    launches must be ``per_step`` x (new - 1) + ``prefill`` exactly, its
    tokens the eager loop's, and one replay's launches are confirmed in
    the graph and by the profiler.  Returns (tokens, launches by
    kernel)."""
    import numpy as np
    from repro_torch.serve import GenerationConfig, ServeEngine
    cfg, new = model.cfg, FAMILY_NEW
    max_len = _n_positions(batch) + new + 8
    gen = GenerationConfig(max_new_tokens=new)
    eng = ServeEngine(model, params, max_len=max_len)
    eng.generate(batch, gen)                        # captures the step
    out, launches, wall = _drive(torch, lambda: eng.generate(batch, gen))
    path = f"{arch} static, {name}"
    if eng.n_captures != 1:
        raise AssertionError(f"{path}: captured {eng.n_captures} steps")
    want = {}
    for w, n in per_step.items():
        k = WRAPPER_KERNEL[w]
        want[k] = want.get(k, 0) + n * (new - 1)
    for w, n in prefill.items():
        k = WRAPPER_KERNEL[w]
        want[k] = want.get(k, 0) + n
    _check_launches(path, launches, want)
    if out.shape != (FAMILY_BATCH, new) or out.min() < 0 \
            or out.max() >= cfg.vocab:
        raise AssertionError(f"{path}: bad output")
    ph = eng.phase
    emit("serve_families", path=path, config=cfg.name, kv=name,
         layers=cfg.n_layers, batch=FAMILY_BATCH,
         positions=_n_positions(batch), new_tokens=new, wall_s=wall,
         prefill_s=ph["prefill"], decode_s=ph["decode"],
         decode_tokens_per_s=FAMILY_BATCH * (new - 1) / ph["decode"],
         step_wall_ms=ph["decode"] / (new - 1) * 1e3,
         kv_cache_nbytes=eng.kv_cache_nbytes,
         weight_pool_nbytes=eng.weight_pool_nbytes, launches=launches,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         card=CARD)
    t0 = time.perf_counter()
    eager = _family_eager(torch, model, params, batch, new, max_len)
    eager_s = time.perf_counter() - t0
    if not np.array_equal(out, eager):
        raise AssertionError(f"{path}: graph and eager decode loops give "
                             f"other tokens")
    emit("graph_vs_eager", path=path, steps=new - 1, eager_s=eager_s,
         graph_decode_s=ph["decode"], tokens=True)
    graph = next(iter(eng._graphs.values()))
    check_replay(torch, f"{path} decode step", graph.step, per_step)
    del eng, graph
    _free(torch)
    return out, launches


def _family_load(torch, arch, over, resident, **kw):
    """Full-width ``arch`` (depth cut by ``over``) with random weights
    from seed 0, under INT8 K / E2M1 V (and weight-resident e4m3 where
    ``resident``), as a driven path: the converter's launches at load
    are 7 per layer where resident, else 0."""
    from repro_torch.launch.serve import build_model
    quant = ("weights=e4m3@32:ocp," if resident else "") + KV_POLICY
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    (model, params), load, load_s = _drive(torch, lambda: build_model(
        arch, reduced=False, quant=quant, weight_resident=resident,
        device="cuda", seed=0, attn_impl="flash", **over, **kw))
    cfg = model.cfg
    _check_launches(f"{arch} load", load, {
        "mx_quantize_2d": 7 * cfg.n_layers if resident else 0})
    emit("serve_setup", config=cfg.name, layers=cfg.n_layers,
         d_model=cfg.d_model, family=cfg.family, policy=str(cfg.mx),
         build_s=load_s, launches=load, weight_bytes=_weight_bytes(params),
         device_mem_gib=torch.cuda.memory_allocated() / 2 ** 30, card=CARD)
    return model, params


def serve_families(torch):
    """Each of the other families at its published width (depth cut only
    where ``SERVE_FAMILIES`` names it), random weights from a seed,
    through ``ServeEngine``: 8 rows of 512 positions (internvl2: 256 patch
    embeddings + 256 tokens; seamless: 512 frames + 512 decoder tokens),
    32 new tokens, greedy, over the MX KV cache (MLA's compressed cache
    under ``kv_key``) and, where the family attends, over a bf16 cache
    (flash prefill).  Each decode step is a replay of the captured graph,
    with the eager loop's tokens and exactly the predicted launches; each
    model is freed before the next loads.  ``families_card_vs_cpu`` runs
    in a subprocess beside it (most of its time on the CPU).  Returns the
    launches of every driven run by kernel."""
    import tempfile
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        check = _sub_check("families_card_vs_cpu", Path(d))
        try:
            total = _serve_families_runs(torch)
            check()
        finally:
            check.stop()
    return total


def _serve_families_runs(torch):
    import dataclasses
    from repro_torch.core.spec import QuantPolicy
    from repro_torch.models import Model
    total = {}
    for seed, (arch, over, resident) in enumerate(SERVE_FAMILIES):
        model, params = _family_load(torch, arch, over, resident)
        cfg = model.cfg
        batch = _family_batch(cfg, FAMILY_BATCH, FAMILY_POSITIONS, 30 + seed)
        step = FAMILY_STEP_LAUNCHES[arch]
        runs = [("mx_kv", model, step,
                 {w: n for w, n in step.items()
                  if w != "mx_decode_attention"})]
        if cfg.family != "rwkv":
            fp = Model(dataclasses.replace(cfg, mx=QuantPolicy(
                weights=cfg.mx.weights)), device=model.device)
            b2 = {w: n for w, n in step.items() if w == "mx_matmul_2d"}
            flash = FAMILY_FLASH_PER_PREFILL[arch]
            runs.append(("bf16_kv", fp, b2, {
                **b2, **({"flash_attention": flash} if flash else {})}))
        for name, m, per_step, prefill in runs:
            _, launches = _family_static(torch, arch, name, m, params,
                                         batch, per_step, prefill)
            for k, n in launches.items():
                total[k] = total.get(k, 0) + n
        emit("serve_families", path=f"{arch} peak memory", config=cfg.name,
             peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
             weight_bytes=_weight_bytes(params), card=CARD)
        del params, model, runs
        _free(torch)
    return total


def _byte_flips(torch, card_cache, cpu_cache):
    """(differing, total) bytes of the MX code and scale leaves of two
    caches of one layout (fp leaves left out)."""
    from repro_torch.tree import leaves
    diff = total = 0
    for a, b in zip(leaves(card_cache), leaves(cpu_cache)):
        if a.dtype == torch.uint8:
            diff += int((a.cpu() != b).sum())
            total += b.numel()
    return diff, total


def _dequantized_to_cpu(torch, params):
    """``params`` on the CPU with every ``MXWeight`` dequantized once to
    f32 on the card.  The CPU's plain MX matmul is exactly this: it
    dequantizes the weight (the same f32 values) and multiplies in f32
    (``ref.mx_matmul_2d_ref``), but once per call, which at internvl2's
    widths is most of a CPU pass; the first weight's product is checked
    bit for bit against the plain MX matmul on the card."""
    from repro_torch.core.mx_weight import MXWeight
    from repro_torch.kernels import ref
    checked = []

    def walk(t):
        if isinstance(t, MXWeight):
            w = t.dequantize()
            if not checked:
                x = torch.randn(4, t.k, device=w.device)
                if not torch.equal(torch.matmul(x, w), ref.mx_matmul_2d_ref(
                        x, t.unpacked_codes(), t.scales, t.spec)):
                    raise AssertionError("a dequantized weight's product "
                                         "differs from the plain MX matmul")
                checked.append(True)
            return w.cpu()
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return t.cpu()

    return walk(params)


def families_card_vs_cpu(torch):
    """Two full-width f32 layers of each family (deepseek-v2: the dense
    layer and one MoE layer of 160 experts; seamless: one encoder and one
    decoder layer; zamba2: one site of the shared attention block before
    two Mamba2 blocks; internvl2 weight-resident e4m3), on the card and on
    the CPU, on a short batch of 2 rows: 16 positions for deepseek-v2 (its
    MoE layer's CPU side reads 15 GB a pass), 64 elsewhere (internvl2:
    its 256 patch embeddings and 2 tokens; seamless: 64 frames and 64
    tokens; weight-resident weights reach the CPU dequantized,
    ``_dequantized_to_cpu``).  Prefill logits within LOGITS_TOL over an
    f32 KV cache;
    under INT8 K / E2M1 V the caches' code and scale bytes equal but for
    at most 1 in 1000 (an element at a rounding boundary takes the
    neighbouring code on one device), and the logits within LOGITS_TOL
    unless such a flip happened; ``ServeEngine``'s greedy tokens under
    the MX cache equal (a flip only at a top-2 gap below LOGITS_TOL)."""
    import dataclasses
    from repro_torch.core.spec import QuantPolicy
    from repro_torch.models import Model
    from repro_torch.serve import GenerationConfig, ServeEngine
    for seed, (arch, _, resident) in enumerate(SERVE_FAMILIES):
        t0 = time.perf_counter()
        over = {"n_layers": 2}
        if arch == "seamless_m4t_medium":
            over.update(n_enc_layers=1, n_dec_layers=1)
        model, params = _family_load(torch, arch, over, resident,
                                     dtype="float32")
        cfg = model.cfg
        cpu_model = Model(cfg, device="cpu")
        cpu_params = _dequantized_to_cpu(torch, params)
        fp_cfg = dataclasses.replace(cfg, mx=QuantPolicy(
            weights=cfg.mx.weights))
        positions = 16 if cfg.n_experts else 64
        batch = _family_batch(cfg, 2, positions, 40 + seed)
        row = {k: v[:1] for k, v in batch.items()}
        max_len = _n_positions(row)
        vocab = cfg.vocab
        logits = {}
        kvs = (("fp", Model(fp_cfg, model.device), Model(fp_cfg, "cpu")),
               ("mx", model, cpu_model))
        for kv, card, cpu in kvs[:1 if cfg.family == "rwkv" else 2]:
            lg, cg, _ = card.prefill(params, row, max_len=max_len)
            lc, cc, _ = cpu.prefill(cpu_params, row, max_len=max_len)
            err = float((lg.cpu()[..., :vocab] - lc[..., :vocab])
                        .abs().max())
            diff, total = _byte_flips(torch, cg, cc)
            logits[kv] = dict(max_abs_err=err, flipped_bytes=diff,
                              cache_bytes=total)
            if diff > total // 1000 or (err > LOGITS_TOL and not diff):
                raise AssertionError(f"{arch}: card vs CPU prefill, {kv} KV:"
                                     f" logits differ by {err}, {diff} of "
                                     f"{total} cache bytes")
            del lg, lc, cg, cc
        gen = GenerationConfig(max_new_tokens=3)
        outs = [ServeEngine(m, p, max_len=_n_positions(batch) + 3 + 8)
                .generate(batch, gen).tolist()
                for m, p in ((model, params), (cpu_model, cpu_params))]
        flips = _family_flips(torch, model, params, batch, *outs)
        emit("families_card_vs_cpu", config=cfg.name, layers=2,
             dtype="float32", policy=str(cfg.mx), positions=positions,
             prefill=logits, tolerance=LOGITS_TOL, tokens=outs[0],
             cpu_tokens=outs[1], flips=flips,
             seconds=time.perf_counter() - t0)
        del params, model, cpu_params, cpu_model, kvs
        _free(torch)


# =============================================================================
# phase 6: calibration and per-layer policy tables (serve_policy)
# =============================================================================
# the searches' budgets: 0.7 x the uniform INT8 KV cache of chatglm3-6b
# (28 layers x 528 B = 14,784 B/token; the reference's
# test_search_applied_cost_matches_accounting uses the same ratio), and
# 0.75 B/param, which no uniform weight format meets (8-bit 1.031, 6-bit
# 0.781, e2m1 0.531 B/param)
POLICY_KV_BUDGET = 10348
POLICY_W_BUDGET = 0.75
CALIB_BATCHES = 4
CALIB_SHAPE = (8, 512)
# the card-vs-CPU table: 2 full-width f32 layers, layer 1 at its own
# weight and KV formats
POLICY_CPU_TABLE = (POLICY, {1: "weights=e2m1@32:ocp,kv_key=e3m2@32:ocp,"
                                "kv_value=e2m3@32:ocp"})
STATS_REL_TOL = 1e-3   # card vs CPU moments (f32 sums in other orders)
HIST_L1_TOL = 1e-3     # card vs CPU exponent histograms, x count


def _layer_formats(cfg):
    """Per layer: (weights, kv_key, kv_value) spec strings
    (``_spec_key``'s)."""
    return [tuple(_spec_key(getattr(cfg.layer_policy(i), r))
                  for r in ("weights", "kv_key", "kv_value"))
            for i in range(cfg.n_layers)]


def _policy_serve(torch, name, model, params, prompts, new):
    """One driven continuous run under a table: launches exactly 7 B2, 1
    KV write and 1 paged attention per layer per step (plus the prefill
    batches'), and pool bytes exactly page_size x num_pages x each
    layer's own kv_token_nbytes.  The B2 and B3 launches are also read
    by spec, as the wrappers counted them in the run and as one replay
    of the captured step credits them."""
    from repro_torch.serve import ContinuousBatchingEngine
    from repro_torch.serve.paging import kv_token_nbytes
    cfg, n_l = model.cfg, model.cfg.n_layers
    t0 = time.perf_counter()
    eng = ContinuousBatchingEngine(
        model, params, max_slots=8, page_size=16,
        max_len=max(map(len, prompts)) + new + 1, sync_every=8,
        prefill_bucket=64)
    capture_s = time.perf_counter() - t0
    outs, launches, wall = _drive(torch, lambda: _serve(eng, prompts, new))
    by_spec = _spec_launches()
    per_replay = _spec_launches(eng.window.step.spec_launches)
    steps, batches = eng.n_steps, eng.n_prefill_batches
    for kname, counts in by_spec.items():
        if sum(counts.values()) != launches[kname]:
            raise AssertionError(f"policy {name}: {kname} counted "
                                 f"{launches[kname]} launches, by spec "
                                 f"{counts}")
    # one replay runs each layer's matmuls at its weight spec and its
    # attention at its KV pair
    want_w, want_kv = {}, {}
    for w, k, v in _layer_formats(cfg):
        want_w[w] = want_w.get(w, 0) + 7
        want_kv[f"{k}/{v}"] = want_kv.get(f"{k}/{v}", 0) + 1
    if per_replay != {"mx_matmul_2d": dict(sorted(want_w.items())),
                      "mx_paged_decode_attention":
                          dict(sorted(want_kv.items()))}:
        raise AssertionError(f"policy {name}: one replay launches "
                             f"{per_replay} by spec, the table implies "
                             f"{want_w} and {want_kv}")
    _check_launches(f"policy {name}", launches, {
        "mx_matmul_2d": 7 * n_l * (steps + batches),
        "mx_kv_write": n_l * (steps + batches),
        "mx_paged_decode_attention": n_l * steps})
    want = [16 * eng.blocks.num_pages * kv_token_nbytes(
        cfg.layer_policy(i), cfg.n_kv_heads, cfg.hd) for i in range(n_l)]
    if eng.kv_pool_layer_nbytes != want \
            or eng.kv_pool_nbytes != sum(want):
        raise AssertionError(f"policy {name}: pool bytes "
                             f"{eng.kv_pool_layer_nbytes} per layer, "
                             f"accounted {want}")
    if eng.n_quarantined or eng.scheduler.failed:
        raise AssertionError(f"policy {name}: a healthy request was "
                             f"quarantined")
    for p, o in zip(prompts, outs):
        if len(o) != new or o.min() < 0 or o.max() >= cfg.vocab:
            raise AssertionError(f"policy {name}: bad output for a "
                                 f"{len(p)}-token prompt")
    ph = eng.phase
    emit("serve_policy", path=name, requests=len(prompts), new_tokens=new,
         wall_s=wall, prefill_s=ph["prefill"], decode_s=ph["decode"],
         decode_tokens_per_s=(eng.n_generated - len(prompts)) / ph["decode"],
         decode_steps=steps, step_wall_ms=ph["decode"] / steps * 1e3,
         prefill_batches=batches, graph_capture_s=capture_s,
         launches=launches, launches_by_spec=by_spec,
         launches_per_replay_by_spec=per_replay,
         kv_pool_nbytes=eng.kv_pool_nbytes,
         kv_pool_layer_nbytes=eng.kv_pool_layer_nbytes,
         weight_pool_nbytes=eng.weight_pool_nbytes,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    run = dict(tokens=[o.tolist() for o in outs], launches=launches,
               by_spec=by_spec, per_replay=per_replay,
               kv_pool_nbytes=eng.kv_pool_nbytes)
    del eng
    return run


def _policy_identities(torch, name, model, params, rng):
    """Under a table: a replayed window equals the eager loop (and one
    replay's launches are the graph's kernel nodes and the profiler's
    count); sync_every 1 equals 8; the prefix cache on equals off."""
    import numpy as np
    from repro_torch.serve import ContinuousBatchingEngine
    vocab = model.cfg.vocab
    short = [rng.integers(0, vocab, size=int(n)).astype(np.int32)
             for n in rng.integers(64, 257, size=8)]
    check_graph_window(torch, model, params, short, 0.0,
                       path=f"policy {name}")
    toks = []
    for se in (1, 8):
        e = ContinuousBatchingEngine(model, params, max_slots=8,
                                     page_size=16, max_len=256 + 17,
                                     sync_every=se, prefill_bucket=64)
        toks.append([o.tolist() for o in _serve(e, short, 16)])
        del e
    if toks[0] != toks[1]:
        raise AssertionError(f"policy {name}: sync_every 1 and 8 disagree")
    system = rng.integers(0, vocab, size=128).astype(np.int32)
    shared = [np.concatenate([system, rng.integers(0, vocab, size=int(t))
                              .astype(np.int32)])
              for t in rng.integers(16, 129, size=8)]
    runs, hits = [], 0
    for on in (False, True):
        e = ContinuousBatchingEngine(model, params, max_slots=4,
                                     page_size=16, max_len=256 + 17,
                                     sync_every=8, prefill_bucket=64,
                                     prefix_cache=on)
        runs.append([o.tolist() for o in _serve(e, shared, 16)])
        hits = e.prefix.hits if on else hits
        del e
    if runs[0] != runs[1] or hits == 0:
        raise AssertionError(f"policy {name}: prefix cache on and off "
                             f"disagree (or no hit: {hits})")
    emit("policy_identities", path=name, sync_every_1_eq_8=True,
         prefix_on_eq_off=True, prefix_hits=hits)


def _policy_static(torch, model, params):
    """``ServeEngine`` (B4 over the per-layer contiguous caches) on 8
    prompts of 512 under the table, its decode step replayed (launches
    counted per replay), against the continuous engine on the same
    prompts."""
    import numpy as np
    from repro_torch.serve import GenerationConfig, ServeEngine
    cfg, n_l = model.cfg, model.cfg.n_layers
    b, s, new = 8, 512, 64
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab, size=(b, s)).astype(np.int32)
    eng = ServeEngine(model, params, max_len=s + new + 8)
    gen = GenerationConfig(max_new_tokens=new)
    eng.generate({"tokens": tokens}, gen)             # captures the step
    out, launches, wall = _drive(
        torch, lambda: eng.generate({"tokens": tokens}, gen))
    _check_launches("policy static", launches, {
        "mx_matmul_2d": 7 * n_l * new, "mx_kv_write": n_l * new,
        "mx_decode_attention": n_l * (new - 1)})
    check_replay(torch, "policy static decode step",
                 eng._graphs[(b, 0.0)].step,
                 {"mx_matmul_2d": 7 * n_l, "mx_cache_kv_write": n_l,
                  "mx_decode_attention": n_l})
    ph = eng.phase
    emit("serve_policy", path="kv_table static", batch=b, prompt_len=s,
         new_tokens=new, wall_s=wall, prefill_s=ph["prefill"],
         decode_s=ph["decode"],
         decode_tokens_per_s=b * (new - 1) / ph["decode"],
         kv_cache_nbytes=eng.kv_cache_nbytes, launches=launches)
    del eng
    torch.cuda.empty_cache()
    prompts = list(tokens)
    cont = _policy_serve(torch, "kv_table continuous 8 x 512", model,
                         params, prompts, new)
    flips = _flips(torch, model, params, prompts, cont["tokens"], out)
    emit("static_vs_continuous", path="kv_table", requests=b,
         new_tokens=new, identical=not flips, flips=flips)
    return launches, cont["launches"]


def _policy_matmul_rows(torch, flush, fmts, run):
    """B2 at w1 (4096 x 13696, M 8) in each weight format the searched
    table picked (packed where sub-byte), beside e4m3's; ``run`` is the
    weights table's run, whose launches by spec (in the run and per
    replay) each row carries."""
    from repro_torch.core.mx_weight import MXWeight
    from repro_torch.core.pack import unpack_codes_rows
    from repro_torch.core.spec import QuantSpec
    from repro_torch.kernels import ref
    from repro_torch.kernels.mx_matmul import mx_matmul_2d
    gen = torch.Generator(device="cuda").manual_seed(22)
    k, n = PROJ["w1/w3"]
    a = torch.randn(8, k, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(k, n, generator=gen, device="cuda")
         / math.sqrt(k)).to(torch.bfloat16)
    rows = []
    for fmt in fmts:
        spec = QuantSpec(fmt, "ocp")
        mw = MXWeight.quantize(w, spec)
        codes = unpack_codes_rows(mw.codes, fmt, k) if mw.packed \
            else mw.codes
        row = _matmul_row(torch, ref, mx_matmul_2d, a, mw, codes, spec,
                          "w1/w3", flush)
        wd = ref.dequant_ref(codes, mw.scales, spec).to(torch.bfloat16)
        row.update(graph_ms=graph_ms(torch, lambda: mx_matmul_2d(
                       a, mw.codes, mw.scales, mw.spec), flush=flush),
                   library_graph_ms=graph_ms(
                       torch, lambda: torch.matmul(a, wd), flush=flush),
                   weight_nbytes=mw.nbytes,
                   launches=run["by_spec"]["mx_matmul_2d"].get(
                       _spec_key(spec), 0),
                   launches_per_replay=run["per_replay"]["mx_matmul_2d"]
                   .get(_spec_key(spec), 0))
        rows.append(row)
    return rows


def _policy_attention_rows(torch, flush, pairs, run):
    """B3 at each (kv_key, kv_value) pair the searched KV table picked: 8
    slots over up to 576 tokens, Hq 32 / Hkv 2, D 128, bf16 q, against
    its plain version; ``run`` is the KV table's run, whose launches by
    pair (in the run and per replay) each row carries."""
    from repro_torch.core.spec import QuantSpec
    from repro_torch.kernels import ref
    from repro_torch.kernels.mx_decode_attn import mx_paged_decode_attention
    gen = torch.Generator(device="cuda").manual_seed(23)
    rows = []
    for pair in pairs:
        kspec, vspec = (QuantSpec.parse(x) for x in pair)
        q32, kc, ks, vc, vs, bt, lengths = _paged_case(torch, kspec, vspec,
                                                       gen)
        args = (q32.to(torch.bfloat16), kc, ks, vc, vs, bt, lengths)
        kw = dict(key_spec=kspec, value_spec=vspec, rep=16)
        got = mx_paged_decode_attention(*args, **kw)
        want = ref.mx_paged_decode_attention_ref(*args, **kw)
        torch.testing.assert_close(got, want)
        row = _time_paged_attention(torch, flush, args, kspec, vspec,
                                    "/".join(pair))
        key = "/".join(pair)
        row.update(max_abs_err=float((got.float() - want.float()).abs()
                                     .max()),
                   launches=run["by_spec"][
                       "mx_paged_decode_attention"].get(key, 0),
                   launches_per_replay=run["per_replay"][
                       "mx_paged_decode_attention"].get(key, 0))
        rows.append(row)
    return rows


def _stats_close(role, layer, a, b):
    """Card against CPU statistics of one (role, layer)."""
    import numpy as np
    if (a.count, a.n_zero) != (b.count, b.n_zero):
        raise AssertionError(f"stats {role} {layer}: count / n_zero "
                             f"{a.count}/{a.n_zero} vs {b.count}/{b.n_zero}")
    for key in ("absmax", "total", "sumsq"):
        x, y = getattr(a, key), getattr(b, key)
        if not abs(x - y) <= STATS_REL_TOL * max(abs(y), 1e-30):
            raise AssertionError(f"stats {role} {layer} {key}: card {x}, "
                                 f"CPU {y}")
    l1 = int(np.abs(a.exp_hist - b.exp_hist).sum())
    if not l1 <= HIST_L1_TOL * a.count:
        raise AssertionError(f"stats {role} {layer}: histogram L1 {l1} "
                             f"> {HIST_L1_TOL} x {a.count}")
    return l1


def _policy_card_vs_cpu(torch):
    """Two full-width f32 layers under POLICY_CPU_TABLE, card against CPU:
    all five roles' statistics (grads through B5's autograd backward on
    the card), the KV search's table JSON, then per-layer quantized
    weights: prefill logits within LOGITS_TOL and the continuous engine's
    greedy tokens."""
    import numpy as np
    from repro_torch.calib import collect_model_stats, search_kv_policy
    from repro_torch.core.spec import PolicyTable, QuantPolicy
    from repro_torch.launch.serve import build_model
    from repro_torch.models import Model
    from repro_torch.serve import ContinuousBatchingEngine
    from repro_torch.serve.paging import kv_token_nbytes
    model, params = build_model(
        "chatglm3_6b", reduced=False, quant=POLICY, weight_resident=False,
        device="cuda", seed=1, n_layers=2, dtype="float32",
        attn_impl="flash", table=PolicyTable(*POLICY_CPU_TABLE))
    cfg = model.cfg
    cpu_model = Model(cfg, device="cpu")
    cpu_params = _to_cpu(params)
    rng = np.random.default_rng(2)
    batches = [rng.integers(0, cfg.vocab, size=(2, 64)).astype(np.int32)
               for _ in range(2)]
    roles = ("kv_key", "kv_value", "activations", "weights", "grads")
    t0 = time.perf_counter()
    stats, launches, _ = _drive(torch, lambda: collect_model_stats(
        model, params, batches, roles=roles))
    # flash once per layer and batch in the forward roles' pass and once
    # in the grads role's (its backward recomputes densely)
    _check_launches("policy card calibration", launches,
                    {"flash_attention": 2 * 2 * 2})
    cpu_stats = collect_model_stats(cpu_model, cpu_params, batches,
                                    roles=roles)
    worst_l1 = {r: max(_stats_close(r, i, stats.role_layers(r)[i],
                                    cpu_stats.role_layers(r)[i])
                       for i in range(2)) for r in roles}
    budget = 0.7 * 2 * kv_token_nbytes(QuantPolicy.parse("kv=int8@32:ocp"),
                                       cfg.n_kv_heads, cfg.hd)
    tables = [search_kv_policy(st, budget, cfg).table.to_json()
              for st in (stats, cpu_stats)]
    if tables[0] != tables[1]:
        raise AssertionError(f"the KV search on the card's stats gives "
                             f"{tables[0]}, on the CPU's {tables[1]}")
    qparams = model.quantize_weights(params)
    cpu_q = cpu_model.quantize_weights(cpu_params)
    del params, cpu_params
    vocab = cfg.vocab
    prompts = [rng.integers(0, vocab, size=n).astype(np.int32)
               for n in (40, 61)]
    tok = torch.from_numpy(prompts[1][None])
    lg, _, _ = model.prefill(qparams, tok.cuda(), max_len=tok.shape[1])
    lc, _, _ = cpu_model.prefill(cpu_q, tok, max_len=tok.shape[1])
    err = float((lg.cpu()[..., :vocab] - lc[..., :vocab]).abs().max())
    if not err <= LOGITS_TOL:
        raise AssertionError(f"policy card vs CPU prefill logits differ "
                             f"by {err}")
    outs = []
    for m, p in ((model, qparams), (cpu_model, cpu_q)):
        eng = ContinuousBatchingEngine(m, p, max_slots=2, page_size=16,
                                       max_len=64 + 4, sync_every=8,
                                       prefill_bucket=64)
        outs.append([o.tolist() for o in _serve(eng, prompts, 3)])
    flips = _flips(torch, model, qparams, prompts, *outs)
    emit("policy_card_vs_cpu", layers=2, dtype="float32",
         table=json.loads(PolicyTable(*POLICY_CPU_TABLE).to_json()),
         stats_roles=list(roles), hist_l1_worst=worst_l1,
         stats_rel_tol=STATS_REL_TOL, hist_l1_tol=HIST_L1_TOL,
         flash_launches=launches["flash_attention"],
         kv_budget=budget, searched_table_equal=True,
         logits_max_abs_err=err, tolerance=LOGITS_TOL, tokens=outs[0],
         cpu_tokens=outs[1], flips=flips,
         seconds=time.perf_counter() - t0)
    del qparams, model
    torch.cuda.empty_cache()


def serve_policy(torch, flush_bytes=256 * 2 ** 20):
    """Full-width chatglm3-6b (28 layers, fp bf16 weights from seed 0):
    calibrate (4 batches of 8 x 512 through ``forward_calib``, attention
    through B5), search a KV table at POLICY_KV_BUDGET B/token and a
    weights table at POLICY_W_BUDGET B/param, serve each through the
    continuous engine after quantizing per layer (B1 at each layer's
    weight format; B2, the KV write and B3 at each layer's formats), with
    the identities; the KV table also through ``ServeEngine`` (B4); a
    uniform table collapses to the base policy's run (its weights
    quantized as they are made, phase 3's route); card against
    CPU on 2 layers (``_policy_card_vs_cpu``, in a subprocess beside the
    rest); kernel rows at the formats the tables picked.  Returns the
    launches of its main paths and the kernel rows."""
    import tempfile
    # the card-against-CPU check (most of its time on the CPU) in a
    # subprocess beside the phase's driven paths
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        check = _sub_check("policy_card_vs_cpu", Path(d))
        try:
            out = _serve_policy_paths(torch, flush_bytes)
            check()
        finally:
            check.stop()
    return out


def _serve_policy_paths(torch, flush_bytes):
    import numpy as np
    from repro_torch.calib import (collect_model_stats, search_kv_policy,
                                   search_weights_policy)
    from repro_torch.core.spec import PolicyTable, QuantPolicy, QuantSpec
    from repro_torch.launch.serve import build_model
    from repro_torch.models import Model, apply_policy_table, load_config
    from repro_torch.serve.paging import kv_cache_token_nbytes
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    (model, params), _, load_s = _drive(torch, lambda: build_model(
        "chatglm3_6b", reduced=False, quant=POLICY, weight_resident=False,
        device="cuda", seed=0, attn_impl="flash"))
    cfg, n_l = model.cfg, model.cfg.n_layers
    total = {}

    def add(launches):
        for kname, n in launches.items():
            total[kname] = total.get(kname, 0) + n

    rng = np.random.default_rng(1)
    batches = [rng.integers(0, cfg.vocab, size=CALIB_SHAPE).astype(np.int32)
               for _ in range(CALIB_BATCHES)]
    stats, launches, calib_s = _drive(torch, lambda: collect_model_stats(
        model, params, batches,
        roles=("kv_key", "kv_value", "activations", "weights")))
    _check_launches("calibration", launches,
                    {"flash_attention": n_l * CALIB_BATCHES})
    add(launches)
    emit("policy_calibration", batches=CALIB_BATCHES,
         batch_shape=list(CALIB_SHAPE), seconds=calib_s, fp_load_s=load_s,
         launches=launches, fp_weight_bytes=_weight_bytes(params),
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    t0 = time.perf_counter()
    kv = search_kv_policy(stats, POLICY_KV_BUDGET, cfg)
    kv_s = time.perf_counter() - t0
    kv_cfg = apply_policy_table(cfg, kv.table)
    kv_pol = {(f[1], f[2]) for f in _layer_formats(kv_cfg)}
    if len(kv_pol) < 2 or kv_cache_token_nbytes(kv_cfg) > POLICY_KV_BUDGET:
        raise AssertionError(f"KV table: {len(kv_pol)} distinct layer "
                             f"policies at {kv_cache_token_nbytes(kv_cfg)} "
                             f"B/token (budget {POLICY_KV_BUDGET})")
    t0 = time.perf_counter()
    wt = search_weights_policy(stats, POLICY_W_BUDGET, cfg)
    w_s = time.perf_counter() - t0
    w_cfg = apply_policy_table(cfg, wt.table)
    w_fmts = {f[0] for f in _layer_formats(w_cfg)}
    per_param = wt.total_nbytes / wt.total_params
    if len(w_fmts) < 2 or per_param > POLICY_W_BUDGET:
        raise AssertionError(f"weights table: {sorted(w_fmts)} at "
                             f"{per_param} B/param")
    del stats
    emit("policy_tables", kv_budget=POLICY_KV_BUDGET,
         kv_bytes_per_token=kv_cache_token_nbytes(kv_cfg),
         kv_mean_sqnr_db=kv.mean_sqnr_db, kv_search_s=kv_s,
         kv_layer_policies=sorted("/".join(p) for p in kv_pol),
         kv_table=json.loads(kv.table.to_json()),
         weights_budget=POLICY_W_BUDGET, weights_bytes_per_param=per_param,
         weights_mean_sqnr_db=wt.mean_sqnr_db, weights_search_s=w_s,
         weight_formats=sorted(w_fmts),
         weights_table=json.loads(wt.table.to_json()))
    prompts, _ = _continuous_prompts(cfg.vocab)
    runs = {}
    for name, tcfg in (("kv_table", kv_cfg), ("weights_table", w_cfg)):
        m = Model(tcfg, device=model.device)
        qparams, q_launches, q_s = _drive(
            torch, lambda: m.quantize_weights(params))
        _check_launches(f"policy {name} quantize", q_launches,
                        {"mx_quantize_2d": 7 * n_l})
        add(q_launches)
        runs[name] = _policy_serve(torch, name, m, qparams, prompts, 64)
        add(runs[name]["launches"])
        _policy_identities(torch, name, m, qparams, rng)
        if name == "kv_table":
            static, cont = _policy_static(torch, m, qparams)
            add(static)
            add(cont)
        emit("serve_policy", path=f"{name} peak memory",
             quantize_s=q_s, weight_pool_bytes=_weight_bytes(qparams),
             peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        del qparams, m
        _free(torch)
    # a uniform table naming the base policy is the base policy's config
    # and gives the tokens and pool bytes of the base policy's weights
    # quantized as they are made (phase 3's route, at this phase's depth)
    base = load_config("chatglm3_6b", mx=QuantPolicy.parse(POLICY),
                       attn_impl="flash")
    uni = apply_policy_table(base, PolicyTable(
        POLICY, {i: POLICY for i in range(n_l)}))
    if uni != base or uni.mx_table is not None or base != cfg:
        raise AssertionError("a uniform table does not collapse to the "
                             "base policy's config")
    um = Model(uni, device=model.device)
    uparams = um.quantize_weights(params)
    del params
    _free(torch)
    run = _policy_serve(torch, "uniform table", um, uparams, prompts, 64)
    add(run["launches"])
    del uparams, um
    _free(torch)
    bm, bparams = build_model(
        "chatglm3_6b", reduced=False, quant=POLICY, weight_resident=True,
        device="cuda", seed=0, attn_impl="flash")
    want = _policy_serve(torch, "base policy", bm, bparams, prompts, 64)
    add(want["launches"])
    del bm, bparams
    if run["tokens"] != want["tokens"] \
            or run["kv_pool_nbytes"] != want["kv_pool_nbytes"]:
        raise AssertionError("the uniform table's run differs from the "
                             "base policy's (tokens or pool bytes)")
    emit("policy_collapse", identical_config=True, tokens_equal=True,
         kv_pool_nbytes=run["kv_pool_nbytes"])
    del model
    _free(torch)
    flush = torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
    w_run = runs["weights_table"]
    b2 = _policy_matmul_rows(torch, flush, sorted(
        {QuantSpec.parse(s).fmt for s in w_fmts} | {"e4m3"}), w_run)
    b3 = _policy_attention_rows(torch, flush, sorted(kv_pol),
                                runs["kv_table"])
    del flush
    torch.cuda.empty_cache()
    return total, {"mx_matmul_2d": b2, "mx_paged_decode_attention": b3}


# =============================================================================
# phase 4: card against CPU
# =============================================================================
# =============================================================================
# phase 7: training (full-width chatglm3-6b cut to 4 layers)
# =============================================================================
TRAIN_ARCH = "chatglm3_6b"
TRAIN_LAYERS = 4        # AdamW holds 16 B a parameter (bf16 param, f32
#                         master, m, v) plus its bf16 gradient: 4 of 28
#                         layers is 1.35 G parameters, ~25 GB
TRAIN_SHAPE = (8, 512)  # batch x sequence of every training step here
TRAIN_STEPS = 20
TRAIN_LR = 3e-4         # the launcher's --lr: at its default, 1e-3, the
#                         full-width held-out loss rises (11.584 ->
#                         11.730 over 20 steps on an H100), while
#                         _grads_card_vs_cpu holds the card's step to the
#                         CPU path's, which the CPU tests hold to the
#                         reference
TRAIN_LAUNCHER_LR = 1e-3
TRAIN_RESUME_LAYERS = 1  # the resume path's depth: its checkpoint writes
#                          and reads the whole AdamW state
TRAIN_HELDOUT = 1_000_000  # the batch index of the held-out batch: no run
#                            trains on it
TRAIN_HELDOUT_MARGIN = 5e-3  # nats the held-out loss must fall by: a
#                              frozen optimizer moves it by 0 (the step is
#                              deterministic); weight decay alone shrinks
#                              the logits by ~lr x 0.1 x 20 = 6e-4
#                              relative, under 1e-3 nats
TRAIN_QUANT = "weights=e4m3@32:ocp,activations=e4m3@32:ocp"
TRAIN_WEIGHTS_QUANT = "weights=e4m3@32:ocp"
# fake-quant launches per layer and forward: one per matmul weight (wq,
# wk, wv, wo, w1, w3, w2) and one per matmul input, as each dense()
# quantizes its own
FQ_PER_LAYER = {TRAIN_QUANT: 14, TRAIN_WEIGHTS_QUANT: 7, "none": 0}
TRAIN_FQ_SHAPES = {"wq/wo": (4096, 4096), "wk/wv": (4096, 256),
                   "w1/w3": (4096, 13696), "w2": (13696, 4096)}
TRAIN_FQ_FMTS = ("e4m3", "e2m1", "e2m3", "int8")
TRAIN_CPU_LOSS_RTOL = 1e-4   # card vs CPU, f32, one full-width layer: sums
#                              in another order (an activation's E4M3 code
#                              flipping at a rounding boundary would show)
TRAIN_CPU_MASTER_RTOL, TRAIN_CPU_MASTER_ATOL = 2e-3, 2e-5  # the reference's
#                              test_microbatched_matches_full_batch
# card vs CPU, one full-width layer, no quant: each leaf's gradient and m
# within this relative L2 error, loss and grad norm within it relatively.
# f32: sums in other orders (~1e-6).  bf16: each product and norm rounds
# its output to bf16 (2^-9 relative) on both devices, at places where the
# f32 sums before it differ, and the card's LM head rounds the logits'
# gradient to bf16 (ROADMAP C10): a few ulps of bf16 (2^-8 = 3.9e-3)
TRAIN_GRAD_RTOL = {"float32": 1e-4, "bfloat16": 3e-2}
# where bf16 rounding alone moves a leaf's gradient by about that much on
# each device (a zamba2 group: 2.1e-2 - 3.2e-2 from the f32 gradient of
# the same params on either, 2.97e-2 apart; an H100, PERF.md), each
# device's bf16 gradient and m are held to the f32 ones instead: the
# card's error at most this times the CPU's (read: at most 1.19)
TRAIN_BF16_VS_F32_RATIO = 1.5


def _train_model(torch, quant, n_layers=TRAIN_LAYERS, device="cuda", **over):
    from repro_torch.core.spec import QuantPolicy
    from repro_torch.models import Model, load_config
    cfg = load_config(TRAIN_ARCH, mx=QuantPolicy.parse(quant),
                      n_layers=n_layers, attn_impl="flash", **over)
    return Model(cfg, device=device)


def _train_opt(steps, lr=TRAIN_LR):
    """AdamW as the reference's launcher sets it, at ``--lr`` ``lr``."""
    from repro_torch.optim import AdamWConfig
    return AdamWConfig(lr=lr, warmup_steps=min(20, steps // 10 + 1),
                       total_steps=steps)


def _heldout_loss(torch, model, params, batch, fake_quant):
    """The training loss of ``params`` on ``batch``, forward only."""
    from repro_torch.train.step import _loss_fn
    with torch.no_grad():
        return float(_loss_fn(model, params, batch,
                              fake_quant=fake_quant)[0])


def _train_data(cfg, shape=TRAIN_SHAPE):
    from repro_torch.data import DataConfig, SyntheticLM
    return SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=shape[1],
                                  global_batch=shape[0]))


def _train_run(torch, name, quant, steps=TRAIN_STEPS, check=None,
               lr=TRAIN_LR, gate=True, model=None, shape=TRAIN_SHAPE,
               per_step=None, phase="train"):
    """``steps`` train steps of a fresh model from seed 0 (``model``, by
    default chatglm3-6b at 4 layers under ``quant``) on batches of
    ``shape`` as a driven path: losses and grad norms finite, ms per step
    (each step ends in the loss's host read), tokens/s, peak device
    memory, and the converter's and flash attention's launches, which
    must be exactly ``per_step`` (by default the count the policy implies
    for chatglm3-6b) times ``steps``.  The loss on one held-out batch
    (TRAIN_HELDOUT) before and after the steps: with ``gate`` it must
    fall by TRAIN_HELDOUT_MARGIN; without (the 2-step runs) it is
    recorded.  ``check(model, params, opt, data)`` runs before the steps
    (outside the drive).  Returns the run's launches."""
    from repro_torch.data import make_batch_for
    from repro_torch.train import build_train_step, init_train_state
    _free(torch)
    if model is None:
        model = _train_model(torch, quant)
    cfg = model.cfg
    params, opt = init_train_state(model, seed=0)
    fq = quant != "none"
    step_fn = build_train_step(model, _train_opt(steps, lr), fake_quant=fq)
    data = _train_data(cfg, shape)
    extra = check(model, params, opt, data) if check else None
    batches = [make_batch_for(cfg, data.batch(i)) for i in range(steps)]
    held = make_batch_for(cfg, data.batch(TRAIN_HELDOUT))
    held_before = _heldout_loss(torch, model, params, held, fq)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, ms = [], [], []

    def run():
        nonlocal params, opt
        for i in range(steps):
            t0 = time.perf_counter()
            params, opt, met = step_fn(params, opt, batches[i], i)
            losses.append(float(met["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
            norms.append(float(met["grad_norm"]))

    _, launches, wall = _drive(torch, run)
    held_after = _heldout_loss(torch, model, params, held, fq)
    if not all(math.isfinite(x) for x in losses + norms + [held_after]) or (
            gate and held_after > held_before - TRAIN_HELDOUT_MARGIN):
        raise AssertionError(f"train {name}: held-out loss {held_before} -> "
                             f"{held_after}, losses {losses}, grad norms "
                             f"{norms}, ms {ms}")
    # remat recomputes a layer, kernels and all, where the backward needs
    # a tensor it saved: under an activations role no tensor inside a
    # layer needs a gradient (C9), so nothing is recomputed
    recompute = cfg.remat and not (fq and cfg.mx.activations is not None)
    if per_step is None:
        passes = 2 if recompute else 1
        per_step = {"mx_quantize_2d": FQ_PER_LAYER[quant] * cfg.n_layers
                    * passes, "flash_attention": cfg.n_layers * passes}
    _check_launches(f"{phase} {name}", launches,
                    {k: n * steps for k, n in per_step.items()})
    step_ms = statistics.median(ms[1:])
    row = dict(path=name, config=cfg.name, layers=cfg.n_layers,
               batch=shape[0], seq=shape[1], dtype=cfg.dtype,
               remat=cfg.remat, quant=quant, steps=steps, lr=lr,
               losses=losses, grad_norms=norms, heldout_before=held_before,
               heldout_after=held_after, heldout_gate=gate,
               first_step_ms=ms[0], step_ms=step_ms, step_ms_all=ms,
               tokens_per_s=shape[0] * shape[1] / step_ms * 1e3,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches=launches,
               launches_per_step={k: v / steps for k, v in launches.items()
                                  if v},
               predicted_per_step=per_step, recomputed=recompute,
               wall_s=wall, card=CARD)
    if extra is not None:
        row.update(extra(params, opt))
    emit(phase, **row)
    del params, opt, model, batches, held
    return launches


def _c9_check(torch):
    """Before the QAT run: the leaves with no gradient (``None``) on the
    first batch are exactly each layer's matmul weights and norms (under
    weights + activations nothing inside a layer reaches the loss except
    through a fake quantizer); a copy of layer 0's masters is kept.
    After it: those leaves' moments are still exactly 0 and each master
    is its initial value decayed by every step's lr x weight_decay, in
    the update's own f32 operations, bit for bit."""
    from repro_torch.data import make_batch_for
    from repro_torch.optim.adamw import _lr
    from repro_torch.train.step import _grads_of
    from repro_torch.tree import leaves_with_path, path_key

    def before(model, params, opt, data):
        _, _, grads = _grads_of(model, params,
                                make_batch_for(model.cfg, data.batch(0)),
                                True)
        none = sorted(path_key(p) for p, g in leaves_with_path(grads)
                      if g is None)
        layer = sorted(f"layers/{i}/{path_key(p)}"
                       for i, lp in enumerate(params["layers"])
                       for p, _ in leaves_with_path(lp))
        if none != layer:
            raise AssertionError(f"C9: leaves without gradient {none}, "
                                 f"expected every layer leaf")
        del grads
        start = {path_key(p): w.clone()
                 for p, w in leaves_with_path(opt["master"]["layers"][0])}
        opt_cfg = _train_opt(TRAIN_STEPS)

        def after(params, opt):
            for path, w in leaves_with_path(opt["master"]["layers"][0]):
                key = path_key(path)
                m = opt["m"]["layers"][0]
                v = opt["v"]["layers"][0]
                for k in path:
                    m, v = m[k], v[k]
                if bool(m.abs().max() > 0) or bool(v.abs().max() > 0):
                    raise AssertionError(f"C9: layer 0 {key}: moments "
                                         f"moved")
                want = start[key]
                for i in range(TRAIN_STEPS):
                    lr = float(_lr(opt_cfg, i))
                    want = want - lr * (0.0 + opt_cfg.weight_decay * want)
                if not torch.equal(w, want):
                    raise AssertionError(f"C9: layer 0 {key}: master is not "
                                         f"its weight-decayed start")
            return {"c9_leaves": len(none),
                    "c9_check": "no gradient; moments 0; master = start "
                                "decayed by lr x weight_decay, bit for bit"}

        return after

    return before


def _train_resume(torch, tmp):
    """Resume identity through ``train_loop`` (weights fake-quantized, so
    the converter, flash and the full backward all run) at
    TRAIN_RESUME_LAYERS full-width layers: 10 steps uninterrupted; 5
    steps with a checkpoint at step 5, then a fresh state resumed from it
    to 10.  Params, master, m and v equal the uninterrupted run's bit for
    bit."""
    from repro_torch.data import make_batch_for
    from repro_torch.train import (LoopConfig, build_train_step,
                                   init_train_state, train_loop)
    from repro_torch.tree import leaves_with_path, path_key
    steps = 10
    model = _train_model(torch, TRAIN_WEIGHTS_QUANT,
                         n_layers=TRAIN_RESUME_LAYERS)
    data = _train_data(model.cfg)
    step_fn = build_train_step(model, _train_opt(steps), fake_quant=True)

    def batch_fn(i):
        return make_batch_for(model.cfg, data.batch(i))

    def loop(total, ckpt_dir, every):
        out = train_loop(LoopConfig(total_steps=total, ckpt_dir=ckpt_dir,
                                    ckpt_every=every, log_every=1000),
                         step_fn, *init_train_state(model, seed=0),
                         batch_fn, log=lambda *_: None)
        return out

    t0 = time.perf_counter()
    a = loop(steps, str(tmp / "a"), 0)
    want = {path_key(p): t.cpu() for p, t in leaves_with_path(
        {"params": a["params"], "opt": a["opt"]})}
    a_loss = [h["loss"] for h in a["history"]]
    del a
    _free(torch)
    t1 = time.perf_counter()
    loop(5, str(tmp / "b"), 5)
    _free(torch)
    save_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    b = loop(steps, str(tmp / "b"), 0)
    resume_s = time.perf_counter() - t1
    got = {"params": b["params"], "opt": b["opt"]}
    diff = [path_key(p) for p, t in leaves_with_path(got)
            if not torch.equal(t.cpu(), want[path_key(p)])]
    b_loss = [h["loss"] for h in b["history"]]
    if diff or b_loss != a_loss[5:] or len(want) != len(
            list(leaves_with_path(got))):
        raise AssertionError(f"resume: {len(diff)} leaves differ from the "
                             f"uninterrupted run ({diff[:4]}); losses "
                             f"{b_loss} vs {a_loss[5:]}")
    ckpt = tmp / "b" / "step_00000005"
    emit("train_resume", quant=TRAIN_WEIGHTS_QUANT, layers=model.cfg.n_layers,
         steps=steps, checkpoint_step=5, leaves=len(want),
         checkpoint_bytes=sum(f.stat().st_size for f in ckpt.iterdir()),
         bit_identical=True, losses=a_loss,
         seconds=time.perf_counter() - t0, save_run_s=save_s,
         resume_run_s=resume_s)
    del b, got, want
    _free(torch)


def _fake_quant_rows(torch, flush, shapes=TRAIN_FQ_SHAPES):
    """The fake-quant route (``ops.fake_quantize``: the converter kernel,
    then the port's dequantize) against the plain round trip
    (``core.convert``) at each weight shape of ``shapes`` (by default
    every one of a chatglm3-6b layer), along
    axis 0 (K), in e4m3, e2m1, e2m3 and int8 (OCP): codes, scales and
    values bit for bit, NaN and Inf blocks included; the kernel launch
    the route makes timed per shape in e4m3 with its bound and plain
    version."""
    from repro_torch.core import convert
    from repro_torch.core.spec import QuantSpec
    from repro_torch.kernels import ref
    from repro_torch.kernels.mx_quant import mx_quantize_2d
    from repro_torch.kernels.ops import fake_quantize
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows, n_checked = [], 0
    for name, (k, n) in shapes.items():
        w = torch.randn(k, n, generator=gen, device="cuda") * 0.016
        w[5, 7] = float("nan")                     # a NaN block
        w[40, 1] = float("inf")                    # an Inf block
        w[70, 2] = -float("inf")
        w[96:128, 3] = 1e-40                       # subnormals
        xt = w.t().contiguous()                    # the launch's layout
        for fmt in TRAIN_FQ_FMTS:
            spec = QuantSpec(fmt, "ocp")
            codes, scales = mx_quantize_2d(xt, spec)
            want = convert.mx_quantize(w, spec, axis=0)
            got_v = fake_quantize(w, spec, axis=0)
            want_v = convert.quantize_dequantize(w, spec, axis=0)
            if not (torch.equal(codes.t(), want.codes)
                    and torch.equal(scales.t(), want.scales)
                    and torch.equal(got_v.view(torch.int32),
                                    want_v.view(torch.int32))):
                raise AssertionError(f"fake quant {name} {spec}: the kernel "
                                     f"route differs from the plain round "
                                     f"trip")
            n_checked += 1
        spec = QuantSpec("e4m3", "ocp")
        numel = k * n
        tb, by = bound(numel * (4 + 1 + 1 / 32),
                       numel * CONVERTER_OPS_PER_ELEMENT, F32_CUDA_CORE_FLOPS)
        rows.append(dict(
            kernel="mx_quantize_2d",
            shape=f"fake-quant {name} {k}x{n} along K (launched {n}x{k})",
            spec=str(spec), max_abs_err=0.0,
            ms=time_ms(torch, lambda: mx_quantize_2d(xt, spec), flush=flush),
            round_trip_ms=time_ms(torch, lambda: fake_quantize(w, spec,
                                                               axis=0),
                                  flush=flush),
            plain_ms=time_ms(torch, lambda: ref.mx_quantize_2d_ref(xt, spec),
                             flush=flush),
            bound_ms=tb, bound_by=by, library_ms=None))
        emit("time", **rows[-1])
        del w, xt
    emit("check", kernel="fake_quantize", compared=n_checked,
         criterion="codes, scales and dequantized values bit-identical to "
                   "core.convert (NaN/Inf blocks included)")
    return rows


def _train_card_vs_cpu(torch):
    """One full-width layer of chatglm3-6b, batch 2 x 64, on the card and
    on the CPU from the same params (seed 3, made once on the CPU): two
    QAT steps in f32 (``_qat_card_vs_cpu``), then each leaf's gradient
    and ``m`` with no quant in f32 and in bf16 (``_grads_card_vs_cpu``)."""
    from repro_torch.tree import tree_map
    t0 = time.perf_counter()
    cpu = _train_model(torch, TRAIN_QUANT, n_layers=1, device="cpu",
                       dtype="float32", param_dtype="float32", remat=False)
    start = cpu.init(seed=3)
    _qat_card_vs_cpu(torch, cpu, tree_map(torch.clone, start))
    for dtype in ("float32", "bfloat16"):
        params = tree_map(lambda t: t.to(getattr(torch, dtype), copy=True),
                          start)
        _grads_card_vs_cpu(torch, _train_model(
            torch, "none", n_layers=1, device="cpu", dtype=dtype,
            param_dtype=dtype), params)
    emit("phase_seconds", name="train card vs CPU",
         seconds=time.perf_counter() - t0)
    del start
    _free(torch)


def _qat_card_vs_cpu(torch, cpu, cp):
    """Two QAT steps (weights + activations, f32, remat off) of the
    one-layer model ``cpu`` from params ``cp`` and the same AdamW state
    (random moments) on the card and on the CPU: loss and grad norm
    within TRAIN_CPU_LOSS_RTOL at each step, master within the
    reference's rtol 2e-3, atol 2e-5; the weights' converter codes equal
    on both devices.  Under C9 only embed, norm_f and the LM head get a
    gradient here; ``_grads_card_vs_cpu`` holds every leaf's."""
    from repro_torch.core import convert
    from repro_torch.data import make_batch_for
    from repro_torch.kernels.mx_quant import mx_quantize_2d
    from repro_torch.kernels.ops import fake_quantize
    from repro_torch.models import Model
    from repro_torch.optim import adamw_init
    from repro_torch.train import build_train_step
    from repro_torch.tree import leaves, tree_map
    t0 = time.perf_counter()
    card = Model(cpu.cfg, device="cuda")
    co = adamw_init(cp)
    # random moments (|m| / sqrt(v) <= 1), made on the card and copied:
    # from zero moments a first step moves each weight by about lr x the
    # sign of its gradient, and the LM head's 266 M gradient elements
    # include some at the two devices' rounding noise, which would move
    # apart by 2 lr
    gen = torch.Generator(device="cuda").manual_seed(4)
    gp = tree_map(lambda t: t.cuda(), cp)
    go = {"master": tree_map(lambda t: t.cuda(), co["master"]),
          "m": tree_map(lambda t: torch.randn(t.shape, generator=gen,
                                              device="cuda") * 1e-3,
                        co["m"])}
    go["v"] = tree_map(lambda m: (m.abs() + 1e-3) ** 2, go["m"])
    co["m"] = tree_map(lambda t: t.cpu(), go["m"])
    co["v"] = tree_map(lambda t: t.cpu(), go["v"])
    spec = cpu.cfg.mx.weights
    w1 = cp["layers"][0]["mlp"]["w1"]
    a = convert.mx_quantize(w1, spec, axis=0)
    gc_, gs_ = mx_quantize_2d(w1.cuda().t().contiguous(), spec)
    if not (torch.equal(gc_.t().cpu(), a.codes)
            and torch.equal(gs_.t().cpu(), a.scales)):
        raise AssertionError("train card vs CPU: converter codes differ")
    if not torch.equal(fake_quantize(w1.cuda(), spec, axis=0).cpu(),
                       fake_quantize(w1, spec, axis=0)):
        raise AssertionError("train card vs CPU: fake-quant values differ")
    del a, gc_, gs_
    data = _train_data(cpu.cfg, (2, 64))
    opt_cfg = _train_opt(2)
    steps = [build_train_step(m, opt_cfg, fake_quant=True)
             for m in (card, cpu)]
    errs = {"loss": 0.0, "grad_norm": 0.0}
    losses = []
    for i in range(2):
        raw = data.batch(i)
        gp, go, gm = steps[0](gp, go, make_batch_for(card.cfg, raw), i)
        cp, co, cm = steps[1](cp, co, make_batch_for(cpu.cfg, raw,
                                                     device="cpu"), i)
        for k in errs:
            e = abs(float(gm[k]) - float(cm[k])) / abs(float(cm[k]))
            errs[k] = max(errs[k], e)
        losses.append((float(gm["loss"]), float(cm["loss"])))
    worst = 0.0
    for g, c in zip(leaves(go["master"]), leaves(co["master"])):
        c = c.cuda()
        worst = max(worst, float(((g - c).abs() / (
            TRAIN_CPU_MASTER_ATOL + TRAIN_CPU_MASTER_RTOL * c.abs())).max()))
    if errs["loss"] > TRAIN_CPU_LOSS_RTOL or \
            errs["grad_norm"] > TRAIN_CPU_LOSS_RTOL or worst > 1.0:
        raise AssertionError(f"train card vs CPU: rel errors {errs}, master "
                             f"at {worst} x its tolerance")
    emit("train_card_vs_cpu", layers=1, dtype="float32", batch=2, seq=64,
         quant=TRAIN_QUANT, steps=2, losses=losses, rel_err=errs,
         loss_rtol=TRAIN_CPU_LOSS_RTOL, master_worst_over_tol=worst,
         master_tol=(TRAIN_CPU_MASTER_RTOL, TRAIN_CPU_MASTER_ATOL),
         codes_equal=True, seconds=time.perf_counter() - t0)
    del gp, go, cp, co, card
    _free(torch)


def _rel_l2(a, b) -> float:
    """||a - b|| / ||b|| in f32 on ``a``'s device (``a`` the card's)."""
    a, b = a.detach().float(), b.detach().to(a.device).float()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def _grads_card_vs_cpu(torch, cpu, cp, shape=(2, 64), f32=None):
    """The model ``cpu`` (on the CPU: one full-width layer, or one group
    of the hybrid, in its dtype, no quant, remat on: the main path's
    settings but depth) and its twin on the card, batch ``shape``, from
    params ``cp``: every leaf has a gradient on both, and each leaf's
    gradient (``_grads_of``) and, after one train step from zero moments,
    its ``m`` (0.1 x the clipped gradient) agree within
    TRAIN_GRAD_RTOL[dtype] in relative L2 norm; loss and grad norm
    within it relatively.  A bf16 head on the card runs ``_HeadMM``,
    whose backward rounds the logits' gradient to bf16 (ROADMAP C10);
    the CPU's contracts in f32 as the reference does.

    With ``f32`` (the CPU's f32 gradients and ``m`` of the same params,
    as this function returns them) a bf16 run is held to those instead:
    each leaf's card error against them within TRAIN_BF16_VS_F32_RATIO
    times the CPU's plus TRAIN_GRAD_RTOL["float32"], loss and grad norm
    card against CPU within TRAIN_GRAD_RTOL["bfloat16"]; each leaf's
    card-against-CPU error is reported.  Returns the CPU's gradients and
    ``m`` by path."""
    from repro_torch.data import make_batch_for
    from repro_torch.models import Model
    from repro_torch.optim import adamw_init
    from repro_torch.train import build_train_step
    from repro_torch.train.step import _grads_of
    from repro_torch.tree import leaves_with_path, path_key, tree_map
    t0 = time.perf_counter()
    dtype = cpu.cfg.dtype
    tol = TRAIN_GRAD_RTOL[dtype]
    card = Model(cpu.cfg, device="cuda")
    models = (card, cpu)
    params = [tree_map(lambda t: t.cuda(), cp), cp]
    raw = _train_data(cpu.cfg, shape).batch(0)
    batches = [make_batch_for(m.cfg, raw, device=m.device) for m in models]
    grads, losses = [], []
    for m, p, b in zip(models, params, batches):
        loss, _, g = _grads_of(m, p, b, False)
        grads.append(g)
        losses.append(float(loss))
    pairs = list(zip(leaves_with_path(grads[0]), leaves_with_path(grads[1])))
    missing = [path_key(pa) for (pa, a), (_, b) in pairs
               if a is None or b is None]
    if missing:
        raise AssertionError(f"train grads {cpu.cfg.name} {dtype}: no "
                             f"gradient at {missing}")
    g_err = {path_key(pa): _rel_l2(a, b) for (pa, a), (_, b) in pairs}
    cpu_g = {path_key(pa): b.detach().float() for _, (pa, b) in pairs}
    card_g = {path_key(pa): a.detach().float().cpu()
              for (pa, a), _ in pairs} if f32 else None
    del grads, pairs
    opts, mets = [], []
    for m, p, b in zip(models, params, batches):
        _, o, met = build_train_step(m, _train_opt(TRAIN_STEPS))(
            p, adamw_init(p), b, 0)
        opts.append(o)
        mets.append({k: float(met[k]) for k in ("loss", "grad_norm")})
    m_pairs = list(zip(leaves_with_path(opts[0]["m"]),
                       leaves_with_path(opts[1]["m"])))
    m_err = {path_key(pa): _rel_l2(a, b) for (pa, a), (_, b) in m_pairs}
    cpu_m = {path_key(pa): b.float() for _, (pa, b) in m_pairs}
    s_err = {k: abs(mets[0][k] - mets[1][k]) / abs(mets[1][k])
             for k in mets[0]}
    s_err["grads_of_loss"] = abs(losses[0] - losses[1]) / abs(losses[1])
    worst = max(max(g_err.values()), max(m_err.values()),
                max(s_err.values()))
    vs_f32, bad = {}, []
    if f32:
        # each device's bf16 error against the f32 gradient and m of the
        # same params: the card's within the ratio of the CPU's
        card_m = {path_key(pa): a.float().cpu() for (pa, a), _ in m_pairs}
        slack = TRAIN_GRAD_RTOL["float32"]
        for name, card_t, cpu_t, ref_t in (("grad", card_g, cpu_g, f32[0]),
                                           ("m", card_m, cpu_m, f32[1])):
            for k, r in ref_t.items():
                e = (_rel_l2(card_t[k], r), _rel_l2(cpu_t[k], r))
                vs_f32[f"{name} {k}"] = e
                if e[0] > TRAIN_BF16_VS_F32_RATIO * e[1] + slack:
                    bad.append((f"{name} {k}", e))
        bad += [(k, e) for k, e in s_err.items() if e > tol]
        del card_g, card_m
    elif worst > tol:
        bad.append(("worst relative error", worst))
    emit("train_grads_card_vs_cpu", config=cpu.cfg.name,
         layers=cpu.cfg.n_layers, dtype=dtype, batch=shape[0], seq=shape[1],
         quant="none", remat=cpu.cfg.remat, leaves=len(g_err), rtol=tol,
         grad_rel_l2=g_err, m_rel_l2=m_err, scalar_rel_err=s_err,
         worst=worst, seconds=time.perf_counter() - t0,
         **({"vs_f32_card_cpu": vs_f32, "vs_f32_ratio":
             TRAIN_BF16_VS_F32_RATIO} if f32 else {}))
    if bad:
        raise AssertionError(f"train grads {cpu.cfg.name} {dtype}: {bad[:4]}"
                             + (f" over {TRAIN_BF16_VS_F32_RATIO} x the "
                                f"CPU's error against f32" if f32 else
                                f" over {tol}"))
    del params, opts, card, cpu
    _free(torch)
    return cpu_g, cpu_m


def _spawn(cmd, log, **kw):
    """``cmd`` in a subprocess from the checkout's root, its output in
    ``log``.out and ``log``.err."""
    with open(f"{log}.out", "w") as fo, open(f"{log}.err", "w") as fe:
        return subprocess.Popen(cmd, stdout=fo, stderr=fe, text=True,
                                cwd=str(ROOT), **kw)


def _stop(procs) -> None:
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _train_launcher(tmp):
    """The launcher on the card in two subprocesses, as a user runs it:
    reduced chatglm3-6b, 12 steps of 8 x 32, once as is and once with
    ``--quant auto:0.75 --save-policy``.  Both start now and run beside
    the caller's next work; the returned function waits for them: each
    exits 0 with a falling loss, and the saved table reloads (a run's
    ``seconds``: from its start to its collection).  Its ``stop`` ends
    them early (on a failure elsewhere)."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    runs = []
    for i, extra in enumerate(([], ["--quant", "auto:0.75", "--save-policy",
                                    str(tmp / "p.json")])):
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               "chatglm3_6b", "--reduced", "--steps", "12", "--batch", "8",
               "--seq", "32", "--ckpt-dir", str(tmp / f"l{i}"), *extra]
        log = tmp / f"l{i}"
        runs.append((cmd, extra, log, _spawn(cmd, log, env=env),
                     time.perf_counter()))

    def finish():
        import re
        from repro_torch.core.spec import PolicyTable
        rows = []
        try:
            for cmd, extra, log, proc, t0 in runs:
                rc = proc.wait(timeout=600)
                stdout = Path(f"{log}.out").read_text()
                if rc != 0:
                    raise AssertionError(
                        f"launcher {extra} exited {rc}:\n{stdout[-2000:]}"
                        f"\n{Path(f'{log}.err').read_text()[-4000:]}")
                m = re.search(r"done: loss ([\d.]+) -> ([\d.]+)", stdout)
                if not m or float(m.group(2)) >= float(m.group(1)):
                    raise AssertionError(f"launcher {extra}: no falling "
                                         f"loss in\n{stdout[-2000:]}")
                rows.append(dict(args=" ".join(cmd[3:]), loss_first=float(
                    m.group(1)), loss_last=float(m.group(2)),
                    seconds=time.perf_counter() - t0))
        finally:
            finish.stop()
        table = PolicyTable.from_json((tmp / "p.json").read_text())
        emit("train_launcher", runs=rows, table=table.to_json_dict())

    finish.stop = lambda: _stop([r[3] for r in runs])
    return finish


# checks that run in a subprocess of their own (``chip_smoke.py --check
# NAME``) beside the main process's work: most of their time is on the
# CPU, with a few CPU threads fewer so that the work beside them keeps
# its cores
SUB_CHECK_THREADS = 6
# the train phase's check runs beside GPU-bound steps and disk writes:
# every core
SUB_CHECK_THREADS_BY_NAME = {"train_card_vs_cpu": 8}


def _sub_check(name, tmp):
    """Start ``chip_smoke.py --check name`` (its output in ``tmp``);
    returns a function that waits for it, emits its rows here and raises
    if it failed; its ``stop`` ends the subprocess early."""
    log = tmp / name
    proc = _spawn([sys.executable, str(Path(__file__).resolve()),
                   "--check", name], log)

    def finish():
        try:
            rc = proc.wait(timeout=1200)
        finally:
            finish.stop()
        for line in Path(f"{log}.out").read_text().splitlines():
            if line.startswith("{"):
                row = json.loads(line)
                emit(row.pop("phase"), **row)
        if rc != 0:
            raise AssertionError(f"{name} (in a subprocess) exited {rc}:\n"
                                 f"{Path(f'{log}.err').read_text()[-4000:]}")

    finish.stop = lambda: _stop([proc])
    return finish


def train_phase(torch, flush_bytes=256 * 2 ** 20):
    """Phase 7 (see the module docstring).  Returns (launches of the
    driven runs, their launches per step by run, the converter's
    ``train_shapes`` rows)."""
    import tempfile
    launches, per_step = {}, {}
    # the card-against-CPU checks (most of their time on the CPU) in a
    # subprocess from the start of the phase, beside the driven runs, and
    # the launcher in two more, beside the resume
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        running = [_sub_check("train_card_vs_cpu", Path(d))]
        try:
            flush = torch.empty(flush_bytes, dtype=torch.uint8,
                                device="cuda")
            fq_rows = _fake_quant_rows(torch, flush)
            del flush
            for name, quant, steps, check, over in (
                    ("baseline", "none", TRAIN_STEPS, None, {}),
                    ("qat", TRAIN_QUANT, TRAIN_STEPS, _c9_check(torch), {}),
                    ("qat weights only", TRAIN_WEIGHTS_QUANT, 2, None,
                     dict(gate=False))):
                run = _train_run(torch, name, quant, steps, check, **over)
                per_step[name] = {k: n / steps for k, n in run.items() if n}
                for k, n in run.items():
                    launches[k] = launches.get(k, 0) + n
            _free(torch)
            running.append(_train_launcher(Path(d)))
            _train_resume(torch, Path(d))
            for finish in running:
                finish()
        finally:
            for finish in running:
                finish.stop()
    return launches, per_step, fq_rows


# =============================================================================
# phase 8: training the other families (MLA, the patch frontend, the
# hybrid, RWKV6, the encoder-decoder)
# =============================================================================
# (arch, depth overrides, baseline steps, lr): published widths, bf16,
# flash, remat, batches of TRAIN_SHAPE tokens (the encoder-decoder's as
# many frames, the patch frontend's 256 patch embeddings before them).
# Depth is cut where AdamW's state (~18 B a parameter with the bf16
# gradient) would not fit one card beside the step's activations.
# zamba2 trains at the launcher's lr.  From the reference's init at the
# published width its first gradient norm is 1.47e8 (it grows 2.4-2.6x
# per group, in the reference too: ROADMAP C13); clipped to 1.0, the
# gradients of Mamba2 blocks 20-37, the LM head and norm_f fall under
# AdamW's eps, its training loss stays flat over 20 steps at lr 1e-4 to
# 3e-3, and its held-out loss moved by +3.4e-3 at 3e-4 (PERF.md, an
# H100).  Its held-out gate therefore rules out a frozen optimizer; it
# does not show that zamba2 learns
TRAIN_FAMILIES = (
    # 20 of 38 layers (cut for the clock, PERF.md §4)
    ("zamba2_1p2b", {"n_layers": 20}, TRAIN_STEPS, TRAIN_LAUNCHER_LR),
    ("seamless_m4t_medium", {}, 3, TRAIN_LR),       # whole: 12 + 12
    ("rwkv6_7b", {"n_layers": 4}, 3, TRAIN_LR),     # 4 of 32
    ("deepseek_v2_236b", {"n_layers": 1}, 3, TRAIN_LR),  # layer 0: MLA
    ("internvl2_76b", {"n_layers": 1}, 3, TRAIN_LR),     # 1 of 80
)
TRAIN_FAMILY_QAT_STEPS = 2
# card against CPU, no quant, f32 and bf16, at full width, 2 x 128 tokens
# (eight WKV chunks, two SSD chunks): one RWKV6 block, held card against
# CPU in both; one zamba2 group, its shared block and two Mamba2 layers,
# held card against CPU in f32 and, in bf16, to the f32 gradients
# (TRAIN_BF16_VS_F32_RATIO)
TRAIN_FAMILY_CARD_VS_CPU = (("rwkv6_7b", {"n_layers": 1}, False),
                            ("zamba2_1p2b", {"n_layers": 2}, True))
TRAIN_FAMILY_CPU_SHAPE = (2, 128)
# the converter at the other families' fake-quant weight shapes (K x N)
TRAIN_FAMILY_FQ_SHAPES = {
    "zamba2 in_proj": (2048, 8384), "zamba2 out_proj": (4096, 2048),
    "zamba2 shared w1/w3": (2048, 8192),
    "rwkv6 cmix wk": (4096, 14336), "rwkv6 tmix wr..wo": (4096, 4096),
    "seamless w1": (1024, 4096), "deepseek-v2 MLA w_uq": (1536, 24576),
    "deepseek-v2 MLA w_dkv": (5120, 512),
}


def family_train_launches(cfg, fq: bool):
    """The converter's and flash attention's launches in one train step of
    ``cfg`` (bf16, remat as the config says), worked out from the code:
    under weights + activations QAT each fake-quantized matmul launches
    the converter twice (its weight and its input), and nothing is
    recomputed (no tensor inside a layer needs a gradient, C9); flash
    runs once per causal self-attention (the encoder's and the
    cross-attention are dense, MLA runs none), and once more in the
    backward pass where remat recomputes its unit."""
    mlp = 3 if cfg.gated_mlp else 2
    if cfg.family == "hybrid":
        sites = cfg.n_layers // cfg.attn_every
        matmuls = 2 * cfg.n_layers + sites * (4 + mlp)    # in/out_proj
        flash, recomputed = sites, sites
    elif cfg.family == "rwkv":
        matmuls = 8 * cfg.n_layers          # wr wk wv wg wo; cmix wk wv wr
        flash = recomputed = 0
    elif cfg.family == "encdec":
        matmuls = cfg.n_enc_layers * (4 + mlp) \
            + cfg.n_dec_layers * (8 + mlp)  # self and cross attention
        flash, recomputed = cfg.n_dec_layers, cfg.n_dec_layers
    else:
        if any(cfg.moe_layer(i) for i in range(cfg.n_layers)):
            raise ValueError("an MoE layer is not trained on the card")
        attn = (7 if cfg.q_lora else 6) if cfg.mla else 4
        matmuls = cfg.n_layers * (attn + mlp)
        flash = 0 if cfg.mla else cfg.n_layers
        recomputed = 0 if cfg.mla else cfg.n_layers - cfg.n_dense_layers
    if fq:
        return {"mx_quantize_2d": 2 * matmuls, "flash_attention": flash}
    return {"mx_quantize_2d": 0,
            "flash_attention": flash + (recomputed if cfg.remat else 0)}


def _family_train_model(torch, arch, over, quant, device="cuda"):
    from repro_torch.core.spec import QuantPolicy
    from repro_torch.models import Model, load_config
    return Model(load_config(arch, mx=QuantPolicy.parse(quant),
                             attn_impl="flash", **over), device=device)


def _family_grads_card_vs_cpu(torch):
    """Each of TRAIN_FAMILY_CARD_VS_CPU at full width, card against CPU
    (``_grads_card_vs_cpu``) in f32 and in bf16 from one set of params
    (seed 3, made on the CPU and rounded to bf16, so that the f32 run's
    gradients are those of the bf16 run's params), the bf16 run held to
    the f32 run's CPU gradients where the entry says so."""
    from repro_torch.tree import tree_map
    for arch, over, vs_f32 in TRAIN_FAMILY_CARD_VS_CPU:
        start = _family_train_model(torch, arch, over, "none", "cpu").init(
            seed=3)
        start = tree_map(lambda t: t.to(torch.bfloat16).float(), start)
        f32 = None
        for dtype in ("float32", "bfloat16"):
            cpu = _family_train_model(torch, arch, dict(
                over, dtype=dtype, param_dtype=dtype), "none", "cpu")
            params = tree_map(lambda t: t.to(getattr(torch, dtype),
                                             copy=True), start)
            out = _grads_card_vs_cpu(torch, cpu, params,
                                     TRAIN_FAMILY_CPU_SHAPE,
                                     f32=f32 if dtype == "bfloat16" else None)
            f32 = out if vs_f32 else None
        del start, f32, out
        _free(torch)


def train_families_phase(torch, flush_bytes=256 * 2 ** 20):
    """Phase 8 (see the module docstring).  Returns (launches of the
    driven runs, their launches per step by run, the converter's rows at
    the families' fake-quant shapes)."""
    flush = torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
    fq_rows = _fake_quant_rows(torch, flush, TRAIN_FAMILY_FQ_SHAPES)
    del flush
    launches, per_step = {}, {}
    for arch, over, steps, lr in TRAIN_FAMILIES:
        for quant, n in (("none", steps),
                         (TRAIN_QUANT, TRAIN_FAMILY_QAT_STEPS)):
            model = _family_train_model(torch, arch, over, quant)
            name = f"{arch} {'baseline' if quant == 'none' else 'qat'}"
            want = family_train_launches(model.cfg, quant != "none")
            run = _train_run(torch, name, quant, n, model=model, lr=lr,
                             per_step=want, phase="train_families",
                             gate=n >= TRAIN_STEPS)
            del model
            per_step[name] = {k: c / n for k, c in run.items() if c}
            for k, c in run.items():
                launches[k] = launches.get(k, 0) + c
    _free(torch)
    _family_grads_card_vs_cpu(torch)
    return launches, per_step, fq_rows


# =============================================================================
# phase 9: MX-compressed data-parallel training (train_dp)
# =============================================================================
DP_WORLD = 2            # ranks of the exchange and the step, both on one
#                         card through gloo (staged through host memory)
DP_LAYERS = 1           # chatglm3-6b cut to 1 of 28 layers for the clock
#                         (PERF.md §4); 0.93 G params at 2 layers,
#                         ~19 GB of bf16 params, f32 master, m, v and the
#                         exchange's f32 buffer per rank, so that two ranks
#                         fit one card beside their activations
DP_RUNS = (("baseline", "none", 3), ("qat", TRAIN_QUANT, 2))
DP_GRAD = ("w1 gradient (13696 x 4096)", (13696, 4096))
DP_RAGGED = ("ragged leaf (1,000,003)", (1_000_003,))
DP_TIMEOUT = 300        # seconds for the ranks (~90 measured); a hung
#                         collective fails the phase


def leaf_digest(torch, t) -> int:
    """A position-weighted 64-bit sum of a tensor's bits: sum over i of
    word_i x (i x 0x9E3779B97F4A7C15 | 1) mod 2^64, the words being the
    tensor's 2- or 4-byte elements.  Each weight is odd, so two tensors
    that differ in a single element always have other digests."""
    words = t.detach().contiguous().view(-1)
    words = words.view(torch.int16 if words.element_size() == 2
                       else torch.int32)
    acc = torch.zeros((), dtype=torch.int64, device=words.device)
    chunk = 1 << 24
    for a in range(0, words.numel(), chunk):
        part = words[a:a + chunk].to(torch.int64)
        w = torch.arange(a, a + part.numel(), dtype=torch.int64,
                         device=words.device)
        w.mul_(-7046029254386353131).bitwise_or_(1)   # 0x9E37...7C15
        acc += (part * w).sum()
    return int(acc)


def _dp_digests(torch, params, opt):
    from repro_torch.tree import leaves
    return [leaf_digest(torch, t) for t in leaves((params, opt))]


def _dp_exchange(torch, groups):
    """On each rank: the exchange of a leaf of its own (seeded by rank) in
    every format x mode, on the card (the converter kernel, gloo staged
    through host memory) and on the CPU (the plain converter, the same
    gloo groups), bit for bit; the card's wall ms and the analytic
    ``exchanged_bytes``."""
    import dataclasses
    from repro_torch.core.grad_compress import (exchanged_bytes,
                                                mx_allreduce_mean)
    from repro_torch.core.spec import QuantSpec
    from repro_torch.kernels.mx_quant import mx_quantize_2d
    dev = groups.device
    cpu = dataclasses.replace(groups, device=torch.device("cpu"))
    gen = torch.Generator(device=dev).manual_seed(100 + groups.rank)
    rows = []
    for leaf, shape in (DP_GRAD, DP_RAGGED):
        g = torch.randn(shape, generator=gen, device=dev) * 1e-3
        g_cpu = g.cpu()
        for fmt in FMTS:
            for mode in MODES:
                spec = QuantSpec(fmt, mode)
                before = mx_quantize_2d.launches
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = mx_allreduce_mean(g, groups, spec)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                want = mx_allreduce_mean(g_cpu, cpu, spec)
                if not torch.equal(out.cpu(), want):
                    raise AssertionError(
                        f"rank {groups.rank}: exchange of the {leaf} in "
                        f"{spec}: the card's output differs from the CPU's")
                rows.append(dict(
                    what="exchange", leaf=leaf, spec=str(spec),
                    elements=g.numel(), wall_ms=ms,
                    converter_launches=mx_quantize_2d.launches - before,
                    exchanged_bytes=exchanged_bytes(g.numel(), groups.world,
                                                    spec),
                    f32_allreduce_bytes=exchanged_bytes(
                        g.numel(), groups.world, spec, compressed=False),
                    digest=leaf_digest(torch, out),
                    bit_equal_cpu=True))
                if rows[-1]["converter_launches"] != 1:
                    raise AssertionError(f"exchange of the {leaf}: "
                                         f"{rows[-1]['converter_launches']} "
                                         f"converter launches, expected 1")
        del g, g_cpu, out, want
    return rows


def _dp_train(torch, groups):
    """On each rank: DP_RUNS of ``build_train_step_compressed_dp`` at
    full width, DP_LAYERS layers, bf16, flash, remat, global batches of
    TRAIN_SHAPE split over the ranks, each driven from 0: losses and
    grad norms finite, the params' and AdamW state's digests after each
    step, ms per step and peak memory, and the converter's and flash's
    launches per step exactly the exchanged leaves (one converter launch
    each) plus the QAT launches, and the flash launches, of
    ``_train_run``'s rule."""
    from repro_torch.data import make_batch_for
    from repro_torch.train import (build_train_step_compressed_dp,
                                   init_train_state)
    from repro_torch.tree import leaves
    rows = []
    for name, quant, steps in DP_RUNS:
        _free(torch)
        model = _train_model(torch, quant, n_layers=DP_LAYERS)
        cfg = model.cfg
        fq = quant != "none"
        params, opt = init_train_state(model, seed=0)
        step_fn = build_train_step_compressed_dp(
            model, _train_opt(steps), groups=groups, fake_quant=fq)
        data = _train_data(cfg)
        batches = [make_batch_for(cfg, data.batch(i), device=model.device)
                   for i in range(steps)]
        # a leaf the loss reaches only through a fake quantizer has no
        # gradient (C9): under weights + activations every layer leaf
        exchanged = len(leaves(params)) - (
            len(leaves(params["layers"])) if fq else 0)
        recompute = cfg.remat and not (fq and cfg.mx.activations is not None)
        passes = 2 if recompute else 1
        per_step = {"mx_quantize_2d": exchanged
                    + FQ_PER_LAYER[quant] * cfg.n_layers * passes,
                    "flash_attention": cfg.n_layers * passes}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, norms, ms, digests = [], [], [], []

        def run():
            nonlocal params, opt
            for i in range(steps):
                t0 = time.perf_counter()
                params, opt, met = step_fn(params, opt, batches[i], i)
                losses.append(float(met["loss"]))
                ms.append((time.perf_counter() - t0) * 1e3)
                norms.append(float(met["grad_norm"]))
                digests.append(_dp_digests(torch, params, opt))

        _, launches, wall = _drive(torch, run)
        if not all(math.isfinite(x) for x in losses + norms):
            raise AssertionError(f"train_dp {name} rank {groups.rank}: "
                                 f"losses {losses}, grad norms {norms}")
        _check_launches(f"train_dp {name} rank {groups.rank}", launches,
                        {k: n * steps for k, n in per_step.items()})
        rows.append(dict(
            what="train", path=name, config=cfg.name, layers=cfg.n_layers,
            batch=TRAIN_SHAPE[0], rank_batch=TRAIN_SHAPE[0] // groups.world,
            seq=TRAIN_SHAPE[1], dtype=cfg.dtype, remat=cfg.remat,
            quant=quant, steps=steps, losses=losses, grad_norms=norms,
            step_ms_all=ms, step_ms=statistics.median(ms[1:]),
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            params=sum(p.numel() for p in leaves(params)),
            exchanged_leaves=exchanged, launches=launches,
            launches_per_step={k: v / steps for k, v in launches.items()
                               if v},
            predicted_per_step=per_step, digests=digests, wall_s=wall))
        del params, opt, model, batches, step_fn
    _free(torch)
    return rows


def _dp_rank(rank, world, store, out, card):
    """One rank process of the ``train_dp`` phase (``dist.spawn``): the
    exchange checks, then the driven train runs; its rows go to
    ``out``/rank<r>.json."""
    import torch
    global CARD
    CARD = card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, 8 // world))
    from repro_torch.dist import close_dp, init_dp, rank_device
    groups = init_dp(rank, (world,), rank_device("cuda", rank), store)
    try:
        if groups.backend != "gloo" or not groups.staged:
            raise AssertionError(f"{world} ranks on one card: backend "
                                 f"{groups.backend}, expected gloo, staged")
        rows = _dp_exchange(torch, groups) + _dp_train(torch, groups)
    finally:
        close_dp()
    Path(out, f"rank{rank}.json").write_text(json.dumps(rows))


def _dp_kernel_rows(torch, flush_bytes=256 * 2 ** 20):
    """The kernels at the shapes the ``train_dp`` path gives them on one
    rank: the converter on its exchange shard (``_dp_shard_row``) and on
    its QAT activations (``_dp_act_rows``), flash attention at its batch
    (TRAIN_SHAPE split over DP_WORLD ranks, chatglm3-6b's heads), each
    against its plain version and timed.  Returns {kernel: rows}."""
    flush = torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(12)
    quant = [_dp_shard_row(torch, flush)] + _dp_act_rows(torch, flush, gen)
    b, s = TRAIN_SHAPE[0] // DP_WORLD, TRAIN_SHAPE[1]
    flash = _flash_row(torch, flush, gen, b, s, 32, 2, 128,
                       "chatglm3-6b, one rank's batch of train_dp")
    emit("check", kernel="flash_attention", what="train_dp's rank batch",
         compared=1, max_abs_err_bf16=flash["max_abs_err"],
         criterion=f"|kernel - plain| <= tol + tol * |plain|, tol "
                   f"{FLASH_TOL_BF16} (bf16)")
    return {"mx_quantize_2d": quant, "flash_attention": [flash]}


def _dp_shard_row(torch, flush):
    """The converter's launch on one rank's shard of the w1 gradient at
    world 2 (28,049,408 f32), e4m3: as the exchange makes it, (1, L), and
    as (L/32, 32) rows, bit-identical to each other and to the plain
    version, timed beside the byte bound and the plain version."""
    from repro_torch.core.spec import QuantSpec
    from repro_torch.kernels import ref
    from repro_torch.kernels.mx_quant import mx_quantize_2d
    n = DP_GRAD[1][0] * DP_GRAD[1][1] // DP_WORLD
    x = torch.randn(n, generator=torch.Generator(device="cuda").manual_seed(
        5), device="cuda") * 1e-3
    spec = QuantSpec("e4m3", "ocp")
    one, rows32 = x.view(1, n), x.view(n // 32, 32)
    c1, s1 = mx_quantize_2d(one, spec)
    c2, s2 = mx_quantize_2d(rows32, spec)
    rc, rs = ref.mx_quantize_2d_ref(one, spec)
    if not (torch.equal(c1, rc) and torch.equal(s1, rs)
            and torch.equal(c2.view(1, n), rc)
            and torch.equal(s2.view(1, -1), rs)):
        raise AssertionError("converter on the exchange shard: the (1, L) "
                             "and (L/32, 32) launches and the plain version "
                             "disagree")
    tb, by = bound(n * (4 + 1 + 1 / 32), n * CONVERTER_OPS_PER_ELEMENT,
                   F32_CUDA_CORE_FLOPS)
    row = dict(kernel="mx_quantize_2d",
               shape=f"exchange shard of the w1 gradient at world "
                     f"{DP_WORLD}: (1, {n})", spec=str(spec),
               max_abs_err=0.0,
               ms=time_ms(torch, lambda: mx_quantize_2d(one, spec),
                          flush=flush),
               rows32_ms=time_ms(torch, lambda: mx_quantize_2d(rows32, spec),
                                 flush=flush),
               plain_ms=time_ms(torch, lambda: ref.mx_quantize_2d_ref(
                   one, spec), flush=flush),
               bound_ms=tb, bound_by=by, library_ms=None, card=CARD)
    emit("time", **row)
    return row


def _dp_act_rows(torch, flush, gen):
    """QAT's activation fake-quant at one rank's rows (TRAIN_SHAPE split
    over DP_WORLD ranks) of bf16 matmul inputs, along K = 4096 (wq, wk,
    wv, wo, w1, w3) and 13696 (w2): the route (``ops.fake_quantize``,
    one converter launch over the input widened to f32) against the plain
    round trip, codes, scales and values bit for bit in TRAIN_FQ_FMTS
    (NaN and Inf blocks included); the launch timed in e4m3 beside its
    bound, the round trip and the plain version."""
    from repro_torch.core import convert
    from repro_torch.core.spec import QuantSpec
    from repro_torch.kernels import ref
    from repro_torch.kernels.mx_quant import mx_quantize_2d
    from repro_torch.kernels.ops import fake_quantize
    m = TRAIN_SHAPE[0] // DP_WORLD * TRAIN_SHAPE[1]
    rows = []
    for k in (4096, 13696):
        x = torch.randn(m, k, generator=gen, device="cuda").to(
            torch.bfloat16)
        x[5, 7] = float("nan")
        x[40, 33] = float("inf")
        xf = x.float()                          # the launch's input
        for fmt in TRAIN_FQ_FMTS:
            spec = QuantSpec(fmt, "ocp")
            codes, scales = mx_quantize_2d(xf, spec)
            want = convert.mx_quantize(xf, spec, axis=-1)
            got_v = fake_quantize(x, spec, axis=-1)
            want_v = convert.quantize_dequantize(xf, spec, axis=-1)
            if not (torch.equal(codes, want.codes)
                    and torch.equal(scales, want.scales)
                    and torch.equal(got_v.view(torch.int32),
                                    want_v.view(torch.int32))):
                raise AssertionError(f"activation fake quant ({m}, {k}) "
                                     f"{spec}: the kernel route differs "
                                     f"from the plain round trip")
        spec = QuantSpec("e4m3", "ocp")
        tb, by = bound(m * k * (4 + 1 + 1 / 32),
                       m * k * CONVERTER_OPS_PER_ELEMENT, F32_CUDA_CORE_FLOPS)
        rows.append(dict(
            kernel="mx_quantize_2d",
            shape=f"activation fake-quant of train_dp's rank batch: "
                  f"({m}, {k}) bf16 along K", spec=str(spec), max_abs_err=0.0,
            ms=time_ms(torch, lambda: mx_quantize_2d(xf, spec), flush=flush),
            round_trip_ms=time_ms(torch, lambda: fake_quantize(x, spec,
                                                               axis=-1),
                                  flush=flush),
            plain_ms=time_ms(torch, lambda: ref.mx_quantize_2d_ref(xf, spec),
                             flush=flush),
            bound_ms=tb, bound_by=by, library_ms=None, card=CARD))
        emit("time", **rows[-1])
        del x, xf
    emit("check", kernel="fake_quantize", what="train_dp's rank "
         "activations", compared=2 * len(TRAIN_FQ_FMTS),
         criterion="codes, scales and dequantized values bit-identical to "
                   "core.convert (NaN/Inf blocks included)")
    return rows


def _dp_world_one(torch, tmp):
    """World one through NCCL in this process: ``init_dp`` picks NCCL for
    one rank with a card of its own; the exchange's wire methods run
    through it on the card (reduce-scatter of f32, all-gather of f32 and
    of code bytes, each the identity at world one); and two steps of
    ``build_train_step_compressed_dp`` (which exchanges nothing at world
    one, as the reference's mesh of one device) equal two of
    ``build_train_step`` from the same start, bit for bit: metrics, and
    every leaf's digest of params and AdamW state."""
    from repro_torch.data import make_batch_for
    from repro_torch.dist import close_dp, init_dp
    from repro_torch.train import (build_train_step,
                                   build_train_step_compressed_dp,
                                   init_train_state)
    groups = init_dp(0, (1,), torch.device("cuda", 0), str(tmp / "store1"))
    try:
        if groups.backend != "nccl" or groups.staged:
            raise AssertionError(f"world one: backend {groups.backend}")
        x = torch.randn(1 << 20, generator=torch.Generator(
            device="cuda").manual_seed(13), device="cuda")
        codes = (x * 64).to(torch.int32).to(torch.uint8)
        for axis in groups.axes:
            scattered = groups.reduce_scatter(groups.to_wire(x), axis)
            gathered = groups.from_wire(groups.all_gather(scattered, axis))
            gathered_codes = groups.all_gather(codes, axis)
            if not (scattered.is_cuda and torch.equal(scattered, x)
                    and torch.equal(gathered, x)
                    and torch.equal(gathered_codes, codes)):
                raise AssertionError("world one: NCCL's reduce-scatter or "
                                     "all-gather is not the identity")
        runs = []
        for build in (build_train_step, build_train_step_compressed_dp):
            _free(torch)
            model = _train_model(torch, "none", n_layers=DP_LAYERS)
            params, opt = init_train_state(model, seed=0)
            kw = {} if build is build_train_step else {"groups": groups}
            step_fn = build(model, _train_opt(2), **kw)
            data = _train_data(model.cfg)
            mets = []
            for i in range(2):
                params, opt, met = step_fn(params, opt, make_batch_for(
                    model.cfg, data.batch(i), device=model.device), i)
                mets.append({k: float(v) for k, v in met.items()})
            runs.append((mets, _dp_digests(torch, params, opt)))
            del params, opt, model, step_fn
        if runs[0] != runs[1]:
            raise AssertionError("world one: the compressed-DP step differs "
                                 "from build_train_step")
    finally:
        close_dp()
        _free(torch)
    emit("train_dp", what="world one", backend=groups.backend, steps=2,
         layers=DP_LAYERS, nccl_collectives="reduce-scatter (f32) and "
         "all-gather (f32, uint8) of 2^20 elements on the card: identity", losses=[m["loss"] for m in runs[0][0]],
         criterion="metrics and every leaf's digest equal to "
                   "build_train_step's", card=CARD)


def _dp_launcher(tmp):
    """The launcher as a user runs it on the card: ``--compressed-dp
    --devices 2`` over reduced chatglm3-6b (two ranks on the card, gloo);
    starts now, the returned function waits: exit 0, the backend printed,
    a falling loss."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "chatglm3_6b", "--reduced", "--compressed-dp", "--devices",
           str(DP_WORLD), "--steps", "4", "--batch", "8", "--seq", "32",
           "--ckpt-dir", str(tmp / "dpl")]
    log = tmp / "dpl"
    proc, t0 = _spawn(cmd, log, env=env), time.perf_counter()

    def finish():
        import re
        try:
            rc = proc.wait(timeout=600)
        finally:
            finish.stop()
        stdout = Path(f"{log}.out").read_text()
        if rc != 0:
            raise AssertionError(f"launcher --compressed-dp exited {rc}:\n"
                                 f"{stdout[-2000:]}\n"
                                 f"{Path(f'{log}.err').read_text()[-4000:]}")
        m = re.search(r"done: loss ([\d.]+) -> ([\d.]+)", stdout)
        if ("over gloo (staged through host memory)" not in stdout or not m
                or float(m.group(2)) >= float(m.group(1))):
            raise AssertionError(f"launcher --compressed-dp:\n"
                                 f"{stdout[-2000:]}")
        emit("train_dp", what="launcher", args=" ".join(cmd[3:]),
             loss_first=float(m.group(1)), loss_last=float(m.group(2)),
             seconds=time.perf_counter() - t0, card=CARD)

    finish.stop = lambda: _stop([proc])
    return finish


def train_dp_phase(torch):
    """Phase 9 (see the module docstring).  Returns (the driven runs'
    launches summed over the ranks, launches per step per rank by run,
    {kernel: its rows at the path's shapes})."""
    import tempfile
    from repro_torch.dist import spawn
    kernel_rows = _dp_kernel_rows(torch)
    _free(torch)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        tmp = Path(d)
        spawn(_dp_rank, DP_WORLD, (DP_WORLD, str(tmp / "store"), d, CARD),
              timeout=DP_TIMEOUT)
        ranks = [json.loads((tmp / f"rank{r}.json").read_text())
                 for r in range(DP_WORLD)]
        # the launcher's run (reduced, mostly start-up) beside world one,
        # so that the ranks' step times share the host with nothing
        launcher = _dp_launcher(tmp)
        try:
            _dp_world_one(torch, tmp)
            launcher()
        finally:
            launcher.stop()
    launches, per_step = {}, {}
    for i, row in enumerate(ranks[0]):
        others = [r[i] for r in ranks[1:]]
        if any(o["digest" if row["what"] == "exchange" else "digests"]
               != row["digest" if row["what"] == "exchange" else "digests"]
               for o in others):
            raise AssertionError(f"train_dp: the ranks differ after "
                                 f"{row['what']} {row.get('path', '')} "
                                 f"{row.get('spec', '')}")
        if row["what"] == "train":
            for r in [row] + others:
                for k, n in r["launches"].items():
                    launches[k] = launches.get(k, 0) + n
            per_step[row["path"]] = row["launches_per_step"]
            row = dict(row, ranks_identical=True,
                       step_ms_by_rank=[r["step_ms"] for r in [row] + others],
                       peak_gib_by_rank=[r["peak_gib"]
                                         for r in [row] + others])
            row.pop("digests")
        emit("train_dp", world=DP_WORLD, backend="gloo (staged)", card=CARD,
             **row)
    return launches, per_step, kernel_rows


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


def card_vs_cpu(torch, arch="chatglm3_6b", new=3):
    """The continuous engine on 2 full-width f32 layers of ``arch`` (for
    moonshot-v1-16b-a3b its dense layer and one MoE layer), on the
    card and on the CPU: first-prefill logits within LOGITS_TOL, greedy
    tokens equal (a flip only at a top-2 gap below it)."""
    import numpy as np
    from repro_torch.launch.serve import build_model
    from repro_torch.models import Model
    from repro_torch.serve import ContinuousBatchingEngine
    model, params = build_model(arch, reduced=False, quant=POLICY,
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
                                       max_len=64 + new + 1, sync_every=8,
                                       prefill_bucket=64)
        outs.append([o.tolist() for o in _serve(eng, prompts, new)])
    # a token flip is accepted only where the logits that chose it have a
    # top-2 gap below the tolerance (traced on the card)
    flips = _flips(torch, model, params, prompts, *outs)
    emit("card_vs_cpu", config=model.cfg.name, layers=2, dtype="float32",
         n_experts=model.cfg.n_experts, logits_max_abs_err=err,
         tolerance=LOGITS_TOL, tokens=outs[0], cpu_tokens=outs[1],
         flips=flips, seconds=time.perf_counter() - t0)
    del params, model
    torch.cuda.empty_cache()


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
# phase 10: sharded serving (serve_shard)
# =============================================================================
SHARD_POLICY = "weights=e4m3@32:ocp,kv=int8@32:ocp"
SHARD_WORLD = 2         # ranks on mesh (1, 2) = ("data", "model"), both on
#                         the one card through gloo (staged through host
#                         memory, so the engines decode eagerly)
SHARD_NEW = 32          # continuous: 8 prompts of 64-128 tokens, greedy
SHARD_STATIC = (8, 128, 16)     # static: rows, prompt tokens, new tokens
SHARD_KN = {"wq": (4096, 2048), "wo": (2048, 4096), "w1/w3": (4096, 6848),
            "w2": (6848, 4096)}  # one rank's projections at model 2
SHARD_TIMEOUT = 420     # seconds for the ranks; a hung collective fails
SHARD_F32_NEW = 8       # the f32 twins' new tokens per prompt
SHARD_MXKV_TOL = 2e-2   # the f32 twin at MX KV against the whole model:
#                         reordered f32 sums flip an INT8 code wherever a
#                         value sits at a rounding boundary, a whole code
#                         step; its first-step logits moved 0.0078 on an
#                         H100 (PERF.md, sharded serving), so 2.5 times that
SHARD_POOL_MESH = (2, 1)    # --shard-pool: the slots and the page pool
#                             split over the same two ranks, as data ranks
SHARD_ROWSUM_TOL = 0.01     # the bf16 row-sum control's mismatch share


def _shard_inputs(vocab):
    """The phase's 8 continuous prompts (64-128 tokens) and its static
    batch (8 x 128), from numpy seeds 27 and 28."""
    import numpy as np
    rng = np.random.default_rng(27)
    prompts = [rng.integers(0, vocab, size=int(n)).astype(np.int32)
               for n in rng.integers(64, 129, size=8)]
    b, s, _ = SHARD_STATIC
    static = np.random.default_rng(28).integers(
        0, vocab, size=(b, s)).astype(np.int32)
    return prompts, static


def _shard_path(torch, model, params, rules=None):
    """The phase's serving path in this process (the whole model, or one
    rank's shard under ``rules`` and the installed mesh): the continuous
    engine over the 8 prompts, then the static engine at MX KV (decode
    through B4) and at bf16 KV (prefill through B5), each a driven path
    whose launches must be exactly its steps' (a layer's B2 7, KV write 1
    and B3 1 per decode step; B4 1 per static MX-KV decode step; B5 1
    per bf16-KV prefill; a captured static step's warm-up counts)."""
    import dataclasses
    from repro_torch.core.spec import QuantPolicy
    from repro_torch.models import Model
    from repro_torch.serve import GenerationConfig, ServeEngine
    cfg = model.cfg
    n_l = cfg.n_layers
    _, static = _shard_inputs(cfg.vocab)
    out = {}
    out["continuous"], out["engine"] = _shard_continuous(torch, model,
                                                         params, rules)
    b, s, new = SHARD_STATIC
    gen = GenerationConfig(max_new_tokens=new)
    bf16 = Model(dataclasses.replace(
        cfg, mx=QuantPolicy.parse(SHARD_POLICY.split(",")[0])),
        device=model.device)
    for kv, m in (("mx", model), ("bf16", bf16)):
        st = ServeEngine(m, params, max_len=s + new + 8, rules=rules)
        toks, launches, wall = _drive(torch, lambda: st.generate(
            {"tokens": static}, gen))
        dec = new - 1 + st.n_captures      # a capture's warm-up step counts
        want = {"mx_matmul_2d": 7 * n_l * (1 + dec)}
        if kv == "mx":
            want.update(mx_kv_write=n_l * (1 + dec),
                        mx_decode_attention=n_l * dec)
        else:
            want["flash_attention"] = n_l
        _check_launches(f"serve_shard static {kv}-KV", launches, want)
        out[f"static_{kv}"] = dict(
            tokens=toks.tolist(), launches=launches, wall_s=wall,
            prefill_s=st.phase["prefill"], decode_s=st.phase["decode"],
            decode_ms_per_step=st.phase["decode"] / (new - 1) * 1e3,
            captured=st.captures)
    out["first_logits"] = _first_logits(torch, model, params,
                                        out["engine"])
    return out


def _shard_continuous(torch, model, params, rules=None, name="continuous"):
    """The continuous engine over the phase's 8 prompts with SHARD_NEW new
    tokens, a driven path whose launches must be exactly its steps' (a
    layer's B2 7, KV write 1 and B3 1 a decode step; B2 7 and the KV
    write 1 a prefill batch).  Returns (its row, the engine)."""
    from repro_torch.serve import ContinuousBatchingEngine
    n_l = model.cfg.n_layers
    prompts, _ = _shard_inputs(model.cfg.vocab)
    eng = ContinuousBatchingEngine(
        model, params, max_slots=8, page_size=16,
        max_len=max(len(p) for p in prompts) + SHARD_NEW + 1, sync_every=8,
        rules=rules)
    toks, launches, wall = _drive(torch, lambda: _serve(eng, prompts,
                                                        SHARD_NEW))
    # a data rank prefills only the batches that hold its slots' requests
    steps, batches = eng.n_steps, eng.n_rank_prefills
    _check_launches(f"serve_shard {name}", launches, {
        "mx_matmul_2d": 7 * n_l * (steps + batches),
        "mx_kv_write": n_l * (steps + batches),
        "mx_paged_decode_attention": n_l * steps})
    ph = eng.phase
    return dict(
        tokens=[t.tolist() for t in toks], launches=launches, wall_s=wall,
        decode_steps=steps, prefill_batches=batches,
        prefill_s=ph["prefill"], decode_s=ph["decode"],
        decode_ms_per_step=ph["decode"] / steps * 1e3,
        captured=eng.captures,
        kv_pool_gib=eng.kv_pool_nbytes / 2 ** 30,
        pool_pages=int(next(iter(eng.pool.values())).shape[1]),
        launches_per_step={"mx_matmul_2d": 7 * n_l, "mx_kv_write": n_l,
                           "mx_paged_decode_attention": n_l}), eng


def _f32_twin(torch, model, params, mx_kv: bool):
    """The same weights at f32 activations: the MX weights as they are,
    every fp leaf (embedding, head, norms) widened exactly to f32; the KV
    cache MX as in ``model`` (``mx_kv``) or f32."""
    import dataclasses
    from repro_torch.core.mx_weight import MXWeight
    from repro_torch.core.spec import QuantPolicy
    from repro_torch.models import Model
    from repro_torch.tree import tree_map
    policy = SHARD_POLICY if mx_kv else SHARD_POLICY.split(",")[0]

    def widen(t):
        if isinstance(t, MXWeight) or not t.is_floating_point():
            return t
        return t.float()

    return (Model(dataclasses.replace(model.cfg, dtype="float32",
                                      mx=QuantPolicy.parse(policy)),
                  device=model.device),
            tree_map(widen, params))


def _first_logits(torch, model, params, eng=None):
    """Prompt 0's last-position logits of one prefill (under ``eng``'s
    sharding context where given)."""
    import contextlib
    prompt = _shard_inputs(model.cfg.vocab)[0][0]
    with eng._ctx() if eng is not None else contextlib.nullcontext():
        lg, _, _ = model.prefill(params, torch.from_numpy(
            prompt[None]).to(model.device), max_len=len(prompt))
    return lg[0, -1, :model.cfg.vocab].float().cpu()


def _shard_f32_path(torch, model, params, rules=None, mx_kv=False):
    """An f32 twin of the continuous run (``_f32_twin``: the same weights,
    activations and fp leaves in f32, the KV cache f32 or, ``mx_kv``, MX
    as in ``model``): the 8 prompts with SHARD_F32_NEW new tokens,
    launches exact, and the first step's logits.  At f32 KV reordered
    f32 sums are the only difference a sharded run has from the whole
    model; attention over the f32 pool is dense (a layer's B2 7 a step
    and prefill batch, B5 1 a prefill batch).  At MX KV the run writes the
    rank's KV heads through the KV-write kernel and attends them through
    B3 (a layer's B2 7 and KV write 1 a step and prefill batch, B3 1 a
    step), and an f32 difference at a code boundary moves a whole code
    (SHARD_MXKV_TOL)."""
    from repro_torch.serve import ContinuousBatchingEngine
    m32, p32 = _f32_twin(torch, model, params, mx_kv=mx_kv)
    n_l = m32.cfg.n_layers
    prompts, _ = _shard_inputs(m32.cfg.vocab)
    eng = ContinuousBatchingEngine(
        m32, p32, max_slots=8, page_size=16,
        max_len=max(len(p) for p in prompts) + SHARD_F32_NEW + 1,
        sync_every=8, rules=rules)
    toks, launches, wall = _drive(torch, lambda: _serve(eng, prompts,
                                                        SHARD_F32_NEW))
    steps, batches = eng.n_steps, eng.n_rank_prefills
    want = {"mx_matmul_2d": 7 * n_l * (steps + batches)}
    per_step = {"mx_matmul_2d": 7 * n_l}
    if mx_kv:
        want.update(mx_kv_write=n_l * (steps + batches),
                    mx_paged_decode_attention=n_l * steps)
        per_step.update(mx_kv_write=n_l, mx_paged_decode_attention=n_l)
    else:
        want["flash_attention"] = n_l * batches
    _check_launches(f"serve_shard continuous f32{' MX-KV' * mx_kv}",
                    launches, want)
    return dict(tokens=[t.tolist() for t in toks], launches=launches,
                wall_s=wall, decode_ms_per_step=eng.phase["decode"]
                / steps * 1e3, prefill_s=eng.phase["prefill"],
                launches_per_step=per_step,
                first_logits=_first_logits(torch, m32, p32, eng))


def _row_sum_control(torch, mesh):
    """The bf16 control of the row-parallel sum on a rank of a "model"
    mesh: bf16 x (8 x 13696) over chatglm3-6b's w2 (13696 x 4096, e4m3),
    K split over "model".  ``dense(tp="row")`` sums the f32 partials
    before the cast, so its bf16 output differs from the whole weight's
    only where reordered f32 sums straddle a bf16 rounding boundary;
    returns that share and the share the ranks' partials cast to bf16
    and then summed would differ in (the fault the f32 sum rules out)."""
    from repro_torch.core.mx_weight import MXWeight
    from repro_torch.core.spec import QuantSpec
    from repro_torch.dist.sharding import model_gather, set_mesh, shard_leaf
    from repro_torch.kernels.ops import mx_matmul_resident
    from repro_torch.models.layers import dense
    k, n = 13696, 4096
    gen = torch.Generator(device=mesh.device).manual_seed(33)
    w = torch.randn(k, n, generator=gen, device=mesh.device) / math.sqrt(k)
    x = torch.randn(8, k, generator=gen, device=mesh.device).to(
        torch.bfloat16)
    mw = MXWeight.quantize(w, QuantSpec.parse("e4m3@32:ocp"))
    del w
    with set_mesh(None):
        whole = dense(x, mw)
    piece = shard_leaf(mw, ("model", "data"), mesh)
    kl = k // mesh.size("model")
    xs = x[:, mesh.coord("model") * kl:][:, :kl].contiguous()
    got = dense(xs, piece, tp="row", k=k)
    parts = model_gather(mx_matmul_resident(xs, piece)[None], 0)
    fault = parts[0].to(torch.bfloat16)
    for p in parts[1:]:
        fault = fault + p.to(torch.bfloat16)
    return {"mismatch": float((got != whole).float().mean()),
            "fault_mismatch": float((fault != whole).float().mean()),
            "shape": f"bf16 x 8 x {k} over w2 {k} x {n}, K/{mesh.size('model')}"}


def _tp_ms_per_step(torch, eng, steps=8):
    """The collectives' milliseconds per decode step: ``steps`` eager
    window steps (the slots idle after the run; every layer's work and
    collectives still run) under the profiler, the ``tp.*`` spans'
    CPU time summed (staged collectives end in a synchronize, so their
    host time is their wall time)."""
    from torch.profiler import ProfilerActivity, profile
    with eng._ctx(), profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.window.run(steps)
        torch.cuda.synchronize()
    spans = {e.key: e.cpu_time_total / 1e3 / steps
             for e in prof.key_averages() if e.key.startswith("tp.")}
    return sum(spans.values()), spans


def _shard_rank(rank, world, store, out, card):
    """One rank process of ``serve_shard`` (``dist.spawn``): its shard of
    full-width chatglm3-6b placed as each piece is made, the phase's
    path, the first step's logits, the collectives' time per step; rows
    to ``out``/rank<r>.json, logits to rank<r>.pt.  Then, in the same
    process, the ``--shard-pool`` run (``_shard_pool_run``)."""
    import torch
    global CARD
    CARD = card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(max(1, 8 // world))
    from repro_torch.core.spec import QuantPolicy
    from repro_torch.dist import close_dp, init_dp, rank_device
    from repro_torch.dist.sharding import (make_rules, set_mesh,
                                           shard_params, use_rules)
    from repro_torch.launch.serve import build_model
    mesh = init_dp(rank, (1, world), rank_device("cuda", rank), store,
                   axes=("data", "model"))
    try:
        if mesh.backend != "gloo" or not mesh.staged:
            raise AssertionError(f"{world} ranks on one card: backend "
                                 f"{mesh.backend}, expected gloo, staged")
        rules = make_rules(mesh.axes, fsdp_params=False,
                           quant=QuantPolicy.parse(SHARD_POLICY))
        with set_mesh(mesh), use_rules(rules):
            torch.cuda.reset_peak_memory_stats()
            (model, params), load, load_s = _drive(torch, lambda: build_model(
                "chatglm3_6b", reduced=False, quant=SHARD_POLICY,
                weight_resident=True, device=str(mesh.device), seed=0,
                attn_impl="flash",
                place=lambda t: shard_params(t, mesh, rules)))
            _check_launches(f"serve_shard rank {rank} load", load,
                            {"mx_quantize_2d": 7 * model.cfg.n_layers})
            res = _shard_path(torch, model, params, rules)
            eng = res.pop("engine")
            tp_ms, spans = _tp_ms_per_step(torch, eng)
            del eng
            res["f32"] = _shard_f32_path(torch, model, params, rules)
            res["f32_mx"] = _shard_f32_path(torch, model, params, rules,
                                            mx_kv=True)
            res["rowsum"] = _row_sum_control(torch, mesh)
            torch.save({"bf16": res.pop("first_logits"),
                        "f32": res["f32"].pop("first_logits"),
                        "f32_mx": res["f32_mx"].pop("first_logits")},
                       Path(out, f"rank{rank}.pt"))
            res.update(rank=rank, load_s=load_s,
                       weight_gib=_weight_bytes(params) / 2 ** 30,
                       peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                       tp_ms_per_step=tp_ms, tp_spans_ms_per_step=spans)
            del model, params
    finally:
        close_dp()
    Path(out, f"rank{rank}.json").write_text(json.dumps(res))
    _free(torch)
    _shard_pool_run(torch, rank, store + "_pool", out)


def _shard_pool_run(torch, rank, store, out):
    """Rank ``rank`` of ``serve_shard``'s ``--shard-pool`` run on mesh
    SHARD_POOL_MESH = ("data", "model"), joined through ``store``: the
    whole model (a "model" axis of 1), its run of the decode slots and
    of the page pool (rules ``paged_pool_sharded``), the continuous run
    with its launches exact (B3 reads the rank's own pool); its row to
    ``out``/pool<r>.json."""
    from repro_torch.core.spec import QuantPolicy
    from repro_torch.dist import close_dp, init_dp, rank_device
    from repro_torch.dist.sharding import (make_rules, set_mesh,
                                           shard_params, use_rules)
    from repro_torch.launch.serve import build_model
    mesh = init_dp(rank, SHARD_POOL_MESH, rank_device("cuda", rank), store,
                   axes=("data", "model"))
    try:
        rules = make_rules(mesh.axes, fsdp_params=False,
                           paged_pool_sharded=True,
                           quant=QuantPolicy.parse(SHARD_POLICY))
        with set_mesh(mesh), use_rules(rules):
            model, params = build_model(
                "chatglm3_6b", reduced=False, quant=SHARD_POLICY,
                weight_resident=True, device=str(mesh.device), seed=0,
                attn_impl="flash",
                place=lambda t: shard_params(t, mesh, rules))
            res, eng = _shard_continuous(torch, model, params, rules,
                                         name=f"pool rank {rank}")
            res.update(rank=rank, captured=eng.captures,
                       slots=eng._sl)
            del eng
    finally:
        close_dp()
    Path(out, f"pool{rank}.json").write_text(json.dumps(res))


def _nccl_captured_identity(torch):
    """At a world of one over NCCL: an all-reduce and an all-gather on
    the card captured into a CUDA graph (after an eager warm-up, which
    makes NCCL's communicator) and replayed on new values must each
    give its input back bit for bit."""
    import torch.distributed as dist
    gen = torch.Generator(device="cuda").manual_seed(31)
    x = torch.randn(8, 4096, generator=gen, device="cuda")
    summed, gathered = x.clone(), torch.empty_like(x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        dist.all_reduce(summed)
        dist.all_gather_into_tensor(gathered, x)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        summed.copy_(x)
        dist.all_reduce(summed)
        dist.all_gather_into_tensor(gathered, x)
    x.copy_(torch.randn(8, 4096, generator=gen, device="cuda"))
    graph.replay()
    torch.cuda.synchronize()
    return torch.equal(summed, x) and torch.equal(gathered, x)


def _shard_kernel_rows(torch):
    """The kernels at a rank's shapes: B2 at the rank's projections of
    chatglm3-6b at model 2 (M 8), B3 at its heads (Hq 16 over Hkv 1),
    each timed beside its plain version, library call and bound; B3 and
    B4 over a cache of every KV head with q a slice from head0 (a rank at
    model 4), against their plain versions."""
    from repro_torch.core.mx_weight import MXWeight
    from repro_torch.core.spec import QuantSpec
    from repro_torch.kernels import ref
    from repro_torch.kernels.mx_decode_attn import (
        mx_decode_attention, mx_paged_decode_attention)
    from repro_torch.kernels.mx_matmul import mx_matmul_2d
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(29)
    spec = QuantSpec.parse("e4m3@32:ocp")
    rows = {"mx_matmul_2d": [], "mx_paged_decode_attention": []}
    for pname, (k, n) in SHARD_KN.items():
        w = (torch.randn(k, n, generator=gen, device="cuda")
             / math.sqrt(k))
        mw = MXWeight.quantize(w, spec)
        del w
        a = torch.randn(8, k, generator=gen, device="cuda").to(
            torch.bfloat16)
        rows["mx_matmul_2d"].append(_matmul_row(
            torch, ref, mx_matmul_2d, a, mw, mw.codes, spec,
            f"rank's {pname} {k}x{n}", flush))
    i8 = QuantSpec.parse("int8@32:ocp")
    q, kc, ks, vc, vs, bt, lengths = _paged_case(torch, i8, i8, gen,
                                                 hq=16, hkv=1)
    rows["mx_paged_decode_attention"].append(_time_paged_attention(
        torch, flush, (q.to(torch.bfloat16), kc, ks, vc, vs, bt, lengths),
        i8, i8, "int8@32:ocp/int8@32:ocp"))
    # head0: 8 of 32 q heads over both KV heads (rep 16)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    q, kc, ks, vc, vs, bt, lengths = _paged_case(torch, i8, i8, gen)
    n = 0
    for head0 in (8, 24):
        for dt in (torch.float32, torch.bfloat16):
            kw = dict(key_spec=i8, value_spec=i8, rep=16, head0=head0)
            qs = q[:, :, head0:head0 + 8].contiguous().to(dt)
            args = (qs, kc, ks, vc, vs, bt, lengths)
            _attn_check(torch, mx_paged_decode_attention(*args, **kw),
                        ref.mx_paged_decode_attention_ref(*args, **kw),
                        worst)
            cache = [t[bt[:, :4].to(torch.int64)].reshape(
                8, 64, 2, -1).contiguous() for t in (kc, ks, vc, vs)]
            for pos in (0, 37, 63):
                _attn_check(torch, mx_decode_attention(qs, *cache, pos, **kw),
                            ref.mx_decode_attention_ref(
                                qs, *cache, torch.full((8,), pos,
                                                       dtype=torch.int32,
                                                       device="cuda"),
                                **kw), worst)
            n += 4
    emit("check", kernel="mx_paged_decode_attention / mx_decode_attention",
         what="head0 8 and 24: 8 of 32 q heads over both KV heads",
         compared=n, max_abs_err_bf16=worst[torch.bfloat16],
         max_abs_err_f32=worst[torch.float32],
         criterion=f"f32 within {ATTN_TOL_F32}; bf16 within torch's bf16 "
                   f"defaults")
    del flush
    return rows


def serve_shard_phase(torch):
    """Phase 10 (see the module docstring).  Returns (the driven runs'
    launches summed over processes, launches per step by run, {kernel:
    its rows at a rank's shapes})."""
    import dataclasses
    import tempfile
    import numpy as np
    from repro_torch.core.spec import QuantPolicy
    from repro_torch.dist import close_dp, init_dp, spawn
    from repro_torch.dist.sharding import make_rules, set_mesh, use_rules
    from repro_torch.launch.serve import build_model
    from repro_torch.models import Model
    kernel_rows = _shard_kernel_rows(torch)
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    (model, params), load, load_s = _drive(torch, lambda: build_model(
        "chatglm3_6b", reduced=False, quant=SHARD_POLICY,
        weight_resident=True, device="cuda", seed=0, attn_impl="flash"))
    ref = _shard_path(torch, model, params)
    ref.pop("engine")
    ref["f32"] = _shard_f32_path(torch, model, params)
    ref["f32_mx"] = _shard_f32_path(torch, model, params, mx_kv=True)
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    for key in ("continuous", "static_mx", "static_bf16", "f32", "f32_mx"):
        add(ref[key]["launches"])
    # the noise of bf16 itself: the whole model's bf16 first-step logits
    # against its f32 twin's (the same weights, the same MX KV policy)
    eps_bf16 = max(LOGITS_TOL, float((ref["first_logits"] - _first_logits(
        torch, *_f32_twin(torch, model, params, mx_kv=True))).abs().max()))
    emit("serve_shard", what="unsharded", load_s=load_s,
         bf16_vs_f32_first_logits_max_abs_err=eps_bf16,
         weight_gib=_weight_bytes(params) / 2 ** 30,
         peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         **{k: {x: y for x, y in v.items()
                if x not in ("tokens", "first_logits")}
            for k, v in ref.items() if k != "first_logits"}, card=CARD)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        tmp = Path(d)
        # world one over NCCL: the same sharded code on mesh (1, 1),
        # captured, the unsharded tokens bit for bit
        mesh = init_dp(0, (1, 1), "cuda:0", str(tmp / "store1"),
                       axes=("data", "model"))
        try:
            if mesh.backend != "nccl":
                raise AssertionError(f"world one: backend {mesh.backend}")
            rules = make_rules(mesh.axes, fsdp_params=False,
                               quant=QuantPolicy.parse(SHARD_POLICY))
            with set_mesh(mesh), use_rules(rules):
                one = _shard_path(torch, model, params, rules)
            one.pop("engine")
            # the layers skip their collectives on axes of size 1: check
            # apart that NCCL's own capture into a graph at world one
            nccl_captured = _nccl_captured_identity(torch)
        finally:
            close_dp()
        for key in ("continuous", "static_mx", "static_bf16"):
            add(one[key]["launches"])
            if not one[key]["captured"] \
                    or one[key]["tokens"] != ref[key]["tokens"]:
                raise AssertionError(f"serve_shard world one {key}: "
                                     f"captured {one[key]['captured']}, "
                                     f"tokens equal "
                                     f"{one[key]['tokens'] == ref[key]['tokens']}")
        if not torch.equal(one["first_logits"], ref["first_logits"]):
            raise AssertionError("serve_shard world one: the first step's "
                                 "logits differ from the unsharded ones")
        if not nccl_captured:
            raise AssertionError("serve_shard world one: a captured NCCL "
                                 "all-reduce / all-gather is not the "
                                 "identity")
        emit("serve_shard", what="world one", backend=mesh.backend,
             mesh={"data": 1, "model": 1},
             captured=[one[k]["captured"] for k in
                       ("continuous", "static_mx", "static_bf16")],
             nccl_collectives_captured_identity=nccl_captured,
             criterion="tokens and first-step logits bit for bit equal to "
                       "the unsharded engines' (the layers skip their "
                       "collectives at size 1); an NCCL all-reduce and "
                       "all-gather captured into a graph, replayed, bit "
                       "for bit the identity", card=CARD)
        spawn(_shard_rank, SHARD_WORLD, (SHARD_WORLD, str(tmp / "store"),
                                         d, CARD), timeout=SHARD_TIMEOUT)
        ranks = [json.loads((tmp / f"rank{r}.json").read_text())
                 for r in range(SHARD_WORLD)]
        saved = [torch.load(tmp / f"rank{r}.pt")
                 for r in range(SHARD_WORLD)]
        pool = [json.loads((tmp / f"pool{r}.json").read_text())
                for r in range(SHARD_WORLD)]
    prompts, static = _shard_inputs(model.cfg.vocab)
    bf16 = Model(dataclasses.replace(model.cfg, mx=QuantPolicy.parse(
        SHARD_POLICY.split(",")[0])), device=model.device)
    # the first step's logits: at f32 activations and KV within
    # LOGITS_TOL (reordered f32 sums); at f32 activations and MX KV
    # within SHARD_MXKV_TOL (a code step where a value sits at a code
    # boundary); in bf16 no further from the whole model's than bf16
    # rounding itself moves them (eps_bf16, at least LOGITS_TOL)
    want = {"bf16": ref["first_logits"], "f32": ref["f32"]["first_logits"],
            "f32_mx": ref["f32_mx"]["first_logits"]}
    errs = {dt: [float((r[dt] - want[dt]).abs().max()) for r in saved]
            for dt in want}
    tol = {"f32": LOGITS_TOL, "f32_mx": SHARD_MXKV_TOL, "bf16": eps_bf16}
    emit("serve_shard", what="first-step logits", world=SHARD_WORLD,
         max_abs_err=errs, tolerance=tol,
         ranks_equal=all(torch.equal(saved[0][dt], saved[1][dt])
                         for dt in want), card=CARD)
    for dt in ("f32", "f32_mx", "bf16"):
        if not max(errs[dt]) <= tol[dt]:
            raise AssertionError(f"serve_shard: {dt} first-step logits "
                                 f"differ from the unsharded ones by "
                                 f"{errs[dt]} > {tol[dt]}")
        if not all(torch.equal(r[dt], saved[0][dt]) for r in saved):
            raise AssertionError(f"serve_shard: the ranks' {dt} "
                                 f"first-step logits differ")
    m32, p32 = _f32_twin(torch, model, params, mx_kv=False)
    m32x, p32x = _f32_twin(torch, model, params, mx_kv=True)
    per_step = {}
    for key, m, p, inputs, gap in (
            ("f32", m32, p32, prompts, LOGITS_TOL),
            ("f32_mx", m32x, p32x, prompts, SHARD_MXKV_TOL),
            ("continuous", model, params, prompts, eps_bf16),
            ("static_mx", model, params, list(static), eps_bf16),
            ("static_bf16", bf16, params, list(static), eps_bf16)):
        streams = [r[key]["tokens"] for r in ranks]
        if any(s != streams[0] for s in streams[1:]):
            raise AssertionError(f"serve_shard {key}: the ranks' tokens "
                                 f"differ")
        # a stream may differ only from a step whose unsharded top-2
        # logit gap is below the tolerance: LOGITS_TOL in f32, eps_bf16
        # in bf16
        flips = _flips(torch, m, p, inputs, streams[0],
                       ref[key]["tokens"], tol=gap)
        for r in ranks:
            add(r[key]["launches"])
        per_step[key] = ranks[0][key].get("launches_per_step", {})
        captured = [r[key].get("captured", False) for r in ranks]
        emit("serve_shard", what=key, world=SHARD_WORLD,
             mesh={"data": 1, "model": SHARD_WORLD},
             backend="gloo (staged)", ranks_identical=True,
             equal_to_unsharded=streams[0] == ref[key]["tokens"],
             flips=flips, flip_tolerance=gap,
             prefill_s=[r[key].get("prefill_s") for r in ranks],
             decode_ms_per_step=[r[key]["decode_ms_per_step"]
                                 for r in ranks],
             unsharded_decode_ms_per_step=ref[key]["decode_ms_per_step"],
             captured=captured,
             launches=[r[key]["launches"] for r in ranks], card=CARD)
    # the bf16 control of the row-parallel sum, on each rank
    ctl = [r["rowsum"] for r in ranks]
    emit("serve_shard", what="bf16 row-sum control", world=SHARD_WORLD,
         rows=ctl, tolerance=SHARD_ROWSUM_TOL, card=CARD)
    for c in ctl:
        if not c["mismatch"] <= SHARD_ROWSUM_TOL < c["fault_mismatch"]:
            raise AssertionError(f"serve_shard bf16 row-sum control: {c} "
                                 f"(mismatch must be at most "
                                 f"{SHARD_ROWSUM_TOL}, the fault's above)")
    # --shard-pool: each data rank its slots and its run of pages, B3 over
    # its own pool; the whole model on each rank, so the tokens are the
    # unsharded ones but for a flip at a top-2 gap below LOGITS_TOL
    streams = [r["tokens"] for r in pool]
    if any(t != streams[0] for t in streams[1:]):
        raise AssertionError("serve_shard --shard-pool: the ranks' tokens "
                             "differ")
    flips = _flips(torch, model, params, prompts, streams[0],
                   ref["continuous"]["tokens"])
    whole_pages = ref["continuous"]["pool_pages"]
    for r in pool:
        add(r["launches"])
        if r["pool_pages"] * len(pool) != whole_pages + len(pool) - 1:
            raise AssertionError(f"serve_shard --shard-pool: rank "
                                 f"{r['rank']} holds {r['pool_pages']} of "
                                 f"{whole_pages} pages")
    per_step["pool"] = pool[0]["launches_per_step"]
    emit("serve_shard", what="shard_pool",
         mesh=dict(zip(("data", "model"), SHARD_POOL_MESH)),
         backend="gloo (staged)", ranks_identical=True,
         equal_to_unsharded=streams[0] == ref["continuous"]["tokens"],
         flips=flips, flip_tolerance=LOGITS_TOL,
         pool_pages=[r["pool_pages"] for r in pool],
         unsharded_pool_pages=whole_pages, slots=[r["slots"] for r in pool],
         decode_ms_per_step=[r["decode_ms_per_step"] for r in pool],
         captured=[r["captured"] for r in pool],
         launches=[r["launches"] for r in pool], card=CARD)
    emit("serve_shard", what="ranks", world=SHARD_WORLD,
         weight_gib=[r["weight_gib"] for r in ranks],
         unsharded_weight_gib=_weight_bytes(params) / 2 ** 30,
         peak_gib=[r["peak_gib"] for r in ranks],
         load_s=[r["load_s"] for r in ranks],
         tp_ms_per_step=[r["tp_ms_per_step"] for r in ranks],
         tp_spans_ms_per_step=[r["tp_spans_ms_per_step"] for r in ranks],
         card=CARD)
    del model, params, bf16, m32, p32, m32x, p32x
    _free(torch)
    return launches, per_step, kernel_rows


# =============================================================================
# =============================================================================
# phase 11: sharded training (FSDP x TP) through launch/cells.py
# =============================================================================
TS_MESH = (2, 2)        # ("data", "model"): four gloo ranks on the one card
TS_LAYERS = 2           # chatglm3-6b cut to 2 of 28 layers
TS_SHAPE = (4, 512)     # the cut train cell: global batch x sequence
TS_RUNS = (("optimized", 3), ("baseline", 2))
TS_TWIN = (1, (2, 128))  # the f32 twin: layers, (batch, sequence)
TS_TIMEOUT = 600        # seconds for the ranks; a hung collective fails
# the f32 twin against the unsharded f32 step on the card: f32 sums in
# other orders (row-parallel partials, the FSDP reduce-scatter, the norm
# over shards); relative to the unsharded value (a master: to its leaf's
# largest value).  Measured on the H100 (PERF.md §6): loss and
# grad norm 0, masters 9.5e-8; the limits are ten times that or more
TS_TWIN_TOL = {"loss": 1e-6, "grad_norm": 1e-5, "master": 1e-6}
# bf16: a step's loss and grad norm against world one (the unsharded step,
# bit for bit), relative; measured at most 2.9e-5, the control without
# the column-parallel input's backward sum 0.49 (PERF.md §6)
TS_BF16_GATE = 1e-3
TS_PREFILL_TOL = 0.125  # bf16 prefill logits against the unsharded ones
#                         (row sums in bf16 under bf16_matmul_out;
#                         measured 0.054)
TS_LOGITS_TAIL = 16     # positions of each prefill row whose logits return


def _ts_opt():
    from repro_torch.optim import AdamWConfig
    # warm-up of one step; the steps run at indices 1.. (lr > 0)
    return AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=10)


def _ts_cell(mesh, variant, kind="train", layers=TS_LAYERS, shape=TS_SHAPE,
             device="cuda", **over):
    from repro_torch.launch.cells import build_cell
    from repro_torch.models.config import ShapeSpec
    return build_cell("chatglm3_6b", ShapeSpec(f"{kind}_shard", shape[1],
                                               shape[0], kind),
                      mesh, variant, n_layers_override=layers,
                      device=device, opt_cfg=_ts_opt(), overrides=over)


def _ts_batches(cfg, n, shape=TS_SHAPE, device="cuda"):
    from repro_torch.data import make_batch_for
    data = _train_data(cfg, shape)
    return [make_batch_for(cfg, data.batch(i), device=device)
            for i in range(1, n + 1)]


def _ts_moments(torch, opt, like=None, shardings=None, seed=7):
    """Random ``m`` and ``v`` (``v`` > 0) in place of zeros, drawn whole
    from ``seed`` leaf by leaf (``like``: the whole params' stand-ins)
    and, with ``shardings``, each cut to this rank's shard: a first step
    from them is set by the moments, not by the sign of gradients at f32
    noise."""
    from repro_torch.dist.sharding import shard_leaf
    from repro_torch.tree import leaves
    dev = leaves(opt)[0].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    ms, vs = leaves(opt["m"]), leaves(opt["v"])
    shapes = [t.shape for t in leaves(like if like is not None else ms)]
    shs = leaves(shardings) if shardings is not None else [None] * len(ms)
    for m, v, shape, sh in zip(ms, vs, shapes, shs):
        w = torch.randn(shape, generator=gen, device=dev) * 1e-3
        if sh is not None:
            w = shard_leaf(w, sh.spec, sh.mesh, dp=True)
        m.copy_(w)
        v.copy_((w.abs() + 1e-3) ** 2)
        del w
    return opt


def _ts_local_keys(mesh, pshard):
    """Per leaf (``leaves`` order): the chunk this rank holds, as the
    index along each split dim (None where whole)."""
    from repro_torch.dist.sharding import placed_spec
    from repro_torch.tree import leaves
    return [tuple(None if e is None else mesh.index(e)
                  for e in placed_spec(sh.spec, mesh))
            for sh in leaves(pshard)]


def _ts_train(torch, mesh, variant, steps):
    """One driven run of the train cell on this rank: placed shards of
    full-width chatglm3-6b at TS_LAYERS, ``steps`` steps from 0 with each
    kernel's launches, ms per step, metrics and the digests of every
    leaf; the last step under the profiler for the "tp.*", "fsdp.*" and
    "train_shard.*" spans."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.dist.sharding import shard_params
    from repro_torch.optim import adamw_init
    from repro_torch.tree import leaves
    cell = _ts_cell(mesh, variant, device=str(mesh.device))
    cfg = cell.cfg
    params = cell.model.init(seed=0, place=lambda t: shard_params(
        t, mesh, cell.rules))
    lp = params["layers"][0]
    held = dict(q_heads=lp["attn"]["wq"].shape[1] // cfg.hd,
                kv_heads=lp["attn"]["wk"].shape[1] // cfg.hd,
                ffn_cols=lp["mlp"]["w1"].shape[1],
                vocab_rows=params["embed"].shape[0],
                wq=list(lp["attn"]["wq"].shape), wo=list(lp["attn"]["wo"]
                                                         .shape),
                w2=list(lp["mlp"]["w2"].shape))
    opt = adamw_init(params)
    state_bytes = sum(t.numel() * t.element_size()
                      for t in leaves((params, opt)))
    whole = sum(int(math.prod(t.shape)) for t in leaves(cell.args[0]))
    batches = _ts_batches(cfg, steps)
    fq = cfg.mx.weights is not None
    passes = 2 if cfg.remat else 1
    per_step = {"mx_quantize_2d": (7 * cfg.n_layers * passes if fq else 0),
                "flash_attention": (cfg.n_layers * passes
                                    if cfg.attn_impl == "flash" else 0)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    met_all, ms, digests, spans = [], [], [], {}

    def run():
        nonlocal params, opt
        for i, batch in enumerate(batches, start=1):
            prof = profile(activities=[ProfilerActivity.CPU]) \
                if i == steps else None
            t0 = time.perf_counter()
            if prof:
                prof.__enter__()
            params, opt, met = cell.fn(params, opt, batch, i)
            torch.cuda.synchronize()
            if prof:
                prof.__exit__(None, None, None)
                spans.update({e.key: e.cpu_time_total / 1e3
                              for e in prof.key_averages()
                              if e.key.split(".")[0] in
                              ("tp", "fsdp", "train_shard", "train")})
            ms.append((time.perf_counter() - t0) * 1e3)
            met_all.append({k: float(v) for k, v in met.items()})
            digests.append([leaf_digest(torch, t)
                            for t in leaves((params, opt))])

    _, launches, wall = _drive(torch, run)
    losses = [m["loss"] for m in met_all]
    if not all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
               for m in met_all):
        raise AssertionError(f"train_shard {variant} rank {mesh.rank}: "
                             f"metrics {met_all}")
    _check_launches(f"train_shard {variant} rank {mesh.rank}", launches,
                    {k: n * steps for k, n in per_step.items()})
    row = dict(what="train", path=variant, layers=cfg.n_layers,
               batch=TS_SHAPE[0], seq=TS_SHAPE[1], dtype=cfg.dtype,
               remat=cfg.remat, steps=steps, metrics=met_all, losses=losses,
               step_ms_all=ms, step_ms=statistics.median(ms[1:]),
               spans_ms_last_step=spans,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               state_gib=state_bytes / 2 ** 30,
               whole_state_gib=whole * (cfg.torch_param_dtype.itemsize
                                        + 12) / 2 ** 30,
               held=held, launches=launches,
               launches_per_step={k: v / steps for k, v in launches.items()
                                  if v},
               predicted_per_step=per_step, digests=digests,
               keys=_ts_local_keys(mesh, cell.in_shardings[0]), wall_s=wall,
               rules={k: v for k, v in cell.rule_kw.items()})
    del params, opt, cell, batches
    _free(torch)
    return row


def _ts_control(torch, mesh):
    """The control: the optimized cell's first step with the
    column-parallel input's backward sum removed (``ModelCopy``'s
    backward the identity), on fresh params: its metrics."""
    from repro_torch.dist import groups as G
    from repro_torch.dist.sharding import shard_params
    from repro_torch.optim import adamw_init
    cell = _ts_cell(mesh, "optimized", device=str(mesh.device))
    params = cell.model.init(seed=0, place=lambda t: shard_params(
        t, mesh, cell.rules))
    opt = adamw_init(params)
    real = G.ModelCopy.backward
    G.ModelCopy.backward = staticmethod(lambda ctx, g: (g, None, None))
    try:
        _, _, met = cell.fn(params, opt, _ts_batches(cell.cfg, 1)[0], 1)
    finally:
        G.ModelCopy.backward = real
    del params, opt, cell
    _free(torch)
    return {k: float(v) for k, v in met.items()}


def _ts_twin_cell(mesh, device):
    layers, shape = TS_TWIN
    return _ts_cell(mesh, "baseline", layers=layers, shape=shape,
                    device=device, dtype="float32", param_dtype="float32")


def _ts_twin(torch, mesh, want_path):
    """The f32 twin on this rank: its step from placed params and random
    moments, and the largest difference of each of its master shards from
    the unsharded step's (``want_path``, read by memory map)."""
    from repro_torch.dist.sharding import placed_spec, shard_params
    from repro_torch.optim import adamw_init
    from repro_torch.tree import leaves, leaves_with_path, path_key
    cell = _ts_twin_cell(mesh, str(mesh.device))
    params = cell.model.init(seed=0, place=lambda t: shard_params(
        t, mesh, cell.rules))
    opt = _ts_moments(torch, adamw_init(params), cell.args[0],
                      cell.in_shardings[0])
    batch = _ts_batches(cell.cfg, 1, shape=TS_TWIN[1])[0]
    params, opt, met = cell.fn(params, opt, batch, 1)
    deadline = time.monotonic() + TS_TIMEOUT
    while not Path(want_path).exists():     # the main process writes it
        if time.monotonic() > deadline:
            raise TimeoutError(f"{want_path} never came")
        time.sleep(0.5)
    want = torch.load(want_path, mmap=True)
    worst = {}
    for (path, got), sh in zip(leaves_with_path(opt["master"]),
                               leaves(cell.in_shardings[0])):
        w = want["master"][path_key(path)]
        for dim, e in enumerate(placed_spec(sh.spec, mesh)):
            if e is not None:
                n = w.shape[dim] // mesh.size(e)
                w = w.narrow(dim, mesh.index(e) * n, n)
        w = w.to(got.device)
        worst[path_key(path)] = (float((got - w).abs().max()),
                                 float(w.abs().max()))
    del params, opt, cell
    _free(torch)
    return {"metrics": {k: float(v) for k, v in met.items()},
            "master_max_abs": worst}


def _ts_prefill(torch, mesh, out):
    """One batch of the optimized prefill cell on this rank (its rows and
    KV heads): the last TS_LOGITS_TAIL positions' logits and the cache,
    saved to ``out``; its launches."""
    from repro_torch.dist.sharding import shard_params
    cell = _ts_cell(mesh, "optimized", kind="prefill",
                    device=str(mesh.device))
    params = cell.model.init(seed=0, place=lambda t: shard_params(
        t, mesh, cell.rules))
    batch = {"tokens": _ts_batches(cell.cfg, 1)[0]["tokens"]}
    (logits, cache), launches, wall = _drive(
        torch, lambda: cell.fn(params, batch))
    _check_launches(f"train_shard prefill rank {mesh.rank}", launches,
                    {"mx_kv_write": cell.cfg.n_layers})
    torch.save({"logits": logits[:, -TS_LOGITS_TAIL:].cpu(),
                "cache": {k: v.cpu() for k, v in cache.items()}},
               Path(out, f"prefill{mesh.rank}.pt"))
    del params, cell, logits, cache
    _free(torch)
    return {"launches": launches, "wall_s": wall}


def _ts_check_backend(mesh):
    if mesh.backend != "gloo" or not mesh.staged:
        raise AssertionError(f"{mesh.world} ranks on one card: backend "
                             f"{mesh.backend}, expected gloo, staged")


def _ts_rank(rank, world, store, out, card):
    """One rank process of ``train_shard`` (``dist.spawn``): the driven
    optimized and baseline runs, the control, the f32 twin and the
    prefill cell; rows to ``out``/rank<r>.json."""
    import os
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    global CARD
    CARD = card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, 8 // world))
    from repro_torch.dist import close_dp, init_dp, rank_device
    mesh = init_dp(rank, TS_MESH, rank_device("cuda", rank), store,
                   axes=("data", "model"))
    try:
        _ts_check_backend(mesh)
        res = {"runs": [_ts_train(torch, mesh, v, n) for v, n in TS_RUNS],
               "control": _ts_control(torch, mesh),
               "twin": _ts_twin(torch, mesh, str(Path(out, "twin.pt"))),
               "prefill": _ts_prefill(torch, mesh, out),
               "coords": {a: mesh.coord(a) for a in mesh.axes}}
    finally:
        close_dp()
    Path(out, f"rank{rank}.json").write_text(json.dumps(res))


def _ts_twin_unsharded(torch, out):
    """The f32 twin's unsharded step on the card, beside the ranks: its
    metrics, and its updated master saved whole (host) for the ranks,
    which wait for the file."""
    from repro_torch.dist import world_one
    from repro_torch.optim import adamw_init
    from repro_torch.train import build_train_step
    from repro_torch.tree import leaves_with_path, path_key
    cell = _ts_twin_cell(world_one(("data", "model"), "cuda"), "cuda")
    params = cell.model.init(seed=0)
    opt = _ts_moments(torch, adamw_init(params))
    step = build_train_step(cell.model, _ts_opt())
    batch = _ts_batches(cell.cfg, 1, shape=TS_TWIN[1])[0]
    params, opt, met = step(params, opt, batch, 1)
    part = Path(f"{out}.part")
    torch.save({"master": {path_key(p): t.cpu()
                           for p, t in leaves_with_path(opt["master"])}},
               part)
    part.replace(out)           # the ranks read it once it is whole
    del params, opt, cell, step
    _free(torch)
    return {k: float(v) for k, v in met.items()}


def _ts_world_one(torch):
    """World one: the optimized train cell on a mesh of one (rules
    installed, every axis of size 1) against the port's unsharded
    ``build_train_step`` on the same seed's params and batches, every
    leaf's digest after each step; returns the unsharded metrics (the
    bf16 gate's yardstick) and the launches of the cell's run."""
    from repro_torch.dist import world_one
    from repro_torch.optim import adamw_init
    from repro_torch.train import build_train_step
    from repro_torch.tree import leaves
    steps = dict(TS_RUNS)["optimized"]
    out = {}
    for name in ("cell", "unsharded"):
        cell = _ts_cell(world_one(("data", "model"), "cuda"), "optimized")
        params = cell.model.init(seed=0)
        opt = adamw_init(params)
        fn = cell.fn if name == "cell" else build_train_step(
            cell.model, _ts_opt(), fake_quant=True)
        batches = _ts_batches(cell.cfg, steps)
        mets, digests = [], []
        for i, batch in enumerate(batches, start=1):
            params, opt, met = fn(params, opt, batch, i)
            mets.append({k: float(v) for k, v in met.items()})
            digests.append([leaf_digest(torch, t)
                            for t in leaves((params, opt))])
        out[name] = (mets, digests)
        del params, opt, cell, batches
        _free(torch)
    if out["cell"] != out["unsharded"]:
        raise AssertionError("train_shard world one: the cell on a mesh of "
                             "one differs from build_train_step")
    return out["unsharded"][0]


def _ts_prefill_unsharded(torch):
    """The optimized prefill cell's batch through the unsharded model on
    the card (no rules): its last positions' logits and its cache."""
    from repro_torch.dist import world_one
    cell = _ts_cell(world_one(("data", "model"), "cuda"), "optimized",
                    kind="prefill")
    params = cell.model.init(seed=0)
    tokens = _ts_batches(cell.cfg, 1)[0]["tokens"]
    with torch.no_grad():
        logits, cache, _ = cell.model.prefill(params, {"tokens": tokens},
                                              max_len=TS_SHAPE[1])
    res = (logits[:, -TS_LOGITS_TAIL:].cpu(),
           {k: v.cpu() for k, v in cache.items()})
    del params, cell, logits, cache
    _free(torch)
    return res


def _ts_kernel_rows(torch, flush_bytes=256 * 2 ** 20):
    """The kernels at a rank's shapes of ``train_shard`` (mesh (2, 2)):
    B1's fake-quant of the gathered shards (w1 4096 x 6848: K whole after
    the FSDP gather; w2 6848 x 4096: the rank's K rows over "model", N
    gathered) against the plain round trip, bit for bit in four formats,
    the K-sliced shard's codes and scales equal to the whole weight's
    sliced (its blocks line up), timed; B5 at the rank's batch and heads
    (2 x 512, Hq 16 / Hkv 1, D 128, bf16) beside SDPA."""
    from repro_torch.core import convert
    from repro_torch.core.spec import QuantSpec
    flush = torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(31)
    rows = _fake_quant_rows(torch, flush, {"rank's w1 (gathered)":
                                           (4096, 6848),
                                           "rank's w2 (K/model)":
                                           (6848, 4096)})
    w = torch.randn(13696, 4096, generator=gen, device="cuda") * 0.016
    spec = QuantSpec("e4m3", "ocp")
    whole = convert.mx_quantize(w, spec, axis=0)
    from repro_torch.kernels.ops import mx_quantize
    for r in range(TS_MESH[1]):
        part = mx_quantize(w[r * 6848:(r + 1) * 6848], spec, axis=0)
        if not (torch.equal(part.codes, whole.codes[r * 6848:(r + 1) * 6848])
                and torch.equal(part.scales,
                                whole.scales[r * 214:(r + 1) * 214])):
            raise AssertionError(f"w2's K rows of model rank {r}: the "
                                 f"shard's codes differ from the whole "
                                 f"weight's sliced")
    emit("check", kernel="mx_quantize_2d", what="w2's K shard at model 2",
         compared=TS_MESH[1], criterion="the shard's codes and scales = "
         "the whole weight's, sliced, bit for bit")
    flash = _flash_row(torch, flush, gen, TS_SHAPE[0] // TS_MESH[0],
                       TS_SHAPE[1], 32 // TS_MESH[1], 2 // TS_MESH[1], 128,
                       "chatglm3-6b, a rank's batch and heads of "
                       "train_shard")
    del flush, w, whole
    return {"mx_quantize_2d": rows, "flash_attention": [flash]}


def _rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def train_shard_phase(torch):
    """Phase 11 (see the module docstring).  Returns (the driven runs'
    launches summed over the ranks, launches per step per rank by run,
    {kernel: its rows at a rank's shapes})."""
    import tempfile
    import threading
    from repro_torch.dist import spawn
    kernel_rows = _ts_kernel_rows(torch)
    _free(torch)
    world = math.prod(TS_MESH)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        tmp = Path(d)
        # the ranks in a thread; this process's unsharded runs beside
        # them on the card (their host work is light)
        failed = []

        def ranks_run():
            try:
                spawn(_ts_rank, world, (world, str(tmp / "store"), d, CARD),
                      timeout=TS_TIMEOUT)
            except BaseException as e:      # re-raised below
                failed.append(e)

        t0 = time.perf_counter()
        thread = threading.Thread(target=ranks_run)
        thread.start()
        try:
            twin_want = _ts_twin_unsharded(torch, tmp / "twin.pt")
            one = _ts_world_one(torch)
            pre_want = _ts_prefill_unsharded(torch)
        finally:
            thread.join()
        ranks_s = time.perf_counter() - t0
        if failed:
            raise failed[0]
        ranks = [json.loads((tmp / f"rank{r}.json").read_text())
                 for r in range(world)]
        pre = [torch.load(tmp / f"prefill{r}.pt") for r in range(world)]
    launches, per_step = {}, {}
    for j, (variant, steps) in enumerate(TS_RUNS):
        rows = [r["runs"][j] for r in ranks]
        # ranks holding the same chunk of a leaf end each step alike
        for i in range(steps):
            for leaf in range(len(rows[0]["keys"])):
                seen = {}
                for r in rows:
                    key = tuple(r["keys"][leaf])
                    d = r["digests"][i][leaf]
                    if seen.setdefault(key, d) != d:
                        raise AssertionError(
                            f"train_shard {variant} step {i + 1}: ranks "
                            f"holding chunk {key} of leaf {leaf} differ")
            mets = [r["metrics"][i] for r in rows]
            if any(m != mets[0] for m in mets):
                raise AssertionError(f"train_shard {variant} step {i + 1}: "
                                     f"the ranks' metrics differ: {mets}")
        for r in rows:
            for k, n in r["launches"].items():
                launches[k] = launches.get(k, 0) + n
            ratio = r["state_gib"] / r["whole_state_gib"]
            if not 0.24 <= ratio <= 0.27:
                raise AssertionError(f"train_shard {variant}: a rank holds "
                                     f"{ratio:.4f} of the state, not about "
                                     f"a quarter")
        per_step[variant] = rows[0]["launches_per_step"]
        gate = None
        if variant == "optimized":
            gate = [{k: _rel(m[k], w[k]) for k in ("loss", "grad_norm")}
                    for m, w in zip(rows[0]["metrics"], one)]
            worst = max(max(g.values()) for g in gate)
            if worst > TS_BF16_GATE:
                raise AssertionError(f"train_shard optimized: metrics "
                                     f"{gate} off world one's beyond "
                                     f"{TS_BF16_GATE}")
        for r in rows:
            r.pop("digests")
            r.pop("keys")
        emit("train_shard", mesh=list(TS_MESH), backend="gloo (staged)",
             card=CARD, ranks_identical=True, world_one_bitwise=True,
             gate_vs_world_one=gate, gate=TS_BF16_GATE,
             state_fraction=[r["state_gib"] / r["whole_state_gib"]
                             for r in rows],
             step_ms_by_rank=[r["step_ms"] for r in rows],
             peak_gib_by_rank=[r["peak_gib"] for r in rows],
             ranks_wall_s=ranks_s, **rows[0])
    ctl = ranks[0]["control"]
    ctl_gate = _rel(ctl["grad_norm"], one[0]["grad_norm"])
    if ctl_gate <= TS_BF16_GATE:
        raise AssertionError(f"train_shard control: grad norm "
                             f"{ctl['grad_norm']} vs world one's "
                             f"{one[0]['grad_norm']} passes the gate")
    twin = [r["twin"] for r in ranks]
    twin_err = {"loss": _rel(twin[0]["metrics"]["loss"], twin_want["loss"]),
                "grad_norm": _rel(twin[0]["metrics"]["grad_norm"],
                                  twin_want["grad_norm"]),
                "master": max(e / max(m, 1e-30) for t in twin
                              for e, m in t["master_max_abs"].values())}
    bad = {k: v for k, v in twin_err.items() if v > TS_TWIN_TOL[k]}
    if bad:
        raise AssertionError(f"train_shard f32 twin: {bad} beyond "
                             f"{TS_TWIN_TOL}")
    # prefill: rank (d, m) holds rows of data rank d and KV head m
    logits_err, differ, total = 0.0, 0, 0
    b = TS_SHAPE[0] // TS_MESH[0]
    for r, got in zip(ranks, pre):
        d, m = r["coords"]["data"], r["coords"]["model"]
        want_l = pre_want[0][d * b:(d + 1) * b]
        logits_err = max(logits_err, float((got["logits"] - want_l).abs()
                                           .max()))
        for k, v in got["cache"].items():
            w = pre_want[1][k][:, d * b:(d + 1) * b, :, m:m + 1]
            if v.dtype == torch.uint8:
                differ += int((v != w).sum())
                total += v.numel()
    if logits_err > TS_PREFILL_TOL:
        raise AssertionError(f"train_shard prefill: logits {logits_err} "
                             f"off the unsharded beyond {TS_PREFILL_TOL}")
    for r in ranks:
        for k, n in r["prefill"]["launches"].items():
            launches[k] = launches.get(k, 0) + n
    emit("train_shard_checks", card=CARD, control_metrics=ctl,
         control_vs_world_one=ctl_gate, gate=TS_BF16_GATE,
         world_one_metrics=one, twin_unsharded=twin_want,
         twin_metrics=twin[0]["metrics"], twin_rel_err=twin_err,
         twin_tol=TS_TWIN_TOL,
         twin_master_max_abs=twin[0]["master_max_abs"],
         prefill_logits_max_abs=logits_err, prefill_tol=TS_PREFILL_TOL,
         prefill_code_share_differ=differ / max(total, 1),
         prefill_launches_rank0=ranks[0]["prefill"]["launches"])
    return launches, per_step, kernel_rows


def serve_card_vs_cpu(torch):
    """Phase 4's checks of chatglm3-6b: the continuous engine and
    ``ServeEngine`` at 2 full-width f32 layers, card against CPU, each
    with its phase_seconds row.  (Moonshot's stays in the main process:
    its CPU side's routing sits at a near-tie that another CPU thread
    count moves to another expert.)"""
    for name, fn in (("card vs CPU", card_vs_cpu),
                     ("static card vs CPU", static_card_vs_cpu)):
        t = time.perf_counter()
        fn(torch)
        emit("phase_seconds", name=name, seconds=time.perf_counter() - t)


# the card-against-CPU checks that run as ``chip_smoke.py --check NAME``
# subprocesses beside their phases (``_sub_check``)
SUB_CHECKS = {"serve_card_vs_cpu": serve_card_vs_cpu,
              "train_card_vs_cpu": _train_card_vs_cpu,
              "policy_card_vs_cpu": _policy_card_vs_cpu,
              "families_card_vs_cpu": families_card_vs_cpu}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every result row to this JSON file")
    ap.add_argument("--check", choices=sorted(SUB_CHECKS),
                    help=argparse.SUPPRESS)    # one check, as a subprocess
    args = ap.parse_args()
    # the deterministic train step (phase 7) needs cuBLAS's fixed
    # workspace, set before cuBLAS starts
    import os
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    global CARD
    CARD = smi
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.lib()
    if args.check:
        torch.set_num_threads(SUB_CHECK_THREADS_BY_NAME.get(
            args.check, SUB_CHECK_THREADS))
        SUB_CHECKS[args.check](torch)
        return 0
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
    family = check_family_shapes(torch, flush)
    for name, rows in check_other_family_shapes(torch, flush).items():
        family.setdefault(name, []).extend(rows)
    del flush
    torch.cuda.empty_cache()
    emit("phase_seconds", name="build and kernels",
         seconds=time.perf_counter() - t_start)

    def timed(name, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        emit("phase_seconds", name=name, seconds=time.perf_counter() - t)
        return out

    # this slice's paths first (the MoE step's profile of ~24k kernels is
    # the first of the process), each driven from 0: their launches join
    # the kernels line's
    # phase 4's card-against-CPU checks (most of their time on the CPU)
    # in a subprocess beside serve_moe and serve_yi (graph replays)
    import tempfile
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        check = _sub_check("serve_card_vs_cpu", Path(d))
        try:
            family_launches = [timed(name, path, torch)
                               for name, path in (("serve_moe", serve_moe),
                                                  ("serve_yi", serve_yi))]
            timed("card vs CPU checks (wait)", check)
        finally:
            check.stop()
    timed("MoE card vs CPU", card_vs_cpu, torch, MOE_ARCH, new=2)
    family_launches.append(timed("serve_families", serve_families, torch))
    launches = timed("chatglm3-6b serving", serve_full_width, torch)
    policy_launches, policy_rows = timed("serve_policy", serve_policy, torch)
    family_launches.append(policy_launches)
    for counts in family_launches:
        for kernel, n in counts.items():
            launches[kernel] = launches.get(kernel, 0) + n
    timed("head dim 48", serve_c5, torch)
    train_launches, train_per_step, train_rows = timed("train", train_phase,
                                                       torch)
    fam_launches, fam_per_step, fam_rows = timed(
        "train_families", train_families_phase, torch)
    dp_launches, dp_per_step, dp_rows = timed("train_dp", train_dp_phase,
                                              torch)
    shard_launches, shard_per_step, shard_rows = timed(
        "serve_shard", serve_shard_phase, torch)
    ts_launches, ts_per_step, ts_rows = timed(
        "train_shard", train_shard_phase, torch)
    for counts in (train_launches, fam_launches, dp_launches,
                   shard_launches, ts_launches):
        for kernel, n in counts.items():
            launches[kernel] = launches.get(kernel, 0) + n

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
        # the kernel at the formats the searched per-layer tables picked
        kernels[-1]["policy_shapes"] = [
            {k: r.get(k) for k in ("shape", "spec", "max_abs_err", "ms",
                                   "graph_ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms",
                                   "library_graph_ms", "launches",
                                   "launches_per_replay")}
            for r in policy_rows.get(name, ())]
        # the kernel at the GQA family's shapes
        kernels[-1]["family_shapes"] = [
            {k: r.get(k) for k in ("shape", "spec", "max_abs_err", "ms",
                                   "graph_ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms",
                                   "library_graph_ms")}
            for r in family.get(name, ())]
        # the training path (phase 7): launches per step of each driven
        # run, and the converter at the fake-quant shapes
        kernels[-1]["train_launches_per_step"] = {
            run: counts.get(name, 0) for run, counts in
            train_per_step.items()}
        # phase 8: the other families' training runs
        kernels[-1]["train_families_launches_per_step"] = {
            run: counts.get(name, 0) for run, counts in
            fam_per_step.items()}
        # phase 9: each rank's launches per step of the compressed-DP runs
        kernels[-1]["train_dp_launches_per_step"] = {
            run: counts.get(name, 0) for run, counts in dp_per_step.items()}
        shape_keys = ("shape", "spec", "max_abs_err", "ms", "round_trip_ms",
                      "rows32_ms", "plain_ms", "bound_ms", "bound_by",
                      "library_ms")
        if name == "mx_quantize_2d":
            for key, rows in (("train_shapes", train_rows),
                              ("train_families_shapes", fam_rows)):
                kernels[-1][key] = [{k: r.get(k) for k in shape_keys}
                                    for r in rows]
        # phase 9: the kernels at the shapes of one rank of train_dp
        kernels[-1]["train_dp_shapes"] = [{k: r.get(k) for k in shape_keys}
                                          for r in dp_rows.get(name, ())]
        # phase 10: each rank's launches per decode step of the sharded
        # continuous engine, and the kernels at a rank's shapes
        kernels[-1]["serve_shard_launches_per_step"] = \
            shard_per_step.get("continuous", {}).get(name, 0)
        kernels[-1]["serve_shard_shapes"] = [
            {k: r.get(k) for k in shape_keys + ("graph_ms",)}
            for r in shard_rows.get(name, ())]
        # phase 11: each rank's launches per step of the sharded train
        # cell's runs, and the kernels at a rank's shapes
        kernels[-1]["train_shard_launches_per_step"] = {
            run: counts.get(name, 0) for run, counts in ts_per_step.items()}
        kernels[-1]["train_shard_shapes"] = [
            {k: r.get(k) for k in shape_keys} for r in ts_rows.get(name, ())]
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
