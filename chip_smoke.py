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
   PyTorch library call on dequantized inputs, and the bound; the MX
   matmul, flash attention and both MX decode attentions in bf16 (tensor
   cores) and f32 (CUDA cores), and the matmul's rows bit-identical
   whatever the batch; decode attention's library call is timed under
   every SDPA backend that accepts it and the fastest reported, and the
   kernel and that call also replayed from a CUDA graph (device time
   without the host's per-call work);
3. serve full-width chatglm3-6b (28 layers, random weights from a seed)
   through ``ContinuousBatchingEngine`` with 8-bit MX weights, INT8 key
   pages and packed E2M1 value pages; count each kernel's launches on that
   run and check ``sync_every`` 1 and 8 give the same tokens; then serve a
   static batch through ``ServeEngine`` on the same weights, once with the
   MX KV cache (contiguous MX decode attention) and once with a bf16 cache
   (flash prefill), counting launches of each run, and check the
   continuous engine gives the static engine's tokens;
4. the continuous engine at full width but 2 layers in f32, once on the
   card and once on the CPU (the kernels' plain versions): first-prefill
   logits and greedy tokens must agree; likewise ``ServeEngine`` over an
   fp cache (flash prefill) on 2 full-width f32 layers.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
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
    from repro_torch.core.spec import QuantSpec
    from repro_torch.kernels import ref
    from repro_torch.kernels.mx_quant import mx_quantize_2d
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
    }
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
         criterion="bit-identical codes and scales")
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
                   bound_ms=tb, bound_by=by, library_ms=None)
        emit("time", **row)
        rows[name] = row
    return rows["kv_write (8 slots x 2 heads, D=128)"], 0.0


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


def _paged_case(torch, kspec, vspec, gen):
    from repro_torch.core.pack import pack_codes
    from repro_torch.kernels.mx_quant import mx_quantize_2d
    b, hq, hkv, d, page, npg = 8, 32, 2, 128, 16, 36
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
            for q in (q32, q32.to(torch.bfloat16),
                      (q32 * 8).to(torch.bfloat16)):
                _attn_check(torch, mx_decode_attention(q, *cache, pos, **kw),
                            ref.mx_decode_attention_ref(q, *cache, lengths,
                                                        **kw), worst)
                n_checked += 1
        if vspec.fmt != "e2m1":
            continue
        # timing at the static path's types: bf16 q, INT8 K / E2M1 V
        pos, q = 575, q32.to(torch.bfloat16)
        lengths = torch.full((b,), pos, dtype=torch.int32, device="cuda")
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
                   shape="8 rows, pos 575 of S 640, Hq 32, Hkv 2, D 128",
                   spec=kv,
                   ms=time_ms(torch, lambda: mx_decode_attention(
                       q, *cache, pos, **kw), flush=flush),
                   graph_ms=graph_ms(torch, lambda: mx_decode_attention(
                       q, *cache, pos, **kw), flush=flush),
                   library_graph_ms=sdpa_graph,
                   plain_ms=time_ms(torch, lambda: ref
                                    .mx_decode_attention_ref(
                                        q, *cache, lengths, **kw),
                                    flush=flush),
                   library_ms=sdpa[best], library_backend=best,
                   sdpa_ms=sdpa, bound_ms=tb, bound_by=by, live_tokens=live)
        emit("time", **row)
    emit("check", kernel="mx_decode_attention", compared=n_checked,
         max_abs_err_bf16=worst[torch.bfloat16],
         max_abs_err_f32=worst[torch.float32],
         criterion=f"f32 within {ATTN_TOL_F32}; bf16 within torch's bf16 "
                   f"defaults")
    return dict(row, max_abs_err_f32=worst[torch.float32]), \
        worst[torch.bfloat16]


def check_flash(torch, flush):
    """Flash attention at the static fp-KV prefill's shapes (8 prompts of
    512, 32 heads over 2 KV heads, D 128), ragged lengths and a causal
    Sq != Sk case (top-left alignment), in f32 (CUDA-core kernel) and bf16
    (tensor-core kernel, the main path's); bf16 also at D 32 and 64, and
    with scores scaled x8 (a peaked softmax: the online rescale with P in
    bf16).  Times bf16 and f32 at the serving shape, and bf16 with 32 KV
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
             (8, 512, 512, True, 128, 8.0, (torch.bfloat16,))]
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


# =============================================================================
# phase 3: full-width serving
# =============================================================================
def _counters():
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.kernels.mx_decode_attn import (mx_decode_attention,
                                                    mx_paged_decode_attention)
    from repro_torch.kernels.mx_matmul import mx_matmul_2d
    from repro_torch.kernels.mx_quant import mx_quantize_2d
    return {"mx_quantize_2d": mx_quantize_2d, "mx_matmul_2d": mx_matmul_2d,
            "mx_paged_decode_attention": mx_paged_decode_attention,
            "mx_decode_attention": mx_decode_attention,
            "flash_attention": flash_attention}


def _drive(torch, fn):
    """Run ``fn`` as a main path: every launch count set to 0 just before,
    read just after.  Returns (fn's result, launches, wall seconds)."""
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, {name: c.launches for name, c in counters.items()}, wall


def _check_launches(path, launches, want):
    """Each kernel launched exactly as often as the path implies; every
    kernel the path runs at least once."""
    for name, n in launches.items():
        if n != want.get(name, 0):
            raise AssertionError(f"{path}: {name} launched {n} times, "
                                 f"expected {want.get(name, 0)}")


def _flips(torch, model, params, prompts, got, want):
    """Token streams ``got`` against ``want`` per prompt: a stream may
    differ only from a step where the logits that chose the token have a
    top-2 gap below LOGITS_TOL (traced through ``model`` on ``want``'s
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
        if gap >= LOGITS_TOL:
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
    from repro_torch.serve import ContinuousBatchingEngine
    t0 = time.perf_counter()
    model, params = build_model("chatglm3_6b", reduced=False, quant=POLICY,
                                weight_resident=True, device="cuda", seed=0)
    torch.cuda.synchronize()
    cfg = model.cfg
    emit("serve_setup", config=cfg.name, layers=cfg.n_layers,
         d_model=cfg.d_model, d_ff=cfg.d_ff, vocab=cfg.vocab,
         policy=str(cfg.mx), build_s=time.perf_counter() - t0,
         device_mem_gib=torch.cuda.memory_allocated() / 2 ** 30)
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 513, size=16)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
               for n in lens]
    new = 64
    eng = ContinuousBatchingEngine(
        model, params, max_slots=8, page_size=16,
        max_len=int(lens.max()) + new + 1, sync_every=8, prefill_bucket=64)
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
         kv_pool_nbytes=eng.kv_pool_nbytes,
         weight_pool_nbytes=eng.weight_pool_nbytes, launches=launches,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    n_l = cfg.n_layers
    _check_launches("continuous serving", launches, {
        "mx_matmul_2d": 7 * n_l * (steps + batches),
        "mx_quantize_2d": 2 * n_l * (steps + batches),
        "mx_paged_decode_attention": n_l * steps})
    for p, o in zip(prompts, outs):
        if len(o) != new or o.min() < 0 or o.max() >= cfg.vocab:
            raise AssertionError(f"bad output for a {len(p)}-token prompt")
    # first-prefill logits of one prompt are finite and of the full vocab
    logits, _, _ = model.prefill(params, torch.from_numpy(
        prompts[0][None]).cuda(), max_len=len(prompts[0]))
    if logits.shape[-1] < cfg.vocab or not bool(torch.isfinite(
            logits).all()):
        raise AssertionError("non-finite or short prefill logits")
    # sync_every must not change the tokens (all 8 admitted at once)
    short = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
             for n in rng.integers(64, 257, size=8)]
    toks = []
    for se in (1, 8):
        e = ContinuousBatchingEngine(model, params, max_slots=8,
                                     page_size=16, max_len=256 + 17,
                                     sync_every=se, prefill_bucket=64)
        toks.append([o.tolist() for o in _serve(e, short, 16)])
    if toks[0] != toks[1]:
        raise AssertionError("sync_every=1 and sync_every=8 disagree")
    emit("sync_check", requests=8, new_tokens=16, identical=True)
    static = serve_static(torch, model, params)
    del params, model, eng
    torch.cuda.empty_cache()
    return {**launches, **static}


def serve_static(torch, model, params):
    """``ServeEngine`` on the full-width weights: 8 equal prompts of 512
    tokens, 64 new tokens, greedy; once over the MX KV cache of ``model``'s
    policy (decode through the contiguous MX decode kernel) and once over a
    bf16 cache (prefill through the flash kernel), each a main path of its
    own.  Then the continuous engine serves the same prompts under the MX
    policy and must give the static engine's tokens."""
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
                              "mx_quantize_2d": 2 * n_l * new}),
            ("bf16_kv", fp_kv, {"flash_attention": n_l,
                                "mx_matmul_2d": 7 * n_l * new}))
    gen = GenerationConfig(max_new_tokens=new)
    outs, counts = {}, {}
    for name, m, want in runs:
        eng = ServeEngine(m, params, max_len=s + new + 8)
        out, launches, wall = _drive(
            torch, lambda: eng.generate({"tokens": tokens}, gen))
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
        outs[name], counts[name] = out, launches
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
                                n_layers=2, dtype="float32")
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
                                n_layers=2, dtype="float32")
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
    m_row, m_err = check_matmul(torch, flush)
    a_row, a_err = check_paged_attention(torch, flush)
    d_row, d_err = check_decode_attention(torch, flush)
    f_row, f_err = check_flash(torch, flush)
    del flush
    torch.cuda.empty_cache()
    launches = serve_full_width(torch)
    card_vs_cpu(torch)

    sources = {"mx_quantize_2d": "src/repro_torch/csrc/mx_quant.cu",
               "mx_matmul_2d": "src/repro_torch/csrc/mx_matmul_tc.cu",
               "mx_paged_decode_attention":
                   "src/repro_torch/csrc/mx_decode_attn_tc.cu",
               "mx_decode_attention":
                   "src/repro_torch/csrc/mx_decode_attn_tc.cu",
               "flash_attention": "src/repro_torch/csrc/flash_attn_tc.cu"}
    replaces = {
        "mx_quantize_2d": "src/repro/kernels/mx_quant.py:117",
        "mx_matmul_2d": "src/repro/kernels/mx_matmul.py:140",
        "mx_paged_decode_attention":
            "src/repro/kernels/mx_decode_attn.py:310",
        "mx_decode_attention": "src/repro/kernels/mx_decode_attn.py:162",
        "flash_attention": "src/repro/kernels/flash_attn.py:99"}
    kernels = []
    for name, row, err in (("mx_quantize_2d", q_row, q_err),
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
        for key in ("max_abs_err_f32", "library_backend"):
            if key in row:      # the f32 kernel's error; SDPA's backend
                kernels[-1][key] = row[key]
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
