"""Where a decode step's time goes on the card: traced decode steps.

    PYTHONPATH=src python -m repro_torch.launch.profile_decode

Builds full-width chatglm3-6b (all 28 layers) with 8-bit MX weights and
traces ``SYNC_EVERY`` decode steps of each serving path with
``torch.profiler`` (CPU + CUDA activities), 8 rows at ~256 positions:

- ``continuous``: 8 requests of 256 prompt tokens in 8 slots over INT8
  key / E2M1 value pages; after the admission cycle and a warm window,
  the next ``engine.step()`` — one window and nothing else;
- ``static_mx_kv`` and ``static_bf16_kv``: the static engine's decode
  loop (``Model.decode_step`` + greedy sampling, no host sync) over a
  contiguous cache that one prefill of 8 x 256 tokens filled, with INT8
  key / E2M1 value codes or bf16, after one warm step.

Prints one JSON line per path: wall time per step, the device's busy
time per step (union of kernel intervals), its busy share, kernel
launches per step, the MX decode-attention kernels' time per step (the
split kernel and the merge kernel apart), the fused KV write's time and
launches per step, and the kernels that take the most device time.
Needs a CUDA device.
"""
from __future__ import annotations

import dataclasses
import json
import time
from collections import defaultdict

import numpy as np
import torch

from repro_torch.core.spec import QuantPolicy
from repro_torch.launch.serve import build_model
from repro_torch.models import Model
from repro_torch.models.decoder import sample_tokens
from repro_torch.serve import ContinuousBatchingEngine

POLICY = "weights=e4m3@32:ocp,kv_key=int8@32:ocp,kv_value=e2m1@32:ocp"
PROMPT_LEN = 256
SYNC_EVERY = 8


def _union_us(intervals) -> float:
    total, end = 0.0, -float("inf")
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _trace(fn):
    """Run ``fn`` under the profiler; returns (profile, wall seconds)."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, wall


def _report(path: str, prof, wall: float, steps: int, layers: int) -> None:
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = _union_us((e.time_range.start, e.time_range.end)
                        for e in kernels)
    by_name = defaultdict(float)
    counts = defaultdict(int)
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us()
        counts[e.name] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    attn = {"split": 0.0, "merge": 0.0}      # MX decode attention, us
    kv_us = kv_n = 0
    for name, us in by_name.items():
        if "decode_attn" in name or "paged_attn" in name:
            attn["merge" if "merge" in name else "split"] += us
        if "mx_kv_write" in name:
            kv_us, kv_n = kv_us + us, kv_n + counts[name]
    print(json.dumps({
        "phase": "profile_decode", "path": path,
        "card": torch.cuda.get_device_name(0), "layers": layers, "rows": 8,
        "steps": steps, "wall_ms_per_step": wall * 1e3 / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "device_busy_share": busy_us / 1e6 / wall,
        "kernel_launches_per_step": len(kernels) / steps,
        "attention_ms_per_step": {k: us / 1e3 / steps
                                  for k, us in attn.items()},
        "kv_write_ms_per_step": kv_us / 1e3 / steps,
        "kv_write_launches_per_step": kv_n / steps,
        "top_kernels_ms_per_step": [
            {"name": n[:80], "ms": us / 1e3 / steps,
             "launches": counts[n] / steps} for n, us in top]}),
        flush=True)


def _static_steps(model: Model, params, tok, cache, pos: int, n: int):
    """The static engine's decode loop: ``n`` greedy steps from ``pos``."""
    for i in range(n):
        logits, cache = model.decode_step(params, tok, cache, pos + i)
        tok = sample_tokens(logits[:, -1, :model.cfg.vocab])
    return tok


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode needs a CUDA device")
    model, params = build_model("chatglm3_6b", reduced=False, quant=POLICY,
                                weight_resident=True, device="cuda",
                                seed=0)
    rng = np.random.default_rng(0)
    eng = ContinuousBatchingEngine(
        model, params, max_slots=8, page_size=16,
        max_len=PROMPT_LEN + 4 * SYNC_EVERY + 1,
        sync_every=SYNC_EVERY, prefill_bucket=64)
    prompts = rng.integers(0, model.cfg.vocab, size=(8, PROMPT_LEN))
    for p in prompts.astype(np.int32):
        eng.add_request(p, 4 * SYNC_EVERY)
    eng.step()                          # admission, prefill, first window
    eng.step()                          # warm
    steps0 = eng.n_steps
    prof, wall = _trace(eng.step)
    n_l = model.cfg.n_layers
    _report("continuous", prof, wall, eng.n_steps - steps0, n_l)
    del eng
    fp_kv = Model(dataclasses.replace(model.cfg, mx=QuantPolicy(
        weights=model.cfg.mx.weights)), device=model.device)
    tokens = torch.from_numpy(prompts.astype(np.int32)).cuda()
    for path, m in (("static_mx_kv", model), ("static_bf16_kv", fp_kv)):
        logits, cache, pos = m.prefill(
            params, tokens, max_len=PROMPT_LEN + SYNC_EVERY + 2)
        tok = sample_tokens(logits[:, -1, :m.cfg.vocab])
        tok = _static_steps(m, params, tok, cache, pos, 1)      # warm
        prof, wall = _trace(lambda: _static_steps(
            m, params, tok, cache, pos + 1, SYNC_EVERY))
        _report(path, prof, wall, SYNC_EVERY, n_l)
        del cache


if __name__ == "__main__":
    main()
