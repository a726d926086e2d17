"""Where a decode step's time goes on the card: one traced decode window.

    PYTHONPATH=src python -m repro_torch.launch.profile_decode

Builds full-width chatglm3-6b (all 28 layers) with the serving policy
(8-bit MX weights, INT8 key / E2M1 value pages), admits 8 requests of 256
prompt tokens into 8 slots, runs the admission cycle, then traces the next
``engine.step()`` — one window of ``SYNC_EVERY`` decode steps and nothing
else — with ``torch.profiler``
(CPU + CUDA activities).  Prints one JSON line: wall time per step, the
device's busy time per step (union of kernel intervals), its busy share,
kernel launches per step, and the kernels that take the most device
time.  Needs a CUDA device.
"""
from __future__ import annotations

import json
import time
from collections import defaultdict

import numpy as np
import torch

from repro_torch.launch.serve import build_model
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
    for _ in range(8):
        eng.add_request(rng.integers(0, model.cfg.vocab,
                                     size=PROMPT_LEN).astype(np.int32),
                        4 * SYNC_EVERY)
    eng.step()                          # admission, prefill, first window
    eng.step()                          # warm
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    steps0 = eng.n_steps
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = eng.n_steps - steps0
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
    print(json.dumps({
        "phase": "profile_decode", "card": torch.cuda.get_device_name(0),
        "layers": model.cfg.n_layers, "slots": 8, "steps": steps,
        "wall_ms_per_step": wall * 1e3 / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "device_busy_share": busy_us / 1e6 / wall,
        "kernel_launches_per_step": len(kernels) / steps,
        "top_kernels_ms_per_step": [
            {"name": n[:80], "ms": us / 1e3 / steps,
             "launches": counts[n] / steps} for n, us in top]}))


if __name__ == "__main__":
    main()
