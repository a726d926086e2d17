"""Where a decode step's time goes on the card: traced decode steps, each
path as replays of its captured CUDA graph beside the eager loop of the
same step function, in the same call; then one traced prefill batch,
cold and prefix-cache hit.

    PYTHONPATH=src python -m repro_torch.launch.profile_decode

Builds full-width chatglm3-6b (all 28 layers) with 8-bit MX weights and
traces ``SYNC_EVERY`` decode steps of each serving path with
``torch.profiler`` (CPU + CUDA activities), 8 rows at ~256 positions:

- ``continuous``: 8 requests of 256 prompt tokens in 8 slots over INT8
  key / E2M1 value pages, health checks on.  After the admission cycle
  and a warm window: ``eager`` is ``Model.paged_decode_multi_step`` over
  the engine's next window (same pool, tables and state), then
  ``graph`` the next ``engine.step()`` — one window of replays with its
  state upload, poison check and one host transfer;
- ``static_mx_kv`` and ``static_bf16_kv``: after one prefill of 8 x 256
  tokens into a contiguous cache with INT8 key / E2M1 value codes or
  bf16, ``eager`` is ``Model.decode_step`` at host positions plus greedy
  sampling, ``graph`` the static engine's captured step
  (``StaticDecodeGraph``) replayed from the same position, each ending
  in one host transfer of the tokens.

Both modes of a path write the same cache positions with the same
values, so the second repeats the first's work.  Then one prefill
batch of each kind of the continuous engine with the prefix cache on
(``prefill``, after a warm batch of each): ``cold``, 8 prompts of 320
tokens with no cached prefix (the contiguous prefill and its page
scatter), and ``hit``, 8 prompts whose 256 leading tokens are cached
(the suffix prefill of 64 tokens each over the paged pool); one JSON
line each with the batch's wall time, device busy time and share, host
launch calls, device kernels, prompt tokens computed and top kernels.
Prints one JSON line per (path, mode): wall time per step, the device's
busy time per step
(union of kernel intervals), its busy share, the host's launch calls
per step (kernel launches and graph launches), device kernels per step,
decode tokens/s (8 rows over the wall time), the MX decode-attention
kernels' time per step (split and merge kernels apart), the fused KV
write's time and launches per step, and the kernels that take the most
device time.  Needs a CUDA device.
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
from repro_torch.models.decoder import request_keys, sample_tokens
from repro_torch.serve import ContinuousBatchingEngine
from repro_torch.serve.graphs import StaticDecodeGraph
from repro_torch.serve.paging import TRASH_PAGE

POLICY = "weights=e4m3@32:ocp,kv_key=int8@32:ocp,kv_value=e2m1@32:ocp"
PROMPT_LEN = 256
SYNC_EVERY = 8
ROWS = 8
# host-side CUDA API calls (`cuda*` and `cu*`) that start device work
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch")


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


def _kernels(prof):
    """(device kernel events, host launch calls, busy us, us and launches
    by kernel name) of a trace."""
    events = prof.events()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    launches = sum(e.name in LAUNCH_CALLS for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU)
    busy_us = _union_us((e.time_range.start, e.time_range.end)
                        for e in kernels)
    by_name = defaultdict(float)
    counts = defaultdict(int)
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us()
        counts[e.name] += 1
    return kernels, launches, busy_us, by_name, counts


def _report(path: str, mode: str, prof, wall: float, steps: int,
            layers: int) -> dict:
    kernels, launches, busy_us, by_name, counts = _kernels(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    attn = {"split": 0.0, "merge": 0.0}      # MX decode attention, us
    kv_us = kv_n = 0
    for name, us in by_name.items():
        if "decode_attn" in name or "paged_attn" in name:
            attn["merge" if "merge" in name else "split"] += us
        if "mx_kv_write" in name:
            kv_us, kv_n = kv_us + us, kv_n + counts[name]
    row = {
        "phase": "profile_decode", "path": path, "mode": mode,
        "card": torch.cuda.get_device_name(0), "layers": layers,
        "rows": ROWS, "steps": steps, "wall_ms_per_step": wall * 1e3 / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "device_busy_share": busy_us / 1e6 / wall,
        "host_launch_calls_per_step": launches / steps,
        "device_kernels_per_step": len(kernels) / steps,
        "decode_tokens_per_s": ROWS * steps / wall,
        "attention_ms_per_step": {k: us / 1e3 / steps
                                  for k, us in attn.items()},
        "kv_write_ms_per_step": kv_us / 1e3 / steps,
        "kv_write_launches_per_step": kv_n / steps,
        "top_kernels_ms_per_step": [
            {"name": n[:80], "ms": us / 1e3 / steps,
             "launches": counts[n] / steps} for n, us in top]}
    print(json.dumps(row), flush=True)
    return row


def _continuous(model: Model, params, prompts) -> None:
    eng = ContinuousBatchingEngine(
        model, params, max_slots=ROWS, page_size=16,
        max_len=PROMPT_LEN + 4 * SYNC_EVERY + 1,
        sync_every=SYNC_EVERY, prefill_bucket=64)
    for p in prompts:
        eng.add_request(p, 4 * SYNC_EVERY)
    eng.step()                          # admission, prefill, first window
    eng.step()                          # warm
    # the next window's pages, granted as the engine's step grants them
    eng.scheduler.plan_window(eng._lengths, SYNC_EVERY)
    eng._upload_tables()
    dev = model.device
    w = eng.window
    state = [torch.from_numpy(a.copy()).to(dev)
             for a in (eng._cur_tok, eng._lengths, eng._remaining)]
    keys = w.keys.clone()

    def eager():
        toks = model.paged_decode_multi_step(
            params, *state[:1], eng.pool, w.block_tables, *state[1:], keys,
            n_steps=SYNC_EVERY, trash_page=TRASH_PAGE, health=True)[0]
        return toks.cpu()

    n_l = model.cfg.n_layers
    prof, wall = _trace(eager)
    _report("continuous", "eager", prof, wall, SYNC_EVERY, n_l)
    steps0 = eng.n_steps
    prof, wall = _trace(eng.step)
    _report("continuous", "graph", prof, wall, eng.n_steps - steps0, n_l)


def _static(path: str, m: Model, params, prompts) -> None:
    dev = m.device
    vocab = m.cfg.vocab
    max_len = PROMPT_LEN + 2 * SYNC_EVERY + 2
    graph = StaticDecodeGraph(m, params, batch=ROWS, max_len=max_len)
    logits, cache, pos = m.prefill(
        params, torch.from_numpy(prompts).to(dev), max_len=max_len,
        cache=graph.cache)
    keys = request_keys(torch.arange(ROWS, dtype=torch.int64)).to(dev)
    keys, tok = sample_tokens(logits[:, -1, :vocab], keys, 0.0)
    del logits
    graph.run(tok, keys, pos, 1)       # warm, then both from pos + 1
    tok, pos = graph.token.clone(), pos + 1

    def eager():
        t, k = tok, keys
        out = []
        for i in range(SYNC_EVERY):
            lg, _ = m.decode_step(params, t, cache, pos + i)
            k, t = sample_tokens(lg[:, -1, :vocab], k, 0.0)
            out.append(t)
        return torch.stack(out).cpu()

    n_l = m.cfg.n_layers
    prof, wall = _trace(eager)
    _report(path, "eager", prof, wall, SYNC_EVERY, n_l)
    prof, wall = _trace(
        lambda: graph.run(tok, keys, pos, SYNC_EVERY).cpu())
    _report(path, "graph", prof, wall, SYNC_EVERY, n_l)


def _prefill(model: Model, params, rng) -> None:
    """One cold and one hit prefill batch of 8 prompts, traced (see the
    module docstring); each after an untraced batch of its kind."""
    vocab = model.cfg.vocab
    system = rng.integers(0, vocab, size=PROMPT_LEN).astype(np.int32)
    max_len = PROMPT_LEN + 64 + 1
    # room for every batch's pages in the trie: no reclaim drops the
    # shared system prompt before the traced hit batch
    eng = ContinuousBatchingEngine(
        model, params, max_slots=ROWS, page_size=16, max_len=max_len,
        num_pages=1 + 4 * ROWS * -(-max_len // 16), sync_every=SYNC_EVERY,
        prefill_bucket=64, prefix_cache=True)

    def batch(shared: bool) -> int:
        """Admit 8 prompts (a shared system prompt + 64 tokens, or 320
        fresh tokens) and prefill them; one new token each, so each
        request finishes, publishing its pages, at its prefill."""
        for _ in range(ROWS):
            tail = rng.integers(0, vocab, size=64).astype(np.int32)
            head = system if shared else rng.integers(
                0, vocab, size=PROMPT_LEN).astype(np.int32)
            eng.add_request(np.concatenate([head, tail]), 1)
        before = eng.prefill_tokens_computed
        eng._batched_prefill(eng.scheduler.admit(), [])
        torch.cuda.synchronize()
        return eng.prefill_tokens_computed - before

    batch(True)                         # warm: cold, publishes the system
    batch(True)                         # warm: hits
    for mode, shared in (("cold", False), ("hit", True)):
        tokens = {}
        prof, wall = _trace(lambda: tokens.setdefault("n", batch(shared)))
        kernels, launches, busy_us, by_name, counts = _kernels(prof)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        print(json.dumps({
            "phase": "profile_prefill", "path": "continuous prefill",
            "mode": mode, "card": torch.cuda.get_device_name(0),
            "layers": model.cfg.n_layers, "rows": ROWS,
            "prompt_tokens_computed": tokens["n"], "wall_ms": wall * 1e3,
            "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / 1e6 / wall,
            "host_launch_calls": launches, "device_kernels": len(kernels),
            "top_kernels_ms": [{"name": n[:80], "ms": us / 1e3,
                                "launches": counts[n]} for n, us in top]}),
            flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode needs a CUDA device")
    model, params = build_model("chatglm3_6b", reduced=False, quant=POLICY,
                                weight_resident=True, device="cuda",
                                seed=0, attn_impl="flash")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, model.cfg.vocab,
                           size=(ROWS, PROMPT_LEN)).astype(np.int32)
    _continuous(model, params, prompts)
    torch.cuda.empty_cache()
    fp_kv = Model(dataclasses.replace(model.cfg, mx=QuantPolicy(
        weights=model.cfg.mx.weights)), device=model.device)
    for path, m in (("static_mx_kv", model), ("static_bf16_kv", fp_kv)):
        _static(path, m, params, prompts)
        torch.cuda.empty_cache()
    _prefill(model, params, rng)


if __name__ == "__main__":
    main()
