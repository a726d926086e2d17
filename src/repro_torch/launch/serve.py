"""Serving launcher of the port (a subset of src/repro/launch/serve.py):
static-batch serving over a contiguous (MX) KV cache, or with --paged
continuous batching over the paged MX KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3_6b \\
        --batch 2 --prompt-len 24 --new-tokens 6 \\
        --quant weights=e4m3@32:ocp,kv_key=int8@32:ocp,kv_value=e2m1@32:ocp
    PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3_6b \\
        --paged --weight-resident --batch 8 --requests 16 --mixed \\
        --prompt-len 256 --new-tokens 64 --prefill-bucket 64 \\
        --quant weights=e4m3@32:ocp,kv_key=int8@32:ocp,kv_value=e2m1@32:ocp

Runs on the CUDA device, each decode step one replay of a captured CUDA
graph; ``--device cpu`` computes every kernel's plain version instead
(use it with ``--reduced``).  Attention runs through the kernels
(``attn_impl="flash"``, as the reference's serving cells set it).
``--temperature`` /
``--seed`` sample as the reference's flags do; paged mode runs the
numeric-health guards unless ``--no-health-checks``.  ``--prefix-cache``
shares the KV pages of common prompt prefixes (``--shared-prefix N``
gives every prompt N common leading tokens) and prints the hit rate and
the effective pool beside the allocated one; the tokens are those of a
run without it.  It needs MX KV pages (``kv_key`` / ``kv_value`` in
``--quant``): over an fp pool at ``"flash"`` the cold and the suffix
prefill attend by different routes, and the engine refuses it.
Weights are random, made on the device from seed 0; with
``--weight-resident`` each layer is quantized to MX storage as soon as
it is made.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Tuple

import numpy as np

from repro_torch.core.spec import QuantPolicy
from repro_torch.models import Model, load_config, load_reduced
from repro_torch.obs.metrics import rate
from repro_torch.serve import (ContinuousBatchingEngine, GenerationConfig,
                               ServeEngine)


def build_model(arch: str, *, reduced: bool, quant: str,
                weight_resident: bool, device: str = "cuda",
                seed: int = 0, **overrides) -> Tuple[Model, dict]:
    """Config + random weights on ``device`` (quantized layer by layer
    when ``weight_resident``)."""
    policy = QuantPolicy.parse(quant or "none")
    cfg = (load_reduced if reduced else load_config)(arch, mx=policy,
                                                      **overrides)
    if weight_resident and cfg.mx.weights is None:
        raise ValueError("--weight-resident needs a 'weights' role in the "
                         "policy, e.g. --quant weights=e4m3@32:ocp")
    model = Model(cfg, device=device)
    return model, model.init(seed=seed, quantize=weight_resident)


def make_prompts(n: int, prompt_len: int, mixed: bool, vocab: int,
                 shared_prefix: int = 0) -> List[np.ndarray]:
    """``n`` random prompts from seed 0; ``mixed`` draws lengths from
    [prompt_len // 4, 2 * prompt_len) (the reference launcher's rule);
    ``shared_prefix`` common leading tokens (a system prompt) go before
    every prompt."""
    rng = np.random.default_rng(0)
    if mixed:
        lens = rng.integers(max(1, prompt_len // 4), 2 * prompt_len, size=n)
    else:
        lens = np.full(n, prompt_len)
    shared = rng.integers(0, vocab, size=shared_prefix).astype(np.int32)
    return [np.concatenate([shared, rng.integers(0, vocab, size=int(m))
                            .astype(np.int32)]) for m in lens]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--paged", action="store_true",
                    help="continuous batching over the paged KV cache "
                         "(default: the static engine)")
    ap.add_argument("--weight-resident", action="store_true",
                    help="keep matmul weights as MX codes + scales")
    ap.add_argument("--quant", default=None,
                    help="policy, e.g. weights=e4m3@32:ocp,"
                         "kv_key=int8@32:ocp,kv_value=e2m1@32:ocp")
    ap.add_argument("--batch", type=int, default=8,
                    help="static batch, or decode slots with --paged")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--sync-every", type=int, default=8)
    ap.add_argument("--prefill-bucket", type=int, default=0,
                    help="pad prompts to a multiple of this (default: "
                         "the page size)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="paged mode: share full KV pages across requests "
                         "with a common prompt prefix (refcounted, "
                         "copy-on-write); only the uncached suffix is "
                         "prefilled, and the tokens stay those of a run "
                         "without it; needs MX KV pages (kv_key/kv_value "
                         "in --quant)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="give every prompt this many common leading "
                         "tokens (a system prompt)")
    ap.add_argument("--requests", type=int, default=0,
                    help="requests to serve (default 2 * batch)")
    ap.add_argument("--mixed", action="store_true",
                    help="mixed prompt lengths")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 samples greedily; above 0, Gumbel-max over "
                         "logits / temperature")
    ap.add_argument("--seed", type=int, default=0,
                    help="sampling seed (each request's stream folds in "
                         "its id)")
    ap.add_argument("--no-health-checks", action="store_true",
                    help="paged mode: turn off the numeric-health guards "
                         "(non-finite logits, MX poison markers)")
    ap.add_argument("--device", default="cuda",
                    help="cpu computes every kernel's plain version")
    args = ap.parse_args(argv)
    if args.no_health_checks and not args.paged:
        ap.error("--no-health-checks needs --paged (the guards live in "
                 "the paged engine)")
    if args.prefix_cache and not args.paged:
        ap.error("--prefix-cache needs --paged (prefixes share pages)")
    t0 = time.perf_counter()
    model, params = build_model(args.arch, reduced=args.reduced,
                                quant=args.quant,
                                weight_resident=args.weight_resident,
                                device=args.device, attn_impl="flash")
    cfg = model.cfg
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
          f"policy {cfg.mx}, built on {model.device} in "
          f"{time.perf_counter() - t0:.2f}s")
    if not args.paged:
        _serve_static(args, model, params)
        return
    prompts = make_prompts(args.requests or 2 * args.batch, args.prompt_len,
                           args.mixed, cfg.vocab, args.shared_prefix)
    max_len = max(len(p) for p in prompts) + args.new_tokens + 1
    eng = ContinuousBatchingEngine(
        model, params, max_slots=args.batch, page_size=args.page_size,
        max_len=max_len, sync_every=args.sync_every,
        prefill_bucket=args.prefill_bucket or None,
        gen=GenerationConfig(temperature=args.temperature, seed=args.seed),
        prefix_cache=args.prefix_cache,
        health_checks=not args.no_health_checks)
    t0 = time.perf_counter()
    for p in prompts:
        eng.add_request(p, args.new_tokens)
    out = eng.run()
    dt = time.perf_counter() - t0
    toks = sum(len(v) for v in out.values())
    ph = eng.phase
    print(f"[serve] {len(out)} requests, {toks} tokens in {dt:.2f}s — "
          f"{rate(toks, dt):.1f} tok/s, {eng.n_steps} decode steps in "
          f"{eng.n_syncs} windows, {eng.n_quarantined} quarantined")
    print(f"[serve] pools: weights {eng.weight_pool_nbytes / 2**20:.1f} MiB"
          f"{' (MX-resident)' if args.weight_resident else ' (fp)'}, "
          f"kv pages {eng.kv_pool_nbytes / 2**20:.1f} MiB")
    print(f"[serve] phase wall: prefill {ph['prefill']:.2f}s, decode "
          f"{ph['decode']:.2f}s, host-sync {ph['sync']:.2f}s; "
          f"{eng.prefill_tokens_computed} prefill tokens computed")
    if args.prefix_cache:
        px = eng.prefix
        print(f"[serve] prefix cache: hit rate {eng.prefix_hit_rate:.2f} "
              f"({px.hits}/{px.lookups} admissions), {px.tokens_matched} "
              f"tokens reused, {eng.n_cow_forks} COW forks, peak shared "
              f"pages {eng.peak_shared_pages}, effective pool "
              f"{eng.kv_pool_bytes_effective / 2**20:.2f} MiB (allocated "
              f"{eng.kv_pool_nbytes / 2**20:.2f} MiB)")
    first = min(out)
    print(f"[serve] sample tokens (request {first}): "
          f"{out[first][:16].tolist()}")


def _serve_static(args, model: Model, params) -> None:
    """Equal-length seeded prompts through ``ServeEngine``, twice: the
    first call, then a steady one."""
    cfg = model.cfg
    tokens = np.stack(make_prompts(args.batch, args.prompt_len, False,
                                   cfg.vocab))
    eng = ServeEngine(model, params,
                      max_len=args.prompt_len + args.new_tokens + 8)
    gen = GenerationConfig(max_new_tokens=args.new_tokens,
                           temperature=args.temperature, seed=args.seed)
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        out = eng.generate({"tokens": tokens}, gen)
        times.append(time.perf_counter() - t0)
    ph = eng.phase
    print(f"[serve] {cfg.name} quant={cfg.mx}: generated {out.size} tokens;"
          f" first {times[0]:.2f}s, steady {times[1]:.2f}s "
          f"({rate(out.size, times[1]):.1f} tok/s; prefill "
          f"{ph['prefill']:.3f}s, decode {ph['decode']:.3f}s)")
    print(f"[serve] weights {eng.weight_pool_nbytes / 2**20:.1f} MiB"
          f"{' (MX-resident)' if args.weight_resident else ' (fp)'}, "
          f"kv cache {eng.kv_cache_nbytes / 2**20:.2f} MiB")
    print("[serve] sample output tokens:", out[0][:12].tolist())


if __name__ == "__main__":
    main()
