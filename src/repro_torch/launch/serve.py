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
(use it with ``--reduced``).  ``--arch`` takes every entry of
``repro_torch.models.ARCH_IDS``.  The GQA decoders (dense and MoE)
serve through both paths; the other archs (MLA ``deepseek_v2_236b``,
the patch frontend ``internvl2_76b``, the hybrid ``zamba2_1p2b``,
``rwkv6_7b`` and the encoder-decoder ``seamless_m4t_medium``) through
the static path only: ``--paged`` is refused for them, as the
reference's continuous engine refuses them, and ``--weight-resident``
is taken by ``internvl2_76b`` alone among them.  Attention runs
through the kernels (``attn_impl="flash"``, as the reference's serving
cells set it), but for ``--prefix-cache`` over an fp KV pool, which
serves at ``"dense"`` as the reference's launcher does (its default
``attn_impl``).
``--temperature`` /
``--seed`` sample as the reference's flags do; paged mode runs the
numeric-health guards unless ``--no-health-checks``.  ``--prefix-cache``
shares the KV pages of common prompt prefixes (``--shared-prefix N``
gives every prompt N common leading tokens) and prints the hit rate and
the effective pool beside the allocated one; the tokens are those of a
run without it (for a dense config; MoE capacity routing depends on
which tokens share a prefill, ROADMAP C8).  ``--mx-kv`` / ``--mx-mode``
are the reference's deprecated aliases for ``--quant kv=<fmt>@32:<mode>``.
``--shard --devices N`` serves sharded, as the reference's ``--shard``
does over its devices: N rank processes (``dist.spawn``) on the
reference's ``make_test_mesh(N)`` ("model" the first of 4, 2, 1 that
divides N, "data" the rest), each holding its shard of the weights
(decode posture: resident, split over "model", whole over "data") and
serving the same requests through the same engine; ``--shard-pool``
shards the paged engine's page pool over the data axes.  On the CPU
the ranks join over gloo; on the card each rank takes
``cuda:(rank % cards)``, NCCL where every rank has a card of its own,
gloo staged through host memory where ranks share one (the engines then
decode eagerly).  Rank 0 prints; every rank's tokens are compared.  The
GQA decoder family (dense and MoE) serves sharded; the other families
are refused with the ROADMAP item they wait on:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3_6b \
        --reduced --device cpu --paged --weight-resident --shard \
        --devices 2 --quant weights=e4m3@32:ocp,kv=int8@32:ocp
Weights are random, made on the device from seed 0; with
``--weight-resident`` each layer is quantized to MX storage as soon as
it is made.

Per-layer policies (``repro_torch.calib``): ``--quant auto:<budget>``
runs ``--calib-batches`` synthetic batches (``--batch`` x
``--prompt-len`` tokens from numpy seed 1) through the instrumented
forward over the fp weights, searches per-layer KV specs under a total
of ``<budget>`` KV bytes per token over all layers, prints the table and
serves it (``--save-policy PATH`` writes its JSON); ``--policy-json
PATH`` serves a saved table without calibrating (layers quantize their
weights per their own entry under ``--weight-resident``):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3_6b \
        --reduced --device cpu --paged --quant auto:200 \
        --calib-batches 2 --save-policy policy.json
    PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3_6b \
        --reduced --device cpu --paged --policy-json policy.json

Requests that arrive over time serve through the asyncio front end
(``serve.frontend.AsyncServer``): ``--arrival poisson:R`` (R req/s),
``onoff:R:ON:OFF`` (bursts of R req/s for ON seconds, then OFF seconds
of silence) or ``trace:PATH`` (a JSONL trace).  ``--slo S`` makes about
two thirds of the synthetic requests an interactive class (priority 0,
TTFT deadline S seconds) and the rest a batch class (priority 1, up to
twice the new tokens); ``--preempt`` swaps a batch request's packed KV
pages to host memory when an interactive one cannot be admitted, and
``--admission reject`` drops what cannot start at once instead of
queueing it.  It prints TTFT and ITL p50/p99, SLO attainment, the phase
wall times and the preemption / swap traffic:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3_6b \
        --reduced --device cpu --paged --preempt \
        --arrival onoff:60:0.15:2.0 --slo 0.35 --requests 8 \
        --quant kv_key=int8@32:ocp,kv_value=e2m1@32:ocp

Paged mode also takes a seeded fault plan (``--faults``, ``--fault-seed``;
``serve.faults``; ``kernel_fail`` is refused, the port has no degraded
path), the front end's stalled-step watchdog (``--watchdog``), and the
observability layer: ``--trace-out`` (trace/v1 JSONL), ``--chrome-trace``,
``--metrics-json`` (the engine's registry with the front end's series
merged in) and ``--obs-interval`` (the ``mx.*`` health gauges):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3_6b \
        --reduced --device cpu --paged --batch 2 --requests 6 \
        --new-tokens 16 --faults prefill_nan:rid=1,page_corrupt:nth=2 \
        --obs-interval 1 \
        --trace-out trace.jsonl --metrics-json metrics.json \
        --quant kv_key=int8@32:ocp,kv_value=e2m1@32:ocp
"""
from __future__ import annotations

import argparse
import asyncio
import contextlib
import dataclasses
import hashlib
import io
import json
import tempfile
import time
from pathlib import Path
from typing import List, Tuple

import numpy as np

from repro_torch.core.spec import PolicyTable, QuantPolicy
from repro_torch.models import (Model, apply_policy_table, load_config,
                                load_reduced, make_concrete_batch)
from repro_torch.models.layers import any_fp_kv
from repro_torch.obs import MetricsRegistry, Tracer, rate
from repro_torch.serve import (AsyncServer, ContinuousBatchingEngine,
                               FaultPlan, GenerationConfig, ServeEngine,
                               TrafficClass, latency_summary, load_trace,
                               on_off_times, poisson_times, replay,
                               synthesize)
from repro_torch.serve.engine import KERNEL_FAIL_REFUSED


SHARD_REFUSED = (
    "--shard / --shard-pool serve the GQA decoder family (dense and MoE); "
    "{} ({}) waits on ROADMAP A11.2's remaining half: sharded serving of "
    "the other families")
WEIGHTS_ROLE_NEEDED = ("--weight-resident needs a 'weights' role in the "
                       "policy, e.g. --quant weights=e4m3@32:ocp")


def has_weights_role(cfg) -> bool:
    """Some layer's policy quantizes its weights."""
    return any(cfg.layer_policy(i).weights is not None
               for i in range(cfg.n_layers))


def build_model(arch: str, *, reduced: bool, quant: str,
                weight_resident: bool, device: str = "cuda",
                seed: int = 0, table=None, place=None,
                **overrides) -> Tuple[Model, dict]:
    """Config (under ``table``, a per-layer ``PolicyTable``, when given)
    + random weights on ``device``, quantized layer by layer, each at its
    own policy's weights spec, when ``weight_resident``; ``place`` keeps
    a sharded rank's shard of each piece (``Model.init``)."""
    policy = QuantPolicy.parse(quant or "none")
    cfg = (load_reduced if reduced else load_config)(arch, mx=policy,
                                                      **overrides)
    if table is not None:
        cfg = apply_policy_table(cfg, table)
    if weight_resident and not has_weights_role(cfg):
        raise ValueError(WEIGHTS_ROLE_NEEDED)
    model = Model(cfg, device=device)
    return model, model.init(seed=seed, quantize=weight_resident,
                             place=place)


def shard_family(cfg) -> str:
    """Why ``cfg`` cannot serve sharded ("" for the GQA decoders)."""
    if cfg.family != "decoder":
        return cfg.family
    if cfg.mla:
        return "MLA"
    if cfg.frontend != "none":
        return f"{cfg.frontend} frontend"
    return ""


def auto_policy(model: Model, params, budget: float, batch: int,
                prompt_len: int, n_batches: int, save: str = None):
    """Calibrate the KV roles on ``n_batches`` synthetic (batch,
    prompt_len) token batches (numpy seed 1, as the reference's launcher
    draws them) over the fp ``params``, search per-layer KV specs under
    ``budget`` KV bytes per token, print the table and return the model
    under it."""
    from repro_torch.calib import collect_model_stats, search_kv_policy
    from repro_torch.serve.paging import kv_cache_token_nbytes
    cfg = model.cfg
    rng = np.random.default_rng(1)
    batches = [rng.integers(0, cfg.vocab, size=(batch, prompt_len))
               .astype(np.int32) for _ in range(max(1, n_batches))]
    t0 = time.perf_counter()
    stats = collect_model_stats(model, params, batches,
                                roles=("kv_key", "kv_value"))
    res = search_kv_policy(stats, budget, cfg)
    print(f"[serve] calibrated {len(batches)} batches + searched in "
          f"{time.perf_counter() - t0:.2f}s")
    print("[serve] " + res.describe().replace("\n", "\n[serve] "))
    if save:
        Path(save).write_text(res.table.to_json())
        print(f"[serve] wrote policy table -> {save}")
    cfg = apply_policy_table(cfg, res.table)
    print(f"[serve] KV cache: {kv_cache_token_nbytes(cfg)} B/token across "
          f"{cfg.n_layers} layers (budget {budget:.4g} B/token)")
    return Model(cfg, device=model.device)


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


def make_tracer(args, cfg):
    """The launcher's Tracer when ``--trace-out`` / ``--chrome-trace`` ask
    for one (None otherwise); the run's identifying knobs ride the trace
    header's ``meta``."""
    if not (args.trace_out or args.chrome_trace):
        return None
    return Tracer(meta={"arch": args.arch, "quant": str(cfg.mx),
                        "arrival": args.arrival,
                        "preempt": bool(args.preempt),
                        "faults": args.faults or "",
                        "retry": args.retry,
                        "sync_every": args.sync_every})


def write_obs(args, eng, srv=None) -> None:
    """Export the run's observability files: close every open trace track
    (``finalize_trace``), then write the trace/v1 JSONL, the Chrome trace
    and the metrics snapshot (the front end's series merged into the
    engine's registry, and the latency summary in async mode)."""
    if eng.tracer is not None:
        eng.finalize_trace()
        if args.trace_out:
            eng.tracer.write_jsonl(args.trace_out)
            print(f"[serve] wrote trace/v1 JSONL -> {args.trace_out} "
                  f"({len(eng.tracer.events)} events)")
        if args.chrome_trace:
            eng.tracer.write_chrome(args.chrome_trace)
            print(f"[serve] wrote Chrome trace -> {args.chrome_trace}")
    if args.metrics_json:
        reg = MetricsRegistry()
        reg.merge(eng.metrics)
        snap = {}
        if srv is not None:
            reg.merge(srv.metrics)
            snap["latency"] = latency_summary(eng.finished_in_window)
        snap["metrics"] = reg.snapshot()
        with open(args.metrics_json, "w") as f:
            json.dump(snap, f, indent=1, sort_keys=True)
        print(f"[serve] wrote metrics snapshot -> {args.metrics_json}")


def report_faults(eng, faults, srv=None) -> None:
    """The fault-tolerance lines: quarantines, the front end's retries,
    failures and watchdog recoveries, the sites that fired, and each
    quarantined request's diagnostic."""
    line = f"[serve] fault tolerance: {eng.n_quarantined} quarantined"
    if srv is not None:
        line += (f", {srv.n_retried} retries, {srv.n_failed} permanent "
                 f"failures, {srv.n_recoveries} watchdog recoveries")
    if faults is not None and faults.fired:
        line += f", fired sites {sorted({s for s, _, _ in faults.fired})}"
    print(line)
    for r in eng.scheduler.failed:
        print(f"[serve]   rid {r.rid} quarantined: {r.error}")


def parse_arrival(spec: str):
    """Parse an ``--arrival`` spec into ``(kind, params)``:

    ``batch``                       — every request queued at once
    ``poisson:<rate>``              — Poisson arrivals at <rate> req/s
    ``onoff:<rate>:<on_s>:<off_s>`` — bursty on/off modulated Poisson
    ``trace:<path>``                — replay a JSONL trace
    """
    parts = spec.split(":")
    kind = parts[0]
    try:
        if kind == "batch" and len(parts) == 1:
            return "batch", ()
        if kind == "poisson" and len(parts) == 2:
            return "poisson", (float(parts[1]),)
        if kind == "onoff" and len(parts) == 4:
            return "onoff", (float(parts[1]), float(parts[2]),
                             float(parts[3]))
        if kind == "trace" and len(parts) >= 2:
            return "trace", (spec.split(":", 1)[1],)
    except ValueError:
        pass
    raise ValueError(
        f"bad --arrival {spec!r}: expected batch, poisson:<rate>, "
        f"onoff:<rate>:<on_s>:<off_s>, or trace:<path>")


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
                         "kv_key=int8@32:ocp,kv_value=e2m1@32:ocp, or "
                         "'auto:<bytes>' to calibrate and search a "
                         "per-layer policy under a total KV "
                         "bytes-per-token budget")
    ap.add_argument("--calib-batches", type=int, default=4,
                    help="calibration batches for --quant auto "
                         "(each --batch x --prompt-len synthetic tokens)")
    ap.add_argument("--save-policy", default=None,
                    help="write the auto-selected PolicyTable JSON here")
    ap.add_argument("--policy-json", default=None,
                    help="serve a previously saved PolicyTable JSON "
                         "(skips calibration)")
    ap.add_argument("--mx-kv", choices=["off", "int8", "e4m3", "e5m2",
                                        "e3m2", "e2m3", "e2m1"],
                    default="off",
                    help="deprecated: use --quant kv=<fmt>@32:<mode>")
    ap.add_argument("--mx-mode", choices=["paper", "ocp"], default="ocp",
                    help="deprecated: use --quant")
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
                         "without it (dense configs); over an fp KV pool "
                         "attention runs dense")
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
    ap.add_argument("--preempt", action="store_true",
                    help="paged mode: preempt-and-swap — under pool "
                         "pressure a lower-priority request's packed KV "
                         "pages swap to host memory and come back "
                         "token-identically on re-admission")
    ap.add_argument("--arrival", default="batch",
                    help="paged mode request arrivals: 'batch' (queue "
                         "everything), 'poisson:<rate>' req/s, "
                         "'onoff:<rate>:<on_s>:<off_s>' bursty, or "
                         "'trace:<path>' JSONL replay; other than batch "
                         "serves through the asyncio front end")
    ap.add_argument("--slo", type=float, default=0.0,
                    help="async mode: make ~2/3 of the synthetic requests "
                         "an interactive class (priority 0) with this TTFT "
                         "deadline in seconds, the rest a batch class "
                         "(priority 1, no deadline); 0 = one class")
    ap.add_argument("--admission", choices=["block", "reject"],
                    default="block",
                    help="async mode: 'block' queues submissions, "
                         "'reject' drops requests that cannot start at "
                         "once")
    ap.add_argument("--speedup", type=float, default=0.0,
                    help="async mode: divide arrival times by this (0 = "
                         "submit as fast as the loop allows)")
    ap.add_argument("--retry", type=int, default=0,
                    help="async mode: per-request retry budget for "
                         "quarantined requests (jittered exponential "
                         "backoff)")
    ap.add_argument("--retry-backoff", type=float, default=0.05,
                    help="async mode: base retry backoff in seconds")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="async mode: take an engine snapshot every N "
                         "steps (0 = only when --watchdog needs one)")
    ap.add_argument("--faults", default=None,
                    help="paged mode: seeded fault-injection plan, e.g. "
                         "'prefill_nan:rid=1:always,page_corrupt:nth=1,"
                         "stall:nth=2:stall_s=30' (sites: page_corrupt, "
                         "swap_corrupt, prefill_nan, alloc_fail, stall — "
                         "see repro_torch.serve.faults; kernel_fail is "
                         "refused: the port has no degraded path)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed for the --faults plan's randomness "
                         "(which slot/page/position each firing corrupts)")
    ap.add_argument("--watchdog", type=float, default=0.0,
                    help="async mode: stalled-step watchdog timeout in "
                         "seconds; a hung step is aborted and the engine "
                         "restored from the last snapshot (0 = off). Must "
                         "comfortably exceed the slowest healthy step or "
                         "slow steps trip spurious recoveries")
    ap.add_argument("--trace-out", default=None,
                    help="paged mode: write per-request trace spans "
                         "(queued / prefill / decode windows / preempt / "
                         "restore / quarantine / retry) as trace/v1 JSONL "
                         "to this path — no extra host syncs; "
                         "token-identical on/off")
    ap.add_argument("--chrome-trace", default=None,
                    help="paged mode: also export the trace as a Chrome "
                         "trace_event JSON (load in Perfetto / "
                         "chrome://tracing)")
    ap.add_argument("--metrics-json", default=None,
                    help="paged mode: write the metrics-registry snapshot "
                         "(engine + scheduler + paging + prefix + swap + "
                         "mx.* gauges, with the server's series merged in "
                         "and the latency summary in async mode) as JSON")
    ap.add_argument("--obs-interval", type=int, default=0,
                    help="paged mode: sample the MX-health gauges "
                         "(shared-scale saturation/clip and underflow "
                         "rates, poison markers, per KV role) every N "
                         "sync windows (0 = never; each sample is one "
                         "device reduction and one host transfer)")
    ap.add_argument("--shard", action="store_true",
                    help="serve under a (data, model) mesh of --devices "
                         "ranks with the decode sharding rules (weights "
                         "resident, split over model)")
    ap.add_argument("--shard-pool", action="store_true",
                    help="shard the page pool's page dim over the data "
                         "axes (with --shard)")
    ap.add_argument("--devices", type=int, default=1,
                    help="ranks of the --shard mesh (make_test_mesh)")
    args = ap.parse_args(argv)
    if args.shard_pool and not args.shard:
        ap.error("--shard-pool needs --shard")
    if args.shard and (args.arrival != "batch" or args.quant and
                       args.quant.startswith("auto")):
        ap.error("--shard serves --arrival batch with a fixed policy (the "
                 "async front end and --quant auto are not sharded yet, "
                 "ROADMAP A11.2)")
    try:
        arrival = parse_arrival(args.arrival)
    except ValueError as e:
        ap.error(str(e))
    if arrival[0] != "batch" and not args.paged:
        ap.error("--arrival needs --paged (the async front end drives the "
                 "continuous-batching engine)")
    if args.preempt and not args.paged:
        ap.error("--preempt needs --paged (it swaps pages)")
    if arrival[0] == "batch" and (args.retry or args.snapshot_every
                                  or args.slo or args.speedup
                                  or args.watchdog > 0
                                  or args.admission != "block"):
        ap.error("--slo/--admission/--speedup/--retry/--watchdog/"
                 "--snapshot-every need a non-batch --arrival (they are "
                 "front-end policies)")
    if not args.paged and (args.faults or args.no_health_checks):
        ap.error("--faults/--no-health-checks need --paged (the guards "
                 "and injection sites live in the paged engine)")
    if not args.paged and (args.trace_out or args.chrome_trace
                           or args.metrics_json or args.obs_interval):
        ap.error("--trace-out/--chrome-trace/--metrics-json/"
                 "--obs-interval need --paged (the observability layer "
                 "instruments the continuous-batching engine)")
    faults = None
    if args.faults:
        try:
            faults = FaultPlan.parse(args.faults, seed=args.fault_seed)
        except ValueError as e:
            ap.error(f"--faults: {e}")
        if any(f.site == "kernel_fail" for f in faults.faults):
            ap.error(KERNEL_FAIL_REFUSED)
        print(f"[serve] fault plan (seed {args.fault_seed}): {faults}")
    if args.prefix_cache and not args.paged:
        ap.error("--prefix-cache needs --paged (prefixes share pages)")
    if args.policy_json and (args.quant or args.mx_kv != "off"):
        ap.error("--policy-json and --quant/--mx-kv are mutually "
                 "exclusive: the saved table already fixes the policy "
                 "(re-run calibration with --quant auto:<budget> to "
                 "replace it)")
    quant, auto_budget, table = args.quant, None, None
    if quant and (quant == "auto" or quant.startswith("auto:")):
        from repro_torch.calib import parse_auto_budget
        try:
            auto_budget = parse_auto_budget(quant)
        except ValueError as e:
            ap.error(str(e))
        quant = None
    elif not quant and args.mx_kv != "off":
        print(f"[serve] --mx-kv/--mx-mode are deprecated; use "
              f"--quant kv={args.mx_kv}@32:{args.mx_mode}")
        quant = f"kv={args.mx_kv}@32:{args.mx_mode}"
    if args.policy_json:
        table = PolicyTable.from_json(Path(args.policy_json).read_text())
    if args.shard:
        cfg = (load_reduced if args.reduced else load_config)(args.arch)
        why = shard_family(cfg)
        if why:
            ap.error(SHARD_REFUSED.format(args.arch, why))
        _serve_sharded(args, quant, table, faults)
        return
    _serve(args, quant, auto_budget, table, faults, arrival, ap.error)


def _raise(msg: str):
    raise ValueError(msg)


def _serve(args, quant, auto_budget, table, faults, arrival, error=_raise,
           rules=None, place=None):
    """Build the model and serve it: the whole launcher on one device,
    or one rank of ``--shard`` (``rules`` and ``place`` given, the mesh
    installed); ``error`` reports a bad request (the parser's, or a
    raise in a rank).  Returns the generated tokens (request id ->
    tokens, or the static batch's array)."""
    t0 = time.perf_counter()
    try:
        model, params = build_model(
            args.arch, reduced=args.reduced, quant=quant,
            weight_resident=args.weight_resident and auto_budget is None,
            device=args.device, table=table, attn_impl="flash",
            place=place)
    except ValueError as e:
        error(str(e))
    if table is not None:
        cfg = model.cfg
        print(f"[serve] policy table from {args.policy_json}: {cfg.mx}"
              + (f" + {len(cfg.mx_table.overrides)} layer overrides"
                 if cfg.mx_table is not None else ""))
    if auto_budget is not None:
        # calibrate -> search -> apply: the fp weights serve the table
        model = auto_policy(model, params, auto_budget, args.batch,
                            args.prompt_len, args.calib_batches,
                            args.save_policy)
        if args.weight_resident:
            if not has_weights_role(model.cfg):
                error(WEIGHTS_ROLE_NEEDED)
            params = model.quantize_weights(params)
    # an fp pool under the prefix cache serves at "dense", as the
    # reference's launcher does: at "flash" its cold prefill would attend
    # through the flash kernel and its suffix prefill densely (the engine
    # refuses that pairing)
    if args.prefix_cache and any_fp_kv(model.cfg):
        model = Model(dataclasses.replace(model.cfg, attn_impl="dense"),
                      device=model.device)
    cfg = model.cfg
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
          f"policy {cfg.mx}"
          + (f" + {len(cfg.mx_table.overrides)} layer overrides"
             if cfg.mx_table is not None else "")
          + f", attention {cfg.attn_impl}, built on {model.device} in "
          f"{time.perf_counter() - t0:.2f}s")
    if not args.paged:
        return _serve_static(args, model, params, rules)
    if arrival[0] != "batch":
        _serve_async(args, model, params, *arrival, faults=faults)
        return None
    prompts = make_prompts(args.requests or 2 * args.batch, args.prompt_len,
                           args.mixed, cfg.vocab, args.shared_prefix)
    max_len = max(len(p) for p in prompts) + args.new_tokens + 1
    eng = ContinuousBatchingEngine(
        model, params, max_slots=args.batch, page_size=args.page_size,
        max_len=max_len, sync_every=args.sync_every,
        prefill_bucket=args.prefill_bucket or None,
        gen=GenerationConfig(temperature=args.temperature, seed=args.seed),
        prefix_cache=args.prefix_cache, preempt=args.preempt,
        health_checks=not args.no_health_checks, faults=faults,
        tracer=make_tracer(args, cfg), obs_interval=args.obs_interval,
        rules=rules)
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
          f"{ph['decode']:.2f}s, host-sync {ph['sync']:.2f}s, swap "
          f"{ph['swap']:.2f}s; {eng.prefill_tokens_computed} prefill "
          f"tokens computed")
    if args.prefix_cache:
        px = eng.prefix
        print(f"[serve] prefix cache: hit rate {eng.prefix_hit_rate:.2f} "
              f"({px.hits}/{px.lookups} admissions), {px.tokens_matched} "
              f"tokens reused, {eng.n_cow_forks} COW forks, peak shared "
              f"pages {eng.peak_shared_pages}, effective pool "
              f"{eng.kv_pool_bytes_effective / 2**20:.2f} MiB (allocated "
              f"{eng.kv_pool_nbytes / 2**20:.2f} MiB)")
    if faults is not None or eng.n_quarantined:
        report_faults(eng, faults)
    if out:
        first = min(out)
        print(f"[serve] sample tokens (request {first}): "
              f"{out[first][:16].tolist()}")
    write_obs(args, eng)
    return out


def _shard_rank(rank: int, args, quant, table, faults, store: str) -> None:
    """One rank of ``--shard`` (``dist.spawn``): join the mesh, place
    this rank's shard of the weights as they are made, serve, and check
    that every rank produced the same tokens.  Only rank 0 prints."""
    from repro_torch.dist import close_dp, init_dp, rank_device
    from repro_torch.dist.sharding import (make_rules, set_mesh,
                                           shard_params, use_rules)
    from repro_torch.launch.mesh import make_test_mesh
    shape = make_test_mesh(args.devices)
    mesh = init_dp(rank, shape.sizes, rank_device(args.device, rank), store,
                   axes=shape.axis_names)
    args.device = str(mesh.device)
    rules = make_rules(shape.axis_names, fsdp_params=False,
                       paged_pool_sharded=args.shard_pool,
                       quant=QuantPolicy.parse(quant or "none"))
    quiet = contextlib.redirect_stdout(io.StringIO()) if rank \
        else contextlib.nullcontext()
    try:
        with quiet, set_mesh(mesh), use_rules(rules):
            print(f"[serve] sharded over mesh {shape.shape} "
                  f"({mesh.world} ranks over {mesh.backend}"
                  f"{', staged through host memory' if mesh.staged else ''}"
                  f"; decode {'eager' if mesh.staged else 'captured'} on "
                  f"the card)")
            out = _serve(args, quant, None, table, faults, ("batch", ()),
                         rules=rules,
                         place=lambda t: shard_params(t, mesh, rules))
            digest = hashlib.sha256(repr(
                sorted(out.items()) if isinstance(out, dict)
                else out.tolist()).encode()).digest()[:8]
            got = mesh.host_gather(np.frombuffer(digest, np.uint8).copy(),
                                   mesh.axes)
            same = bool((got == got[0]).all())
            print(f"[serve] ranks identical: {same} "
                  f"(token digest {digest.hex()})")
            if not same:
                raise SystemExit("serve: the ranks' tokens differ")
    finally:
        close_dp()


def _serve_sharded(args, quant, table, faults) -> None:
    """``--shard --devices N``: N rank processes over make_test_mesh(N)."""
    from repro_torch.dist import spawn
    with tempfile.TemporaryDirectory(prefix="serve_shard_") as d:
        spawn(_shard_rank, args.devices,
              (args, quant, table, faults, str(Path(d) / "store")))


def _serve_async(args, model: Model, params, kind: str, aparams,
                 faults=None) -> None:
    """Serve a synthetic (or replayed) arrival process through
    ``AsyncServer`` and report tail latency, SLO attainment and the
    preemption / swap accounting."""
    cfg = model.cfg
    if kind == "trace":
        arrivals = load_trace(aparams[0])
    else:
        n_req = args.requests or 2 * args.batch
        if kind == "poisson":
            times = poisson_times(aparams[0], n_req, seed=0)
        else:
            rate_, on_s, off_s = aparams
            times = on_off_times(rate_, n_req, on_s=on_s, off_s=off_s,
                                 seed=0)
        lo = max(1, args.prompt_len // 4) if args.mixed else args.prompt_len
        hi = max(lo + 1, 2 * args.prompt_len) if args.mixed \
            else args.prompt_len + 1
        new = args.new_tokens
        if args.slo > 0:
            classes = [
                TrafficClass("interactive", (lo, hi), (new, new + 1),
                             priority=0, deadline_s=args.slo, weight=2.0),
                TrafficClass("batch", (lo, hi), (new, 2 * new + 1),
                             priority=1, weight=1.0)]
        else:
            classes = [TrafficClass("default", (lo, hi), (new, new + 1))]
        arrivals = synthesize(times, classes, cfg.vocab, seed=0)
    max_len = max(a.prompt.shape[0] + a.max_new_tokens for a in arrivals) + 1
    eng = ContinuousBatchingEngine(
        model, params, max_slots=args.batch, page_size=args.page_size,
        max_len=max_len, sync_every=args.sync_every,
        prefill_bucket=args.prefill_bucket or None,
        gen=GenerationConfig(temperature=args.temperature, seed=args.seed),
        prefix_cache=args.prefix_cache, preempt=args.preempt,
        health_checks=not args.no_health_checks, faults=faults,
        tracer=make_tracer(args, cfg), obs_interval=args.obs_interval)
    speedup = args.speedup if args.speedup > 0 else float("inf")
    srv_kw = dict(admission=args.admission, retries=args.retry,
                  retry_backoff_s=args.retry_backoff,
                  snapshot_every=args.snapshot_every or None)
    if args.watchdog > 0:
        srv_kw.update(use_executor=True, watchdog_s=args.watchdog,
                      snapshot_every=args.snapshot_every or 1)
    servers = []

    async def run():
        async with AsyncServer(eng, **srv_kw) as srv:
            servers.append(srv)
            return await replay(srv, arrivals, speedup=speedup)

    t0 = time.perf_counter()
    _, rejected = asyncio.run(run())
    dt = time.perf_counter() - t0
    fin = eng.finished_in_window
    summ = latency_summary(fin)
    toks = sum(len(r.out) for r in fin)
    print(f"[serve] {cfg.name} async quant={cfg.mx} arrival={args.arrival} "
          f"admission={args.admission} "
          f"preempt={'on' if args.preempt else 'off'}: {len(fin)} served / "
          f"{len(rejected)} rejected of {len(arrivals)} arrivals, {toks} "
          f"tokens in {dt:.2f}s — {rate(toks, dt):.1f} tok/s")
    if "ttft_p50_ms" in summ:
        print(f"[serve] TTFT p50 {summ['ttft_p50_ms']:.1f} ms / "
              f"p99 {summ['ttft_p99_ms']:.1f} ms"
              + (f", ITL p50 {summ['itl_p50_ms']:.2f} ms / "
                 f"p99 {summ['itl_p99_ms']:.2f} ms"
                 if "itl_p50_ms" in summ else ""))
    if "slo_attainment" in summ:
        print(f"[serve] SLO attainment (TTFT <= {args.slo:.3g}s): "
              f"{summ['slo_attainment']:.1%}")
    ph = eng.phase
    print(f"[serve] phase wall: prefill {ph['prefill']:.2f}s, decode "
          f"{ph['decode']:.2f}s, host-sync {ph['sync']:.2f}s, swap "
          f"{ph['swap']:.2f}s")
    if args.preempt:
        sw = eng.swap_store
        print(f"[serve] preempt-and-swap: {eng.n_preemptions} preemptions, "
              f"{eng.n_restores} restores, swap traffic "
              f"{sw.bytes_out / 1024:.1f} KiB out / "
              f"{sw.bytes_in / 1024:.1f} KiB in (MX-packed), peak "
              f"resident {sw.peak_resident_bytes / 1024:.1f} KiB")
    srv = servers[0]
    if faults is not None or args.retry or args.watchdog > 0 \
            or eng.n_quarantined:
        report_faults(eng, faults, srv)
    if fin:
        first = min(fin, key=lambda r: r.rid)
        print(f"[serve] sample tokens (request {first.rid}): "
              f"{first.out[:16]}")
    write_obs(args, eng, srv)


def _serve_static(args, model: Model, params, rules=None):
    """A seeded batch of equal-length prompts through ``ServeEngine``,
    twice: the first call, then a steady one.  The batch is the
    reference launcher's ``make_concrete_batch``: ``--prompt-len`` tokens,
    or for the patch frontend its prefix embeddings and the rest in
    tokens, or for the encoder-decoder half in frames and half in
    decoder tokens."""
    cfg = model.cfg
    batch = make_concrete_batch(cfg, args.batch, args.prompt_len)
    batch.pop("labels")
    eng = ServeEngine(model, params,
                      max_len=args.prompt_len + args.new_tokens + 8,
                      rules=rules)
    gen = GenerationConfig(max_new_tokens=args.new_tokens,
                           temperature=args.temperature, seed=args.seed)
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        out = eng.generate(batch, gen)
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
    return out


if __name__ == "__main__":
    main()
