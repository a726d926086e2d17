"""Rank functions of tests/test_torch_serve_shard.py (a module that
imports no jax: the spawned rank processes import it).

``serve_jobs(mesh, jobs)`` runs on every rank of a (data, model) mesh:
each job places the reference's converted weights (numpy trees, carried
to the ranks as they are) on the rank with ``shard_params`` and serves
the same prompts through a sharded engine; the rank returns its tokens,
its resident weight bytes, its pool's page count and how often the
paged attention kernel's wrapper (B3) ran.  A "rowsum" job is the
bf16 control of the row-parallel sum (``row_sum_control``).
"""
import contextlib

import numpy as np
import torch

from repro_torch.core import MXWeight
from repro_torch.core.spec import QuantPolicy, QuantSpec
from repro_torch.dist.sharding import (make_rules, model_gather, set_mesh,
                                       shard_leaf, shard_params, use_rules)
from repro_torch.kernels import mx_decode_attn
from repro_torch.kernels.ops import mx_matmul_resident
from repro_torch.models.layers import dense
from repro_torch.models import Model, load_reduced
from repro_torch.models.params import from_numpy
from repro_torch.core.mx_weight import params_nbytes
from repro_torch.serve import (ContinuousBatchingEngine, GenerationConfig,
                               ServeEngine)


def model_of(arch, policy):
    cfg = load_reduced(arch, mx=QuantPolicy.parse(policy),
                       attn_impl="flash")
    return Model(cfg, device="cpu")


def serve_continuous(model, params, prompts, new, rules=None, **kw):
    eng = ContinuousBatchingEngine(model, params, rules=rules, **kw)
    rids = [eng.add_request(p, new) for p in prompts]
    out = eng.run()
    return [out[r].tolist() for r in rids], eng


def serve_static(model, params, tokens, new, max_len, rules=None):
    eng = ServeEngine(model, params, max_len=max_len, rules=rules)
    return eng.generate({"tokens": tokens},
                        GenerationConfig(max_new_tokens=new)).tolist(), eng


@contextlib.contextmanager
def counting_paged_attention():
    """Count the calls of the paged attention kernel's wrapper (the
    ``*_ctx`` wrapper imports it at each call)."""
    calls = [0]
    real = mx_decode_attn.mx_paged_decode_attention

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    mx_decode_attn.mx_paged_decode_attention = counted
    try:
        yield calls
    finally:
        mx_decode_attn.mx_paged_decode_attention = real


def row_sum_control(mesh, k=1024, n=512, m=8):
    """bf16 x over a row-parallel MX weight (K split over "model"):
    the share of outputs where ``dense(tp="row")`` differs from the
    whole weight's bf16 product, and the share where the sum of the
    ranks' partials cast to bf16 first would (the fault that summing
    f32 partials before the cast rules out)."""
    rng = np.random.default_rng(5)
    w = torch.from_numpy((rng.normal(size=(k, n)) / np.sqrt(k))
                         .astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)
                         ).to(torch.bfloat16)
    mw = MXWeight.quantize(w, QuantSpec.parse("e4m3@32:ocp"))
    whole = dense(x, mw)
    with set_mesh(mesh), use_rules(make_rules(mesh.axes,
                                              fsdp_params=False)):
        piece = shard_leaf(mw, ("model", "data"), mesh)
        kl = k // mesh.size("model")
        xs = x[:, mesh.coord("model") * kl:][:, :kl]
        got = dense(xs, piece, tp="row", k=k)
        parts = model_gather(mx_matmul_resident(xs, piece)[None], 0)
    fault = parts[0].to(torch.bfloat16)
    for p in parts[1:]:
        fault = fault + p.to(torch.bfloat16)
    return {"mismatch": float((got != whole).float().mean()),
            "fault_mismatch": float((fault != whole).float().mean())}


def serve_jobs(mesh, jobs):
    out = []
    for job in jobs:
        if job["kind"] == "rowsum":
            out.append(row_sum_control(mesh))
            continue
        model = model_of(job["arch"], job["policy"])
        rules = make_rules(mesh.axes, fsdp_params=False,
                           paged_pool_sharded=job.get("pool", False),
                           quant=model.cfg.mx)
        with set_mesh(mesh), use_rules(rules):
            whole = from_numpy(job["params"], model.cfg, "cpu")
            params = shard_params(whole, mesh, rules)
            res = {"weight_bytes": params_nbytes(params),
                   "whole_bytes": params_nbytes(whole)}
            del whole
            if job["kind"] == "continuous":
                with counting_paged_attention() as calls:
                    res["tokens"], eng = serve_continuous(
                        model, params, job["prompts"], job["new"], rules,
                        **job["kw"])
                res["paged_attention_calls"] = calls[0]
                res["decode_steps"] = eng.n_steps
                res["n_layers"] = model.cfg.n_layers
                res["pool_pages"] = int(
                    next(iter(eng.pool.values())).shape[1])
                res["kv_heads"] = int(
                    next(iter(eng.pool.values())).shape[3])
            else:
                res["tokens"], eng = serve_static(
                    model, params, job["tokens"], job["new"],
                    job["max_len"], rules)
            res["captures"] = eng.captures
        out.append(res)
    return out


def restore_rank(mesh, d, step, x):
    """Restore ``x``'s checkpoint onto this rank's (data, model) mesh with
    the leaf spec ("model", "data"); returns the rank's shard and its
    coordinates."""
    from repro_torch.ckpt import restore
    from repro_torch.dist.sharding import NamedSharding
    like = {"w": torch.zeros(x.shape, dtype=torch.float32)}
    out, meta = restore(d, step, like,
                        {"w": NamedSharding(mesh, ("model", "data"))})
    return (out["w"], mesh.coord("data"), mesh.coord("model"), meta)


def save_rank(mesh, d, step, x):
    """Ranks of a ("data",) mesh each hold their rows of ``x``; the rows
    are gathered and rank 0 saves the whole array."""
    from repro_torch.ckpt import save_atomic
    rows = torch.from_numpy(np.asarray(x)).chunk(mesh.world)[mesh.rank]
    whole = mesh.gather_over(rows.contiguous(), "data", 0)
    if mesh.rank == 0:
        save_atomic(d, step, {"w": whole}, {"mesh": list(mesh.sizes)})
    mesh.host_gather(np.zeros(1, np.int32), "data")     # a barrier
    return whole
