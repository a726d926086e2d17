"""Rank functions of tests/test_torch_serve_shard.py and
tests/test_torch_train_shard.py (a module that imports no jax: the
spawned rank processes import it).

``serve_jobs(mesh, jobs)`` runs on every rank of a (data, model) mesh:
each job places the reference's converted weights (numpy trees, carried
to the ranks as they are) on the rank with ``shard_params`` and serves
the same prompts through a sharded engine; the rank returns its tokens,
its resident weight bytes, its pool's page count and how often the
paged attention kernel's wrapper (B3) ran.  A "rowsum" job is the
bf16 control of the row-parallel sum (``row_sum_control``).

``train_jobs(mesh, jobs)`` runs the port's train and prefill cells
(``launch.cells.build_cell``) on a rank of any mesh over ("pod",
"data", "model"): a "train" job places the given whole params and AdamW
state (numpy trees, the reference's) with ``shard_params`` /
``shard_opt_state`` in the FSDP posture and takes its steps on the
global batches; every rank returns its metrics and a digest of each of
its leaves, rank 0 also the whole state after each step (``unshard``).
With ``control`` the column-parallel input's backward sum is removed
(``ModelCopy`` backward the identity): the fault the gradient check
must catch.  A "prefill" job runs the prefill cell; "mx_gather" the
FSDP-gathered MX weights of ``dense(tp="row")``; "save" / "restore" the
sharded state through ``ckpt``; "qat_shard" a step at a ``d_ff`` whose
row-parallel K shard is no block multiple (QAT refuses it).
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
from repro_torch.tree import leaves, tree_map


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


# =============================================================================
# sharded training (tests/test_torch_train_shard.py)
# =============================================================================
def digest(t) -> str:
    """A leaf's bytes as a hex digest (ranks holding one shard must
    agree bit for bit)."""
    import hashlib
    t = t.detach().contiguous().cpu()
    return hashlib.sha1(t.view(torch.uint8).numpy().tobytes()).hexdigest()


@contextlib.contextmanager
def no_copy_backward_sum():
    """The control fault: the column-parallel input's backward sum over
    "model" removed (``ModelCopy``'s backward the identity)."""
    from repro_torch.dist import groups
    real = groups.ModelCopy.backward
    groups.ModelCopy.backward = staticmethod(
        lambda ctx, g: (g, None, None))
    try:
        yield
    finally:
        groups.ModelCopy.backward = real


def _cell(mesh, job, kind):
    from repro_torch.launch.cells import build_cell
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim import AdamWConfig
    b, s = job["shape"]
    return build_cell(job.get("arch", "chatglm3_6b"),
                      ShapeSpec("cut", s, b, kind), mesh, job["variant"],
                      device="cpu", reduced=True,
                      overrides=job.get("overrides"),
                      opt_cfg=AdamWConfig(**job.get("opt_kw", {})))


def _train(mesh, job):
    from repro_torch.launch.cells import shard_opt_state, unshard
    from repro_torch.models.params import opt_state_from_numpy
    cell = _cell(mesh, job, "train")
    cfg = cell.cfg
    pshard = cell.in_shardings[0]
    params = shard_params(from_numpy(job["params"], cfg, "cpu"), mesh,
                          cell.rules)
    opt = shard_opt_state(opt_state_from_numpy(job["opt"], cfg, "cpu"),
                          pshard)
    from repro_torch.dist.sharding import placed_spec
    keys = [tuple(None if e is None else mesh.index(e)
                  for e in placed_spec(sh.spec, mesh))
            for sh in leaves((pshard, {k: pshard for k in opt}))]
    out = {"met": {}, "whole": {}, "digests": {}, "keys": keys,
           "coords": {a: mesh.coord(a) for a in mesh.axes}}
    ctl = no_copy_backward_sum() if job.get("control") \
        else contextlib.nullcontext()
    with ctl:
        for i in job["steps"]:
            batch = {k: torch.from_numpy(v)
                     for k, v in job["batches"][i].items()}
            params, opt, met = cell.fn(params, opt, batch, i)
            out["met"][i] = {k: float(v) for k, v in met.items()}
            out["digests"][i] = [digest(t) for t in leaves((params, opt))]
            whole = (unshard(params, pshard),
                     {k: unshard(v, pshard) for k, v in opt.items()})
            if mesh.rank == 0:
                out["whole"][i] = tree_map(torch.clone, whole)
    if job.get("save"):
        from repro_torch.ckpt import save_atomic
        if mesh.rank == 0:
            save_atomic(job["save"], job["steps"][-1],
                        {"params": whole[0], "opt": whole[1]},
                        {"mesh": list(mesh.sizes)})
        mesh.host_gather(np.zeros(1, np.int32), mesh.axes)   # a barrier
    return out


def _prefill(mesh, job):
    cell = _cell(mesh, job, "prefill")
    params = shard_params(from_numpy(job["params"], cell.cfg, "cpu"), mesh,
                          cell.rules)
    batch = {k: torch.from_numpy(v) for k, v in job["batch"].items()}
    logits, cache = cell.fn(params, batch)
    return {"logits": logits, "cache": cache,
            "coords": {a: mesh.coord(a) for a in mesh.axes}}


def mx_row_gather(mesh):
    """FSDP-gathered MX weights in ``dense(tp="row")`` on a (data, model)
    mesh (the reference's ``test_row_parallel_mx_gather_divisibility``):
    at K=128 each rank holds its (K/model, N/data) chunk of an
    ``MXArray`` and of an ``MXWeight`` and its K chunk of x, and the
    output against the whole weight's dequant-matmul; at K=32 the
    placement and ``dense`` each raise (their messages)."""
    from repro_torch.core.convert import mx_quantize
    spec = QuantSpec("e4m3", "ocp", 32, True)
    rng = np.random.default_rng(0)
    rules = make_rules(mesh.axes, fsdp_params=True)
    out = {"errors": [], "raised": []}
    w_bad = torch.from_numpy(rng.normal(size=(32, 16)).astype(np.float32))
    x_bad = torch.from_numpy(rng.normal(size=(2, 32)).astype(np.float32))
    w_ok = torch.from_numpy((rng.normal(size=(128, 16)) * 0.05)
                            .astype(np.float32))
    x_ok = torch.from_numpy(rng.normal(size=(2, 128)).astype(np.float32))
    with set_mesh(mesh), use_rules(rules):
        for bad in (mx_quantize(w_bad, spec, axis=0),
                    MXWeight.quantize(w_bad, spec)):
            for place in (True, False):
                try:
                    w = shard_leaf(bad, ("model", "data"), mesh, dp=True) \
                        if place else bad
                    dense(x_bad, w, tp="row", k=32, n=16)
                    out["raised"].append(None)
                except ValueError as e:
                    out["raised"].append(str(e))
        mxw = MXWeight.quantize(w_ok, spec)
        ref = x_ok @ mxw.dequantize()
        kl = 128 // mesh.size("model")
        xs = x_ok[:, mesh.coord("model") * kl:][:, :kl]
        for w in (mx_quantize(w_ok, spec, axis=0), mxw):
            piece = shard_leaf(w, ("model", "data"), mesh, dp=True)
            y = dense(xs, piece, tp="row", k=128, n=16)
            out["errors"].append(float((y - ref).abs().max()))
    return out


def _qat_shard(mesh, job):
    """One step of the train cell of reduced chatglm3 at ``job["d_ff"]``
    from its own init: the message it raised, or None if it ran."""
    from repro_torch.data import DataConfig, SyntheticLM, make_batch_for
    from repro_torch.launch.cells import shard_opt_state
    from repro_torch.optim import adamw_init
    cell = _cell(mesh, dict(job, overrides=dict(d_ff=job["d_ff"])), "train")
    whole = cell.model.init(seed=0)
    params = shard_params(whole, mesh, cell.rules)
    opt = shard_opt_state(adamw_init(whole), cell.in_shardings[0])
    b, s = job["shape"]
    data = SyntheticLM(DataConfig(vocab=cell.cfg.vocab, seq_len=s,
                                  global_batch=b, seed=3))
    batch = make_batch_for(cell.cfg, data.batch(0), device="cpu")
    try:
        cell.fn(params, opt, batch, 0)
    except ValueError as e:
        return str(e)
    return None


def _restore(mesh, job):
    from repro_torch.ckpt import restore
    from repro_torch.launch.cells import shardings_for_params
    from repro_torch.models import Model
    cell = _cell(mesh, job, "train")
    like = Model(cell.cfg, "cpu").init()
    like = {"params": like, "opt": {k: tree_map(lambda t: t.float(), like)
                                    for k in ("m", "master", "v")}}
    sh = shardings_for_params(like["params"], mesh)
    shardings = {"params": sh, "opt": {k: sh for k in like["opt"]}}
    got, meta = restore(job["dir"], job["step"], like, shardings)
    return {"state": got, "meta": meta,
            "coords": {a: mesh.coord(a) for a in mesh.axes}}


def train_jobs(mesh, jobs):
    torch.set_num_threads(1)
    run = {"train": _train, "prefill": _prefill, "restore": _restore,
           "mx_gather": lambda m, j: mx_row_gather(m),
           "qat_shard": _qat_shard}
    return [run[job["kind"]](mesh, job) for job in jobs]
