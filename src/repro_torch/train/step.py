"""The train steps (mirror src/repro/train/step.py).

``build_train_step(model, opt_cfg, microbatches=, fake_quant=)`` returns
``train_step(params, opt_state, batch, step) -> (params, opt_state,
metrics)``: the LM loss (cross-entropy + 0.01 x the MoE aux loss), its
gradient by autograd over the param leaves, microbatches accumulated in
f32 and averaged as the reference's ``scan`` does, then one AdamW
update.  A leaf that the loss reaches only through a fake quantizer has
no gradient (``None``; ROADMAP C9) and is updated as a zero gradient.

Each step runs under ``deterministic()``: ``torch.use_deterministic_
algorithms(True)`` (the embedding gather's backward accumulates by a
sort, not by atomics), so a step on the same inputs gives the same bits
and a resumed run the uninterrupted run's.  On the card that needs
cuBLAS's fixed workspace, ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` in the
environment before the process first uses cuBLAS; the training entry
points set it.

``build_train_step_compressed_dp(model, opt_cfg, groups=)`` is the
reference's explicit data-parallel step over the process groups of
``dist.groups``: each rank takes its rows of the global batch, computes
their gradient, and the gradients are averaged by the MX-compressed
exchange of ``core.grad_compress`` before every rank takes the same
AdamW step on its replica of the params and state (ZeRO-1, as the
reference).  Its three phases run in ``record_function`` spans
("dp_step.grads", "dp_step.exchange", "dp_step.adamw"), which
``tests/profile_dp_exchange.py`` reads; it has no "model" axis.

Under installed rules and a mesh (``launch.cells``' train cell),
``build_train_step`` is one rank's share of the reference's GSPMD step,
FSDP x TP (``_sharded_step``): the rank's rows of the global batch, its
shards of params and AdamW state, weights gathered over "data" at their
use points and the layers tensor-parallel over "model".
"""
from __future__ import annotations

import contextlib
import os
from typing import Any, Callable, Dict, Tuple

import torch
from torch.profiler import record_function

from repro_torch.core.grad_compress import mx_allreduce_tree
from repro_torch.core.spec import QuantSpec, as_spec
from repro_torch.dist.sharding import current_mesh, current_rules
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     global_norm)
from repro_torch.tree import leaves, tree_map, unflatten_like

CUBLAS_WORKSPACE = ":4096:8"


def cross_entropy_parts(logits: torch.Tensor, labels: torch.Tensor,
                        vocab: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of CE over valid positions, their count): labels in [0,
    vocab), -1 = masked; f32, the log-partition over every
    (padded-vocab) column, a padded column never a valid label."""
    logits = logits.to(torch.float32)
    labels = labels.to(torch.int64)
    valid = (labels >= 0) & (labels < vocab)
    labs = torch.clamp(labels, 0, vocab - 1)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labs[..., None])[..., 0]
    ce = (logz - gold) * valid
    return torch.sum(ce), torch.sum(valid)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab: int) -> torch.Tensor:
    """Mean CE over valid positions (``cross_entropy_parts``)."""
    total, count = cross_entropy_parts(logits, labels, vocab)
    return total / torch.clamp(count, min=1)


def _loss_fn(model, params, batch, *, fake_quant: bool,
             aux_weight: float = 0.01, count_sum=None, parts: int = 1):
    """(loss, {"ce", "aux"}).  A sharded step passes ``count_sum`` (the
    valid count summed over the batch axes, so that the ranks' CE shares
    add up to the global batch's CE) and ``parts`` (the ranks the aux
    loss is averaged over); without them the one-device loss."""
    logits, aux = model.forward(params, batch, fake_quant=fake_quant)
    labels = batch["labels"]
    # the forward emits one logit per input position; labels are already
    # next-token-shifted by the pipeline
    s = min(logits.shape[1], labels.shape[1])
    total, count = cross_entropy_parts(logits[:, :s], labels[:, :s],
                                       model.cfg.vocab)
    if count_sum is not None:
        count = count_sum(count)
    ce = total / torch.clamp(count, min=1)
    if parts != 1:
        aux = aux / parts
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms on for the block (restored after)."""
    prev = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=warn)


def _check_cublas(device: torch.device) -> None:
    if device.type == "cuda" and os.environ.get(
            "CUBLAS_WORKSPACE_CONFIG") not in (CUBLAS_WORKSPACE, ":16:8"):
        raise RuntimeError(
            "a deterministic train step on the card needs cuBLAS's fixed "
            f"workspace: set CUBLAS_WORKSPACE_CONFIG={CUBLAS_WORKSPACE} "
            "before the process first uses cuBLAS")


def _grads_of(model, params, batch, fake_quant: bool, **loss_kw):
    """(loss, {"ce", "aux"}, grads): grads a tree of the params' structure,
    each leaf the gradient in its param's dtype or None where the loss
    does not reach it; ``loss_kw`` goes to ``_loss_fn``."""
    flat = [p.detach().requires_grad_(True) for p in leaves(params)]
    p = unflatten_like(params, flat)
    with torch.enable_grad():
        loss, met = _loss_fn(model, p, batch, fake_quant=fake_quant,
                             **loss_kw)
        gs = torch.autograd.grad(loss, flat, allow_unused=True)
    met = {k: v.detach() for k, v in met.items()}
    return loss.detach(), met, unflatten_like(params, list(gs))


def build_train_step(model, opt_cfg: AdamWConfig, *, microbatches: int = 1,
                     fake_quant: bool = False, shardings=None) -> Callable:
    """Returns train_step(params, opt_state, batch, step) -> (params,
    opt_state, metrics); metrics hold ``loss``, ``ce``, ``aux`` (the last
    microbatch's), ``grad_norm`` and ``lr`` as 0-dim f32 tensors.  The
    step updates ``params`` and ``opt_state`` in place and returns them,
    as the reference's donating step does.

    Called under installed rules and a mesh (``dist.sharding.use_rules``
    and ``set_mesh``, as ``launch.cells``' train cell calls it) the step
    is one rank's of the sharded step (``_sharded_step``): ``params`` and
    ``opt_state`` are the rank's shards, placed by ``shardings`` (a tree
    like ``params`` of ``dist.sharding.NamedSharding``, the cell's), and
    ``batch`` is the global batch.  Without a mesh it is the one-device
    step."""
    param_dtype = model.cfg.torch_param_dtype
    _check_cublas(model.device)

    def train_step(params, opt_state, batch, step):
        if current_rules() is not None and current_mesh() is not None:
            if microbatches != 1:
                raise NotImplementedError(
                    "the sharded step takes one microbatch (the "
                    "reference's cells build it so)")
            return _sharded_step(model, opt_cfg, params, opt_state, batch,
                                 step, fake_quant, shardings)
        with deterministic():
            if microbatches == 1:
                loss, met, grads = _grads_of(model, params, batch,
                                             fake_quant)
            else:
                grads, loss = None, 0.0
                for j in range(microbatches):
                    mb = {k: v.reshape((microbatches, v.shape[0]
                                        // microbatches) + v.shape[1:])[j]
                          for k, v in batch.items()}
                    l_j, met, g = _grads_of(model, params, mb, fake_quant)
                    if grads is None:
                        grads = tree_map(
                            lambda g, p: None if g is None else torch.zeros(
                                p.shape, dtype=torch.float32,
                                device=p.device), g, params)
                    grads = tree_map(
                        lambda a, b: None if b is None
                        else a + b.to(torch.float32), grads, g)
                    loss = loss + l_j
                grads = tree_map(lambda g: None if g is None
                                 else g / microbatches, grads)
                loss = loss / microbatches
            new_params, new_opt, omet = adamw_update(
                opt_cfg, grads, opt_state, step, param_dtype, params)
        return new_params, new_opt, {"loss": loss, **met, **omet}

    return train_step


def _sharded_step(model, opt_cfg: AdamWConfig, params, opt_state, batch,
                  step, fake_quant: bool, shardings):
    """One rank's step of the reference's ``build_train_step`` under its
    mesh (FSDP x TP; the GSPMD step of the train cell).

    The rank takes its rows of the global batch over the "batch" axes
    (("pod", "data") on the mesh), and runs the forward on its shards:
    the use points gather weights over "data" and keep "model" split
    (``models/layers.py``), and their collectives carry gradients.  The
    loss is the reference's CE over the global batch: the rank's masked
    CE sum over the valid count summed over the batch axes, so that the
    ranks' losses add up to it, plus the MoE aux loss averaged (0 for a
    dense model).  After the backward, each leaf's gradient holds the
    sum over the "data" ranks where the leaf is split over "data" (the
    FSDP gather's reduce-scatter); over the batch axes a leaf is not
    split on (every leaf over "pod", the norms over "data" too) it is
    summed here, in f32, one flat buffer per set of axes.  The global
    norm adds each distinct shard once (``optim.global_norm``) and AdamW
    updates the rank's shards.  Every rank returns the same ``loss``,
    ``ce``, ``aux``, ``grad_norm`` and ``lr``.  Every rank issues the
    same collectives in the same order (the gradients that are None are
    None on every rank).  Spans: "train_shard.grads", ".sync",
    ".adamw"."""
    from repro_torch.dist.sharding import placed_axes, rule_axes
    if shardings is None:
        raise ValueError("a sharded train step places its leaves by the "
                         "cell's shardings: build_train_step(..., "
                         "shardings=)")
    mesh, rules = current_mesh(), current_rules()
    dp = tuple(a for a in rule_axes("batch") if mesh.size(a) > 1)
    n_dp = 1
    for a in dp:
        n_dp *= mesh.size(a)
    split = [placed_axes(sh.spec, mesh, bool(rules.get("wgather")))
             for sh in leaves(shardings)]
    rows = mesh.batch_rows(next(iter(batch.values())).shape[0], dp)
    local = {k: v[rows] for k, v in batch.items()}
    with deterministic():
        with record_function("train_shard.grads"):
            loss, met, grads = _grads_of(
                model, params, local, fake_quant, parts=n_dp,
                count_sum=lambda c: mesh.sum_over(c, dp,
                                                  span="train.count"))
        with record_function("train_shard.sync"):
            gs = leaves(grads)
            by_axes: Dict[Tuple[str, ...], list] = {}
            for i, (g, axes) in enumerate(zip(gs, split)):
                over = tuple(a for a in dp if a not in axes)
                if g is not None and over:
                    by_axes.setdefault(over, []).append(i)
            for over, idx in by_axes.items():
                buf = torch.cat([gs[i].reshape(-1).to(torch.float32)
                                 for i in idx])
                buf = mesh.sum_over(buf, over, span="train.grad_sum")
                for i, part in zip(idx, torch.split(
                        buf, [gs[i].numel() for i in idx])):
                    gs[i] = part.view(gs[i].shape)
            met = mesh.sum_over(torch.stack([loss, met["ce"], met["aux"]]),
                                dp, span="train.metrics")
            grads = unflatten_like(params, gs)
            gnorm = global_norm(grads, split, mesh)
        with record_function("train_shard.adamw"):
            new_params, new_opt, omet = adamw_update(
                opt_cfg, grads, opt_state, step, model.cfg.torch_param_dtype,
                params, gnorm=gnorm)
    return new_params, new_opt, {"loss": met[0], "ce": met[1],
                                 "aux": met[2], **omet}


def build_train_step_compressed_dp(model, opt_cfg: AdamWConfig, *, groups,
                                   spec=None,
                                   fake_quant: bool = False) -> Callable:
    """Returns train_step(params, opt_state, batch, step) -> (params,
    opt_state, metrics) for one rank of ``groups`` (a
    ``dist.groups.DPGroups``): ``batch`` is the global batch, of which the
    rank takes rows ``[r B/n, (r+1) B/n)`` (the reference's ``P(dp)``
    split of dim 0); the gradient of its rows is averaged over the ranks
    by ``mx_allreduce_tree``, then AdamW updates the rank's replica of the
    params and state in place.  Every rank returns the same metrics:
    ``loss`` averaged over the ranks (the reference's ``pmean``),
    ``grad_norm`` and ``lr`` of the shared update, and ``ce`` and ``aux``
    of rank 0's rows, which is what the reference's ``shard_map`` returns
    for these unreduced values under ``out_specs P()`` (its first
    device's).  The exchange spec defaults to the config policy's
    ``grads`` role, else e4m3/ocp.  At a world of one the step is
    ``build_train_step``'s, bit for bit."""
    cfg = model.cfg
    spec = as_spec(spec) if spec is not None else (
        cfg.mx.grads or QuantSpec("e4m3", "ocp"))
    param_dtype = cfg.torch_param_dtype
    _check_cublas(model.device)

    def train_step(params, opt_state, batch, step):
        rows = groups.batch_rows(next(iter(batch.values())).shape[0])
        local = {k: v[rows] for k, v in batch.items()}
        with deterministic():
            with record_function("dp_step.grads"):
                loss, met, grads = _grads_of(model, params, local,
                                             fake_quant)
            with record_function("dp_step.exchange"):
                grads = mx_allreduce_tree(grads, groups, spec)
                loss = groups.mean(loss)
                ce_aux = groups.broadcast(torch.stack([met["ce"],
                                                       met["aux"]]))
            with record_function("dp_step.adamw"):
                new_params, new_opt, omet = adamw_update(
                    opt_cfg, grads, opt_state, step, param_dtype, params)
        return new_params, new_opt, {"loss": loss, "ce": ce_aux[0],
                                     "aux": ce_aux[1], **omet}

    return train_step


def init_train_state(model, seed: int = 0) -> Tuple[Dict[str, Any], Any]:
    """Random params (``model.init``, on the model's device) and their
    AdamW state."""
    params = model.init(seed=seed)
    return params, adamw_init(params)
