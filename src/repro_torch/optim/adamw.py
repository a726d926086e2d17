"""AdamW with f32 master weights (mirrors src/repro/optim/adamw.py).

State layout (every leaf mirrors the param tree, all f32):
    master — authoritative f32 weights
    m, v   — moments

Plain torch, as the reference is plain jnp (no kernel), in the
reference's f32 order of operations.  ``torch.optim.AdamW`` is another
computation (weight decay applied apart, no master copy) and is not
used.  A gradient leaf of ``None`` (a weight reached only through a
fake quantizer, ROADMAP C9) counts as a zero gradient: its moments
decay, its master weight takes the weight decay, and it adds 0 to the
global norm, as the reference's all-zero gradient does.

The schedules run on the host in f32 (0-dim CPU tensors: the step is a
host int in the loop); the clipping scale depends on the gradients and
stays on their device, so an update waits for the host nowhere.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.tree import leaves, tree_map

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"          # cosine | wsd | const


def _step_f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(device="cpu", dtype=_F32)


def cosine_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    s = _step_f32(step)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * prog))


def wsd_schedule(cfg: AdamWConfig, step,
                 decay_frac: float = 0.1) -> torch.Tensor:
    """Warmup-Stable-Decay."""
    s = _step_f32(step)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    decay_start = cfg.total_steps * (1.0 - decay_frac)
    dec = torch.clamp(1.0 - (s - decay_start)
                      / max(cfg.total_steps - decay_start, 1), 0.0, 1.0)
    return cfg.lr * warm * dec


def _lr(cfg: AdamWConfig, step) -> torch.Tensor:
    if cfg.schedule == "wsd":
        return wsd_schedule(cfg, step)
    if cfg.schedule == "const":
        return torch.tensor(cfg.lr, dtype=_F32)
    return cosine_schedule(cfg, step)


def adamw_init(params) -> Dict[str, Any]:
    """f32 ``master`` (a copy of the params), zero ``m`` and ``v``, each
    on its param's device."""
    return {
        "master": tree_map(lambda p: p.detach().to(_F32, copy=True), params),
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=_F32,
                                            device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=_F32,
                                            device=p.device), params),
    }


def global_norm(tree, split=None, mesh=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares in f32 (``None`` leaves add
    nothing).  Over a sharded tree (``split``: the mesh axes each leaf
    is split over, one tuple per leaf in ``leaves`` order; ``mesh`` this
    rank's ``DPGroups``) each leaf's sum of squares is summed over the
    axes it is split on, once per distinct shard, and counted once over
    those it is replicated on, so every rank gets the whole tree's norm;
    the leaves are then added in the same order as without a mesh."""
    sq = [None if g is None else torch.sum(torch.square(g.to(_F32)))
          for g in leaves(tree)]
    if split is not None:
        by_axes: Dict[Tuple[str, ...], list] = {}
        for i, (axes, v) in enumerate(zip(split, sq)):
            live = tuple(a for a in axes if mesh.size(a) > 1)
            if v is not None and live:
                by_axes.setdefault(live, []).append(i)
        for axes, idx in by_axes.items():     # the same order on every rank
            tot = mesh.sum_over(torch.stack([sq[i] for i in idx]), axes,
                                span="train.norm")
            for j, i in enumerate(idx):
                sq[i] = tot[j]
    sq = [v for v in sq if v is not None]
    if not sq:
        return torch.zeros((), dtype=_F32)
    return torch.sqrt(sum(sq[1:], sq[0]))


# elements of a leaf updated at once: on the card 64 MiB per f32
# temporary (an internvl2-76b embedding's update in one piece holds ~24
# GiB of them) in few launches; on the CPU 4 MiB, so that a slice's
# arithmetic runs in cache
UPDATE_SLICE = 1 << 24
UPDATE_SLICE_CPU = 1 << 20


def adamw_update(cfg: AdamWConfig, grads, state, step, param_dtype, params,
                 gnorm: Optional[torch.Tensor] = None
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, Any]]:
    """One AdamW step, in place, as the reference's jitted step donates
    its buffers: the new ``m``, ``v`` and ``master`` are written into
    ``state``'s tensors and the new params (master cast to
    ``param_dtype``) into ``params``'s, a leaf stored wider (the MoE
    router in f32) taking the cast value; returns (params, state,
    metrics).  Leaves
    are updated one at a time, a large one in slices of
    ``UPDATE_SLICE`` elements (``UPDATE_SLICE_CPU`` on the CPU), so the
    extra memory is a few of those slices, not the state.  A caller that
    needs the old values clones them first.  ``gnorm`` is the
    gradients' global norm where the caller has it (a sharded step's,
    ``global_norm(grads, split, mesh)``), else ``global_norm(grads)``;
    the update itself is elementwise, so a rank updates its shards."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = _lr(cfg, step)
    t = _step_f32(step) + 1.0
    bc1 = 1.0 - torch.tensor(cfg.b1, dtype=_F32) ** t
    bc2 = 1.0 - torch.tensor(cfg.b2, dtype=_F32) ** t
    lr_f, bc1_f, bc2_f = float(lr), float(bc1), float(bc2)

    def upd(g, m, v, mast):
        """The reference's update, its operations in its order, written
        into m, v and mast: m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g
        g, mast = mast - lr (m / bc1 / (sqrt(v / bc2) + eps) + wd mast)."""
        m.mul_(cfg.b1)
        v.mul_(cfg.b2)
        if g is not None:                     # else a zero gradient
            g = g.to(_F32) * scale
            m.add_(g * (1.0 - cfg.b1))
            gg = g * (1.0 - cfg.b2)
            v.add_(gg.mul_(g))
            del g, gg
        step_dir = m / bc1_f
        den = v / bc2_f
        step_dir.div_(den.sqrt_().add_(cfg.eps))
        del den
        step_dir.add_(mast * cfg.weight_decay)
        mast.sub_(step_dir.mul_(lr_f))

    flat = [leaves(grads), leaves(state["m"]), leaves(state["v"]),
            leaves(state["master"]), leaves(params)]
    if len({len(f) for f in flat}) != 1:
        raise ValueError("adamw_update: grads, state and params trees "
                         "differ")
    for g, m, v, w, p in zip(*flat):
        # in slices (element-wise arithmetic: the same bits), so that a
        # large leaf's f32 temporaries stay small beside the state; the
        # state and params are contiguous (view raises otherwise), a
        # gradient is flattened once
        g = None if g is None else g.reshape(-1)
        m, v, w, p = (t.view(-1) for t in (m, v, w, p))
        step_n = UPDATE_SLICE if w.is_cuda else UPDATE_SLICE_CPU
        for a in range(0, w.numel(), step_n):
            part = slice(a, a + step_n)
            upd(None if g is None else g[part], m[part], v[part], w[part])
            p[part].copy_(w[part].to(param_dtype))
    return params, state, {"grad_norm": gnorm, "lr": lr}
