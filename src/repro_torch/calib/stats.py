"""Streaming per-(role, layer) tensor statistics for calibration (mirrors
src/repro/calib/stats.py).

``collect_model_stats`` runs calibration batches through the instrumented
forward (``Model.forward_calib`` taps the unquantized tensors of the
``activations`` / ``kv_key`` / ``kv_value`` roles per layer), reads the
``weights`` role off the params, and, when asked, runs one LM-loss
backward per batch for the ``grads`` role.  Each tensor is reduced where
it lies (on the card for a model on the card): absmax, sum, sum of
squares, the biased-FP32-exponent histogram and the leading block rows;
the host merges the small results per batch and frees the batch's taps
before the next one.

Samples are block rows along each role's quantization axis (head_dim for
KV, the feature dim for activations, the input dim for weights), so
quantizing a sample along its last axis reproduces the consumer's block
decomposition.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.formats import DEFAULT_BLOCK
from repro_torch.core.mx_weight import MXWeight
from repro_torch.models import decoder

ROLES_FORWARD = ("activations", "kv_key", "kv_value")
ALL_ROLES = ("weights", "activations", "kv_key", "kv_value", "grads")

# params leaves left out of the weights role: the router runs in f32
# outside the quantized matmuls
_WEIGHT_EXCLUDE = ("router",)

# where the reference's collect_model_stats stops on the other families:
# it walks the decoder's layer stack, and its grads-role loss runs the
# model on tokens alone
_REFERENCE_LIMIT = {
    "hybrid": "KeyError: 'layers' (src/repro/calib/stats.py:183, the "
              "decoder's layer stack)",
    "rwkv": "KeyError: 'layers' (src/repro/calib/stats.py:183, the "
            "decoder's layer stack)",
    "encdec": "KeyError: 'frames' (src/repro/calib/stats.py:192 runs the "
              "model on tokens alone; src/repro/models/registry.py:64)",
}


# =============================================================================
# TensorStats: one (role, layer)'s streaming accumulator
# =============================================================================
@dataclasses.dataclass
class TensorStats:
    """Streaming statistics plus a bounded block sample of one tensor
    stream.  ``exp_hist[e]`` counts finite non-zero elements of biased
    FP32 exponent ``e`` (what the converter's max-exponent step and shared
    scale consume)."""

    count: int = 0
    n_zero: int = 0
    absmax: float = 0.0
    total: float = 0.0
    sumsq: float = 0.0
    exp_hist: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(256, np.int64))
    sample: Optional[np.ndarray] = None       # (rows, block) f32

    @property
    def mean(self) -> float:
        return self.total / max(1, self.count)

    @property
    def rms(self) -> float:
        return float(np.sqrt(self.sumsq / max(1, self.count)))

    @property
    def zero_frac(self) -> float:
        return self.n_zero / max(1, self.count)

    def exp_percentile(self, q: float) -> int:
        """Biased-exponent value at quantile ``q`` of the histogram."""
        c = np.cumsum(self.exp_hist)
        if c[-1] == 0:
            return 0
        return int(np.searchsorted(c, q * c[-1], side="left"))

    def merge(self, other: "TensorStats",
              sample_rows: int = 4096) -> "TensorStats":
        """Fold ``other`` into this accumulator (streaming merge)."""
        self.count += other.count
        self.n_zero += other.n_zero
        self.absmax = max(self.absmax, other.absmax)
        self.total += other.total
        self.sumsq += other.sumsq
        self.exp_hist = self.exp_hist + other.exp_hist
        if other.sample is not None:
            if self.sample is None:
                self.sample = other.sample[:sample_rows]
            elif self.sample.shape[0] < sample_rows:
                room = sample_rows - self.sample.shape[0]
                self.sample = np.concatenate(
                    [self.sample, other.sample[:room]], axis=0)
        return self


# =============================================================================
# the per-tensor reduction (on the tensor's device)
# =============================================================================
def _block_rows(x: torch.Tensor, block: int) -> torch.Tensor:
    """(rows, block) f32 along the trailing (quantization) axis, the
    trailing dim zero-padded to a block multiple."""
    x = x.to(torch.float32)
    pad = (-x.shape[-1]) % block
    if pad:
        x = F.pad(x, (0, pad))
    return x.reshape(-1, block)


def tensor_reduction(x: torch.Tensor, block: int = DEFAULT_BLOCK,
                     sample_rows: int = 4096) -> Dict[str, torch.Tensor]:
    """Moments, the exponent histogram of the f32 values (read through
    ``view(torch.int32)``; the padding's zeros count in ``count`` and
    ``n_zero``) and the leading ``sample_rows`` block rows, as tensors
    on ``x``'s device."""
    rows = _block_rows(x, block)
    flat = rows.reshape(-1)
    exp = (flat.view(torch.int32) >> 23) & 0xFF
    finite_nz = (exp != 0xFF) & (flat != 0.0)
    return {
        "count": torch.tensor(flat.numel(), dtype=torch.int64),
        "n_zero": torch.sum(flat == 0.0),
        "absmax": torch.amax(torch.abs(flat)),
        "total": torch.sum(flat),
        "sumsq": torch.sum(flat * flat),
        "exp_hist": torch.bincount(exp[finite_nz], minlength=256),
        # a copy: a view would hold the whole f32 copy of x alive
        "sample": rows[:sample_rows].clone(),
    }


def _to_stats(red) -> TensorStats:
    return TensorStats(
        count=int(red["count"]), n_zero=int(red["n_zero"]),
        absmax=float(red["absmax"]), total=float(red["total"]),
        sumsq=float(red["sumsq"]),
        exp_hist=red["exp_hist"].cpu().numpy().astype(np.int64),
        sample=red["sample"].cpu().numpy().astype(np.float32))


# =============================================================================
# CalibStats: the whole collection
# =============================================================================
@dataclasses.dataclass
class CalibStats:
    """``stats[role][layer]`` for every collected role, layers numbered
    absolutely (an MoE config's leading dense layers first), as
    ``PolicyTable`` numbers them."""

    arch: str
    n_layers: int
    n_batches: int
    stats: Dict[str, Dict[int, TensorStats]]

    def role_layers(self, role: str) -> Dict[int, TensorStats]:
        if role not in self.stats:
            raise KeyError(
                f"role {role!r} was not collected; have "
                f"{sorted(self.stats)} (pass it in roles= to "
                f"collect_model_stats)")
        return self.stats[role]


def _weight_leaves(tree, path="") -> List[Tuple[str, torch.Tensor]]:
    """A layer's matmul weight leaves (2-D and up, the router left out) in
    the reference's pytree order (dict keys sorted at every level)."""
    out = []
    for key in sorted(tree):
        val, name = tree[key], f"{path}[{key!r}]"
        if isinstance(val, dict):
            out.extend(_weight_leaves(val, name))
        elif isinstance(val, MXWeight):
            raise ValueError(
                f"collect_model_stats: {name} is an MXWeight; the weights "
                f"and grads roles read fp params (calibrate before "
                f"quantize_weights)")
        elif val.dim() >= 2 and not any(x in name for x in _WEIGHT_EXCLUDE):
            out.append((name, val))
    return out


def _layer_rows(leaves, block: int) -> torch.Tensor:
    """One layer's weight (or gradient) leaves as block rows along the
    contraction axis, concatenated: dense() quantizes (K, N) weights and
    the expert stacks (E, K, N) along K, the second-to-last axis."""
    return torch.cat([_block_rows(w.transpose(-1, -2), block)
                      for w in leaves], dim=0)


def _lm_loss(model, params, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy plus 0.01 x the MoE aux loss (the grads
    role's calibration signal)."""
    logits, aux = decoder._forward_with_aux(params, tokens, model.cfg)
    lp = torch.log_softmax(
        logits[:, :-1, :model.cfg.vocab].to(torch.float32), dim=-1)
    tgt = tokens[:, 1:].to(torch.int64)
    nll = -torch.gather(lp, -1, tgt[..., None])
    return torch.mean(nll) + 0.01 * aux


def _grad_reductions(model, params, tokens, red, block: int) -> List[Dict]:
    """One LM-loss backward; each layer's weight gradients reduced."""
    def attach(tree):
        """The tree with each weight leaf a leaf of the autograd graph."""
        return {key: attach(val) if isinstance(val, dict)
                else val.detach().requires_grad_(True)
                if val.dim() >= 2 and key not in _WEIGHT_EXCLUDE else val
                for key, val in tree.items()}

    layers = [attach(lp) for lp in params["layers"]]
    leaves = [[t for _, t in _weight_leaves(lp)] for lp in layers]
    p = dict(params, layers=layers)
    with torch.enable_grad():
        loss = _lm_loss(model, p, tokens)
        flat = [t for lv in leaves for t in lv]
        gs = torch.autograd.grad(loss, flat)
    out, k = [], 0
    for lv in leaves:
        out.append(red(_layer_rows(gs[k:k + len(lv)], block)))
        k += len(lv)
    return out


def collect_model_stats(model, params, batches: Iterable[np.ndarray], *,
                        roles: Sequence[str] = ROLES_FORWARD + ("weights",),
                        block: int = DEFAULT_BLOCK,
                        sample_rows: int = 4096) -> CalibStats:
    """Collect per-(role, layer) statistics from calibration batches.

    ``model`` is a ``models.registry.Model`` of the decoder family (the
    others raise where the reference's stops) over fp ``params``;
    ``batches`` yields (B, S) int32 token arrays.  The weights role reads
    the params (no forward); ``grads`` runs one LM-loss backward per
    batch (attention through ``flash_attention_vjp`` at ``"flash"``).
    Each batch's taps are reduced and dropped before the next batch."""
    roles = tuple(roles)
    for r in roles:
        if r not in ALL_ROLES:
            raise ValueError(f"unknown tensor role {r!r}; choose from "
                             f"{list(ALL_ROLES)}")
    family = model.cfg.family
    if family != "decoder":
        raise NotImplementedError(
            f"{model.cfg.name}: calibration covers the decoder family, as "
            f"the reference's does: its collect_model_stats stops on the "
            f"{family!r} family with {_REFERENCE_LIMIT[family]}")
    acc: Dict[str, Dict[int, TensorStats]] = {r: {} for r in roles}
    fwd_roles = tuple(r for r in roles if r in ROLES_FORWARD)
    red = functools.partial(tensor_reduction, block=block,
                            sample_rows=sample_rows)

    def fold(role, layer, red_out):
        acc[role].setdefault(layer, TensorStats()).merge(
            _to_stats(red_out), sample_rows)

    n_batches = 0
    for tokens in batches:
        tokens = torch.as_tensor(np.asarray(tokens, np.int32),
                                 device=model.device)
        n_batches += 1
        if fwd_roles:
            with torch.no_grad():
                _, _, taps = model.forward_calib(params, tokens)
                for role in fwd_roles:
                    for layer, t in enumerate(taps[role]):
                        fold(role, layer, red(t))
            del taps
        if "grads" in roles:
            for layer, r in enumerate(
                    _grad_reductions(model, params, tokens, red, block)):
                fold("grads", layer, r)
    if "weights" in roles:
        with torch.no_grad():
            for layer, lp in enumerate(params["layers"]):
                fold("weights", layer, red(_layer_rows(
                    [w for _, w in _weight_leaves(lp)], block)))
    n_layers = max((max(d) + 1 for d in acc.values() if d), default=0)
    return CalibStats(arch=model.cfg.name, n_layers=n_layers,
                      n_batches=n_batches, stats=acc)
