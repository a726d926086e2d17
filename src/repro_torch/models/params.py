"""Carry parameters across from the reference package, as numpy.

The reference keeps its layer params stacked on a leading ``n_scan`` axis
(one ``lax.scan`` slice per layer), after a list ``dense_layers`` of the
leading dense layers of an MoE config; the port keeps one list of
``n_layers`` per-layer dicts, the dense layers first (its KV caches and
pools stack all ``n_layers`` on one leading axis alike).  An MoE layer's
expert stacks keep their leading ``E`` axis, and its router stays f32
whatever the config's dtype, as the reference's does.  ``from_numpy`` takes the reference's tree with every array
already converted to numpy (the caller does the jax -> numpy step; this
package never sees a jax object) and returns the port's params on
``device``.  An ``MXWeight`` leaf arrives as a dict
``{"codes", "scales", "fmt", "mode", "block", "packed", "k", "n"}`` and is
rebuilt byte for byte, so both sides compute with identical weights.
Under a per-layer policy table the reference's quantized ``layers`` are
a list of per-layer trees (each at its own weight format) instead of a
stack; both are taken.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.mx_weight import MXWeight
from repro_torch.models.config import ModelConfig

_MX_KEYS = {"codes", "scales", "fmt", "mode", "block", "packed", "k", "n"}


def _is_mx(leaf) -> bool:
    return isinstance(leaf, dict) and set(leaf) == _MX_KEYS


def _tensor(a, dtype, device) -> torch.Tensor:
    a = np.array(a)
    if a.dtype.name == "bfloat16":        # numpy has no bf16 torch takes;
        a = a.astype(np.float32)          # widening to f32 is exact
    return torch.from_numpy(a).to(device=device, dtype=dtype)


# fp leaves kept in f32 whatever the config's dtype (ref layers.py:881)
_F32_KEYS = frozenset({"router"})


def _leaf(leaf, i, cfg: ModelConfig, device, key: str = "", dtype=None):
    """Layer ``i``'s slice of one stacked leaf (``i`` None: unstacked); an
    fp leaf in ``dtype`` when given, else in the config's dtype (f32 for
    the router)."""
    if _is_mx(leaf):
        codes, scales = leaf["codes"], leaf["scales"]
        if i is not None:
            codes, scales = codes[i], scales[i]
        return MXWeight(codes=_tensor(codes, torch.uint8, device),
                        scales=_tensor(scales, torch.uint8, device),
                        fmt=str(leaf["fmt"]), mode=str(leaf["mode"]),
                        block=int(leaf["block"]),
                        packed=bool(leaf["packed"]), k=int(leaf["k"]),
                        n=int(leaf["n"]))
    if isinstance(leaf, dict):
        return {k: _leaf(v, i, cfg, device, k, dtype)
                for k, v in leaf.items()}
    arr = np.asarray(leaf)
    if dtype is None:
        dtype = torch.float32 if key in _F32_KEYS else cfg.torch_dtype
    return _tensor(arr if i is None else arr[i], dtype, device)


def from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
               device="cuda", dtype=None) -> Dict[str, Any]:
    """The reference's params (numpy leaves; ``dense_layers`` then the
    stacked ``layers``) -> the port's params (one per-layer list) on
    ``device`` (the card unless the caller asks for ``"cpu"``); every fp
    leaf in ``dtype`` when given (a gradient or optimizer-state tree of
    the params' structure), else as the config stores it."""
    device = torch.device(device)
    dense = tree.get("dense_layers", [])
    stack = tree["layers"]
    if isinstance(stack, (list, tuple)):      # per-layer (a policy table)
        n = len(stack)
    else:
        n = next(v for v in _first_leaves(stack)).shape[0]
    if len(dense) != cfg.n_dense_layers or len(dense) + n != cfg.n_layers:
        raise ValueError(f"params hold {len(dense)} dense + {n} stacked "
                         f"layers, config says {cfg.n_dense_layers} dense "
                         f"of {cfg.n_layers}")
    out = {k: _leaf(tree[k], None, cfg, device, dtype=dtype)
           for k in ("embed", "norm_f", "lm_head") if k in tree}
    out["layers"] = [_leaf(lp, None, cfg, device, dtype=dtype)
                     for lp in dense] + (
        [_leaf(lp, None, cfg, device, dtype=dtype) for lp in stack]
        if isinstance(stack, (list, tuple))
        else [_leaf(stack, i, cfg, device, dtype=dtype) for i in range(n)])
    return out


def opt_state_from_numpy(state: Dict[str, Any], cfg: ModelConfig,
                         device="cuda") -> Dict[str, Any]:
    """The reference's AdamW state (``master``, ``m``, ``v``, each a
    numpy tree of the params' structure) -> the port's, all f32."""
    return {k: from_numpy(state[k], cfg, device, dtype=torch.float32)
            for k in ("master", "m", "v")}


def _first_leaves(t):
    if _is_mx(t):
        yield np.asarray(t["codes"])
    elif isinstance(t, dict):
        for v in t.values():
            yield from _first_leaves(v)
    else:
        yield np.asarray(t)
