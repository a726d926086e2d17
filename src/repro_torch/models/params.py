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

The other families stack their layers too, and the port keeps each as a
list: the hybrid's Mamba2 ``blocks`` (its ``shared_attn`` block is one
tree), RWKV's ``blocks``, the encoder-decoder's ``enc_layers`` and
``dec_layers`` (each decoder layer with its ``xattn``).  MLA layers
carry their own keys (``w_dkv``, ``w_kr``, ``w_uk``, ``w_uv``, ``w_dq``,
``w_uq``, the two norms) through the decoder's path.
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


# fp leaves kept in f32 whatever the config's dtype: the MoE router (ref
# layers.py:881), Mamba2's decay, step bias and skip (ref ssm.py:40-42),
# RWKV's decay base and bonus (ref rwkv.py:41-47)
_F32_KEYS = frozenset({"router", "a_log", "dt_bias", "d_skip", "w0", "u"})
# the layer stacks of the other families, one list each in the port
_STACKS = ("blocks", "enc_layers", "dec_layers")


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
    """The reference's params (numpy leaves; a decoder's ``dense_layers``
    then its stacked ``layers``, another family's stacks) -> the port's
    params (per-layer lists) on
    ``device`` (the card unless the caller asks for ``"cpu"``); every fp
    leaf in ``dtype`` when given (a gradient or optimizer-state tree of
    the params' structure), else as the config stores it."""
    device = torch.device(device)
    if cfg.family != "decoder":
        return {k: [_leaf(v, i, cfg, device, dtype=dtype)
                    for i in range(_depth(v))] if k in _STACKS
                else _leaf(v, None, cfg, device, dtype=dtype)
                for k, v in tree.items()}
    dense = tree.get("dense_layers", [])
    stack = tree["layers"]
    n = _depth(stack)
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


def _depth(stack) -> int:
    """Layers of a stacked tree (or of a per-layer list)."""
    if isinstance(stack, (list, tuple)):
        return len(stack)
    return next(v for v in _first_leaves(stack)).shape[0]


def _first_leaves(t):
    if _is_mx(t):
        yield np.asarray(t["codes"])
    elif isinstance(t, dict):
        for v in t.values():
            yield from _first_leaves(v)
    else:
        yield np.asarray(t)
