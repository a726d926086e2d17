"""Carry parameters across from the reference package, as numpy.

The reference keeps its layer params stacked on a leading ``n_scan`` axis
(one ``lax.scan`` slice per layer); the port keeps a list of per-layer
dicts.  ``from_numpy`` takes the reference's tree with every array
already converted to numpy (the caller does the jax -> numpy step; this
package never sees a jax object) and returns the port's params on
``device``.  An ``MXWeight`` leaf arrives as a dict
``{"codes", "scales", "fmt", "mode", "block", "packed", "k", "n"}`` and is
rebuilt byte for byte, so both sides compute with identical weights.
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
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def _leaf(leaf, i, cfg: ModelConfig, device):
    """Layer ``i``'s slice of one stacked leaf (``i`` None: unstacked)."""
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
        return {k: _leaf(v, i, cfg, device) for k, v in leaf.items()}
    arr = np.asarray(leaf)
    return _tensor(arr if i is None else arr[i], cfg.torch_dtype, device)


def from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
               device="cuda") -> Dict[str, Any]:
    """The reference's params (numpy leaves; stacked ``layers``) -> the
    port's params (per-layer list) on ``device`` (the card unless the
    caller asks for ``"cpu"``)."""
    device = torch.device(device)
    n = next(v for v in _first_leaves(tree["layers"])).shape[0]
    if n != cfg.n_layers:
        raise ValueError(f"params hold {n} layers, config says "
                         f"{cfg.n_layers}")
    out = {k: _leaf(tree[k], None, cfg, device)
           for k in ("embed", "norm_f", "lm_head") if k in tree}
    out["layers"] = [_leaf(tree["layers"], i, cfg, device)
                     for i in range(n)]
    return out


def _first_leaves(t):
    if _is_mx(t):
        yield np.asarray(t["codes"])
    elif isinstance(t, dict):
        for v in t.values():
            yield from _first_leaves(v)
    else:
        yield np.asarray(t)
