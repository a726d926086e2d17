"""Atomic checkpoints (mirrors src/repro/ckpt/checkpoint.py).

Layout:  <dir>/step_<N>/   arrays.npz     ("/"-joined tree path -> array)
                            manifest.json  (step, keys, tree, metadata)

Writes go to ``step_<N>.tmp``, then ``os.replace``: a crash mid-save
never corrupts the latest checkpoint.  Arrays are saved from the host;
``restore`` puts each back on the device and in the dtype of the
matching leaf of ``like``, or, given ``shardings``, only this rank's
shard of it (the reference's elastic restore across mesh shapes).  A bf16 tensor is stored as its raw 2-byte
words (numpy dtype ``|V2``), the bytes the reference's numpy writes for
a bf16 array, and restored bit for bit.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import leaves_with_path, path_key, unflatten_like


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _from_numpy(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if a.dtype.kind == "V":
        if like.dtype != torch.bfloat16 or a.dtype.itemsize != 2:
            raise ValueError(f"checkpoint: raw {a.dtype} words restore only "
                             f"into bfloat16, not {like.dtype}")
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a).to(like.dtype)
    return t.to(like.device)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {path_key(p): _to_numpy(leaf)
            for p, leaf in leaves_with_path(tree)}


def _structure(tree):
    """The tree's shape as JSON: dict keys, list lengths (the manifest's
    counterpart of the reference's treedef string)."""
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_structure(v) for v in tree]
    return None


def save_atomic(ckpt_dir: str, step: int, state: Dict[str, Any],
                metadata: Optional[Dict[str, Any]] = None) -> str:
    """state: a tree of tensors (params / optimizer state / ...);
    metadata: JSON-able."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = _flatten(state)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    manifest = {
        "step": step,
        "keys": sorted(flat.keys()),
        "treedef": _structure(state),
        "metadata": metadata or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for d in os.listdir(ckpt_dir)
             if (m := re.fullmatch(r"step_(\d+)", d))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like: Any,
            shardings: Any = None) -> Tuple[Any, Dict[str, Any]]:
    """Restore into the structure of ``like`` (shapes must match), each
    leaf on its ``like`` leaf's device and in its dtype; returns (tree,
    metadata).  ``shardings`` (a tree like ``like`` of
    ``dist.sharding.NamedSharding``: this rank's mesh and a spec per
    leaf) is the reference's elastic path: every rank keeps its own
    shard of each leaf, on a mesh whose shape need not be the one that
    saved it (the arrays are saved whole)."""
    from repro_torch.dist.sharding import shard_leaf
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    data = np.load(os.path.join(path, "arrays.npz"))
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    shard = [s for _, s in leaves_with_path(shardings)] \
        if shardings is not None else None
    out = []
    for i, (pth, leaf) in enumerate(leaves_with_path(like)):
        key = path_key(pth)
        arr = data[key]
        if arr.shape != tuple(leaf.shape):
            raise ValueError(f"checkpoint {path}: {key} has shape "
                             f"{arr.shape}, expected {tuple(leaf.shape)}")
        t = _from_numpy(arr, leaf)
        if shard is not None and shard[i] is not None:
            t = shard_leaf(t, shard[i].spec, shard[i].mesh, dp=True)
        out.append(t)
    return unflatten_like(like, out), manifest["metadata"]


def gc_old(ckpt_dir: str, keep: int = 3) -> None:
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(int(m.group(1)) for d in os.listdir(ckpt_dir)
                   if (m := re.fullmatch(r"step_(\d+)", d)))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
