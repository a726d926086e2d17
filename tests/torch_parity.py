"""Test-only bridge between the JAX package and the PyTorch port.

The two packages meet only as numpy arrays: ``params_to_numpy`` turns a
reference param tree (jax arrays, ``MXWeight`` leaves) into the plain
tree ``repro_torch.models.params.from_numpy`` accepts.
"""
import numpy as np

from repro.core.mx_weight import MXWeight


def params_to_numpy(tree):
    if isinstance(tree, MXWeight):
        return {"codes": np.asarray(tree.codes),
                "scales": np.asarray(tree.scales), "fmt": tree.fmt,
                "mode": tree.mode, "block": tree.block,
                "packed": tree.packed, "k": tree.k, "n": tree.n}
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)
