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
    if isinstance(tree, (list, tuple)):       # an MoE config's dense_layers
        return [params_to_numpy(v) for v in tree]
    return np.asarray(tree)


def random_moments(opt_state, seed: int = 0, scale: float = 1e-2):
    """A reference AdamW state whose ``m`` and ``v`` are random (``v``
    positive), ``master`` kept: a step from it is set by the moments, not
    by the sign of gradient elements that sit at the two frameworks'
    rounding noise (as a first step from zero moments is)."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)

    ms = jax.tree_util.tree_map(
        lambda x: rng.normal(size=x.shape).astype(np.float32) * scale,
        opt_state["m"])
    # |m| / sqrt(v) <= 1, as after steps of a steady gradient
    vs = jax.tree_util.tree_map(lambda m: (np.abs(m) + scale) ** 2, ms)
    return {"master": opt_state["master"],
            "m": jax.tree_util.tree_map(jnp.asarray, ms),
            "v": jax.tree_util.tree_map(jnp.asarray, vs)}


class LogitsTap:
    """A reference ``Model`` whose forward keeps its last logits, so that
    one ``jax.value_and_grad`` of the reference's ``_loss_fn`` can return
    them as aux (the logits are of that trace)."""

    def __init__(self, model):
        self.model, self.cfg, self.logits = model, model.cfg, None

    def forward(self, params, batch, *, fake_quant=False):
        out = self.model.forward(params, batch, fake_quant=fake_quant)
        self.logits = out[0]
        return out
