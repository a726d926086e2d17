"""MX-compressed gradient collectives (mirrors
src/repro/core/grad_compress.py): the paper's converter as a
distributed-optimization trick.

The exchange, over the DP process groups of ``dist.groups``:

    reduce-scatter (f32)  ->  mx_quantize (8.25 bit)  ->  all-gather (u8)
                          ->  mx_dequantize

The reduction itself stays f32 (sums of quantized values would
accumulate bias); only the broadcast half of the all-reduce is
compressed, cutting the bytes a rank sends from 2x the f32 size to
(1x f32 + 0.26x).  The owned shard is converted by
``kernels.ops.mx_quantize``: the converter kernel (csrc/mx_quant.cu) on a
CUDA tensor, the plain converter on a CPU tensor.  The reference
quantizes it in plain jnp; codes and scales are the same bytes either
way.  The kernel takes block 32 only, so another block raises on the
card.  Gloo ranks sharing a card stage the f32 buffer and the code and
scale bytes through pinned host memory (``dist.groups``).  The
converter and the dequantize run in ``record_function`` spans
("dp.quantize", "dp.dequantize"), beside the wire's of ``dist.groups``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.core.convert import MXArray, mx_dequantize
from repro_torch.core.spec import QuantSpec, as_spec
from repro_torch.tree import tree_map

_GRAD_DEFAULT = QuantSpec("e4m3", "ocp")


def _grads_spec(spec) -> QuantSpec:
    """The exchange spec: an explicit argument, then the ``grads`` role of
    the policy installed with the sharding rules, then e4m3/ocp."""
    if spec is None:
        from repro_torch.dist.sharding import quant_spec_for
        spec = quant_spec_for("grads")
    return as_spec(spec) if spec is not None else _GRAD_DEFAULT


def compressed_mean(g: torch.Tensor, groups, spec: QuantSpec) -> MXArray:
    """The exchange of ``g`` without the final dequantize: the mean over
    the ranks of ``groups`` (a ``dist.groups.DPGroups`` of world > 1) of
    ``g`` flattened to f32 and zero-padded to a multiple of n x block, as
    the MX codes and scales every rank gathers (1-D, blocked along axis
    0).  Each rank converts only its own shard (one converter launch)."""
    from repro_torch.kernels.ops import mx_quantize
    n = groups.world
    flat = g.detach().reshape(-1).to(torch.float32)
    pad = (-flat.numel()) % (n * spec.block)
    if pad:
        flat = F.pad(flat, (0, pad))
    # hierarchical f32 reduce-scatter, the outer axis (pod) first: each
    # leaves this rank a 1/k shard of the partial sums
    x = groups.to_wire(flat)
    for a in groups.axes:
        if groups.size(a) > 1:
            x = groups.reduce_scatter(x, a)
    shard = groups.from_wire(x) / n
    # compress the owned shard, all-gather codes and scales, in the
    # reverse order of the axes
    with record_function("dp.quantize"):
        mx = mx_quantize(shard, spec)
    codes, scales = groups.to_wire(mx.codes), groups.to_wire(mx.scales)
    for a in reversed(groups.axes):
        if groups.size(a) > 1:
            codes = groups.all_gather(codes, a)
            scales = groups.all_gather(scales, a)
    return MXArray.from_spec(groups.from_wire(codes),
                             groups.from_wire(scales), spec, axis=0)


def mx_allreduce_mean(g: torch.Tensor, groups, spec=None) -> torch.Tensor:
    """All-reduce-mean of ``g`` over the ranks of ``groups`` with the
    MX-compressed gather; every rank returns the same tensor, in ``g``'s
    shape and dtype.  ``spec`` is a QuantSpec (default: the ``grads`` role
    of the installed sharding rules, else e4m3/ocp).  A world of one
    returns ``g`` itself, as the reference does for a mesh of one
    device."""
    spec = _grads_spec(spec)
    if groups.world == 1:
        return g
    mx = compressed_mean(g, groups, spec)
    with record_function("dp.dequantize"):
        out = mx_dequantize(mx)
        return out[: g.numel()].reshape(g.shape).to(g.dtype)


def mx_allreduce_tree(grads, groups, spec=None):
    """``mx_allreduce_mean`` over every leaf of a gradient tree
    (``repro_torch.tree``), one exchange per leaf.  A ``None`` leaf (a
    weight the loss reaches only through a fake quantizer, ROADMAP C9)
    stays ``None`` and is not exchanged: the reference exchanges its
    all-zero gradient, whose mean is zero, and ``adamw_update`` takes
    ``None`` as a zero gradient, so the update is the same."""
    spec = _grads_spec(spec)
    return tree_map(lambda g: None if g is None
                    else mx_allreduce_mean(g, groups, spec), grads)


def exchanged_bytes(n_params: int, n_devices: int,
                    spec: "QuantSpec | str" = "e4m3",
                    compressed: bool = True) -> float:
    """Analytic wire bytes per device for one gradient all-reduce (ring):
    the f32 ring all-reduce moves 2 * P * 4 * (n-1)/n bytes; compressed,
    the f32 scatter (P * 4 * (n-1)/n) plus the MX gather (P * bits per
    element / 8 * (n-1)/n)."""
    f = (n_devices - 1) / n_devices
    if not compressed:
        return 2 * n_params * 4 * f
    mx_b = as_spec(spec).format.bits_per_element() / 8.0
    return (n_params * 4 + n_params * mx_b) * f

