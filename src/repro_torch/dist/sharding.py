"""Logical sharding rules (mirrors src/repro/dist/sharding.py).

The models are written against *logical* axis names ("batch", "model",
"seq", "wgather", "kv_batch", "kv_pages"); a rule table maps each name to
zero or more physical mesh axes.  ``make_rules`` builds one,
``use_rules`` installs it for a block (a thread-local stack),
``current_rules`` reads the innermost one; ``set_mesh`` installs the
rank's mesh (a ``dist.groups.DPGroups`` over the mesh's axes, the
counterpart of the reference's ``compat.set_mesh``).  Plain Python over those stacks, as in
the reference: the port keeps its own copy.

Physical axis convention (``launch/mesh.py``):
  pod    — inter-pod data parallelism (gradient reduction only)
  data   — intra-pod DP / FSDP shard axis
  model  — tensor / expert / sequence parallelism

Where the reference hands GSPMD a global array and a constraint, the port
runs one process per mesh coordinate over *local* tensors: every rank
holds its shard of each weight (``shard_params``: ``param_specs``
validated against the mesh, as the reference's
``launch/cells.py::_validated`` does), and the use points in
``models/layers.py`` and ``models/decoder.py`` make each layout explicit
with a collective where GSPMD would insert one (a row-parallel sum over
"model", the vocab-sharded logits gathered before sampling).  The
reference's ``logical`` constraint has no counterpart: a local tensor
already has the layout its names resolve to.

Serving consumes ``batch``, ``kv_batch``, ``model``, ``kv_pages`` and
``quant``, in the decode posture (``fsdp_params=False``).  ``make_rules``
returns the reference's table key for key, but refuses the toggles
nothing consumes yet (``seq_sharded``, ``bf16_matmul_out``,
``pure_fsdp``), and ``shard_params`` refuses the FSDP posture: their
consumers, training's FSDP weight gather and sequence sharding, come
with the "model" axis in the train step (ROADMAP A11.2).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

Rules = Dict[str, Any]
Spec = Tuple[Any, ...]       # one entry per dim: None, an axis, or a tuple

DP_AXES = ("pod", "data")       # data-parallel axes, outermost first
TP_AXIS = "model"
MESH_AXES = DP_AXES + (TP_AXIS,)

# parameter containers whose leaves carry a leading layer dim in the
# reference (its lax.scan stacks); the port's layer lists carry none
STACKED_CONTAINERS = frozenset(
    {"layers", "enc_layers", "dec_layers", "blocks"})
# output projections: input dim is the TP-sharded one (Megatron row-parallel)
ROW_PARALLEL = frozenset({"wo", "w2"})

_state = threading.local()


def _stack(name: str):
    stack = getattr(_state, name, None)
    if stack is None:
        stack = []
        setattr(_state, name, stack)
    return stack


# =============================================================================
# rule tables
# =============================================================================
def make_rules(axes: Sequence[str], *, fsdp_params: bool = True,
               seq_sharded: bool = False, bf16_matmul_out: bool = False,
               pure_fsdp: bool = False,
               paged_pool_sharded: bool = False,
               quant: Any = None) -> Rules:
    """Build a logical->physical rule table for a mesh with ``axes`` (the
    reference's, key for key).

    ``fsdp_params``    — use-point weight gathering (ZeRO-3); decode
                         passes False so weights stay resident.
    ``paged_pool_sharded`` — shard the page pool's page dim over the data
                         axes; default False replicates it.
    ``quant``          — a ``repro_torch.core.spec.QuantPolicy`` whose
                         per-role specs distributed consumers resolve
                         through ``quant_spec_for``.

    The reference's ``seq_sharded`` (the sequence dim over "model"),
    ``bf16_matmul_out`` (bf16 matmul outputs, halving TP sums) and
    ``pure_fsdp`` (the whole weight gathered per layer) have no consumer
    in the port yet: setting one raises rather than being ignored."""
    unported = [k for k, on in (("seq_sharded", seq_sharded),
                                ("bf16_matmul_out", bf16_matmul_out),
                                ("pure_fsdp", pure_fsdp)) if on]
    if unported:
        raise NotImplementedError(
            f"make_rules({', '.join(k + '=True' for k in unported)}): no "
            f"layer consumes it yet; it comes with the \"model\" axis in "
            f"the train step (ROADMAP A11.2)")
    axes = tuple(axes)
    batch = tuple(a for a in DP_AXES if a in axes)
    model = tuple(a for a in axes if a == TP_AXIS)
    wgather: Optional[Tuple[str, ...]] = None
    if fsdp_params:
        wgather = ("data",) if "data" in axes else (batch or None)
    return {
        "batch": batch,
        "kv_batch": batch,
        "model": model,
        "seq": None,
        "kv_pages": batch if paged_pool_sharded else None,
        "wgather": wgather,
        "wgather_mode": "col",
        "bf16_matmul_out": False,
        "quant": quant,
    }


@contextlib.contextmanager
def use_rules(rules: Rules):
    """Install ``rules`` for the duration of the block."""
    _stack("rules").append(rules)
    try:
        yield rules
    finally:
        _stack("rules").pop()


def current_rules() -> Optional[Rules]:
    stack = _stack("rules")
    return stack[-1] if stack else None


@contextlib.contextmanager
def set_mesh(mesh):
    """Install ``mesh`` (this rank's ``DPGroups``, or None) for the
    block: the counterpart of the reference's ``compat.set_mesh``;
    ``logical``, the use points and the kernel wrappers read it."""
    _stack("mesh").append(mesh)
    try:
        yield mesh
    finally:
        _stack("mesh").pop()


def current_mesh():
    stack = _stack("mesh")
    return stack[-1] if stack else None


@contextlib.contextmanager
def use_sharding(rules: Optional[Rules], mesh):
    """``use_rules(rules)`` and ``set_mesh(mesh)`` together (neither when
    ``rules`` is None): what an engine installs around its model calls."""
    if rules is None:
        yield
        return
    with use_rules(rules), set_mesh(mesh):
        yield


# =============================================================================
# queries the layers, the kernel wrappers and the engines read
# =============================================================================
def quant_spec_for(role: str):
    """The installed rules' quantization spec for ``role``, or None (no
    rules, no policy, or no spec for the role)."""
    r = current_rules()
    pol = (r or {}).get("quant")
    return pol.role(role) if pol is not None else None


def _axes_size(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= mesh.size(a)
    return n


def rule_axes(name: str) -> Tuple[str, ...]:
    """The mesh axes the installed rules map ``name`` to, those of the
    installed mesh only (() without rules or mesh)."""
    rules, mesh = current_rules(), current_mesh()
    if rules is None or mesh is None:
        return ()
    return tuple(a for a in (rules.get(name) or ()) if a in mesh.axes)


def rule_size(name: str) -> int:
    """Ranks behind the logical ``name`` (1 without rules or mesh)."""
    axes = rule_axes(name)
    return _axes_size(current_mesh(), axes) if axes else 1


def rule_index(name: str) -> int:
    """This rank's coordinate along the axes of ``name`` (row-major over
    them; 0 without rules or mesh)."""
    axes = rule_axes(name)
    mesh = current_mesh()
    i = 0
    for a in axes:
        i = i * mesh.size(a) + mesh.coord(a)
    return i


def model_axis_size() -> int:
    """Mesh extent behind the logical "model" name under the installed
    rules (1 when no rules / mesh are active).  A dim this size does not
    divide stays replicated."""
    return rule_size("model")


def model_index() -> int:
    """This rank's coordinate along "model" (0 without a mesh)."""
    return rule_index("model")


def model_parts(n: int) -> int:
    """The model-axis size when it divides ``n`` (a dim the placement
    shards over "model"), else 1 (the dim stays replicated)."""
    ms = model_axis_size()
    return ms if ms > 1 and n % ms == 0 else 1


UNDIVIDED_HEADS_REFUSED = (
    "{} q heads do not split over a 'model' axis of {}: attention whole "
    "on every rank (q gathered, wo's rows taken from the whole output) "
    "waits on ROADMAP A11.2; pick a mesh whose 'model' size divides the "
    "q heads")


@dataclasses.dataclass(frozen=True)
class HeadShard:
    """How a rank attends under the installed mesh: the q heads it
    attends, the KV heads its cache holds, and the collectives around
    them.

    ``head0``     its first global q head where its cache holds every KV
                  head but q only some (the "model" axis divides the q
                  heads, not the KV heads: the reference's
                  ``flash_attention_ctx`` keeps k/v replicated there);
                  None where q covers the cache's heads
    ``gather_kv`` wk/wv's columns are sharded, but not by whole KV heads:
                  k/v are gathered over "model"
    """
    n_heads: int
    n_kv: int
    head0: Optional[int] = None
    gather_kv: bool = False


def head_shard(n_heads: int, n_kv: int, hd: int) -> HeadShard:
    """The installed mesh's ``HeadShard`` of a GQA attention of
    ``n_heads`` q and ``n_kv`` KV heads of ``hd``: q heads split over
    "model", KV heads too where it divides them, else each rank keeps
    every KV head.  A "model" size that does not divide the q heads is
    refused (``UNDIVIDED_HEADS_REFUSED``)."""
    ms = model_axis_size()
    if ms == 1:
        return HeadShard(n_heads, n_kv)
    if n_heads % ms:
        raise NotImplementedError(UNDIVIDED_HEADS_REFUSED.format(n_heads, ms))
    nh = n_heads // ms
    if n_kv % ms == 0:
        return HeadShard(nh, n_kv // ms)
    return HeadShard(nh, n_kv, head0=model_index() * nh,
                     gather_kv=model_parts(n_kv * hd) > 1)


def model_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of ``x`` over the "model" ranks of the installed mesh (x
    itself without one); callers pass f32 partials."""
    axes = rule_axes("model")
    return current_mesh().sum_over(x, axes) if axes else x


def model_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The "model" ranks' ``x`` concatenated on ``dim`` in coordinate
    order (x itself without a mesh)."""
    axes = rule_axes("model")
    return current_mesh().gather_over(x, axes, dim) if axes else x


# =============================================================================
# parameter specs
# =============================================================================
def _spec_for(keys: Tuple[str, ...], ndim: int) -> Spec:
    """The reference's ``_spec_for``: one tuple entry per dim."""
    stacked = any(k in STACKED_CONTAINERS for k in keys)
    lead: Spec = (None,) if stacked else ()
    nd = ndim - len(lead)
    name = keys[-1] if keys else ""
    if nd <= 1:
        return lead + (None,) * nd              # norms / biases: replicated
    if "experts" in keys:
        # MoE expert tables (E, d_in, d_ff[, ...]): expert-parallel over
        # "model", FSDP over "data" on the next dim, rest replicated
        return lead + (TP_AXIS, "data") + (None,) * (nd - 2)
    if name == "embed" and nd == 2:
        # vocab-sharded over "model" (the tied head is col-parallel)
        return lead + (TP_AXIS, "data")
    if name in ROW_PARALLEL:
        return lead + (None,) * (nd - 2) + (TP_AXIS, "data")
    return lead + (None,) * (nd - 2) + ("data", TP_AXIS)    # col (default)


def param_specs(params) -> Any:
    """A spec tree mirroring ``params`` (a tree of tensors, or of shapes
    given as tuples): one tuple of axis names (or None) per leaf,
    standing in for the reference's ``PartitionSpec``.  A stacked
    container that is a dict (the reference's layout) gives its leaves a
    leading None for the layer dim, as the reference's does; the port's
    per-layer *list* under such a name carries no layer dim, so its
    leaves get the reference's spec without that entry.  An ``MXWeight``
    leaf gets the spec of its (..., K, N) weight.  Divisibility against
    a concrete mesh is ``validated``'s job."""
    from repro_torch.core.mx_weight import MXWeight

    def walk(tree, keys):
        if isinstance(tree, dict):
            return {k: walk(v, keys + (str(k),)) for k, v in tree.items()}
        if isinstance(tree, list):
            # one entry per layer: the container's name no longer marks a
            # leading layer dim
            base = keys[:-1] + ("#" + keys[-1],) if keys else keys
            return [walk(v, base + (str(i),)) for i, v in enumerate(tree)]
        if isinstance(tree, MXWeight):
            return _spec_for(keys, tree.scales.dim())
        shape = tree if isinstance(tree, tuple) else tree.shape
        return _spec_for(keys, len(shape))

    return walk(params, ())


def _entry_size(sizes: Dict[str, int], entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, tuple):
        n = 1
        for e in entry:
            n *= sizes.get(e, 1)
        return n
    return sizes.get(entry, 1)


def validated(spec: Spec, shape: Sequence[int], sizes) -> Spec:
    """The reference's ``launch/cells.py::_validated``: drop spec axes
    that do not divide the corresponding dim.  ``sizes`` maps axis name
    -> size (a mesh's ``shape``); missing axes count as 1."""
    sizes = dict(sizes)
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(e if e is not None and dim % _entry_size(sizes, e) == 0
                 else None for dim, e in zip(shape, entries[:len(shape)]))


# =============================================================================
# shard placement (decode posture: weights resident, split over "model")
# =============================================================================
@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's placement: this rank's mesh and the leaf's spec (the
    reference's ``jax.sharding.NamedSharding``; a tree leaf, not a
    container)."""
    mesh: Any
    spec: Spec


def _check_mx_row_gather(k: int, block: int, ms: int) -> None:
    """The reference's ``models/layers.py::_check_mx_row_gather``: a
    row-parallel MX weight shards its codes' K axis and its scales'
    K//block axis alike; a K that divides the model axis while K//block
    does not would leave codes sharded and scales replicated, so it is
    refused with the reference's message."""
    kblk = k // block
    if ms > 1 and k % ms == 0 and kblk % ms != 0:
        raise ValueError(
            f"row-parallel FSDP gather cannot shard this MX weight: the "
            f"codes' contraction axis (K={k}) divides the 'model' axis "
            f"size {ms}, but the scales' axis (K//block={kblk}, block="
            f"{block}) does not — pad K to a multiple of {ms * block} or "
            f"store this weight unquantized")


def _slice(t: torch.Tensor, dim: int, parts: int, index: int):
    n = t.shape[dim] // parts
    return t.narrow(dim, index * n, n).contiguous()


def _local_spec(spec: Spec, sizes: Dict[str, int], dp: bool) -> Spec:
    """The entries a rank's shard follows: "model" always, the data axes
    only when ``dp`` (FSDP; the decode posture replicates over them)."""
    def keep(e):
        if e is None:
            return None
        axes = e if isinstance(e, tuple) else (e,)
        axes = tuple(a for a in axes if sizes.get(a, 1) > 1
                     and (a == TP_AXIS or dp))
        return (axes if len(axes) > 1 else axes[0]) if axes else None
    return tuple(keep(e) for e in spec)


def shard_leaf(x, spec: Spec, mesh, dp: bool = False):
    """This rank's shard of one leaf (a tensor or an ``MXWeight``) placed
    by ``spec`` (``param_specs``'s entry for it) on ``mesh``: each dim
    whose (validated) entry names mesh axes keeps this rank's contiguous
    chunk, in coordinate order.  An ``MXWeight`` is quantized whole and
    sliced: its codes and scales follow the spec of the (..., K, N)
    weight, K through the code rows and the scale rows alike (block
    aligned), N as columns, so the shard equals quantizing the weight's
    slice bit for bit.  A row-parallel MX weight whose K the model axis
    divides while K//block is not divided raises (the reference's
    ``_check_mx_row_gather``)."""
    from repro_torch.core.mx_weight import MXWeight
    sizes = dict(mesh.shape)
    if isinstance(x, MXWeight):
        nd = x.scales.dim()
        kp = x.kp
        shape = tuple(x.scales.shape[:-2]) + (kp, x.n)
        spec = validated(spec, shape, sizes)
        spec = _local_spec(spec, sizes, dp)
        if spec[-2] is not None:
            _check_mx_row_gather(kp, x.block, _entry_size(sizes, spec[-2]))
        codes, scales, k, n = x.codes, x.scales, x.k, x.n
        for dim, e in enumerate(spec):
            if e is None:
                continue
            parts = _entry_size(sizes, e)
            idx = mesh.index(e)
            if dim == nd - 2 and x.k != kp:
                raise NotImplementedError(
                    f"a row-parallel MX weight of K={x.k} padded to {kp}: "
                    f"the port shards K only where it is a block multiple")
            codes = _slice(codes, dim, parts, idx)
            scales = _slice(scales, dim, parts, idx)
            if dim == nd - 2:
                k //= parts
            if dim == nd - 1:
                n //= parts
        return dataclasses.replace(x, codes=codes, scales=scales, k=k, n=n)
    spec = _local_spec(validated(spec, tuple(x.shape), sizes), sizes, dp)
    for dim, e in enumerate(spec):
        if e is not None:
            x = _slice(x, dim, _entry_size(sizes, e), mesh.index(e))
    return x


# leaves every rank keeps whole although ``param_specs`` shards them: the
# MoE router, so that routing (ROADMAP C8) is the same computation on
# every rank (a column-sharded router's gathered logits need not equal
# the whole product bit for bit)
REPLICATED = frozenset({"router"})


def shard_params(params, mesh, rules: Optional[Rules] = None):
    """This rank's shard of a whole param tree in the decode posture:
    ``param_specs`` validated against ``mesh`` (``validated``), split over
    "model" and replicated over the data axes; ``REPLICATED`` leaves
    whole.  Rules of the FSDP posture (``fsdp_params=True``, whose
    weights would also split over "data") are refused: no layer gathers
    them yet (ROADMAP A11.2)."""
    if rules and rules.get("wgather"):
        raise NotImplementedError(
            "shard_params places the decode posture (make_rules(..., "
            "fsdp_params=False)); the FSDP weight gather comes with the "
            "\"model\" axis in the train step (ROADMAP A11.2)")
    specs = param_specs(params)

    def walk(tree, spec):
        if isinstance(tree, dict):
            return {k: tree[k] if k in REPLICATED else walk(v, spec[k])
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, s) for v, s in zip(tree, spec)]
        return shard_leaf(tree, spec, mesh)

    return walk(params, specs)
