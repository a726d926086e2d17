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
``quant``, in the decode posture (``fsdp_params=False``: weights
resident, split over "model" only).  Training and prefill consume
``wgather`` too, in the FSDP posture (``fsdp_params=True``, the
reference's ZeRO-3): ``shard_params`` also splits each weight over
"data" as ``param_specs`` says, and each use point gathers it over the
``wgather`` axes (``fsdp_gather``: all-gather forward, reduce-scatter
backward), leaving its "model" dim split; ``bf16_matmul_out`` makes a
row-parallel projection sum its partials in the activation dtype.
The collectives that carry gradients (``model_sum``, ``model_copy``,
``model_gather``, ``fsdp_gather``) are ``torch.autograd.Function``s over
``dist.groups.DPGroups``' methods.  ``make_rules`` returns the
reference's table key for key, but refuses ``seq_sharded`` (the sequence
dim over "model") and ``pure_fsdp`` (no dim left TP-sharded): no layer
consumes them (``A11_2``: ROADMAP A11.2, which also holds the FSDP
posture of the MoE layer and of the other families, ``refuse_fsdp``).
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

# the ROADMAP item of what the port's sharding still refuses
A11_2 = "ROADMAP A11.2: sharded training of MoE and the other families"

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
    ``bf16_matmul_out``— a row-parallel projection's partial products
                         come out, and are summed over "model", in the
                         activation dtype (halving the sum's bytes).

    The reference's ``seq_sharded`` (the sequence dim over "model") and
    ``pure_fsdp`` (the whole weight gathered per layer) have no consumer
    in the port: setting one raises rather than being ignored."""
    unported = [k for k, on in (("seq_sharded", seq_sharded),
                                ("pure_fsdp", pure_fsdp)) if on]
    if unported:
        raise NotImplementedError(
            f"make_rules({', '.join(k + '=True' for k in unported)}): no "
            f"layer consumes it yet ({A11_2})")
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
        "bf16_matmul_out": bool(bf16_matmul_out),
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
    itself without one): a row-parallel projection's partials, whose
    gradient reaches each rank's partial unchanged (``RowSum``)."""
    from repro_torch.dist.groups import RowSum
    axes = _live("model")
    return RowSum.apply(x, current_mesh(), axes) if axes else x


def model_copy(x: torch.Tensor) -> torch.Tensor:
    """x entering column-parallel projections: the identity forward, its
    gradient summed over "model" backward (``ModelCopy``; x itself
    without a mesh)."""
    from repro_torch.dist.groups import ModelCopy
    axes = _live("model")
    return ModelCopy.apply(x, current_mesh(), axes) if axes else x


def model_gather(x: torch.Tensor, dim: int,
                 partial: bool = False) -> torch.Tensor:
    """The "model" ranks' ``x`` concatenated on ``dim`` in coordinate
    order (x itself without a mesh).  Backward: the rank's own chunk of
    the gradient, or with ``partial`` (each rank uses the whole in its
    own way, as its q heads read gathered k/v) its sum over the ranks
    (``Gather``)."""
    from repro_torch.dist.groups import Gather
    axes = _live("model")
    if not axes:
        return x
    return Gather.apply(x, current_mesh(), axes, dim, partial,
                        ("tp.gather", "tp.reduce_scatter"))


def weight_gather_enabled() -> bool:
    """The installed rules gather weights at their use points (the FSDP
    posture: ``make_rules(fsdp_params=True)``)."""
    r = current_rules()
    return bool(r and r.get("wgather"))


def weight_gather_mode() -> str:
    r = current_rules()
    return (r or {}).get("wgather_mode", "col")


def bf16_matmul_out_enabled() -> bool:
    """Row-parallel partial products in the activation dtype."""
    r = current_rules()
    return bool(r and r.get("bf16_matmul_out"))


def wgather_parts(n: int) -> int:
    """Ranks a weight dim of global length ``n`` that ``param_specs``
    puts on "data" is split over in the FSDP posture: the ``wgather``
    axes' size where it divides ``n`` (``validated``), else 1."""
    if not weight_gather_enabled():
        return 1
    k = rule_size("wgather")
    return k if k > 1 and n % k == 0 else 1


def fsdp_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The whole of a weight's FSDP-split ``dim`` (its "data" entry):
    all-gathered over the ``wgather`` axes forward, the gradient summed
    over them and split again backward (reduce-scatter; each data rank
    computed it from its own rows), in "fsdp.*" spans.  x itself where
    no axis splits it."""
    from repro_torch.dist.groups import Gather
    axes = _live("wgather")
    if not axes:
        return x
    return Gather.apply(x, current_mesh(), axes, dim, True,
                        ("fsdp.gather", "fsdp.reduce_scatter"))


def _live(name: str) -> Tuple[str, ...]:
    """The axes of ``name`` of size > 1 on the installed mesh."""
    mesh = current_mesh()
    return tuple(a for a in rule_axes(name) if mesh.size(a) > 1)


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
# shard placement (decode posture: split over "model"; FSDP posture: over
# "data" too)
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


def _check_qat_row_shard(k: int, kl: int, blocks, ms: int) -> None:
    """QAT on a row-parallel matmul fake-quantizes the rank's K shard (of
    an fp weight under the ``weights`` role, of x under ``activations``)
    by itself: its MX blocks are the whole K's only where the shard's
    length is a multiple of the block, so any other split is refused
    (quantizing before the K split waits on ROADMAP A11.2)."""
    for block in blocks:
        if kl % block:
            raise ValueError(
                f"row-parallel QAT cannot fake-quantize this K shard: K={k} "
                f"over the 'model' axis size {ms} leaves {kl} rows a rank, "
                f"not a multiple of the block {block}, so the shard's MX "
                f"blocks would not be the whole weight's — pick a 'model' "
                f"size that leaves K/model a multiple of {block} "
                f"({A11_2})")


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


def placed_spec(spec: Spec, mesh, dp: bool = True) -> Spec:
    """The spec a rank's shard of a leaf follows, placed by the validated
    ``spec`` on ``mesh``: only the axes of size > 1 that the posture
    splits ("model", and with ``dp`` the data axes: the FSDP posture)."""
    return _local_spec(spec, dict(mesh.shape), dp)


def placed_axes(spec: Spec, mesh, dp: bool = True) -> Tuple[str, ...]:
    """The axes of size > 1 a leaf placed by the validated ``spec`` is
    split over on ``mesh`` (``placed_spec``)."""
    out: Tuple[str, ...] = ()
    for e in placed_spec(spec, mesh, dp):
        if e is not None:
            out += e if isinstance(e, tuple) else (e,)
    return out


def _mx_shape(x) -> Tuple[int, ...]:
    """The global (..., K padded, N) shape an MX weight's spec covers."""
    from repro_torch.core.mx_weight import MXWeight
    if isinstance(x, MXWeight):
        return tuple(x.scales.shape[:-2]) + (x.kp, x.n)
    return tuple(x.codes.shape)


def shard_leaf(x, spec: Spec, mesh, dp: bool = False):
    """This rank's shard of one leaf (a tensor, an ``MXWeight`` or an
    ``MXArray`` quantized along its rows) placed by ``spec``
    (``param_specs``'s entry for it) on ``mesh``: each dim whose
    validated entry names mesh axes keeps this rank's contiguous chunk,
    in coordinate order ("model" only, and with ``dp`` the data axes
    too: the FSDP posture).  An MX weight is quantized whole and sliced:
    its codes and scales follow the spec of the (..., K, N) weight, K
    through the code rows and the scale rows alike (block aligned), N
    as columns, so the shard equals quantizing the weight's slice bit
    for bit.  A K split whose K//block rows do not split alike raises
    (on "model" the reference's ``_check_mx_row_gather``)."""
    from repro_torch.core.convert import MXArray
    from repro_torch.core.mx_weight import MXWeight
    sizes = dict(mesh.shape)
    if isinstance(x, (MXWeight, MXArray)):
        if isinstance(x, MXArray) and x.axis != x.codes.dim() - 2:
            raise NotImplementedError(
                "shard_leaf places an MXArray quantized along its rows "
                "(..., K, N)")
        shape = _mx_shape(x)
        nd = len(shape)
        spec = _local_spec(validated(spec, shape, sizes), sizes, dp)
        block = x.block
        codes, scales = x.codes, x.scales
        for dim, e in enumerate(spec):
            if e is None:
                continue
            parts = _entry_size(sizes, e)
            idx = mesh.index(e)
            if dim == nd - 2:
                _check_mx_k_split(shape[-2], block, parts, e)
                if isinstance(x, MXWeight) and x.k != x.kp:
                    raise NotImplementedError(
                        f"an MX weight of K={x.k} padded to {x.kp}: the "
                        f"port shards K only where it is a block multiple")
            codes = _slice(codes, dim, parts, idx)
            scales = _slice(scales, dim, parts, idx)
        if isinstance(x, MXArray):
            return dataclasses.replace(x, codes=codes, scales=scales,
                                       orig_len=codes.shape[-2])
        return dataclasses.replace(
            x, codes=codes, scales=scales, n=scales.shape[-1],
            k=x.k if spec[-2] is None else scales.shape[-2] * block)
    spec = _local_spec(validated(spec, tuple(x.shape), sizes), sizes, dp)
    for dim, e in enumerate(spec):
        if e is not None:
            x = _slice(x, dim, _entry_size(sizes, e), mesh.index(e))
    return x


def _check_mx_k_split(k: int, block: int, parts: int, entry) -> None:
    """An MX weight's K (codes) split over ``parts`` ranks of ``entry``
    needs its K//block scale rows split alike."""
    if entry == TP_AXIS:
        _check_mx_row_gather(k, block, parts)
    elif (k // block) % parts:
        raise ValueError(
            f"FSDP placement cannot split this MX weight's K={k} over "
            f"{entry!r} of size {parts}: its scales' axis (K//block="
            f"{k // block}, block={block}) does not split alike — pad K "
            f"to a multiple of {parts * block} or store it unquantized")


def gather_leaf(x, spec: Spec, mesh):
    """The whole leaf from every rank's shard ``x`` placed by ``spec``
    (a local spec, ``placed_spec``): gathered over each split dim's axes
    (the inverse of ``shard_leaf``; a collective every rank calls)."""
    for dim, e in enumerate(spec):
        if e is not None:
            x = mesh.gather_over(x.contiguous(), e, dim)
    return x


# leaves every rank keeps whole although ``param_specs`` shards them: the
# MoE router, so that routing (ROADMAP C8) is the same computation on
# every rank (a column-sharded router's gathered logits need not equal
# the whole product bit for bit)
REPLICATED = frozenset({"router"})

# what the FSDP posture places and its use points gather: the GQA
# decoder family's dense layers
FSDP_REFUSED = ("{}: the FSDP posture (training and prefill sharded over "
                "a mesh) covers the dense GQA decoders; {} waits on " + A11_2)


def refuse_fsdp(cfg) -> None:
    """Raise where ``cfg`` is not a dense GQA decoder (the MoE layer,
    whose expert stacks are ("model", "data"), MLA, the patch frontend,
    the hybrid, RWKV6, the encoder-decoder)."""
    what = None
    if cfg.family != "decoder":
        what = f"the {cfg.family} family"
    elif cfg.n_experts:
        what = "the MoE layer"
    elif cfg.mla:
        what = "MLA"
    elif cfg.frontend != "none":
        what = f"the {cfg.frontend} frontend"
    if what is not None:
        raise NotImplementedError(FSDP_REFUSED.format(cfg.name, what))


def shard_params(params, mesh, rules: Optional[Rules] = None):
    """This rank's shard of a whole param tree: ``param_specs`` validated
    against ``mesh`` (``validated``), split over "model" and, in the
    FSDP posture (rules with ``wgather``: ``make_rules(fsdp_params=
    True)``), over "data" as well, each rank then holding its (data,
    model) chunk; in the decode posture replicated over the data axes.
    ``REPLICATED`` leaves stay whole.  The FSDP posture of an MoE
    layer's expert stacks raises (``FSDP_REFUSED``)."""
    dp = bool(rules and rules.get("wgather"))
    specs = param_specs(params)

    def walk(tree, spec):
        if isinstance(tree, dict):
            if dp and "experts" in tree:
                raise NotImplementedError(FSDP_REFUSED.format(
                    "an MoE layer", "the MoE layer"))
            return {k: tree[k] if k in REPLICATED else walk(v, spec[k])
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, s) for v, s in zip(tree, spec)]
        return shard_leaf(tree, spec, mesh, dp)

    return walk(params, specs)
