"""Cells: (arch x shape x variant x mesh) -> a step function, stand-ins
for its arguments and their shardings (mirrors
src/repro/launch/cells.py).

Variants:
  baseline  — bf16 weights / KV, no MX anywhere (the fp reference).
  paper     — the paper-faithful technique in the loop: MX weight
              fake-quant in training; MX (paper mode) INT8 KV cache.
  optimized — OCP-mode formats, flash attention and bf16 row-parallel
              sums (``bf16_matmul_out``).

``build_cell`` picks the reference's ``make_rules`` keywords per kind,
variant and family (the cell's ``rule_kw``), validates ``param_specs``
and the batch and cache specs against the mesh (``shardings_for_*``:
one ``dist.sharding.NamedSharding`` per leaf), and builds the step.
Where the reference hands GSPMD global arrays, the port runs one process
per mesh coordinate: ``mesh`` is this rank's ``dist.groups.DPGroups``
(``init_dp``, or ``world_one``), and the cell's ``fn`` runs on the
rank's local tensors under ``use_rules`` and ``set_mesh``:

* train:   ``fn(params, opt_state, batch, step)`` with the rank's shards
           of params and AdamW state (``dist.sharding.shard_params`` in
           the FSDP posture, ``shard_opt_state``) and the *global* batch,
           of which the rank takes its rows over ("pod", "data")
           (``train.step.build_train_step``'s sharded step); returns the
           updated shards and the global metrics, the same on every rank;
* prefill: ``fn(params, batch)`` with the global batch (no labels);
           returns the logits and contiguous cache of the rank's rows
           (its KV heads under "model");
* decode:  ``fn(params, token, cache, pos)``: the rank's rows of the
           global ``token``, the rank's cache (kv_batch rows, its KV
           heads), weights resident (the decode posture); returns (logits
           of its rows, cache).

A cell's ``args`` are stand-ins on the meta device (shapes and dtypes,
no storage: the reference's ``ShapeDtypeStruct``s), of the *global*
arrays.  A mesh description (``launch.mesh.MeshShape``) builds the
specs of a cell; running its ``fn`` needs a ``DPGroups``.

The FSDP posture covers the dense GQA decoders; the MoE layer and the
other families (MLA, the patch frontend, the hybrid, RWKV6, the
encoder-decoder) raise ``NotImplementedError`` when their train or
prefill cell runs, as ``make_rules`` does for ``seq_sharded``
(``long_500k``) and ``pure_fsdp`` (RWKV training under "optimized"):
ROADMAP A11.2.  The reference's ``lower_cell``, ``dryrun.py`` and
``hlo_stats.py`` lower through XLA and have no counterpart here
(ROADMAP A11.3).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.spec import QuantPolicy, QuantSpec
from repro_torch.dist.sharding import (A11_2, NamedSharding, current_mesh,
                                       gather_leaf, make_rules, param_specs,
                                       placed_spec, refuse_fsdp, rule_axes,
                                       shard_leaf, use_sharding, validated)
from repro_torch.models import (Model, batch_specs, decode_specs,
                                load_config, load_reduced)
from repro_torch.models.config import SHAPES, ModelConfig, ShapeSpec
from repro_torch.models.layers import leaf_base
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train.step import build_train_step

KV_CACHE_LEAVES_ATTN = {"k", "v", "k_codes", "k_scales", "v_codes",
                        "v_scales"}
KV_CACHE_LEAVES_MLA = {"ckv", "kr", "ckv_codes", "ckv_scales", "kr_codes",
                       "kr_scales"}
STATE_LEAVES_B4 = {"ssm", "tmix_state"}
STATE_LEAVES_B3 = {"conv", "tmix_prev", "cmix_prev"}


def variant_config(arch: str, variant: str,
                   reduced: bool = False) -> ModelConfig:
    """The reference's ``variant_config``; ``reduced`` starts from the
    reduced config (``load_reduced``: small widths, f32) instead."""
    cfg = load_reduced(arch) if reduced else load_config(arch)
    if variant == "baseline":
        return cfg
    if variant == "paper":
        mx = QuantPolicy(weights=QuantSpec("e4m3", "paper"),
                         kv_key=QuantSpec("int8", "paper"),
                         kv_value=QuantSpec("int8", "paper"),
                         grads=QuantSpec("e4m3", "paper"))
        return dataclasses.replace(cfg, mx=mx)
    if variant == "optimized":
        mx = QuantPolicy.parse(
            "weights=e4m3@32:ocp,kv=int8@32:ocp,grads=e4m3@32:ocp")
        return dataclasses.replace(cfg, mx=mx, attn_impl="flash")
    raise ValueError(f"unknown variant {variant!r}")


# =============================================================================
# sharding helpers
# =============================================================================
def _sizes(mesh) -> Dict[str, int]:
    return dict(mesh.shape)


def _batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def shardings_for_params(params_like, mesh) -> Any:
    """One ``NamedSharding`` per leaf of ``params_like`` (tensors or
    stand-ins): its ``param_specs`` entry validated against ``mesh``
    (the reference's ``_validated``)."""
    sizes = _sizes(mesh)

    def walk(tree, spec):
        if isinstance(tree, dict):
            return {k: walk(v, spec[k]) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, s) for v, s in zip(tree, spec)]
        return NamedSharding(mesh, validated(spec, tuple(tree.shape),
                                             sizes))

    return walk(params_like, param_specs(params_like))


def shardings_for_batch(batch_like, mesh) -> Dict[str, NamedSharding]:
    """Each batch leaf split on dim 0 over ("pod", "data") where they
    divide it."""
    ba, sizes = _batch_axes(mesh), _sizes(mesh)
    return {k: NamedSharding(mesh, validated((ba,), tuple(v.shape), sizes))
            for k, v in batch_like.items()}


def shardings_for_cache(cache_like, mesh) -> Any:
    """The reference's cache placement by leaf name: a KV leaf's batch
    dim over ("pod", "data"), a recurrent state's batch dim likewise
    (the reference's ``seq_sharded`` sequence split is refused by
    ``make_rules``).  The port's grouped names (``k_codes.1``) read as
    their base name."""
    ba, sizes = _batch_axes(mesh), _sizes(mesh)

    def one(name, shape):
        name = leaf_base(name)
        nd = len(shape)
        ent: list = [None] * nd
        if name in KV_CACHE_LEAVES_ATTN and nd >= 4:
            ent[nd - 4] = ba
        elif name in KV_CACHE_LEAVES_MLA and nd >= 3:
            ent[nd - 3] = ba
        elif name in STATE_LEAVES_B4 and nd >= 4:
            ent[nd - 4] = ba
        elif name in STATE_LEAVES_B3 and nd >= 3:
            ent[nd - 3] = ba
        return NamedSharding(mesh, validated(tuple(ent), shape, sizes))

    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(v, str(k)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, name) for v in tree)
        return one(name, tuple(tree.shape))

    return walk(cache_like, "")


def _by_leaf(fn, tree, shardings):
    if isinstance(tree, dict):
        return {k: _by_leaf(fn, v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_by_leaf(fn, v, s) for v, s in zip(tree, shardings)]
    return fn(tree, shardings)


def shard_opt_state(opt_state, pshard) -> Dict[str, Any]:
    """This rank's shard of a whole AdamW state (``master``, ``m``,
    ``v``), each placed as its param (``pshard``, the cell's) in the
    FSDP posture."""
    return {k: _by_leaf(lambda x, sh: shard_leaf(x, sh.spec, sh.mesh,
                                                 dp=True), v, pshard)
            for k, v in opt_state.items()}


def unshard(tree, shardings, dp: bool = True):
    """The whole tree from every rank's shards placed by ``shardings``
    (in the FSDP posture with ``dp``): each leaf gathered over the axes
    it is split on, in leaf order (a collective every rank calls; the
    sharded state saved whole, as ``ckpt.restore`` reads it back onto
    any mesh)."""
    return _by_leaf(lambda x, sh: gather_leaf(
        x, placed_spec(sh.spec, sh.mesh, dp), sh.mesh), tree, shardings)


# =============================================================================
# cell construction
# =============================================================================
@dataclasses.dataclass
class Cell:
    arch: str
    shape: ShapeSpec
    variant: str
    cfg: ModelConfig
    fn: Any                  # python callable on the rank's tensors
    args: Tuple[Any, ...]    # meta-device stand-ins of the global arrays
    in_shardings: Tuple[Any, ...]
    kind: str
    mesh: Any = None
    rule_kw: Optional[Dict[str, bool]] = None   # make_rules' keywords
    rules: Optional[Dict[str, Any]] = None
    model: Any = None


def _rows(mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global batch leaf (its "batch" axes)."""
    return x[mesh.batch_rows(x.shape[0], rule_axes("batch"))]


def _running(mesh):
    from repro_torch.dist.groups import DPGroups
    if not isinstance(mesh, DPGroups):
        raise TypeError("a cell runs on this rank's mesh: build it on a "
                        "dist.groups.DPGroups (init_dp, or world_one)")
    return mesh


def build_cell(arch: str, shape, mesh, variant: str = "baseline",
               n_layers_override: Optional[int] = None, *,
               device="cuda", reduced: bool = False,
               overrides: Optional[Dict[str, Any]] = None,
               opt_cfg: Optional[AdamWConfig] = None) -> Cell:
    """The reference's ``build_cell``.  ``shape`` is a name of ``SHAPES``
    or a ``ShapeSpec`` (a cut one); ``n_layers_override`` cuts the depth
    (an encoder-decoder's halves each), ``reduced`` starts from the
    reduced config, ``overrides`` replaces config fields (``dtype``...),
    ``opt_cfg`` replaces the train cell's ``AdamWConfig()``; the model
    runs on ``device``."""
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    cfg = variant_config(arch, variant, reduced)
    over = dict(overrides or {})
    if n_layers_override is not None:
        over["n_layers"] = n_layers_override
        if cfg.family == "encdec":
            over["n_enc_layers"] = n_layers_override // 2
            over["n_dec_layers"] = n_layers_override // 2
    if over:
        cfg = dataclasses.replace(cfg, **over)
    model = Model(cfg, device=device)
    # decode: weights stay resident (no per-token gather); train and
    # prefill gather weights per layer (FSDP); the optimized variant adds
    # bf16 row-parallel sums and, for RWKV training, pure FSDP
    rkw = dict(seq_sharded=(shape.name == "long_500k"),
               fsdp_params=(shape.kind != "decode"))
    if variant == "optimized":
        rkw["bf16_matmul_out"] = True
        if cfg.family == "rwkv" and shape.kind == "train":
            rkw["pure_fsdp"] = True
    rules = make_rules(tuple(mesh.axis_names), quant=cfg.mx, **rkw)
    params_like = Model(cfg, device="meta").init()
    pshard = shardings_for_params(params_like, mesh)

    def installed():
        return use_sharding(rules, _running(mesh))

    if shape.kind == "train":
        opt_like = adamw_init(params_like)
        oshard = {k: pshard for k in opt_like}
        b_like = batch_specs(cfg, shape)
        bshard = shardings_for_batch(b_like, mesh)
        step_like = torch.empty((), dtype=torch.int32, device="meta")
        built = []

        def wrapped(params, opt_state, batch, step):
            refuse_fsdp(cfg)
            if not built:       # on the first call: the step checks the
                #                 card's settings, a spec-only cell needs none
                built.append(build_train_step(
                    model, opt_cfg or AdamWConfig(), microbatches=1,
                    fake_quant=(cfg.mx.weights is not None
                                or cfg.mx.activations is not None),
                    shardings=pshard))
            with installed():
                return built[0](params, opt_state, batch, step)

        return Cell(arch, shape, variant, cfg, wrapped,
                    (params_like, opt_like, b_like, step_like),
                    (pshard, oshard, bshard, None), "train", mesh, rkw,
                    rules, model)

    if shape.kind == "prefill":
        b_like = batch_specs(cfg, shape)
        b_like.pop("labels", None)
        bshard = shardings_for_batch(b_like, mesh)
        max_len = shape.seq_len // 2 if cfg.family == "encdec" \
            else shape.seq_len

        def pre_fn(params, batch):
            refuse_fsdp(cfg)
            with installed(), torch.no_grad():
                local = {k: _rows(current_mesh(), torch.as_tensor(v))
                         for k, v in batch.items()}
                logits, cache, _ = model.prefill(params, local,
                                                 max_len=max_len)
                return logits, cache

        return Cell(arch, shape, variant, cfg, pre_fn,
                    (params_like, b_like), (pshard, bshard), "prefill",
                    mesh, rkw, rules, model)

    d_like = decode_specs(cfg, shape)
    cshard = shardings_for_cache(d_like["cache"], mesh)
    tshard = shardings_for_batch({"token": d_like["token"]}, mesh)["token"]

    def dec_fn(params, token, cache, pos):
        if cfg.family != "decoder" or cfg.mla or cfg.frontend != "none":
            raise NotImplementedError(
                f"{cfg.name}: a sharded decode cell covers the GQA "
                f"decoders ({A11_2})")
        with installed(), torch.no_grad():
            return model.decode_step(params, _rows(current_mesh(), token),
                                     cache, pos)

    return Cell(arch, shape, variant, cfg, dec_fn,
                (params_like, d_like["token"], d_like["cache"],
                 d_like["pos"]),
                (pshard, tshard, cshard, None), "decode", mesh, rkw, rules,
                model)
