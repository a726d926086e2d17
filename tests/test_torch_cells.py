"""The port's cells (``repro_torch.launch.cells``) against the reference's
(``repro.launch.cells``) on a mesh of one, ``jax.make_mesh((1, 1),
("data", "model"))``, and the port's ``MeshShape`` of the same shape:
``variant_config`` field for field, ``batch_specs`` / ``decode_specs``
shapes and dtypes against the reference's ``jax.eval_shape`` stand-ins,
and ``build_cell``'s kind, argument shapes and dtypes, in-sharding specs
and ``make_rules`` keywords, for every arch at its applicable shapes
under "baseline" and chatglm3-6b under all three variants.  The
reference's stacked layers (and a MoE config's ``dense_layers``) are
laid out as the port's per-layer lists before comparing: a stacked
leaf's spec is the port's with the layer entry in front.  Where the
port refuses (``seq_sharded`` at long_500k, ``pure_fsdp`` for RWKV
training under "optimized"), the refusal names ROADMAP A11.2.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.launch import cells as RC
from repro.models import batch_specs as j_batch_specs
from repro.models import decode_specs as j_decode_specs
from repro.models import load_config as j_load_config
from repro.models.config import applicable_shapes as j_applicable
from repro_torch.dist.sharding import A11_2
from repro_torch.launch import cells as TC
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import ARCH_IDS, batch_specs, decode_specs, load_config
from repro_torch.models.config import SHAPES, applicable_shapes
from repro_torch.tree import leaves_with_path

import torch

torch.set_num_threads(1)
VARIANTS = ("baseline", "paper", "optimized")
STACKS = ("layers", "blocks", "enc_layers", "dec_layers")
J_MESH = jax.make_mesh((1, 1), ("data", "model"))
T_MESH = MeshShape((1, 1), ("data", "model"))


def _spec(p):
    """A spec as a tuple, a one-axis tuple entry as its axis."""
    out = []
    for e in tuple(p):
        if isinstance(e, tuple) and len(e) == 1:
            e = e[0]
        out.append(e)
    return tuple(out)


def _dtype(d) -> str:
    return str(np.dtype(d)) if not isinstance(d, torch.dtype) \
        else str(d).replace("torch.", "")


def _j_flat(tree, extra=None, n_dense=0):
    """{port path: (shape, dtype[, spec])} of a reference tree of
    ShapeDtypeStructs (``extra``: a matching tree of NamedShardings),
    its stacks expanded to per-layer entries and ``dense_layers`` put
    first in ``layers``."""
    out = {}
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    shard = jax.tree_util.tree_leaves(extra) if extra is not None else None
    for i, (path, sds) in enumerate(flat):
        keys = [str(getattr(p, "key", getattr(p, "idx", p))) for p in path]
        spec = _spec(shard[i].spec) if shard is not None else None
        if keys[0] == "dense_layers":
            keys = ["layers"] + keys[1:]
            out["/".join(keys)] = (tuple(sds.shape), _dtype(sds.dtype), spec)
            continue
        stack = next((j for j, k in enumerate(keys) if k in STACKS), None)
        if stack is None or keys[0] == "cache":
            out["/".join(keys)] = (tuple(sds.shape), _dtype(sds.dtype), spec)
            continue
        for layer in range(sds.shape[0]):
            k = keys[:stack + 1] + [str(layer + (n_dense if keys[stack]
                                                  == "layers" else 0))]
            k += keys[stack + 1:]
            out["/".join(k)] = (tuple(sds.shape[1:]), _dtype(sds.dtype),
                                None if spec is None else spec[1:])
    return out


def _t_flat(tree, extra=None):
    out = {}
    shard = [s for _, s in leaves_with_path(extra)] if extra is not None \
        else None
    for i, (path, t) in enumerate(leaves_with_path(tree)):
        spec = _spec(shard[i].spec) if shard is not None else None
        out["/".join(map(str, path))] = (tuple(t.shape), _dtype(t.dtype),
                                         spec)
    return out


def _j_cache_flat(cache, family):
    """A reference cache's leaves by the port's names: a decoder's dense
    layers and stacked layers as one stack."""
    if family != "decoder":
        return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                         for p in path): (tuple(s.shape), _dtype(s.dtype))
                for path, s in jax.tree_util.tree_flatten_with_path(
                    cache)[0]}
    dense = cache.get("dense_layers", [])
    out = {}
    for k, v in cache["layers"].items():
        n = v.shape[0] + len(dense)
        out[k] = ((n,) + tuple(v.shape[1:]), _dtype(v.dtype))
    return out


def _t_cache_flat(cache):
    return {"/".join(map(str, p)): (tuple(t.shape), _dtype(t.dtype))
            for p, t in leaves_with_path(cache)}


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_variant_config_matches_reference(arch, variant):
    got, want = TC.variant_config(arch, variant), RC.variant_config(
        arch, variant)
    for f in dataclasses.fields(got):
        if f.name in ("mx", "mx_table"):
            continue
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    for role in ("weights", "activations", "kv_key", "kv_value", "grads"):
        g, w = getattr(got.mx, role), getattr(want.mx, role)
        assert (g is None) == (w is None), role
        if g is not None:
            assert (g.fmt, g.mode, g.block, g.packed) == \
                (w.fmt, w.mode, w.block, w.packed), role


def _cases():
    return [(arch, shape.name) for arch in ARCH_IDS
            for shape in applicable_shapes(load_config(arch))]


@pytest.mark.parametrize("arch,shape", _cases())
def test_input_specs_match_reference(arch, shape):
    """``batch_specs`` (train / prefill shapes) or ``decode_specs`` (the
    decode shapes) against the reference's stand-ins, leaf by leaf."""
    tcfg, jcfg = load_config(arch), j_load_config(arch)
    assert [s.name for s in applicable_shapes(tcfg)] == \
        [s.name for s in j_applicable(jcfg)]
    ts, js = SHAPES[shape], SHAPES[shape]
    if ts.kind != "decode":
        got, want = batch_specs(tcfg, ts), j_batch_specs(jcfg, js)
        assert {k: (tuple(v.shape), _dtype(v.dtype))
                for k, v in got.items()} == \
            {k: (tuple(v.shape), _dtype(v.dtype)) for k, v in want.items()}
        assert all(v.device.type == "meta" for v in got.values())
        return
    got, want = decode_specs(tcfg, ts), j_decode_specs(jcfg, js)
    for k in ("token", "pos"):
        assert (tuple(got[k].shape), _dtype(got[k].dtype)) == \
            (tuple(want[k].shape), _dtype(want[k].dtype))
    assert _t_cache_flat(got["cache"]) == _j_cache_flat(want["cache"],
                                                        tcfg.family)


def _record_rules(monkeypatch):
    seen = {}
    real = RC.make_rules

    def rec(axes, **kw):
        seen.update(kw)
        return real(axes, **kw)

    monkeypatch.setattr(RC, "make_rules", rec)
    return seen


def _cell_cases():
    out = [(arch, shape, "baseline") for arch, shape in _cases()]
    out += [("chatglm3_6b", s, v) for v in ("paper", "optimized")
            for s in ("train_4k", "prefill_32k", "decode_32k")]
    out += [("rwkv6_7b", "train_4k", "optimized"),
            ("rwkv6_7b", "long_500k", "optimized")]
    return out


@pytest.mark.parametrize("arch,shape,variant", _cell_cases())
def test_build_cell_matches_reference(monkeypatch, arch, shape, variant):
    """Kind, argument shapes and dtypes, in-sharding specs (the params'
    leaf by leaf, the batch's, the cache's) and make_rules' keywords;
    where the port refuses, the refusal names the ROADMAP item."""
    seen = _record_rules(monkeypatch)
    want = RC.build_cell(arch, shape, J_MESH, variant)
    rkw = dict(seen)
    if rkw.get("seq_sharded") or rkw.get("pure_fsdp"):
        with pytest.raises(NotImplementedError) as e:
            TC.build_cell(arch, shape, T_MESH, variant)
        assert A11_2 in str(e.value)
        return
    got = TC.build_cell(arch, shape, T_MESH, variant)
    assert got.kind == want.kind and got.rule_kw == rkw
    cfg = got.cfg
    n_dense = cfg.n_dense_layers if cfg.family == "decoder" else 0
    assert _t_flat(got.args[0], got.in_shardings[0]) == _j_flat(
        want.args[0], want.in_shardings[0], n_dense)
    if got.kind == "train":
        for k in ("master", "m", "v"):
            assert _t_flat(got.args[1][k]) == {
                p: v[:2] + (None,) for p, v in _j_flat(
                    want.args[1][k], None, n_dense).items()}
        assert (tuple(got.args[3].shape), _dtype(got.args[3].dtype)) == \
            (tuple(want.args[3].shape), _dtype(want.args[3].dtype))
    if got.kind in ("train", "prefill"):
        batch, bshard = got.args[1 if got.kind == "prefill" else 2], \
            got.in_shardings[1 if got.kind == "prefill" else 2]
        jb, jsh = want.args[1 if want.kind == "prefill" else 2], \
            want.in_shardings[1 if want.kind == "prefill" else 2]
        assert {k: (tuple(v.shape), _dtype(v.dtype), _spec(bshard[k].spec))
                for k, v in batch.items()} == \
            {k: (tuple(v.shape), _dtype(v.dtype), _spec(jsh[k].spec))
             for k, v in jb.items()}
        return
    token, cache = got.args[1], got.args[2]
    assert (tuple(token.shape), _spec(got.in_shardings[1].spec)) == \
        (tuple(want.args[1].shape), _spec(want.in_shardings[1].spec))
    tspecs = {"/".join(map(str, p)): _spec(s.spec)
              for p, s in leaves_with_path(got.in_shardings[2])}
    jflat = jax.tree_util.tree_flatten_with_path(want.in_shardings[2])[0]
    jspecs = {}
    for path, s in jflat:
        keys = [str(getattr(p, "key", getattr(p, "idx", p))) for p in path]
        if cfg.family == "decoder":
            if keys[0] == "dense_layers":
                continue           # a leaf without its stack's layer dim
            keys = keys[1:]
        jspecs["/".join(keys)] = _spec(s.spec)
    assert tspecs == jspecs
    assert _t_cache_flat(cache) == _j_cache_flat(want.args[2], cfg.family)


def test_cell_runs_need_a_rank_mesh():
    """A mesh description builds a cell's specs; running its step needs
    this rank's DPGroups."""
    cell = TC.build_cell("chatglm3_6b", "decode_32k", T_MESH, "baseline")
    with pytest.raises(TypeError, match="DPGroups"):
        cell.fn(None, torch.zeros(128, dtype=torch.int32), None, 0)
