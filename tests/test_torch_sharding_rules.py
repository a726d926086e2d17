"""The port's rule table against the reference's (tests/
test_sharding_rules.py's cases, ported), and ``param_specs`` leaf by leaf
against the reference's on the converted param trees of the reduced
chatglm3 and moonshot (no mesh needed: placement-only meshes stand in).
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.dist import sharding as R
from repro.launch.cells import _validated as ref_validated
from repro.models import Model as JModel
from repro.models import load_reduced as j_load_reduced
from repro_torch.core.spec import QuantPolicy
from repro_torch.dist import sharding as S
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.models import load_reduced as t_load_reduced
from repro_torch.models.params import from_numpy
from torch_parity import params_to_numpy


class _Mesh:
    def __init__(self, sizes, coords=None):
        self.shape, self.coords = dict(sizes), dict(coords or {})
        self.axes = tuple(sizes)

    def size(self, axis):
        return self.shape.get(axis, 1)

    def coord(self, axis):
        return self.coords.get(axis, 0)

    def index(self, entry):
        axes = entry if isinstance(entry, tuple) else (entry,)
        i = 0
        for a in axes:
            i = i * self.size(a) + self.coord(a)
        return i


def test_make_rules_single_pod():
    r = S.make_rules(("data", "model"))
    assert r["batch"] == ("data",)
    assert r["model"] == ("model",)
    assert r["wgather"] is not None


def test_make_rules_multi_pod_decode():
    r = S.make_rules(("pod", "data", "model"), fsdp_params=False)
    assert r["batch"] == ("pod", "data")
    assert r["seq"] is None
    assert r["wgather"] is None
    assert r == R.make_rules(("pod", "data", "model"), fsdp_params=False)


# the reference's toggles no port layer reads: they raise rather than
# being silently ignored (seq_sharded would leave the sequence whole)
UNPORTED = (dict(seq_sharded=True),
            dict(pure_fsdp=True, paged_pool_sharded=True))


@pytest.mark.parametrize("axes", [("data",), ("data", "model"),
                                  ("pod", "data", "model"), ("model",)])
@pytest.mark.parametrize("kw", [{}, dict(fsdp_params=False),
                                dict(paged_pool_sharded=True),
                                dict(bf16_matmul_out=True)] +
                         list(UNPORTED))
def test_make_rules_matches_reference(axes, kw):
    """Key for key, every keyword the port consumes, with and without a
    policy; only seq_sharded and pure_fsdp raise, naming the toggle and
    the ROADMAP item of sharded training's remainder."""
    pol = QuantPolicy.parse("grads=e4m3@32:ocp")
    if kw in UNPORTED:
        with pytest.raises(NotImplementedError) as e:
            S.make_rules(axes, **kw)
        assert next(iter(kw)) in str(e.value) and S.A11_2 in str(e.value)
        assert "A11.2: sharded training of MoE and the other families" \
            in str(e.value)
        return
    assert S.make_rules(axes, **kw) == R.make_rules(axes, **kw)
    got = S.make_rules(axes, quant=pol, **kw)
    assert got["quant"] is pol and set(got) == set(R.make_rules(axes))


def test_shard_params_refuses_fsdp_posture():
    """The FSDP posture gives each rank its (data, model) chunk: a
    column-parallel weight ("data", "model") splits K over "data" and N
    over "model", a row-parallel one ("model", "data") the other way
    round, the vocab-sharded embedding its rows over "model" and d over
    "data"; a norm stays whole.  The decode posture splits over "model"
    only.  An MoE layer's expert stacks are refused, naming A11.2."""
    w = torch.arange(8 * 8, dtype=torch.float32).reshape(8, 8)
    params = {"embed": w.clone(), "norm_f": torch.ones(8),
              "layers": [{"attn": {"wq": w.clone(), "wo": w.clone()}}]}
    rules = S.make_rules(("data", "model"))
    for d in range(2):
        for m in range(2):
            mesh = _Mesh({"data": 2, "model": 2}, {"data": d, "model": m})
            got = S.shard_params(params, mesh, rules)
            rows, cols = slice(4 * d, 4 * d + 4), slice(4 * m, 4 * m + 4)
            assert torch.equal(got["layers"][0]["attn"]["wq"], w[rows, cols])
            rows, cols = slice(4 * m, 4 * m + 4), slice(4 * d, 4 * d + 4)
            assert torch.equal(got["layers"][0]["attn"]["wo"], w[rows, cols])
            assert torch.equal(got["embed"], w[rows, cols])
            assert torch.equal(got["norm_f"], params["norm_f"])
    decode = S.make_rules(("data", "model"), fsdp_params=False)
    assert S.shard_params(params, mesh, decode)["layers"][0]["attn"][
        "wq"].shape == (8, 4)
    moe = {"layers": [{"moe": {"router": w, "experts": {"w1": w[None]}}}]}
    with pytest.raises(NotImplementedError, match="A11.2: sharded training"):
        S.shard_params(moe, mesh, rules)


def test_toggles_and_mesh_queries():
    assert (S.model_axis_size(), S.model_index()) == (1, 0)
    rules = S.make_rules(("data", "model"),
                         quant=QuantPolicy.parse("kv=int8@32:ocp"))
    with S.use_rules(rules):
        assert S.model_axis_size() == 1              # no mesh installed
        assert S.quant_spec_for("kv_key").fmt == "int8"
        with S.set_mesh(_Mesh({"data": 2, "model": 4}, {"model": 3})):
            assert (S.model_axis_size(), S.model_index()) == (4, 3)
            assert (S.model_parts(64), S.model_parts(6)) == (4, 1)
            assert S.rule_size("kv_batch") == 2
            assert S.rule_axes("model") == ("model",)
    assert S.current_mesh() is None and S.current_rules() is None


def test_head_shard():
    rules = S.make_rules(("data", "model"))
    with S.use_rules(rules), S.set_mesh(_Mesh({"model": 4}, {"model": 2})):
        assert S.head_shard(32, 8, 128) == S.HeadShard(8, 2)
        # chatglm3's 2 KV heads at model 4: every KV head (wk's columns
        # split mid-head, so k / v are gathered), q from head 16
        assert S.head_shard(32, 2, 128) == S.HeadShard(8, 2, head0=16,
                                                       gather_kv=True)
        # reduced chatglm3 at model 4: wk's 64 columns split mid-head
        assert S.head_shard(4, 2, 32) == S.HeadShard(1, 2, head0=2,
                                                     gather_kv=True)
        # 6 heads do not split over 4: refused, naming A11.2
        with pytest.raises(NotImplementedError, match="A11.2"):
            S.head_shard(6, 2, 32)
    assert S.head_shard(32, 2, 128) == S.HeadShard(32, 2)


def test_param_specs_shapes():
    params = {
        "embed": (1024, 64),
        "layers": {
            "attn": {"wq": (4, 64, 128), "wo": (4, 128, 64)},
            "moe": {"experts": {"w1": (4, 8, 64, 32)}},
            "ln1": (4, 64),
        },
        "lm_head": (64, 1024),
    }
    specs = S.param_specs(params)
    assert specs["embed"] == ("model", "data")
    assert specs["layers"]["attn"]["wq"] == (None, "data", "model")
    assert specs["layers"]["attn"]["wo"] == (None, "model", "data")
    assert specs["layers"]["moe"]["experts"]["w1"] == \
        (None, "model", "data", None)
    assert specs["layers"]["ln1"] == (None, None)
    assert specs["lm_head"] == ("data", "model")
    ref = R.param_specs(jax.tree_util.tree_map(
        lambda s: jnp.zeros(s), params,
        is_leaf=lambda x: isinstance(x, tuple)))
    flat = jax.tree_util.tree_leaves(ref, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    port = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        else:
            port.append(t)
    walk(specs)
    assert port == [tuple(p) for p in flat]


def test_validated_divisibility():
    sizes = {"data": 16, "model": 16}
    assert S.validated(("data", "model"), (50, 64), sizes) \
        == (None, "model")
    assert S.validated((("pod", "data"), None), (64, 3), sizes)[1] is None

    class FakeMesh:
        shape = sizes
    for spec, shape in [(("data", "model"), (50, 64)),
                        ((("pod", "data"), None), (64, 3)),
                        (("model", "data", None), (8, 48, 5))]:
        assert S.validated(spec, shape, sizes) \
            == tuple(ref_validated(jax.sharding.PartitionSpec(*spec), shape,
                                   FakeMesh()))


def _ref_leaf_specs(jparams):
    """(path, spec) of every reference leaf, paths as key strings."""
    specs = R.param_specs(jparams)
    out = {}
    for path, sp in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))[0]:
        out[tuple(str(getattr(p, "key", getattr(p, "idx", p)))
                  for p in path)] = tuple(sp)
    return out


@pytest.mark.parametrize("arch", ["chatglm3_6b", "moonshot_v1_16b_a3b"])
def test_param_specs_match_reference_on_converted_trees(arch):
    """Leaf by leaf: the port's per-layer list gets the reference's spec
    of the stacked leaf without its layer entry (an MoE config's leading
    dense layers, unstacked in the reference, their spec as it is)."""
    jm = JModel(j_load_reduced(arch))
    jp = jm.init(jax.random.PRNGKey(0))
    ref = _ref_leaf_specs(jp)
    cfg = t_load_reduced(arch)
    tp = from_numpy(params_to_numpy(jp), cfg, "cpu")
    specs = S.param_specs(tp)
    n_dense = cfg.n_dense_layers
    seen = set()

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, path + (i,))
        else:
            if path[0] == "layers" and path[1] < n_dense:
                key = ("dense_layers", str(path[1])) + path[2:]
                want = ref[key]
            elif path[0] == "layers":
                key = ("layers",) + path[2:]
                want = ref[key][1:]
            else:
                key, want = path, ref[path]
            assert t == want, path
            seen.add(key)
    walk(specs, ())
    assert seen == set(ref)


@pytest.mark.parametrize("ndev,shape", [(1, (1, 1)), (2, (1, 2)),
                                        (3, (3, 1)), (4, (1, 4)),
                                        (6, (3, 2)), (8, (2, 4))])
def test_make_test_mesh(ndev, shape):
    m = make_test_mesh(ndev)
    assert (m.sizes, m.axis_names) == (shape, ("data", "model"))
    assert m.world == ndev


def test_make_production_mesh_shapes():
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).shape \
        == {"pod": 2, "data": 16, "model": 16}
