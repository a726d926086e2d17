"""The port's MX-compressed gradient all-reduce
(``repro_torch.core.grad_compress``) on gloo ranks on the CPU, against
the reference's on forced host devices (``tests/torch_dist.py``), and
``repro_torch.core``'s max-exponent tree against the reference's.

Tolerances:

* meshes (2,) ``("data",)`` and (2, 2) ``("pod", "data")``: codes,
  scales and every rank's output bit for bit against the reference's,
  in every format x mode, for an f32 and a bf16 leaf of 4096 + 17
  elements (padding happens).  Every partial sum there is one f32
  addition, so the order of a sum cannot differ.  The reference's codes
  are its converter's on the mean summed in its order (pod, then data);
  its outputs are its ``mx_allreduce_mean``'s own;
* mesh (2, 4), the reference's own test mesh: every rank's output
  identical, and within the reference's bound of the exact mean
  (``bmax * 2^-3 * 1.01 + 1e-7`` per 32-block,
  ``tests/test_distributed.py:99-104``).  A sum of four terms may run in
  another order in gloo than in XLA; the test records how many codes
  differ from the reference's (none, measured) and holds it at 0;
* ``exchanged_bytes`` equal to the reference's; the spec resolution in
  the reference's order; a world of one returns its input object;
* ``block_max_exponent`` / ``max_exponent_tree`` bit for bit, NaN and
  Inf inputs in, blocks 32 and 64.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.grad_compress import (compressed_mean,
                                            exchanged_bytes,
                                            mx_allreduce_mean,
                                            mx_allreduce_tree)
from repro_torch.core.spec import QuantSpec
from repro_torch.dist import DPGroups
from torch_dist import run_ranks, start_reference

FMTS = ("e5m2", "e4m3", "e3m2", "e2m3", "e2m1", "int8")
MODES = ("paper", "ocp")
SPECS = [f"{f}@32:{m}" for f in FMTS for m in MODES]
DTYPES = ("float32", "bfloat16")
N = 4096 + 17
MESHES = {"2": ((2,), ("data",)), "2x2": ((2, 2), ("pod", "data"))}


def _inputs(n_ranks: int) -> np.ndarray:
    """Each rank's gradient row, f32 (the bf16 leaf is this rounded to
    bf16 on each side: round-to-nearest-even in both frameworks)."""
    return np.random.default_rng(n_ranks).normal(
        size=(n_ranks, N)).astype(np.float32)


_REF = """
import jax, numpy as np
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.core.convert import mx_quantize
from repro.core.grad_compress import mx_allreduce_mean
from repro.core.spec import QuantSpec

N = {N}
out = {{}}
for name, sizes, axes, specs in {meshes!r}:
    n = int(np.prod(sizes))
    g = np.random.default_rng(n).normal(size=(n, N)).astype(np.float32)
    devs = np.array(jax.devices()[:n]).reshape(sizes)
    mesh = jax.sharding.Mesh(devs, axes)
    cases = [(sp, dt) for sp in specs for dt in ("float32", "bfloat16")]

    def body(gl):
        return [mx_allreduce_mean(gl[0].astype(dt), axes,
                                  QuantSpec.parse(sp)).astype(
                                      jnp.float32)[None]
                for sp, dt in cases]

    # one program per mesh: every spec x dtype
    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=P(axes),
                           out_specs=P(axes)))
    for (sp, dt), res in zip(cases, fn(jnp.asarray(g))):
        out[(name, sp, dt, "out")] = np.asarray(res)

    @jax.jit
    def codes(flat):
        # the reference's converter on the mean summed in its order: the
        # pod sums first, then data (two-term sums: one f32 addition)
        res = []
        for sp, dt in cases:
            x = flat.astype(dt).astype(jnp.float32).reshape(sizes + (N,))
            if len(sizes) == 2:
                x = x[0] + x[1]
            s = x[0]
            for d in range(1, x.shape[0]):
                s = s + x[d]
            spec = QuantSpec.parse(sp)
            pad = (-N) % (n * spec.block)
            mx = mx_quantize(jnp.pad(s, (0, pad)) / n, spec)
            res.append((mx.codes, mx.scales))
        return res

    for (sp, dt), (c, sc) in zip(cases, codes(jnp.asarray(g))):
        out[(name, sp, dt, "codes")] = np.asarray(c)
        out[(name, sp, dt, "scales")] = np.asarray(sc)
save(out)
"""


def _reference(tmp):
    meshes = [(name, sizes, axes, SPECS)
              for name, (sizes, axes) in MESHES.items()]
    meshes.append(("2x4", (2, 4), ("pod", "data"), ["e4m3@32:ocp"]))
    return start_reference(_REF.format(N=N, meshes=meshes), 8, tmp)


def _exchange_rank(groups, specs):
    """On each rank: every spec x dtype exchanged (codes, scales, the
    output), and ``mx_allreduce_tree`` over a tree with a ``None`` leaf."""
    g = torch.from_numpy(_inputs(groups.world)[groups.rank])
    res = {}
    for sp in specs:
        spec = QuantSpec.parse(sp)
        for dt in DTYPES:
            x = g.to(getattr(torch, dt))
            mx = compressed_mean(x, groups, spec)
            out = mx_allreduce_mean(x, groups, spec)
            res[(sp, dt)] = (mx.codes, mx.scales, out.dtype,
                             out.to(torch.float32))
    tree = {"a": g[:100].clone(), "b": None,
            "c": [g[:40].to(torch.bfloat16), None]}
    res["tree"] = mx_allreduce_tree(tree, groups, "e2m1@32:ocp")
    res["tree_leaves"] = {
        "a": mx_allreduce_mean(tree["a"], groups, "e2m1@32:ocp"),
        "c0": mx_allreduce_mean(tree["c"][0], groups, "e2m1@32:ocp")}
    return res


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The reference's exchange (its interpreter started first) and the
    port's on the gloo ranks of each mesh, run side by side."""
    d = tmp_path_factory.mktemp("exchange")
    wait = _reference(d)
    port = {name: run_ranks(_exchange_rank, sizes, d, SPECS)
            for name, (sizes, _) in MESHES.items()}
    port["2x4"] = run_ranks(_exchange_rank, (2, 4), d, ["e4m3@32:ocp"])
    return wait(), port


@pytest.fixture(scope="module")
def reference(both):
    return both[0]


@pytest.fixture(scope="module")
def port(both):
    return both[1]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_allreduce_bit_for_bit(reference, port, mesh, spec, dtype):
    """Codes, scales and each rank's output equal the reference's."""
    want = np.asarray(reference[(mesh, spec, dtype, "out")])
    n = len(port[mesh])
    for r, ranks in enumerate(port[mesh]):
        codes, scales, out_dtype, out = ranks[(spec, dtype)]
        assert out_dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(
            codes.numpy(), reference[(mesh, spec, dtype, "codes")],
            err_msg=f"rank {r} codes")
        np.testing.assert_array_equal(
            scales.numpy(), reference[(mesh, spec, dtype, "scales")],
            err_msg=f"rank {r} scales")
        # the reference's output rows: one per device, all the same
        assert want.shape == (n, N)
        np.testing.assert_array_equal(out.numpy(), want[r],
                                      err_msg=f"rank {r} output")


def test_reference_mesh_2x4_identical_and_bounded(reference, port):
    """At the reference's own mesh (2, 4) every rank's output is the same
    and within the reference's bound of the exact mean; the codes equal
    the reference's (none differs: gloo's four-term sums give XLA's
    bits here)."""
    g = _inputs(8)
    outs = [r[("e4m3@32:ocp", "float32")] for r in port["2x4"]]
    for codes, scales, _, out in outs[1:]:
        assert torch.equal(out, outs[0][3])
        assert torch.equal(codes, outs[0][0])
    out = outs[0][3].numpy()
    exact = g.mean(0)
    err = np.abs(out - exact)
    blocks = exact[: N // 32 * 32].reshape(-1, 32)
    tol = np.repeat(np.abs(blocks).max(1), 32) * 2.0 ** -3 * 1.01 + 1e-7
    assert (err[: len(tol)] <= tol).all(), err.max()
    flips = int((outs[0][0].numpy()
                 != reference[("2x4", "e4m3@32:ocp", "float32",
                               "codes")]).sum())
    print(f"(2, 4): {flips} of {outs[0][0].numel()} codes differ from "
          f"the reference's")
    assert flips == 0
    np.testing.assert_array_equal(
        out, reference[("2x4", "e4m3@32:ocp", "float32", "out")][0])


@pytest.mark.parametrize("mesh", ["2", "2x2", "2x4"])
def test_allreduce_tree_keeps_none_and_dtypes(port, mesh):
    """``mx_allreduce_tree``: ``None`` leaves stay ``None``, each leaf
    keeps its dtype and equals its own ``mx_allreduce_mean``."""
    for ranks in port[mesh]:
        tree, one = ranks["tree"], ranks["tree_leaves"]
        assert tree["b"] is None and tree["c"][1] is None
        assert tree["a"].dtype == torch.float32
        assert tree["c"][0].dtype == torch.bfloat16
        assert torch.equal(tree["a"], one["a"])
        assert torch.equal(tree["c"][0], one["c0"])


def test_world_of_one_returns_its_input():
    """A world of one returns ``g`` itself (the reference's mesh of one
    device), and launches nothing."""
    groups = DPGroups(("data",), (1,), 0, torch.device("cpu"), "gloo",
                      {"data": None})
    g = torch.randn(100)
    assert mx_allreduce_mean(g, groups) is g
    assert mx_allreduce_mean(g, groups, "e2m1@32:paper") is g
    tree = mx_allreduce_tree({"a": g, "b": None}, groups)
    assert tree["a"] is g and tree["b"] is None


@pytest.mark.parametrize("fmt", FMTS)
def test_exchanged_bytes_matches_reference(fmt):
    """``exchanged_bytes`` equals the reference's for every format at 1,
    2 and 8 devices, compressed or not, and for a spec string."""
    from repro.core.grad_compress import exchanged_bytes as ref_bytes
    for n in (1, 2, 8):
        for compressed in (True, False):
            for spec in (fmt, f"{fmt}@32:paper"):
                assert exchanged_bytes(7_000_003, n, spec, compressed) == \
                    ref_bytes(7_000_003, n, spec, compressed)


def _grads_spec_cases():
    return [
        # (explicit spec, the rules' grads role)
        ("e2m1@32:paper", "e5m2@32:ocp"),
        ("int8@32:paper", "no rules"),
        (None, "e5m2@32:ocp"),
        (None, None),
        (None, "no rules"),
    ]


@pytest.mark.parametrize("case", range(5))
def test_grads_spec_resolution_order(case):
    """The exchange spec: an explicit argument, then the installed rules'
    ``grads`` role, then e4m3/ocp; equal to the reference's resolution in
    each case."""
    from repro.core.grad_compress import _grads_spec as ref_spec
    from repro.core.spec import QuantPolicy as JPolicy
    from repro.dist.sharding import make_rules as j_rules
    from repro.dist.sharding import use_rules as j_use
    from repro_torch.core.grad_compress import _grads_spec
    from repro_torch.core.spec import QuantPolicy
    from repro_torch.dist import make_rules, use_rules
    spec, role = _grads_spec_cases()[case]

    def resolve(make, use, policy, fn):
        if role == "no rules":
            return fn()
        pol = policy.parse(f"grads={role}" if role else "none")
        with use(make(("data",), quant=pol)):
            return fn()

    got = resolve(make_rules, use_rules, QuantPolicy,
                  lambda: _grads_spec(spec))
    want = resolve(j_rules, j_use, JPolicy,
                   lambda: ref_spec(spec, None, None, None))
    assert str(got) == str(want)
    expected = {0: "e2m1@32:paper", 1: "int8@32:paper", 2: "e5m2@32:ocp",
                3: "e4m3@32:ocp", 4: "e4m3@32:ocp"}[case]
    assert str(got) == expected


# =============================================================================
# repro_torch.core's max-exponent tree (ROADMAP A13)
# =============================================================================
def _exponents(block: int, seed: int):
    """f32 inputs with NaN, +-Inf, zeros and subnormals among normals;
    their biased exponents and finite mask, (rows, block)."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(64, block))
         * 2.0 ** rng.integers(-140, 120, size=(64, block))).astype(
        np.float32)
    x[1, 3] = np.nan
    x[2, :] = np.inf
    x[3, 5] = -np.inf
    x[4, :] = 0.0
    x[5, 7] = np.float32(1e-42)               # subnormal
    x[6, :] = np.nan
    bits = x.view(np.uint32)
    exp = ((bits >> 23) & 0xFF).astype(np.int32)
    return exp, exp != 0xFF


@pytest.mark.parametrize("block", [32, 64])
def test_block_max_exponent_matches_reference(block):
    """``block_max_exponent`` (finite masking) and ``max_exponent_tree``
    bit for bit against the reference's, and equal to the converter's
    ``amax`` over the masked exponents."""
    import jax.numpy as jnp
    from repro.core import block_max_exponent as j_bme
    from repro.core import max_exponent_tree as j_tree
    from repro_torch.core import block_max_exponent, max_exponent_tree
    exp, finite = _exponents(block, block)
    got = block_max_exponent(torch.from_numpy(exp),
                             torch.from_numpy(finite))
    want = np.asarray(j_bme(jnp.asarray(exp), jnp.asarray(finite)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    masked = np.where(finite, exp, 0)
    np.testing.assert_array_equal(got.numpy(), masked.max(-1))
    raw = np.random.default_rng(7).integers(
        -300, 300, size=(5, 3, block)).astype(np.int32)
    np.testing.assert_array_equal(
        max_exponent_tree(torch.from_numpy(raw)).numpy(),
        np.asarray(j_tree(jnp.asarray(raw))))

