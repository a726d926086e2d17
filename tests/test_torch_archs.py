"""The port's five GQA decoder configs against the JAX package: configs,
parameters and the forward pass on each reduced config (the other
families' are in tests/test_torch_families.py; the configs of all ten
archs are held field for field here).

For every GQA arch of ``repro_torch.models.ARCH_IDS`` the reference's params
(its ``init``, weight-resident e4m3 where a policy says so) are carried
across with ``from_numpy``: an MoE config's ``dense_layers`` come first
in the port's one list of layers, the expert stacks keep their leading
E axis, and the router stays f32 even in a bf16 config.  Logits are held
to 1e-4 absolute, the decoder tolerance of tests/test_torch_model.py
(f32 sums in another order, compounded over the layers).  The
reference's weight-resident matmul runs its dequant-einsum path
(``REPRO_MX_MATMUL_IMPL=einsum``).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.models import ARCH_IDS as J_ARCH_IDS
from repro.models import Model as JModel
from repro.models import load_config as j_load_config
from repro.models import load_reduced as j_load_reduced
from repro.models.config import QuantPolicy as JPolicy
from repro_torch.core.mx_weight import MXWeight as TMXWeight
from repro_torch.core.spec import QuantPolicy as TPolicy
from repro_torch.models import ARCH_IDS, Model as TModel
from repro_torch.models import load_config as t_load_config
from repro_torch.models import load_reduced as t_load_reduced
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.models.params import from_numpy
from torch_parity import params_to_numpy

torch.set_num_threads(1)

LOGITS_TOL = 1e-4
# the port's config fields, every one the reference's (the port leaves
# out only the reference's dry-run switch ``scan_unroll``); ``mx`` is
# compared as its own type, ``attn_impl`` defaults alike
FIELDS = [f.name for f in dataclasses.fields(TConfig)
          if f.name not in ("mx", "attn_impl")]
GQA = ("chatglm3_6b", "glm4_9b", "yi_34b", "deepseek_67b",
       "moonshot_v1_16b_a3b")


def test_arch_ids_are_the_gqa_decoders():
    """The GQA decoders are among ``ARCH_IDS``, which is the reference's
    ten archs in the reference's order."""
    assert set(GQA) <= set(ARCH_IDS)
    assert ARCH_IDS == J_ARCH_IDS


def test_registry_refuses_an_unknown_arch():
    for load in (t_load_config, t_load_reduced):
        with pytest.raises(ValueError, match="unknown arch"):
            load("no_such_arch")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_match_reference(arch):
    """Field for field: the published config, and the reduced config in
    f32 (as the reference's ``load_reduced`` serves it)."""
    for tcfg, jcfg in ((t_load_config(arch), j_load_config(arch)),
                       (t_load_reduced(arch), j_load_reduced(arch))):
        for name in FIELDS:
            assert getattr(tcfg, name) == getattr(jcfg, name), (arch, name)
        assert tcfg.hd == jcfg.hd
        assert TModel(tcfg, "cpu").supports_paged() \
            == JModel(jcfg).supports_paged()
    assert t_load_reduced(arch).dtype == "float32"


def _pair(arch, policy, **over):
    jcfg = j_load_reduced(arch, mx=JPolicy.parse(policy), **over)
    tcfg = t_load_reduced(arch, mx=TPolicy.parse(policy), **over)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    if jcfg.mx.weights is not None:
        jp = jax.jit(jm.quantize_weights)(jp)
    return jm, jp, tcfg, from_numpy(params_to_numpy(jp), tcfg, "cpu")


def _equal(t, j):
    """A port leaf or subtree equals the reference's, key for key."""
    if isinstance(t, dict):
        return set(t) == set(j) and all(_equal(t[k], j[k]) for k in t)
    if isinstance(t, TMXWeight):
        return (np.array_equal(t.codes.numpy(), np.asarray(j.codes))
                and np.array_equal(t.scales.numpy(), np.asarray(j.scales)))
    return str(t.dtype).split(".")[-1] == np.asarray(j).dtype.name \
        and np.array_equal(t.to(torch.float32).numpy(),
                           np.asarray(j, np.float32))


@pytest.mark.parametrize("arch", GQA)
def test_from_numpy_carries_the_reference_tree(arch):
    """One list of n_layers layers: the reference's dense_layers, then
    each slice of its stacked layers, every leaf equal."""
    jm, jp, tcfg, tp = _pair(arch, "weights=e4m3@32:ocp")
    assert len(tp["layers"]) == tcfg.n_layers
    dense = jp.get("dense_layers", [])
    assert len(dense) == tcfg.n_dense_layers
    for i, lp in enumerate(tp["layers"]):
        jl = dense[i] if i < len(dense) else jax.tree_util.tree_map(
            lambda a: a[i - len(dense)], jp["layers"])
        assert ("moe" in lp) == tcfg.moe_layer(i) == ("moe" in jl)
        assert _equal(lp, jl)
    for k in ("embed", "norm_f", "lm_head"):
        assert _equal(tp[k], jp[k])
    if tcfg.n_experts:
        moe = tp["layers"][-1]["moe"]
        assert moe["experts"]["w2"].codes.shape[0] == tcfg.n_experts
        assert moe["router"].dtype == torch.float32
        assert isinstance(moe["shared"]["w1"], TMXWeight)


def test_router_stays_f32_in_a_bf16_config():
    """The reference keeps the router in f32 whatever the dtype
    (layers.py:881); so does the port, from its own init and across
    from_numpy, while every other fp leaf is bf16."""
    over = dict(dtype="bfloat16", param_dtype="bfloat16")
    jcfg = j_load_reduced("moonshot_v1_16b_a3b", **over)
    tcfg = t_load_reduced("moonshot_v1_16b_a3b", dtype="bfloat16")
    jp = JModel(jcfg).init(jax.random.PRNGKey(0))
    assert jp["layers"]["moe"]["router"].dtype == np.float32
    tp = from_numpy(params_to_numpy(jp), tcfg, "cpu")
    for params in (tp, TModel(tcfg, "cpu").init(seed=0)):
        moe = params["layers"][1]["moe"]
        assert moe["router"].dtype == torch.float32
        assert moe["experts"]["w1"].dtype == torch.bfloat16
        assert params["layers"][0]["mlp"]["w1"].shape == (128, tcfg.d_ff)


@pytest.mark.parametrize("arch", GQA)
@pytest.mark.parametrize("policy", ["none", "weights=e4m3@32:ocp"])
def test_forward_logits_agree(monkeypatch, arch, policy):
    """The full forward on 2 x 32 tokens (``layers.moe``'s aux loss is
    held against the reference in test_torch_moe)."""
    monkeypatch.setenv("REPRO_MX_MATMUL_IMPL", "einsum")
    jm, jp, tcfg, tp = _pair(arch, policy)
    tokens = np.random.default_rng(0).integers(
        0, tcfg.vocab, size=(2, 32)).astype(np.int32)
    jlog, _ = jm.forward(jp, {"tokens": tokens})
    tlog, _ = TModel(tcfg, "cpu").forward(
        tp, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               atol=LOGITS_TOL, rtol=0)


@pytest.mark.parametrize("arch", GQA)
def test_port_init_quantizes_each_layer(arch):
    """The port's own init on a reduced config: with ``quantize`` every
    matmul weight (expert stacks included) is an MXWeight of the
    weights role, and the same as quantizing the fp init afterwards."""
    tcfg = t_load_reduced(arch, mx=TPolicy.parse("weights=e4m3@32:ocp"))
    m = TModel(tcfg, "cpu")
    q = m.init(seed=1, quantize=True)
    after = m.quantize_weights(m.init(seed=1))
    leaves = jax.tree_util.tree_leaves(
        q["layers"], is_leaf=lambda v: isinstance(v, TMXWeight))
    ref = jax.tree_util.tree_leaves(
        after["layers"], is_leaf=lambda v: isinstance(v, TMXWeight))
    n_moe = sum(tcfg.moe_layer(i) for i in range(tcfg.n_layers))
    per_moe = 3 + (3 if tcfg.n_shared_experts else 0)   # experts, shared
    assert sum(isinstance(v, TMXWeight) for v in leaves) \
        == 4 * tcfg.n_layers + 3 * (tcfg.n_layers - n_moe) + per_moe * n_moe
    assert len(leaves) == len(ref)
    for a, b in zip(leaves, ref):
        if isinstance(a, TMXWeight):
            assert torch.equal(a.codes, b.codes)
            assert torch.equal(a.scales, b.scales)
        else:
            assert torch.equal(a, b)


@pytest.mark.parametrize("arch", GQA)
def test_launcher_serves_every_arch(capsys, arch):
    """``--arch`` takes every GQA decoder: the continuous engine on the
    reduced config, weight-resident, on the CPU (the other families serve
    through the static path: tests/test_torch_families_serve.py)."""
    from repro_torch.launch import serve as launcher
    launcher.main(["--arch", arch, "--reduced", "--device", "cpu",
                   "--paged", "--weight-resident", "--batch", "2",
                   "--requests", "3", "--new-tokens", "3", "--prompt-len",
                   "12", "--quant", "weights=e4m3@32:ocp,kv=int8@32:ocp"])
    out = capsys.readouterr().out
    assert "9 tokens" in out and "0 quarantined" in out


def test_launcher_mx_kv_alias(capsys):
    """The reference's deprecated ``--mx-kv`` / ``--mx-mode`` serve as
    ``--quant kv=<fmt>@32:<mode>`` does: the same policy and tokens."""
    from repro_torch.launch import serve as launcher
    base = ["--arch", "yi_34b", "--reduced", "--device", "cpu", "--batch",
            "2", "--prompt-len", "12", "--new-tokens", "4"]
    tokens = []
    for extra in (["--mx-kv", "e2m1", "--mx-mode", "paper"],
                  ["--quant", "kv=e2m1@32:paper"]):
        launcher.main(base + extra)
        out = capsys.readouterr().out
        assert "policy kv_key=e2m1@32:paper,kv_value=e2m1@32:paper" in out
        tokens.append([ln for ln in out.splitlines()
                       if "sample output tokens" in ln])
    assert tokens[0] == tokens[1] and len(tokens[0]) == 1
