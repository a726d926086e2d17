"""The static engine of the port against the JAX package's on the
reduced configs of the other families: MLA (deepseek-v2-236b), the patch
frontend (internvl2-76b), the Mamba2 hybrid (zamba2-1.2b), RWKV6
(rwkv6-7b) and the encoder-decoder (seamless-m4t-medium).

Both sides serve the reference's batch dict (``tokens``, and
``prefix_embeds`` or ``frames`` from a numpy seed) at
``attn_impl="flash"`` (the reference's Pallas kernels in interpret mode,
the port's kernels' plain versions), once with an fp KV cache and once
with INT8-key / E2M1-value MX KV (internvl2 also with weight-resident
e4m3 weights).  Weights are carried across byte for byte; greedy tokens
must be identical.  The continuous engine refuses all five, as the
reference's does, and the serve launcher serves each through its static
path.
"""
import jax
import numpy as np
import pytest
import torch

from repro.models import Model as JModel
from repro.models import load_reduced as j_load_reduced
from repro.models.config import QuantPolicy as JPolicy
from repro.serve import ContinuousBatchingEngine as JEngine
from repro.serve import GenerationConfig as JGen
from repro.serve import ServeEngine as JServe
from repro_torch.core.spec import QuantPolicy as TPolicy
from repro_torch.models import Model as TModel
from repro_torch.models import load_reduced as t_load_reduced
from repro_torch.models import make_concrete_batch
from repro_torch.models.params import from_numpy
from repro_torch.serve import ContinuousBatchingEngine as TEngine
from repro_torch.serve import GenerationConfig, ServeEngine
from torch_parity import params_to_numpy

torch.set_num_threads(1)

FAMILIES = ("deepseek_v2_236b", "internvl2_76b", "zamba2_1p2b", "rwkv6_7b",
            "seamless_m4t_medium")
POLICIES = {"fp": "none", "mx": "kv_key=int8@32:ocp,kv_value=e2m1@32:ocp"}
NEW, S, MAX_LEN = 6, 24, 40


@pytest.fixture(autouse=True)
def einsum_matmul(monkeypatch):
    monkeypatch.setenv("REPRO_MX_MATMUL_IMPL", "einsum")


def _pair(arch, kv):
    policy = POLICIES[kv]
    resident = arch == "internvl2_76b" and kv == "mx"
    if resident:
        policy = "weights=e4m3@32:ocp," + policy
    jcfg = j_load_reduced(arch, mx=JPolicy.parse(policy), attn_impl="flash")
    tcfg = t_load_reduced(arch, mx=TPolicy.parse(policy), attn_impl="flash")
    jm = JModel(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    if resident:
        jp = jax.jit(jm.quantize_weights)(jp)
    return jm, jp, TModel(tcfg, "cpu"), from_numpy(params_to_numpy(jp), tcfg,
                                                   "cpu")


def _batch(cfg, s=S, seed=1):
    batch = make_concrete_batch(cfg, 2, s, seed=seed)
    batch.pop("labels")
    return batch


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("kv", ["fp", "mx"])
def test_static_engine_tokens_match_jax(arch, kv):
    """Greedy tokens of ``ServeEngine`` equal the JAX engine's; a second
    call on the same engine (its graph's cache and states refilled in
    place) gives them again."""
    jm, jp, tm, tp = _pair(arch, kv)
    batch = _batch(tm.cfg)
    want = np.asarray(JServe(jm, jp, max_len=MAX_LEN).generate(
        batch, JGen(max_new_tokens=NEW)))
    eng = ServeEngine(tm, tp, max_len=MAX_LEN)
    gen = GenerationConfig(max_new_tokens=NEW)
    np.testing.assert_array_equal(eng.generate(batch, gen), want)
    np.testing.assert_array_equal(eng.generate(batch, gen), want)
    assert eng.kv_cache_nbytes > 0


def test_encoder_length_keys_the_static_step():
    """The encoder-decoder's cross K/V are S_enc long: a batch of other
    frames gets a step of its own, and each gives the JAX engine's
    tokens."""
    jm, jp, tm, tp = _pair("seamless_m4t_medium", "mx")
    eng = ServeEngine(tm, tp, max_len=MAX_LEN)
    for s in (S, 16, S):
        batch = _batch(tm.cfg, s=s, seed=s)
        want = np.asarray(JServe(jm, jp, max_len=MAX_LEN).generate(
            batch, JGen(max_new_tokens=NEW)))
        got = eng.generate(batch, GenerationConfig(max_new_tokens=NEW))
        np.testing.assert_array_equal(got, want)
    assert sorted(k[2] for k in eng._graphs) == [8, 12]


def test_prefix_counts_against_max_len():
    """The patch frontend's prefix positions sit in the cache too: a
    batch whose prefix + tokens + new tokens exceed max_len is refused."""
    _, _, tm, tp = _pair("internvl2_76b", "fp")
    batch = _batch(tm.cfg)          # 8 prefix + 16 tokens
    eng = ServeEngine(tm, tp, max_len=S + NEW - 2)
    with pytest.raises(ValueError, match="do not fit"):
        eng.generate(batch, GenerationConfig(max_new_tokens=NEW))
    eng = ServeEngine(tm, tp, max_len=S + NEW - 1)
    assert eng.generate(batch, GenerationConfig(
        max_new_tokens=NEW)).shape == (2, NEW)


@pytest.mark.parametrize("arch", FAMILIES)
def test_continuous_engine_refuses_as_the_reference(arch):
    """``supports_paged`` is false for all five (MLA, a frontend, or not
    a decoder), and both continuous engines refuse them."""
    jm, jp, tm, tp = _pair(arch, "mx")
    assert not tm.supports_paged() and not jm.supports_paged()
    with pytest.raises(NotImplementedError, match="GQA decoder"):
        JEngine(jm, jp)
    with pytest.raises(NotImplementedError, match="GQA decoder"):
        TEngine(tm, tp)


@pytest.mark.parametrize("arch", FAMILIES)
def test_launcher_serves_each_family(capsys, arch):
    """The serve launcher's static path on each reduced config on the
    CPU (internvl2 weight-resident), and its ``--paged`` refused as the
    continuous engine refuses it."""
    from repro_torch.launch import serve as launcher
    base = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "20", "--new-tokens", "3"]
    quant = "kv=int8@32:ocp"
    if arch == "internvl2_76b":
        base.append("--weight-resident")
        quant = "weights=e4m3@32:ocp," + quant
    launcher.main(base + ["--quant", quant])
    out = capsys.readouterr().out
    assert "generated 6 tokens" in out and "sample output tokens" in out
    with pytest.raises(NotImplementedError, match="GQA decoder"):
        launcher.main(base + ["--quant", quant, "--paged"])
