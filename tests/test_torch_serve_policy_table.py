"""Per-layer policy serving in the port (``PolicyTable``) against the JAX
engines (mirrors tests/test_serve_policy_table.py).

The six cases of the reference's file run on the port under its
``TABLE`` (INT8 KV on layer 0, E2M1 keys beside E4M3 values on layer 1):
dense attention equals the decode kernels' path (their plain versions on
the CPU), continuous equals solo contiguous serving, each layer's pages
are sized by its own specs, the engine reports fewer pool bytes than
uniform INT8, an identical table collapses to the uniform policy, and fp
pages beside packed E2M1 pages serve.  Beyond them: greedy tokens equal
the JAX engines', continuous and static, under a table that mixes weight
formats too (weight-resident, each layer at its own format); the
per-layer pool bytes equal the JAX pool's; the prefix cache,
preempt-and-swap and a snapshot restore each give the clean run's tokens
under the table; and a reduced moonshot-v1-16b-a3b at capacity 64.0 with
a weights table serves the JAX engine's tokens.  Tokens are compared
exactly; the reference's weight-resident matmul runs its dequant-einsum
path (``REPRO_MX_MATMUL_IMPL=einsum``, bit-identical to its kernel at
these widths).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.spec import PolicyTable, QuantPolicy
from repro_torch.models import Model, apply_policy_table, load_reduced
from repro_torch.models.layers import kv_layer_view
from repro_torch.serve import (ContinuousBatchingEngine, GenerationConfig,
                               ServeEngine, capture, restore)
from repro_torch.serve.paging import kv_token_nbytes

torch.set_num_threads(1)

TABLE = "kv=int8@32:ocp", {1: "kv_key=e2m1@32:ocp,kv_value=e4m3@32:ocp"}
# weights and KV formats mixed across the two layers
MIXED = ("weights=e4m3@32:ocp,kv=int8@32:ocp",
         {1: "weights=e2m1@32:ocp,kv_key=e2m1@32:ocp,kv_value=e3m2@32:ocp"})
FP_AND_E2M1 = "none", {1: "kv=e2m1@32:ocp"}
LENS = [4, 9, 14, 9, 4]
NEW = 4
PAGE = 8
SLOTS = 2          # < len(LENS): admission and eviction on the path


@pytest.fixture(autouse=True)
def einsum_matmul(monkeypatch):
    monkeypatch.setenv("REPRO_MX_MATMUL_IMPL", "einsum")


def _cfg(table, arch="chatglm3_6b", **over):
    return apply_policy_table(load_reduced(arch, **over), PolicyTable(*table))


def _pair(table, arch="chatglm3_6b", quantize=False, **over):
    """(JAX model, JAX params, port model, port params) under ``table``:
    the same random weights, quantized per layer when ``quantize``."""
    import jax
    from repro.core import PolicyTable as JTable
    from repro.models import Model as JModel
    from repro.models import apply_policy_table as j_apply
    from repro.models import load_reduced as j_load_reduced
    from repro_torch.models.params import from_numpy
    from torch_parity import params_to_numpy
    jcfg = j_apply(j_load_reduced(arch, **over), JTable(*table))
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    if quantize:
        jp = jm.quantize_weights(jp)
    tcfg = _cfg(table, arch, **over)
    return jm, jp, Model(tcfg, device="cpu"), from_numpy(
        params_to_numpy(jp), tcfg, "cpu")


def _prompts(vocab, lens=LENS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def _serve_paged(model, params, prompts, **kw):
    eng = ContinuousBatchingEngine(
        model, params, max_slots=SLOTS, page_size=PAGE,
        max_len=max(map(len, prompts)) + NEW + 1,
        gen=GenerationConfig(max_new_tokens=NEW), **kw)
    rids = [eng.add_request(p, NEW) for p in prompts]
    out = eng.run()
    return eng, [out[r].tolist() for r in rids]


def _jax_paged(jm, jp, prompts):
    from repro.serve import ContinuousBatchingEngine as JEngine
    from repro.serve import GenerationConfig as JGen
    eng = JEngine(jm, jp, max_slots=SLOTS, page_size=PAGE,
                  max_len=max(map(len, prompts)) + NEW + 1, sync_every=1,
                  health_checks=False, gen=JGen(max_new_tokens=NEW))
    rids = [eng.add_request(p, NEW) for p in prompts]
    out = eng.run()
    return eng, [np.asarray(out[r]).tolist() for r in rids]


@pytest.fixture(scope="module")
def table_pair():
    return _pair(TABLE)


@pytest.fixture(scope="module")
def jax_table_run(table_pair):
    jm, jp, tm, tp = table_pair
    return _jax_paged(jm, jp, _prompts(tm.cfg.vocab))


# =============================================================================
# the reference's six cases
# =============================================================================
@pytest.mark.parametrize("table", [TABLE, FP_AND_E2M1],
                         ids=["int8-e2m1-e4m3", "fp-and-e2m1"])
def test_per_layer_table_dense_matches_flash_kernel(table):
    """Different KV specs per layer (fp pages beside packed E2M1 in the
    second case): the dense path and the decode kernels' path give the
    same tokens."""
    cfg = _cfg(table)
    model = Model(cfg, device="cpu")
    params = model.init(seed=0)
    prompts = _prompts(cfg.vocab)
    _, dense = _serve_paged(model, params, prompts)
    flash = Model(dataclasses.replace(cfg, attn_impl="flash"), device="cpu")
    _, got = _serve_paged(flash, params, prompts)
    assert got == dense


def test_per_layer_table_matches_solo_contiguous(table_pair):
    """Continuous serving under the table == each request served alone
    through the static engine's per-layer contiguous cache."""
    _, _, tm, tp = table_pair
    prompts = _prompts(tm.cfg.vocab)
    _, paged = _serve_paged(tm, tp, prompts)
    solos = {}
    for p, got in zip(prompts, paged):
        n = p.shape[0]
        if n not in solos:
            solos[n] = ServeEngine(tm, tp, max_len=n + NEW + 2)
        ref = solos[n].generate({"tokens": p[None, :]},
                                GenerationConfig(max_new_tokens=NEW))[0]
        assert got == ref.tolist()


def test_per_layer_pool_sized_per_layer():
    """Layer 0's INT8 key pages are twice the bytes of layer 1's packed
    E2M1 ones; value pages per their own specs; scales alike."""
    cfg = _cfg(TABLE)
    pool = Model(cfg, device="cpu").init_paged_cache(8, PAGE)
    l0, l1 = (kv_layer_view(pool, cfg, i) for i in range(2))
    assert l0["kc_pages"].shape[-1] == 32         # int8: 1 B per element
    assert l1["kc_pages"].shape[-1] == 16         # e2m1 packed
    assert l1["vc_pages"].shape[-1] == 32         # e4m3: 1 B per element
    assert l0["ks_pages"].shape == l1["ks_pages"].shape
    assert sorted(pool) == ["kc_pages", "kc_pages.1", "ks_pages",
                            "ks_pages.1", "vc_pages", "vc_pages.1",
                            "vs_pages", "vs_pages.1"]


def test_engine_reports_per_layer_pool_bytes(table_pair, jax_table_run):
    """Fewer pool bytes than uniform INT8; the JAX pool's bytes, in all
    and layer by layer; each layer page_size x num_pages x its own
    kv_token_nbytes."""
    jm, jp, tm, tp = table_pair
    jeng, _ = jax_table_run
    eng, _ = _serve_paged(tm, tp, _prompts(tm.cfg.vocab))
    uni = Model(apply_policy_table(tm.cfg, PolicyTable("kv=int8@32:ocp")),
                device="cpu")
    eng_uni, _ = _serve_paged(uni, tp, _prompts(tm.cfg.vocab))
    assert 0 < eng.kv_pool_nbytes < eng_uni.kv_pool_nbytes
    assert eng.kv_pool_nbytes == jeng.kv_pool_nbytes
    jax_layers = [sum(np.asarray(x).nbytes for x in layer.values())
                  for layer in jeng.pool["layers"]]
    assert eng.kv_pool_layer_nbytes == jax_layers
    cfg = tm.cfg
    assert eng.kv_pool_layer_nbytes == [
        PAGE * eng.blocks.num_pages * kv_token_nbytes(
            cfg.layer_policy(i), cfg.n_kv_heads, cfg.hd, 4)
        for i in range(cfg.n_layers)]


def test_identical_table_collapses_bit_identical():
    """An all-layers-identical table is the uniform QuantPolicy: the same
    config, the same tokens and pool bytes."""
    uniform = QuantPolicy.parse("kv=int8@32:ocp")
    collapsed = apply_policy_table(
        load_reduced("chatglm3_6b"),
        PolicyTable(uniform, {0: uniform, 1: uniform}))
    direct = load_reduced("chatglm3_6b", mx=uniform)
    assert collapsed == direct and collapsed.mx_table is None
    model = Model(direct, device="cpu")
    params = model.init(seed=0)
    prompts = _prompts(direct.vocab)
    ea, a = _serve_paged(Model(collapsed, device="cpu"), params, prompts)
    eb, b = _serve_paged(model, params, prompts)
    assert a == b and ea.kv_pool_nbytes == eb.kv_pool_nbytes
    assert sorted(ea.pool) == ["kc_pages", "ks_pages", "vc_pages",
                               "vs_pages"]


def test_mixed_quantized_and_fp_layers_serve():
    """fp pages on layer 0 beside packed E2M1 pages on layer 1, the JAX
    engine's tokens."""
    jm, jp, tm, tp = _pair(FP_AND_E2M1)
    pool = tm.init_paged_cache(8, PAGE)
    assert "k_pages" in kv_layer_view(pool, tm.cfg, 0)
    assert "kc_pages" in kv_layer_view(pool, tm.cfg, 1)
    prompts = _prompts(tm.cfg.vocab)
    _, got = _serve_paged(tm, tp, prompts)
    _, want = _jax_paged(jm, jp, prompts)
    assert got == want


# =============================================================================
# against the JAX engines
# =============================================================================
def test_table_tokens_match_jax_engine(table_pair, jax_table_run):
    _, _, tm, tp = table_pair
    _, want = jax_table_run
    _, got = _serve_paged(tm, tp, _prompts(tm.cfg.vocab))
    assert got == want


@pytest.fixture(scope="module")
def mixed_pair():
    return _pair(MIXED, quantize=True)


def test_mixed_weights_and_kv_continuous_match_jax(mixed_pair):
    """Weight-resident, each layer at its own weight format (e4m3 and
    packed e2m1) beside its own KV formats: the JAX engine's tokens."""
    jm, jp, tm, tp = mixed_pair
    w0, w1 = (tp["layers"][i]["mlp"]["w1"] for i in range(2))
    assert (w0.fmt, w1.fmt, w1.packed) == ("e4m3", "e2m1", True)
    prompts = _prompts(tm.cfg.vocab)
    jeng, want = _jax_paged(jm, jp, prompts)
    eng, got = _serve_paged(tm, tp, prompts)
    assert got == want
    assert eng.kv_pool_nbytes == jeng.kv_pool_nbytes
    assert eng.weight_pool_nbytes == jeng.weight_pool_nbytes


def test_mixed_weights_and_kv_static_match_jax(mixed_pair):
    from repro.serve import GenerationConfig as JGen
    from repro.serve import ServeEngine as JServe
    jm, jp, tm, tp = mixed_pair
    tokens = np.stack(_prompts(tm.cfg.vocab, lens=[12, 12, 12]))
    want = JServe(jm, jp, max_len=12 + NEW + 2).generate(
        {"tokens": tokens}, JGen(max_new_tokens=NEW))
    got = ServeEngine(tm, tp, max_len=12 + NEW + 2).generate(
        {"tokens": tokens}, GenerationConfig(max_new_tokens=NEW))
    np.testing.assert_array_equal(got, np.asarray(want))


def test_moe_weights_table_matches_jax():
    """Reduced moonshot-v1-16b-a3b at the no-drop capacity factor 64.0,
    its dense layer at e4m3 weights and INT8 KV, its MoE layer's expert
    stacks at packed e2m3 beside E2M1 values."""
    table = ("weights=e4m3@32:ocp,kv=int8@32:ocp",
             {1: "weights=e2m3@32:ocp,kv_key=int8@32:ocp,"
                 "kv_value=e2m1@32:ocp"})
    jm, jp, tm, tp = _pair(table, "moonshot_v1_16b_a3b", quantize=True,
                           capacity_factor=64.0)
    experts = tp["layers"][1]["moe"]["experts"]["w1"]
    assert experts.fmt == "e2m3" and experts.codes.dim() == 3
    prompts = _prompts(tm.cfg.vocab)
    _, want = _jax_paged(jm, jp, prompts)
    _, got = _serve_paged(tm, tp, prompts)
    assert got == want


# =============================================================================
# the serving stack under the table: the clean run's tokens
# =============================================================================
@pytest.fixture(scope="module")
def mixed_clean(mixed_pair):
    _, _, tm, tp = mixed_pair
    prompts = _prompts(tm.cfg.vocab)
    return prompts, _serve_paged(tm, tp, prompts)[1]


def test_prefix_cache_under_table(mixed_pair):
    """Prompts sharing two full pages: the cache on gives the tokens of
    the cache off, with hits."""
    _, _, tm, tp = mixed_pair
    rng = np.random.default_rng(4)
    shared = rng.integers(0, tm.cfg.vocab, size=2 * PAGE).astype(np.int32)
    prompts = [np.concatenate([shared, p]) for p in
               _prompts(tm.cfg.vocab, lens=[3, 6, 5, 9])]
    _, off = _serve_paged(tm, tp, prompts)
    eng, on = _serve_paged(tm, tp, prompts, prefix_cache=True)
    assert on == off and eng.prefix.hits > 0


def test_preempt_and_swap_under_table(mixed_pair):
    """A batch request swapped out for an interactive one over a tight
    pool (its per-layer packed pages to the host and back) gives the
    tokens of a pool large enough for both."""
    _, _, tm, tp = mixed_pair
    rng = np.random.default_rng(3)
    pb = rng.integers(1, tm.cfg.vocab, size=9).astype(np.int32)
    pa = rng.integers(1, tm.cfg.vocab, size=17).astype(np.int32)

    def script(num_pages):
        eng = ContinuousBatchingEngine(
            tm, tp, max_slots=2, page_size=PAGE, max_len=30,
            num_pages=num_pages, sync_every=4, preempt=True)
        rb = eng.add_request(pb, 20, priority=1)
        req = next(r for r in eng.scheduler.waiting if r.rid == rb)
        while len(req.out) < 5:
            eng.step()
        ra = eng.add_request(pa, 4, priority=0, deadline_s=1.0)
        out = eng.run()
        return eng, [out[r].tolist() for r in (rb, ra)]

    tight, got = script(6)
    assert tight.n_preemptions >= 1
    assert tight.swap_store.bytes_in == tight.swap_store.bytes_out > 0
    _, want = script(32)
    assert got == want


def test_snapshot_restore_under_table(mixed_pair, mixed_clean):
    """A snapshot mid-stream, two steps past it, then a restore: the
    clean run's tokens, the pool's grouped leaves written in place."""
    _, _, tm, tp = mixed_pair
    prompts, want = mixed_clean
    eng = ContinuousBatchingEngine(
        tm, tp, max_slots=SLOTS, page_size=PAGE,
        max_len=max(map(len, prompts)) + NEW + 1, sync_every=1,
        gen=GenerationConfig(max_new_tokens=NEW))
    ptrs = {k: v.data_ptr() for k, v in eng.pool.items()}
    rids = [eng.add_request(p, NEW) for p in prompts]
    eng.step()
    snap = capture(eng)
    assert snap.nbytes == eng.kv_pool_nbytes
    eng.step()
    eng.step()
    restore(eng, snap)
    assert {k: v.data_ptr() for k, v in eng.pool.items()} == ptrs
    eng.run()
    done = {r.rid: list(r.out) for r in eng.scheduler.finished}
    assert [done[r] for r in rids] == want


# =============================================================================
# the launcher's --quant auto:<budget> / --save-policy / --policy-json
# =============================================================================
def test_launcher_auto_policy_round_trip(tmp_path, capsys):
    """Calibrate, search and serve; the saved table served again gives the
    same sample tokens; the flags' exclusions are the reference's."""
    from repro_torch.launch.serve import main
    path = tmp_path / "policy.json"
    common = ["--arch", "chatglm3_6b", "--reduced", "--device", "cpu",
              "--paged", "--batch", "2", "--requests", "3",
              "--new-tokens", "4", "--prompt-len", "12"]
    main(common + ["--quant", "auto:200", "--calib-batches", "2",
                   "--save-policy", str(path)])
    first = capsys.readouterr().out
    table = PolicyTable.from_json(path.read_text())
    assert "auto policy: 200B used of 200B budget" in first
    assert "KV cache: 200 B/token across 2 layers" in first
    main(common + ["--policy-json", str(path)])
    second = capsys.readouterr().out
    assert f"policy table from {path}: {table.default}" in second

    def sample(out):
        return [ln for ln in out.splitlines() if "sample tokens" in ln]
    assert sample(first) == sample(second) != []
    for bad, msg in (
            (["--policy-json", str(path), "--quant", "kv=int8@32:ocp"],
             "mutually exclusive"),
            (["--quant", "auto:0"], "auto budget must be positive"),
            (["--quant", "auto:200", "--weight-resident"],
             "needs a 'weights' role")):
        with pytest.raises(SystemExit):
            main(common + bad)
        assert msg in capsys.readouterr().err
