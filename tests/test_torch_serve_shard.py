"""Sharded serving of the port on CPU gloo ranks against the JAX package.

The reduced chatglm3 serves through the port's sharded engines on
(data, model) meshes of spawned gloo ranks (``torch_dist.run_ranks``,
one spawn per mesh): (1, 2), (1, 4), where the model axis does not
divide the 2 KV heads and every rank keeps them all (the kernels'
first-head route), and (2, 2), where the decode slots also split over
the data ranks; ``--shard-pool`` shards the page pool over the data
axis at (2, 1); the reduced moonshot serves expert-parallel at (1, 2).
Every rank's greedy tokens must equal the JAX package's single-device
engine's (the reference's own sharded tests fail under this jax,
ROADMAP C3) and the port's unsharded engine's.  Row-parallel sums
reorder f32 additions, so a flip would be allowed only at a near tie
(top-2 logit gap below 1e-4); none occurs here.  Weights are the
reference's, converted byte for byte (``from_numpy``) and placed on
each rank by ``shard_params``; the reference's weight-resident matmul
runs its dequant-einsum path, bit-identical to its kernel here.

Also: the placement (each rank holds only its shard; slices of an
``MXWeight`` are the codes and scales of quantizing the slice, bit for
bit; the reference's row-parallel divisibility error) and the
launcher's ``--shard --devices 2``.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import Model as JModel
from repro.models import load_reduced as j_load_reduced
from repro.models.config import QuantPolicy as JPolicy
from repro.serve import ContinuousBatchingEngine as JEngine
from repro.serve import GenerationConfig as JGen
from repro.serve import ServeEngine as JServe
from repro_torch.core import MXWeight
from repro_torch.core.spec import QuantSpec
from repro_torch.dist.sharding import shard_leaf
from repro_torch.models.layers import dense
from repro_torch.models.params import from_numpy
from torch_dist import ROOT, run_ranks
from torch_parity import params_to_numpy
import torch_shard

torch.set_num_threads(1)

POLICY = "weights=e4m3@32:ocp,kv=int8@32:ocp"
LENS = [4, 9, 14, 4, 9, 14, 9, 4]
NEW = 4
KW = dict(max_slots=4, page_size=8, max_len=max(LENS) + NEW + 1,
          sync_every=4)
STATIC = (4, 12, 5)                  # rows, prompt length, new tokens
AXES = ("data", "model")


def _prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in LENS]


def _jax(arch):
    jm = JModel(j_load_reduced(arch, mx=JPolicy.parse(POLICY),
                               attn_impl="flash"))
    jp = jax.jit(jm.quantize_weights)(jm.init(jax.random.PRNGKey(0)))
    return jm, jp


_CACHE = {}


def _reference(arch):
    """The JAX engines' single-device tokens, the port's unsharded ones,
    and the converted weights."""
    if arch not in _CACHE:
        os.environ["REPRO_MX_MATMUL_IMPL"] = "einsum"
        jm, jp = _jax(arch)
        prompts = _prompts(jm.cfg.vocab)
        kw = {k: v for k, v in KW.items() if k != "sync_every"}
        jeng = JEngine(jm, jp, sync_every=1, health_checks=False, **kw)
        rids = [jeng.add_request(p, NEW) for p in prompts]
        jout = jeng.run()
        want = [jout[r].tolist() for r in rids]
        b, s, new = STATIC
        toks = np.random.default_rng(3).integers(
            0, jm.cfg.vocab, size=(b, s)).astype(np.int32)
        jstatic = np.asarray(JServe(jm, jp, max_len=s + new + 4).generate(
            {"tokens": jnp.asarray(toks)},
            JGen(max_new_tokens=new))).tolist() if arch == "chatglm3_6b" \
            else None
        np_params = params_to_numpy(jp)
        model = torch_shard.model_of(arch, POLICY)
        tp = from_numpy(np_params, model.cfg, "cpu")
        port, _ = torch_shard.serve_continuous(model, tp, prompts, NEW,
                                               **KW)
        pstatic, _ = torch_shard.serve_static(model, tp, toks, new,
                                              s + new + 4)
        _CACHE[arch] = dict(want=want, port=port, jstatic=jstatic,
                            pstatic=pstatic, params=np_params,
                            prompts=prompts, toks=toks)
    return _CACHE[arch]


def _continuous_job(arch, pool=False):
    ref = _reference(arch)
    return dict(arch=arch, policy=POLICY, kind="continuous",
                params=ref["params"], prompts=ref["prompts"], new=NEW,
                kw=KW, pool=pool)


_RUNS = {}


def _sharded(sizes, pool=False):
    """One spawn per mesh: every job of that mesh on its ranks."""
    key = (sizes, pool)
    if key not in _RUNS:
        jobs = [_continuous_job("chatglm3_6b", pool)]
        if sizes == (1, 2) and not pool:
            b, s, new = STATIC
            ref = _reference("chatglm3_6b")
            jobs.append(dict(arch="chatglm3_6b", policy=POLICY,
                             kind="static", params=ref["params"],
                             tokens=ref["toks"], new=new,
                             max_len=s + new + 4))
            jobs.append(_continuous_job("moonshot_v1_16b_a3b"))
            jobs.append(dict(kind="rowsum"))
        import tempfile
        _RUNS[key] = run_ranks(torch_shard.serve_jobs, sizes,
                               tempfile.mkdtemp(), jobs, axes=AXES,
                               timeout=240)
    return _RUNS[key]


@pytest.mark.parametrize("sizes", [(1, 2), (1, 4), (2, 2)])
def test_sharded_continuous_matches_jax_and_unsharded(sizes):
    ref = _reference("chatglm3_6b")
    assert ref["port"] == ref["want"]
    for rank, res in enumerate(_sharded(sizes)):
        assert res[0]["tokens"] == ref["want"], f"rank {rank}"
        assert not res[0]["captures"]          # the CPU captures nothing
        # every decode step of every layer through the paged kernel's
        # wrapper (its plain version on the CPU)
        assert res[0]["paged_attention_calls"] \
            == res[0]["n_layers"] * res[0]["decode_steps"] > 0


def test_replicated_kv_heads_at_model_4():
    """At model 4 the 2 KV heads stay whole on every rank (the q heads
    split, 1 per rank: the first-head route); at model 2 each rank keeps
    its own KV head."""
    assert {r[0]["kv_heads"] for r in _sharded((1, 4))} == {2}
    assert {r[0]["kv_heads"] for r in _sharded((1, 2))} == {1}


def test_ranks_hold_only_their_shard():
    """The decode posture: weights split over "model", whole over "data"
    (the norms, the router and other undivided dims stay whole)."""
    for sizes, parts in (((1, 2), 2), ((1, 4), 4), ((2, 2), 2)):
        for res in _sharded(sizes):
            w, whole = res[0]["weight_bytes"], res[0]["whole_bytes"]
            assert whole / parts <= w < whole / parts * 1.05, (sizes, w)


def test_sharded_static_engine_matches_jax():
    ref = _reference("chatglm3_6b")
    assert ref["pstatic"] == ref["jstatic"]
    for res in _sharded((1, 2)):
        assert res[1]["tokens"] == ref["jstatic"]


def test_moe_expert_parallel_matches_jax():
    ref = _reference("moonshot_v1_16b_a3b")
    assert ref["port"] == ref["want"]
    for res in _sharded((1, 2)):
        assert res[2]["tokens"] == ref["want"]
        # 8 experts over 2 ranks: each holds 4 of every stack
        assert res[2]["weight_bytes"] < 0.55 * res[2]["whole_bytes"]


def test_shard_pool_over_data():
    """--shard-pool at (2, 1): each data rank holds its run of the pages
    (half the pool, plus its own trash page) and serves its slots."""
    ref = _reference("chatglm3_6b")
    runs = _sharded((2, 1), pool=True)
    pages = 1 + KW["max_slots"] * -(-KW["max_len"] // KW["page_size"])
    for res in runs:
        assert res[0]["tokens"] == ref["want"]
        assert res[0]["pool_pages"] == (pages + 1) // 2
        # the paged kernel reads the rank's own pool: no gather route
        assert res[0]["paged_attention_calls"] \
            == res[0]["n_layers"] * res[0]["decode_steps"] > 0


def test_row_parallel_sum_in_f32_before_the_cast():
    """bf16 activations over a row-parallel MX weight at (1, 2): the f32
    partials are summed before the cast, so the bf16 outputs differ from
    the whole weight's only where reordered f32 sums straddle a bf16
    rounding boundary; summing partials already cast to bf16 would
    differ in a large share."""
    for res in _sharded((1, 2)):
        ctl = res[3]
        assert ctl["mismatch"] <= 0.01, ctl
        assert ctl["fault_mismatch"] >= 0.1, ctl


def test_ranks_identical():
    for sizes in ((1, 2), (1, 4), (2, 2)):
        runs = _sharded(sizes)
        assert all(r[0]["tokens"] == runs[0][0]["tokens"] for r in runs)


class _Mesh:
    """A placement-only mesh: axis sizes and this rank's coordinates."""

    def __init__(self, coords, sizes):
        self.coords, self.shape = coords, sizes
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


SPEC = QuantSpec("e4m3", "ocp", 32, True)


@pytest.mark.parametrize("spec", ["e4m3@32:ocp", "e2m1@32:ocp",
                                  "e3m2@32:paper"])
def test_shard_sliced_mx_equals_shard_quantized(spec):
    """A rank's slice of a quantized weight is the quantization of the
    weight's slice, codes (bit-packed too) and scales bit for bit:
    column shards (N), row shards (K, block aligned) and expert stacks."""
    spec = QuantSpec.parse(spec)
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.normal(size=(256, 96)).astype(np.float32))
    e = torch.from_numpy(rng.normal(size=(4, 128, 64)).astype(np.float32))
    full, stack = MXWeight.quantize(w, spec), MXWeight.quantize(e, spec)
    for m in range(2):
        mesh = _Mesh({"model": m}, {"data": 1, "model": 2})
        cases = [(full, ("data", "model"), w[:, 48 * m:48 * (m + 1)]),
                 (full, ("model", "data"), w[128 * m:128 * (m + 1)]),
                 (stack, ("model", "data", None), e[2 * m:2 * (m + 1)])]
        for mw, sp, piece in cases:
            got = shard_leaf(mw, sp, mesh)
            want = MXWeight.quantize(piece, spec)
            assert torch.equal(got.codes, want.codes)
            assert torch.equal(got.scales, want.scales)
            assert (got.k, got.n) == (want.k, want.n)


def test_row_parallel_mx_gather_divisibility():
    """The reference test's cases: K=32 (K//block=1) over a model axis
    of 2 refuses with the reference's message, for the placement and so
    for serving; K=128 shards and the row-parallel dense over the two
    shards sums to the unsharded dequant matmul."""
    rng = np.random.default_rng(0)
    mesh = _Mesh({"model": 0}, {"data": 2, "model": 2})
    bad = MXWeight.quantize(torch.from_numpy(
        rng.normal(size=(32, 16)).astype(np.float32)), SPEC)
    with pytest.raises(ValueError) as e:
        shard_leaf(bad, ("model", "data"), mesh)
    assert "K//block=1" in str(e.value) and "size 2" in str(e.value)
    w_ok = torch.from_numpy(
        rng.normal(size=(128, 16)).astype(np.float32) * 0.05)
    x = torch.from_numpy(rng.normal(size=(2, 128)).astype(np.float32))
    mxw = MXWeight.quantize(w_ok, SPEC)
    parts = []
    for m in range(2):
        piece = shard_leaf(mxw, ("model", "data"),
                           _Mesh({"model": m}, {"data": 2, "model": 2}))
        parts.append(dense(x[:, 64 * m:64 * (m + 1)], piece))
    ref = x @ mxw.dequantize()
    np.testing.assert_allclose((parts[0] + parts[1]).numpy(), ref.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_launcher_shard_devices_2():
    """``--shard --devices 2`` on the CPU: two gloo ranks on the (1, 2)
    test mesh, the same sample tokens as the unsharded command, the ranks
    identical; another family is refused by name."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "chatglm3_6b", "--reduced", "--device", "cpu", "--paged",
           "--weight-resident", "--batch", "2", "--requests", "3",
           "--prompt-len", "12", "--new-tokens", "3", "--quant", POLICY]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def run(extra):
        p = subprocess.run(cmd + extra, env=env, capture_output=True,
                           text=True, timeout=240)
        assert p.returncode == 0, p.stderr[-3000:]
        return p.stdout

    single, sharded = run([]), run(["--shard", "--devices", "2"])
    sample = [ln for ln in single.splitlines() if "sample tokens" in ln]
    assert sample and sample[0] in sharded
    assert "ranks identical: True" in sharded
    assert "sharded over mesh {'data': 1, 'model': 2}" in sharded
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "zamba2_1p2b", "--reduced", "--device", "cpu", "--shard",
         "--devices", "2"], env=env, capture_output=True, text=True,
        timeout=120)
    assert p.returncode != 0 and "ROADMAP A11.2" in p.stderr


def test_elastic_restore_across_mesh_shapes(tmp_path):
    """The reference's elastic restore: saved from ranks of a ("data",)
    mesh of 2, restored onto a (data, model) mesh of (2, 2) with the leaf
    spec ("model", "data"): every rank holds the saved array's slice."""
    x = np.arange(64, dtype=np.float32).reshape(8, 8)
    d = str(tmp_path / "ck")
    run_ranks(torch_shard.save_rank, (2,), tmp_path, d, 3, x)
    out = run_ranks(torch_shard.restore_rank, (2, 2), tmp_path, d, 3, x,
                    axes=AXES)
    for shard, di, mi, meta in out:
        np.testing.assert_array_equal(
            shard.numpy(), x[4 * mi:4 * (mi + 1), 4 * di:4 * (di + 1)])
        assert meta == {"mesh": [2]}
