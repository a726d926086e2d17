"""The port's sharded training (FSDP x TP: ``launch.cells.build_cell``'s
train cell, ``train.step.build_train_step`` under a mesh) on gloo ranks
on the CPU, against the JAX package's single-device
``build_train_step`` on the same numpy params and batches.

Reduced chatglm3-6b, f32, batches of 8 x 32 from ``SyntheticLM``, from
the reference's params and random moments (``torch_parity.
random_moments``), steps 6 and 7 (lr past warm-up), at (data, model) =
(2, 1), (1, 2), (2, 2) and (pod, data, model) = (2, 1, 2), under
"baseline" and "paper" (QAT: the weights fake-quantized on the gathered
shard).  Tolerances, those of ``test_torch_train_dp.py``:

* ``loss``, ``ce``, ``grad_norm`` and ``lr`` within rtol 1e-5;
* every rank's params and ``master`` / ``m`` / ``v`` shards, gathered,
  within rtol 2e-3, atol 2e-5 after each step.

Also: ranks holding the same chunk of a leaf bit-identical and every
rank the same metrics; a mesh of one equal to the unsharded port step
bit for bit; remat (the recompute gathers again) at (2, 2); one bf16
case with ``bf16_matmul_out`` against the unsharded bf16 step (stated
tolerance ``BF16_TOL``); the control without the column-parallel
input's backward sum failing the gradient check; the "optimized" prefill
cell at (2, 2) against the JAX package's single-device prefill; the
FSDP-gathered ``MXArray`` / ``MXWeight`` in ``dense(tp="row")`` (the
reference's ``test_row_parallel_mx_gather_divisibility``, which cannot
run on this jax); the sharded state saved from (2, 2) and restored at
(1, 2) and unsharded; the refusals naming ROADMAP A11.2, among them QAT
on a row-parallel K shard that is no block multiple (``QAT_D_FF``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.cells import variant_config as j_variant_config
from repro.models import Model as JModel
from repro.models import load_reduced as j_load_reduced
from repro.optim import AdamWConfig as JAdamWConfig
from repro.train import build_train_step as j_build_train_step
from repro.train import init_train_state as j_init_train_state
from repro_torch.data import DataConfig, SyntheticLM, make_batch_for
from repro_torch.dist import world_one
from repro_torch.dist.sharding import A11_2, shard_params
from repro_torch.launch.cells import build_cell, variant_config
from repro_torch.models.config import ShapeSpec
from repro_torch.models.params import from_numpy, opt_state_from_numpy
from repro_torch.optim import AdamWConfig
from repro_torch.train import build_train_step
from repro_torch.tree import leaves, leaves_with_path, path_key, tree_map
from torch_dist import run_ranks
from torch_parity import params_to_numpy, random_moments
from torch_shard import train_jobs

torch.set_num_threads(1)
OPT = dict(lr=2e-3, warmup_steps=5, total_steps=25)
B, S = 8, 32
STEPS = (6, 7)
VARIANTS = ("baseline", "paper")
MESHES = {"2x1": ((2, 1), ("data", "model")),
          "1x2": ((1, 2), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
METRICS = ("loss", "ce", "grad_norm", "lr")
# bf16 (reduced chatglm3 in bf16, bf16_matmul_out at (2, 2)) against the
# unsharded bf16 step: the row-parallel sums round each rank's partials
# to bf16 before adding them; measured after one step: loss 1.4e-4,
# grad norm 3.4e-4, masters 1.1e-4 of their leaf's largest value
BF16_TOL = 1e-2
PREFILL_ATOL = 1e-4     # f32 prefill logits against the reference's
#                         (measured 3.3e-6)
CODES_DIFFER = 1e-3     # share of KV-cache codes that may take a
#                         neighbouring code (an f32 value at a rounding
#                         boundary, sums in another order; measured 0 of
#                         25,344)


def _tcfg(variant):
    return variant_config("chatglm3_6b", variant, reduced=True)


def _batches(cfg):
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B,
                                  seed=3))
    return {i: {k: v.numpy() for k, v in make_batch_for(
        cfg, data.batch(i), device="cpu").items()} for i in STEPS}


@pytest.fixture(scope="module")
def reference():
    """The reference's start state and, per variant and step, its metrics
    and state after the step (single device, jitted)."""
    out = {}
    for variant in VARIANTS:
        cfg = j_load_reduced("chatglm3_6b",
                             mx=j_variant_config("chatglm3_6b", variant).mx)
        model = JModel(cfg)
        params, opt = j_init_train_state(model, jax.random.PRNGKey(0))
        opt = random_moments(opt)
        out[variant, "start"] = (params_to_numpy(params),
                                 params_to_numpy(opt))
        step = jax.jit(j_build_train_step(
            model, JAdamWConfig(**OPT), fake_quant=variant != "baseline"))
        batches = _batches(_tcfg(variant))
        for i in STEPS:
            batch = {k: jnp.asarray(v) for k, v in batches[i].items()}
            params, opt, met = step(params, opt, batch, jnp.asarray(i))
            out[variant, i, "met"] = {k: float(v) for k, v in met.items()}
            out[variant, i, "state"] = (params_to_numpy(params),
                                        params_to_numpy(opt))
        out[variant, "batches"] = batches
    return out


def _job(reference, variant, **kw):
    start = reference[variant, "start"]
    job = dict(kind="train", variant=variant, shape=(B, S),
               params=start[0], opt=start[1], steps=list(STEPS),
               batches=reference[variant, "batches"], opt_kw=OPT)
    job.update(kw)
    return job


def _run(name, tmp, jobs):
    sizes, axes = MESHES[name]
    return run_ranks(train_jobs, sizes, tmp, jobs, axes=axes, timeout=300)


@pytest.fixture(scope="module")
def port_2x2(reference, tmp_path_factory):
    """The (2, 2) ranks: both variants, remat, the control, a bf16 run,
    the prefill cell, the MX gathers, and the state saved."""
    ckpt = tmp_path_factory.mktemp("ckpt")
    rng = np.random.default_rng(1)
    cfg = _tcfg("optimized")
    prefill_batch = {"tokens": rng.integers(0, cfg.vocab, size=(4, 24))
                     .astype(np.int32)}
    bf16 = dict(dtype="bfloat16", param_dtype="bfloat16")
    jobs = [_job(reference, v) for v in VARIANTS]
    jobs += [_job(reference, "baseline", overrides=dict(remat=True)),
             _job(reference, "baseline", control=True, steps=[6]),
             dict(_job(reference, "baseline"), variant="optimized",
                  overrides=bf16, steps=[6]),
             dict(kind="prefill", variant="optimized", shape=(4, 24),
                  params=reference["baseline", "start"][0],
                  batch=prefill_batch),
             dict(kind="mx_gather"),
             _job(reference, "paper", steps=[6], save=str(ckpt))]
    res = _run("2x2", tmp_path_factory.mktemp("ranks"), jobs)
    return {"res": res, "ckpt": str(ckpt), "prefill_batch": prefill_batch}


# reduced chatglm3 at d_ff 208: w2's K shard at model 2 is 104 rows, 3.25
# blocks of 32 (the full width's 13,696 at model 8 is 1,712, 53.5 blocks)
QAT_D_FF = 208


@pytest.fixture(scope="module")
def port(reference, port_2x2, tmp_path_factory):
    """Each mesh's ranks' train jobs (both variants), (1, 2) also the
    restore of the (2, 2) state and a step at ``QAT_D_FF`` per variant."""
    out = {"2x2": [r[:2] for r in port_2x2["res"]]}
    for name in ("2x1", "1x2", "2x1x2"):
        jobs = [_job(reference, v) for v in VARIANTS]
        if name == "1x2":
            jobs.append(dict(kind="restore", variant="paper", shape=(B, S),
                             dir=port_2x2["ckpt"], step=6))
            jobs += [dict(kind="qat_shard", variant=v, shape=(2, 16),
                          d_ff=QAT_D_FF) for v in VARIANTS]
        res = _run(name, tmp_path_factory.mktemp("ranks"), jobs)
        out[name] = [r[:2] for r in res]
        if name == "1x2":
            out["restore"] = [r[2] for r in res]
            out["qat_shard"] = [dict(zip(VARIANTS, r[3:])) for r in res]
    return out


def _assert_state(have, want_np, cfg, err=""):
    """Params, master, m and v within the module's tolerances."""
    wp, wo = want_np
    want = {"params": from_numpy(wp, cfg, "cpu"),
            **opt_state_from_numpy(wo, cfg, "cpu")}
    have = {"params": have[0], **have[1]}
    for k in ("params", "master", "m", "v"):
        for (pg, g), (pw, w) in zip(leaves_with_path(have[k]),
                                    leaves_with_path(want[k])):
            assert pg == pw
            np.testing.assert_allclose(
                g.float().numpy(), w.float().numpy(), rtol=2e-3, atol=2e-5,
                err_msg=f"{err}{k} {path_key(pg)}")


def _cases():
    return [(m, v, i) for m in MESHES for v in VARIANTS for i in STEPS]


@pytest.mark.parametrize("mesh,variant,i", _cases())
def test_sharded_step_matches_reference(reference, port, mesh, variant, i):
    """Metrics and every gathered leaf of params and AdamW state after
    the step against the reference's single-device step."""
    got = port[mesh][0][VARIANTS.index(variant)]
    for k in METRICS:
        np.testing.assert_allclose(got["met"][i][k],
                                   reference[variant, i, "met"][k],
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    _assert_state(got["whole"][i], reference[variant, i, "state"],
                  _tcfg(variant))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_ranks_holding_a_chunk_agree(port, mesh):
    """Every rank returns the same metrics, and ranks that hold the same
    chunk of a leaf (the norms everywhere; every leaf across "pod") end
    each step with identical bits."""
    for j in range(len(VARIANTS)):
        runs = [r[j] for r in port[mesh]]
        for i in STEPS:
            assert all(r["met"][i] == runs[0]["met"][i] for r in runs)
            shared = 0
            for leaf in range(len(runs[0]["keys"])):
                seen = {}
                for r in runs:
                    key = tuple(r["keys"][leaf])
                    assert seen.setdefault(key, r["digests"][i][leaf]) == \
                        r["digests"][i][leaf], (mesh, i, leaf)
                shared += len(seen) < len(runs)
            assert shared > 0


@pytest.mark.parametrize("variant", VARIANTS)
def test_world_one_is_the_unsharded_step(reference, variant):
    """The train cell on a mesh of one (rules installed, every axis of
    size 1) equals the port's unsharded ``build_train_step`` bit for
    bit."""
    cfg = _tcfg(variant)
    mesh = world_one(("data", "model"), "cpu")
    cell = build_cell("chatglm3_6b", ShapeSpec("t", S, B, "train"), mesh,
                      variant, device="cpu", reduced=True,
                      opt_cfg=AdamWConfig(**OPT))
    start = reference[variant, "start"]
    pa = shard_params(from_numpy(start[0], cfg, "cpu"), mesh, cell.rules)
    oa = opt_state_from_numpy(start[1], cfg, "cpu")
    pb, ob = tree_map(torch.clone, (pa, oa))
    step = build_train_step(cell.model, AdamWConfig(**OPT),
                            fake_quant=variant != "baseline")
    for i in STEPS:
        batch = {k: torch.from_numpy(v)
                 for k, v in reference[variant, "batches"][i].items()}
        pa, oa, ma = cell.fn(pa, oa, batch, i)
        pb, ob, mb = step(pb, ob, batch, i)
        assert {k: float(v) for k, v in ma.items()} == \
            {k: float(v) for k, v in mb.items()}
        assert all(torch.equal(x, y)
                   for x, y in zip(leaves((pa, oa)), leaves((pb, ob))))


def test_remat_recomputes_the_gathers(reference, port_2x2):
    """remat on: each layer's backward recomputes its forward, FSDP
    gathers included, on every rank alike; the step still matches."""
    got = port_2x2["res"][0][2]
    for i in STEPS:
        _assert_state(got["whole"][i], reference["baseline", i, "state"],
                      _tcfg("baseline"), "remat ")


def test_missing_backward_sum_fails_the_gradient_check(reference, port_2x2):
    """The control: without the column-parallel input's backward sum
    over "model" the step runs, and its gradients are wrong, which the
    state check catches (and the grad norm shows)."""
    got = port_2x2["res"][0][3]
    want = reference["baseline", 6, "met"]
    assert abs(got["met"][6]["grad_norm"] - want["grad_norm"]) \
        > 1e-2 * want["grad_norm"]
    with pytest.raises(AssertionError):
        _assert_state(got["whole"][6], reference["baseline", 6, "state"],
                      _tcfg("baseline"))


def test_bf16_matmul_out_within_bf16_tolerance(reference, port_2x2):
    """bf16 reduced chatglm3 under the optimized cell (flash,
    ``bf16_matmul_out``: the row-parallel partials summed in bf16) at
    (2, 2), one step, against the unsharded bf16 step of the same
    config: loss and grad norm within ``BF16_TOL`` relative, every
    master within ``BF16_TOL`` of its leaf's largest value."""
    got = port_2x2["res"][0][4]
    cfg = variant_config("chatglm3_6b", "optimized", reduced=True)
    import dataclasses
    cfg = dataclasses.replace(cfg, dtype="bfloat16", param_dtype="bfloat16")
    from repro_torch.models import Model
    model = Model(cfg, "cpu")
    start = reference["baseline", "start"]
    params = from_numpy(start[0], cfg, "cpu")
    opt = opt_state_from_numpy(start[1], cfg, "cpu")
    step = build_train_step(model, AdamWConfig(**OPT), fake_quant=True)
    batch = {k: torch.from_numpy(v)
             for k, v in reference["baseline", "batches"][6].items()}
    _, opt, met = step(params, opt, batch, 6)
    for k in ("loss", "grad_norm"):
        assert abs(got["met"][6][k] - float(met[k])) \
            <= BF16_TOL * abs(float(met[k])), k
    for (p, g), w in zip(leaves_with_path(got["whole"][6][1]["master"]),
                         leaves(opt["master"])):
        assert float((g - w).abs().max()) \
            <= BF16_TOL * float(w.abs().max()), path_key(p)


def test_prefill_cell_matches_reference(reference, port_2x2):
    """The "optimized" prefill cell at (2, 2) (FSDP-gathered weights,
    each rank its rows and KV head, MX INT8 KV): logits within
    ``PREFILL_ATOL`` of the JAX package's single-device prefill, and the
    KV-cache codes equal but for at most ``CODES_DIFFER`` of them."""
    batch = port_2x2["prefill_batch"]
    cfg = j_load_reduced("chatglm3_6b",
                         mx=j_variant_config("chatglm3_6b", "optimized").mx,
                         attn_impl="flash")
    jm = JModel(cfg)
    jp = jax.tree_util.tree_map(jnp.asarray,
                                reference["baseline", "start"][0])
    jlog, jc, _ = jm.prefill(jp, {"tokens": jnp.asarray(batch["tokens"])},
                             max_len=24)
    jlog, jc = np.asarray(jlog), {k: np.asarray(v)
                                  for k, v in jc["layers"].items()}
    differ = total = 0
    for r in port_2x2["res"]:
        got = r[5]
        d, m = got["coords"]["data"], got["coords"]["model"]
        rows = slice(2 * d, 2 * d + 2)
        np.testing.assert_allclose(got["logits"].numpy(), jlog[rows],
                                   atol=PREFILL_ATOL, rtol=0)
        for k, v in got["cache"].items():
            w = jc[k][:, rows, :, m:m + 1]
            assert v.shape == w.shape
            differ += int((v.numpy() != w).sum())
            total += v.numel()
    assert differ <= CODES_DIFFER * total, (differ, total)


def test_fsdp_gathered_mx_weights_in_row_dense(port_2x2):
    """``dense(tp="row")`` over FSDP-placed MX weights at (2, 2): K=128
    (K//block 4) matches the whole weight's dequant-matmul within 1e-5
    for an ``MXArray`` and an ``MXWeight``; K=32 (K//block 1) raises at
    the placement and at the use point, naming K//block=1 and size 2."""
    for r in port_2x2["res"]:
        got = r[6]
        assert max(got["errors"]) <= 1e-5, got["errors"]
        assert len(got["raised"]) == 4
        for msg in got["raised"]:
            assert msg is not None and "K//block=1" in msg \
                and "size 2" in msg, msg


def test_qat_refuses_a_k_shard_off_the_blocks(port):
    """Under QAT a row-parallel K shard that is no multiple of the block
    is refused on every rank, naming K, the block and the "model" size
    (its MX blocks would not be the whole weight's); the same step
    without QAT runs."""
    for r in port["qat_shard"]:
        assert r["baseline"] is None, r["baseline"]
        msg = r["paper"]
        assert msg is not None and f"K={QAT_D_FF}" in msg \
            and "block 32" in msg and "size 2" in msg \
            and A11_2 in msg, msg


def test_sharded_state_restores_elsewhere(reference, port, port_2x2):
    """The FSDP state (params, master / m / v) saved whole from (2, 2)
    restores onto (1, 2) (each rank its "model" chunk) and unsharded
    (``ckpt.restore``), bit for bit."""
    from repro_torch.ckpt import restore
    from repro_torch.models import Model
    whole = port_2x2["res"][0][7]["whole"][6]
    cfg = _tcfg("paper")
    like = Model(cfg, "cpu").init()
    like = {"params": like, "opt": {k: tree_map(lambda t: t.float(), like)
                                    for k in ("m", "master", "v")}}
    got, meta = restore(port_2x2["ckpt"], 6, like)
    assert meta == {"mesh": [2, 2]}
    want = {"params": whole[0], "opt": whole[1]}
    assert all(torch.equal(a, b) for a, b in zip(leaves(got), leaves(want)))
    for r in port["restore"]:
        mi = r["coords"]["model"]
        st = r["state"]
        wq = want["params"]["layers"][0]["attn"]["wq"]
        n = wq.shape[1] // 2
        assert torch.equal(st["params"]["layers"][0]["attn"]["wq"],
                           wq[:, mi * n:(mi + 1) * n])
        wo = want["opt"]["m"]["layers"][1]["attn"]["wo"]
        k = wo.shape[0] // 2
        assert torch.equal(st["opt"]["m"]["layers"][1]["attn"]["wo"],
                           wo[mi * k:(mi + 1) * k])
        assert torch.equal(st["params"]["norm_f"], want["params"]["norm_f"])
    # every leaf: the ranks' chunks put back together give the whole
    from repro_torch.launch.cells import shardings_for_params
    from repro_torch.launch.mesh import MeshShape
    sh = shardings_for_params(like["params"], MeshShape((1, 2),
                                                        ("data", "model")))
    specs = [s.spec for s in leaves({"params": sh,
                                     "opt": {k: sh for k in like["opt"]}})]
    ranks = sorted(port["restore"], key=lambda r: r["coords"]["model"])
    for j, (w, spec) in enumerate(zip(leaves(want), specs)):
        parts = [leaves(r["state"])[j] for r in ranks]
        dim = next((d for d, e in enumerate(spec) if e == "model"), None)
        joined = parts[0] if dim is None else torch.cat(parts, dim)
        assert torch.equal(joined, w), j


@pytest.mark.parametrize("arch", ["moonshot_v1_16b_a3b", "deepseek_v2_236b",
                                  "internvl2_76b", "zamba2_1p2b",
                                  "rwkv6_7b", "seamless_m4t_medium"])
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_other_families_refused(arch, kind):
    """The FSDP posture of the MoE layer and of the other five families
    raises, naming the ROADMAP item, before anything runs."""
    mesh = world_one(("data", "model"), "cpu")
    cell = build_cell(arch, ShapeSpec("t", S, B, kind), mesh, "baseline",
                      device="cpu", reduced=True)
    args = (None, None, None, 0) if kind == "train" else (None, None)
    with pytest.raises(NotImplementedError) as e:
        cell.fn(*args)
    assert A11_2 in str(e.value)


@pytest.mark.parametrize("arch,shape,variant",
                         [("zamba2_1p2b", "long_500k", "baseline"),
                          ("rwkv6_7b", "long_500k", "baseline"),
                          ("rwkv6_7b", "train_4k", "optimized")])
def test_seq_sharded_and_pure_fsdp_refused(arch, shape, variant):
    """``seq_sharded`` (long_500k decode) and ``pure_fsdp`` (RWKV training
    under "optimized") raise in ``make_rules``, naming the ROADMAP
    item."""
    with pytest.raises(NotImplementedError) as e:
        build_cell(arch, shape, world_one(("data", "model"), "cpu"),
                   variant, device="cpu")
    assert "A11.2: sharded training of MoE and the other families" \
        in str(e.value)
