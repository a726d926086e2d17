"""The port's compressed data-parallel train step
(``repro_torch.train.build_train_step_compressed_dp``) on gloo ranks on
the CPU, against the reference's on forced host devices, and the train
launcher's ``--compressed-dp --devices``.

Reduced chatglm3-6b, f32, ``remat=False``, batches of 8 x 32 from
``SyntheticLM``, the step from the reference's params and random moments
(``torch_parity.random_moments``: a first step from zero moments moves a
weight by lr times the sign of its gradient, which rounding noise can
flip), at steps 6 and 7 (lr past warm-up).  Tolerances, as
``test_torch_train.py``'s f32 ones:

* loss, ``ce``, ``aux``, ``grad_norm`` and ``lr`` within rtol 1e-5;
* params, ``master``, ``m`` and ``v`` after each step within rtol 2e-3,
  atol 2e-5;
* the exchanged gradients' codes that differ from the reference's are
  counted and printed (each side's exchange output at each step's start
  params, element by element), and held at most 1 in 10^4 of the
  exchanged elements (measured: 33 and 30 of 426,624 at steps 6 and 7,
  3 of 131,712 in the QAT step);
* every rank's params and AdamW state bit-identical after each step;
* a world of one equals ``build_train_step`` bit for bit.

The reference returns ``ce`` and ``aux`` unreduced under ``out_specs
P()`` (``check_vma=False``): ``test_ce_is_rank_zeros`` shows that this is
its first device's value, which the port's step returns on every rank.
The reference's learning test (``tests/test_distributed.py:110-141``)
runs on a ("pod", "data", "model") mesh; the port has no "model" axis
yet (ROADMAP A11.2), so its mirror runs on ("pod", "data") = (2, 2).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.grad_compress import mx_allreduce_tree
from repro_torch.core.spec import QuantPolicy
from repro_torch.data import DataConfig, SyntheticLM, make_batch_for
from repro_torch.dist import DPGroups
from repro_torch.models import Model, load_reduced
from repro_torch.models.params import from_numpy, opt_state_from_numpy
from repro_torch.optim import AdamWConfig
from repro_torch.train import (build_train_step,
                               build_train_step_compressed_dp,
                               init_train_state)
from repro_torch.train.step import _grads_of
from repro_torch.tree import leaves, leaves_with_path, path_key, tree_map
from torch_dist import run_ranks, run_reference

OPT = dict(lr=2e-3, warmup_steps=5, total_steps=25)
B, S = 8, 32
QUANTS = {"none": ("none", (6, 7)), "weights": ("weights=e4m3@32:ocp", (6,))}
METRICS = ("loss", "ce", "aux", "grad_norm", "lr")

_REF = """
import jax, numpy as np
import jax.numpy as jnp
from repro.core.grad_compress import mx_allreduce_tree
from repro.core.spec import QuantPolicy
from repro.data import DataConfig, SyntheticLM, make_batch_for
from repro.dist import compat
from repro.models import Model, load_reduced
from repro.optim import AdamWConfig
from repro.train import build_train_step_compressed_dp, init_train_state
from repro.train.step import _loss_fn
from jax.sharding import PartitionSpec as P
from torch_parity import params_to_numpy, random_moments

mesh = jax.make_mesh((2,), ("data",))
out = {{}}
for name, (quant, steps) in {quants!r}.items():
    fq = quant != "none"
    cfg = load_reduced("chatglm3_6b", remat=False,
                       mx=QuantPolicy.parse(quant))
    model = Model(cfg)
    params, opt = init_train_state(model, jax.random.PRNGKey(0))
    opt = random_moments(opt)
    out[name, "start"] = (params_to_numpy(params), params_to_numpy(opt))
    # replicated from the start, as the step returns them: one compile
    rep = jax.sharding.NamedSharding(mesh, P())
    params, opt = jax.device_put((params, opt), rep)
    step = jax.jit(build_train_step_compressed_dp(
        model, AdamWConfig(**{opt_kw!r}), mesh=mesh, dp_axes=("data",),
        fake_quant=fq))
    spec = cfg.mx.grads or QuantPolicy.parse("grads=e4m3@32:ocp").grads

    def exch(p, batch):
        g = jax.grad(lambda q: _loss_fn(model, q, batch,
                                        fake_quant=fq)[0])(p)
        return mx_allreduce_tree(g, ("data",), spec)

    exch = jax.jit(compat.shard_map(
        exch, mesh=mesh, in_specs=(P(), P("data")), out_specs=P(),
        check_vma=False, axis_names={{"data"}}))
    @jax.jit
    def halves_ce(p, batch):
        # each device's ce: the loss of its rows of the batch
        return [_loss_fn(model, p, {{k: v[r * {B} // 2:(r + 1) * {B} // 2]
                                    for k, v in batch.items()}},
                         fake_quant=fq)[1]["ce"] for r in range(2)]

    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len={S},
                                  global_batch={B}, seed=3))
    with jax.set_mesh(mesh):
        for i in steps:
            batch = make_batch_for(cfg, data.batch(i))
            ces = [float(c) for c in halves_ce(params, batch)]
            out[name, i, "exchanged"] = params_to_numpy(exch(params, batch))
            params, opt, met = step(params, opt, batch, jnp.asarray(i))
            out[name, i, "met"] = {{k: float(v) for k, v in met.items()}}
            out[name, i, "ce_per_device"] = ces
            out[name, i, "state"] = (params_to_numpy(params),
                                     params_to_numpy(opt))
save(out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    body = _REF.format(quants=QUANTS, opt_kw=OPT, B=B, S=S)
    return run_reference(body, 2, tmp_path_factory.mktemp("ref"))


def _batch(cfg, i):
    raw = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B,
                                 seed=3)).batch(i)
    return make_batch_for(cfg, raw, device="cpu")


def _step_rank(groups, runs):
    """One rank, for each (name, start state, quant, steps) of ``runs``:
    from the reference's start state, each step's exchanged gradients (at
    the step's start params) and the state and metrics after it."""
    out = {}
    for name, start, quant, steps in runs:
        fq = quant != "none"
        model = Model(_tcfg(quant), "cpu")
        params = from_numpy(start[0], model.cfg, "cpu")
        opt = opt_state_from_numpy(start[1], model.cfg, "cpu")
        step = build_train_step_compressed_dp(model, AdamWConfig(**OPT),
                                              groups=groups, fake_quant=fq)
        for i in steps:
            batch = _batch(model.cfg, i)
            local = {k: v[groups.batch_rows(B)] for k, v in batch.items()}
            _, _, g = _grads_of(model, params, local, fq)
            out[name, i, "exchanged"] = mx_allreduce_tree(
                g, groups, model.cfg.mx.grads)
            params, opt, met = step(params, opt, batch, i)
            out[name, i, "met"] = {k: float(v) for k, v in met.items()}
            out[name, i, "state"] = tree_map(torch.clone, (params, opt))
    return out


@pytest.fixture(scope="module")
def port(reference, tmp_path_factory):
    runs = [(name, reference[name, "start"], quant, steps)
            for name, (quant, steps) in QUANTS.items()]
    return run_ranks(_step_rank, (2,), tmp_path_factory.mktemp("ranks"),
                     runs)


def _tcfg(quant):
    return load_reduced("chatglm3_6b", remat=False,
                        mx=QuantPolicy.parse(quant))


def _cases():
    return [(name, i) for name, (_, steps) in QUANTS.items() for i in steps]


@pytest.mark.parametrize("name,i", _cases())
def test_step_matches_reference(reference, port, name, i):
    """Metrics, params and AdamW state after the step against the
    reference's (module docstring), and the exchanged codes that differ
    counted."""
    cfg = _tcfg(QUANTS[name][0])
    got = port[0]
    for k in METRICS:
        np.testing.assert_allclose(got[name, i, "met"][k],
                                   reference[name, i, "met"][k],
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    wp, wo = reference[name, i, "state"]
    tp, to = got[name, i, "state"]
    want = {"params": from_numpy(wp, cfg, "cpu"),
            **opt_state_from_numpy(wo, cfg, "cpu")}
    have = {"params": tp, **to}
    for k in ("params", "master", "m", "v"):
        for (pg, g), (pw, w) in zip(leaves_with_path(have[k]),
                                    leaves_with_path(want[k])):
            assert pg == pw
            np.testing.assert_allclose(
                g.float().numpy(), w.float().numpy(), rtol=2e-3, atol=2e-5,
                err_msg=f"{k} {path_key(pg)}")
    # the exchanged gradients: a leaf the port does not exchange (None,
    # C9) is all zeros in the reference
    ref_x = from_numpy(reference[name, i, "exchanged"], cfg, "cpu",
                       dtype=torch.float32)
    differ = total = 0
    for (pg, g), (_, w) in zip(leaves_with_path(got[name, i, "exchanged"]),
                               leaves_with_path(ref_x)):
        if g is None:
            assert not bool(w.abs().max() > 0), path_key(pg)
            continue
        differ += int((g.float() != w).sum())
        total += w.numel()
    print(f"{name} step {i}: {differ} of {total} exchanged codes differ "
          f"from the reference's")
    assert differ <= total * 1e-4


def test_ce_is_rank_zeros(reference, port):
    """The reference's ``ce`` (unreduced under ``out_specs P()``) is its
    first device's, and the port returns rank 0's on every rank."""
    for name, (_, steps) in QUANTS.items():
        for i in steps:
            ces = reference[name, i, "ce_per_device"]
            assert ces[0] != ces[1]
            np.testing.assert_allclose(reference[name, i, "met"]["ce"],
                                       ces[0], rtol=1e-6)
            for r in port:
                assert r[name, i, "met"] == port[0][name, i, "met"]


@pytest.mark.parametrize("name", list(QUANTS))
def test_ranks_hold_identical_state(port, name):
    """After each step every rank's params and AdamW state are the same
    bits, and so are the exchanged gradients."""
    for i in QUANTS[name][1]:
        for r in port[1:]:
            for a, b in zip(leaves(r[name, i, "state"]),
                            leaves(port[0][name, i, "state"])):
                assert torch.equal(a, b)
            for a, b in zip(leaves(r[name, i, "exchanged"]),
                            leaves(port[0][name, i, "exchanged"])):
                assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("quant", ["none", "weights=e4m3@32:ocp"])
def test_world_of_one_equals_the_plain_step(quant):
    """At a world of one the compressed-DP step is ``build_train_step``'s,
    bit for bit, over two steps (no process group: nothing is sent)."""
    fq = quant != "none"
    model = Model(_tcfg(quant), "cpu")
    groups = DPGroups(("data",), (1,), 0, torch.device("cpu"), "gloo",
                      {"data": None})
    p0, o0 = init_train_state(model, seed=0)
    runs = []
    for build in (lambda: build_train_step(model, AdamWConfig(**OPT),
                                           fake_quant=fq),
                  lambda: build_train_step_compressed_dp(
                      model, AdamWConfig(**OPT), groups=groups,
                      fake_quant=fq)):
        step = build()
        p, o = tree_map(torch.clone, (p0, o0))
        mets = []
        for i in range(2):
            p, o, met = step(p, o, _batch(model.cfg, i), i)
            mets.append({k: float(v) for k, v in met.items()})
        runs.append((p, o, mets))
    assert runs[0][2] == runs[1][2]
    for a, b in zip(leaves(runs[0][:2]), leaves(runs[1][:2])):
        assert torch.equal(a, b)


def _learn_rank(groups):
    """The reference's learning test on the port: 12 steps at lr 2e-3."""
    model = Model(load_reduced("chatglm3_6b", remat=False), "cpu")
    params, opt = init_train_state(model, seed=0)
    step = build_train_step_compressed_dp(
        model, AdamWConfig(lr=2e-3, warmup_steps=2, total_steps=20,
                           weight_decay=0.0), groups=groups)
    data = SyntheticLM(DataConfig(vocab=model.cfg.vocab, seq_len=16,
                                  global_batch=8, seed=1))
    losses = []
    for i in range(12):
        batch = make_batch_for(model.cfg, data.batch(i), device="cpu")
        params, opt, met = step(params, opt, batch, i)
        losses.append(float(met["loss"]))
    return losses


def test_compressed_dp_learns_on_pod_data_mesh(tmp_path):
    """4 ranks as ("pod", "data") = (2, 2): the loss falls over 12 steps,
    every loss finite and the same on every rank."""
    ranks = run_ranks(_learn_rank, (2, 2), tmp_path)
    losses = ranks[0]
    assert all(r == losses for r in ranks[1:])
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


def _launch(capfd, ckpt, steps, arch="chatglm3_6b"):
    """The launcher in this process (its ranks are spawned processes):
    its exit code and everything the ranks and it printed."""
    from repro_torch.launch.train import main
    code = 0
    try:
        main(["--arch", arch, "--reduced", "--device", "cpu",
              "--compressed-dp", "--devices", "2", "--steps", str(steps),
              "--batch", "8", "--seq", "32", "--ckpt-every", "2",
              "--ckpt-dir", str(ckpt)])
    except SystemExit as e:
        code = e.code
    out = capfd.readouterr()
    return code, out.out, out.err


def test_launcher_compressed_dp_runs_and_resumes(tmp_path, capfd):
    """``--compressed-dp --devices 2`` trains on two gloo ranks (rank 0
    prints once), and a run of 2 steps resumed to 4 writes the
    uninterrupted run's step-4 checkpoint bit for bit (the first two
    steps' lr is the same at 2 or 4 total steps: 0, then lr)."""
    code, full, err = _launch(capfd, tmp_path / "a", 4)
    assert code == 0, err[-4000:]
    assert "ranks=2 over gloo" in full
    assert full.count("done: loss") == 1
    first, last = (float(x) for x in full.split("done: loss ")[1].split(
        " over")[0].split(" -> "))
    assert last < first
    assert _launch(capfd, tmp_path / "b", 2)[0] == 0
    code, resumed, err = _launch(capfd, tmp_path / "b", 4)
    assert code == 0, err[-4000:]
    assert "resumed from step_00000002" in resumed
    a = np.load(tmp_path / "a" / "step_00000004" / "arrays.npz")
    b = np.load(tmp_path / "b" / "step_00000004" / "arrays.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].tobytes() == b[k].tobytes(), k


def test_launcher_failed_rank_exits_nonzero(tmp_path, capfd):
    """A rank that raises (an unknown arch) stops the others, and the
    launcher exits non-zero with the rank's traceback."""
    code, _, err = _launch(capfd, tmp_path / "c", 1, arch="no_such_arch")
    assert code == 1
    assert "a rank failed" in err and "Traceback" in err


@pytest.mark.parametrize("flag", ["--shard", "--shard-pool"])
def test_serve_launcher_refuses_sharding_naming_a11(flag, capsys):
    """The serve launcher serves ``--shard`` / ``--shard-pool`` for the
    GQA decoder family (tests/test_torch_serve_shard.py) and refuses
    them for the other families with a message naming ROADMAP A11 (their
    sharded serving waits for A11.2's other half)."""
    from repro_torch.launch.serve import main
    with pytest.raises(SystemExit) as e:
        main(["--arch", "rwkv6_7b", "--reduced", "--device", "cpu",
              "--shard"] + ([flag] if flag != "--shard" else []))
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "A11" in err and flag in err


def test_launcher_compressed_dp_with_auto_policy(tmp_path, capfd):
    """``--quant auto`` under ``--compressed-dp`` runs: rank 0 calibrates,
    searches and saves a table with a uniform ``grads`` spec (printed
    once), which every rank trains."""
    from repro_torch.core.spec import PolicyTable
    from repro_torch.launch.train import main
    main(["--arch", "chatglm3_6b", "--reduced", "--device", "cpu",
          "--compressed-dp", "--devices", "2", "--steps", "2", "--batch",
          "8", "--seq", "32", "--quant", "auto:0.75", "--save-policy",
          str(tmp_path / "p.json"), "--ckpt-dir", str(tmp_path / "ck")])
    out = capfd.readouterr().out
    assert out.count("grads role -> ") == 1 and "done: loss" in out
    table = PolicyTable.from_json((tmp_path / "p.json").read_text())
    assert table.default.grads is not None
