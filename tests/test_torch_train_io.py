"""The port's training I/O and loop (``repro_torch.data``, ``ckpt``,
``train.loop``, ``launch.train``), against the JAX package's where the
two compute the same thing, and the port-only mirrors of the reference's
tests/test_train_integration.py.

* ``SyntheticLM`` / ``token_file_reader`` batches equal the reference's
  byte for byte.
* A checkpoint has the reference's layout (``step_<N>/arrays.npz`` of
  "/"-joined tree paths and ``manifest.json``); a bf16 tensor is stored
  as the same raw 2-byte words the reference's numpy writes for a bf16
  array; restore is bit for bit.
* Mirrors (port only, as the reference's): the loss falls below 0.8x
  its first value in 25 steps (0.85x with MX E4M3 weights); the
  microbatched step equals the full batch (loss rtol 1e-4, params rtol
  2e-3, atol 2e-5: the reference's tolerances); resume is bit-exact; a
  crashed save never shadows a valid checkpoint.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.ckpt import gc_old, latest_step, restore, save_atomic
from repro_torch.core.spec import QuantPolicy
from repro_torch.data import (DataConfig, SyntheticLM, make_batch_for,
                              token_file_reader)
from repro_torch.models import Model, load_reduced
from repro_torch.optim import AdamWConfig
from repro_torch.train import (LoopConfig, build_train_step,
                               init_train_state, train_loop)
from repro_torch.tree import leaves_with_path, tree_map

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
B, S, STEPS = 8, 32, 25


@pytest.mark.parametrize("seed,vocab,steps", [(0, 512, (0, 1, 7)),
                                               (3, 65024, (0, 2, 1000)),
                                               (11, 97, (5,))])
def test_synthetic_lm_matches_reference_bytes(seed, vocab, steps):
    from repro.data import DataConfig as JDataConfig
    from repro.data import SyntheticLM as JSyntheticLM
    kw = dict(vocab=vocab, seq_len=33, global_batch=5, seed=seed)
    got, want = SyntheticLM(DataConfig(**kw)), JSyntheticLM(JDataConfig(**kw))
    for step in steps:
        g, w = got.batch(step), want.batch(step)
        for k in ("tokens", "labels"):
            assert g[k].dtype == w[k].dtype
            assert g[k].tobytes() == w[k].tobytes()
    it = iter(got)
    assert next(it)["tokens"].tobytes() == want.batch(0)["tokens"].tobytes()


def test_token_file_reader_matches_reference(tmp_path):
    from repro.data import token_file_reader as j_reader
    path = tmp_path / "toks.bin"
    np.random.default_rng(2).integers(0, 60000, size=5000).astype(
        np.uint16).tofile(path)
    got, n = token_file_reader(str(path), 16, 4)
    want, jn = j_reader(str(path), 16, 4)
    assert n == jn == (5000 - 1) // 64
    for step in (0, 3, n, n + 5):
        for k in ("tokens", "labels"):
            assert got(step)[k].tobytes() == want(step)[k].tobytes()


def test_make_batch_for_puts_the_batch_on_the_device():
    cfg = load_reduced("chatglm3_6b")
    raw = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=8,
                                 global_batch=2)).batch(0)
    b = make_batch_for(cfg, raw, device="cpu")
    assert set(b) == {"tokens", "labels"}
    assert b["tokens"].dtype == torch.int32 and b["tokens"].device.type \
        == "cpu"
    assert np.array_equal(b["labels"].numpy(), raw["labels"])


def test_checkpoint_layout_and_bf16_bytes_match_reference(tmp_path):
    """The same tree saved by both packages: the same step directory,
    files and "/"-joined keys, the same array bytes (bf16 as raw 2-byte
    words in both), and the port restores the reference's file."""
    import jax.numpy as jnp
    from repro.ckpt import save_atomic as j_save
    rng = np.random.default_rng(0)
    a = rng.normal(size=(3, 4)).astype(np.float32)
    h = rng.normal(size=(5,)).astype(np.float32)
    t_state = {"params": {"w": torch.from_numpy(a),
                          "h": torch.from_numpy(h).to(torch.bfloat16)},
               "opt": {"m": [torch.from_numpy(a * 2)]}}
    j_state = {"params": {"w": jnp.asarray(a),
                          "h": jnp.asarray(h).astype(jnp.bfloat16)},
               "opt": {"m": [jnp.asarray(a * 2)]}}
    save_atomic(str(tmp_path / "t"), 7, t_state, metadata={"next_step": 7})
    j_save(str(tmp_path / "j"), 7, j_state, metadata={"next_step": 7})
    td, jd = tmp_path / "t" / "step_00000007", tmp_path / "j" / \
        "step_00000007"
    assert sorted(os.listdir(td)) == sorted(os.listdir(jd)) == [
        "arrays.npz", "manifest.json"]
    tz, jz = np.load(td / "arrays.npz"), np.load(jd / "arrays.npz")
    assert sorted(tz.files) == sorted(jz.files) == [
        "opt/m/0", "params/h", "params/w"]
    for k in jz.files:
        assert tz[k].dtype == jz[k].dtype and tz[k].tobytes() == \
            jz[k].tobytes(), k
    tm, jm = (json.loads((d / "manifest.json").read_text())
              for d in (td, jd))
    assert tm["keys"] == jm["keys"] and tm["step"] == jm["step"] == 7
    assert tm["metadata"] == jm["metadata"] == {"next_step": 7}
    like = {"params": {"w": torch.zeros(3, 4),
                       "h": torch.zeros(5, dtype=torch.bfloat16)},
            "opt": {"m": [torch.zeros(3, 4)]}}
    for d in ("t", "j"):
        got, meta = restore(str(tmp_path / d), 7, like)
        assert meta == {"next_step": 7}
        for (p, x), (_, y) in zip(leaves_with_path(got),
                                  leaves_with_path(t_state)):
            assert x.dtype == y.dtype and torch.equal(x, y), p


def test_checkpoint_restore_checks_shapes_and_gc(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3, 4):
        save_atomic(d, s, {"x": torch.full((2,), float(s))})
    gc_old(d, keep=2)
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004"]
    assert latest_step(d) == 4
    got, _ = restore(d, 3, {"x": torch.zeros(2)})
    assert torch.equal(got["x"], torch.full((2,), 3.0))
    with pytest.raises(ValueError, match="shape"):
        restore(d, 3, {"x": torch.zeros(3)})
    assert latest_step(str(tmp_path / "none")) is None


def test_checkpoint_atomicity(tmp_path):
    """A leftover .tmp dir (a crash mid-save) never shadows a valid
    checkpoint, and a later save at that step replaces it."""
    d = str(tmp_path)
    save_atomic(d, 5, {"x": torch.ones(3)})
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    assert latest_step(d) == 5
    save_atomic(d, 9, {"x": torch.zeros(3)})
    assert latest_step(d) == 9
    assert not os.path.exists(os.path.join(d, "step_00000009.tmp"))


def _setup(mx=None, microbatches=1):
    over = {"remat": False}
    if mx is not None:
        over["mx"] = QuantPolicy.parse(mx)
    cfg = load_reduced("chatglm3_6b", **over)
    model = Model(cfg, "cpu")
    params, opt = init_train_state(model, seed=0)
    step = build_train_step(
        model, AdamWConfig(lr=2e-3, warmup_steps=5, total_steps=STEPS,
                           weight_decay=0.0),
        microbatches=microbatches, fake_quant=mx is not None)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=S,
                                  global_batch=B, seed=3))
    return cfg, params, opt, step, data


def _losses(cfg, params, opt, step, data, n=STEPS):
    out = []
    for i in range(n):
        params, opt, met = step(params, opt, make_batch_for(
            cfg, data.batch(i), device="cpu"), i)
        out.append(float(met["loss"]))
    return out


@pytest.mark.parametrize("mx,factor", [(None, 0.8),
                                       ("weights=e4m3@32:paper", 0.85)])
def test_loss_decreases(mx, factor):
    """The reference's two loss tests: baseline below 0.8x, paper-mode
    E4M3 fake-quantized weights below 0.85x, all finite."""
    losses = _losses(*_setup(mx))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * factor, losses[:3] + losses[-3:]


def test_microbatched_matches_full_batch():
    """As the reference's, at step 0 (lr 0) and, beyond it, at step 6
    (past warm-up), from the same state."""
    cfg, p1, o1, step1, data = _setup()
    _, p2, o2, step2, _ = _setup(microbatches=4)
    b = make_batch_for(cfg, data.batch(0), device="cpu")
    for step in (0, 6):
        # each step updates its trees in place: start both from copies
        p1n, o1n, m1 = step1(*tree_map(torch.clone, (p1, o1)), b, step)
        p2n, o2n, m2 = step2(*tree_map(torch.clone, (p2, o2)), b, step)
        np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                                   rtol=1e-4)
        for (_, a), (_, c) in zip(leaves_with_path(p1n),
                                  leaves_with_path(p2n)):
            np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=2e-3,
                                       atol=2e-5)


def test_checkpoint_resume_bitexact(tmp_path):
    """Crash/restart at step 10 reproduces the uninterrupted run to 20:
    params and the AdamW state bit for bit."""
    cfg, params, opt, step, data = _setup()

    def batch_fn(i):
        return make_batch_for(cfg, data.batch(i), device="cpu")

    def fresh():
        return _setup()[1:3]

    out_a = train_loop(LoopConfig(total_steps=20, ckpt_dir=str(
        tmp_path / "a"), ckpt_every=0, log_every=1000), step, *fresh(),
        batch_fn, log=lambda *_: None)
    ck = str(tmp_path / "ckpt")
    train_loop(LoopConfig(total_steps=10, ckpt_dir=ck, ckpt_every=10,
                          log_every=1000), step, *fresh(), batch_fn,
               log=lambda *_: None)
    logs = []
    out_b = train_loop(LoopConfig(total_steps=20, ckpt_dir=ck,
                                  ckpt_every=10, log_every=1000),
                       step, *fresh(), batch_fn, log=logs.append)
    assert logs[0].startswith("[loop] resumed from step_00000010")
    assert [h["step"] for h in out_b["history"]] == list(range(10, 20))
    for k in ("params", "opt"):
        for (p, a), (_, b) in zip(leaves_with_path(out_a[k]),
                                  leaves_with_path(out_b[k])):
            assert torch.equal(a, b), (k, p)


def test_straggler_watchdog_logs():
    """A step over 3x the running median is logged as a straggler."""
    import time

    def slow_step(params, opt, batch, step):
        time.sleep(0.2 if step == 7 else 0.01)
        return params, opt, {"loss": torch.tensor(1.0)}

    logs = []
    out = train_loop(LoopConfig(total_steps=8, ckpt_dir="", ckpt_every=0,
                                log_every=1000), slow_step, {}, {},
                     lambda i: {}, log=logs.append)
    assert len(out["history"]) == 8
    assert [s for s in logs if s.startswith("[watchdog]")] and all(
        s.startswith("[watchdog] step 7") for s in logs
        if s.startswith("[watchdog]"))


def _launch(tmp_path, *extra, ckpt_dir=True, steps=12):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "chatglm3_6b", "--reduced", "--device", "cpu", "--steps",
           str(steps), "--batch", "8", "--seq", "32", "--ckpt-every", "6",
           *extra]
    if ckpt_dir:
        cmd += ["--ckpt-dir", str(tmp_path / "ck")]
    else:
        env["TMPDIR"] = str(tmp_path)
    return subprocess.run(cmd, env=env, capture_output=True, text=True,
                          cwd=str(ROOT), timeout=600)


def test_launcher_default_ckpt_dir_is_new(tmp_path):
    """Without ``--ckpt-dir`` the launcher checkpoints into a new
    directory under the temp dir, so two runs never resume from each
    other's checkpoints."""
    out = _launch(tmp_path, ckpt_dir=False, steps=6)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("[train] checkpoints in ")][0]
    d = Path(line.split(" in ", 1)[1])
    assert d.parent == tmp_path and d.name.startswith("repro_torch_ckpt_")
    assert latest_step(str(d)) == 6
    assert "resumed" not in out.stdout


@pytest.mark.parametrize("quant", ["weights=e4m3@32:ocp,grads=e4m3@32:ocp",
                                   "auto:0.75"])
def test_launcher_trains_on_cpu(tmp_path, quant):
    """The launcher (``--device cpu --reduced``) trains with a falling
    loss and atomic checkpoints; ``--quant auto:0.75`` writes a
    ``PolicyTable`` JSON within the budget that reloads and names a
    uniform grads spec; a rerun resumes from the last checkpoint."""
    from repro_torch.calib import weight_param_nbytes
    from repro_torch.core.spec import PolicyTable
    extra = ["--quant", quant]
    if quant.startswith("auto"):
        extra += ["--save-policy", str(tmp_path / "p.json")]
    out = _launch(tmp_path, *extra)
    assert out.returncode == 0, out.stderr[-3000:]
    done = [ln for ln in out.stdout.splitlines() if "done: loss" in ln][0]
    first, last = (float(x) for x in done.split("loss ")[1].split(
        " over")[0].split(" -> "))
    assert last < first
    assert latest_step(str(tmp_path / "ck")) == 12
    if quant.startswith("auto"):
        table = PolicyTable.from_json((tmp_path / "p.json").read_text())
        specs = [table.layer(i) for i in range(2)]
        assert all(p.weights is not None for p in specs)
        assert len({p.grads for p in specs}) == 1
        assert np.mean([weight_param_nbytes(p.weights) for p in specs]) \
            <= 0.75 + 1e-9
    again = _launch(tmp_path, *extra)
    assert again.returncode == 0
    assert "resumed from step_00000012" in again.stdout


@pytest.mark.parametrize("flag", [["--compressed-dp", "--devices", "3"],
                                  ["--devices", "-1"]])
def test_launcher_refuses_multi_device(tmp_path, flag):
    """The multi-device forms the launcher cannot run stop before any
    rank starts: a global batch (8) that does not split over the ranks,
    and a negative rank count (``--compressed-dp --devices`` itself runs:
    tests/test_torch_train_dp.py)."""
    out = _launch(tmp_path, *flag)
    assert out.returncode == 2
    want = ("--batch 8 does not split over 3 ranks" if "3" in flag
            else "--devices takes a count of ranks")
    assert want in out.stderr
