"""Training I/O of the five families beyond the GQA decoder: the data
pipeline's modality stubs, remat, checkpoint resume, the train launcher
and its ``--quant auto``, against the JAX package where the two compute
the same thing.

* ``make_batch_for``: ``frames`` (encoder-decoder) and ``prefix_embeds``
  with the -1-prefixed labels (patch frontend) equal the reference's
  arrays byte for byte, from a given ``prefix_rng`` and from none (then
  every step carries the same stub, as in the reference: ROADMAP C12).
* Remat (``cfg.remat``: ``torch.utils.checkpoint`` over the reference's
  checkpointed unit) gives the loss and every gradient of remat off, bit
  for bit.
* A checkpoint of each family's tree (the hybrid's block list and shared
  block, RWKV's ``mu`` / ``u``, the encoder-decoder's two stacks) resumes
  the uninterrupted run bit for bit.
* The launcher trains ``--reduced --device cpu``; ``--quant auto:0.75``
  writes the reference's ``PolicyTable`` JSON given the same statistics
  where the reference's launcher trains (MLA, the patch frontend), and
  stops, naming the reference's limit, where the reference's stops (the
  hybrid, RWKV and the encoder-decoder: its ``collect_model_stats``
  walks the decoder's layer stack and runs the model on tokens alone).
"""
import functools
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.ckpt import latest_step
from repro_torch.core.spec import PolicyTable, QuantPolicy
from repro_torch.data import DataConfig, SyntheticLM, make_batch_for
from repro_torch.launch import train as launcher
from repro_torch.models import Model, load_reduced
from repro_torch.optim import AdamWConfig
from repro_torch.train import (LoopConfig, build_train_step,
                               init_train_state, train_loop)
from repro_torch.train.step import _grads_of
from repro_torch.tree import leaves_with_path, path_key

torch.set_num_threads(1)

ARCHS = ("deepseek_v2_236b", "internvl2_76b", "zamba2_1p2b", "rwkv6_7b",
         "seamless_m4t_medium")
B, S = 8, 32


def _data(cfg, seed=3):
    return SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=S,
                                  global_batch=B, seed=seed))


@pytest.mark.parametrize("arch", ("chatglm3_6b",) + ARCHS)
def test_make_batch_for_matches_reference(arch):
    """Every key, dtype and byte of the port's batch equals the
    reference's, with no ``prefix_rng`` (two steps: the same stub) and
    with one (the stub drawn from it)."""
    from repro.data import make_batch_for as j_batch
    from repro.models import load_reduced as j_load_reduced
    cfg, jcfg = load_reduced(arch), j_load_reduced(arch)
    data = _data(cfg)
    stubs = []
    for step, rng in ((0, None), (1, None), (1, 7)):
        raw = data.batch(step)
        got = make_batch_for(cfg, raw, None if rng is None
                             else np.random.default_rng(rng), device="cpu")
        want = j_batch(jcfg, raw, None if rng is None
                       else np.random.default_rng(rng))
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            w = np.asarray(w)
            g = got[k].numpy()
            assert got[k].device.type == "cpu"
            assert g.dtype == w.dtype and g.shape == w.shape, k
            assert g.tobytes() == w.tobytes(), (k, step, rng)
        stubs.append({k: v for k, v in got.items()
                      if k in ("frames", "prefix_embeds")})
    if cfg.family == "encdec" or cfg.frontend == "patch":
        assert len(stubs[0]) == 1
        (k, first), = stubs[0].items()
        assert torch.equal(first, stubs[1][k])        # no rng: fixed stub
        assert not torch.equal(first, stubs[2][k])    # drawn from the rng
        if k == "prefix_embeds":
            labels = make_batch_for(cfg, data.batch(0),
                                    device="cpu")["labels"]
            assert labels.shape == (B, cfg.prefix_len + S)
            assert bool((labels[:, :cfg.prefix_len] == -1).all())
    else:
        assert stubs == [{}, {}, {}]


@pytest.mark.parametrize("quant", ["none", "weights=e4m3@32:ocp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_equals_off(arch, quant):
    """The loss and every leaf's gradient with ``remat`` on equal remat
    off bit for bit (f32, the CPU), fake-quantized weights included (the
    recomputed forward quantizes them again); with remat on, the forward
    keeps fewer tensors for the backward (each checkpointed unit keeps
    only its input)."""
    fq = quant != "none"
    data = _data(load_reduced(arch)).batch(0)
    out, saved = [], []
    for remat in (False, True):
        cfg = load_reduced(arch, remat=remat, attn_impl="flash",
                           mx=QuantPolicy.parse(quant))
        model = Model(cfg, "cpu")
        params = model.init(seed=0)
        packed = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: packed.append(1) or t, lambda t: t):
            loss, _, grads = _grads_of(model, params, make_batch_for(
                cfg, data, device="cpu"), fq)
        out.append((loss, grads))
        saved.append(len(packed))
    assert saved[1] < saved[0], saved
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    n = 0
    for (p, a), (_, b) in zip(leaves_with_path(g0), leaves_with_path(g1)):
        assert (a is None) == (b is None), path_key(p)
        if a is not None:
            assert torch.equal(a, b), path_key(p)
            n += 1
    assert n > 0


# the leaves each family's tree must carry through a checkpoint
FAMILY_KEYS = {
    "zamba2_1p2b": ("params/blocks/3/in_proj", "params/blocks/0/a_log",
                    "params/shared_attn/attn/wq",
                    "params/shared_attn/mlp/w2", "opt/m/blocks/1/conv_w"),
    "rwkv6_7b": ("params/blocks/1/tmix/mu", "params/blocks/0/tmix/u",
                 "params/blocks/0/cmix/mu", "opt/v/blocks/1/tmix/u"),
    "seamless_m4t_medium": ("params/enc_layers/1/attn/wq",
                            "params/dec_layers/1/xattn/wk",
                            "opt/master/dec_layers/0/lnx"),
}


@pytest.mark.parametrize("arch", list(FAMILY_KEYS))
def test_family_resume_bitexact(tmp_path, arch):
    """6 steps uninterrupted against 3 steps, a checkpoint, and a fresh
    state resumed from it to 6 (``train_loop``): params, master, m and v
    bit for bit, the same losses; the checkpoint holds the family's
    leaves by their tree paths."""
    cfg = load_reduced(arch)
    model = Model(cfg, "cpu")
    data = _data(cfg)
    step = build_train_step(model, AdamWConfig(lr=2e-3, warmup_steps=2,
                                               total_steps=6))

    def batch_fn(i):
        return make_batch_for(cfg, data.batch(i), device="cpu")

    def loop(total, d, every):
        return train_loop(LoopConfig(total_steps=total, ckpt_dir=str(d),
                                     ckpt_every=every, log_every=1000),
                          step, *init_train_state(model, seed=0), batch_fn,
                          log=lambda *_: None)

    a = loop(6, tmp_path / "a", 0)
    loop(3, tmp_path / "b", 3)
    manifest = json.loads((tmp_path / "b" / "step_00000003" /
                           "manifest.json").read_text())
    keys = set(manifest["keys"])
    assert set(FAMILY_KEYS[arch]) <= keys, sorted(keys)[:8]
    b = loop(6, tmp_path / "b", 0)
    assert [h["step"] for h in b["history"]] == [3, 4, 5]
    assert [h["loss"] for h in b["history"]] == \
        [h["loss"] for h in a["history"]][3:]
    for k in ("params", "opt"):
        for (p, x), (_, y) in zip(leaves_with_path(a[k]),
                                  leaves_with_path(b[k])):
            assert torch.equal(x, y), (k, path_key(p))


def _launch(capsys, *argv):
    launcher.main(list(argv))
    return capsys.readouterr().out


@pytest.mark.parametrize("arch", ["zamba2_1p2b", "seamless_m4t_medium"])
def test_launcher_trains_family(tmp_path, capsys, arch):
    """``python -m repro_torch.launch.train --arch <arch> --reduced
    --device cpu``: 12 steps with a falling loss and checkpoints every 6;
    a rerun resumes from the last."""
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--steps", "12",
            "--batch", "8", "--seq", "32", "--ckpt-every", "6",
            "--ckpt-dir", str(tmp_path / "ck")]
    out = _launch(capsys, *argv)
    done = [ln for ln in out.splitlines() if "done: loss" in ln][0]
    first, last = (float(x) for x in done.split("loss ")[1].split(
        " over")[0].split(" -> "))
    assert np.isfinite([first, last]).all() and last < first, out
    assert latest_step(str(tmp_path / "ck")) == 12
    again = _launch(capsys, *argv)
    assert "resumed from step_00000012" in again


CALIB = dict(batch=4, seq=32, batches=2, budget=0.75)


def _reference_auto_table(jm, jstats, budget):
    """The reference launcher's table from its stats: its search, then
    its uniform grads spec (src/repro/launch/train.py:125-151, whose
    steps this repeats with the reference's functions)."""
    from repro.calib import (search_weights_policy, sweep_role,
                             weight_param_nbytes)
    res = search_weights_policy(jstats, budget, jm.cfg)
    agg = {}
    for scored in sweep_role(jstats, "grads", weight_param_nbytes).values():
        for s in scored:
            a = agg.setdefault(s.spec, [0.0, 0])
            a[0] += s.sqnr_db
            a[1] += 1
    in_budget = {sp: v[0] / v[1] for sp, v in agg.items()
                 if weight_param_nbytes(sp) <= budget}
    table = res.table
    if in_budget:
        gspec = max(in_budget, key=in_budget.get)
        table = table.replace(
            default=table.default.replace(grads=gspec),
            overrides=tuple((i, p.replace(grads=gspec))
                            for i, p in table.overrides))
    return table


@pytest.mark.parametrize("arch", ARCHS)
def test_quant_auto_matches_reference(tmp_path, capsys, arch):
    """``--quant auto:0.75`` per family, as the reference's launcher: on
    the reference's params and calibration batches (numpy seed 1), where
    the reference's ``collect_model_stats`` gives stats, the port's
    ``auto_table`` on those stats and on the port's own (same params)
    emits the reference's table JSON, and the port's launcher trains
    under its own table; where the reference's raises, the port's
    launcher stops there with a message naming that limit."""
    import jax
    from repro.calib import collect_model_stats as j_collect
    from repro.models import Model as JModel
    from repro.models import load_reduced as j_load_reduced
    from repro.train import init_train_state as j_init
    from repro_torch.calib import collect_model_stats
    from repro_torch.models.params import from_numpy
    from torch_parity import params_to_numpy
    jm = JModel(j_load_reduced(arch))
    cfg = load_reduced(arch)
    jp, _ = jax.jit(functools.partial(j_init, jm))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    batches = [rng.integers(0, cfg.vocab, size=(CALIB["batch"],
                                                CALIB["seq"])
                            ).astype(np.int32)
               for _ in range(CALIB["batches"])]
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--steps", "2",
            "--batch", str(CALIB["batch"]), "--seq", str(CALIB["seq"]),
            "--calib-batches", str(CALIB["batches"]), "--ckpt-dir",
            str(tmp_path / "ck"), "--quant", f"auto:{CALIB['budget']}",
            "--save-policy", str(tmp_path / "p.json")]
    if cfg.family != "decoder":
        limit = "'frames'" if cfg.family == "encdec" else "'layers'"
        with pytest.raises(KeyError, match=limit):
            j_collect(jm, jp, batches, roles=("weights", "grads"))
        with pytest.raises(NotImplementedError,
                           match=f"KeyError: {limit}"):
            _launch(capsys, *argv)
        assert not os.path.exists(tmp_path / "p.json")
        return
    jstats = j_collect(jm, jp, batches, roles=("weights", "grads"))
    want = _reference_auto_table(jm, jstats, CALIB["budget"]).to_json()
    got, _, gspec, _ = launcher.auto_table(jstats, CALIB["budget"], cfg)
    assert got.to_json() == want
    assert gspec is not None
    stats = collect_model_stats(
        Model(cfg, "cpu"), from_numpy(params_to_numpy(jp), cfg, "cpu"),
        batches, roles=("weights", "grads"))
    assert launcher.auto_table(stats, CALIB["budget"], cfg)[0].to_json() \
        == want
    out = _launch(capsys, *argv)
    assert "done: loss" in out
    table = PolicyTable.from_json((tmp_path / "p.json").read_text())
    assert len({table.layer(i).grads for i in range(cfg.n_layers)}) == 1


def test_adamw_update_in_slices_is_bit_identical(monkeypatch):
    """``adamw_update`` updates a large leaf in slices of
    ``UPDATE_SLICE_CPU`` elements on the CPU (``UPDATE_SLICE`` on the
    card): with slices of 4099 elements (the reduced
    hybrid's leaves past that cut, with ragged ends) params, master, m
    and v equal the one-piece update bit for bit."""
    from repro_torch.optim import adamw, adamw_init
    from repro_torch.tree import tree_map
    cfg = load_reduced("zamba2_1p2b")
    model = Model(cfg, "cpu")
    params = model.init(seed=0)
    _, _, grads = _grads_of(model, params, make_batch_for(
        cfg, _data(cfg).batch(0), device="cpu"), False)
    opt_cfg = AdamWConfig(lr=2e-3, warmup_steps=1, total_steps=4)
    out = []
    for size in (adamw.UPDATE_SLICE_CPU, 4099):
        monkeypatch.setattr(adamw, "UPDATE_SLICE_CPU", size)
        p = tree_map(torch.clone, params)
        s = adamw_init(p)
        for step in range(2):
            p, s, _ = adamw.adamw_update(opt_cfg, grads, s, step,
                                         torch.float32, p)
        out.append({"params": p, "opt": s})
    for (k, a), (_, b) in zip(leaves_with_path(out[0]),
                              leaves_with_path(out[1])):
        assert torch.equal(a, b), path_key(k)
