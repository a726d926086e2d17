"""Training launcher of the port (mirrors src/repro/launch/train.py).

    PYTHONPATH=src python -m repro_torch.launch.train --arch chatglm3_6b \\
        --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ck

Trains any arch of ``models.ARCH_IDS`` on the CUDA device (``--device
cpu`` computes every kernel's plain version instead; use it with
``--reduced``): random weights from seed 0, synthetic batches from
``data.SyntheticLM`` (an encoder-decoder's frames and a patch frontend's
embeddings are ``data.make_batch_for``'s fixed stubs, the same every
step, as in the reference: ROADMAP C12), the resumable loop of
``train.loop`` (atomic checkpoints every ``--ckpt-every`` steps, resumed
from the latest one in ``--ckpt-dir``; without it, a new directory under
the temp dir).  The step is deterministic: this
launcher sets ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` before cuBLAS starts.

MX levers, as the reference's: ``--quant`` takes the per-role policy (a
``weights`` role fake-quantizes every matmul weight along K in the
forward, an ``activations`` role every matmul input, each through the
converter kernel; QAT), ``--mx {off,paper,ocp}`` is the deprecated
alias for ``weights=e4m3@32:<mode>,grads=e4m3@32:<mode>``.  As in the
reference, no gradient passes through a fake-quantized tensor (ROADMAP
C9): under a ``weights`` role the matmul weights move only by weight
decay, and the embedding, norms and LM head learn.

``--quant auto:<bytes-per-param>`` calibrates instead of hand-picking:
weight statistics from the initialized params, gradient statistics from
``--calib-batches`` LM-loss backward passes (``--batch`` x ``--seq``
tokens from numpy seed 1), then ``calib.search_weights_policy`` gives
each layer its own ``weights`` spec under the average bytes-per-param
budget, and one uniform ``grads`` spec is the best aggregate-gradient
SQNR within the same budget; the per-layer table trains with QAT and
``--save-policy`` writes its JSON.  Calibration covers the decoder
family (MLA and the patch frontend included), as the reference's: the
hybrid, RWKV and the encoder-decoder stop where the reference's
``collect_model_stats`` does, with a message naming that limit.
``--compressed-dp`` and
``--devices`` (the reference's multi-device data parallelism) stop with
a message naming ROADMAP A11.
"""
from __future__ import annotations

import argparse
import os
import tempfile

MULTI_DEVICE_REFUSED = (
    "multi-device training (--compressed-dp, --devices: the reference's "
    "MX-compressed gradient all-reduce over a device mesh) is not ported "
    "yet: ROADMAP item A11; the port trains on one device")


def grads_role_spec(stats, budget: float):
    """The uniform ``grads`` spec the reference's launcher picks: the best
    aggregate-gradient SQNR over layers among candidates within
    ``budget`` bytes per param (None when none fits)."""
    from repro_torch.calib import sweep_role, weight_param_nbytes
    agg = {}
    for scored in sweep_role(stats, "grads", weight_param_nbytes).values():
        for s in scored:
            a = agg.setdefault(s.spec, [0.0, 0])
            a[0] += s.sqnr_db
            a[1] += 1
    in_budget = {sp: v[0] / v[1] for sp, v in agg.items()
                 if weight_param_nbytes(sp) <= budget}
    if not in_budget:
        return None, None
    best = max(in_budget, key=in_budget.get)
    return best, in_budget[best]


def auto_table(stats, budget: float, cfg):
    """The reference launcher's ``--quant auto:<budget>`` table from
    calibration ``stats``: ``search_weights_policy``'s per-layer weights
    table with the uniform ``grads_role_spec`` in every layer.  Returns
    (table, the search's result, the grads spec, its mean SQNR)."""
    from repro_torch.calib import search_weights_policy
    res = search_weights_policy(stats, budget, cfg)
    table = res.table
    gspec, gsqnr = grads_role_spec(stats, budget)
    if gspec is not None:
        table = table.replace(
            default=table.default.replace(grads=gspec),
            overrides=tuple((i, p.replace(grads=gspec))
                            for i, p in table.overrides))
    return table, res, gspec, gsqnr


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory, resumed from its latest "
                         "checkpoint; default: a new directory under the "
                         "temp dir (a fresh run)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--quant", default=None,
                    help="quantization policy, e.g. "
                         "'weights=e4m3@32:ocp,grads=e4m3@32:ocp', or "
                         "'auto:<bytes-per-param>' to calibrate and "
                         "search a per-layer weights policy")
    ap.add_argument("--calib-batches", type=int, default=2,
                    help="gradient-statistics batches for --quant auto")
    ap.add_argument("--save-policy", default=None,
                    help="write the auto-selected PolicyTable JSON here")
    ap.add_argument("--mx", choices=["off", "paper", "ocp"], default="off",
                    help="deprecated: use --quant (applies e4m3 to "
                         "weights+grads in the given mode)")
    ap.add_argument("--compressed-dp", action="store_true",
                    help="not ported (ROADMAP A11)")
    ap.add_argument("--devices", type=int, default=0,
                    help="not ported (ROADMAP A11)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (every kernel's plain "
                         "version; with --reduced)")
    args = ap.parse_args(argv)
    if args.compressed_dp or args.devices:
        ap.error(MULTI_DEVICE_REFUSED)
    # before cuBLAS starts: the deterministic step needs its fixed
    # workspace (repro_torch.train.step)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    import numpy as np

    from repro_torch.core.spec import QuantPolicy
    from repro_torch.data import DataConfig, SyntheticLM, make_batch_for
    from repro_torch.models import (Model, apply_policy_table, load_config,
                                    load_reduced)
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (LoopConfig, build_train_step,
                                   init_train_state, train_loop)
    from repro_torch.tree import leaves

    over = {}
    auto_budget = None
    if args.quant and (args.quant == "auto"
                       or args.quant.startswith("auto:")):
        from repro_torch.calib import parse_auto_budget
        auto_budget = parse_auto_budget(args.quant)
    elif args.quant:
        over["mx"] = QuantPolicy.parse(args.quant)
    elif args.mx != "off":
        print(f"[train] --mx is deprecated; use --quant "
              f"weights=e4m3@32:{args.mx},grads=e4m3@32:{args.mx}")
        over["mx"] = QuantPolicy.parse(
            f"weights=e4m3@32:{args.mx},grads=e4m3@32:{args.mx}")
    cfg = (load_reduced if args.reduced else load_config)(args.arch, **over)
    model = Model(cfg, device=args.device)
    params, opt_state = init_train_state(model, seed=0)

    if auto_budget is not None:
        from pathlib import Path

        from repro_torch.calib import collect_model_stats
        rng = np.random.default_rng(1)
        batches = [rng.integers(0, cfg.vocab, size=(args.batch, args.seq)
                                ).astype(np.int32)
                   for _ in range(max(1, args.calib_batches))]
        stats = collect_model_stats(model, params, batches,
                                    roles=("weights", "grads"))
        table, res, gspec, gsqnr = auto_table(stats, auto_budget, cfg)
        if gspec is not None:
            print(f"[train] grads role -> {gspec} "
                  f"({gsqnr:.1f}dB aggregate SQNR)")
        print("[train] " + res.describe().replace("\n", "\n[train] "))
        if args.save_policy:
            Path(args.save_policy).write_text(table.to_json())
            print(f"[train] wrote policy table -> {args.save_policy}")
        cfg = apply_policy_table(cfg, table)
        model = Model(cfg, device=args.device)
    n_params = sum(p.numel() for p in leaves(params))
    print(f"[train] {cfg.name}: {n_params/1e6:.1f}M params, "
          f"quant={cfg.mx}, device={model.device}")
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 10
                                                       + 1),
                          total_steps=args.steps)
    fake_quant = any(cfg.layer_policy(i).weights is not None
                     or cfg.layer_policy(i).activations is not None
                     for i in range(cfg.n_layers))
    step = build_train_step(model, opt_cfg, microbatches=args.microbatches,
                            fake_quant=fake_quant)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch))

    def batch_fn(i):
        # no prefix_rng, as the reference's launcher: every step's frames
        # or patch embeddings are the same stub (ROADMAP C12)
        return make_batch_for(cfg, data.batch(i), device=model.device)

    if args.ckpt_dir is None:
        args.ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
        print(f"[train] checkpoints in {args.ckpt_dir}")
    loop_cfg = LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                          ckpt_every=args.ckpt_every)
    out = train_loop(loop_cfg, step, params, opt_state, batch_fn)
    h = out["history"]
    if h:
        print(f"[train] done: loss {h[0]['loss']:.4f} -> "
              f"{h[-1]['loss']:.4f} over {len(h)} steps")
    else:
        print(f"[train] done: nothing to run past step {args.steps}")


if __name__ == "__main__":
    main()
