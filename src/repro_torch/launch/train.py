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

``--compressed-dp`` trains data-parallel over ``--devices N`` ranks, one
process each (default: one per CUDA card, one on the CPU), with the
MX-compressed gradient all-reduce (``core.grad_compress``; its format is
the policy's ``grads`` role, else e4m3/ocp): each rank takes its rows
of the global batch, and every rank takes the same AdamW step on its
replica of the params and state (ZeRO-1, as the reference).  Rank r of
a CUDA run sits on ``cuda:(r % cards)``; NCCL joins the ranks when each
has a card of its own, gloo when they share one (staged through pinned
host memory) and on the CPU (``dist.groups``; the backend is printed).
Rank 0 writes the checkpoints and prints; every rank resumes from them.
A failed rank stops the others, and the launcher exits non-zero.

    PYTHONPATH=src python -m repro_torch.launch.train --arch chatglm3_6b \
        --reduced --device cpu --compressed-dp --devices 2 --steps 12

``--devices`` without ``--compressed-dp`` trains the plain step in one
process on one device, as the reference's single-device step does on
the first of its forced host devices.
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile


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
                    help="data parallelism over --devices ranks with the "
                         "MX-compressed gradient all-reduce (ZeRO-1)")
    ap.add_argument("--devices", type=int, default=0,
                    help="ranks of --compressed-dp, one process each "
                         "(default: one per CUDA card, 1 on the CPU); "
                         "without --compressed-dp the plain step runs "
                         "on one device")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (every kernel's plain "
                         "version; with --reduced)")
    args = ap.parse_args(argv)
    if args.devices < 0:
        ap.error("--devices takes a count of ranks")
    # before cuBLAS starts: the deterministic step needs its fixed
    # workspace (repro_torch.train.step); the ranks inherit it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if args.ckpt_dir is None:
        args.ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
        print(f"[train] checkpoints in {args.ckpt_dir}")
    if not args.compressed_dp:
        _train(args)
        return
    import torch

    from repro_torch.dist import RankFailed, spawn
    world = args.devices or (torch.cuda.device_count()
                             if args.device == "cuda" else 1)
    if args.batch % world:
        ap.error(f"--batch {args.batch} does not split over {world} ranks")
    rdv = tempfile.mkdtemp(prefix="repro_torch_dp_")
    try:
        spawn(_rank_main, world, (args, world, os.path.join(rdv, "store")))
    except RankFailed as e:
        print(f"[train] a rank failed; every rank was stopped:\n{e}",
              file=sys.stderr)
        raise SystemExit(1)
    finally:
        shutil.rmtree(rdv, ignore_errors=True)


def _rank_main(rank: int, args, world: int, store: str) -> None:
    """One rank of a ``--compressed-dp`` run (a process of its own)."""
    import torch

    from repro_torch.dist import close_dp, init_dp, rank_device
    device = rank_device(args.device, rank)
    if device.type == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    groups = init_dp(rank, (world,), device, store)
    try:
        _train(args, groups)
    finally:
        close_dp()


def _train(args, groups=None) -> None:
    """The run: ``groups`` None trains the plain step on ``--device``;
    else rank ``groups.rank`` of a compressed-DP run on its own device
    (rank 0 logs and writes the checkpoints)."""
    import numpy as np

    from repro_torch.core.spec import PolicyTable, QuantPolicy
    from repro_torch.data import DataConfig, SyntheticLM, make_batch_for
    from repro_torch.models import (Model, apply_policy_table, load_config,
                                    load_reduced)
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (LoopConfig, build_train_step,
                                   build_train_step_compressed_dp,
                                   init_train_state, train_loop)
    from repro_torch.tree import leaves

    lead = groups is None or groups.rank == 0
    log = print if lead else (lambda *a, **k: None)
    device = args.device if groups is None else groups.device
    over = {}
    auto_budget = None
    if args.quant and (args.quant == "auto"
                       or args.quant.startswith("auto:")):
        from repro_torch.calib import parse_auto_budget
        auto_budget = parse_auto_budget(args.quant)
    elif args.quant:
        over["mx"] = QuantPolicy.parse(args.quant)
    elif args.mx != "off":
        log(f"[train] --mx is deprecated; use --quant "
            f"weights=e4m3@32:{args.mx},grads=e4m3@32:{args.mx}")
        over["mx"] = QuantPolicy.parse(
            f"weights=e4m3@32:{args.mx},grads=e4m3@32:{args.mx}")
    cfg = (load_reduced if args.reduced else load_config)(args.arch, **over)
    model = Model(cfg, device=device)
    params, opt_state = init_train_state(model, seed=0)

    if auto_budget is not None:
        # rank 0 calibrates and searches; the others take its table
        table = None
        if lead:
            from pathlib import Path

            from repro_torch.calib import collect_model_stats
            rng = np.random.default_rng(1)
            batches = [rng.integers(0, cfg.vocab, size=(args.batch,
                                                        args.seq)
                                    ).astype(np.int32)
                       for _ in range(max(1, args.calib_batches))]
            stats = collect_model_stats(model, params, batches,
                                        roles=("weights", "grads"))
            table, res, gspec, gsqnr = auto_table(stats, auto_budget, cfg)
            if gspec is not None:
                log(f"[train] grads role -> {gspec} "
                    f"({gsqnr:.1f}dB aggregate SQNR)")
            log("[train] " + res.describe().replace("\n", "\n[train] "))
            if args.save_policy:
                Path(args.save_policy).write_text(table.to_json())
                log(f"[train] wrote policy table -> {args.save_policy}")
        if groups is not None:
            import torch.distributed as dist
            box = [table.to_json() if lead else None]
            dist.broadcast_object_list(box, src=0)
            table = PolicyTable.from_json(box[0])
        cfg = apply_policy_table(cfg, table)
        model = Model(cfg, device=device)
    n_params = sum(p.numel() for p in leaves(params))
    ranks = "" if groups is None else (
        f", ranks={groups.world} over {groups.backend}"
        f"{' (staged through host memory)' if groups.staged else ''}")
    log(f"[train] {cfg.name}: {n_params/1e6:.1f}M params, "
        f"quant={cfg.mx}, device={model.device}{ranks}")
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 10
                                                       + 1),
                          total_steps=args.steps)
    fake_quant = any(cfg.layer_policy(i).weights is not None
                     or cfg.layer_policy(i).activations is not None
                     for i in range(cfg.n_layers))
    if groups is None:
        step = build_train_step(model, opt_cfg,
                                microbatches=args.microbatches,
                                fake_quant=fake_quant)
    else:
        step = build_train_step_compressed_dp(model, opt_cfg, groups=groups,
                                              fake_quant=fake_quant)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch))

    def batch_fn(i):
        # no prefix_rng, as the reference's launcher: every step's frames
        # or patch embeddings are the same stub (ROADMAP C12)
        return make_batch_for(cfg, data.batch(i), device=model.device)

    # the replicas are identical: rank 0 writes the checkpoints, and
    # every rank resumes from them
    loop_cfg = LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                          ckpt_every=args.ckpt_every if lead else 0)
    out = train_loop(loop_cfg, step, params, opt_state, batch_fn, log=log)
    h = out["history"]
    if h:
        log(f"[train] done: loss {h[0]['loss']:.4f} -> "
            f"{h[-1]['loss']:.4f} over {len(h)} steps")
    else:
        log(f"[train] done: nothing to run past step {args.steps}")


if __name__ == "__main__":
    main()
