"""Gradient diagnostics of the training path, run as a script (pytest
collects nothing here).

``norms``: the f32 gradient norm of a config at its published width by
depth, batch 2 x 64 of ``SyntheticLM``'s first batch, params from seed 0,
through the JAX package (on the CPU) or the port (any device):

    PYTHONPATH=src python tests/grad_witness.py norms --package jax \\
        --arch zamba2_1p2b --layers 2 6 12
    PYTHONPATH=src python tests/grad_witness.py norms --package port \\
        --device cuda --arch zamba2_1p2b --layers 2 6 12 38

``bf16``: a reduced config's bf16 gradients and first-step ``m`` on a
device and on the CPU, each against the f32 ones of the same params on
the CPU, leaf by leaf (the setting of ``tests/test_torch_cuda.py``'s
family train tests: no quant, flash, remat on, 4 x 48 tokens):

    PYTHONPATH=src python tests/grad_witness.py bf16 --device cuda \\
        --arch zamba2_1p2b

``clip``: a config at its published width as ``chip_smoke.py``'s
``train_families`` phase trains it (bf16, flash, remat, 8 x 512 tokens,
params from seed 0): its first step's gradient norm and, per leaf, the
share of elements whose gradient clipped to norm 1.0 is under AdamW's
eps (1e-8), so that their first Adam step is under half of lr:

    PYTHONPATH=src python tests/grad_witness.py clip --device cuda \\
        --arch zamba2_1p2b

Each prints one JSON object per result line.  The port's side imports
no jax, so it also runs where jax is not installed.
"""
import argparse
import json
import os
import time


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def jax_norms(arch, layers):
    import jax
    import jax.numpy as jnp
    from repro.data import DataConfig, SyntheticLM, make_batch_for
    from repro.models import Model, load_config
    from repro.train.step import _loss_fn
    for nl in layers:
        cfg = load_config(arch, n_layers=nl, dtype="float32",
                          param_dtype="float32")
        m = Model(cfg)
        p = jax.jit(m.init)(jax.random.PRNGKey(0))
        raw = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64,
                                     global_batch=2)).batch(0)
        (loss, _), g = jax.jit(jax.value_and_grad(
            lambda q, b: _loss_fn(m, q, b, fake_quant=False),
            has_aux=True))(p, make_batch_for(cfg, raw))
        gl = jax.tree_util.tree_leaves(g)
        norm = float(jnp.sqrt(sum(jnp.sum(jnp.square(x)) for x in gl)))
        print(json.dumps({"package": "jax", "arch": arch, "layers": nl,
                          "loss": float(loss), "grad_norm": norm}),
              flush=True)


def port_norms(arch, layers, device):
    import torch
    from repro_torch.data import DataConfig, SyntheticLM, make_batch_for
    from repro_torch.models import Model, load_config
    from repro_torch.train.step import _grads_of
    from repro_torch.tree import leaves_with_path, path_key, tree_map
    for nl in layers:
        t0 = time.perf_counter()
        cfg = load_config(arch, n_layers=nl, dtype="float32",
                          param_dtype="float32", attn_impl="flash")
        p = tree_map(lambda t: t.to(device), Model(cfg, "cpu").init(seed=0))
        raw = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64,
                                     global_batch=2)).batch(0)
        loss, _, g = _grads_of(Model(cfg, device), p,
                               make_batch_for(cfg, raw, device=device), False)
        lv = [(path_key(k), float(x.float().norm()))
              for k, x in leaves_with_path(g)]
        print(json.dumps({"package": "port", "device": str(device),
                          "arch": arch, "layers": nl, "loss": float(loss),
                          "grad_norm": sum(n * n for _, n in lv) ** 0.5,
                          "top": sorted(lv, key=lambda kv: -kv[1])[:6],
                          "seconds": time.perf_counter() - t0}), flush=True)
        del p, g
        if device != "cpu":
            torch.cuda.empty_cache()


def bf16_witness(arch, device):
    import torch
    from repro_torch.core.spec import QuantPolicy
    from repro_torch.data import DataConfig, SyntheticLM, make_batch_for
    from repro_torch.models import Model, load_reduced
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import build_train_step
    from repro_torch.train.step import _grads_of
    from repro_torch.tree import leaves_with_path, path_key, tree_map

    def cfg_of(dtype):
        return load_reduced(arch, mx=QuantPolicy.parse("none"),
                            attn_impl="flash", remat=True, dtype=dtype,
                            param_dtype=dtype)

    p16 = Model(cfg_of("bfloat16"), "cpu").init(seed=0)
    p32 = tree_map(lambda t: t.float(), p16)
    opt_cfg = AdamWConfig(lr=2e-3, warmup_steps=1, total_steps=3)
    raw = SyntheticLM(DataConfig(vocab=cfg_of("float32").vocab, seq_len=48,
                                 global_batch=4, seed=3)).batch(0)
    runs = {}
    for name, dtype, params, dev in (("f32_cpu", "float32", p32, "cpu"),
                                     ("bf16_cpu", "bfloat16", p16, "cpu"),
                                     ("bf16_dev", "bfloat16", p16, device)):
        cfg = cfg_of(dtype)
        model = Model(cfg, dev)
        p = tree_map(lambda t: t.to(dev, copy=True), params)
        batch = make_batch_for(cfg, raw, device=dev)
        loss, _, g = _grads_of(model, p, batch, False)
        g = {path_key(k): x.float().cpu() for k, x in leaves_with_path(g)}
        _, opt, met = build_train_step(model, opt_cfg)(p, adamw_init(p),
                                                       batch, 0)
        m = {path_key(k): x.float().cpu()
             for k, x in leaves_with_path(opt["m"])}
        runs[name] = (float(loss), float(met["grad_norm"]), g, m)
    ref = runs["f32_cpu"]
    for i, what in ((2, "grad"), (3, "m")):
        for k, r in ref[i].items():
            e_dev = _rel(runs["bf16_dev"][i][k], r)
            e_cpu = _rel(runs["bf16_cpu"][i][k], r)
            print(json.dumps({
                "arch": arch, "device": str(device), "what": what,
                "leaf": k, "f32_norm": float(r.norm()),
                "dev_vs_f32": e_dev, "cpu_vs_f32": e_cpu,
                "ratio": e_dev / max(e_cpu, 1e-30),
                "dev_vs_cpu": _rel(runs["bf16_dev"][i][k],
                                   runs["bf16_cpu"][i][k])}), flush=True)
    print(json.dumps({"arch": arch, "device": str(device), "scalars": {
        n: {"loss": r[0], "grad_norm": r[1]} for n, r in runs.items()}}),
        flush=True)


def clip_share(arch, device, eps=1e-8):
    from repro_torch.data import DataConfig, SyntheticLM, make_batch_for
    from repro_torch.models import Model, load_config
    from repro_torch.train.step import _grads_of
    from repro_torch.tree import leaves_with_path, path_key
    cfg = load_config(arch, attn_impl="flash")
    model = Model(cfg, device)
    raw = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=512,
                                 global_batch=8)).batch(0)
    _, _, g = _grads_of(model, model.init(seed=0),
                        make_batch_for(cfg, raw, device=device), False)
    lv = [(path_key(k), x.float()) for k, x in leaves_with_path(g)]
    norm = sum(float(x.pow(2).sum()) for _, x in lv) ** 0.5
    scale = min(1.0, 1.0 / (norm + 1e-9))    # adamw_update's clip to 1.0
    under = {k: (x.numel(), int((x.abs() * scale < eps).sum()),
                 int((x == 0).sum())) for k, x in lv}
    for k, (n, u, z) in under.items():
        print(json.dumps({"leaf": k, "elements": n, "under_eps": u / n,
                          "zero": z / n}), flush=True)
    print(json.dumps({
        "arch": arch, "dtype": cfg.dtype, "grad_norm": norm,
        "clip_scale": scale, "leaves": len(under),
        "leaves_mostly_under_eps": sum(u > n / 2
                                       for n, u, _ in under.values()),
        "elements": sum(n for n, _, _ in under.values()),
        "under_eps": sum(u for _, u, _ in under.values()),
        "zero": sum(z for _, _, z in under.values())}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    n = sub.add_parser("norms")
    n.add_argument("--package", choices=("jax", "port"), required=True)
    n.add_argument("--arch", default="zamba2_1p2b")
    n.add_argument("--device", default="cuda")
    n.add_argument("--layers", type=int, nargs="+", required=True)
    b = sub.add_parser("bf16")
    b.add_argument("--arch", default="zamba2_1p2b")
    b.add_argument("--device", default="cuda")
    c = sub.add_parser("clip")
    c.add_argument("--arch", default="zamba2_1p2b")
    c.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    if a.cmd == "norms" and a.package == "jax":
        jax_norms(a.arch, a.layers)
        return
    import torch
    torch.set_num_threads(os.cpu_count() or 1)
    if a.device != "cpu":
        # the deterministic train step needs cuBLAS's fixed workspace
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.backends.cuda.matmul.allow_tf32 = False
    if a.cmd == "norms":
        port_norms(a.arch, a.layers, a.device)
    elif a.cmd == "bf16":
        bf16_witness(a.arch, a.device)
    else:
        clip_share(a.arch, a.device)


if __name__ == "__main__":
    main()
