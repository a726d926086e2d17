"""Where a compressed data-parallel step's time goes, on one CUDA card.

    python3 tests/profile_dp_exchange.py

A script, not a test (it needs a card).  It prints the card's name and
power limit, then JSON rows:

* ``nccl_two_ranks_one_card``: two ranks that both sit on ``cuda:0``
  joined through NCCL and one ``all_reduce``: whether NCCL runs them,
  refuses them (its error's last line) or hangs (killed after 120 s).
  ``dist.groups`` picks gloo for ranks that share a card on the strength
  of this.
* Two ranks on the card through gloo (``dist.groups``: staged through
  pinned host memory), as ``chip_smoke.py``'s ``train_dp`` phase runs
  them, under ``torch.profiler`` (CPU and CUDA activities):
  ``mx_allreduce_mean`` of chatglm3-6b's embedding gradient (65024 x
  4096 f32) three times, then three steps of
  ``build_train_step_compressed_dp`` on full-width chatglm3-6b at 2
  layers, 4 x 512 tokens a rank, after one unprofiled step.  For each
  the wall ms, and per span of the code itself (the ``dp.*`` spans of
  ``dist.groups`` and ``core.grad_compress``, the ``dp_step.*`` spans of
  the step) and per converter kernel its calls, host ms and device ms
  (the kernels launched inside the span) per repetition.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

REPS = 3
NCCL_TIMEOUT = 120


def _nccl_rank(rank, world, store):
    """Rank ``rank`` of ``world`` NCCL ranks, every one on cuda:0."""
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    x = torch.ones(1024, device="cuda:0")
    dist.all_reduce(x)
    torch.cuda.synchronize()
    dist.destroy_process_group()


def _spans(prof, reps):
    """The profile's ``dp*`` spans and converter kernels: calls, host ms
    and device ms per repetition.  A span has two entries of its name, on
    the host's timeline and on the device's (the range of the kernels it
    launched); each field is taken from the entry that has it."""
    out = {}
    for e in prof.key_averages():
        if not (e.key.startswith("dp") or "mx_quant" in e.key):
            continue
        dev = getattr(e, "device_time_total", None)
        if dev is None:
            dev = e.cuda_time_total
        row = out.setdefault(e.key, {"calls": 0.0, "host_ms": 0.0,
                                     "device_ms": 0.0})
        for k, v in (("calls", e.count / reps),
                     ("host_ms", e.cpu_time_total / 1e3 / reps),
                     ("device_ms", dev / 1e3 / reps)):
            row[k] = max(row[k], v)
    return out


def _gloo_rank(rank, world, store, out):
    import torch

    import chip_smoke as cs
    from repro_torch.core.grad_compress import mx_allreduce_mean
    from repro_torch.core.spec import QuantSpec
    from repro_torch.data import make_batch_for
    from repro_torch.dist import close_dp, init_dp, rank_device
    from repro_torch.train import (build_train_step_compressed_dp,
                                   init_train_state)
    torch.set_num_threads(4)
    groups = init_dp(rank, (world,), rank_device("cuda", rank), store)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    rows = []

    def profiled(name, fn):
        fn()                                # warm-up, unprofiled
        torch.cuda.synchronize()
        wall = []
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(REPS):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall.append((time.perf_counter() - t0) * 1e3)
        rows.append({"what": name, "wall_ms": wall,
                     "spans": _spans(prof, REPS)})

    g = torch.randn(65024, 4096, device="cuda") * 1e-3
    profiled("exchange of the embedding gradient (65024 x 4096 f32)",
             lambda: mx_allreduce_mean(g, groups, QuantSpec("e4m3", "ocp")))
    del g
    model = cs._train_model(torch, "none", n_layers=2)
    state = list(init_train_state(model, seed=0))
    step_fn = build_train_step_compressed_dp(model, cs._train_opt(4),
                                             groups=groups)
    data = cs._train_data(model.cfg)
    batches = [make_batch_for(model.cfg, data.batch(i)) for i in range(4)]
    it = iter(range(4))

    def step():
        i = next(it)
        state[0], state[1], met = step_fn(state[0], state[1], batches[i], i)
        float(met["loss"])

    profiled("compressed-DP step, chatglm3-6b at 2 layers, 4 x 512 a rank",
             step)
    close_dp()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(rows, f)


def main():
    import torch

    from repro_torch.dist import RankFailed, spawn
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        print("profile_dp_exchange: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    build.lib()
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        try:
            spawn(_nccl_rank, 2, (2, os.path.join(d, "nccl")),
                  timeout=NCCL_TIMEOUT)
            verdict, error = "ran", None
        except RankFailed as e:
            lines = [x for x in str(e).splitlines() if x.strip()]
            verdict, error = "refused", lines[-1] if lines else str(e)
        except TimeoutError:
            verdict, error = "hung", f"killed after {NCCL_TIMEOUT} s"
        print(json.dumps({"what": "nccl_two_ranks_one_card",
                          "verdict": verdict, "error": error,
                          "seconds": time.perf_counter() - t0}))
        spawn(_gloo_rank, 2, (2, os.path.join(d, "store"), d), timeout=600)
        for r in range(2):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                for row in json.load(f):
                    print(json.dumps({"rank": r, **row}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
