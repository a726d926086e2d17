"""Profile ``chip_smoke.py``'s card-against-CPU checks on a machine with
a CUDA card, run as a script (pytest collects nothing here):

    python3 tests/profile_cpu_checks.py [--out DIR] [--checks NAME ...]

Each check (the MoE and chatglm3-6b continuous engines, the per-layer
policy table, the chatglm3-6b train step, the other families' train
steps and serving) runs once under ``cProfile``; the seconds of each
print, and its 30 costliest functions by own time and 45 by cumulative
time go to ``DIR/prof_<check>.txt``.  The CPU halves of these checks
are what varies most between runs of ``chip_smoke.py``; this shows
which of the port's plain functions they spend it in.
"""
from __future__ import annotations

import argparse
import cProfile
import io
import os
import pstats
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "profile"))
    ap.add_argument("--checks", nargs="*", default=None,
                    help="profile only these (default: all)")
    args = ap.parse_args()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as C
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    C.CARD = smi
    print("cpu threads", torch.get_num_threads(), "cores", os.cpu_count(),
          flush=True)
    from repro_torch.kernels import build
    build.lib()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    def prof(name, fn, *a, **kw):
        if args.checks is not None and name not in args.checks:
            return
        pr = cProfile.Profile()
        t = time.perf_counter()
        pr.enable()
        fn(*a, **kw)
        pr.disable()
        s = io.StringIO()
        st = pstats.Stats(pr, stream=s)
        st.sort_stats("tottime").print_stats(30)
        st.sort_stats("cumulative").print_stats(45)
        (out / f"prof_{name}.txt").write_text(s.getvalue())
        print(name, "seconds", time.perf_counter() - t, flush=True)

    prof("moe", C.card_vs_cpu, torch, C.MOE_ARCH, new=2)
    prof("policy", C._policy_card_vs_cpu, torch)
    prof("train", C._train_card_vs_cpu, torch)
    prof("famgrads", C._family_grads_card_vs_cpu, torch)
    prof("families", C.families_card_vs_cpu, torch)
    prof("chatglm", C.card_vs_cpu, torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
