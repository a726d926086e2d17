"""Fault-tolerant training loop: auto-resume, atomic checkpoints, the
straggler watchdog (mirrors src/repro/train/loop.py).

  * crash       -> rerun the job; the loop resumes from the latest atomic
                   checkpoint with the data cursor (the step number), so
                   it replays the same batches;
  * straggler   -> a step whose wall time exceeds ``straggler_factor`` x
                   the running median is logged;
  * preemption  -> a checkpoint every ``ckpt_every`` steps bounds the
                   lost work; saves are atomic (tmp + rename).

A step's wall time ends when its loss reaches the host (``float``), as
in the reference, which reads the loss each step too.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict

import numpy as np

from repro_torch.ckpt.checkpoint import (gc_old, latest_step, restore,
                                         save_atomic)


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: str
    ckpt_every: int = 100
    keep: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0


def train_loop(cfg: LoopConfig, train_step: Callable, params, opt_state,
               batch_fn: Callable[[int], Dict[str, Any]],
               log: Callable[[str], None] = print) -> Dict[str, Any]:
    """Runs to ``total_steps`` with auto-resume; returns the final
    ``params``, ``opt`` state and the ``history`` (step, loss, time_s)."""
    start = 0
    last = latest_step(cfg.ckpt_dir)
    if last is not None:
        state = {"params": params, "opt": opt_state}
        state, meta = restore(cfg.ckpt_dir, last, state)
        params, opt_state = state["params"], state["opt"]
        start = int(meta.get("next_step", last))
        log(f"[loop] resumed from step_{last:08d} -> next_step={start}")
    history = []
    step_times = []
    for step in range(start, cfg.total_steps):
        batch = batch_fn(step)
        t0 = time.perf_counter()
        params, opt_state, metrics = train_step(params, opt_state, batch,
                                                step)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        step_times.append(dt)
        med = float(np.median(step_times[-50:]))
        if len(step_times) > 5 and dt > cfg.straggler_factor * med:
            log(f"[watchdog] step {step}: {dt:.2f}s > "
                f"{cfg.straggler_factor:.1f}x median {med:.2f}s — straggler "
                f"event (would report to controller)")
        history.append({"step": step, "loss": loss, "time_s": dt})
        if step % cfg.log_every == 0:
            log(f"[train] step={step} loss={loss:.4f} "
                f"gnorm={float(metrics.get('grad_norm', 0)):.3f} "
                f"({dt*1e3:.0f} ms)")
        if cfg.ckpt_every and (step + 1) % cfg.ckpt_every == 0:
            save_atomic(cfg.ckpt_dir, step + 1,
                        {"params": params, "opt": opt_state},
                        metadata={"next_step": step + 1})
            gc_old(cfg.ckpt_dir, cfg.keep)
    return {"params": params, "opt": opt_state, "history": history}
