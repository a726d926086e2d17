"""Logical sharding rules: the rule table (mirrors the first half of
src/repro/dist/sharding.py).

A rule table maps the models' logical axis names to physical mesh axes
and carries the quantization policy that distributed consumers read.
``make_rules`` builds one, ``use_rules`` installs it for a block (a
thread-local stack), ``current_rules`` reads the innermost one.  Plain
Python over that stack, as in the reference: the port keeps its own
copy.

Physical axis convention (the reference's ``launch/mesh.py``):
  pod    — inter-pod data parallelism (gradient reduction only)
  data   — intra-pod DP / FSDP shard axis
  model  — tensor / expert / sequence parallelism

The port consumes today only the ``quant`` policy (``core.grad_compress``
resolves its exchange spec through ``quant_spec_for("grads")``) and
``DP_AXES`` (``dist.groups`` maps them onto process groups), so the
table holds only the batch axes and that policy.  The reference's other
toggles and queries (``fsdp_params``, ``seq_sharded``,
``bf16_matmul_out``, ``pure_fsdp``, ``paged_pool_sharded``,
``weight_gather_*``) and its use-point constraints (``logical``,
``_spec_for``, ``param_specs``: its ``:179-241``) are ported with
sharding onto DTensor (ROADMAP A11.2), when a consumer arrives; the
reference's ``dist/compat.py`` has no counterpart here (it shims jax
versions).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Optional, Sequence

Rules = Dict[str, Any]

DP_AXES = ("pod", "data")       # data-parallel axes, outermost first

_state = threading.local()


def _stack():
    stack = getattr(_state, "rules", None)
    if stack is None:
        stack = _state.rules = []
    return stack


def make_rules(axes: Sequence[str], *, quant: Any = None) -> Rules:
    """A rule table for a mesh with ``axes``: the batch over its DP axes,
    and ``quant``, a ``repro_torch.core.spec.QuantPolicy`` whose per-role
    specs distributed consumers resolve through ``quant_spec_for`` (the
    compressed gradient exchange reads "grads")."""
    batch = tuple(a for a in DP_AXES if a in tuple(axes))
    return {"batch": batch, "quant": quant}


@contextlib.contextmanager
def use_rules(rules: Rules):
    """Install ``rules`` for the duration of the block."""
    _stack().append(rules)
    try:
        yield rules
    finally:
        _stack().pop()


def current_rules() -> Optional[Rules]:
    stack = _stack()
    return stack[-1] if stack else None


def quant_spec_for(role: str):
    """The installed rules' quantization spec for ``role``, or None (no
    rules, no policy, or no spec for the role)."""
    r = current_rules()
    pol = (r or {}).get("quant")
    return pol.role(role) if pol is not None else None
