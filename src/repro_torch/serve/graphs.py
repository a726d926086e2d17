"""Decode steps as captured CUDA graphs: the port's counterpart of the
reference's ``jax.jit`` over its decode step and decode window.

``CapturedStep`` records one call of a step function — which reads and
writes only tensors it holds (static buffers) — as one
``torch.cuda.CUDAGraph`` and replays it, so a decode step costs the host
one graph launch instead of ~2260 eager kernel launches.  Before capture
the step runs once on a side stream (the warm-up): it builds the kernel
library, uploads the decode tables and sets kernel attributes, none of
which may happen inside a capture.  A failed capture raises; nothing
falls back to eager decode on the card.  On the CPU there is nothing to
capture and a call runs the step itself, so both devices run the same
step function over the same buffers.  A sharded step whose collectives
run staged through host memory (gloo on the card: host work, which a
graph cannot hold) is built with ``capture=False`` and runs eagerly on
the card too; the engines choose that from the mesh's backend, never by
trying a capture.

The kernel wrappers count launches on the host, so a replay counts
nothing by itself: each replay credits every wrapper with the launches
its one captured call recorded (and, for a wrapper that also counts by
spec, each spec's), and the capture's own recording (which launches
nothing) is taken back off.

``PagedDecodeGraph`` holds the continuous engine's window buffers and
its captured step (``decoder.paged_decode_window_step``); a window of n
steps is n replays, so the power-of-two windows of
``Scheduler.plan_window`` share one graph.  ``StaticDecodeGraph`` holds
the static engine's cache and its captured step (the family's
``decode_step`` at a position kept on the device, then sampling), one per
batch size, temperature and encoder length.
"""
from __future__ import annotations

import gc
from typing import Callable, Dict, Tuple

import torch

from repro_torch.models.decoder import sample_tokens


def kernel_wrappers() -> Tuple[Callable, ...]:
    """Every kernel wrapper with a ``launches`` count."""
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.kernels.mx_decode_attn import (mx_decode_attention,
                                                    mx_paged_decode_attention)
    from repro_torch.kernels.mx_kv_write import (mx_cache_kv_write,
                                                 mx_paged_kv_write,
                                                 mx_paged_kv_write_tokens)
    from repro_torch.kernels.mx_matmul import mx_matmul_2d
    from repro_torch.kernels.mx_quant import mx_quantize_2d
    return (mx_quantize_2d, mx_paged_kv_write, mx_paged_kv_write_tokens,
            mx_cache_kv_write, mx_matmul_2d, mx_paged_decode_attention,
            mx_decode_attention, flash_attention)


class CapturedStep:
    """``fn()`` captured once as a CUDA graph on ``device`` (a CUDA
    device), or run as it is on the CPU; calling the object replays it.

    ``launches`` maps each kernel wrapper to the launches one replay
    makes, and ``spec_launches`` each wrapper that counts by spec
    (``launches_by_spec``) to one replay's launches per spec (both empty
    on the CPU, where the wrappers count as they run).  ``capture=False``
    runs ``fn`` eagerly on the card as well."""

    def __init__(self, fn: Callable[[], None], device: torch.device,
                 capture: bool = True):
        self.fn = fn
        self.graph = None
        self.launches: Dict[Callable, int] = {}
        self.spec_launches: Dict[Callable, dict] = {}
        if device.type != "cuda" or not capture:
            return
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            fn()                        # warm-up: real launches, counted
        torch.cuda.current_stream(device).wait_stream(side)
        wrappers = kernel_wrappers()
        before = [w.launches for w in wrappers]
        by_spec = {w: dict(w.launches_by_spec) for w in wrappers
                   if hasattr(w, "launches_by_spec")}
        # the graph's nodes stay readable (``graph.raw_cuda_graph()``)
        # after instantiation: what one replay launches can be listed
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        # a captured step holds a reference cycle (its step closure and
        # the buffers' owner), so a dropped engine's graph dies in the
        # cyclic collector; destroying a graph while a capture is open
        # invalidates the capture, so collect first and not during it
        gc.collect()
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                fn()
        finally:
            if gc_on:
                gc.enable()
        graph.instantiate()
        for w, n in zip(wrappers, before):
            if w.launches != n:
                self.launches[w] = w.launches - n
                w.launches = n          # the capture only recorded them
        for w, was in by_spec.items():
            now = w.launches_by_spec
            got = {k: n - was.get(k, 0) for k, n in now.items()
                   if n != was.get(k, 0)}
            if got:
                self.spec_launches[w] = got
                now.clear()
                now.update(was)
        self.graph = graph

    def __call__(self) -> None:
        if self.graph is None:
            self.fn()
            return
        self.graph.replay()
        for w, n in self.launches.items():
            w.launches += n
        for w, got in self.spec_launches.items():
            by = w.launches_by_spec
            for k, n in got.items():
                by[k] = by.get(k, 0) + n


class PagedDecodeGraph:
    """The continuous engine's decode window over static buffers.

    ``state`` (3, slots) int32 — each slot's in-flight token, length and
    remaining budget; ``block_tables`` (slots, max_pages) int32;
    ``keys`` (slots, 2) int64 sampling keys; ``bad`` (slots,) bool, the
    window's finite-logits flag; ``tokens`` (max_window, slots) int32, the
    token each step emits.  ``pool`` is updated in place.  The caller
    fills ``state`` (and, when the host tables changed,
    ``block_tables``) before ``run`` and reads ``tokens`` and ``bad``
    after it; ``keys`` stay on the device from window to window."""

    def __init__(self, model, params, pool, *, slots: int, max_pages: int,
                 max_window: int, temperature: float = 0.0,
                 health: bool = False, trash_page: int = 0,
                 capture: bool = True):
        dev = model.device
        self.state = torch.zeros((3, slots), dtype=torch.int32, device=dev)
        self.block_tables = torch.full((slots, max_pages), trash_page,
                                       dtype=torch.int32, device=dev)
        self.keys = torch.zeros((slots, 2), dtype=torch.int64, device=dev)
        self.bad = torch.zeros(slots, dtype=torch.bool, device=dev)
        self.tokens = torch.zeros((max_window, slots), dtype=torch.int32,
                                  device=dev)
        self._step_idx = torch.zeros(1, dtype=torch.int64, device=dev)

        def step():
            token, lengths, remaining, keys, bad = \
                model.paged_decode_window_step(
                    params, self.state[0], pool, self.block_tables,
                    self.state[1], self.state[2], self.keys,
                    temperature=temperature, trash_page=trash_page,
                    health=health)
            self.state.copy_(torch.stack([token, lengths, remaining]))
            self.keys.copy_(keys)
            if health:
                self.bad |= bad
            self.tokens.index_copy_(0, self._step_idx, token[None])
            self._step_idx += 1

        # captured on all-idle slots: the warm-up step writes only the
        # trash page and leaves every live page as it was
        self.step = CapturedStep(step, dev, capture)

    def run(self, n_steps: int) -> None:
        """``n_steps`` steps from the buffers' state (replays on the
        card): tokens[:n_steps] and ``bad`` cover this window only."""
        if n_steps > self.tokens.shape[0]:
            raise ValueError(f"a window of {n_steps} steps exceeds the "
                             f"{self.tokens.shape[0]} the buffers hold")
        self.bad.zero_()
        self._step_idx.zero_()
        for _ in range(n_steps):
            self.step()


class StaticDecodeGraph:
    """The static engine's decode step over a contiguous cache of
    ``max_len`` positions for ``batch`` rows, at one temperature (and,
    for an encoder-decoder, one encoder length ``s_enc``: the cache's
    cross K/V, which its prefill fills).

    ``cache`` is the static cache (``prefill(..., cache=)`` fills it in
    place: KV caches, recurrent states and cross K/V alike);
    ``token`` (batch,) int32, ``pos`` (1,) int32 and ``keys`` (batch, 2)
    int64 advance on the device with every step, and ``tokens`` (max_len,
    batch) int32 collects what each step samples."""

    def __init__(self, model, params, *, batch: int, max_len: int,
                 temperature: float = 0.0, s_enc: int = 0,
                 capture: bool = True):
        dev = model.device
        vocab = model.cfg.vocab
        self.cache = model.init_cache(batch, max_len, s_enc)
        self.token = torch.zeros(batch, dtype=torch.int32, device=dev)
        self.pos = torch.zeros(1, dtype=torch.int32, device=dev)
        self.keys = torch.zeros((batch, 2), dtype=torch.int64, device=dev)
        self.tokens = torch.zeros((max_len, batch), dtype=torch.int32,
                                  device=dev)
        self._step_idx = torch.zeros(1, dtype=torch.int64, device=dev)

        def step():
            logits, _ = model.decode_step(params, self.token, self.cache,
                                          self.pos)
            keys, nxt = sample_tokens(logits[:, -1, :vocab], self.keys,
                                      temperature)
            self.token.copy_(nxt)
            self.keys.copy_(keys)
            self.pos += 1
            self.tokens.index_copy_(0, self._step_idx, nxt[None])
            self._step_idx += 1

        # the warm-up writes position 0 of the cache (and steps a
        # recurrent state), which every prefill zeroes and rewrites
        self.step = CapturedStep(step, dev, capture)

    def run(self, token: torch.Tensor, keys: torch.Tensor, pos: int,
            n_steps: int) -> torch.Tensor:
        """``n_steps`` steps from ``token`` at ``pos`` with ``keys``;
        returns the sampled tokens (n_steps, batch) on the device."""
        self.token.copy_(token)
        self.keys.copy_(keys)
        self.pos.fill_(pos)
        self._step_idx.zero_()
        for _ in range(n_steps):
            self.step()
        return self.tokens[:n_steps]
