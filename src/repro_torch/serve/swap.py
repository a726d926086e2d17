"""Host-memory swap store for preempt-and-swap serving (mirrors
src/repro/serve/swap.py).

When the SLO scheduler preempts a running request
(``Scheduler.pick_victim`` + ``ContinuousBatchingEngine._swap_out``), the
victim slot's KV pages are copied from the device page pool into host
memory and the slot is freed for a more urgent admission.  The pool
stores *MX codes* (bit-packed sub-byte elements + E8M0 scales), not
dequantized values, so the swap traffic is already compressed.  On
re-admission the request is restored page for page into freshly
allocated private pages (``scatter_pages``); with the saved per-slot
sampling key this makes the continuation token-identical to an
unpreempted run.

Pool leaves are layer-stacked ``(L, P, page, n_kv, X)``
(``decoder.init_paged_cache``), so the page axis is always 1, and the
bytes move verbatim whatever the layer's spec: MX and fp pools alike.
The gather is one ``index_select(1, ids)`` per leaf into a **pinned**
host tensor on the card (so each leaf's device-to-host copy is one DMA),
all leaves issued before one synchronize.  The scatter is
``index_copy_(1, ids, ...)`` into the live leaves, so a captured decode
graph that reads them sees the restored pages.  No kernel: the
reference does this in plain array indexing outside any Pallas kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve.faults import corrupt_swap_payload

Pages = Dict[str, torch.Tensor]     # pool leaf name -> host page contents


def to_host(t: torch.Tensor) -> torch.Tensor:
    """Start a copy of ``t`` to host memory: into a pinned tensor, without
    waiting, when ``t`` lies on the card (the caller synchronizes once for
    a batch of these); a plain copy on the CPU."""
    if t.device.type != "cuda":
        return t.clone()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


def sync(device: torch.device) -> None:
    """Wait for the copies ``to_host`` started on ``device``."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def gather_pages(pool: Pages, page_ids: Sequence[int]) -> Tuple[Pages, int]:
    """Copy the contents of ``page_ids`` out of every pool leaf to host
    memory, one synchronize for all leaves.  Returns (host pages, total
    bytes); each host leaf is the pool leaf with its page axis shrunk to
    ``len(page_ids)``."""
    leaf0 = next(iter(pool.values()))
    ids = torch.as_tensor(list(page_ids), dtype=torch.int64,
                          device=leaf0.device)
    host = {name: to_host(leaf.index_select(1, ids))
            for name, leaf in pool.items()}
    sync(leaf0.device)
    return host, sum(t.numel() * t.element_size() for t in host.values())


def scatter_pages(pool: Pages, page_ids, host: Pages) -> Pages:
    """Write a ``gather_pages`` copy back into ``pool`` at (fresh)
    physical ``page_ids``, in place: the restore half of
    preempt-and-swap."""
    leaf0 = next(iter(pool.values()))
    ids = torch.as_tensor(list(page_ids), dtype=torch.int64,
                          device=leaf0.device)
    for name, leaf in pool.items():
        leaf.index_copy_(1, ids, host[name].to(leaf.device,
                                               non_blocking=True))
    return pool


def concat_snapshots(snapshots: Sequence[Pages]) -> Pages:
    """Concatenate several ``gather_pages`` copies along the page axis so
    a batch of restores lands in one scatter per leaf (into pinned memory
    when the copies are pinned)."""
    if len(snapshots) == 1:
        return snapshots[0]
    out = {}
    for name, first in snapshots[0].items():
        parts = [s[name] for s in snapshots]
        shape = list(first.shape)
        shape[1] = sum(p.shape[1] for p in parts)
        out[name] = torch.cat(parts, dim=1, out=torch.empty(
            shape, dtype=first.dtype, pin_memory=first.is_pinned()))
    return out


@dataclasses.dataclass
class SwapData:
    """One preempted request's host-resident state: its KV page contents
    (MX-packed as in the pool), how many pages they cover, its sampling
    key at the preemption boundary and the cache length they hold —
    enough, with the request's own token history, to continue
    bit-identically."""
    pages: Pages
    n_pages: int
    length: int                 # cache positions filled at swap-out
    key: torch.Tensor           # (2,) int64 per-slot sampling key
    nbytes: int


class HostSwapStore:
    """Keyed host-memory store of :class:`SwapData` with byte accounting.

    The counters live in a :class:`~repro_torch.obs.metrics.MetricsRegistry`
    (``swap.bytes_out`` / ``swap.bytes_in`` and the gauge
    ``swap.peak_resident_bytes``); the attributes of those names are
    registry-backed views, writable because snapshot restore rewinds
    them.  ``reset_counters`` zeroes the traffic counters for a
    measurement window and keeps the stored entries: a request swapped
    out before the window must still restore after it.  ``faults`` (a
    ``serve.faults.FaultPlan``) is consulted at its ``swap_corrupt`` site
    once per ``put``."""

    def __init__(self, metrics: Optional[MetricsRegistry] = None):
        self._entries: Dict[int, SwapData] = {}
        self.metrics = MetricsRegistry() if metrics is None else metrics
        self._c_out = self.metrics.counter(
            "swap.bytes_out", "device -> host swap-out traffic")
        self._c_in = self.metrics.counter(
            "swap.bytes_in", "host -> device restore traffic")
        self._g_peak = self.metrics.gauge(
            "swap.peak_resident_bytes", "peak host-resident swap bytes")
        self.faults = None          # serve.faults.FaultPlan (swap_corrupt)

    @property
    def bytes_out(self) -> int:
        return int(self._c_out.value())

    @bytes_out.setter
    def bytes_out(self, v: int) -> None:
        self._c_out.set(int(v))

    @property
    def bytes_in(self) -> int:
        return int(self._c_in.value())

    @bytes_in.setter
    def bytes_in(self, v: int) -> None:
        self._c_in.set(int(v))

    @property
    def peak_resident_bytes(self) -> int:
        return int(self._g_peak.value())

    @peak_resident_bytes.setter
    def peak_resident_bytes(self, v: int) -> None:
        self._g_peak.set(int(v))

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, rid: int) -> bool:
        return rid in self._entries

    @property
    def resident_bytes(self) -> int:
        return sum(d.nbytes for d in self._entries.values())

    def put(self, rid: int, data: SwapData) -> None:
        if rid in self._entries:
            raise ValueError(f"swap store: request {rid} already resident")
        if self.faults is not None and \
                self.faults.should_fire("swap_corrupt",
                                        rid=rid) is not None:
            # poison the host payload in place: the restore writes it
            # back and the next decode window's health guard quarantines
            # exactly this request
            corrupt_swap_payload(data.pages)
        self._entries[rid] = data
        self._c_out.inc(data.nbytes)
        self._g_peak.set_max(self.resident_bytes)

    def pop(self, rid: int) -> SwapData:
        if rid not in self._entries:
            raise KeyError(f"swap store: request {rid} is not resident")
        data = self._entries.pop(rid)
        self._c_in.inc(data.nbytes)
        return data

    def reset_counters(self) -> None:
        """Zero the traffic counters; the resident peak re-anchors to the
        bytes still held (entries survive a measurement reset)."""
        self._c_out.set(0)
        self._c_in.set(0)
        self._g_peak.set(self.resident_bytes)
