"""Metrics registry for the serving stack (dependency-free).

One :class:`MetricsRegistry` owns every counter and gauge a serving
process maintains; the engine, scheduler, block manager and prefix cache
register their series here instead of keeping ad-hoc ``self.n_*``
attributes, so ``registry.reset()`` restarts every measurement window
at once and ``registry.snapshot()`` is the single structured view of
them.

The continuous engine's series: ``engine.steps``, ``engine.syncs``,
``engine.generated_tokens``, ``engine.prefill_batches``,
``engine.prefill_tokens`` (prompt positions prefilled), ``engine.cow_forks``,
``engine.quarantined`` (requests the numeric-health guard parked) and
``engine.phase_s`` (labeled by phase), with the gauges
``pages.peak_mapped`` and ``pages.peak_shared``; the block manager's
``pages.allocated``, ``pages.shared_mapped``, ``pages.cow_forks`` and
``pages.released``; the prefix cache's ``prefix.lookups``,
``prefix.hits`` and ``prefix.tokens_matched``; preempt-and-swap's
``engine.preemptions`` / ``engine.restores``, ``sched.preemptions`` /
``sched.restores`` and the swap store's ``swap.bytes_out`` /
``swap.bytes_in`` with the gauge ``swap.peak_resident_bytes``; and the
histogram ``engine.window_steps`` (decode steps per window).  The async
front end keeps its own registry (``server.accepted``,
``server.rejected``, ``server.retried``, ``server.failed``).

A :class:`Counter` holds labeled series (a series is keyed by its sorted
``(label, value)`` pairs; the empty label set is a plain scalar) and
accumulates (``inc``); values may be float (phase wall-clock seconds
accumulate here too), and ``set`` exists only for snapshot restore,
which rewinds counters.  A :class:`Gauge` is a level (``set``), with
``set_max`` for peaks.  A :class:`Histogram` keeps its raw samples and
reports nearest-rank percentiles (:func:`percentile`, the one
implementation the front end and the launcher share).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def rate(count: float, seconds: float) -> float:
    """Throughput that tolerates degenerate windows: a zero-decode or
    zero-duration run reports 0.0 instead of raising ZeroDivisionError."""
    return count / seconds if seconds > 0 else 0.0


def percentile(samples: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (no interpolation): the ceil(q/100 * n)-th
    smallest sample.  Any percentile of one sample is that sample; an
    empty sample set or q outside (0, 100] raises ValueError."""
    if not samples:
        raise ValueError("percentile of an empty sample set")
    if not 0 < q <= 100:
        raise ValueError(f"q must be in (0, 100], got {q}")
    s = sorted(samples)
    return s[max(1, math.ceil((q / 100.0) * len(s))) - 1]


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _key_str(key: LabelKey) -> str:
    return ",".join(f"{k}={v}" for k, v in key)


class Counter:
    """Monotone accumulator over labeled series."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._series: Dict[LabelKey, float] = {}

    def labels(self) -> List[LabelKey]:
        return sorted(self._series)

    def reset(self) -> None:
        self._series.clear()

    def inc(self, amount: float = 1, **labels) -> None:
        if amount < 0:
            raise ValueError(
                f"counter {self.name}: negative increment {amount}")
        key = _label_key(labels)
        self._series[key] = self._series.get(key, 0) + amount

    def set(self, value: float, **labels) -> None:
        """Overwrite the series: snapshot restore only (a rewind to a
        checkpoint moves a counter backwards)."""
        self._series[_label_key(labels)] = value

    def value(self, **labels) -> float:
        return self._series.get(_label_key(labels), 0)

    def snapshot(self):
        if not self._series:
            return 0
        if list(self._series) == [()]:
            return self._series[()]
        return {_key_str(k): v for k, v in sorted(self._series.items())}

    def __repr__(self) -> str:
        return (f"<Counter {self.name!r} {len(self._series)} series>")


class Gauge(Counter):
    """Last-write-wins level; ``set_max`` tracks peaks."""

    kind = "gauge"

    def inc(self, amount: float = 1, **labels) -> None:
        raise TypeError(f"gauge {self.name}: use set or set_max")

    def set_max(self, value: float, **labels) -> None:
        key = _label_key(labels)
        self._series[key] = max(self._series.get(key, value), value)

    def __repr__(self) -> str:
        return f"<Gauge {self.name!r} {len(self._series)} series>"


class Histogram:
    """Raw samples per labeled series, with nearest-rank percentiles."""

    kind = "histogram"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._series: Dict[LabelKey, List[float]] = {}

    def reset(self) -> None:
        self._series.clear()

    def observe(self, value: float, **labels) -> None:
        self._series.setdefault(_label_key(labels), []).append(float(value))

    def values(self, **labels) -> List[float]:
        return list(self._series.get(_label_key(labels), []))

    def count(self, **labels) -> int:
        return len(self._series.get(_label_key(labels), []))

    def percentile(self, q: float, **labels) -> float:
        return percentile(self._series.get(_label_key(labels), []), q)

    @staticmethod
    def _stats(vals: List[float]) -> Dict[str, float]:
        out = {"count": len(vals), "sum": float(sum(vals))}
        if vals:
            out.update(min=min(vals), max=max(vals),
                       p50=percentile(vals, 50), p99=percentile(vals, 99))
        return out

    def snapshot(self):
        if list(self._series) in ([], [()]):
            return self._stats(self._series.get((), []))
        return {_key_str(k): self._stats(v)
                for k, v in sorted(self._series.items())}

    def __repr__(self) -> str:
        return f"<Histogram {self.name!r} {len(self._series)} series>"


class MetricsRegistry:
    """Get-or-create home for every metric of one serving process:
    ``counter`` returns the existing counter when the name is already
    registered, so subsystems sharing a registry converge on the same
    series without coordination."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _get(self, cls, name: str, help: str):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, help)
        if type(m) is not cls:
            raise TypeError(f"metric {name} is a {m.kind}, not a "
                            f"{cls.kind}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get(Histogram, name, help)

    def get(self, name: str) -> Optional[object]:
        return self._metrics.get(name)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def reset(self) -> None:
        """Zero every registered series (the counters stay registered)."""
        for m in self._metrics.values():
            m.reset()

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """Nested plain-data view ``{"counters": {name: value-or-series},
        "gauges": {...}, "histograms": {...}}``, JSON-serializable."""
        out: Dict[str, Dict[str, object]] = {"counters": {}, "gauges": {},
                                             "histograms": {}}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            out[m.kind + "s"][name] = m.snapshot()
        return out
