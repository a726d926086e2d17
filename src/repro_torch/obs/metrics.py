"""Metrics registry for the serving stack (dependency-free).

One :class:`MetricsRegistry` owns every counter a serving process
maintains; the engine, scheduler and block manager register their series
here instead of keeping ad-hoc ``self.n_*`` attributes, so
``registry.reset()`` restarts every measurement window at once and
``registry.snapshot()`` is the single structured view of them.

The continuous engine's series: ``engine.steps``, ``engine.syncs``,
``engine.generated_tokens``, ``engine.prefill_batches``,
``engine.quarantined`` (requests the numeric-health guard parked) and
``engine.phase_s`` (labeled by phase); the block manager's
``pages.allocated`` and ``pages.released``.

A :class:`Counter` holds labeled series (a series is keyed by its sorted
``(label, value)`` pairs; the empty label set is a plain scalar) and only
accumulates (``inc``); values may be float (phase wall-clock seconds
accumulate here too).  Gauges and histograms come with the slices that
need them.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def rate(count: float, seconds: float) -> float:
    """Throughput that tolerates degenerate windows: a zero-decode or
    zero-duration run reports 0.0 instead of raising ZeroDivisionError."""
    return count / seconds if seconds > 0 else 0.0


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


class MetricsRegistry:
    """Get-or-create home for every counter of one serving process:
    ``counter`` returns the existing counter when the name is already
    registered, so subsystems sharing a registry converge on the same
    series without coordination."""

    def __init__(self):
        self._metrics: Dict[str, Counter] = {}

    def counter(self, name: str, help: str = "") -> Counter:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = Counter(name, help)
        return m

    def get(self, name: str) -> Optional[Counter]:
        return self._metrics.get(name)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def reset(self) -> None:
        """Zero every registered series (the counters stay registered)."""
        for m in self._metrics.values():
            m.reset()

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """Nested plain-data view ``{"counters": {name: value-or-series}}``,
        JSON-serializable."""
        return {"counters": {name: self._metrics[name].snapshot()
                             for name in sorted(self._metrics)}}
