"""Dependency-free metrics registry: counters, gauges, histograms.

The serving stack (engine / scheduler / paged pool) reports through one
``MetricsRegistry`` namespace so the ``report()`` dicts, the benchmark
scripts, and a scraped ``/metrics`` endpoint can never drift apart: the
registry *is* the source of truth and ``report()`` is a snapshot of it.

Design constraints :

* **No dependencies** -- plain Python, no prometheus_client.
* **Hot-path cost == a plain int add.**  ``Counter.inc`` / ``Gauge.set``
  mutate a float attribute; no locks, no dict lookups on the hot path
  (label children are resolved once and cached by the caller).
* **Allocation-free when disabled.**  Call sites that need timing or
  per-step work go through the ``ServingObs`` facade (obs/hooks.py)
  whose no-op twin ``NULL_OBS`` makes every hook a constant-return
  method -- the registry itself is cheap enough to always be live for
  event counters, which is what keeps legacy ``pool.n_cow``-style
  attributes exact.

Exposition is Prometheus text format 0.0.4 via ``registry.render()``::

    # HELP repro_pool_cow_total copy-on-write block copies
    # TYPE repro_pool_cow_total counter
    repro_pool_cow_total 3

Histograms are fixed-bucket (chosen at declaration), rendering the
standard cumulative ``_bucket{le=...}`` / ``_sum`` / ``_count`` series.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "LATENCY_BUCKETS", "TOKEN_BUCKETS",
]

# default bucket ladders ------------------------------------------------
# seconds: 100us .. 30s, roughly x3 steps -- covers TTFT and inter-token
# latency on anything from a stubbed clock to a CPU interpret run
LATENCY_BUCKETS = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3,
                   1.0, 3.0, 10.0, 30.0)
# token counts: powers of two up to a long prompt
TOKEN_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


def _fmt_label_values(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


def _fmt_num(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


class _Metric:
    """Base: a named family of children keyed by label values."""

    kind = "untyped"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = ()) -> None:
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children: Dict[Tuple[str, ...], "_Metric"] = {}
        # the unlabeled metric acts as its own (sole) child
        if not self.labelnames:
            self._children[()] = self

    def labels(self, **kv: str) -> "_Metric":
        """Resolve (and cache) the child for a label-value combination.

        Resolve once at setup, hold the child: the returned object's
        ``inc``/``set``/``observe`` are then plain attribute mutations.
        """
        if tuple(kv) != self.labelnames:
            raise ValueError(
                f"{self.name}: labels {tuple(kv)} != declared "
                f"{self.labelnames}")
        key = tuple(str(kv[k]) for k in self.labelnames)
        child = self._children.get(key)
        if child is None:
            child = self._make_child()
            self._children[key] = child
        return child

    def _make_child(self) -> "_Metric":
        raise NotImplementedError

    # -- exposition -----------------------------------------------------
    def _sample_lines(self) -> List[str]:
        raise NotImplementedError

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        for key in sorted(self._children):
            child = self._children[key]
            labels = tuple(zip(self.labelnames, key))
            lines.extend(child._render_samples(labels))
        return "\n".join(lines) + "\n"

    def _render_samples(
            self, labels: Tuple[Tuple[str, str], ...]) -> List[str]:
        raise NotImplementedError


class Counter(_Metric):
    """Monotonically increasing count; rendered as ``<name>_total``."""

    kind = "counter"

    def __init__(self, name, help, labelnames=()):
        super().__init__(name, help, labelnames)
        self.value = 0.0

    def _make_child(self):
        c = Counter(self.name, self.help)
        return c

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    @property
    def total_name(self) -> str:
        return self.name if self.name.endswith("_total") \
            else self.name + "_total"

    def _render_samples(self, labels):
        return [f"{self.total_name}{_fmt_label_values(labels)} "
                f"{_fmt_num(self.value)}"]


class Gauge(_Metric):
    """A value that can go up and down (occupancy, batch lanes, ...)."""

    kind = "gauge"

    def __init__(self, name, help, labelnames=()):
        super().__init__(name, help, labelnames)
        self.value = 0.0

    def _make_child(self):
        return Gauge(self.name, self.help)

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.value -= amount

    def _render_samples(self, labels):
        return [f"{self.name}{_fmt_label_values(labels)} "
                f"{_fmt_num(self.value)}"]


class Histogram(_Metric):
    """Fixed-bucket histogram with cumulative Prometheus exposition."""

    kind = "histogram"

    def __init__(self, name, help, labelnames=(),
                 buckets: Sequence[float] = LATENCY_BUCKETS):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * (len(self.buckets) + 1)   # +1 for +Inf
        self.sum = 0.0
        self.count = 0

    def _make_child(self):
        return Histogram(self.name, self.help, buckets=self.buckets)

    def observe(self, value: float) -> None:
        self.sum += value
        self.count += 1
        # buckets are few (~12): linear scan beats bisect's call cost
        for i, b in enumerate(self.buckets):
            if value <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def percentile(self, q: float) -> float:
        """Approximate percentile: upper edge of the bucket holding the
        q-quantile observation (``inf`` if it lands in the overflow
        bucket).  Good enough for a stats bar; tests should compare
        within a bucket's tolerance, not exactly."""
        if not self.count:
            return 0.0
        rank = q / 100.0 * self.count
        seen = 0
        for i, b in enumerate(self.buckets):
            seen += self.counts[i]
            if seen >= rank:
                return b
        return float("inf")

    def _render_samples(self, labels):
        out = []
        cum = 0
        for i, b in enumerate(self.buckets):
            cum += self.counts[i]
            lb = labels + (("le", _fmt_num(b)),)
            out.append(f"{self.name}_bucket{_fmt_label_values(lb)} {cum}")
        lb = labels + (("le", "+Inf"),)
        out.append(f"{self.name}_bucket{_fmt_label_values(lb)} "
                   f"{self.count}")
        out.append(f"{self.name}_sum{_fmt_label_values(labels)} "
                   f"{_fmt_num(self.sum)}")
        out.append(f"{self.name}_count{_fmt_label_values(labels)} "
                   f"{self.count}")
        return out


class MetricsRegistry:
    """A named collection of metrics with Prometheus text exposition.

    ``counter``/``gauge``/``histogram`` are get-or-create: declaring the
    same name twice returns the existing metric (so the pool, scheduler,
    and engine can share one registry without coordinating declaration
    order), but redeclaring with a different kind raises.
    """

    def __init__(self) -> None:
        self._metrics: Dict[str, _Metric] = {}

    def _declare(self, cls, name, help, labelnames, **kw) -> _Metric:
        m = self._metrics.get(name)
        if m is not None:
            if type(m) is not cls or m.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name!r} redeclared with different "
                    f"kind/labels")
            return m
        m = cls(name, help, labelnames, **kw)
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._declare(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._declare(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = LATENCY_BUCKETS
                  ) -> Histogram:
        return self._declare(Histogram, name, help, labelnames,
                             buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def value(self, name: str, **labels: str) -> float:
        """Current value of a counter/gauge (0 if undeclared)."""
        m = self._metrics.get(name)
        if m is None:
            return 0.0
        child = m.labels(**labels) if labels else m
        return child.value

    def snapshot(self) -> Dict[str, float]:
        """Flat ``{name{labels}: value}`` dict of counters and gauges
        (histograms contribute ``_sum`` and ``_count``)."""
        out: Dict[str, float] = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            for key in sorted(m._children):
                child = m._children[key]
                suffix = _fmt_label_values(
                    tuple(zip(m.labelnames, key)))
                if isinstance(child, Histogram):
                    out[f"{name}_sum{suffix}"] = child.sum
                    out[f"{name}_count{suffix}"] = float(child.count)
                elif isinstance(child, Counter):
                    out[f"{child.total_name}{suffix}"] = child.value
                else:
                    out[f"{name}{suffix}"] = child.value
        return out

    def render(self) -> str:
        """Prometheus text exposition (format 0.0.4) of every metric."""
        return "".join(self._metrics[n].render()
                       for n in sorted(self._metrics))
