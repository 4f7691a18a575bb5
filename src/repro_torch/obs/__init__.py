"""Observability for the serving stack: metrics, traces, hooks.

Dependency-free telemetry threaded through the engine / scheduler /
paged pool (a port of the reference ``repro.obs`` package):

* :mod:`repro_torch.obs.metrics` -- counters, gauges, fixed-bucket
  histograms in one :class:`MetricsRegistry` namespace with
  Prometheus-style text exposition (``registry.render()``).  The
  pool's and scheduler's legacy counter attributes (``pool.n_cow``,
  ``sch.n_preemptions``, ...) and their ``report()`` dicts are
  snapshots of this registry -- one source of truth.
* :mod:`repro_torch.obs.trace` -- per-request lifecycle span trees
  (``queued -> running -> chunk_prefill[i] -> decode -> finish``)
  exportable as Chrome/Perfetto ``trace_event`` JSON.
* :mod:`repro_torch.obs.hooks` -- the :class:`ServingObs` facade the stack
  reports through, and its no-op twin :data:`NULL_OBS` (the default:
  observability off costs one no-op call per event and leaves the hot
  path token-identical).

Enable per engine: ``Engine(..., metrics=True)`` (or pass a
``MetricsRegistry`` / ``ServingObs``); then ``eng.obs.registry.render()``
for the Prometheus snapshot and ``eng.obs.tracer.export()`` for the
Perfetto timeline.
"""

from repro_torch.obs.hooks import NULL_OBS, ServingObs
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                               LATENCY_BUCKETS, TOKEN_BUCKETS)
from repro_torch.obs.trace import RequestTrace, Span, Tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "LATENCY_BUCKETS", "TOKEN_BUCKETS",
    "Span", "RequestTrace", "Tracer",
    "ServingObs", "NULL_OBS",
]
