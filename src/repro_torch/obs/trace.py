"""Per-request lifecycle tracing with Chrome/Perfetto trace export.

Every submitted request gets a ``RequestTrace``: a span tree recording
the lifecycle ``queued -> admitted -> [prefix_hit] -> chunk_prefill[i]
-> decode -> finished|preempted|cancelled|timeout`` plus per-token
emission timestamps, TTFT, preemption count, prefix-hit tokens, and
peak blocks held.  Timestamps come from the *engine's* injectable clock
(``Engine(clock=...)``), so traces are fully deterministic under test.

``Tracer.export()`` emits Chrome ``trace_event`` JSON (the classic
array-of-events format): each request maps to its own ``tid`` inside
one ``pid``, spans become ``"X"`` complete events (``ts``/``dur`` in
microseconds), token emissions and prefix hits become ``"i"`` instant
events, and ``"M"`` metadata events name the rows.  The file opens
directly in ``ui.perfetto.dev`` or ``chrome://tracing``.

Span integrity is a test invariant: ``RequestTrace.validate()`` checks
that a finished request's tree is *balanced* -- every span that was
opened is closed, exactly one root "request" span covers the lifetime,
and no event timestamps fall outside it.  The reference package's
``tests/test_obs.py`` runs this for every request in preemption/cancel/timeout walks.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

__all__ = ["Span", "RequestTrace", "Tracer"]

_US = 1e6   # clock is in seconds; trace_event wants microseconds


class Span:
    """One closed-or-open interval in a request's lifecycle."""

    __slots__ = ("name", "t0", "t1", "args")

    def __init__(self, name: str, t0: float,
                 args: Optional[Dict[str, Any]] = None) -> None:
        self.name = name
        self.t0 = t0
        self.t1: Optional[float] = None
        self.args = args or {}

    @property
    def open(self) -> bool:
        return self.t1 is None

    def close(self, t1: float) -> None:
        if self.t1 is not None:
            raise RuntimeError(f"span {self.name!r} closed twice")
        self.t1 = t1

    def __repr__(self) -> str:
        end = "open" if self.open else f"{self.t1:.6f}"
        return f"Span({self.name}, {self.t0:.6f}..{end})"


class RequestTrace:
    """Span tree + event log for one request's lifetime."""

    def __init__(self, rid: int, label: str, t_submit: float) -> None:
        self.rid = rid
        self.label = label
        self.t_submit = t_submit
        self.t_finish: Optional[float] = None
        self.finish_reason: Optional[str] = None
        self.spans: List[Span] = []          # closed-or-open, in t0 order
        self._open: Dict[str, Span] = {}     # name -> currently open span
        self.instants: List[Dict[str, Any]] = []
        self.token_times: List[float] = []
        self.ttft: Optional[float] = None
        self.n_preemptions = 0
        self.n_chunks = 0
        self.prefix_hit_tokens = 0
        self.peak_blocks = 0

    # -- span API -------------------------------------------------------
    def begin(self, name: str, t: float,
              args: Optional[Dict[str, Any]] = None) -> Span:
        if name in self._open:
            raise RuntimeError(
                f"req {self.rid}: span {name!r} already open")
        s = Span(name, t, args)
        self._open[name] = s
        self.spans.append(s)
        return s

    def end(self, name: str, t: float,
            args: Optional[Dict[str, Any]] = None) -> None:
        s = self._open.pop(name, None)
        if s is None:
            raise RuntimeError(
                f"req {self.rid}: end of unopened span {name!r}")
        if args:
            s.args.update(args)
        s.close(t)

    def complete(self, name: str, t0: float, t1: float,
                 args: Optional[Dict[str, Any]] = None) -> None:
        """Record an already-closed span (no open/close pairing)."""
        s = Span(name, t0, args)
        s.close(t1)
        self.spans.append(s)

    def instant(self, name: str, t: float,
                args: Optional[Dict[str, Any]] = None) -> None:
        self.instants.append(dict(name=name, t=t, args=args or {}))

    # -- lifecycle bookkeeping -----------------------------------------
    def token(self, t: float, index: int, tok: int) -> None:
        if self.ttft is None:
            self.ttft = t - self.t_submit
        self.token_times.append(t)
        self.instant("token", t, dict(index=index, id=int(tok)))

    def finish(self, t: float, reason: str) -> None:
        # close anything still open (e.g. "running" on cancel mid-step)
        for name in list(self._open):
            self.end(name, t)
        self.t_finish = t
        self.finish_reason = reason

    @property
    def done(self) -> bool:
        return self.t_finish is not None

    def intertoken(self) -> List[float]:
        tt = self.token_times
        return [b - a for a, b in zip(tt, tt[1:])]

    # -- invariants -----------------------------------------------------
    def validate(self) -> None:
        """Balanced-tree check for a finished request.  Raises on any
        dangling span or event outside the request envelope."""
        if not self.done:
            raise AssertionError(f"req {self.rid}: not finished")
        if self._open:
            raise AssertionError(
                f"req {self.rid}: dangling spans {list(self._open)}")
        t0, t1 = self.t_submit, self.t_finish
        for s in self.spans:
            if s.open:
                raise AssertionError(
                    f"req {self.rid}: unclosed span {s!r}")
            if not (t0 <= s.t0 <= s.t1 <= t1):
                raise AssertionError(
                    f"req {self.rid}: span {s!r} outside envelope "
                    f"[{t0}, {t1}]")
        for ev in self.instants:
            if not (t0 <= ev["t"] <= t1):
                raise AssertionError(
                    f"req {self.rid}: instant {ev['name']!r}@{ev['t']} "
                    f"outside envelope [{t0}, {t1}]")
        if self.finish_reason is None:
            raise AssertionError(f"req {self.rid}: no finish_reason")

    # -- export ---------------------------------------------------------
    def _events(self, pid: int) -> List[Dict[str, Any]]:
        tid = self.rid
        ev: List[Dict[str, Any]] = [dict(
            ph="M", pid=pid, tid=tid, name="thread_name",
            args=dict(name=self.label))]
        root_args = dict(finish_reason=self.finish_reason,
                         ttft=self.ttft,
                         n_tokens=len(self.token_times),
                         n_preemptions=self.n_preemptions,
                         n_chunks=self.n_chunks,
                         prefix_hit_tokens=self.prefix_hit_tokens,
                         peak_blocks=self.peak_blocks)
        ev.append(dict(ph="X", pid=pid, tid=tid, name="request",
                       cat="request", ts=self.t_submit * _US,
                       dur=(self.t_finish - self.t_submit) * _US,
                       args=root_args))
        for s in self.spans:
            ev.append(dict(ph="X", pid=pid, tid=tid, name=s.name,
                           cat="lifecycle", ts=s.t0 * _US,
                           dur=(s.t1 - s.t0) * _US, args=s.args))
        for i in self.instants:
            ev.append(dict(ph="i", pid=pid, tid=tid, name=i["name"],
                           cat="event", ts=i["t"] * _US, s="t",
                           args=i["args"]))
        return ev


class Tracer:
    """Registry of per-request traces; owns nothing but the dict."""

    PID = 1

    def __init__(self) -> None:
        self.traces: Dict[int, RequestTrace] = {}
        self._next_rid = 0

    def start(self, t_submit: float,
              label: Optional[str] = None) -> RequestTrace:
        rid = self._next_rid
        self._next_rid += 1
        tr = RequestTrace(rid, label or f"req {rid}", t_submit)
        self.traces[rid] = tr
        return tr

    def validate_all(self) -> None:
        for tr in self.traces.values():
            tr.validate()

    def export(self) -> Dict[str, Any]:
        """Chrome trace_event JSON object (``{"traceEvents": [...]}``)."""
        events: List[Dict[str, Any]] = [dict(
            ph="M", pid=self.PID, tid=0, name="process_name",
            args=dict(name="repro serving engine"))]
        for rid in sorted(self.traces):
            events.extend(self.traces[rid]._events(self.PID))
        return dict(traceEvents=events, displayTimeUnit="ms")

    def export_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.export(), f, indent=1)
