"""Structured telemetry: one event stream for the whole training stack.

The port's copy of ``repro.obs.telemetry`` (stdlib only, so the port keeps
its own rather than importing the JAX package); the event schema, the
sinks and the disabled path are the reference's, line for line, so
``tools/obs_report.py`` renders a port run's log unchanged.

FedHeN's claims are *trajectories* — bytes per round, rounds to a target
accuracy, straggler/staleness behaviour across a heterogeneous cohort —
yet until this module the repo's metrics were ad-hoc dicts printed from
the round loop, invisible to the async and quantization machinery.  This
is the one instrumentation substrate everything reports through:

* **Events** are plain JSON-ready dicts (no classes on the hot path, no
  dependencies beyond the stdlib — this module never imports torch).  Four
  kinds:

  - ``span``    — one phase of a round, in a tree addressed by ``path``
                  (e.g. ``round/execute``).  ``dur_s`` is wall seconds
                  for host-measured spans and ``None`` for *logical*
                  spans: the phases of a round's execute step (broadcast
                  → train-chunk[t] → fold → finalize) are real structure
                  with real attributes (staleness, wire dtype), but their
                  wall time is attributed to the enclosing ``execute``
                  span, as in the reference, never invented per phase.
  - ``counter`` — one named scalar (client-health: NaN-excluded devices,
                  weight-0 padding, version-cache hits/misses).
  - ``ledger``  — one named dict of related values (per-round comm
                  bytes, the compiled round's roofline numbers, eval
                  metrics, run config).
  - ``log``     — one verbatim human line (the round loop's existing
                  print format routes through here bit-identically).

* **Sinks** receive every event: :class:`StdoutSink` (prints ``log``
  lines verbatim — the legacy print path), :class:`JsonlSink` (one JSON
  object per line — the run log ``tools/obs_report.py`` renders), and
  :class:`MemorySink` (in-process list, what the tests assert against).

* **Disabled is the default and costs (almost) nothing.**  The module
  singleton :data:`NOOP` — and any ``Telemetry(enabled=False)`` — takes
  an early-return path: ``span`` hands back one shared re-entrant no-op
  context manager and every emit method returns before building an event
  dict.  ``chip_smoke.py`` phase 13 prints the enabled path's round wall
  beside the disabled one's on the card.

Every event carries ``seq`` (emission order), ``round`` (the trainer
stamps it via :meth:`Telemetry.set_round`), and ``t`` (wall clock).
Attribute values must be JSON-serializable scalars; :func:`jsonable`
coerces numpy scalars and torch 0-d tensors at the sink boundary so the
hot path never imports them.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, IO, List, Optional, Sequence

EVENT_KINDS = ("span", "counter", "ledger", "log")


def jsonable(value: Any) -> Any:
    """Coerce a value to something ``json.dumps`` accepts: stdlib scalars
    pass through; numpy scalars and zero-dim arrays and torch 0-d tensors
    go through their ``item()``; anything else falls back to ``str``."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, dict):
        return {str(k): jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [jsonable(v) for v in value]
    item = getattr(value, "item", None)
    if callable(item):
        try:
            return jsonable(item())
        except (TypeError, ValueError):
            pass
    return str(value)


# ---------------------------------------------------------------------------
# Sinks
# ---------------------------------------------------------------------------

class Sink:
    """One consumer of the event stream.  ``emit`` receives every event
    dict (already JSON-ready); ``close`` flushes whatever the sink
    buffers.  Sinks must not mutate the event (it is shared)."""

    def emit(self, event: Dict[str, Any]) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class MemorySink(Sink):
    """Keeps every event in ``self.events`` — the test sink."""

    def __init__(self):
        self.events: List[Dict[str, Any]] = []

    def emit(self, event: Dict[str, Any]) -> None:
        self.events.append(event)

    def of_kind(self, kind: str) -> List[Dict[str, Any]]:
        return [e for e in self.events if e["kind"] == kind]

    def named(self, name: str) -> List[Dict[str, Any]]:
        return [e for e in self.events if e.get("name") == name]


class StdoutSink(Sink):
    """Prints ``log`` events' message VERBATIM (the legacy print-based
    round logging routes through here, so the line format stays
    bit-identical to the pre-telemetry CLI).  Other kinds are dropped
    unless ``verbose=True``, which renders them as compact one-liners."""

    def __init__(self, verbose: bool = False):
        self.verbose = verbose

    def emit(self, event: Dict[str, Any]) -> None:
        if event["kind"] == "log":
            print(event["message"], flush=True)
        elif self.verbose:
            body = {k: v for k, v in event.items()
                    if k not in ("kind", "name", "seq", "t")}
            print(f"[obs] {event['kind']} {event.get('name', '')} {body}",
                  flush=True)


class JsonlSink(Sink):
    """Appends one JSON object per event to a file — the run log.

    The file handle is opened lazily on the first event and line-buffered
    so a crashed run still leaves a readable log.  ``tools/obs_report.py``
    renders the result.
    """

    def __init__(self, path: str):
        self.path = path
        self._fh: Optional[IO[str]] = None

    def emit(self, event: Dict[str, Any]) -> None:
        if self._fh is None:
            self._fh = open(self.path, "w", buffering=1)
        self._fh.write(json.dumps(event) + "\n")

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class NullSink(Sink):
    """Swallows everything.  A telemetry-ENABLED run with only this sink
    must be bit-identical to a telemetry-off run (test-enforced): sinks
    observe the round, they never steer it."""

    def emit(self, event: Dict[str, Any]) -> None:
        pass


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

class _NullSpan:
    """Shared re-entrant no-op context manager — the disabled ``span``
    path.  One instance serves every call site (no allocation)."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """A timed phase: enters the telemetry's span stack (its name becomes
    a path segment for everything emitted inside) and emits one ``span``
    event with measured ``dur_s`` on exit."""
    __slots__ = ("_tel", "name", "attrs", "_t0")

    def __init__(self, tel: "Telemetry", name: str,
                 attrs: Optional[Dict[str, Any]]):
        self._tel = tel
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        self._tel._stack.append(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self._t0
        tel = self._tel
        tel._stack.pop()
        tel._emit("span", self.name, path=tel._path(self.name),
                  dur_s=dur, attrs=self.attrs)
        return False


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------

class Telemetry:
    """The event registry one training run reports through.

    Args:
      sinks: consumers of the event stream (default: none — events are
        still assembled unless ``enabled=False``; pass :class:`NullSink`
        to measure the enabled path without I/O).
      enabled: ``False`` short-circuits every method before any event
        dict is built — the no-op path the :data:`NOOP` singleton and a
        plain (un-instrumented) trainer share.

    The span stack is **host-thread-local by construction** (one
    Telemetry per trainer, driven from the round loop); it is not safe to
    share one instance across threads.
    """

    def __init__(self, sinks: Sequence[Sink] = (), *, enabled: bool = True):
        self.sinks: List[Sink] = list(sinks)
        self.enabled = bool(enabled)
        self.current_round: Optional[int] = None
        self._stack: List[str] = []
        self._seq = 0

    # -- lifecycle -----------------------------------------------------------

    def add_sink(self, sink: Sink) -> "Telemetry":
        self.sinks.append(sink)
        return self

    def close(self) -> None:
        for s in self.sinks:
            s.close()

    def set_round(self, round_index: int) -> None:
        """Stamp subsequent events with this round index (the trainer
        calls it at round entry)."""
        if self.enabled:
            self.current_round = int(round_index)

    # -- emission ------------------------------------------------------------

    def _path(self, leaf: str) -> str:
        return "/".join(self._stack + [leaf])

    def _emit(self, kind: str, name: str, **fields) -> None:
        attrs = fields.pop("attrs", None)
        event: Dict[str, Any] = {
            "kind": kind, "name": name, "seq": self._seq,
            "round": self.current_round, "t": time.time(),
        }
        if attrs:
            event.update({k: jsonable(v) for k, v in attrs.items()})
        for k, v in fields.items():
            event[k] = jsonable(v)
        self._seq += 1
        for s in self.sinks:
            s.emit(event)

    def span(self, name: str, **attrs):
        """Timed context manager: wall time between enter and exit is the
        span's ``dur_s``; events emitted inside nest under its path."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, attrs or None)

    def point_span(self, name: str, **attrs):
        """A *logical* span: structure + attributes, ``dur_s=None``.

        Used for the phases inside a round's execute step (broadcast /
        train-chunk[t] / fold / finalize): they are real stages of the
        round, but their wall time is only measured at the execute
        step's boundary, so none is invented — the enclosing ``execute``
        span owns the clock."""
        if not self.enabled:
            return
        self._emit("span", name, path=self._path(name), dur_s=None,
                   attrs=attrs or None)

    def counter(self, name: str, value, **attrs) -> None:
        """One named scalar observation (client health lives here)."""
        if not self.enabled:
            return
        self._emit("counter", name, value=value, attrs=attrs or None)

    def ledger(self, name: str, values: Dict[str, Any], **attrs) -> None:
        """One named dict of related values (comm bytes, roofline, eval
        metrics, run config)."""
        if not self.enabled:
            return
        self._emit("ledger", name, values=jsonable(values),
                   attrs=attrs or None)

    def log(self, message: str) -> None:
        """One verbatim human line.  :class:`StdoutSink` prints exactly
        ``message`` — the legacy round-loop print format survives
        bit-identically."""
        if not self.enabled:
            return
        self._emit("log", "log", message=str(message))


#: The module-wide disabled singleton: what every un-instrumented trainer
#: runs against.  Never add sinks to it.
NOOP = Telemetry(enabled=False)


def coalesce(telemetry: Optional[Telemetry]) -> Telemetry:
    """``None`` -> the :data:`NOOP` singleton (the constructor-default
    dance every instrumented component does)."""
    return NOOP if telemetry is None else telemetry


# ---------------------------------------------------------------------------
# Run-log reading (the reporter's input side lives with the schema)
# ---------------------------------------------------------------------------

def read_jsonl(path: str) -> List[Dict[str, Any]]:
    """Parse a :class:`JsonlSink` run log back into event dicts (blank
    and truncated trailing lines are skipped — crashed runs stay
    readable)."""
    events = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return events
