"""Observability: structured telemetry for the port's training stack.

The port's copy of ``repro.obs`` (stdlib only; nothing of the JAX package
is imported):

* :mod:`repro_torch.obs.telemetry` — the event registry
  (:class:`Telemetry`), sinks (:class:`MemorySink`, :class:`JsonlSink`,
  :class:`StdoutSink`, :class:`NullSink`), and the disabled :data:`NOOP`
  singleton.
* :mod:`repro_torch.obs.report` — renders a JSONL run log into the
  summary ``tools/obs_report.py`` prints (``python -m
  repro_torch.obs.report`` is the port's own command line).
"""

from repro_torch.obs.telemetry import (  # noqa: F401
    NOOP,
    JsonlSink,
    MemorySink,
    NullSink,
    Sink,
    StdoutSink,
    Telemetry,
    coalesce,
    jsonable,
    read_jsonl,
)
