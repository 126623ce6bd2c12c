"""Render a telemetry JSONL run log into a human-readable summary.

The port's copy of ``repro.obs.report`` (stdlib only): for the same event
stream it renders the same string.  ``python -m repro_torch.obs.report``
is its command line, with the flags of ``tools/obs_report.py`` (which
renders a port run's log as well).  Input is the event stream a
:class:`JsonlSink` wrote — see :mod:`repro_torch.obs.telemetry` for the
schema.  Output sections:

* **run** — the ``run_config`` ledger (algorithm, cohort geometry, wire).
* **rounds** — count, median/total wall clock per phase from the timed
  spans, and the first round's compile-vs-execute split.
* **comm** — bytes/round (down, up) and cumulative totals from the
  ``comm_bytes`` ledgers, exactly the trainer's measured accounting.
* **client health** — NaN-excluded device total, weight-0 padding slots,
  the merged staleness histogram, and version-cache hit/miss counts.
* **progress** — eval-metric trajectory from ``eval`` ledgers and, when
  a target is given, rounds-to-target — the headline FedHeN comparison
  number.  Direction is inferred from the metric name: ``acc*``/``*acc*``
  metrics count as reached at-or-above the target, everything else
  (losses) at-or-below.

Everything here is stdlib-only and tolerant of partial logs: a crashed
run renders whatever was flushed.
"""

from __future__ import annotations

import argparse
import statistics
from typing import Any, Dict, List, Optional

from repro_torch.obs.telemetry import read_jsonl


def _median(xs: List[float]) -> Optional[float]:
    return statistics.median(xs) if xs else None


def higher_is_better(metric: str) -> bool:
    """Target direction inferred from the metric name: ``acc``-bearing
    metrics maximize (reached at-or-above), everything else — losses —
    minimizes (reached at-or-below).  Shared with
    ``core.federated.rounds_to_target`` so a run report and the in-process
    history agree on what "reached" means."""
    return "acc" in metric


def summarize(events: List[Dict[str, Any]],
              target: Optional[float] = None,
              target_metric: str = "loss_complex") -> Dict[str, Any]:
    """Digest an event stream into the report's section dict."""
    spans = [e for e in events if e.get("kind") == "span"]
    counters = [e for e in events if e.get("kind") == "counter"]
    ledgers = [e for e in events if e.get("kind") == "ledger"]

    def ledger_values(name: str) -> List[Dict[str, Any]]:
        return [e.get("values", {}) for e in ledgers if e.get("name") == name]

    # -- run config (first wins; there is one per run) ----------------------
    run_cfgs = ledger_values("run_config")
    run_config = run_cfgs[0] if run_cfgs else {}

    # -- spans: wall clock per phase name -----------------------------------
    durs: Dict[str, List[float]] = {}
    for s in spans:
        if s.get("dur_s") is not None:
            durs.setdefault(s["name"], []).append(float(s["dur_s"]))
    phase_wall = {
        name: {"n": len(xs), "median_s": _median(xs), "total_s": sum(xs)}
        for name, xs in sorted(durs.items())
    }
    rounds_seen = sorted({s["round"] for s in spans
                          if s.get("name") == "round"
                          and s.get("round") is not None})
    compile_s = sum(durs.get("compile", []))
    trace_lower_s = sum(durs.get("trace_lower", []))
    execute_med = _median(durs.get("execute", []))

    # -- comm ledgers -------------------------------------------------------
    comm = ledger_values("comm_bytes")
    comm_summary: Dict[str, Any] = {}
    if comm:
        last = comm[-1]
        comm_summary = {
            "rounds_accounted": len(comm),
            "bytes_down_per_round": _median(
                [c["down"] for c in comm if "down" in c]),
            "bytes_up_per_round": _median(
                [c["up"] for c in comm if "up" in c]),
            "cum_down": last.get("cum_down"),
            "cum_up": last.get("cum_up"),
            "cum_total": last.get("cum_total"),
        }

    # -- roofline (first-round lowered program) -----------------------------
    rooflines = ledger_values("roofline")
    roofline = rooflines[0] if rooflines else {}

    # -- client health ------------------------------------------------------
    def counter_total(name: str) -> int:
        return int(sum(c.get("value", 0) for c in counters
                       if c.get("name") == name))

    staleness: Dict[str, int] = {}
    for h in ledger_values("staleness_hist"):
        for k, v in h.items():
            staleness[k] = staleness.get(k, 0) + int(v)
    # participation histogram: last wins (cumulative over the run, unlike
    # the per-round staleness histograms which sum)
    part_hists = ledger_values("participation_hist")
    states = ledger_values("client_state")
    ef_stores = ledger_values("ef_store")
    health = {
        "nan_excluded_devices": counter_total("nan_excluded_devices"),
        "padding_weight0_clients": counter_total("padding_weight0_clients"),
        "version_cache_hit": counter_total("version_cache_hit"),
        "version_cache_miss": counter_total("version_cache_miss"),
        "staleness_hist": dict(sorted(staleness.items(),
                                      key=lambda kv: int(kv[0]))),
        "participation_hist": part_hists[-1] if part_hists else {},
        "client_state_bytes": (states[-1].get("state_bytes")
                               if states else None),
        # error-feedback residual store (last ledger wins — the byte
        # counters are cumulative over the run, like client_state)
        "ef_store": ef_stores[-1] if ef_stores else {},
    }

    # -- progress / rounds-to-target ----------------------------------------
    evals = [(e.get("round"), e.get("values", {}))
             for e in ledgers if e.get("name") == "eval"]
    trajectory = [(r, v.get(target_metric)) for r, v in evals
                  if v.get(target_metric) is not None]
    maximize = higher_is_better(target_metric)
    rounds_to_target = None
    if target is not None:
        for r, v in trajectory:
            if v is not None and (v >= target if maximize
                                  else v <= target):
                rounds_to_target = r
                break

    return {
        "run_config": run_config,
        "rounds": {
            "n_rounds": len(rounds_seen) or len(comm),
            "phase_wall": phase_wall,
            "compile_s": compile_s,
            "trace_lower_s": trace_lower_s,
            "execute_median_s": execute_med,
        },
        "comm": comm_summary,
        "roofline": roofline,
        "health": health,
        "progress": {
            "metric": target_metric,
            "target": target,
            "trajectory": trajectory,
            "rounds_to_target": rounds_to_target,
            "final": trajectory[-1][1] if trajectory else None,
        },
        "n_events": len(events),
    }


def _fmt_bytes(n: Optional[float]) -> str:
    if n is None:
        return "-"
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{n:.0f} B"
        n /= 1024
    return f"{n:.1f} GiB"


def _fmt_s(x: Optional[float]) -> str:
    return "-" if x is None else f"{x:.3f}s"


def render(summary: Dict[str, Any]) -> str:
    """Format a :func:`summarize` dict as the printed report."""
    lines: List[str] = []
    add = lines.append
    add("== telemetry run report ==")
    add(f"events: {summary['n_events']}")

    cfg = summary["run_config"]
    if cfg:
        add("")
        add("-- run --")
        for k in sorted(cfg):
            add(f"  {k}: {cfg[k]}")

    r = summary["rounds"]
    add("")
    add("-- rounds --")
    add(f"  rounds: {r['n_rounds']}")
    add(f"  compile (first round): {_fmt_s(r['compile_s'])} "
        f"(trace+lower {_fmt_s(r['trace_lower_s'])})")
    add(f"  execute median: {_fmt_s(r['execute_median_s'])}")
    for name, w in r["phase_wall"].items():
        add(f"  span {name}: n={w['n']} median={_fmt_s(w['median_s'])} "
            f"total={_fmt_s(w['total_s'])}")

    c = summary["comm"]
    if c:
        add("")
        add("-- comm --")
        add(f"  bytes/round down: {_fmt_bytes(c['bytes_down_per_round'])}  "
            f"up: {_fmt_bytes(c['bytes_up_per_round'])}")
        add(f"  cumulative: down {_fmt_bytes(c['cum_down'])}  "
            f"up {_fmt_bytes(c['cum_up'])}  "
            f"total {_fmt_bytes(c['cum_total'])}")

    roof = summary["roofline"]
    if roof:
        add("")
        add("-- roofline (lowered round) --")
        for k in sorted(roof):
            add(f"  {k}: {roof[k]}")

    h = summary["health"]
    add("")
    add("-- client health --")
    add(f"  NaN-excluded devices: {h['nan_excluded_devices']}")
    add(f"  weight-0 padding slots: {h['padding_weight0_clients']}")
    add(f"  version cache: {h['version_cache_hit']} hit / "
        f"{h['version_cache_miss']} miss")
    if h["staleness_hist"]:
        hist = "  ".join(f"s={k}:{v}" for k, v in h["staleness_hist"].items())
        add(f"  staleness histogram: {hist}")
    if h.get("participation_hist"):
        hist = "  ".join(f"n={k}:{v}"
                         for k, v in h["participation_hist"].items())
        add(f"  participation histogram: {hist}")
    if h.get("client_state_bytes") is not None:
        add(f"  client-state matrix: {_fmt_bytes(h['client_state_bytes'])}")
    ef = h.get("ef_store") or {}
    if ef:
        add(f"  error-feedback store: {_fmt_bytes(ef.get('store_bytes'))} "
            f"(gathered {_fmt_bytes(ef.get('cum_gathered_bytes'))}, "
            f"scattered {_fmt_bytes(ef.get('cum_scattered_bytes'))})")

    p = summary["progress"]
    if p["trajectory"]:
        add("")
        add("-- progress --")
        add(f"  metric: {p['metric']}  final: {p['final']:.4f}")
        if p["target"] is not None:
            hit = p["rounds_to_target"]
            add(f"  target {p['target']}: "
                + (f"reached at round {hit}" if hit is not None
                   else "not reached"))
    return "\n".join(lines)


def report_path(path: str, target: Optional[float] = None,
                target_metric: str = "loss_complex") -> str:
    """Read a JSONL run log and return the rendered report."""
    return render(summarize(read_jsonl(path), target=target,
                            target_metric=target_metric))


# ---------------------------------------------------------------------------
# Run comparison (A vs B diff of two summarized logs)
# ---------------------------------------------------------------------------

def _delta(a: Optional[float], b: Optional[float]) -> Optional[float]:
    return None if a is None or b is None else float(b) - float(a)


def compare_summaries(a: Dict[str, Any],
                      b: Dict[str, Any]) -> Dict[str, Any]:
    """Diff two :func:`summarize` dicts (B relative to A).

    The sections an A/B experiment actually argues over: per-phase wall
    clock (medians), comm bytes per round + cumulative totals, and the
    progress section's rounds-to-target / final metric — each as
    ``{"a": ..., "b": ..., "delta": b - a}`` (``delta`` None when either
    side is missing).  Config keys whose values differ are listed so a
    report never silently compares apples to oranges.
    """
    cfg_a, cfg_b = a["run_config"], b["run_config"]
    config_diff = {
        k: {"a": cfg_a.get(k), "b": cfg_b.get(k)}
        for k in sorted(set(cfg_a) | set(cfg_b))
        if cfg_a.get(k) != cfg_b.get(k)
    }
    pa, pb = a["rounds"]["phase_wall"], b["rounds"]["phase_wall"]
    phases = {}
    for name in sorted(set(pa) | set(pb)):
        ma = pa.get(name, {}).get("median_s")
        mb = pb.get(name, {}).get("median_s")
        phases[name] = {"a": ma, "b": mb, "delta": _delta(ma, mb)}
    comm = {}
    for key in ("bytes_down_per_round", "bytes_up_per_round",
                "cum_total"):
        va, vb = a["comm"].get(key), b["comm"].get(key)
        comm[key] = {"a": va, "b": vb, "delta": _delta(va, vb)}
    prog_a, prog_b = a["progress"], b["progress"]
    progress = {
        "metric": prog_a["metric"],
        "rounds_to_target": {
            "a": prog_a["rounds_to_target"],
            "b": prog_b["rounds_to_target"],
            "delta": _delta(prog_a["rounds_to_target"],
                            prog_b["rounds_to_target"]),
        },
        "final": {"a": prog_a["final"], "b": prog_b["final"],
                  "delta": _delta(prog_a["final"], prog_b["final"])},
    }
    return {
        "config_diff": config_diff,
        "rounds": {"a": a["rounds"]["n_rounds"],
                   "b": b["rounds"]["n_rounds"]},
        "phases": phases,
        "comm": comm,
        "progress": progress,
    }


def _fmt_pair(row: Dict[str, Any], fmt) -> str:
    d = row["delta"]
    sign = "" if d is None or d < 0 else "+"
    return (f"A={fmt(row['a'])}  B={fmt(row['b'])}  "
            f"delta={'-' if d is None else sign + fmt(d)}")


def render_compare(cmp: Dict[str, Any]) -> str:
    """Format a :func:`compare_summaries` dict as the printed diff."""
    lines: List[str] = []
    add = lines.append
    add("== telemetry run comparison (B - A) ==")
    add(f"rounds: A={cmp['rounds']['a']}  B={cmp['rounds']['b']}")
    if cmp["config_diff"]:
        add("")
        add("-- config differences --")
        for k, row in cmp["config_diff"].items():
            add(f"  {k}: A={row['a']}  B={row['b']}")
    if cmp["phases"]:
        add("")
        add("-- phase wall clock (median) --")
        for name, row in cmp["phases"].items():
            add(f"  {name}: " + _fmt_pair(row, _fmt_s))
    add("")
    add("-- comm --")
    for key, row in cmp["comm"].items():
        add(f"  {key}: " + _fmt_pair(row, _fmt_bytes))
    p = cmp["progress"]
    add("")
    add(f"-- progress ({p['metric']}) --")
    rt = p["rounds_to_target"]
    if rt["a"] is not None or rt["b"] is not None:
        add("  rounds_to_target: "
            + _fmt_pair(rt, lambda v: "-" if v is None else f"{v:g}"))
    add("  final: "
        + _fmt_pair(p["final"], lambda v: "-" if v is None else f"{v:.4f}"))
    return "\n".join(lines)


def compare_paths(path_a: str, path_b: str,
                  target: Optional[float] = None,
                  target_metric: str = "loss_complex") -> str:
    """Read two JSONL run logs and return the rendered A/B diff."""
    sa = summarize(read_jsonl(path_a), target=target,
                   target_metric=target_metric)
    sb = summarize(read_jsonl(path_b), target=target,
                   target_metric=target_metric)
    return render_compare(compare_summaries(sa, sb))


def main(argv=None) -> int:
    """``python -m repro_torch.obs.report run.jsonl [--target T]
    [--metric M]`` or ``--compare A B``: the flags of
    ``tools/obs_report.py``."""
    ap = argparse.ArgumentParser(
        description="Render (or diff) telemetry JSONL run logs")
    ap.add_argument("jsonl", nargs="?", default=None,
                    help="run log written by --telemetry-out")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"), default=None,
                    help="diff two run logs instead (B relative to A)")
    ap.add_argument("--target", type=float, default=None,
                    help="rounds-to-target threshold on --metric")
    ap.add_argument("--metric", default="loss_complex",
                    help="eval metric for --target (default: loss_complex)")
    args = ap.parse_args(argv)
    if args.compare is not None:
        if args.jsonl is not None:
            ap.error("pass either a single run log or --compare A B, "
                     "not both")
        print(compare_paths(args.compare[0], args.compare[1],
                            target=args.target, target_metric=args.metric))
        return 0
    if args.jsonl is None:
        ap.error("a run log is required (or --compare A B)")
    print(report_path(args.jsonl, target=args.target,
                      target_metric=args.metric))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
