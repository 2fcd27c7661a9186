"""Prometheus text-exposition rendering of the native metrics dump.

The port's own copy of ``horovod_tpu/utils/metrics.py``: the same text,
byte for byte, for the same dump (the native cores are one source), so a
dashboard built on the JAX package's families reads the port's unchanged.
Pure formatting, no scrape server: the caller decides how to expose the
text (write to a file a node_exporter textfile-collector picks up, or serve
it from an existing HTTP endpoint).  Naming scheme:

- counters ->  ``hvd_<name>_total{rank="R"}``  (a trailing ``_total`` in
  the native counter name is not doubled)
- gauges -> ``hvd_<name>{rank="R"}`` — bare name, no ``_total`` suffix
  (last-written values, e.g. ``hvd_elastic_generation``)
- histograms -> ``hvd_<name>_bucket{rank="R",le="<2^i>"}`` cumulative
  series per power-of-two microsecond bucket, a ``le="+Inf"`` overflow
  series, plus ``hvd_<name>_sum`` / ``hvd_<name>_count``
- per-tenant (process-set) QoS accounting -> the same two shapes with an
  extra ``psid="<process_set_id>"`` label:
  ``hvd_tenant_<responses|tensors|bytes>_total{rank="R",psid="P"}`` and
  ``hvd_tenant_negotiation_wait_us_*{rank="R",psid="P"}``
- fleet histograms (protocol v11, rank 0's dump only) -> the same
  histogram shape under a ``hvd_fleet_`` prefix — true cross-rank bucket
  merges, not rank 0's locals — plus
  ``hvd_fleet_tenant_negotiation_wait_us_*{psid="P"}`` per tenant
- ``hvd_goodput_ratio{rank="R"}`` — the useful-step wall fraction as a
  0..1 gauge, derived from the native ``goodput_ratio_ppm`` gauge

Every family is preceded by ``# HELP`` and ``# TYPE`` lines so the output
passes strict exposition validators (promtool check metrics).
"""

from __future__ import annotations

from typing import Dict, List, Set

# Curated help strings for the families dashboards reach for first; every
# other metric gets a generated fallback so no family ships HELP-less.
_HELP = {
    "hvd_negotiation_wait_us": (
        "Microseconds from tensor enqueue to negotiated response delivery"),
    "hvd_ring_hop_us": "Microseconds per data-plane ring hop",
    "hvd_step_time_us": "Wall microseconds per completed training step",
    "hvd_shm_fence_us": "Microseconds waiting on shared-memory plane fences",
    "hvd_elastic_generation": "Current elastic re-formation generation",
    "hvd_goodput_ratio_ppm": (
        "Useful-step wall fraction in parts per million "
        "(ring phase / all phases, fleet cumulative)"),
    "hvd_goodput_ratio": (
        "Useful-step wall fraction 0..1 (ring phase / all phases, "
        "fleet cumulative)"),
    "hvd_fleet_sketches_merged_total": (
        "Cumulative fleet-telemetry sketches merged by the coordinator"),
    "hvd_sentinel_anomalies_total": (
        "Cumulative anomalies flagged by the fleet telemetry sentinel"),
    "hvd_plane_demotions_total": (
        "Cumulative gspmd-plane demotions by reason "
        "(ops/gspmd_plane.py demotion contract)"),
    "hvd_plane_selected_total": (
        "Optimizers that resolved to the named gradient-exchange plane"),
    "hvd_gspmd_collectives_total": (
        "Compiler-inserted collectives inventoried across inspected "
        "gspmd-plane traces"),
    "hvd_gspmd_raw_bytes_total": (
        "Analytic payload bytes of compiler-inserted collectives "
        "(inspected gspmd-plane traces)"),
    "hvd_gspmd_wire_bytes_total": (
        "Analytic ring-model wire bytes of compiler-inserted collectives "
        "(inspected gspmd-plane traces)"),
    "hvd_gspmd_traces_total": (
        "gspmd-plane traces inspected by ops/hlo_inspect.py"),
}


def _help_line(metric: str) -> str:
    text = _HELP.get(metric)
    if text is None:
        # Generated fallback: the metric name reads as words once the
        # prefix/suffix conventions are stripped.
        base = metric[4:] if metric.startswith("hvd_") else metric
        text = "horovod_tpu metric " + base.replace("_", " ")
    return f"# HELP {metric} {text}"


def _meta(lines: List[str], seen: Set[str], metric: str, kind: str) -> None:
    """Emit the family's ``# HELP`` + ``# TYPE`` preamble exactly once —
    repeated metadata for one family (e.g. the per-tenant series) fails
    strict exposition validators."""
    if metric in seen:
        return
    seen.add(metric)
    lines.append(_help_line(metric))
    lines.append(f"# TYPE {metric} {kind}")


def _counter_name(name: str) -> str:
    base = name[:-6] if name.endswith("_total") else name
    return f"hvd_{base}_total"


def _escape_label(value) -> str:
    """Escape a label value per the Prometheus text exposition format.

    Backslash, double-quote, and newline are the three characters the
    format reserves inside a quoted label value.  Ranks and bucket bounds
    are numeric today, but psid comes from user-chosen process-set ids —
    a hostile or merely creative name must not break the whole scrape.
    """
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _render_histogram(lines: List[str], seen: Set[str], metric: str, h: Dict,
                      labels: str) -> None:
    """One native histogram in ``_bucket{le=...}``/``_sum``/``_count``
    form: cumulative counts per power-of-two microsecond bound, with the
    native overflow bucket as ``le="+Inf"``."""
    _meta(lines, seen, metric, "histogram")
    cum = 0
    buckets = h.get("buckets") or []
    for i, b in enumerate(buckets):
        cum += int(b)
        if i == len(buckets) - 1:
            le = "+Inf"  # native overflow bucket
        else:
            # bucket 0 is [0,1us); bucket i covers [2^(i-1), 2^i) us.
            le = str(1 << i)
        lines.append(f'{metric}_bucket{{{labels},le="{le}"}} {cum}')
    lines.append(f'{metric}_sum{{{labels}}} {int(h.get("sum_us", 0))}')
    lines.append(f'{metric}_count{{{labels}}} {int(h.get("count", 0))}')


def render_prometheus(dump: Dict) -> str:
    """Render a ``hvd.metrics()`` dict as Prometheus exposition text.

    The local ``counters`` / ``gauges`` / ``histograms`` / ``tenants``
    sections always render; rank 0's dump additionally renders the v11
    ``fleet`` section (true cross-rank histogram merges) under the
    ``hvd_fleet_`` prefix.  An empty or disabled dump renders "".
    """
    if not dump:
        return ""
    rank = _escape_label(dump.get("rank", 0))
    rank_label = f'rank="{rank}"'
    lines: List[str] = []
    seen: Set[str] = set()
    for name, value in sorted((dump.get("counters") or {}).items()):
        metric = _counter_name(name)
        _meta(lines, seen, metric, "counter")
        lines.append(f'{metric}{{{rank_label}}} {int(value)}')
    # gspmd-plane selection/demotion counters (Python-side, merged into
    # the dump by hvd.metrics()): demote_<reason> keys become the
    # labelled demotions family, plane names the selection family.
    for name, value in sorted((dump.get("plane_counters") or {}).items()):
        if name.startswith("demote_"):
            metric = "hvd_plane_demotions_total"
            label = f'reason="{_escape_label(name[len("demote_"):])}"'
        else:
            metric = "hvd_plane_selected_total"
            label = f'plane="{_escape_label(name)}"'
        _meta(lines, seen, metric, "counter")
        lines.append(f'{metric}{{{rank_label},{label}}} {int(value)}')
    gauges = dump.get("gauges") or {}
    for name, value in sorted(gauges.items()):
        # Gauges keep the bare name — no ``_total`` suffix (they are
        # last-written values, e.g. hvd_elastic_generation).
        metric = f"hvd_{name}"
        _meta(lines, seen, metric, "gauge")
        lines.append(f'{metric}{{{rank_label}}} {int(value)}')
    if "goodput_ratio_ppm" in gauges:
        # The derived 0..1 convenience gauge dashboards alert on; the raw
        # ppm gauge above stays for integer-only consumers.
        metric = "hvd_goodput_ratio"
        _meta(lines, seen, metric, "gauge")
        ratio = int(gauges["goodput_ratio_ppm"]) / 1e6
        lines.append(f'{metric}{{{rank_label}}} {ratio:.6f}')
    for name, h in sorted((dump.get("histograms") or {}).items()):
        _render_histogram(lines, seen, f"hvd_{name}", h, rank_label)
    for psid, t in sorted((dump.get("tenants") or {}).items()):
        labels = f'{rank_label},psid="{_escape_label(psid)}"'
        for field in ("responses", "tensors", "bytes"):
            metric = f"hvd_tenant_{field}_total"
            _meta(lines, seen, metric, "counter")
            lines.append(f'{metric}{{{labels}}} {int(t.get(field, 0))}')
        h = t.get("negotiation_wait_us") or {}
        if h.get("count"):
            _render_histogram(lines, seen, "hvd_tenant_negotiation_wait_us",
                              h, labels)
    fleet = dump.get("fleet") or {}
    for name in ("negotiation_wait_us", "ring_hop_us", "step_time_us",
                 "shm_fence_us"):
        h = fleet.get(name)
        if h:
            _render_histogram(lines, seen, f"hvd_fleet_{name}", h, rank_label)
    for psid, h in sorted((fleet.get("tenants") or {}).items()):
        if h.get("count"):
            labels = f'{rank_label},psid="{_escape_label(psid)}"'
            _render_histogram(lines, seen,
                              "hvd_fleet_tenant_negotiation_wait_us", h,
                              labels)
    return "\n".join(lines) + "\n" if lines else ""
