"""Trace, metrics, profile and time-series file export (the port of
``trivy_tpu/obs/export.py``).

- :func:`write_chrome_trace` (``--trace-out``): Chrome trace-event JSON, the
  format Perfetto and ``chrome://tracing`` load: one ``X`` complete event
  per span, one named track per stage and thread (the feeder, the device
  worker, each confirm-pool thread), and Perfetto counter tracks
  (``"ph": "C"``) for the sampler's series and the flight recorder's
  compile and HBM ledgers.
- :func:`write_metrics_json` (``--metrics-out``): per-stage histograms,
  counters, sample stats, the stall verdict, the per-rule/per-bucket
  profile, the progress and time-series summaries, the wire accounting and
  the ``device`` block.
- :func:`write_profile_json` (``--profile-out``): the cost profile with the
  stall verdict and the stage totals it must agree with.
- :func:`write_timeseries_json` (``--timeseries-out``): every sampled
  series' points.
- :func:`context_doc`: a context's serialized form (bounded events,
  aggregates, profile), which a scan server returns in its response.

A client-mode scan's documents carry the server's half too: its spans as a
second process of the Chrome trace, under the client's trace id, and a
``remote`` block in the metrics and time-series documents. Every
path-based writer gzips when the destination ends in ``.gz``. The
documents carry the JAX package's keys. A fleet scan's profile carries its
``fleet`` block (per-shard rows and the efficiency verdict); with the
fleet telemetry plane on, the metrics document's ``fleet`` block holds each
replica's headroom and series summary, the time-series document's the full
points, and the Chrome trace one process per replica with its series as
counter tracks.
"""

from __future__ import annotations

import json
import os

from trivy_tpu_torch.obs import TraceContext, wire_span_stats
from trivy_tpu_torch.obs import recorder as _recorder
from trivy_tpu_torch.obs import stall as _stall

# bounds of a context's serialized form: events beyond the cap drop from
# its timeline (aggregates and the profile never drop), and per-stage
# reservoirs are cut to a uniform stride
WIRE_MAX_EVENTS = 4096
WIRE_RESERVOIR = 256


def _dump(doc: dict, dest, indent: int | None = None) -> None:
    """Write JSON to a file object or path; paths ending in .gz gzip."""
    if hasattr(dest, "write"):
        json.dump(doc, dest, indent=indent)
        return
    if str(dest).endswith(".gz"):
        import gzip

        with gzip.open(dest, "wt") as f:
            json.dump(doc, f, indent=indent)
    else:
        with open(dest, "w") as f:
            json.dump(doc, f, indent=indent)


def _wire_values(values: list[float]) -> list[float]:
    """Bound a stage's duration reservoir by a uniform strided pick (a
    prefix would bias percentiles toward the scan's warm-up)."""
    n = len(values)
    if n <= WIRE_RESERVOIR:
        return values
    step = n / WIRE_RESERVOIR
    return [values[int(i * step)] for i in range(WIRE_RESERVOIR)]


def context_doc(ctx: TraceContext, max_events: int = WIRE_MAX_EVENTS) -> dict:
    """Serialize a context: bounded raw events (starts rebased to the
    context's creation, alignable through ``created_wall``), exact
    per-stage aggregates with a bounded reservoir, counters, samples and
    the scan profile."""
    with ctx._lock:
        events = [
            {
                "name": sp.name,
                "span_id": sp.span_id,
                "parent_id": sp.parent_id,
                "start": round(sp.start - ctx.created, 6),
                "duration": round(sp.duration, 6),
                "thread": sp.thread,
            }
            for sp in ctx.events[:max_events]
        ]
        dropped = ctx.dropped_events + max(0, len(ctx.events) - max_events)
        spans = {
            name: {
                "count": a.count,
                "total": round(a.total, 6),
                "max": round(a.vmax, 6),
                "threads": len(a.threads),
                "values": [round(v, 6) for v in _wire_values(a.values)],
            }
            for name, a in ctx.durations.items()
            if a.count
        }
        counters = dict(ctx.counters)
        samples = {k: [v[0], v[1], v[2]] for k, v in ctx.samples.items()}
        prof = ctx._profile
        prog = ctx._progress
        ts = ctx.timeseries
    doc = {
        "trace_id": ctx.trace_id,
        "name": ctx.name,
        "pid": os.getpid(),
        "created_wall": ctx.created_wall,
        "root_parent_id": ctx.parent_span_id,
        "events": events,
        "spans": spans,
        "counters": counters,
        "samples": samples,
        "dropped_events": dropped,
    }
    if prof is not None:
        doc["profile"] = prof.to_dict()
    if prog is not None:
        doc["progress"] = prog.snapshot()
    if ts is not None:
        doc["timeseries"] = ts.to_doc()
    tuning = ctx.tuning_doc()
    if tuning is not None:
        doc["tuning"] = tuning
    if ctx.wire is not None:
        doc["wire"] = ctx.wire
    return doc


def chrome_trace_events(ctx: TraceContext) -> list[dict]:
    """Flatten a context, and every remote context joined into it, into
    trace-event dicts: the local spans as process 1, each joined server's
    as process 2, 3, ..., aligned on the wall clock."""
    events: list[dict] = [{
        "name": "process_name",
        "ph": "M",
        "pid": 1,
        "tid": 0,
        "args": {"name": f"trivy-tpu {ctx.name} [{ctx.trace_id}]"},
    }]
    # one track per (process, stage, thread): a stage whose spans run
    # concurrently in N threads (the confirm pool) gets N tracks ("stage",
    # "stage #2", ...) instead of one track of overlapping slices; tids are
    # unique across processes
    tids: dict[tuple[int, str, int], int] = {}
    per_stage_threads: dict[tuple[int, str], int] = {}

    def tid_for(pid: int, name: str, thread: int) -> int:
        t = tids.get((pid, name, thread))
        if t is None:
            t = tids[(pid, name, thread)] = len(tids) + 1
            n = per_stage_threads[(pid, name)] = per_stage_threads.get((pid, name), 0) + 1
            events.append({
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": t,
                "args": {"name": name if n == 1 else f"{name} #{n}"},
            })
        return t

    def emit(pid: int, trace_id: str, name: str, thread: int, span_id, parent_id,
             ts_us: float, dur_s: float) -> None:
        args = {"trace_id": trace_id, "span_id": span_id}
        if parent_id is not None:
            args["parent_span_id"] = parent_id
        events.append({
            "name": name,
            "cat": name.split(".", 1)[0],
            "ph": "X",
            "pid": pid,
            "tid": tid_for(pid, name, thread),
            # clamp: add()-style backdated spans can start a hair before
            # the context's own creation
            "ts": max(0.0, round(ts_us, 3)),
            "dur": round(dur_s * 1e6, 3),
            "args": args,
        })

    def emit_counters(pid: int, series: dict, base_us: float = 0.0) -> None:
        """Perfetto counter tracks: one track per series, its points on the
        span clock."""
        for name, doc in sorted(series.items()):
            for t, v in doc.get("points", ()):
                events.append({
                    "name": name,
                    "cat": "telemetry",
                    "ph": "C",
                    "pid": pid,
                    "tid": 0,
                    "ts": max(0.0, round(base_us + t * 1e6, 3)),
                    "args": {"value": v},
                })

    def emit_tuning(pid: int, tuning: dict, base_us: float = 0.0) -> None:
        """The online controller's decisions as process-scoped instant
        events, each with the knob delta and the gauges that fired it, on
        the timeline of the knobs' counter tracks."""
        ctl = tuning.get("controller") or {}
        for d in ctl.get("decision_log", ()):
            events.append({
                "name": f"tuning:{d.get('rule', '?')}",
                "cat": "tuning",
                "ph": "i",
                "s": "p",
                "pid": pid,
                "tid": 0,
                "ts": max(0.0, round(base_us + d.get("t", 0.0) * 1e6, 3)),
                "args": {"knob": d.get("knob"), "from": d.get("from"), "to": d.get("to"),
                         "gauges": d.get("gauges", {})},
            })

    with ctx._lock:
        spans = list(ctx.events)
        remote_docs = list(ctx.remote)
        ts = ctx.timeseries
    for sp in sorted(spans, key=lambda s: s.start):
        emit(1, ctx.trace_id, sp.name, sp.thread, sp.span_id, sp.parent_id,
             (sp.start - ctx.created) * 1e6, sp.duration)
    if ts is not None:
        emit_counters(1, ts.to_doc())
    # device-lane counter tracks: cumulative compiles and HBM-resident bytes
    dev_series = _recorder.counter_series(ctx)
    if dev_series:
        emit_counters(1, dev_series)
    tuning = ctx.tuning_doc()
    if tuning is not None:
        emit_tuning(1, tuning)
    for i, doc in enumerate(remote_docs):
        pid = 2 + i
        events.append({
            "name": "process_name",
            "ph": "M",
            "pid": pid,
            "tid": 0,
            "args": {"name": f"trivy-tpu {doc.get('name', 'remote')} "
                             f"[{doc.get('trace_id', '')}] (remote)"},
        })
        # perf_counter clocks do not compare across processes: the remote
        # timeline is aligned by the wall-clock gap between the creations
        base_us = (doc.get("created_wall", ctx.created_wall) - ctx.created_wall) * 1e6
        remote_spans = sorted(doc.get("events", []), key=lambda s: s["start"])
        if remote_spans:
            # a server clock running behind would push the track negative:
            # shift the whole track, so the relative timing survives
            first_us = base_us + remote_spans[0]["start"] * 1e6
            if first_us < 0:
                base_us -= first_us
        for sp in remote_spans:
            emit(pid, doc.get("trace_id", ""), sp["name"], sp.get("thread", 0),
                 sp.get("span_id"), sp.get("parent_id"), base_us + sp["start"] * 1e6,
                 sp.get("duration", 0.0))
        if doc.get("timeseries"):
            emit_counters(pid, doc["timeseries"], base_us)
        if doc.get("tuning"):
            emit_tuning(pid, doc["tuning"], base_us)
    fleet = ctx.fleet
    if fleet:
        # the fleet's replicas join the one timeline as processes of their
        # own, after the remote shard traces' pids: the poller's series
        # (scraped on the coordinator's clock, so no shift) as counter tracks
        for i, (host, rep) in enumerate(sorted((fleet.get("replicas") or {}).items())):
            pid = 2 + len(remote_docs) + i
            events.append({
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "args": {"name": f"trivy-tpu fleet replica {host}"},
            })
            if rep.get("series"):
                emit_counters(pid, rep["series"])
    return events


def write_chrome_trace(ctx: TraceContext, dest) -> None:
    """Write Perfetto-loadable trace-event JSON to a path or file object
    (gzipped when the path ends in .gz)."""
    with ctx._lock:
        remote_dropped = sum(d.get("dropped_events", 0) for d in ctx.remote)
    doc = {
        "traceEvents": chrome_trace_events(ctx),
        "displayTimeUnit": "ms",
        "otherData": {
            "trace_id": ctx.trace_id,
            "name": ctx.name,
            "dropped_events": ctx.dropped_events + remote_dropped,
        },
    }
    _dump(doc, dest)


def metrics_dict(ctx: TraceContext) -> dict:
    """Aggregate metrics as one JSON-serializable dict."""
    with ctx._lock:
        counters = dict(sorted(ctx.counters.items()))
        samples = {k: (v[0], v[1], v[2]) for k, v in sorted(ctx.samples.items())}
        remote_docs = list(ctx.remote)
    doc = {
        "trace_id": ctx.trace_id,
        "name": ctx.name,
        "spans": {
            name: {k: round(v, 6) for k, v in s.items()}
            for name, s in ctx.stage_stats().items()
        },
        "counters": counters,
        "samples": {
            name: {"count": count, "mean": round(total / max(1, count), 3), "max": vmax}
            for name, (count, total, vmax) in samples.items()
            if count
        },
        "stall": _stall.attribution(ctx),
        "profile": ctx.profile_doc(),
        "dropped_events": ctx.dropped_events,
    }
    if ctx.timeseries is not None:
        # per-series count/mean/max/p50/p95; the points ride --timeseries-out
        doc["timeseries"] = ctx.timeseries.summary()
    if ctx._progress is not None:
        doc["progress"] = ctx._progress.snapshot()
    tuning = ctx.tuning_doc()
    if tuning is not None:
        doc["tuning"] = tuning
    if ctx.wire is not None:
        # compressed-feed wire accounting, present only when the codec ran
        doc["wire"] = ctx.wire
    dev = _recorder.device_doc()
    if dev is not None:
        # kernel loads and HBM residency, present once the ledgers hold any
        doc["device"] = dev
    if ctx.fleet:
        # the fleet telemetry plane: each replica's headroom and health
        # summary (the series' points ride --timeseries-out)
        doc["fleet"] = {
            "interval_s": ctx.fleet.get("interval_s"),
            "replicas": {host: {k: v for k, v in rep.items() if k != "series"}
                         for host, rep in (ctx.fleet.get("replicas") or {}).items()},
        }
    if remote_docs:
        # each joined server's stage histograms and counters
        doc["remote"] = [
            {
                "trace_id": d.get("trace_id"),
                "name": d.get("name"),
                "spans": {
                    name: {k: round(v, 6) if isinstance(v, float) else v
                           for k, v in wire_span_stats(s).items()}
                    for name, s in sorted((d.get("spans") or {}).items())
                },
                "counters": dict(sorted((d.get("counters") or {}).items())),
            }
            for d in remote_docs
        ]
    return doc


def write_metrics_json(ctx: TraceContext, dest) -> None:
    _dump(metrics_dict(ctx), dest, indent=2)


def profile_dict(ctx: TraceContext) -> dict:
    """The cost-attribution view: the profile, the stall verdict it refines
    and the stage totals (ms) the per-rule times must agree with."""
    return {
        "trace_id": ctx.trace_id,
        "name": ctx.name,
        "profile": ctx.profile_doc(),
        "stall": _stall.attribution(ctx),
        "stage_total_ms": {
            name: round(s["total"] * 1e3, 3) for name, s in ctx.stage_stats().items()
        },
    }


def write_profile_json(ctx: TraceContext, dest) -> None:
    _dump(profile_dict(ctx), dest, indent=2)


def timeseries_dict(ctx: TraceContext) -> dict:
    """Every sampled series' points (a joined server's under ``remote``),
    the per-series summary and the final progress snapshot: what
    ``--timeseries-out`` writes."""
    with ctx._lock:
        remote_docs = list(ctx.remote)
        ts = ctx.timeseries
        prog = ctx._progress
    doc = {
        "trace_id": ctx.trace_id,
        "name": ctx.name,
        "series": ts.to_doc(max_points=ts._capacity) if ts is not None else {},
        "summary": ts.summary() if ts is not None else {},
    }
    if prog is not None:
        doc["progress"] = prog.snapshot()
    tuning = ctx.tuning_doc()
    if tuning is not None:
        doc["tuning"] = tuning
    remote = [
        {
            "trace_id": d.get("trace_id"),
            "name": d.get("name"),
            "series": d["timeseries"],
            **({"progress": d["progress"]} if d.get("progress") else {}),
        }
        for d in remote_docs
        if d.get("timeseries")
    ]
    if remote:
        doc["remote"] = remote
    if ctx.fleet:
        # the full-points twin of metrics_dict's fleet block
        doc["fleet"] = ctx.fleet
    return doc


def write_timeseries_json(ctx: TraceContext, dest) -> None:
    _dump(timeseries_dict(ctx), dest, indent=2)
