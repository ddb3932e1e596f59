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
  aggregates, profile).

Every path-based writer gzips when the destination ends in ``.gz``. The
documents carry the JAX package's keys; the remote and fleet blocks of the
JAX documents come with client/server mode and the fleet, which the port
does not have.
"""

from __future__ import annotations

import json
import os

from trivy_tpu_torch.obs import TraceContext
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
    """Flatten a context into trace-event dicts (spans sorted by start)."""
    events: list[dict] = [{
        "name": "process_name",
        "ph": "M",
        "pid": 1,
        "tid": 0,
        "args": {"name": f"trivy-tpu {ctx.name} [{ctx.trace_id}]"},
    }]
    # one track per (stage, thread): a stage whose spans run concurrently
    # in N threads (the confirm pool) gets N tracks ("stage", "stage #2",
    # ...) instead of one track of overlapping slices
    tids: dict[tuple[str, int], int] = {}
    per_stage_threads: dict[str, int] = {}

    def tid_for(name: str, thread: int) -> int:
        t = tids.get((name, thread))
        if t is None:
            t = tids[(name, thread)] = len(tids) + 1
            n = per_stage_threads[name] = per_stage_threads.get(name, 0) + 1
            events.append({
                "name": "thread_name",
                "ph": "M",
                "pid": 1,
                "tid": t,
                "args": {"name": name if n == 1 else f"{name} #{n}"},
            })
        return t

    def emit_counters(series: dict) -> None:
        """Perfetto counter tracks: one track per series, its points on the
        span clock."""
        for name, doc in sorted(series.items()):
            for t, v in doc.get("points", ()):
                events.append({
                    "name": name,
                    "cat": "telemetry",
                    "ph": "C",
                    "pid": 1,
                    "tid": 0,
                    "ts": max(0.0, round(t * 1e6, 3)),
                    "args": {"value": v},
                })

    with ctx._lock:
        spans = list(ctx.events)
        ts = ctx.timeseries
    for sp in sorted(spans, key=lambda s: s.start):
        args = {"trace_id": ctx.trace_id, "span_id": sp.span_id}
        if sp.parent_id is not None:
            args["parent_span_id"] = sp.parent_id
        events.append({
            "name": sp.name,
            "cat": sp.name.split(".", 1)[0],
            "ph": "X",
            "pid": 1,
            "tid": tid_for(sp.name, sp.thread),
            # clamp: add()-style backdated spans can start a hair before
            # the context's own creation
            "ts": max(0.0, round((sp.start - ctx.created) * 1e6, 3)),
            "dur": round(sp.duration * 1e6, 3),
            "args": args,
        })
    if ts is not None:
        emit_counters(ts.to_doc())
    # device-lane counter tracks: cumulative compiles and HBM-resident bytes
    dev_series = _recorder.counter_series(ctx)
    if dev_series:
        emit_counters(dev_series)
    return events


def write_chrome_trace(ctx: TraceContext, dest) -> None:
    """Write Perfetto-loadable trace-event JSON to a path or file object
    (gzipped when the path ends in .gz)."""
    doc = {
        "traceEvents": chrome_trace_events(ctx),
        "displayTimeUnit": "ms",
        "otherData": {
            "trace_id": ctx.trace_id,
            "name": ctx.name,
            "dropped_events": ctx.dropped_events,
        },
    }
    _dump(doc, dest)


def metrics_dict(ctx: TraceContext) -> dict:
    """Aggregate metrics as one JSON-serializable dict."""
    with ctx._lock:
        counters = dict(sorted(ctx.counters.items()))
        samples = {k: (v[0], v[1], v[2]) for k, v in sorted(ctx.samples.items())}
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
    """Every sampled series' points, the per-series summary and the final
    progress snapshot: what ``--timeseries-out`` writes."""
    with ctx._lock:
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
    return doc


def write_timeseries_json(ctx: TraceContext, dest) -> None:
    _dump(timeseries_dict(ctx), dest, indent=2)
