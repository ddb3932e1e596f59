"""Observability of a scan: per-scan trace contexts, span histograms, the
stall verdict, and the trace, metrics, profile and time-series exports (the
port of ``trivy_tpu/obs/__init__.py``).

- **Span trees** (:class:`TraceContext`): every span carries a trace id,
  span id and parent span id. Contexts are carried in a contextvar: each
  command of ``cli.py`` enters a fresh one, so back-to-back scans in one
  process record into disjoint tables. Worker threads (the secret
  scanner's feeder, device worker and confirm pool, the sampler) re-enter
  their scan's context with :func:`activate`.
- **Stage tracks**: spans export as Chrome trace-event JSON
  (:mod:`trivy_tpu_torch.obs.export`, loadable in Perfetto) with one track
  per stage and thread, and aggregate to p50/p95/max histograms plus a
  per-pipeline stall verdict (:mod:`trivy_tpu_torch.obs.stall`).

Span and counter names are the JAX package's (``secret.device_wait``,
``license.dispatch``, ``cve.join``, ...), so the two packages' exports of
one scan compare name for name. A CUDA launch returns at once, so a span
around a launch times its enqueue; the card's time lands in the span that
first blocks on a result (``secret.prefilter``, ``secret.device_wait``,
``license.device_wait``, ``cve.dispatch``), as a wait on
``block_until_ready`` does in the JAX package.

Disabled contexts cost one attribute check per span site.

- **Cross-process join**: a client sends :func:`traceparent` with each
  request; a server enters ``scan_context(trace_id=, parent_span_id=)``
  from :func:`parse_traceparent`, so its root spans parent under the
  client's ``rpc.scan`` span, and returns its context's document
  (``export.context_doc``), which the client folds in with
  :meth:`TraceContext.ingest_remote`: one export then carries both sides
  of the wire, the server's pipelines under a ``server:`` prefix.
"""

from __future__ import annotations

import contextvars
import itertools
import os
import random
import sys
import threading
import time
from contextlib import contextmanager

__all__ = [
    "Span",
    "TraceContext",
    "activate",
    "count",
    "current",
    "degrade_or_raise",
    "heartbeat",
    "note_scan_degraded",
    "parse_traceparent",
    "percentile",
    "sample",
    "scan_context",
    "span",
    "traceparent",
    "wire_span_stats",
]

# span ids are seeded with 40 random bits per process (the JAX package's
# scheme, which keeps ids of joined processes apart) and stay < 2**64
_span_ids = itertools.count((int.from_bytes(os.urandom(5), "big") << 24) + 1)

# raw span-event cap per context: aggregates never drop, but the event list
# behind the Chrome trace is bounded; exports report ``dropped_events``
MAX_EVENTS = 200_000

# the flight recorder's span hook (``obs/recorder.py`` installs it when it is
# imported): span boundaries above its latency floor become ring events
_flight_hook = None
# per-stage percentile reservoir: count/total/max stay exact, p50/p95 come
# from a uniform reservoir sample (Algorithm R)
RESERVOIR = 8192
# per-name cap on raw sample() observations; count/sum/max stay exact
MAX_SAMPLES = 8192


class _StageAgg:
    """Running per-stage duration aggregate: exact count/total/max, a
    bounded uniform reservoir for percentiles, and the recording threads
    (the stall verdict normalizes pooled stages by their count)."""

    __slots__ = ("count", "total", "vmax", "values", "threads")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.vmax = 0.0
        self.values: list[float] = []
        self.threads: set[int] = set()

    def add(self, dur: float, thread: int) -> None:
        self.count += 1
        self.total += dur
        if dur > self.vmax:
            self.vmax = dur
        if len(self.values) < RESERVOIR:
            self.values.append(dur)
        else:
            i = random.randrange(self.count)
            if i < RESERVOIR:
                self.values[i] = dur
        self.threads.add(thread)


class Span:
    """One finished (or in-flight) timed region."""

    __slots__ = ("name", "span_id", "parent_id", "start", "duration", "thread")

    def __init__(self, name, span_id, parent_id, start, duration, thread):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.start = start  # perf_counter at entry
        self.duration = duration  # seconds
        self.thread = thread  # recording thread ident


class _NullSpan:
    """Shared no-op context manager returned when tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()

class _SpanCM:
    __slots__ = ("ctx", "name", "sp")

    def __init__(self, ctx: "TraceContext", name: str):
        self.ctx = ctx
        self.name = name

    def __enter__(self) -> Span:
        ctx = self.ctx
        stack = ctx._stack()
        parent = stack[-1].span_id if stack else ctx.parent_span_id
        sp = Span(self.name, next(_span_ids), parent, time.perf_counter(), 0.0,
                  threading.get_ident())
        stack.append(sp)
        self.sp = sp
        return sp

    def __exit__(self, *exc) -> bool:
        sp = self.sp
        sp.duration = time.perf_counter() - sp.start
        stack = self.ctx._stack()
        if stack and stack[-1] is sp:
            stack.pop()
        self.ctx._record(sp)
        return False


class TraceContext:
    """Per-scan span table: raw events (bounded), per-name duration
    aggregates, integer counters and numeric samples, all thread-safe.

    Span parenting is tracked per recording thread: nested ``span()`` calls
    on one thread chain parent ids; spans of worker threads that entered
    via :func:`activate` parent to whatever is open on *their* stack. The
    JAX package's ``trace_id`` shape (32 hex digits) is kept.

    A server joining a client's trace passes the incoming ``trace_id`` and
    ``parent_span_id`` (the client's RPC span), so its root spans parent
    under the caller; the client folds the server's serialized context in
    with :meth:`ingest_remote`.
    """

    def __init__(self, name: str = "scan", enabled: bool = False,
                 trace_id: str | None = None, parent_span_id: int | None = None):
        self.name = name
        self.trace_id = trace_id or os.urandom(16).hex()
        self.parent_span_id = parent_span_id
        self.enabled = enabled
        self.created = time.perf_counter()
        self.created_wall = time.time()
        self._lock = threading.Lock()
        self.events: list[Span] = []
        self.dropped_events = 0
        self.durations: dict[str, _StageAgg] = {}
        self.counters: dict[str, int] = {}
        # name -> [count, sum, max, bounded raw values]
        self.samples: dict[str, list] = {}
        # scan-health events (skipped files): recorded even with tracing off
        self.health: dict[str, int] = {}
        # serialized remote context docs (export.context_doc) joined into
        # this trace: a server's half of a client-mode scan
        self.remote: list[dict] = []
        # per-rule / per-bucket cost profile, created lazily by profile()
        self._profile = None
        # the scan's bounded time series, set by an attached Sampler
        self.timeseries = None
        # the tuning surface (trivy_tpu_torch/tuning.py): the resolved knob
        # config as a dict (set by the command) and the online controller
        # (set by a scan run when it is on); tuning_doc() merges both
        self.tuning: dict | None = None
        self.tuning_controller = None
        # compressed-feed wire accounting of the scan, the sum of every
        # secret scan run's (merge_wire) when the codec is on; None on
        # uncompressed scans
        self.wire: dict | None = None
        # the fleet telemetry plane (trivy_tpu_torch/fleet/telemetry.py): the
        # per-replica health doc set at poller stop, and the coordinator's
        # heartbeat-status and --live-fragment callables; all None on scans
        # that are not fleet scans, so exports show no empty block
        self.fleet: dict | None = None
        self.fleet_status = None
        self.fleet_live = None
        # always-on scan progress, created lazily by progress()
        self._progress = None
        # telemetry probes: cheap callables returning {series: value},
        # polled only while a sampler thread is attached
        self._probes: list = []
        self._local = threading.local()

    # -- recording ----------------------------------------------------------

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, sp: Span) -> None:
        with self._lock:
            agg = self.durations.get(sp.name)
            if agg is None:
                agg = self.durations[sp.name] = _StageAgg()
            agg.add(sp.duration, sp.thread)
            if len(self.events) < MAX_EVENTS:
                self.events.append(sp)
            else:
                self.dropped_events += 1
        hook = _flight_hook
        if hook is not None:
            hook(self, sp)

    def span(self, name: str):
        """Context manager timing a block under ``name``; no-op when off."""
        if not self.enabled:
            return _NULL
        return _SpanCM(self, name)

    def add(self, name: str, seconds: float) -> None:
        """Record an externally-timed duration as a span ending now."""
        if not self.enabled:
            return
        self._record(Span(name, next(_span_ids), self.parent_span_id,
                          time.perf_counter() - seconds, seconds, threading.get_ident()))

    def current_span_id(self) -> int | None:
        """The innermost open span on the calling thread (the parent a
        remote callee links under), else this context's own parent."""
        stack = getattr(self._local, "stack", None)
        if stack:
            return stack[-1].span_id
        return self.parent_span_id

    def profile(self):
        """This scan's per-rule/per-bucket cost profile
        (:class:`trivy_tpu_torch.obs.profile.ScanProfile`), created lazily.
        Pipelines guard recording on ``self.enabled`` themselves."""
        from trivy_tpu_torch.obs.profile import ScanProfile

        with self._lock:
            if self._profile is None:
                self._profile = ScanProfile()
            return self._profile

    def progress(self):
        """This scan's :class:`trivy_tpu_torch.obs.timeseries.ScanProgress`,
        created lazily. Always on, like the health channel: a lock and
        integer adds per file."""
        from trivy_tpu_torch.obs.timeseries import ScanProgress

        with self._lock:
            if self._progress is None:
                self._progress = ScanProgress()
            return self._progress

    def progress_peek(self):
        """The progress tracker if a producer created one, else None."""
        return self._progress

    def add_probe(self, fn) -> None:
        """Register a telemetry probe: a cheap callable returning a
        ``{series_name: float}`` dict. Names ending ``_total`` are
        cumulative counters (the sampler derives rates). Only an attached
        sampler thread ever calls it. A probe already registered is not
        added twice."""
        with self._lock:
            if fn not in self._probes:
                self._probes.append(fn)

    def remove_probe(self, fn) -> None:
        with self._lock:
            if fn in self._probes:
                self._probes.remove(fn)

    def probe_values(self) -> dict[str, float]:
        """Snapshot of every registered probe, a series that several probes
        report summed (the secret runs of image layers scanned at once); a
        probe that raises (mid-teardown) is skipped."""
        with self._lock:
            probes = list(self._probes)
        out: dict[str, float] = {}
        for fn in probes:
            try:
                vals = fn()
            except Exception:
                continue
            for k, v in vals.items():
                out[k] = out.get(k, 0.0) + v
        return out

    def ingest_remote(self, doc: dict) -> None:
        """Join a remote scan's serialized context
        (:func:`trivy_tpu_torch.obs.export.context_doc`) into this trace: its
        tracks ride the same Chrome trace, its stage totals feed the stall
        verdict, and its profile merges into this scan's."""
        if not isinstance(doc, dict):
            return
        with self._lock:
            self.remote.append(doc)

    def remote_stage_totals(self) -> dict[str, tuple[float, int]]:
        """Stage totals of every joined remote context, each name prefixed
        ``server:`` so the stall verdict reports ``server:driver`` apart
        from the local pipelines."""
        with self._lock:
            docs = list(self.remote)
        out: dict[str, tuple[float, int]] = {}
        for doc in docs:
            for name, s in (doc.get("spans") or {}).items():
                key = f"server:{name}"
                total, threads = out.get(key, (0.0, 0))
                out[key] = (total + float(s.get("total", 0.0)),
                            max(threads, int(s.get("threads", 1))))
        return out

    def merge_wire(self, delta: dict[str, int]) -> None:
        """Add one secret scan run's wire byte and batch tallies to the
        scan's ``wire`` block and recompute its compression ratio: link
        bytes shipped per raw byte they stand for."""
        with self._lock:
            w = dict(self.wire or {})
            for k, n in delta.items():
                w[k] = w.get(k, 0) + n
            raw_equiv = w["bytes_raw_equiv"] + w["bytes_raw_fallback"]
            shipped = w["bytes_compressed"] + w["bytes_raw_fallback"]
            w.pop("compress", None)
            w.pop("compression_ratio", None)
            self.wire = {"compress": True,
                         "compression_ratio": shipped / raw_equiv if raw_equiv else 1.0, **w}

    def tuning_doc(self) -> dict | None:
        """The scan's tuning state for export: the resolved knob config
        (with each knob's provenance) and, when an online controller is
        attached, its decision log. None when neither exists (``sbom``,
        ``convert``), so no empty block is exported."""
        ctl = self.tuning_controller
        if self.tuning is None and ctl is None:
            return None
        doc = dict(self.tuning or {})
        if ctl is not None:
            try:
                doc["controller"] = ctl.doc()
            except Exception:  # a dying controller must not kill the export
                pass
        return doc

    def profile_doc(self) -> dict:
        """The scan's profile, with every joined remote profile merged in,
        as one dict (empty lists when nothing was profiled): what
        ``--profile-out`` writes and the report renders."""
        from trivy_tpu_torch.obs.profile import ScanProfile

        with self._lock:
            local = self._profile
            docs = list(self.remote)
        if not docs:
            return (local or ScanProfile()).to_dict()
        merged = ScanProfile()
        if local is not None:
            merged.merge_dict(local.to_dict())
        for doc in docs:
            if doc.get("profile"):
                merged.merge_dict(doc["profile"])
        return merged.to_dict()

    def count(self, name: str, n: int = 1) -> None:
        """Accumulate an integer counter (byte/item tallies)."""
        if not self.enabled:
            return
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def sample(self, name: str, value: float) -> None:
        """Record one observation of a fluctuating quantity (queue depth);
        count/sum/max stay exact, raw values are bounded."""
        if not self.enabled:
            return
        value = float(value)
        with self._lock:
            s = self.samples.get(name)
            if s is None:
                s = self.samples[name] = [0, 0.0, value, []]
            s[0] += 1
            s[1] += value
            if value > s[2]:
                s[2] = value
            if len(s[3]) < MAX_SAMPLES:
                s[3].append(value)

    def health_count(self, name: str, n: int = 1) -> None:
        """Accumulate a scan-health event (``walk.skipped``). Not gated on
        ``enabled``: a few events per scan."""
        with self._lock:
            self.health[name] = self.health.get(name, 0) + n

    def health_snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self.health)

    # -- aggregation --------------------------------------------------------

    def snapshot(self) -> dict[str, list[float]]:
        """Copy of the per-name duration reservoirs (a uniform sample past
        ``RESERVOIR`` spans per stage; :meth:`stage_totals` is exact)."""
        with self._lock:
            return {k: list(v.values) for k, v in self.durations.items()}

    def stage_totals(self) -> dict[str, tuple[float, int]]:
        """name -> (exact total seconds, distinct recording threads)."""
        with self._lock:
            return {k: (v.total, len(v.threads)) for k, v in self.durations.items() if v.count}

    def stage_stats(self) -> dict[str, dict[str, float]]:
        """name -> {count, total, mean, p50, p95, max} in seconds.
        count/total/mean/max are exact; p50/p95 come from the reservoir."""
        with self._lock:
            aggs = {k: (v.count, v.total, v.vmax, list(v.values))
                    for k, v in self.durations.items()}
        out = {}
        for name, (count, total, vmax, values) in sorted(aggs.items()):
            if not count:
                continue
            out[name] = {
                "count": count,
                "total": total,
                "mean": total / count,
                "p50": percentile(values, 50),
                "p95": percentile(values, 95),
                "max": vmax,
            }
        return out

    # -- reporting ----------------------------------------------------------

    def report(self, out=None) -> None:
        """Aggregate span table (count / total / mean / p50 / p95 / max),
        widest totals first, then counters and samples, the per-pipeline
        stall verdict and the hottest rules (the JAX package's layout)."""
        if not self.enabled:
            return
        out = out or sys.stderr
        stats = self.stage_stats()
        with self._lock:
            counters = sorted(self.counters.items())
            samples = {k: (v[0], v[1], v[2]) for k, v in sorted(self.samples.items())}
            remote_docs = list(self.remote)
        # a joined server's stages and counters render in the same table,
        # prefixed "server:"
        for doc in remote_docs:
            for name, s in sorted((doc.get("spans") or {}).items()):
                agg = wire_span_stats(s)
                if agg["count"]:
                    stats[f"server:{name}"] = agg
            for name, value in sorted((doc.get("counters") or {}).items()):
                counters.append((f"server:{name}", value))
        prof_doc = self.profile_doc()
        has_profile = bool(prof_doc.get("rules") or prof_doc.get("buckets")
                           or prof_doc.get("fleet"))
        if not stats and not counters and not samples and not has_profile:
            return
        rows = sorted(stats.items(), key=lambda kv: -kv[1]["total"])
        out.write("\n-- trace " + "-" * 71 + "\n")
        if rows:
            out.write(f"{'span':<34}{'count':>7}{'total':>10}{'mean':>9}"
                      f"{'p50':>9}{'p95':>9}{'max':>9}\n")
            for name, s in rows:
                out.write(f"{name:<34}{s['count']:>7}{s['total']:>9.3f}s"
                          f"{s['mean']:>8.4f}s{s['p50']:>8.4f}s"
                          f"{s['p95']:>8.4f}s{s['max']:>8.4f}s\n")
        if counters:
            out.write(f"{'counter':<55}{'value':>15}\n")
            for name, value in counters:
                out.write(f"{name:<55}{value:>15}\n")
        if samples:
            out.write(f"{'sample':<40}{'count':>8}{'mean':>10}{'max':>10}\n")
            for name, (count, total, vmax) in samples.items():
                out.write(f"{name:<40}{count:>8}{total / max(1, count):>10.1f}{vmax:>10.1f}\n")
        from trivy_tpu_torch.obs import profile as _profile
        from trivy_tpu_torch.obs import stall

        lines = stall.verdict_lines(self)
        if lines:
            out.write("-- stall attribution " + "-" * 59 + "\n")
            for line in lines:
                out.write(line + "\n")
        prof_lines = _profile.table_lines(prof_doc)
        if prof_lines:
            out.write(f"-- hottest rules (top {_profile.TOP_K} by confirm cost) "
                      + "-" * 33 + "\n")
            for line in prof_lines:
                out.write(line + "\n")
        fleet_lines = _profile.fleet_table_lines(prof_doc)
        if fleet_lines:
            # the fleet efficiency verdict: per-replica busy, idle, stalled
            # and dead buckets (sum 100%), the distributed stall verdict
            out.write("-- fleet efficiency " + "-" * 60 + "\n")
            for line in fleet_lines:
                out.write(line + "\n")
        if self.dropped_events:
            out.write(f"(note: {self.dropped_events} raw span events dropped past "
                      f"the {MAX_EVENTS}-event cap; aggregates above are complete)\n")
        out.write("-" * 80 + "\n")


def percentile(values: list[float], p: float) -> float:
    """Nearest-rank percentile over an unsorted list."""
    if not values:
        return 0.0
    s = sorted(values)
    idx = int(round((p / 100.0) * (len(s) - 1)))
    return s[max(0, min(idx, len(s) - 1))]


def wire_span_stats(s: dict) -> dict:
    """Aggregate one serialized stage entry (a ``context_doc`` ``spans``
    value) into count/total/mean/p50/p95/max."""
    count = int(s.get("count", 0))
    total = float(s.get("total", 0.0))
    values = list(s.get("values") or [])
    return {
        "count": count,
        "total": total,
        "mean": total / count if count else 0.0,
        "p50": percentile(values, 50),
        "p95": percentile(values, 95),
        "max": float(s.get("max", 0.0)),
    }


# -- module-level surface ---------------------------------------------------

# default context: library callers that never enter scan_context() use this
# one, which records nothing
_default_ctx = TraceContext(name="process")
_current: contextvars.ContextVar[TraceContext | None] = contextvars.ContextVar(
    "trivy_tpu_torch_obs_ctx", default=None)


def current() -> TraceContext:
    """The active trace context (contextvar, else the process default)."""
    return _current.get() or _default_ctx


@contextmanager
def scan_context(name: str = "scan", enabled: bool | None = None, trace_id: str | None = None,
                 parent_span_id: int | None = None):
    """Enter a fresh per-scan context. ``enabled=None`` inherits the process
    default's enabled bit (off). ``trace_id`` and ``parent_span_id`` join an
    existing distributed trace (a server taking a client's
    ``traceparent``) instead of minting one."""
    ctx = TraceContext(name=name, enabled=_default_ctx.enabled if enabled is None else enabled,
                       trace_id=trace_id, parent_span_id=parent_span_id)
    token = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)


@contextmanager
def activate(ctx: TraceContext):
    """Re-enter an existing context from a worker thread: contextvars do not
    follow a thread started outside the scan, so each worker loop wraps
    itself in ``activate(ctx)`` with the context its spawner captured."""
    token = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)


def span(name: str):
    return current().span(name)


def count(name: str, n: int = 1) -> None:
    current().count(name, n)


def sample(name: str, value: float) -> None:
    current().sample(name, value)


_HEX = set("0123456789abcdef")


def traceparent(span: Span | None = None) -> str:
    """W3C-style ``traceparent`` header of the active context:
    ``00-<32-hex trace id>-<16-hex parent span id>-01``. The parent is
    ``span``'s id when given, else the calling thread's innermost open span;
    an all-zero parent (tracing off) joins the trace id with no parent."""
    ctx = current()
    sid = span.span_id if span is not None else ctx.current_span_id()
    return f"00-{ctx.trace_id}-{(sid or 0):016x}-01"


def parse_traceparent(value: str | None) -> tuple[str, int | None] | None:
    """``(trace_id, parent_span_id)`` of a traceparent header, or None when
    it is absent or malformed. A zero parent id maps to None."""
    if not value:
        return None
    parts = value.strip().lower().split("-")
    if len(parts) != 4:
        return None
    _ver, tid, pid, _flags = parts
    if len(tid) != 32 or len(pid) != 16:
        return None
    if set(tid) - _HEX or set(pid) - _HEX:
        return None
    if tid == "0" * 32:
        return None
    return tid, (int(pid, 16) or None)


def note_scan_degraded() -> None:
    """Record one scan-degradation event everywhere it must surface: the
    always-on health channel (folded into the report's ``Degraded`` flag),
    the process-global ``trivy_tpu_scan_degraded_total`` counter, and a
    ``degrade`` event in the flight recorder's ring. Shared by every rung
    that degrades (the secret feed, the license classifier, the CVE join)
    so the surfaces cannot drift apart."""
    from trivy_tpu_torch.obs import metrics as obs_metrics
    from trivy_tpu_torch.obs import recorder as _recorder

    current().health_count("scan.degraded")
    obs_metrics.REGISTRY.counter(
        "trivy_tpu_scan_degraded_total",
        "Scans that completed on a degraded (host-fallback) path",
    ).inc()
    _recorder.record("degrade", "scan.degraded")


def degrade_or_raise(err: BaseException, *, device, host_fallback: bool, counter: str,
                     logger, message: str, first: bool = True, health: bool = True) -> None:
    """The last rung of every stage's ladder (the secret feed, the license
    classifier, the CVE join), in one place: return when the stage may
    finish ``err``'s work on its host oracle, else raise ``err``.

    Raised are a kernel fault (``ops._build.kernel_fault``: a kernel that
    cannot build, load or launch, or a CUDA error from the card), any error
    with ``host_fallback`` off, and any error on a ``cuda`` device, where
    finishing on the host would hide a kernel that does not work: there the
    scan fails, and the CLI still writes its bundle. On the CPU, where the
    stages run the kernels' plain versions, the degrade is counted as
    ``counter`` in the trace (and with ``health`` in the health channel,
    which ``--stats-out`` reads); when ``first``, ``message % err`` is
    logged as a warning on ``logger`` and the scan is marked degraded
    (:func:`note_scan_degraded`)."""
    from trivy_tpu_torch.ops._build import kernel_fault

    if kernel_fault(err) or not host_fallback or getattr(device, "type", device) == "cuda":
        raise err
    ctx = current()
    ctx.count(counter)
    if health:
        ctx.health_count(counter)
    if first:
        logger.warning(message, err)
        note_scan_degraded()


class heartbeat:
    """Progress logging for a long walk: while the block runs, log one line
    every ``interval`` seconds (elapsed time, the scan's progress %,
    instantaneous MB/s and ETA, the device fragment, and an optional
    ``progress()`` string), so a long scan tells itself apart from a hung
    one. The thread parks on an Event and exits when the block ends."""

    def __init__(self, logger, what: str, interval: float = 30.0, progress=None):
        self.logger = logger
        self.what = what
        self.interval = interval
        self.progress = progress
        self._stop = threading.Event()
        self._t0 = 0.0
        self._last_bytes: tuple[float, int] | None = None
        self._ctx: TraceContext | None = None

    def _telemetry(self) -> str:
        """Progress (bytes walked against scanned), MB/s since the previous
        beat and ETA as one fragment, or '' before any progress exists."""
        ctx = self._ctx
        prog = ctx.progress_peek() if ctx is not None else None
        if prog is None:
            return ""
        snap = prog.snapshot()
        now = time.perf_counter()
        mbs = snap["mbs"]
        if self._last_bytes is not None:
            t0, b0 = self._last_bytes
            if now > t0:
                mbs = (snap["bytes_scanned"] - b0) / (now - t0) / (1 << 20)
        self._last_bytes = (now, snap["bytes_scanned"])
        parts = [f"{snap['ratio'] * 100:.1f}%", f"{mbs:.1f} MB/s"]
        if snap.get("eta_s") is not None:
            parts.append(f"ETA {snap['eta_s']:.0f}s")
        # the knobs: live while a controller moves them, else as resolved,
        # so beats of two differently tuned scans compare
        knobs = None
        ctl = ctx.tuning_controller
        if ctl is not None:
            try:
                knobs = ctl.adapter.knobs()
            except Exception:
                knobs = None
        elif isinstance(ctx.tuning, dict):
            cfg = ctx.tuning.get("config") or {}
            if cfg.get("feed_streams") or cfg.get("inflight"):
                knobs = cfg
        if knobs:
            frag = f"knobs s{knobs.get('feed_streams', 0)}/i{knobs.get('inflight', 0)}"
            if knobs.get("arena_slabs"):
                frag += f"/a{knobs['arena_slabs']}"
            if ctl is not None:
                frag += f" ({len(ctl.decisions)} decisions)"
            parts.append(frag)
        # a fleet coordinator's fragment while it fans out: shards done and
        # replica health (from the poller, with the fleet's MB/s, or from its
        # breakers with the poller off)
        status = ctx.fleet_status
        if status is not None:
            try:
                st = status()
                frag = (f"fleet {st['shards_done']}/{st['shards_total']} shards, "
                        f"{st['healthy']}/{st['replicas']} healthy")
                if st.get("breaker_open"):
                    frag += f", {st['breaker_open']} open"
                if st.get("fleet_mbs") is not None:
                    frag += f", {st['fleet_mbs']:.1f} MB/s"
                parts.append(frag)
            except Exception:
                pass
        from trivy_tpu_torch.obs import recorder as _recorder

        frag = _recorder.heartbeat_fragment(self)
        if frag:
            parts.append(frag)
        return " [" + ", ".join(parts) + "]"

    def _loop(self) -> None:
        with activate(self._ctx or _default_ctx):
            while not self._stop.wait(self.interval):
                extra = ""
                try:
                    if self.progress is not None:
                        extra = f" ({self.progress()})"
                    extra = self._telemetry() + extra
                except Exception:
                    pass
                self.logger.info("%s in progress: %.0fs elapsed%s [trace %s]", self.what,
                                 time.perf_counter() - self._t0, extra,
                                 self._ctx.trace_id if self._ctx else "-")

    def __enter__(self) -> "heartbeat":
        self._t0 = time.perf_counter()
        self._ctx = current()
        threading.Thread(target=self._loop, daemon=True, name="heartbeat").start()
        return self

    def __exit__(self, *exc) -> bool:
        self._stop.set()
        return False
