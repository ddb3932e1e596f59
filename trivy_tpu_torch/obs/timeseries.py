"""Live scan telemetry: a per-scan time-series sampler (the port of
``trivy_tpu/obs/timeseries.py``).

A background sampler thread per scan snapshots in-flight pipeline state on
a fixed interval (default 250 ms, ``--telemetry-interval``, 0 = off) into
bounded ring buffers. Producers register cheap probes on the scan's
:class:`~trivy_tpu_torch.obs.TraceContext`; the sampler merges them per
tick: the secret feed's arena occupancy, queue depths, files pending and
confirms in flight, its link-byte counter (``secret.link_mbs`` =
Δ``bytes_uploaded``/Δt) and the card's busy seconds
(``device.d0.busy_ratio``, from :class:`DeviceBusyTracker`), plus the
scan's progress (:class:`ScanProgress`: bytes and files walked against
scanned).

The series land in Perfetto counter tracks of ``--trace-out``, in
``--timeseries-out``, in the ``timeseries`` summary of ``--metrics-out``,
in process gauges of :data:`trivy_tpu_torch.obs.metrics.REGISTRY`, and in
the ``--live`` line.

Off costs nothing: no sampler thread starts unless an export or ``--live``
asks for one (``start_sampler`` returns None for interval 0), probes are
registered but never called, and :class:`ScanProgress` costs a lock and an
add per file.
"""

from __future__ import annotations

import os
import re
import threading
import time
from collections import deque

from trivy_tpu_torch import log
from trivy_tpu_torch.tuning import validate_interval

logger = log.logger("obs:timeseries")

# default sampling cadence; --telemetry-interval / TRIVY_TPU_TELEMETRY_INTERVAL
DEFAULT_INTERVAL = 0.25
# per-series point bound (about 17 minutes at the default cadence); older
# points drop, counted
RING_CAPACITY = 4096
# bounded per-series points of a serialized series (a uniform stride)
WIRE_POINTS = 512

# cumulative-counter series (names ending _total) derive a rate series per
# tick; these two get friendly names (link MB/s, busy seconds per second)
_LINK_COUNTER = "secret.bytes_uploaded_total"
_LINK_SERIES = "secret.link_mbs"
_BUSY_RE = re.compile(r"^device\.(d\w+)\.busy_seconds_total$")


def default_interval() -> float:
    """Sampler cadence from ``TRIVY_TPU_TELEMETRY_INTERVAL`` (seconds),
    else :data:`DEFAULT_INTERVAL`; 0 disables, a bad value raises."""
    raw = os.environ.get("TRIVY_TPU_TELEMETRY_INTERVAL", "")
    if raw:
        return validate_interval(raw, "TRIVY_TPU_TELEMETRY_INTERVAL")
    return DEFAULT_INTERVAL


class RingBuffer:
    """Bounded (t, value) series: append drops the oldest point past
    ``capacity`` and counts the drop."""

    __slots__ = ("points", "dropped", "capacity")

    def __init__(self, capacity: int = RING_CAPACITY):
        self.capacity = max(1, capacity)
        self.points: deque[tuple[float, float]] = deque(maxlen=self.capacity)
        self.dropped = 0

    def append(self, t: float, value: float) -> None:
        if len(self.points) == self.capacity:
            self.dropped += 1
        self.points.append((t, value))


class Timeseries:
    """Named, bounded time series of one scan (thread-safe). Timestamps are
    seconds since the owning context's creation, aligned with the spans of
    the Chrome-trace export."""

    def __init__(self, capacity: int = RING_CAPACITY):
        self._lock = threading.Lock()
        self._series: dict[str, RingBuffer] = {}
        self._capacity = capacity

    def record(self, name: str, t: float, value: float) -> None:
        with self._lock:
            rb = self._series.get(name)
            if rb is None:
                rb = self._series[name] = RingBuffer(self._capacity)
            rb.append(t, float(value))

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._series)

    def latest(self, name: str) -> float | None:
        with self._lock:
            rb = self._series.get(name)
            if rb is None or not rb.points:
                return None
            return rb.points[-1][1]

    def to_doc(self, max_points: int = WIRE_POINTS) -> dict:
        """``{name: {"points": [[t, v], ...], "dropped"}}`` with a uniform
        stride past ``max_points``."""
        with self._lock:
            items = [(name, list(rb.points), rb.dropped)
                     for name, rb in sorted(self._series.items())]
        out = {}
        for name, pts, dropped in items:
            n = len(pts)
            if n > max_points:
                step = n / max_points
                pts = [pts[int(i * step)] for i in range(max_points)]
                dropped += n - max_points
            out[name] = {"points": [[round(t, 4), round(v, 6)] for t, v in pts],
                         "dropped": dropped}
        return out

    def summary(self) -> dict:
        """Per-series {count, mean, max, p50, p95}."""
        from trivy_tpu_torch.obs import percentile

        out = {}
        with self._lock:
            items = [(n, [v for _, v in rb.points]) for n, rb in sorted(self._series.items())]
        for name, vals in items:
            if not vals:
                continue
            out[name] = {
                "count": len(vals),
                "mean": round(sum(vals) / len(vals), 6),
                "max": round(max(vals), 6),
                "p50": round(percentile(vals, 50), 6),
                "p95": round(percentile(vals, 95), 6),
            }
        return out


class ScanProgress:
    """Always-on progress counters of one scan: bytes and files *walked*
    (found by the walk) against *scanned* (processed by the analyzer loop).
    ``ratio`` never decreases and stays below 1 until :meth:`finish`."""

    def __init__(self):
        self._lock = threading.Lock()
        self.files_walked = 0
        self.bytes_walked = 0
        self.files_scanned = 0
        self.bytes_scanned = 0
        self.walk_complete = False
        self.done = False
        self.started = time.perf_counter()
        self._max_ratio = 0.0
        self.remote: dict | None = None  # the latest snapshot of a joined server scan

    def note_walked(self, nbytes: int, files: int = 1) -> None:
        with self._lock:
            self.files_walked += files
            self.bytes_walked += nbytes

    def note_scanned(self, nbytes: int, files: int = 1) -> None:
        with self._lock:
            self.files_scanned += files
            self.bytes_scanned += nbytes

    def finish_walk(self) -> None:
        with self._lock:
            self.walk_complete = True

    def finish(self) -> None:
        with self._lock:
            self.done = True

    def merge_remote(self, snapshot: dict) -> None:
        """The latest server-side progress of a joined remote scan (client
        mode), kept as it came, so ``--live`` shows both sides."""
        if isinstance(snapshot, dict):
            with self._lock:
                self.remote = snapshot

    def ratio(self) -> float:
        with self._lock:
            return self._ratio_locked()

    def _ratio_locked(self) -> float:
        if self.done:
            self._max_ratio = 1.0
            return 1.0
        if self.bytes_walked > 0:
            r = self.bytes_scanned / self.bytes_walked
        elif self.files_walked > 0:
            r = self.files_scanned / self.files_walked
        else:
            r = 0.0
        # never 1.0 before finish(): the walk may still grow the
        # denominator, and detection and the report come after the walk
        r = min(r, 0.999)
        if r > self._max_ratio:
            self._max_ratio = r
        return self._max_ratio

    def snapshot(self) -> dict:
        with self._lock:
            elapsed = time.perf_counter() - self.started
            ratio = self._ratio_locked()
            mbs = self.bytes_scanned / elapsed / (1 << 20) if elapsed > 0 else 0.0
            eta = None
            if (not self.done and self.walk_complete and self.bytes_scanned > 0
                    and self.bytes_walked > self.bytes_scanned):
                rate = self.bytes_scanned / elapsed
                if rate > 0:
                    eta = (self.bytes_walked - self.bytes_scanned) / rate
            doc = {
                "files_walked": self.files_walked,
                "bytes_walked": self.bytes_walked,
                "files_scanned": self.files_scanned,
                "bytes_scanned": self.bytes_scanned,
                "walk_complete": self.walk_complete,
                "done": self.done,
                "ratio": round(ratio, 6),
                "elapsed_s": round(elapsed, 3),
                "mbs": round(mbs, 3),
                "eta_s": round(eta, 1) if eta is not None else None,
            }
            if self.remote is not None:
                doc["remote"] = self.remote
            return doc


class DeviceBusyTracker:
    """Busy-interval accounting of ``n`` dispatch targets for live telemetry
    (the JAX package's ``parallel/mesh.py::DeviceBusyTracker``): one slot
    per round-robin device of a ``StagedDispatch``, one for the default and
    the mesh placements.

    A target is *busy* while at least one batch dispatched to it has not
    been fetched: :meth:`begin` at the copy, :meth:`end` after the fetch.
    Overlapping batches merge into one interval, so ``busy_seconds`` is the
    wall time with work in flight, the numerator of the sampler's busy
    ratio; :meth:`probe` emits ``device.d<i>.busy_seconds_total`` for each
    slot."""

    def __init__(self, n: int = 1, clock=time.monotonic):
        self.n = max(1, n)
        self.clock = clock
        self._lock = threading.Lock()
        self._inflight = [0] * self.n
        self._busy = [0.0] * self.n
        self._since = [0.0] * self.n

    def begin(self, i: int | None = None) -> None:
        i = (i or 0) % self.n
        with self._lock:
            if self._inflight[i] == 0:
                self._since[i] = self.clock()
            self._inflight[i] += 1

    def end(self, i: int | None = None) -> None:
        i = (i or 0) % self.n
        with self._lock:
            if self._inflight[i] <= 0:
                return  # unmatched end; never negative
            self._inflight[i] -= 1
            if self._inflight[i] == 0:
                self._busy[i] += self.clock() - self._since[i]

    def busy_seconds(self) -> list[float]:
        """Cumulative busy wall time per device, the open interval
        included (monotonic, so samplers can differentiate it)."""
        now = self.clock()
        with self._lock:
            return [b + (now - s if f > 0 else 0.0)
                    for b, s, f in zip(self._busy, self._since, self._inflight)]

    def probe(self) -> dict[str, float]:
        """Telemetry-probe fragment: ``device.dN.busy_seconds_total``."""
        return {f"device.d{i}.busy_seconds_total": s
                for i, s in enumerate(self.busy_seconds())}


def _registry():
    from trivy_tpu_torch.obs import metrics as obs_metrics

    return obs_metrics.REGISTRY


def _link_gauge():
    return _registry().gauge("trivy_tpu_link_mbs",
                             "Instantaneous host->device link bandwidth (MB/s)")


def _arena_gauge():
    return _registry().gauge("trivy_tpu_arena_free_slabs",
                             "Free slabs in the secret feed's chunk arena")


def _busy_gauge():
    return _registry().gauge("trivy_tpu_device_busy_ratio",
                             "Fraction of the last sampling interval the device had "
                             "work in flight", labelnames=("device",))


def _progress_gauge():
    return _registry().gauge("trivy_tpu_scan_progress_ratio",
                             "Live scan progress (bytes scanned / bytes walked)",
                             labelnames=("trace",))


def live_utilization() -> dict:
    """The process's utilization gauges for decision logic (the admission
    controller's shed rules): ``link_mbs``, ``busy_max`` (the highest busy
    ratio over the sampled devices), ``arena_free`` (free slabs of the
    latest sampled feed arena) and ``samplers`` (live samplers). A gauge
    with no live value reads None: no telemetry is not an idle card."""
    link = _link_gauge().collect()
    arena = _arena_gauge().collect()
    busy = _busy_gauge().collect()
    with _live_lock:
        samplers = _live_samplers
    return {
        "link_mbs": next(iter(link.values()), None),
        "arena_free": next(iter(arena.values()), None),
        "busy_max": max(busy.values()) if busy else None,
        "samplers": samplers,
    }


# live samplers in the process: the unlabeled gauges (link MB/s, arena free
# slabs) and the busy ratios hold the latest sampled value; when the last
# sampler stops they retire, so an idle process reads no stale value
_live_lock = threading.Lock()
_live_samplers = 0
_busy_devices: set[str] = set()


def _note_sampler_started() -> None:
    global _live_samplers
    with _live_lock:
        _live_samplers += 1


def _note_sampler_stopped() -> None:
    global _live_samplers
    with _live_lock:
        _live_samplers = max(0, _live_samplers - 1)
        if _live_samplers:
            return
        devices = sorted(_busy_devices)
        _busy_devices.clear()
    _link_gauge().remove()
    _arena_gauge().remove()
    busy = _busy_gauge()
    for d in devices:
        busy.remove(device=d)


class Sampler:
    """One scan's background sampler thread. It re-enters the scan's
    context, parks on an Event between ticks and exits on :meth:`stop`,
    which the command calls from a ``finally`` on every exit path; a final
    tick at stop records the end state."""

    def __init__(self, ctx, interval: float = DEFAULT_INTERVAL, clock=time.perf_counter):
        self.ctx = ctx
        self.interval = interval
        self.clock = clock
        self.ts = Timeseries()
        ctx.timeseries = self.ts
        self._stop = threading.Event()
        self._last: dict[str, tuple[float, float]] = {}
        self._progress_gauge_set = False
        self._counted_live = False
        self._thread: threading.Thread | None = None

    def sample_once(self) -> None:
        """One tick: merge every probe, record gauge series, derive rate
        series of cumulative ``*_total`` counters, fold in progress, and
        mirror the headline values to the process gauges."""
        now = self.clock()
        t = now - self.ctx.created
        vals = self.ctx.probe_values()
        for name, v in vals.items():
            self.ts.record(name, t, v)
            if not name.endswith("_total"):
                continue
            prev = self._last.get(name)
            self._last[name] = (now, v)
            if prev is None or now <= prev[0]:
                continue
            rate = max(0.0, (v - prev[1]) / (now - prev[0]))
            m = _BUSY_RE.match(name)
            if name == _LINK_COUNTER:
                mbs = rate / (1 << 20)
                self.ts.record(_LINK_SERIES, t, mbs)
                _link_gauge().set(round(mbs, 3))
            elif m:
                ratio = min(1.0, rate)
                self.ts.record(f"device.{m.group(1)}.busy_ratio", t, ratio)
                _busy_gauge().set(round(ratio, 4), device=m.group(1))
                with _live_lock:
                    _busy_devices.add(m.group(1))
            else:
                self.ts.record(name[: -len("_total")] + "_per_s", t, rate)
        if "secret.arena_free_slabs" in vals:
            _arena_gauge().set(vals["secret.arena_free_slabs"])
        prog = self.ctx.progress_peek()
        if prog is not None:
            snap = prog.snapshot()
            self.ts.record("progress.ratio", t, snap["ratio"])
            self.ts.record("progress.files_walked", t, snap["files_walked"])
            self.ts.record("progress.files_scanned", t, snap["files_scanned"])
            self.ts.record("progress.bytes_scanned_total", t, snap["bytes_scanned"])
            _progress_gauge().set(snap["ratio"], trace=self.ctx.trace_id)
            self._progress_gauge_set = True

    def start(self) -> "Sampler":
        # counted live before the baseline tick's gauge writes, so a
        # concurrently stopping last sampler cannot retire them
        _note_sampler_started()
        self._counted_live = True
        try:
            self.sample_once()
        except Exception as e:
            logger.debug("baseline telemetry tick failed: %s", e)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"telemetry-sampler-{self.ctx.trace_id[:8]}")
        self._thread.start()
        return self

    def _loop(self) -> None:
        from trivy_tpu_torch import obs

        with obs.activate(self.ctx):
            while not self._stop.wait(self.interval):
                try:
                    self.sample_once()
                except Exception as e:  # a dying probe must not stop the ticks
                    logger.debug("telemetry tick failed: %s", e)

    def stop(self, timeout: float = 5.0) -> None:
        """Stop the thread (idempotent), take a final sample and retire this
        scan's progress gauge (and the shared gauges after the last
        sampler)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
        try:
            self.sample_once()
        except Exception as e:
            logger.debug("final telemetry tick failed: %s", e)
        if self._progress_gauge_set:
            _progress_gauge().remove(trace=self.ctx.trace_id)
            self._progress_gauge_set = False
        if self._counted_live:
            self._counted_live = False
            _note_sampler_stopped()


def start_sampler(ctx, interval: float | None = None) -> Sampler | None:
    """A sampler for ``ctx`` unless telemetry is off: ``interval`` None
    reads the env knob, 0 starts nothing."""
    if interval is None:
        interval = default_interval()
    if interval <= 0:
        return None
    return Sampler(ctx, interval=interval).start()


class LiveProgress:
    """The ``--live`` line: one carriage-returned status line on stderr on a
    short cadence (progress %, MB/s, ETA, link MB/s, card busy %, arena
    occupancy, a fleet scan's replicas, compiles and HBM residency, and with
    ``--tune`` the controller's knobs and decision count), ended with a
    newline."""

    def __init__(self, ctx, stream=None, interval: float = 0.5):
        import sys

        self.ctx = ctx
        self.stream = stream or sys.stderr
        self.interval = interval
        self._stop = threading.Event()
        self._wrote = False
        self._thread: threading.Thread | None = None

    def line(self) -> str:
        prog = self.ctx.progress_peek()
        snap = prog.snapshot() if prog is not None else {}
        parts = []
        if snap:
            parts.append(f"{snap['ratio'] * 100:5.1f}%")
            parts.append(f"{snap['mbs']:.1f} MB/s")
            if snap.get("eta_s") is not None:
                parts.append(f"ETA {snap['eta_s']:.0f}s")
            remote = snap.get("remote")
            if remote and remote.get("Ratio") is not None:
                parts.append(f"server {float(remote['Ratio']) * 100:.0f}%")
        ts = self.ctx.timeseries
        if ts is not None:
            link = ts.latest(_LINK_SERIES)
            if link is not None:
                parts.append(f"link {link:.1f} MB/s")
            busy = [ts.latest(n) for n in ts.names()
                    if n.startswith("device.") and n.endswith(".busy_ratio")]
            busy = [b for b in busy if b is not None]
            if busy:
                parts.append(f"busy {100 * sum(busy) / len(busy):.0f}%")
            free = ts.latest("secret.arena_free_slabs")
            if free is not None:
                parts.append(f"arena free {free:.0f}")
        # the fleet column: the telemetry poller's per-replica fragment, set
        # by the coordinator while a fan-out with the poller runs
        fleet_live = self.ctx.fleet_live
        if fleet_live is not None:
            try:
                parts.append(fleet_live())
            except Exception:
                pass
        from trivy_tpu_torch.obs import recorder as _recorder

        dev = _recorder.live_fragment()
        if dev:
            parts.append(dev)
        # the online controller's column: the knobs now and its decisions
        ctl = self.ctx.tuning_controller
        if ctl is not None:
            try:
                k = ctl.adapter.knobs()
                parts.append(f"tune s{k['feed_streams']}/i{k['inflight']} "
                             f"({len(ctl.decisions)} dec)")
            except Exception:
                pass
        return "scan " + " | ".join(parts) if parts else "scan starting..."

    def start(self) -> "LiveProgress":
        self._thread = threading.Thread(target=self._loop, daemon=True, name="telemetry-live")
        self._thread.start()
        return self

    def _loop(self) -> None:
        from trivy_tpu_torch import obs

        with obs.activate(self.ctx):
            while not self._stop.wait(self.interval):
                self._emit()

    def _emit(self) -> None:
        try:
            self.stream.write("\r\x1b[2K" + self.line())
            self.stream.flush()
            self._wrote = True
        except (ValueError, OSError):  # closed stream on teardown
            self._stop.set()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self._emit()
        if self._wrote:
            try:
                self.stream.write("\n")
                self.stream.flush()
            except (ValueError, OSError):
                pass
