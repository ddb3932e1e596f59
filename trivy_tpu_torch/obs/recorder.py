"""Device-lane accounting (the port of the parts of
``trivy_tpu/obs/recorder.py`` that the exports read).

- **Compile ledger** (:func:`note_compile`): in the JAX package a compile
  is the first jit call per shape bucket. In the port a *compile* is a
  kernel library made ready in this process: ``ops/_build.py::load``
  reports each CUDA source it loads, with the bucket ``nvcc`` when
  ``build`` had to run the compiler and ``cached`` when the library was
  already on disk, and the seconds of both. A library loads once per
  process, so the JAX package's recompile storms cannot happen: the
  ``device`` block keeps their keys, with no storm and the JAX threshold.
- **HBM ledger** (:func:`note_resident`): resident bytes by category (the
  secret feed's arena, the CVE bound matrix, the license corpus) against
  the card's memory, ``total_memory`` of the current CUDA device, or
  :data:`DEFAULT_CAPACITY_BYTES` without one.

Each ledger event, and every other significant event (span boundaries
above ``SPAN_FLOOR_S``, batch retries and OOM splits,
degrades, injected faults), lands in a bounded ring on the active scan
context and in one process ring; :func:`counter_series` draws the Perfetto
counter tracks from the scan's. Both ledgers export as
``trivy_tpu_compile_*`` / ``trivy_tpu_hbm_*`` gauges and as the ``device``
block of ``--metrics-out`` (:func:`device_doc`).

- **Diagnostic bundles** (:func:`auto_emit`): on a terminal failure or a
  degraded completion the CLI writes one self-contained gzipped bundle (the
  ring, the health counts, the stall verdict, the metrics, the ledgers with
  the card's name, and a one-paragraph machine verdict naming the first
  anomalous event) under ``--debug-dir`` / ``TRIVY_TPU_DEBUG_DIR``, keeping
  the newest ``TRIVY_TPU_DEBUG_KEEP`` (8). ``python -m trivy_tpu_torch
  debug <bundle>`` renders it. The schema is the JAX package's.

The recorder is always on and never starts a thread.
"""

from __future__ import annotations

import gzip
import json
import os
import threading
import time

from trivy_tpu_torch import log

logger = log.logger("obs:recorder")

ENV_DEBUG_DIR = "TRIVY_TPU_DEBUG_DIR"
ENV_DEBUG_KEEP = "TRIVY_TPU_DEBUG_KEEP"

# a ring holds at most RING_MAX_EVENTS events and at most RING_BYTES
# (approximate accounting; the oldest events evict first)
RING_MAX_EVENTS = 512
RING_BYTES = 256 * 1024
# span boundaries only enter the ring above this duration (the JAX default)
SPAN_FLOOR_S = 0.050
DEFAULT_DEBUG_KEEP = 8
# the JAX package's default recompile-storm threshold, reported as is
STORM_THRESHOLD = 6
# the capacity the HBM ledger scores against when no card is visible
DEFAULT_CAPACITY_BYTES = 1024 << 20
# per-event detail strings are truncated so one giant repr cannot evict
# the whole ring
DETAIL_MAX_CHARS = 200

BUNDLE_SCHEMA = "trivy-tpu-debug-bundle/v1"

# event kinds that count as anomalous for the machine verdict, most severe
# first: the verdict names the earliest, ties broken by this ranking
ANOMALOUS_KINDS = (
    "fault", "error", "oom", "dead", "breaker", "degrade", "storm",
    "retry", "shed",
)

_EVENT_BASE_BYTES = 96  # approximate fixed per-event overhead


def _env_keep() -> int:
    """``TRIVY_TPU_DEBUG_KEEP``: bundles kept per debug dir (at least 1)."""
    try:
        return max(1, int(os.environ.get(ENV_DEBUG_KEEP, "") or DEFAULT_DEBUG_KEEP))
    except ValueError:
        return DEFAULT_DEBUG_KEEP


class Ring:
    """Byte- and count-bounded event ring (oldest evicts first)."""

    __slots__ = ("max_events", "max_bytes", "_lock", "_events", "_bytes", "dropped")

    def __init__(self, max_events: int = RING_MAX_EVENTS, max_bytes: int = RING_BYTES):
        self.max_events = max_events
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._bytes = 0
        self.dropped = 0

    @staticmethod
    def _size(ev: dict) -> int:
        n = _EVENT_BASE_BYTES + len(ev.get("what", ""))
        for k, v in (ev.get("detail") or {}).items():
            n += len(k) + len(str(v))
        return n

    def append(self, ev: dict) -> None:
        sz = self._size(ev)
        with self._lock:
            self._events.append(ev)
            self._bytes += sz
            while self._events and (len(self._events) > self.max_events
                                    or self._bytes > self.max_bytes):
                old = self._events.pop(0)
                self._bytes -= self._size(old)
                self.dropped += 1

    def snapshot(self) -> list[dict]:
        with self._lock:
            return [dict(e) for e in self._events]

    def last(self, *kinds: str) -> dict | None:
        """The newest event of any of ``kinds``, or None."""
        with self._lock:
            for ev in reversed(self._events):
                if ev.get("kind") in kinds:
                    return dict(ev)
        return None


class _State:
    """Per-process recorder state: the process ring, the compile and HBM
    ledgers, and the bundle-emission bookkeeping."""

    def __init__(self):
        self.ring = Ring()
        self.lock = threading.Lock()
        self.debug_dir: str = os.environ.get(ENV_DEBUG_DIR, "")
        self.debug_keep = _env_keep()
        # (trace8, reason) pairs already emitted: one bundle per scan and
        # reason
        self.emitted: set[tuple[str, str]] = set()
        # compile ledger: per-kernel [count, wall_s], per (kernel, bucket) count
        self.compiles: dict[str, list] = {}
        self.compile_buckets: dict[tuple[str, str], int] = {}
        # HBM ledger: category -> resident bytes
        self.resident: dict[str, int] = {}
        self._capacity: int | None = None

    def capacity_bytes(self) -> int:
        """The card's memory, else :data:`DEFAULT_CAPACITY_BYTES`."""
        if self._capacity is not None:
            return self._capacity
        cap = 0
        try:
            import torch

            if torch.cuda.is_available():
                cap = int(torch.cuda.get_device_properties(torch.cuda.current_device())
                          .total_memory)
        except Exception:
            cap = 0
        self._capacity = cap if cap > 0 else DEFAULT_CAPACITY_BYTES
        return self._capacity


_STATE = _State()
_CTX_LOCK = threading.Lock()


def _ctx_ring(ctx) -> Ring:
    ring = getattr(ctx, "_flight_ring", None)
    if ring is None:
        with _CTX_LOCK:
            ring = getattr(ctx, "_flight_ring", None)
            if ring is None:
                ring = ctx._flight_ring = Ring()
    return ring


def set_debug_dir(path: str | None) -> None:
    """Install the bundle destination (``--debug-dir``)."""
    if path:
        _STATE.debug_dir = path


def record(kind: str, what: str, detail: dict | None = None, ctx=None) -> None:
    """Append one significant event to the ring of ``ctx`` (the active
    scan's by default) and to the process ring."""
    from trivy_tpu_torch import obs

    if ctx is None:
        ctx = obs.current()
    ev: dict = {"t": time.time(), "kind": kind, "what": what, "trace": ctx.trace_id[:8]}
    if detail:
        ev["detail"] = {
            k: (v if isinstance(v, (int, float, bool)) or v is None
                else str(v)[:DETAIL_MAX_CHARS])
            for k, v in detail.items()
        }
    _ctx_ring(ctx).append(ev)
    _STATE.ring.append(ev)


def _span_hook(ctx, sp) -> None:
    """Installed as ``obs._flight_hook``: span boundaries above the latency
    floor become ring events."""
    if sp.duration < SPAN_FLOOR_S:
        return
    record("span", sp.name, {"seconds": round(sp.duration, 4)}, ctx=ctx)


def _metric_counter(name: str, help: str, labelnames=()):
    from trivy_tpu_torch.obs import metrics as obs_metrics

    return obs_metrics.REGISTRY.counter(name, help, labelnames)


def _metric_gauge(name: str, help: str, labelnames=()):
    from trivy_tpu_torch.obs import metrics as obs_metrics

    return obs_metrics.REGISTRY.gauge(name, help, labelnames)


# -- device-lane accounting: compiles ---------------------------------------


def note_compile(kernel: str, bucket: str, seconds: float) -> None:
    """One compile of ``kernel`` (see the module docstring for what that is
    in the port) in ``bucket`` took ``seconds``: the ledger, the
    ``trivy_tpu_compile_*`` counters and the ring."""
    st = _STATE
    with st.lock:
        tot = st.compiles.setdefault(kernel, [0, 0.0])
        tot[0] += 1
        tot[1] += seconds
        count = tot[0]
        key = (kernel, bucket)
        st.compile_buckets[key] = st.compile_buckets.get(key, 0) + 1
    _metric_counter("trivy_tpu_compile_total",
                    "Kernel compiles observed by the flight recorder",
                    labelnames=("kernel",)).inc(kernel=kernel)
    _metric_counter("trivy_tpu_compile_seconds_total", "Kernel compile wall time",
                    labelnames=("kernel",)).inc(seconds, kernel=kernel)
    record("compile", kernel, {"bucket": bucket, "seconds": round(seconds, 4), "n": count})


def compile_count() -> int:
    """Total compiles observed so far."""
    st = _STATE
    with st.lock:
        return sum(c for c, _ in st.compiles.values())


# -- device-lane accounting: HBM ledger -------------------------------------


def note_resident(category: str, nbytes: int) -> None:
    """``nbytes`` more of ``category`` (``arena`` / ``cve`` / ``corpus``)
    became device-resident; negative deltas release."""
    st = _STATE
    if not nbytes:
        return
    with st.lock:
        now = st.resident.get(category, 0) + int(nbytes)
        st.resident[category] = max(0, now)
        resident = st.resident[category]
        total = sum(st.resident.values())
    _metric_gauge("trivy_tpu_hbm_resident_bytes",
                  "Device-resident bytes tracked by the flight recorder's HBM "
                  "ledger, by category",
                  labelnames=("category",)).set(resident, category=category)
    _metric_gauge("trivy_tpu_hbm_device_capacity_bytes",
                  "Device memory capacity the HBM ledger scores residency against",
                  ).set(st.capacity_bytes())
    record("hbm", category, {"delta": int(nbytes), "resident": resident, "total": total})


def release_resident(category: str, nbytes: int) -> None:
    note_resident(category, -abs(int(nbytes)))


def hbm_ratio() -> float:
    """Resident bytes / device capacity."""
    st = _STATE
    with st.lock:
        total = sum(st.resident.values())
    cap = st.capacity_bytes()
    return total / cap if cap > 0 else 0.0


# -- export surfaces --------------------------------------------------------


def device_doc() -> dict | None:
    """The ``device`` block for ``--metrics-out``: compile ledger and HBM
    residency; None while the ledgers are empty."""
    st = _STATE
    with st.lock:
        if not st.compiles and not st.resident:
            return None
        compiles = {k: {"count": c, "wall_s": round(w, 4)}
                    for k, (c, w) in sorted(st.compiles.items())}
        buckets = {f"{k}|{b}": n for (k, b), n in sorted(st.compile_buckets.items())}
        resident = dict(sorted(st.resident.items()))
    cap = st.capacity_bytes()
    total = sum(resident.values())
    return {
        "compiles": compiles,
        "compile_total": sum(v["count"] for v in compiles.values()),
        "compile_wall_s": round(sum(v["wall_s"] for v in compiles.values()), 4),
        "shape_buckets": buckets,
        "recompile_storms": [],
        "storm_threshold": STORM_THRESHOLD,
        "hbm": {
            "resident_bytes": resident,
            "resident_total_bytes": total,
            "device_capacity_bytes": cap,
            "ratio": round(total / cap, 4) if cap else 0.0,
        },
    }


def counter_series(ctx) -> dict:
    """Perfetto counter tracks from the scan's ring: cumulative compiles
    and HBM-resident bytes over the scan's timeline."""
    ring = getattr(ctx, "_flight_ring", None)
    if ring is None:
        return {}
    compiles: list = []
    hbm: list = []
    n = 0
    for ev in ring.snapshot():
        t = ev["t"] - ctx.created_wall
        if ev["kind"] == "compile":
            n += 1
            compiles.append((round(t, 6), n))
        elif ev["kind"] == "hbm":
            hbm.append((round(t, 6), (ev.get("detail") or {}).get("total", 0)))
    out = {}
    if compiles:
        out["device.compiles_total"] = {"points": compiles}
    if hbm:
        out["device.hbm_resident_bytes"] = {"points": hbm}
    return out


# -- live fragments (heartbeat / --live) ------------------------------------


def live_fragment() -> str:
    """Device fragment of the ``--live`` line: ``compiles 6 hbm 3%``."""
    n = compile_count()
    ratio = hbm_ratio()
    if not n and not ratio:
        return ""
    frag = f"compiles {n}"
    if ratio:
        frag += f" hbm {ratio * 100:.0f}%"
    return frag


def heartbeat_fragment(carrier) -> str:
    """Heartbeat device fragment with a per-beat delta:
    ``compiles 6 (+0) hbm 3%``; ``carrier`` holds the per-beat state."""
    n = compile_count()
    ratio = hbm_ratio()
    last_n = getattr(carrier, "_rec_last_compiles", None)
    carrier._rec_last_compiles = n
    if not n and not ratio:
        return ""
    frag = f"compiles {n}"
    if last_n is not None:
        frag += f" (+{max(0, n - last_n)})"
    if ratio:
        frag += f" hbm {ratio * 100:.0f}%"
    return frag


# -- diagnostic bundles -----------------------------------------------------


def _iso(t: float) -> str:
    import datetime

    return datetime.datetime.fromtimestamp(t, datetime.timezone.utc).isoformat(
        timespec="milliseconds")


def _verdict(reason: str, ctx, events: list[dict], error: str | None = None) -> str:
    """One machine-built paragraph naming the first anomalous event."""
    st = _STATE
    anomalous = [e for e in events if e.get("kind") in ANOMALOUS_KINDS]
    first = None
    if anomalous:
        rank = {k: i for i, k in enumerate(ANOMALOUS_KINDS)}
        t0 = min(e["t"] for e in anomalous)
        # earliest wins; among events in the same 10 ms window the most
        # severe kind names the verdict (a fault and the degrade it caused
        # land near-simultaneously: the fault is the cause)
        window = [e for e in anomalous if e["t"] - t0 <= 0.010]
        first = min(window, key=lambda e: rank.get(e["kind"], 99))
    parts = [f"Scan {ctx.trace_id[:8]}: {reason}."]
    if first is not None:
        rel = first["t"] - ctx.created_wall
        parts.append(f"First anomalous event: {first['kind']} {first['what']} at "
                     f"{_iso(first['t'])} (+{rel:.2f}s into the scan).")
        if len(anomalous) > 1:
            kinds: dict[str, int] = {}
            for e in anomalous:
                kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
            parts.append(f"{len(anomalous)} anomalous events total ("
                         + ", ".join(f"{k} x{n}" for k, n in sorted(kinds.items())) + ").")
    else:
        parts.append("No anomalous events in the ring.")
    if error:
        parts.append(f"Last error: {str(error)[:DETAIL_MAX_CHARS]}.")
    n = compile_count()
    if n:
        with st.lock:
            wall = sum(w for _, w in st.compiles.values())
            kernels = len(st.compiles)
        parts.append(f"Device lane: {n} compiles / {wall:.2f}s compile wall across {kernels} "
                     f"kernels; HBM resident {hbm_ratio() * 100:.0f}% of device memory.")
    return " ".join(parts)


def healthz_doc() -> dict:
    """The ``/healthz`` forensics fields of the process ring: the last
    error, degrade and breaker trip (the last ``OPEN``, not a close after
    it), each as event and ISO time; empty when none happened."""
    out = {}
    ring = _STATE.ring
    for field, kinds in (("LastError", ("error", "fault", "oom")),
                         ("LastDegraded", ("degrade",)),
                         ("LastBreakerTrip", ("breaker",))):
        if field == "LastBreakerTrip":
            ev = next((e for e in reversed(ring.snapshot())
                       if e.get("kind") == "breaker" and "OPEN" in e.get("what", "")), None)
        else:
            ev = ring.last(*kinds)
        if ev is not None:
            out[field] = {"Event": f"{ev['kind']} {ev['what']}", "Time": _iso(ev["t"])}
    return out


def build_bundle(ctx=None, reason: str = "on-demand", error=None) -> dict:
    """Assemble a self-contained diagnostic bundle as a dict."""
    from trivy_tpu_torch import obs
    from trivy_tpu_torch.obs import export as obs_export
    from trivy_tpu_torch.obs import stall as obs_stall

    if ctx is None:
        ctx = obs.current()
    st = _STATE
    ring = getattr(ctx, "_flight_ring", None)
    events = ring.snapshot() if ring is not None else []
    process_events = st.ring.snapshot()
    doc: dict = {
        "schema": BUNDLE_SCHEMA,
        "reason": reason,
        "created": _iso(time.time()),
        "trace_id": ctx.trace_id,
        "name": ctx.name,
        "verdict": _verdict(reason, ctx, events or process_events,
                            error=str(error) if error is not None else None),
        "events": events,
        "health": ctx.health_snapshot(),
    }
    if error is not None:
        doc["error"] = str(error)[:1000]
    if process_events and process_events != events:
        doc["process_events"] = process_events
    try:
        doc["stall"] = obs_stall.attribution(ctx)
    except Exception:
        pass
    dev = device_doc()
    if dev is not None:
        # the kernel loads and the resident ledger, with the card as
        # nvidia-smi names it when one is visible
        try:
            import torch

            if torch.cuda.is_available():
                from trivy_tpu_torch.device import card_info

                dev["card"] = card_info()
        except Exception as e:  # a missing nvidia-smi must not kill the bundle
            dev["card_error"] = str(e)[:DETAIL_MAX_CHARS]
        doc["device"] = dev
    try:
        doc["metrics"] = obs_export.metrics_dict(ctx)
    except Exception as e:  # a dying context must not kill the bundle
        doc["metrics_error"] = str(e)
    tuning = ctx.tuning_doc()
    if tuning is not None:
        doc["tuning"] = tuning
    return doc


def write_bundle(doc: dict, dest_dir: str) -> str:
    """Write one bundle as gzipped JSON under ``dest_dir`` and keep the
    newest ``TRIVY_TPU_DEBUG_KEEP`` bundles there. Returns the path."""
    keep = _STATE.debug_keep
    os.makedirs(dest_dir, exist_ok=True)
    stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
    trace8 = str(doc.get("trace_id", ""))[:8] or "proc"
    reason = str(doc.get("reason", "bundle")).replace("/", "-")
    path = os.path.join(dest_dir, f"bundle-{stamp}-{trace8}-{reason}.json.gz")
    # a same-second re-emit for the same scan must not clobber
    n = 1
    while os.path.exists(path):
        n += 1
        path = os.path.join(dest_dir, f"bundle-{stamp}-{trace8}-{reason}.{n}.json.gz")
    with gzip.open(path, "wt") as f:
        json.dump(doc, f)
    bundles = sorted(
        (os.path.join(dest_dir, name) for name in os.listdir(dest_dir)
         if name.startswith("bundle-") and name.endswith(".json.gz")),
        key=os.path.getmtime,
    )
    for old in bundles[:-keep]:
        try:
            os.unlink(old)
        except OSError:
            pass
    return path


def read_bundle(path: str) -> dict:
    """Load a bundle written by :func:`write_bundle` (gz or plain JSON)."""
    if path.endswith(".gz"):
        with gzip.open(path, "rt") as f:
            return json.load(f)
    with open(path) as f:
        return json.load(f)


def auto_emit(reason: str, ctx=None, error=None, extra: dict | None = None) -> str | None:
    """Emit a diagnostic bundle for a failure-shaped moment (a terminal
    failure, a degraded completion, a dead fleet replica): at most one per
    (scan, reason), and only with a debug dir configured. ``extra`` keys
    join the bundle's top level (a dead replica's ``replica_bundles``).
    Never raises: forensics must not take the scan down with it."""
    st = _STATE
    if not st.debug_dir:
        return None
    from trivy_tpu_torch import obs

    if ctx is None:
        ctx = obs.current()
    key = (ctx.trace_id[:8], reason)
    with st.lock:
        if key in st.emitted:
            return None
        st.emitted.add(key)
    try:
        doc = build_bundle(ctx=ctx, reason=reason, error=error)
        if extra:
            doc.update(extra)
        path = write_bundle(doc, st.debug_dir)
    except Exception as e:
        logger.warning("debug bundle emit (%s) failed: %s", reason, e)
        return None
    logger.warning("diagnostic bundle written: %s (%s)", path, reason)
    return path


def _install_hook() -> None:
    from trivy_tpu_torch import obs

    obs._flight_hook = _span_hook


# importing this module installs the span hook: the CLI, the secret scanner
# and every kernel load import it
_install_hook()
