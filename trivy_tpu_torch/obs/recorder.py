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

Each ledger event also lands in a bounded ring on the active scan context,
from which :func:`counter_series` draws the Perfetto counter tracks. Both
ledgers export as ``trivy_tpu_compile_*`` / ``trivy_tpu_hbm_*`` gauges and
as the ``device`` block of ``--metrics-out`` (:func:`device_doc`). The
recorder is always on and never starts a thread. Diagnostic bundles,
``--debug-dir`` and ``auto_emit`` are not ported.
"""

from __future__ import annotations

import threading
import time

# a ring holds at most RING_MAX_EVENTS events and at most RING_BYTES
# (approximate accounting; the oldest events evict first)
RING_MAX_EVENTS = 512
RING_BYTES = 256 * 1024
# the JAX package's default recompile-storm threshold, reported as is
STORM_THRESHOLD = 6
# the capacity the HBM ledger scores against when no card is visible
DEFAULT_CAPACITY_BYTES = 1024 << 20
# per-event detail strings are truncated so one giant repr cannot evict
# the whole ring
DETAIL_MAX_CHARS = 200

_EVENT_BASE_BYTES = 96  # approximate fixed per-event overhead


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


class _State:
    """Per-process ledgers: compiles and HBM residency."""

    def __init__(self):
        self.lock = threading.Lock()
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


def record(kind: str, what: str, detail: dict | None = None, ctx=None) -> None:
    """Append one ledger event to the ring of ``ctx`` (the active scan's by
    default)."""
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
