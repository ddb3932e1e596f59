"""Fleet telemetry plane: the coordinator's replica poller (the port of
``trivy_tpu/fleet/telemetry.py``).

A :class:`ReplicaPoller` thread scrapes each replica's ``GET /metrics``
exposition (parsed back into typed samples by
:func:`trivy_tpu_torch.obs.metrics.parse_text`) and the live progress of
that replica's shard jobs on a cadence (``--fleet-telemetry-interval`` /
``TRIVY_TPU_FLEET_TELEMETRY_INTERVAL``, 1.0 s by default; 0 is off with no
thread, buffer or gauge, and this module is then never imported). Each
scrape folds into a bounded per-replica :class:`ReplicaHealth` series (link
MB/s, the card's busy ratio, free arena slabs, admission queue depth,
breaker state), scored by :meth:`ReplicaHealth.headroom` in [0, 1]: the
input of the placement controller (:mod:`trivy_tpu_torch.fleet.controller`)
and of the straggler split.

The poller also gives the verdicts the coordinator cannot see from its own
dispatches: :data:`DEAD_SCRAPE_STREAK` failed scrapes in a row mark a
replica dead (its breaker trips and its in-flight result polls abandon at
once), and a replica whose ``trivy_tpu_server_draining`` gauge reads 1 has
its queued shards handed back before a rejected job says so.

Surfaces fed from here:

- ``trivy_tpu_fleet_*{replica="host:port"}`` gauges on the coordinator's
  process registry, the JAX names, so either package's coordinator reads
  the other's replicas; the label rows retire at :meth:`ReplicaPoller.stop`,
  and concurrent fleets over distinct replicas keep disjoint rows;
- the ``fleet`` blocks of ``--metrics-out`` and ``--timeseries-out`` and the
  per-replica counter tracks of the Perfetto trace, from ``ctx.fleet``,
  set at stop;
- the ``--live`` line's fleet column and the heartbeat's fleet MB/s.

The poller runs on the host and changes only where shards go: it never
moves a scan off the card. A failed scrape is telemetry (headroom 0, the
breaker row flips), never an error that stops the tick.
"""

from __future__ import annotations

import threading
import time

from trivy_tpu_torch import log
from trivy_tpu_torch.obs import metrics as obs_metrics
from trivy_tpu_torch.obs.timeseries import Timeseries
from trivy_tpu_torch.tuning import DEFAULT_FLEET_TELEMETRY_INTERVAL

logger = log.logger("fleet:telemetry")

# replica-side gauge families the scrape folds (name -> series name)
_SCRAPE_FOLD = {
    "trivy_tpu_link_mbs": "link_mbs",
    "trivy_tpu_arena_free_slabs": "arena_free_slabs",
}

# coordinator-side re-export gauges, all labeled {replica="host:port"}
_FLEET_GAUGE_SPECS = (
    ("trivy_tpu_fleet_link_mbs",
     "Per-replica host->device link bandwidth (MB/s), scraped by the fleet coordinator"),
    ("trivy_tpu_fleet_device_busy_ratio",
     "Per-replica max device busy fraction, scraped by the fleet coordinator"),
    ("trivy_tpu_fleet_arena_free_slabs",
     "Per-replica free feed-arena slabs, scraped by the fleet coordinator"),
    ("trivy_tpu_fleet_queue_depth",
     "Per-replica admission queue depth (all tenants), scraped by the fleet coordinator"),
    ("trivy_tpu_fleet_breaker_open",
     "1 when the coordinator's circuit breaker for this replica is open or its last "
     "scrape failed"),
    ("trivy_tpu_fleet_headroom",
     "Per-replica dispatch headroom score in [0,1] (0 = unreachable or breaker-open)"),
    ("trivy_tpu_fleet_weight",
     "Per-replica placement weight assigned by the fleet controller (absent when "
     "headroom-weighted dispatch is off)"),
)

# consecutive failed scrapes before the poller declares a replica dead and
# trips its breaker out of band (a replica that took work and died must not
# park its shard until the job timeout)
DEAD_SCRAPE_STREAK = 2


def _fleet_gauge(name: str, help: str) -> obs_metrics.Gauge:
    return obs_metrics.REGISTRY.gauge(name, help, labelnames=("replica",))


class ReplicaHealth:
    """One replica's bounded health series and scrape bookkeeping.

    Series timestamps are seconds since the owning scan context's creation
    (the clock of the local spans and sampler series), so the per-replica
    counter tracks join the merged timeline with no shift. The scalar
    fields are written by the poller thread only; readers get the last
    tick's values, which is all a headroom consumer needs."""

    def __init__(self, host: str):
        self.host = host
        self.series = Timeseries()
        self.scrapes = 0
        self.scrape_failures = 0
        self.reachable = False  # the last scrape succeeded
        self.breaker_open = False  # the coordinator's breaker, or unreachable
        self.last: dict[str, float] = {}  # latest folded values

    def note_scrape(self, t: float, parsed: dict) -> None:
        """Fold one parsed ``/metrics`` body at timestamp ``t``."""
        self.scrapes += 1
        self.reachable = True
        vals: dict[str, float] = {}
        for metric, series in _SCRAPE_FOLD.items():
            fam = parsed.get(metric)
            v = fam.first() if fam is not None else None
            if v is not None:
                vals[series] = v
        busy = parsed.get("trivy_tpu_device_busy_ratio")
        if busy is not None and busy.samples:
            vals["device_busy_ratio"] = busy.max()
        queue = parsed.get("trivy_tpu_admission_queue_depth")
        # a replica without admission control exports no queue gauge: depth
        # 0 (nothing queued), not unknown
        vals["queue_depth"] = queue.sum() if queue is not None else 0.0
        breaker = parsed.get("trivy_tpu_device_breaker_open")
        if breaker is not None and breaker.samples:
            vals["device_breaker_open"] = breaker.max()
        inflight = parsed.get("trivy_tpu_requests_in_flight")
        if inflight is not None and inflight.first() is not None:
            vals["requests_in_flight"] = inflight.first()
        for name, v in vals.items():
            self.series.record(name, t, v)
        self.last.update(vals)

    def note_failure(self, t: float) -> None:
        self.scrapes += 1
        self.scrape_failures += 1
        self.reachable = False
        self.series.record("headroom", t, 0.0)

    def note_progress(self, t: float, ratio: float, jobs: int) -> None:
        self.series.record("progress_ratio", t, ratio)
        self.series.record("jobs_active", t, float(jobs))
        self.last["progress_ratio"] = ratio

    def headroom(self) -> float:
        """Dispatch headroom in [0, 1]: 0.0 when the replica is unreachable
        or its breaker is open; otherwise ``(1 - busy) / (1 + queue_depth)``,
        halved when the feed arena has no free slab (accepted work would
        wait on allocation), rounded to 4 places."""
        if not self.reachable or self.breaker_open:
            return 0.0
        busy = min(1.0, max(0.0, self.last.get("device_busy_ratio", 0.0)))
        queue = max(0.0, self.last.get("queue_depth", 0.0))
        score = (1.0 - busy) / (1.0 + queue)
        arena = self.last.get("arena_free_slabs")
        if arena is not None and arena <= 0:
            score *= 0.5
        return round(min(1.0, max(0.0, score)), 4)

    def to_doc(self) -> dict:
        """The replica's entry of the ``fleet`` block: the summary always,
        the full series points for ``--timeseries-out`` under ``series``."""
        return {
            "headroom": self.headroom(),
            "breaker_open": bool(self.breaker_open),
            "reachable": bool(self.reachable),
            "scrapes": self.scrapes,
            "scrape_failures": self.scrape_failures,
            "summary": self.series.summary(),
            "series": self.series.to_doc(),
        }


class ReplicaPoller:
    """The coordinator's fleet telemetry thread (see the module docstring).
    ``clock`` is the time source of the series' timestamps."""

    def __init__(self, coordinator, ctx, interval: float, clock=time.perf_counter):
        self.coord = coordinator
        self.ctx = ctx
        self.interval = interval
        self.clock = clock
        self.hosts = list(coordinator.cfg.hosts)
        self.health = {h: ReplicaHealth(h) for h in self.hosts}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._gauge_rows: set[str] = set()  # replica labels ever set
        # the placement controller, which this scrape loop ticks (set by the
        # coordinator), and the per-host dead-scrape streaks
        self.controller = None
        self._dead_streaks: dict[str, int] = {}

    # -- one tick ------------------------------------------------------------

    def scrape_once(self) -> None:
        from trivy_tpu_torch.rpc.client import RPCError, get_metrics_text

        cfg = self.coord.cfg
        self._sync_hosts()
        # a dead replica must not stall the tick for the default RPC timeout:
        # the scrape deadline follows the cadence (floor 0.5 s, so a loaded
        # replica still answers)
        deadline = min(5.0, max(0.5, self.interval))
        for i, host in enumerate(self.hosts):
            t = self.clock() - self.ctx.created
            rh = self.health[host]
            coord_open = bool(self.coord.breaker.is_open(i))
            try:
                text = get_metrics_text(host, token=cfg.token, timeout=deadline)
                parsed = obs_metrics.parse_text(text)
            except (RPCError, obs_metrics.ParseError, OSError) as e:
                # a dead replica is telemetry, not an error: headroom drops to
                # 0 and the breaker row flips; the tick lives on
                logger.debug("telemetry scrape of %s failed: %s", host, e)
                rh.breaker_open = True
                rh.note_failure(t)
                streak = self._dead_streaks.get(host, 0) + 1
                self._dead_streaks[host] = streak
                if streak >= DEAD_SCRAPE_STREAK:
                    # the death verdict: trip the breaker now, so the shard
                    # this replica took re-dispatches (idempotent)
                    note_dead = getattr(self.coord, "note_replica_dead", None)
                    if note_dead is not None:
                        note_dead(i, f"{streak} consecutive dead telemetry scrapes")
                self._export(host, rh)
                continue
            self._dead_streaks[host] = 0
            alive = getattr(self.coord, "note_replica_alive", None)
            if alive is not None:
                alive(i)
            rh.breaker_open = coord_open
            rh.note_scrape(t, parsed)
            draining = parsed.get("trivy_tpu_server_draining")
            if draining is not None and draining.samples and draining.max() >= 1.0:
                # the replica announced a clean drain on its own metrics: hand
                # its queued shards back before the rejected jobs come back
                note_drain = getattr(self.coord, "note_replica_draining", None)
                if note_drain is not None:
                    note_drain(i)
            self._poll_progress(i, host, rh, t)
            rh.series.record("headroom", t, rh.headroom())
            self._export(host, rh)
        ctrl = self.controller
        if ctrl is not None:
            # the controller is tickless: this scrape loop is its clock
            fired = ctrl.tick({h: self.health[h].headroom() for h in self.hosts})
            apply_p = getattr(self.coord, "apply_placement", None)
            if apply_p is not None:
                apply_p(ctrl.weights(), len(fired))

    def _sync_hosts(self) -> None:
        """Pick up replicas that joined mid-sweep: the coordinator's host list
        only grows, so taking its tail keeps the scrape indexes aligned with
        the breaker and driver slots."""
        for h in list(self.coord.cfg.hosts)[len(self.hosts):]:
            self.hosts.append(h)
            self.health[h] = ReplicaHealth(h)

    def _poll_progress(self, i: int, host: str, rh: ReplicaHealth, t: float) -> None:
        """Fold the live progress of the replica's active shard jobs
        (advisory: a failure is skipped, the result path owns correctness)."""
        jobs = self.coord.active_jobs(host)
        if not jobs:
            return
        ratios = []
        driver = self.coord.drivers[i]
        for job_id in jobs:
            try:
                snap = driver.progress(job_id)
            except Exception:
                continue
            total = float(snap.get("BytesWalked") or 0)
            if total > 0:
                ratios.append(min(1.0, float(snap.get("BytesScanned") or 0) / total))
            elif snap.get("Ratio") is not None:
                ratios.append(min(1.0, float(snap["Ratio"])))
        if ratios:
            rh.note_progress(t, sum(ratios) / len(ratios), len(jobs))

    def _export(self, host: str, rh: ReplicaHealth) -> None:
        """Mirror a replica's latest health to the coordinator-side
        ``trivy_tpu_fleet_*{replica=}`` gauges."""
        self._gauge_rows.add(host)
        ctrl = self.controller
        vals = {
            "trivy_tpu_fleet_link_mbs": rh.last.get("link_mbs"),
            "trivy_tpu_fleet_device_busy_ratio": rh.last.get("device_busy_ratio"),
            "trivy_tpu_fleet_arena_free_slabs": rh.last.get("arena_free_slabs"),
            "trivy_tpu_fleet_queue_depth": rh.last.get("queue_depth"),
            "trivy_tpu_fleet_breaker_open": 1.0 if rh.breaker_open else 0.0,
            "trivy_tpu_fleet_headroom": rh.headroom(),
            # the weight row exists only with a controller (None skips the set)
            "trivy_tpu_fleet_weight": ctrl.weights().get(host) if ctrl is not None else None,
        }
        for name, help in _FLEET_GAUGE_SPECS:
            v = vals[name]
            if v is not None:
                _fleet_gauge(name, help).set(round(v, 4), replica=host)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ReplicaPoller":
        # a baseline tick, so even a fan-out shorter than one interval gets a
        # sample per replica, and the gauges exist from the start
        try:
            self.scrape_once()
        except Exception as e:
            logger.debug("baseline fleet telemetry tick failed: %s", e)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"fleet-telemetry-{self.ctx.trace_id[:8]}")
        self._thread.start()
        return self

    def _loop(self) -> None:
        from trivy_tpu_torch import obs

        with obs.activate(self.ctx):
            while not self._stop.wait(self.interval):
                try:
                    self.scrape_once()
                except Exception as e:  # no tick may kill the poller
                    logger.debug("fleet telemetry tick failed: %s", e)

    def stop(self, timeout: float = 5.0) -> None:
        """Idempotent: stop the thread, take a final tick so every series
        carries the end state, retire this fleet's gauge rows (a concurrent
        fleet's rows, other replica addresses, stay) and set ``ctx.fleet``."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
            try:
                self.scrape_once()
            except Exception as e:
                logger.debug("final fleet telemetry tick failed: %s", e)
        for name, help in _FLEET_GAUGE_SPECS:
            g = _fleet_gauge(name, help)
            for host in self._gauge_rows:
                g.remove(replica=host)
        self._gauge_rows.clear()
        self.ctx.fleet = self.fleet_doc()

    # -- aggregated surfaces -------------------------------------------------

    def fleet_doc(self) -> dict:
        doc = {
            "interval_s": self.interval,
            "replicas": {h: self.health[h].to_doc() for h in self.hosts},
        }
        if self.controller is not None:
            doc["controller"] = self.controller.doc()
        return doc

    def live_fragment(self) -> str:
        """Per-replica status for the ``--live`` line, e.g.
        ``fleet[r0 83% 412MB/s q0 | r1 OPEN]``."""
        parts = []
        for k, host in enumerate(self.hosts):
            rh = self.health[host]
            if rh.breaker_open or not rh.reachable:
                parts.append(f"r{k} OPEN")
                continue
            busy = rh.last.get("device_busy_ratio", 0.0) * 100.0
            mbs = rh.last.get("link_mbs", 0.0)
            q = int(rh.last.get("queue_depth", 0))
            parts.append(f"r{k} {busy:.0f}% {mbs:.0f}MB/s q{q}")
        return "fleet[" + " | ".join(parts) + "]"

    def status(self) -> dict:
        """Heartbeat-sized aggregate: replicas healthy and breaker-open, and
        the summed fleet link MB/s of the latest tick."""
        healthy = open_ = 0
        mbs = 0.0
        for rh in self.health.values():
            if rh.breaker_open or not rh.reachable:
                open_ += 1
            else:
                healthy += 1
                mbs += rh.last.get("link_mbs", 0.0)
        return {"replicas": len(self.hosts), "healthy": healthy, "breaker_open": open_,
                "fleet_mbs": round(mbs, 1)}


def start_poller(coordinator, ctx, interval: float | None = None):
    """Start the fleet poller unless telemetry is off. ``interval`` None
    resolves the tuning default; <= 0 allocates nothing (callers gate the
    import of this module on the interval too: ``FleetCoordinator.run``)."""
    if interval is None:
        interval = DEFAULT_FLEET_TELEMETRY_INTERVAL
    if interval <= 0:
        return None
    return ReplicaPoller(coordinator, ctx, interval=interval).start()
