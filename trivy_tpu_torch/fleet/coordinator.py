"""Fleet coordinator: scatter shards to replicas, gather blobs back (the
port of ``trivy_tpu/fleet/coordinator.py``).

Dispatch model: every replica gets ``inflight`` dedicated worker threads
(the bounded per-replica in-flight window; each submit also rides the RPC
client's admission-aware retry ladder, so a replica shedding with
``Retry-After`` throttles its own window without stalling the others) and
an affinity queue of shards kept largest-first. The failure ladder reuses
the mesh semantics end to end:

- **work-stealing**: a worker whose own queue drained takes the largest
  shard still queued on the most-loaded peer, so skewed shards re-balance
  without a central scheduler tick;
- **speculative re-dispatch**: an in-flight shard running past
  ``speculate x`` the median shard wall time (floor ``speculate_floor_s``)
  is handed to an otherwise-idle replica too; the first result wins, the
  losing attempt is cancelled (its poll abandons);
- **straggler split**: an in-flight fs shard past ``split_threshold x``
  that median is split at a directory boundary and its fragments race the
  whole-shard attempt;
- **replica failure**: failures feed a per-replica
  :class:`~trivy_tpu_torch.parallel.mesh.CircuitBreaker` (the threshold,
  half-open probe and backoff ladder of device dispatch) and the shard
  re-dispatches to a survivor; a replica whose queue rejects a job as
  draining hands it back without a breaker penalty;
- **all replicas dead**: the remaining shards run locally through
  :func:`~trivy_tpu_torch.fleet.plan.execute_shard` on the coordinator's
  device (findings stay byte-identical, the report flips ``Degraded``)
  unless ``--no-host-fallback`` keeps the failure loud. On the card that
  run launches the feed and license kernels in this process, and a kernel
  fault there fails the scan.

Observability folds into the coordinator's scan context: per-shard server
``Trace`` blocks join via ``ctx.ingest_remote`` (one Perfetto timeline,
replicas as distinct pids), per-shard progress polls aggregate into the
scan's :class:`~trivy_tpu_torch.obs.timeseries.ScanProgress`, the
efficiency verdict lands in the profile's ``fleet`` block, and
``fleet.dispatch``, ``fleet.steal``, ``fleet.result``, ``fleet.drain`` and
``fleet.split`` fault sites prove every rung.

The telemetry plane rides the same fan-out when ``telemetry_interval`` is
above 0 (1.0 s by default): a :class:`~trivy_tpu_torch.fleet.telemetry.ReplicaPoller`
scrapes every replica's ``/metrics`` and shard progress into headroom
scores, a :class:`~trivy_tpu_torch.fleet.controller.FleetController` turns
them into the placement weights of requeue and steal targeting, and the
poller's verdicts reach the coordinator: :meth:`FleetCoordinator.note_replica_dead`
after two failed scrapes (the breaker trips and the replica's result polls
abandon at once) and :meth:`FleetCoordinator.note_replica_draining` for a
replica whose draining gauge reads 1. :meth:`FleetCoordinator.register_replica`
and :meth:`FleetCoordinator.deregister_replica` add and withdraw a replica
mid-sweep (the ``POST /fleet/register`` seam of a server that installs
them as hooks). At interval 0 none of it exists: no thread, no buffer, no
gauge, and neither module is imported; every headroom then reads as none
and every weight as 1.
"""

from __future__ import annotations

import statistics
import threading
import time
from dataclasses import dataclass, field

from trivy_tpu_torch import faults, log, obs
from trivy_tpu_torch.device import DEFAULT_DEVICE
from trivy_tpu_torch.fleet import FleetError, parse_fleet
from trivy_tpu_torch.fleet.plan import DEFAULT_SHARDS_PER_REPLICA, split_fs_shard
from trivy_tpu_torch.obs import recorder as flight
from trivy_tpu_torch.tuning import DEFAULT_FLEET_SPLIT_THRESHOLD, DEFAULT_FLEET_TELEMETRY_INTERVAL

logger = log.logger("fleet:coordinator")

DEFAULT_INFLIGHT = 2  # async shard jobs in flight per replica
DEFAULT_SPECULATE = 2.0  # straggler multiplier over the median shard time
DEFAULT_SPECULATE_FLOOR_S = 10.0  # no speculation before this wall time
DEFAULT_JOB_TIMEOUT = 600.0  # per-shard attempt wall cap
DEFAULT_RUN_TIMEOUT = 3600.0  # whole-fan-out wall cap
RESULT_POLL_S = 0.1
PROGRESS_EVERY_POLLS = 5  # fold replica progress every Nth result poll
# a straggler split must leave a replica no headroom to hide behind: only
# shards whose owning replica scores at or below this are split; with the
# poller off every headroom reads as none (0.0)
SPLIT_HEADROOM_MAX = 0.05


class ReplicaDraining(Exception):
    """A replica rejected a queued shard because it is draining (SIGTERM
    -> ``"draining"`` on ``/healthz``): hand the shard back for re-dispatch
    WITHOUT a breaker penalty; the replica is shutting down cleanly, not
    failing."""


@dataclass
class FleetConfig:
    """Resolved coordinator knobs, the JAX ``FleetConfig``'s fields.
    ``inflight`` and ``split_threshold`` resolve through
    :class:`~trivy_tpu_torch.tuning.TuningConfig` (CLI > ``TRIVY_TPU_FLEET_*``
    > autotune record > default), as does ``telemetry_interval``; an
    explicit 0 wins."""

    hosts: list = field(default_factory=list)
    token: str = ""
    inflight: int = DEFAULT_INFLIGHT
    shards_per_replica: int = DEFAULT_SHARDS_PER_REPLICA
    speculate: float = DEFAULT_SPECULATE  # 0 disables speculation
    speculate_floor_s: float = DEFAULT_SPECULATE_FLOOR_S
    host_fallback: bool = True
    job_timeout: float = DEFAULT_JOB_TIMEOUT
    run_timeout: float = DEFAULT_RUN_TIMEOUT
    # cross-replica dedup warming: warm hit-store entries
    # ([[persist_key, doc], ...]) shipped once per replica on its first
    # shard so a fresh replica joins a re-scan warm (entries are
    # namespace-keyed, replicas drop mismatches)
    warm_seed: list = field(default_factory=list)
    rpc_retries: int = 1  # replica-death detection must be fast: the
    rpc_deadline: float = 10.0  # coordinator's ladder is the real retry
    poll_s: float = RESULT_POLL_S
    # replica health-poll cadence (the telemetry plane); 0 disables the
    # poller entirely: no thread, no telemetry import, no fleet gauges
    telemetry_interval: float = DEFAULT_FLEET_TELEMETRY_INTERVAL
    # mid-scan re-planning: an in-flight fs shard running past
    # ``split_threshold x`` the median shard wall (floor
    # ``speculate_floor_s``) is split at a directory boundary and the
    # remainder re-scattered; 0 disables
    split_threshold: float = DEFAULT_FLEET_SPLIT_THRESHOLD
    # bearer token a POST /fleet/register must present on the live-join
    # seam; empty falls back to the scan token
    register_token: str = ""

    @classmethod
    def from_opts(cls, opts: dict, tuning=None) -> "FleetConfig":
        hosts = parse_fleet(opts.get("fleet"))
        if not hosts:
            raise ValueError("--fleet: at least one replica address required")
        inflight = int(opts.get("fleet_inflight") or getattr(tuning, "fleet_inflight", 0)
                       or DEFAULT_INFLIGHT)
        speculate = opts.get("fleet_speculate")
        cfg = cls(
            hosts=hosts,
            token=opts.get("token") or "",
            inflight=max(1, inflight),
            shards_per_replica=max(1, int(opts.get("fleet_shards_per_replica")
                                          or DEFAULT_SHARDS_PER_REPLICA)),
            host_fallback=not opts.get("no_host_fallback"),
        )
        if speculate is not None:
            cfg.speculate = max(0.0, float(speculate))
        # an explicit 0 must win over the tuning layer (0.0 is falsy, so no
        # `or` chain here): "off" is a decision, not absence
        tiv = opts.get("fleet_telemetry_interval")
        if tiv is None:
            tiv = getattr(tuning, "fleet_telemetry_interval", DEFAULT_FLEET_TELEMETRY_INTERVAL)
        cfg.telemetry_interval = max(0.0, float(tiv))
        fst = opts.get("fleet_split_threshold")
        if fst is None:
            fst = getattr(tuning, "fleet_split_threshold", DEFAULT_FLEET_SPLIT_THRESHOLD)
        cfg.split_threshold = max(0.0, float(fst))
        cfg.register_token = opts.get("fleet_register_token") or ""
        return cfg

    def target_shards(self) -> int:
        return max(1, len(self.hosts) * self.shards_per_replica)


def _normalize_100(buckets: dict[str, float]) -> dict[str, float]:
    """Round efficiency buckets to one decimal so they sum to exactly
    100.0; rounding drift lands on the largest bucket, where a +/-0.1
    cannot mislead anyone."""
    rounded = {k: round(max(0.0, v), 1) for k, v in buckets.items()}
    drift = round(100.0 - sum(rounded.values()), 1)
    if drift:
        largest = max(rounded, key=lambda k: rounded[k])
        rounded[largest] = round(rounded[largest] + drift, 1)
    return rounded


class _ShardState:
    """Coordinator-side bookkeeping for one shard across its attempts."""

    __slots__ = (
        "spec", "state", "running", "failed_on", "attempts", "started",
        "speculated", "stolen", "done", "blobs", "counted",
        "split", "parent", "children", "resolved_by",
    )

    def __init__(self, spec):
        self.spec = spec
        self.state = "queued"  # queued | inflight | done | dead
        self.running: set[int] = set()  # replica indexes mid-attempt
        self.failed_on: set[int] = set()
        self.attempts = 0
        self.started = 0.0  # first-attempt start (speculation clock)
        self.speculated = False
        self.stolen = False
        self.done = False
        self.blobs: list | None = None
        self.counted = 0  # replica-reported bytes already folded into progress
        # mid-scan re-planning: a straggler split spawns fragment states
        # whose union of paths is exactly the parent's; the parent's
        # whole-shard attempt keeps racing the fragment group, and the first
        # side to complete wins ("self" via its own attempt, "children" when
        # every fragment lands first, "parent" stamped on fragments a parent
        # win superseded)
        self.split = False  # a split was attempted (never re-split)
        self.parent: "_ShardState | None" = None
        self.children: "list[_ShardState] | None" = None
        self.resolved_by = "self"


class FleetCoordinator:
    """One fan-out: ``run(shards)`` scatters, gathers, and returns
    ``{shard index: [{"BlobID", "BlobInfo"}, ...]}``. ``device`` is the
    coordinator's own: the all-dead local fallback analyzes there."""

    def __init__(self, cfg: FleetConfig, scan_options, local_cache=None,
                 device=DEFAULT_DEVICE):
        from trivy_tpu_torch.parallel.mesh import CircuitBreaker
        from trivy_tpu_torch.rpc.client import RemoteDriver

        self.cfg = cfg
        self.scan_options = scan_options
        self.local_cache = local_cache
        self.device = device
        self.drivers = [
            RemoteDriver(h, token=cfg.token, retries=cfg.rpc_retries, deadline=cfg.rpc_deadline)
            for h in cfg.hosts
        ]
        self.breaker = CircuitBreaker(len(cfg.hosts), labels=[f"fleet:{h}" for h in cfg.hosts])
        self._sync_only = [False] * len(cfg.hosts)  # 404 on submit -> sync scan
        self.stats = {
            "replicas": len(cfg.hosts),
            "shards": 0,
            "dispatches": 0,
            "steals": 0,
            "speculative": 0,
            "redispatches": 0,
            "cancelled": 0,
            "local_fallback": 0,
            "warm_seeded": 0,  # replicas sent a warm dedup payload
            "splits": 0,  # stragglers split at a directory boundary
            "joins": 0,  # replicas that registered mid-sweep
            "drains": 0,  # replicas that handed queued work back
            "placement_decisions": 0,  # controller re-weights applied
            "replica_shards": {h: 0 for h in cfg.hosts},
        }
        self._warm_sent: set[int] = set()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queues: list[list[_ShardState]] = []
        self._shards: list[_ShardState] = []
        self._durations: list[float] = []
        self._stop = False
        # the telemetry plane's inputs, the jobs polling on each replica (the
        # poller scrapes their live progress), and per-replica attempt wall
        # accounting for the efficiency verdict
        self._active_jobs: dict[str, set[str]] = {h: set() for h in cfg.hosts}
        self._host_busy: dict[str, float] = {h: 0.0 for h in cfg.hosts}
        self._host_last_done: dict[str, float] = {}
        self._run_started = 0.0
        self.verdict: dict[str, dict] = {}  # set at fan-out end
        # the elastic plane (every list grown in lockstep by register_replica):
        # draining replicas take no new work, dead-marked replicas abandon
        # their in-flight polls now, weights bias requeue and steal placement
        self._draining = [False] * len(cfg.hosts)
        self._dead_marks = [False] * len(cfg.hosts)
        self._weights: dict[str, float] = {h: 1.0 for h in cfg.hosts}
        self._workers: list[threading.Thread] = []
        self._running = False
        self._ctx = None
        self.controller = None  # FleetController while telemetry is on
        self._poller = None  # ReplicaPoller while telemetry is on

    def active_jobs(self, host: str) -> list[str]:
        """The job ids polling on ``host`` now: the poller's progress
        targets."""
        with self._lock:
            return list(self._active_jobs.get(host, ()))

    # -- the elastic plane ---------------------------------------------------

    def register_replica(self, host: str) -> dict:
        """Live join: a replica appearing mid-sweep is probed, then every
        per-replica structure grows in lockstep under the lock (breaker
        slot, affinity queue, workers), so it steals work at once.
        Idempotent on a duplicate (the joiner's retry ladder may re-POST); a
        joiner that fails its health probe or is already draining is refused
        with :class:`FleetError`, and the running fan-out is untouched."""
        hosts = parse_fleet(host)
        if len(hosts) != 1:
            raise FleetError(f"register: exactly one replica address required, got {host!r}")
        host = hosts[0]
        faults.check("fleet.register", key=host)
        with self._lock:
            if host in self.cfg.hosts:
                return {"Host": host, "Known": True, "Replicas": len(self.cfg.hosts)}
        from trivy_tpu_torch.rpc.client import RemoteDriver, get_healthz

        # the probe runs outside the lock: a dead joiner must not stall dispatch
        try:
            hz = get_healthz(host, deadline=self.cfg.rpc_deadline)
        except Exception as e:
            raise FleetError(f"register: health probe of {host} failed: {e}") from e
        if (hz or {}).get("Status") == "draining":
            raise FleetError(f"register: {host} is draining; refusing the join")
        driver = RemoteDriver(host, token=self.cfg.token, retries=self.cfg.rpc_retries,
                              deadline=self.cfg.rpc_deadline)
        with self._cond:
            if host in self.cfg.hosts:  # lost a duplicate-register race
                return {"Host": host, "Known": True, "Replicas": len(self.cfg.hosts)}
            i = len(self.cfg.hosts)
            self.cfg.hosts.append(host)
            self.drivers.append(driver)
            self.breaker.grow(f"fleet:{host}")
            self._sync_only.append(False)
            self._draining.append(False)
            self._dead_marks.append(False)
            self._queues.append([])
            self._active_jobs[host] = set()
            self._host_busy[host] = 0.0
            self._weights[host] = 1.0
            self.stats["replicas"] = len(self.cfg.hosts)
            self.stats["joins"] += 1
            self.stats["replica_shards"].setdefault(host, 0)
            if self._running and not self._stop:
                ws = [threading.Thread(target=self._worker, args=(i, self._ctx), daemon=True,
                                       name=f"fleet-worker-r{i}-{j}")
                      for j in range(self.cfg.inflight)]
                self._workers.extend(ws)
                for w in ws:
                    w.start()
            self._cond.notify_all()
        if self.controller is not None:
            self.controller.add_host(host)
        if self._ctx is not None:
            self._ctx.count("fleet.joins")
        logger.info("replica %s joined the fleet mid-sweep (now %d replica(s))", host,
                    len(self.cfg.hosts))
        flight.record("fleet", f"replica join {host}", {"replicas": len(self.cfg.hosts)})
        return {"Host": host, "Known": False, "Replicas": len(self.cfg.hosts)}

    def deregister_replica(self, host: str) -> dict:
        """Live leave, the inverse of :meth:`register_replica`, through the
        drain hand-back: the replica takes no new work, its queued shards
        re-scatter to survivors and its in-flight attempts finish. Idempotent:
        an unknown or already-draining host is an answer, never an error."""
        hosts = parse_fleet(host)
        if len(hosts) != 1:
            raise FleetError(f"deregister: exactly one replica address required, got {host!r}")
        host = hosts[0]
        with self._cond:
            try:
                i = self.cfg.hosts.index(host)
            except ValueError:
                return {"Host": host, "Known": False, "Replicas": len(self.cfg.hosts)}
            already = self._draining[i]
            if not already:
                self._note_draining_locked(i)
                self._cond.notify_all()
        if not already:
            logger.info("replica %s deregistered from the fleet", host)
        return {"Host": host, "Known": True, "Draining": True, "Replicas": len(self.cfg.hosts)}

    def note_replica_draining(self, i: int) -> None:
        """Telemetry verdict: replica ``i`` scraped as draining; hand its
        queued shards back and stop assigning it work."""
        with self._cond:
            self._note_draining_locked(i)
            self._cond.notify_all()

    def note_replica_dead(self, i: int, reason: str = "") -> None:
        """Telemetry verdict (two failed scrapes in a row): trip the
        replica's fleet breaker now and mark it, so its in-flight result
        polls abandon at once instead of waiting out the job timeout. This
        breaker is the coordinator's, one slot per replica: the scan
        ladder's per-device breakers are not touched."""
        reason = reason or "2 consecutive dead telemetry scrapes"
        with self._cond:
            if i >= len(self._dead_marks) or self._dead_marks[i]:
                return
            self._dead_marks[i] = True
            self._cond.notify_all()
        self.breaker.trip(i, reason)
        host = self.cfg.hosts[i] if i < len(self.cfg.hosts) else f"r{i}"
        flight.record("dead", f"fleet replica {host}", {"reason": reason})
        # the dead replica's bundle carries that replica's own flight
        # recorder too (best effort: for a dead replica the pull's error is
        # the evidence)
        flight.auto_emit("dead-replica", ctx=self._ctx,
                         extra={"replica_bundles": self._pull_replica_bundles([host])})

    def note_replica_alive(self, i: int) -> None:
        """A successful scrape (or attempt) of a dead-marked replica clears
        the mark; the breaker's own half-open ladder decides re-entry."""
        with self._lock:
            if i < len(self._dead_marks):
                self._dead_marks[i] = False

    def _pull_replica_bundles(self, hosts: list[str]) -> dict[str, dict]:
        """``GET /debug/bundle`` of each named replica, so the coordinator's
        bundle carries the replica-side rings; a failed pull is recorded in
        the bundle's place."""
        from trivy_tpu_torch.rpc.client import fetch_debug_bundle

        out: dict[str, dict] = {}
        for h in hosts:
            try:
                out[h] = fetch_debug_bundle(h, token=self.cfg.token,
                                            deadline=self.cfg.rpc_deadline)
            except Exception as e:
                out[h] = {"error": f"{type(e).__name__}: {e}"}
        return out

    def apply_placement(self, weights: dict, fired: int = 0) -> None:
        """The controller's output: the placement weights that requeue
        targeting and steal ordering read, and the decisions it fired."""
        with self._lock:
            self._weights = dict(weights)
            if fired:
                self.stats["placement_decisions"] += fired

    # -- queue mechanics (all under self._lock) ------------------------------

    def _insert_sorted(self, q: list[_ShardState], shard: _ShardState) -> None:
        for pos, s in enumerate(q):
            if shard.spec.nbytes > s.spec.nbytes:
                q.insert(pos, shard)
                return
        q.append(shard)

    def _pending_locked(self) -> int:
        n = 0
        for s in self._shards:
            if s.state in ("done", "dead"):
                continue
            if s.children is not None and not s.running and all(
                    c.state in ("done", "dead") for c in s.children):
                # a split parent with no racing attempt of its own is
                # settled by its fragments (a dead fragment completes in the
                # post-loop fallback, which resolves the parent)
                continue
            n += 1
        return n

    def _median_wall_locked(self) -> float | None:
        """Median shard wall for straggler deadlines. Before ANY shard has
        completed, the estimate is seeded from planner byte sizes over the
        observed progress throughput: a 2-shard plan with one stalled shard
        must still speculate on or split the straggler."""
        if self._durations:
            return statistics.median(self._durations)
        counted = sum(s.counted for s in self._shards if s.parent is None)
        elapsed = time.monotonic() - self._run_started
        if counted <= 0 or elapsed <= 0:
            return None
        sizes = [s.spec.nbytes for s in self._shards if s.parent is None and s.spec.nbytes > 0]
        if not sizes:
            return None
        return statistics.median(sizes) * elapsed / counted

    def _speculate_deadline_locked(self) -> float:
        med = self._median_wall_locked()
        if med is not None:
            return max(self.cfg.speculate_floor_s, self.cfg.speculate * med)
        return self.cfg.speculate_floor_s

    def _take_locked(self, i: int) -> tuple[_ShardState | None, str]:
        """Next shard for replica ``i``: own largest -> stolen largest from
        the most-loaded peer -> largest fragment of a freshly split
        straggler -> speculative twin of the worst straggler."""
        q = self._queues[i]
        if q:
            return q.pop(0), "own"
        donors = [j for j in range(len(self._queues)) if j != i and self._queues[j]]
        if donors:
            # the largest stealable shard across peers (queues are sorted
            # desc, so each queue's first eligible entry is its largest);
            # shards this replica already failed on are not stealable, and
            # donors rank by weighted queued bytes so a drowning replica
            # sheds first
            best = None
            best_j = -1
            for j in sorted(donors, key=lambda j: -sum(s.spec.nbytes for s in self._queues[j])
                            / max(0.05, self._weights.get(self.cfg.hosts[j], 1.0))):
                for s in self._queues[j]:
                    if i in s.failed_on:
                        continue
                    if best is None or s.spec.nbytes > best.spec.nbytes:
                        best, best_j = s, j
                    break
            if best is not None:
                self._queues[best_j].remove(best)
                best.stolen = True
                self.stats["steals"] += 1
                return best, "steal"
        split = self._try_split_locked(i)
        if split is not None:
            return split, "split"
        if self.cfg.speculate > 0:
            now = time.monotonic()
            deadline = self._speculate_deadline_locked()
            cands = [
                s for s in self._shards
                if s.state == "inflight" and not s.done and not s.speculated
                and s.children is None
                and i not in s.running and i not in s.failed_on
                and now - s.started > deadline
            ]
            if cands:
                shard = min(cands, key=lambda s: s.started)  # worst straggler
                shard.speculated = True
                self.stats["speculative"] += 1
                return shard, "speculate"
        return None, ""

    def _owner_headroom_locked(self, s: _ShardState) -> float:
        """Best headroom among the replicas running ``s``: a split fires
        only when even the most relieved owner is out of headroom. No
        telemetry (the poller off, a host never scraped) reads as 0.0: with
        no gauge arguing that the owner can catch up, the straggler deadline
        alone decides."""
        p = self._poller
        if p is None or not s.running:
            return 0.0
        hs = []
        for j in s.running:
            if j < len(self.cfg.hosts):
                rh = p.health.get(self.cfg.hosts[j])
                hs.append(rh.headroom() if rh is not None else 0.0)
        return max(hs) if hs else 0.0

    def _try_split_locked(self, i: int) -> _ShardState | None:
        """Mid-scan re-planning: when an in-flight fs shard's wall exceeds
        ``split_threshold x`` the median and its owner has no headroom,
        split it at a directory boundary (Helm subtrees stay whole), scatter
        the fragments to survivors, and hand the largest to this worker. The
        parent's attempt keeps racing the fragment group: the first side to
        finish wins, so a split can never lose work."""
        if self.cfg.split_threshold <= 0:
            return None
        med = self._median_wall_locked()
        if med is None:
            return None
        now = time.monotonic()
        deadline = max(self.cfg.speculate_floor_s, self.cfg.split_threshold * med)
        cands = [
            s for s in self._shards
            if s.state == "inflight" and not s.done and not s.split
            and s.children is None and s.parent is None
            and s.spec.wire.get("Kind") == "fs"
            and i not in s.running and i not in s.failed_on
            and now - s.started > deadline
            and self._owner_headroom_locked(s) <= SPLIT_HEADROOM_MAX
        ]
        if not cands:
            return None
        shard = min(cands, key=lambda s: s.started)  # worst straggler
        shard.split = True  # one split per shard, even if it fails below
        try:
            faults.check("fleet.split", key=str(shard.spec.index))
            frags = split_fs_shard(shard.spec, n=2)
        except Exception as e:
            logger.warning("split of %s abandoned: %s (original attempt keeps racing)",
                           shard.spec.label(), e)
            return None
        if not frags:
            return None  # indivisible (single planning unit)
        children = []
        for spec in frags:
            c = _ShardState(spec)
            c.parent = shard
            children.append(c)
        shard.children = children
        self._shards.extend(children)
        self.stats["splits"] += 1
        logger.info("straggler %s split into %d fragment(s) after %.1fs (median %.1fs)",
                    shard.spec.label(), len(children), now - shard.started, med)
        flight.record("fleet", f"shard split {shard.spec.label()}",
                      {"fragments": len(children)})
        # the largest fragment goes to this (idle) worker; the rest scatter
        # to survivors, weighted, avoiding the straggler's own owners
        for c in children[1:]:
            self._place_fragment_locked(c, avoid=shard.running | {i})
        self._cond.notify_all()
        return children[0]

    def _eligible_work_locked(self, i: int) -> bool:
        """Would :meth:`_take_locked` yield anything for replica ``i``?
        Mirrors its filters without popping: the breaker's half-open probe
        slot must only be claimed when there is an attempt to spend it on.
        Splits are deliberately NOT mirrored: a probe slot is too scarce to
        spend on re-planning someone else's shard."""
        if self._queues[i]:
            return True
        for j, q in enumerate(self._queues):
            if j != i and any(i not in s.failed_on for s in q):
                return True
        if self.cfg.speculate > 0:
            now = time.monotonic()
            deadline = self._speculate_deadline_locked()
            return any(
                s.state == "inflight" and not s.done and not s.speculated
                and s.children is None
                and i not in s.running and i not in s.failed_on
                and now - s.started > deadline
                for s in self._shards
            )
        return False

    def _weighted_target_locked(self, cands: list[int]) -> int:
        """Least *weighted* queued bytes wins: the controller's placement
        weight divides a replica's apparent load, so a down-weighted
        (drowning) replica looks fuller than its raw bytes say."""
        return min(cands, key=lambda j: (
            sum(s.spec.nbytes for s in self._queues[j])
            / max(0.05, self._weights.get(self.cfg.hosts[j], 1.0)), j))

    def _place_fragment_locked(self, child: _ShardState, avoid) -> None:
        n = len(self._queues)
        cands = [j for j in range(n) if j not in avoid and not self._draining[j]]
        if not cands:
            cands = [j for j in range(n) if not self._draining[j]] or list(range(n))
        child.state = "queued"
        self._insert_sorted(self._queues[self._weighted_target_locked(cands)], child)

    def _requeue_locked(self, shard: _ShardState, avoid: int, redispatch: bool = True) -> None:
        """Re-dispatch a failed shard to a survivor's queue (the replica
        with the least weighted queued bytes that hasn't already failed it
        and isn't draining; everyone-failed resets the slate so breaker
        probes can retry it until the attempt cap declares it dead).
        ``redispatch=False`` is the drain hand-back: the same routing, but
        the move is clean bookkeeping, not a failure retry."""
        n = len(self._queues)
        cands = [j for j in range(n)
                 if j != avoid and j not in shard.failed_on and not self._draining[j]]
        if not cands:
            shard.failed_on.clear()
            cands = ([j for j in range(n) if j != avoid and not self._draining[j]]
                     or [j for j in range(n) if j != avoid] or list(range(n)))
        target = self._weighted_target_locked(cands)
        shard.state = "queued"
        shard.speculated = False
        if redispatch:
            self.stats["redispatches"] += 1
        self._insert_sorted(self._queues[target], shard)

    def _note_draining_locked(self, i: int) -> None:
        """Replica ``i`` reported draining: stop assigning it work and hand
        its queued shards back to survivors. Shards it already accepted
        either finish (a drain waits for running jobs) or come back through
        the rejected hand-back; a replica that dies instead of draining
        cleanly is the breaker ladder's half."""
        if i >= len(self._draining) or self._draining[i]:
            return
        self._draining[i] = True
        self.stats["drains"] += 1
        handed = list(self._queues[i]) if i < len(self._queues) else []
        if handed:
            self._queues[i].clear()
        for s in handed:
            self._place_fragment_locked(s, avoid={i})
        logger.info("replica %s draining: %d queued shard(s) handed back",
                    self.cfg.hosts[i], len(handed))
        flight.record("fleet", f"replica drain {self.cfg.hosts[i]}", {"handed_back": len(handed)})

    def _resolve_split_locked(self, shard: _ShardState) -> None:
        """Settle the parent/fragments race after ``shard`` completed.
        Parent finished first -> the whole-shard result wins outright:
        every fragment is marked superseded and its blobs (even completed
        ones) are dropped, so no path can fold twice. Last fragment finished
        first -> the parent is resolved by its children and its
        still-racing attempt cancels on the next poll."""
        if shard.children is not None:
            for c in shard.children:
                if not c.done:
                    c.done = True
                    c.state = "done"
                c.resolved_by = "parent"
                c.blobs = None
                for q in self._queues:
                    if c in q:
                        q.remove(c)
            return
        p = shard.parent
        if p is not None and not p.done and all(
                c.done and c.resolved_by == "self" for c in p.children):
            p.done = True
            p.state = "done"
            p.resolved_by = "children"

    def _declare_fleet_dead_locked(self) -> None:
        """Every breaker open at once: every queued shard (and every
        in-flight shard with no attempt still running) goes to the local
        fallback; attempts still racing resolve themselves (their own
        failure paths land here again). Split parents are skipped: their
        fragments cover the same paths exactly once."""
        for q in self._queues:
            q.clear()
        for s in self._shards:
            if s.state in ("queued", "inflight") and not s.done \
                    and not s.running and s.children is None:
                s.state = "dead"

    # -- the fan-out ---------------------------------------------------------

    def run(self, specs) -> dict[int, list[dict]]:
        ctx = obs.current()
        n = len(self.cfg.hosts)
        self._run_started = time.monotonic()
        self._shards = [_ShardState(s) for s in specs]
        self.stats["shards"] = len(self._shards)
        ctx.count("fleet.shards", len(self._shards))
        self._queues = [[] for _ in range(n)]
        # round-robin the largest-first plan across affinity queues: each
        # queue stays sorted desc, and loads start near-balanced
        for k, shard in enumerate(self._shards):
            self._queues[k % n].append(shard)
        # the per-shard attempt cap bounds the all-dead detection time: a
        # shard that failed this many times (across redispatches and
        # breaker probes) is declared dead and handed to the fallback
        self._attempt_cap = max(4, 2 * n)
        self._ctx = ctx
        self._workers = [
            threading.Thread(target=self._worker, args=(i, ctx), daemon=True,
                             name=f"fleet-worker-r{i}-{j}")
            for i in range(n)
            for j in range(self.cfg.inflight)
        ]
        deadline = time.monotonic() + self.cfg.run_timeout
        # the telemetry plane is optional: at interval 0 neither module is
        # imported, no thread starts and no gauge exists, and the heartbeat's
        # fleet fragment reads the coordinator's own breakers; the tickless
        # placement controller rides the same gate (the poller ticks it)
        poller = None
        if self.cfg.telemetry_interval > 0:
            from trivy_tpu_torch.fleet.controller import FleetController
            from trivy_tpu_torch.fleet.telemetry import start_poller

            self.controller = FleetController(list(self.cfg.hosts), ctx=ctx,
                                              interval=self.cfg.telemetry_interval)
            poller = start_poller(self, ctx, interval=self.cfg.telemetry_interval)
            if poller is not None:
                poller.controller = self.controller
        self._poller = poller
        ctx.fleet_status = lambda: self._fleet_status(poller)
        if poller is not None:
            ctx.fleet_live = poller.live_fragment
        with self._cond:
            self._running = True
            for w in self._workers:
                w.start()
        try:
            with self._cond:
                while self._pending_locked() > 0:
                    if time.monotonic() > deadline:
                        raise FleetError(f"fleet scan exceeded {self.cfg.run_timeout:.0f}s "
                                         f"({self._pending_locked()} shard(s) unfinished)")
                    self._cond.wait(0.1)
        finally:
            with self._cond:
                self._stop = True
                self._running = False
                ws = list(self._workers)
                self._cond.notify_all()
            for w in ws:
                w.join(timeout=30.0)
            if poller is not None:
                poller.stop()
        dead = [s for s in self._shards if s.state == "dead"]
        if dead:
            self._fallback(dead, ctx)
        # the fan-out's shape as trace counters, so --trace and
        # --metrics-out carry the steal/speculation/redispatch story (joins
        # and placement decisions were counted live as they fired)
        for key in ("steals", "speculative", "redispatches", "splits", "drains"):
            if self.stats[key]:
                ctx.count(f"fleet.{key}", self.stats[key])
        # the verdict is computed whether or not tracing is on; the profile
        # copy feeds report()
        self.verdict = self._efficiency_verdict()
        if ctx.enabled:
            ctx.profile().note_fleet(self.verdict)
        out = {}
        for s in self._shards:
            if s.resolved_by == "parent":
                continue  # fragment superseded by its parent's win
            if s.children is not None and s.resolved_by == "children":
                continue  # split parent represented by its fragments
            if s.blobs is None:
                raise FleetError(f"{s.spec.label()} completed without blobs")
            out[s.spec.index] = s.blobs
        logger.info(
            "fleet fan-out complete: %d shard(s) over %d replica(s) (%d steal(s), "
            "%d speculative, %d redispatch(es), %d split(s), %d join(s), %d drain(s), "
            "%d local)", self.stats["shards"], len(self.cfg.hosts), self.stats["steals"],
            self.stats["speculative"], self.stats["redispatches"], self.stats["splits"],
            self.stats["joins"], self.stats["drains"], self.stats["local_fallback"])
        return out

    def _fleet_status(self, poller) -> dict:
        """Heartbeat-sized fleet snapshot: shards done/total and replica
        health. With the poller off, health is the coordinator's own breaker
        view and the fleet's MB/s is unknown."""
        with self._lock:
            done = sum(1 for s in self._shards if s.done)
            total = len(self._shards)
        if poller is not None:
            st = poller.status()
        else:
            n = len(self.cfg.hosts)
            open_ = sum(1 for j in range(n) if self.breaker.is_open(j))
            st = {"replicas": n, "healthy": n - open_, "breaker_open": open_, "fleet_mbs": None}
        st["shards_done"] = done
        st["shards_total"] = total
        return st

    def _efficiency_verdict(self) -> dict[str, dict]:
        """Per-replica efficiency buckets summing to exactly 100%:

        - ``busy``: attempt wall time (wins, losses, cancelled twins: the
          replica burned it either way) over worker capacity (run wall x
          inflight);
        - ``stalled_on_coordinator``: the tail between a replica's last
          completion and fan-out end, when it sat drained while the
          coordinator had no work left to give it;
        - ``dead``: 100 for a replica that completed nothing and ended
          behind an open breaker;
        - ``idle``: the remainder (queue gaps, poll latency).
        """
        run_wall = max(1e-9, time.monotonic() - self._run_started)
        capacity = run_wall * max(1, self.cfg.inflight)
        with self._lock:
            busy = dict(self._host_busy)
            last_done = dict(self._host_last_done)
            shard_counts = dict(self.stats["replica_shards"])
        out = {}
        for j, host in enumerate(self.cfg.hosts):
            row = {"shards": int(shard_counts.get(host, 0)),
                   "busy_s": round(busy.get(host, 0.0), 3)}
            if not shard_counts.get(host) and self.breaker.is_open(j):
                row.update(busy=0.0, idle=0.0, stalled_on_coordinator=0.0, dead=100.0)
                out[host] = row
                continue
            busy_pct = 100.0 * min(1.0, busy.get(host, 0.0) / capacity)
            ld = last_done.get(host)
            tail_s = max(0.0, run_wall - (ld - self._run_started)) if ld is not None else 0.0
            stalled_pct = 100.0 * min(1.0, tail_s / run_wall)
            busy_pct = min(busy_pct, 100.0 - stalled_pct)
            row.update(_normalize_100({
                "busy": busy_pct,
                "idle": max(0.0, 100.0 - busy_pct - stalled_pct),
                "stalled_on_coordinator": stalled_pct,
                "dead": 0.0,
            }))
            out[host] = row
        return out

    def _worker(self, i: int, ctx) -> None:
        with obs.activate(ctx):
            while True:
                with self._cond:
                    if self._stop or self._pending_locked() == 0:
                        return
                    shard, how = (None, "")
                    if self._draining[i]:
                        # a draining replica takes no new work: its in-flight
                        # jobs finish and its queue was already handed back
                        pass
                    elif not self.breaker.is_open(i):
                        shard, how = self._take_locked(i)
                    elif self._eligible_work_locked(i) and self.breaker.try_probe(i):
                        # an open breaker blocks dispatch until its half-open
                        # probe window arrives; the probe slot is claimed
                        # only when a take would yield work, and try_probe
                        # touches only replica i's slot
                        shard, how = self._take_locked(i)
                    if shard is None:
                        self._cond.wait(0.05)
                        continue
                    shard.running.add(i)
                    shard.attempts += 1
                    if shard.state == "queued":
                        shard.state = "inflight"
                        shard.started = time.monotonic()
                if how == "steal":
                    try:
                        faults.check("fleet.steal", key=self.cfg.hosts[i])
                    except Exception as e:
                        # a faulted steal must put the shard back, never
                        # lose it
                        logger.warning("steal on %s faulted: %s", self.cfg.hosts[i], e)
                        with self._cond:
                            shard.running.discard(i)
                            if not shard.done and not shard.running:
                                shard.state = "queued"
                                self._insert_sorted(self._queues[i], shard)
                            self._cond.notify_all()
                        continue
                self._attempt(i, shard, ctx)

    # -- one attempt ---------------------------------------------------------

    def _attempt(self, i: int, shard: _ShardState, ctx) -> None:
        host = self.cfg.hosts[i]
        t0 = time.monotonic()
        try:
            faults.check("fleet.dispatch", key=host)
            with self._lock:  # stats writes stay lock-consistent
                self.stats["dispatches"] += 1
            ctx.count("fleet.dispatches")
            with ctx.span("fleet.dispatch"):
                resp = self._dispatch(i, shard)
            if resp is None:  # lost the speculation race mid-poll
                with self._cond:
                    self._host_busy[host] += time.monotonic() - t0
                    shard.running.discard(i)
                    self.stats["cancelled"] += 1
                    ctx.count("fleet.cancelled")
                    self._cond.notify_all()
                return
            faults.check("fleet.result", key=str(shard.spec.index))
            blobs = resp.get("Blobs")
            if blobs is None:
                raise FleetError(f"replica {host} returned no Blobs for {shard.spec.label()}")
        except Exception as e:
            drain = isinstance(e, ReplicaDraining)
            if drain:
                try:
                    faults.check("fleet.drain", key=host)
                except Exception as fe:
                    # a faulted hand-back falls back to the breaker ladder:
                    # the shard re-dispatches as a plain failure, never lost,
                    # never double-completed
                    logger.warning("drain hand-back on %s faulted: %s", host, fe)
                    drain = False
            if drain:
                logger.info("%s handed back by draining replica %s", shard.spec.label(), host)
            else:
                self.breaker.record_failure(i)
                logger.warning("%s failed on replica %s (attempt %d): %s",
                               shard.spec.label(), host, shard.attempts, e)
            fleet_dead = not drain and all(
                self.breaker.is_open(j) for j in range(len(self.cfg.hosts)))
            with self._cond:
                # a failed attempt still burned this replica's time: it
                # counts toward the verdict's busy bucket
                self._host_busy[host] += time.monotonic() - t0
                shard.running.discard(i)
                if drain:
                    # a clean drain is not a failure: no breaker penalty, no
                    # failed_on mark; the worker gate keeps replica i out of
                    # rotation and the shard re-routes
                    self._note_draining_locked(i)
                else:
                    shard.failed_on.add(i)
                if not shard.done and not shard.running:
                    if shard.children is not None:
                        # a split parent's failed attempt defers to its
                        # fragments: they cover the same paths
                        pass
                    elif drain:
                        self._requeue_locked(shard, avoid=i, redispatch=False)
                    elif fleet_dead or shard.attempts >= self._attempt_cap:
                        # exhausted everywhere: hand it to the fallback
                        shard.state = "dead"
                        logger.error("%s failed %d attempt(s); no dispatchable replica left "
                                     "- falling back to a local scan", shard.spec.label(),
                                     shard.attempts)
                    else:
                        self._requeue_locked(shard, avoid=i)
                if fleet_dead:
                    # every replica's breaker is open at once: the fleet is
                    # down; drain the queues NOW instead of burning one
                    # backoff-throttled probe per shard per attempt-cap round
                    self._declare_fleet_dead_locked()
                self._cond.notify_all()
            return
        self.breaker.record_success(i)
        wall = time.monotonic() - t0
        with self._cond:
            self._host_busy[host] += wall
            self._dead_marks[i] = False  # it answered: the verdict lapses
            shard.running.discard(i)
            if shard.done:
                # a twin attempt (or the other side of a split) already won;
                # this result is the loser
                self.stats["cancelled"] += 1
                ctx.count("fleet.cancelled")
                self._cond.notify_all()
                return
            shard.done = True
            shard.state = "done"
            shard.blobs = list(blobs)
            self._resolve_split_locked(shard)
            self._durations.append(wall)
            self.stats["replica_shards"][host] += 1
            self._host_last_done[host] = time.monotonic()
            self._cond.notify_all()
        if ctx.enabled:
            ctx.profile().note_shard(host, shard.spec.nbytes, wall, stolen=shard.stolen,
                                     speculated=shard.speculated, attempts=shard.attempts)
        self._fold_result(shard, resp, ctx)

    def _fold_result(self, shard: _ShardState, resp: dict, ctx) -> None:
        """Merge one shard response's observability into the coordinator
        scan: the replica's Trace block joins the timeline (a distinct pid
        in the export), its health events (skipped files, degradations) sum
        into the report metadata, and progress tops up to the shard's
        planned bytes."""
        if ctx.enabled and resp.get("Trace"):
            ctx.ingest_remote(resp["Trace"])
        for name, v in (resp.get("Health") or {}).items():
            if v:
                ctx.health_count(name, int(v))
        with self._lock:
            delta = shard.spec.nbytes - shard.counted
            shard.counted = shard.spec.nbytes
            if shard.parent is not None and delta > 0:
                # a fragment's bytes also count against its parent so a
                # later parent win folds only the remaining delta (progress
                # never double-counts a split)
                p = shard.parent
                p.counted = min(p.spec.nbytes, p.counted + delta)
        if delta > 0:
            ctx.progress().note_scanned(delta, files=0)

    def _note_progress(self, shard: _ShardState, snap: dict, ctx) -> None:
        scanned = min(int(snap.get("BytesScanned") or 0), shard.spec.nbytes)
        with self._lock:
            delta = scanned - shard.counted
            if delta <= 0 or shard.done:
                return
            shard.counted = scanned
        ctx.progress().note_scanned(delta, files=0)

    # -- replica RPC ---------------------------------------------------------

    def _dispatch(self, i: int, shard: _ShardState):
        """One attempt on replica ``i``: async submit and a cancellable
        result poll, falling back to a synchronous shard scan on replicas
        without the job API (404 on submit). Returns the raw shard
        response, or None when a speculation twin won while this attempt
        was in flight."""
        from trivy_tpu_torch.rpc.client import RPCError

        driver = self.drivers[i]
        label = shard.spec.label()
        wire = shard.spec.wire
        if self.cfg.warm_seed:
            with self._lock:
                first = i not in self._warm_sent
                self._warm_sent.add(i)
            if first:
                # the first shard to each replica carries the warm dedup
                # entries (retries and steals do not re-send them)
                wire = dict(wire)
                wire["WarmHits"] = self.cfg.warm_seed
                self.stats["warm_seeded"] += 1
        if not self._sync_only[i]:
            try:
                sub = driver.submit(label, "", [], self.scan_options, shard=wire)
            except RPCError as e:
                if "HTTP 404" not in str(e):
                    raise
                # a replica without admission control has no job API:
                # remember and fall through to the sync path
                self._sync_only[i] = True
                logger.info("replica %s has no async job API; using synchronous shard scans",
                            self.cfg.hosts[i])
            else:
                return self._poll_result(i, shard, sub["JobID"])
        resp = driver.scan_shard(label, wire, self.scan_options)
        if shard.done:
            return None
        return resp

    def _poll_result(self, i: int, shard: _ShardState, job_id: str):
        """Poll a shard job to its end: its result, None when the shard was
        won elsewhere or the run was abandoned, :class:`ReplicaDraining`
        for a job the replica's queue rejected as draining, ``RPCError`` for
        a failed, expired or rejected job, a job past ``job_timeout``, a
        replica that stopped answering or one the poller declared dead. The
        job is in :meth:`active_jobs` while it polls."""
        host = self.cfg.hosts[i]
        with self._lock:
            self._active_jobs[host].add(job_id)
        try:
            return self._poll_result_inner(i, shard, job_id)
        finally:
            with self._lock:
                self._active_jobs[host].discard(job_id)

    def _poll_result_inner(self, i: int, shard: _ShardState, job_id: str):
        from trivy_tpu_torch.rpc.client import RPCError

        ctx = obs.current()
        driver = self.drivers[i]
        deadline = time.monotonic() + self.cfg.job_timeout
        misses = 0
        polls = 0
        while True:
            if shard.done or self._stop:
                # the twin won, or the run was abandoned (timeout): stop
                # polling so worker joins don't outlive the scan
                return None
            if self._dead_marks[i]:
                # the poller declared this replica dead: abandon the poll now,
                # so the shard re-dispatches instead of waiting out the timeout
                raise RPCError(f"replica {self.cfg.hosts[i]} declared dead by telemetry; "
                               f"abandoning job {job_id[:8]}")
            try:
                doc = driver.fetch_result(job_id)
            except RPCError:
                misses += 1
                if misses > 3 or time.monotonic() >= deadline:
                    raise
                time.sleep(self.cfg.poll_s)
                continue
            misses = 0
            status = doc.get("Status")
            if status == "done":
                return doc.get("Result") or {}
            if status == "rejected" and "draining" in (doc.get("Error") or ""):
                # the replica's admission queue handed the job back on
                # SIGTERM: a clean drain, not a failure
                raise ReplicaDraining(f"shard job {job_id[:8]} handed back: {doc.get('Error')}")
            if status in ("failed", "expired", "rejected"):
                raise RPCError(f"shard job {job_id[:8]}: {status}: {doc.get('Error', '')}")
            if time.monotonic() >= deadline:
                raise RPCError(f"shard job {job_id[:8]}: still {status} after "
                               f"{self.cfg.job_timeout:.0f}s")
            polls += 1
            if status == "running" and polls % PROGRESS_EVERY_POLLS == 0:
                try:
                    self._note_progress(shard, driver.progress(job_id), ctx)
                except Exception:
                    pass  # progress polling is advisory, never fatal
            delay = self.cfg.poll_s
            if status == "queued" and doc.get("RetryAfterSeconds"):
                delay = min(2.0, max(delay, float(doc["RetryAfterSeconds"])))
            time.sleep(delay)

    # -- all-dead degradation ------------------------------------------------

    def _fallback(self, dead: list[_ShardState], ctx) -> None:
        """Run the shards every replica failed here, on the coordinator's
        device, each under a child trace context folded back like a remote
        shard response; the scan is marked degraded. With
        ``host_fallback`` off, or a run that fails, :class:`FleetError`."""
        if not self.cfg.host_fallback:
            raise FleetError(
                f"{len(dead)} shard(s) failed on every replica and --no-host-fallback is set: "
                + ", ".join(s.spec.label() for s in dead[:4]))
        if self.local_cache is None:
            raise FleetError("no local cache available for the host-fallback scan")
        from trivy_tpu_torch.fleet import plan as fleet_plan
        from trivy_tpu_torch.obs import export as obs_export

        logger.warning("fleet degraded: scanning %d shard(s) locally (every replica is dead)",
                       len(dead))
        obs.note_scan_degraded()
        for shard in dead:
            child = obs.TraceContext(name=f"fleet-local:{shard.spec.label()}",
                                     enabled=ctx.enabled, trace_id=ctx.trace_id)
            t0 = time.monotonic()
            with obs.activate(child):
                with child.span("fleet.local_shard"):
                    try:
                        blobs = fleet_plan.execute_shard(
                            shard.spec.wire, self.local_cache, device=self.device,
                            list_all_pkgs=bool(getattr(self.scan_options, "list_all_pkgs",
                                                       False)))
                    except Exception as e:
                        # the fallback is the last rung: its failure (a
                        # kernel fault on the card among them) fails the scan
                        raise FleetError(
                            f"local fallback for {shard.spec.label()} failed: {e}") from e
            resp: dict = {"Blobs": blobs, "Health": child.health_snapshot()}
            if ctx.enabled:
                resp["Trace"] = obs_export.context_doc(child)
            shard.done = True
            shard.state = "done"
            shard.blobs = list(blobs)
            with self._lock:
                # a fallback-completed fragment may be the last one its
                # split parent was waiting on
                self._resolve_split_locked(shard)
            self.stats["local_fallback"] += 1
            ctx.count("fleet.local_fallback")
            if ctx.enabled:
                # the degraded path is a pseudo-replica in the cost
                # attribution: "local" rows, not missing bytes
                ctx.profile().note_shard("local", shard.spec.nbytes, time.monotonic() - t0,
                                         attempts=shard.attempts)
            self._fold_result(shard, resp, ctx)
