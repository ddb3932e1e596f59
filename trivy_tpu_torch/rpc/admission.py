"""Admission control for the scan server: capacity budgets, per-tenant
fairness, and the async job queue (the port of
``trivy_tpu/rpc/admission.py``; the reference bounds scans with a
``semaphore.Weighted``).

Without it the server admits every scan, so N concurrent scans compete for
arena slabs and device memory until overload shows up as OOM splits and
breaker trips instead of a clean "try again later". This module is the
front door:

- **Capacity budgets** — a concurrent-scan budget and a queued-bytes
  budget, resolved through
  :func:`trivy_tpu_torch.tuning.admission_budgets` from the topology
  (arena slabs x slab bytes as the device-memory proxy) unless the
  operator pins them. Admit/shed decisions also consult the live gauges
  (:func:`trivy_tpu_torch.obs.timeseries.live_utilization`) and the
  per-device breaker gauge (``parallel/mesh.py``): all devices open means
  the device path is dead, so new work is shed *early* instead of queued.

- **Per-tenant accounting** — tokens map to tenants
  (:func:`parse_tenants`), each with a weight, a max-in-flight bound, and
  a queued-bytes quota. The queue dequeues by weighted deficit round
  robin over *bytes*, so one tenant's multi-GB registry sweep cannot
  starve another tenant's interactive scans.

- **Async jobs** — ``POST /scan/submit`` enqueues a scan request and
  returns a job id (the scan's trace id, so the existing
  ``GET /scan/<id>/progress`` API is the live-poll half);
  ``GET /scan/<id>/result`` returns 202 with a queue position while
  pending and the scan response once done, retained in a bounded table. A
  client-supplied deadline cancels a job that is still queued when it
  expires — an admitted-but-unstarted scan refuses to start late.

- **Honest shedding** — a full queue or an over-budget server sheds with
  503, an over-quota tenant with 429, both carrying a ``Retry-After``
  derived from the observed drain rate; the client's full-jitter backoff
  honors it. Draining rejects queued-but-unstarted jobs loudly instead of
  stranding them.

Every decision is observable (``trivy_tpu_admission_*`` counters/gauges on
``GET /metrics``, a queue-wait span feeding the stall verdict's
``queue-bound`` bucket, job state in the result API) and the deterministic
fault sites ``admission.enqueue``, ``admission.dequeue``, and
``job.result.fetch`` plug into :mod:`trivy_tpu_torch.faults` so the whole
ladder is provable under chaos.

Zero-cost-when-off: with ``max_concurrent == 0`` no controller is constructed —
no worker threads, no per-tenant state, no admission metrics on
``/metrics``, and the serve path is byte-identical to an unadmitted
server.
"""

from __future__ import annotations

import hmac
import math
import os
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field

from trivy_tpu_torch import faults, log
from trivy_tpu_torch.obs import recorder as flight

logger = log.logger("rpc:admission")

# shed reasons -> HTTP status: 503 means "the server is overloaded, any
# client should come back later"; 429 means "this tenant is over its own
# quota" (other tenants are still being admitted)
SHED_STATUS = {
    "queue-full": 503,
    "queued-bytes": 503,
    "gauge-pressure": 503,
    "breakers-open": 503,
    "concurrency": 503,
    "draining": 503,
    "enqueue-fault": 503,
    "tenant-inflight": 429,
    "tenant-bytes": 429,
}

# Retry-After fallback while no completion has been observed yet (a fresh
# server has no drain rate to derive from)
DEFAULT_RETRY_AFTER = 2
MAX_RETRY_AFTER = 120
# drain-rate observation window: completions older than this no longer
# describe the server's current throughput
DRAIN_WINDOW_SECS = 30.0

# live-gauge saturation thresholds (the tuning controller's dead band —
# the same "the device is out of headroom" signal)
PRESSURE_BUSY_MIN = 0.95

# finished-job retention default (bounded like the progress table)
DEFAULT_RESULT_KEEP = 64
DEFAULT_QUEUE_DEPTH = 64

# env spellings, matching the server flag names via the Flag layer's
# TRIVY_TPU_<NAME> rule so subprocess servers configure without CLI flags
ENV_MAX_CONCURRENT = "TRIVY_TPU_MAX_CONCURRENT_SCANS"
ENV_QUEUE_DEPTH = "TRIVY_TPU_ADMISSION_QUEUE_DEPTH"
ENV_QUEUED_MB = "TRIVY_TPU_ADMISSION_QUEUED_MB"
ENV_TENANT_INFLIGHT = "TRIVY_TPU_TENANT_MAX_INFLIGHT"
ENV_TENANT_QUEUED_MB = "TRIVY_TPU_TENANT_QUEUED_MB"
ENV_TENANTS = "TRIVY_TPU_TENANTS"
ENV_JOB_RETENTION = "TRIVY_TPU_JOB_RETENTION"
ENV_JOB_DEADLINE = "TRIVY_TPU_JOB_DEADLINE"

DEFAULT_TENANT = "default"


def validate_count(value, name: str = "count") -> int:
    """A non-negative integer knob (0 = off/derive). Garbage fails loudly
    at resolution time — the Flag layer and the env-resolution path share
    this so a typo'd quota kills server startup, not the Nth request."""
    try:
        v = int(value)
    except (TypeError, ValueError):
        raise ValueError(f"{name}: not an integer: {value!r}") from None
    if v < 0:
        raise ValueError(f"{name}: must be >= 0, got {value!r}")
    return v


def validate_seconds(value, name: str = "seconds") -> float:
    """A non-negative finite duration (0 = none)."""
    try:
        v = float(value)
    except (TypeError, ValueError):
        raise ValueError(f"{name}: not a number: {value!r}") from None
    if math.isnan(v) or math.isinf(v) or v < 0:
        raise ValueError(f"{name}: must be a finite number >= 0, "
                         f"got {value!r}")
    return v


@dataclass
class Tenant:
    """One tenant's identity and quotas. ``max_inflight``/
    ``max_queued_bytes`` of 0 fall back to the config-wide per-tenant
    defaults at decision time."""

    name: str
    token: str = ""
    weight: float = 1.0
    max_inflight: int = 0
    max_queued_bytes: int = 0


def parse_tenants(specs) -> dict[str, Tenant]:
    """``name:token[:weight[:max_inflight[:queued_mb]]]`` entries ->
    name->Tenant, validated loudly (empty fields, duplicate names/tokens,
    non-positive weights, and garbage quotas are configuration errors,
    not runtime surprises). ``max_inflight``/``queued_mb`` of 0 (or
    omitted/empty) fall back to the config-wide per-tenant defaults."""
    tenants: dict[str, Tenant] = {}
    tokens: set[str] = set()
    for spec in specs or []:
        spec = spec.strip()
        if not spec:
            continue
        parts = spec.split(":")
        if len(parts) < 2 or len(parts) > 5:
            raise ValueError(
                f"--tenants: bad entry {spec!r} "
                f"(want name:token[:weight[:max_inflight[:queued_mb]]])"
            )
        name, token = parts[0].strip(), parts[1].strip()
        if not name or not token:
            raise ValueError(f"--tenants: empty name or token in {spec!r}")
        weight = 1.0
        if len(parts) >= 3 and parts[2].strip():
            try:
                weight = float(parts[2])
            except ValueError:
                raise ValueError(
                    f"--tenants: weight not a number in {spec!r}"
                ) from None
            if weight <= 0 or math.isnan(weight) or math.isinf(weight):
                raise ValueError(
                    f"--tenants: weight must be a finite number > 0 "
                    f"in {spec!r}"
                )
        max_inflight = 0
        if len(parts) >= 4 and parts[3].strip():
            try:
                max_inflight = validate_count(
                    parts[3], f"--tenants {name!r} max_inflight"
                )
            except ValueError as e:
                raise ValueError(f"--tenants: {e} in {spec!r}") from None
        max_queued_bytes = 0
        if len(parts) >= 5 and parts[4].strip():
            try:
                max_queued_bytes = validate_count(
                    parts[4], f"--tenants {name!r} queued_mb"
                ) << 20
            except ValueError as e:
                raise ValueError(f"--tenants: {e} in {spec!r}") from None
        if name in tenants:
            raise ValueError(f"--tenants: duplicate tenant name {name!r}")
        if token in tokens:
            raise ValueError(
                f"--tenants: duplicate token (tenant {name!r}) — tokens "
                f"are the tenant identity and must be distinct"
            )
        tokens.add(token)
        tenants[name] = Tenant(
            name=name, token=token, weight=weight,
            max_inflight=max_inflight, max_queued_bytes=max_queued_bytes,
        )
    return tenants


@dataclass
class AdmissionConfig:
    """Resolved admission knobs. ``max_concurrent == 0`` means admission
    is off entirely (today's unbounded behavior, allocation-free)."""

    max_concurrent: int = 0
    queue_depth: int = DEFAULT_QUEUE_DEPTH
    queued_bytes: int = 0           # global queued-bytes budget
    tenant_max_inflight: int = 0    # per-tenant default; 0 = max_concurrent
    tenant_queued_bytes: int = 0    # per-tenant default; 0 = global budget
    result_keep: int = DEFAULT_RESULT_KEEP
    default_deadline: float = 0.0   # seconds; 0 = no implicit deadline
    tenants: dict[str, Tenant] = field(default_factory=dict)
    budgets: dict = field(default_factory=dict)  # derivation provenance

    @property
    def enabled(self) -> bool:
        return self.max_concurrent > 0

    def to_dict(self) -> dict:
        return {
            "max_concurrent": self.max_concurrent,
            "queue_depth": self.queue_depth,
            "queued_bytes": self.queued_bytes,
            "tenant_max_inflight": self.tenant_max_inflight,
            "tenant_queued_bytes": self.tenant_queued_bytes,
            "result_keep": self.result_keep,
            "default_deadline": self.default_deadline,
            "tenants": sorted(self.tenants),
        }


def resolve_admission(opts: dict | None = None,
                      env: dict | None = None) -> AdmissionConfig:
    """Resolve the admission knob set, CLI (``opts``) > env > derived
    default, validating loudly (the Flag layer validates the CLI spellings
    with the same functions, so garbage kills startup either way).

    ``max_concurrent`` keeps 0 as "admission off" — enabling admission is
    an explicit operator decision. Once enabled, unset budgets derive
    from the topology through
    :func:`trivy_tpu_torch.tuning.admission_budgets` (arena slabs x slab
    bytes as the device-memory proxy).
    """
    opts = opts or {}
    env = os.environ if env is None else env

    def _knob(opt_name: str, env_name: str, validator, vname):
        v = opts.get(opt_name)
        if v is None:
            raw = env.get(env_name, "")
            if raw == "":
                return None
            return validator(raw, vname)
        return validator(v, vname)

    cfg = AdmissionConfig()
    cfg.max_concurrent = _knob(
        "max_concurrent_scans", ENV_MAX_CONCURRENT, validate_count,
        "--max-concurrent-scans/" + ENV_MAX_CONCURRENT) or 0
    queue_depth = _knob(
        "admission_queue_depth", ENV_QUEUE_DEPTH, validate_count,
        "--admission-queue-depth/" + ENV_QUEUE_DEPTH)
    queued_mb = _knob(
        "admission_queued_mb", ENV_QUEUED_MB, validate_count,
        "--admission-queued-mb/" + ENV_QUEUED_MB)
    cfg.tenant_max_inflight = _knob(
        "tenant_max_inflight", ENV_TENANT_INFLIGHT, validate_count,
        "--tenant-max-inflight/" + ENV_TENANT_INFLIGHT) or 0
    tenant_queued_mb = _knob(
        "tenant_queued_mb", ENV_TENANT_QUEUED_MB, validate_count,
        "--tenant-queued-mb/" + ENV_TENANT_QUEUED_MB)
    retention = _knob(
        "job_retention", ENV_JOB_RETENTION, validate_count,
        "--job-retention/" + ENV_JOB_RETENTION)
    if retention is not None:
        # explicit 0 is honored: keep NO finished jobs (fire-and-forget
        # submitters that only ever watch the progress API)
        cfg.result_keep = retention
    deadline = _knob(
        "job_deadline", ENV_JOB_DEADLINE, validate_seconds,
        "--job-deadline/" + ENV_JOB_DEADLINE)
    if deadline:
        cfg.default_deadline = deadline

    specs = opts.get("tenants")
    if specs is None:
        raw = env.get(ENV_TENANTS, "")
        specs = [s for s in raw.split(",") if s.strip()] if raw else []
    cfg.tenants = parse_tenants(specs)

    if cfg.enabled:
        from trivy_tpu_torch.tuning import admission_budgets

        budgets = admission_budgets(env=env)
        cfg.budgets = budgets
        # explicit 0 is honored on every queue/byte knob (no queue:
        # every submit sheds, sync scans still budget-gated); only UNSET
        # derives the default. tenant_max_inflight keeps 0 = "derive"
        # (the full budget) — its flag help documents that convention
        cfg.queue_depth = (
            DEFAULT_QUEUE_DEPTH if queue_depth is None else queue_depth
        )
        cfg.queued_bytes = (
            budgets["queued_bytes"] if queued_mb is None
            else queued_mb * (1 << 20)
        )
        cfg.tenant_queued_bytes = (
            cfg.queued_bytes if tenant_queued_mb is None
            else tenant_queued_mb * (1 << 20)
        )
    elif cfg.tenants or any(
        v is not None for v in (queue_depth, queued_mb, tenant_queued_mb,
                                retention, deadline)
    ) or cfg.tenant_max_inflight:
        # quota/job knobs without a concurrency budget are a config
        # smell: nothing would enforce them — refuse rather than
        # silently ignore
        raise ValueError(
            "admission knobs (--tenants/--admission-queue-depth/"
            "--admission-queued-mb/--tenant-queued-mb/"
            "--tenant-max-inflight/--job-retention/--job-deadline) "
            "require --max-concurrent-scans > 0 to take effect"
        )
    return cfg


class _Job:
    """One async scan job; the id doubles as the scan's trace id so the
    progress API polls it directly."""

    __slots__ = (
        "id", "tenant", "req", "traceparent", "nbytes", "submitted",
        "deadline", "status", "result", "error", "started", "finished",
        "queue_wait",
    )

    def __init__(self, job_id, tenant, req, traceparent, nbytes, deadline):
        self.id = job_id
        self.tenant = tenant
        self.req = req
        self.traceparent = traceparent
        self.nbytes = nbytes
        self.submitted = time.monotonic()
        self.deadline = deadline  # absolute monotonic, or None
        self.status = "queued"
        self.result: dict | None = None
        self.error: str | None = None
        self.started: float | None = None
        self.finished: float | None = None
        self.queue_wait: float | None = None


class AdmissionController:
    """The server's admission queue + per-tenant accounting + job table.

    Constructed only when :class:`AdmissionConfig` is enabled; the owning
    :class:`~trivy_tpu_torch.rpc.server.ScanServer` calls :meth:`start` to spawn
    ``max_concurrent`` worker threads and :meth:`shutdown` from the drain
    path. All instruments live on the *server's* registry so an
    admission-off server renders none of them.
    """

    def __init__(self, server, config: AdmissionConfig, registry=None):
        self.server = server
        self.cfg = config
        self._cond = threading.Condition()
        self._stop = False
        self._workers: list[threading.Thread] = []
        # queue state
        self._queues: dict[str, deque[_Job]] = {}
        self._order: list[str] = []      # tenant rotation order
        self._rr = 0
        self._deficit: dict[str, float] = {}
        self._queued_bytes = 0
        self._tenant_queued_bytes: dict[str, int] = {}
        # execution state (sync scans and async jobs share the budget);
        # async jobs are ALSO counted separately — a sync scan is already
        # an in-flight HTTP request, so drain accounting must not count
        # it twice
        self._running = 0
        self._running_jobs = 0
        self._tenant_inflight: dict[str, int] = {}
        # job table: id -> _Job while queued/running, then a bounded
        # finished table (same retention discipline as finished progress)
        self._jobs: dict[str, _Job] = {}
        self._finished: OrderedDict[str, _Job] = OrderedDict()
        # drain-rate observation for Retry-After
        self._completions: deque[float] = deque(maxlen=256)
        # submit idempotency: a client retrying a submit whose 202 was
        # lost on the wire replays the same SubmitKey and gets the SAME
        # job back — without this, flaky networking duplicates jobs and
        # the orphans burn concurrency-budget slots nobody ever polls.
        # Keyed by (tenant, key): a replayed/colliding key from another
        # tenant must mint its own job, not expose someone else's job id
        self._submit_keys: OrderedDict[tuple[str, str], str] = OrderedDict()
        self._default_tenant = Tenant(name=DEFAULT_TENANT)

        if registry is None:
            registry = server.metrics.registry
        r = registry
        self.admitted = r.counter(
            "trivy_tpu_admission_admitted_total",
            "Scans admitted past the admission controller, by tenant",
            labelnames=("tenant",),
        )
        self.shed = r.counter(
            "trivy_tpu_admission_shed_total",
            "Scan requests shed by the admission controller",
            labelnames=("tenant", "reason"),
        )
        self.queue_depth_g = r.gauge(
            "trivy_tpu_admission_queue_depth",
            "Jobs waiting in the admission queue, by tenant",
            labelnames=("tenant",),
        )
        self.queued_bytes_g = r.gauge(
            "trivy_tpu_admission_queued_bytes",
            "Request bytes waiting in the admission queue, by tenant",
            labelnames=("tenant",),
        )
        self.inflight_g = r.gauge(
            "trivy_tpu_admission_inflight",
            "Scans currently executing under the admission budget, "
            "by tenant",
            labelnames=("tenant",),
        )
        self.queue_wait_h = r.histogram(
            "trivy_tpu_admission_queue_wait_seconds",
            "Time admitted jobs spent queued before their scan started",
        )
        self.jobs_c = r.counter(
            "trivy_tpu_admission_jobs_total",
            "Async scan jobs by terminal status",
            labelnames=("status",),
        )

    # -- tenant resolution --------------------------------------------------

    def match_token(self, token: str) -> Tenant | None:
        """Constant-time walk of the tenant table — compare every tenant
        (no early exit) so timing reveals neither a match nor how much of
        the table was walked. The ONE matcher shared by the server's auth
        check and :meth:`tenant_for`, so the two cannot drift."""
        token_b = (token or "").encode("latin-1", "replace")
        match = None
        for t in self.cfg.tenants.values():
            if hmac.compare_digest(
                token_b, t.token.encode("latin-1", "replace")
            ) and match is None:
                match = t
        return match

    def tenant_for(self, token: str) -> Tenant:
        """Map a request token to its tenant; unmatched tokens —
        including the plain server ``--token`` and unauthenticated
        requests on open servers — share the ``default`` tenant."""
        return self.match_token(token) or self._default_tenant

    def _tenant_inflight_limit(self, t: Tenant) -> int:
        return (
            t.max_inflight
            or self.cfg.tenant_max_inflight
            or self.cfg.max_concurrent
        )

    def _tenant_queued_limit(self, t: Tenant) -> int:
        return t.max_queued_bytes or self.cfg.tenant_queued_bytes

    # -- live-state consultation --------------------------------------------

    def _breakers_all_open(self) -> bool:
        """True when every device the process-global breaker gauge knows
        about is open — the device path is fully degraded, so queueing new
        work would only feed the (slower) host-fallback path."""
        from trivy_tpu_torch.obs import metrics as obs_metrics

        rows = obs_metrics.REGISTRY.gauge(
            "trivy_tpu_device_breaker_open",
            "1 while the per-device dispatch circuit breaker is open",
            labelnames=("device",),
        ).collect()
        return bool(rows) and all(v >= 1 for v in rows.values())

    def _shed_for_breakers(self) -> bool:
        """Shed because the devices look dead — but ONLY while work
        is already running or queued. Breakers half-open-probe (and the
        gauge resets) only when a scan actually dispatches, so an idle
        server must always admit one scan to act as the probe; shedding
        unconditionally would leave a stale all-open gauge bricking the
        server forever after a transient outage."""
        if not self._breakers_all_open():
            return False
        with self._cond:
            busy = self._running > 0 or any(
                self._queues.get(t) for t in self._order
            )
        return busy

    def _gauge_pressure(self) -> bool:
        """True when live telemetry says the device side is saturated
        (busy past the dead band with no free arena slab). Only consulted
        once the queue is already half full — pressure tightens the shed
        point, it never rejects on an empty queue."""
        from trivy_tpu_torch.obs import timeseries as obs_timeseries

        u = obs_timeseries.live_utilization()
        if not u["samplers"]:
            return False  # no telemetry is not the same as saturated
        busy, free = u["busy_max"], u["arena_free"]
        return (
            busy is not None and busy >= PRESSURE_BUSY_MIN
            and free is not None and free <= 0
        )

    # -- Retry-After --------------------------------------------------------

    def _drain_rate(self) -> float:
        """Observed completions/second, measured against the FULL
        observation window. Dividing by the age of the oldest recent
        completion would read a burst of back-to-back completions as a
        huge instantaneous rate and hand out Retry-After hints far too
        small to be honest — a compliant client would burn its whole
        retry ladder against a server that drains one 60 s scan at a
        time. Window-dividing errs toward telling clients to wait a bit
        longer than strictly needed, never shorter."""
        now = time.monotonic()
        with self._cond:
            recent = sum(1 for t in self._completions
                         if now - t <= DRAIN_WINDOW_SECS)
        return recent / DRAIN_WINDOW_SECS

    def retry_after(self, ahead: int | None = None) -> int:
        """Honest back-pressure: seconds until the queue has likely
        drained ``ahead`` entries (the whole queue by default) at the
        observed drain rate, clamped to [1, :data:`MAX_RETRY_AFTER`]."""
        if ahead is None:
            ahead = self.queue_depth()
        rate = self._drain_rate()
        if rate <= 0:
            return DEFAULT_RETRY_AFTER
        return int(min(MAX_RETRY_AFTER, max(1, math.ceil(
            (ahead + 1) / rate
        ))))

    def _note_shed(self, tenant: str, reason: str) -> None:
        """One funnel for every shed decision: the Prometheus counter and
        the flight-recorder ring see the same event."""
        self.shed.inc(tenant=tenant, reason=reason)
        flight.record("shed", f"admission {reason}", {"tenant": tenant})

    # -- synchronous admission (the blocking Scanner.Scan POST) -------------

    def try_acquire(self, tenant: Tenant) -> str | None:
        """Admit a synchronous scan into the concurrency budget, or return
        the shed reason. Sync requests never queue — a shed tells the
        client *when* to retry instead of parking its connection."""
        if self._shed_for_breakers():
            self._note_shed(tenant.name, "breakers-open")
            return "breakers-open"
        with self._cond:
            if self._running >= self.cfg.max_concurrent:
                self._note_shed(tenant.name, "concurrency")
                return "concurrency"
            if (self._tenant_inflight.get(tenant.name, 0)
                    >= self._tenant_inflight_limit(tenant)):
                self._note_shed(tenant.name, "tenant-inflight")
                return "tenant-inflight"
            self._running += 1
            self._tenant_inflight[tenant.name] = (
                self._tenant_inflight.get(tenant.name, 0) + 1
            )
            self.inflight_g.set(
                self._tenant_inflight[tenant.name], tenant=tenant.name
            )
        self.admitted.inc(tenant=tenant.name)
        return None

    def release(self, tenant: Tenant, job: bool = False) -> None:
        with self._cond:
            self._running = max(0, self._running - 1)
            if job:
                self._running_jobs = max(0, self._running_jobs - 1)
            n = max(0, self._tenant_inflight.get(tenant.name, 0) - 1)
            self._tenant_inflight[tenant.name] = n
            self.inflight_g.set(n, tenant=tenant.name)
            self._completions.append(time.monotonic())
            self._cond.notify_all()

    # -- async submit / result ----------------------------------------------

    def submit(self, req: dict, tenant: Tenant, nbytes: int,
               traceparent: str | None = None,
               deadline_s: float | None = None,
               submit_key: str | None = None) -> tuple[int, dict, dict]:
        """Enqueue one scan job; returns ``(status, payload, headers)``.
        Shed decisions happen here, at the front door, with the honest
        Retry-After attached. A repeated ``submit_key`` (client retry of
        a submit whose response was lost) returns the existing job."""
        nbytes = max(1, int(nbytes))
        if submit_key:
            with self._cond:
                jid = self._submit_keys.get((tenant.name, submit_key))
                job = self._jobs.get(jid) if jid else None
                if jid and (job is not None or jid in self._finished):
                    position = (
                        self._position_locked(job)
                        if job is not None and job.status == "queued" else 0
                    )
                    return 202, self._submit_doc(jid, tenant, position), {}

        def _shed(reason: str) -> tuple[int, dict, dict]:
            self._note_shed(tenant.name, reason)
            ra = self.retry_after()
            logger.info(
                "shed submit from tenant %s: %s (queue %d, Retry-After %d)",
                tenant.name, reason, self.queue_depth(), ra,
            )
            return (
                SHED_STATUS[reason],
                {"error": f"admission: {reason}", "Tenant": tenant.name,
                 "RetryAfterSeconds": ra},
                {"Retry-After": str(ra)},
            )

        if getattr(self.server, "draining", False):
            return _shed("draining")
        if self._shed_for_breakers():
            return _shed("breakers-open")
        try:
            faults.check("admission.enqueue", key=tenant.name)
        except Exception as e:
            logger.warning("admission.enqueue fault for %s: %s",
                           tenant.name, e)
            return _shed("enqueue-fault")
        with self._cond:
            depth = sum(len(q) for q in self._queues.values())
            if depth >= self.cfg.queue_depth:
                reason = "queue-full"
            elif self._queued_bytes + nbytes > self.cfg.queued_bytes:
                reason = "queued-bytes"
            elif (self._tenant_queued_bytes.get(tenant.name, 0) + nbytes
                  > self._tenant_queued_limit(tenant)):
                reason = "tenant-bytes"
            elif depth >= self.cfg.queue_depth // 2 and self._gauge_pressure():
                reason = "gauge-pressure"
            else:
                reason = None
            if reason is not None:
                pass  # shed outside the lock (metrics + logging)
            else:
                job_id = self._mint_job_id(traceparent)
                deadline = None
                if deadline_s is None and self.cfg.default_deadline > 0:
                    deadline_s = self.cfg.default_deadline
                if deadline_s is not None:
                    deadline = time.monotonic() + deadline_s
                job = _Job(job_id, tenant.name, req, traceparent, nbytes,
                           deadline)
                q = self._queues.setdefault(tenant.name, deque())
                if tenant.name not in self._order:
                    self._order.append(tenant.name)
                q.append(job)
                self._jobs[job_id] = job
                if submit_key:
                    self._submit_keys[(tenant.name, submit_key)] = job_id
                    while len(self._submit_keys) > 4 * self.cfg.result_keep \
                            + 64:
                        self._submit_keys.popitem(last=False)
                self._queued_bytes += nbytes
                self._tenant_queued_bytes[tenant.name] = (
                    self._tenant_queued_bytes.get(tenant.name, 0) + nbytes
                )
                # tenant-local FIFO position — the SAME definition the
                # result poll reports, so the number can't jump between
                # the submit response and the first poll
                position = self._position_locked(job)
                self._sync_queue_gauges(tenant.name)
                self._cond.notify_all()
        if reason is not None:
            return _shed(reason)
        self.admitted.inc(tenant=tenant.name)
        return 202, self._submit_doc(job.id, tenant, position), {}

    def _submit_doc(self, job_id: str, tenant: Tenant,
                    position: int) -> dict:
        from trivy_tpu_torch import rpc

        return {
            "JobID": job_id,
            "TraceID": job_id,
            "Tenant": tenant.name,
            "QueuePosition": position,
            "ResultPath": rpc.scan_result_path(job_id),
            "ProgressPath": rpc.scan_progress_path(job_id),
        }

    def _mint_job_id(self, traceparent: str | None) -> str:
        """Job id == the scan's trace id: join the client's trace when one
        rode in (and is not already taken by an earlier job), else mint a
        fresh 32-hex id."""
        from trivy_tpu_torch import obs

        joined = obs.parse_traceparent(traceparent)
        if joined and joined[0] not in self._jobs \
                and joined[0] not in self._finished:
            return joined[0]
        while True:
            jid = os.urandom(16).hex()
            if jid not in self._jobs and jid not in self._finished:
                return jid

    def result(self, job_id: str) -> tuple[int, dict, dict]:
        """Poll one job: 202 + queue position while pending, the terminal
        state once finished (bounded retention), 404 for unknown ids."""
        faults.check("job.result.fetch", key=job_id)
        with self._cond:
            job = self._jobs.get(job_id) or self._finished.get(job_id)
            if job is None:
                return 404, {"error": f"unknown job {job_id}"}, {}
            if job.status == "queued" and job.deadline is not None \
                    and time.monotonic() > job.deadline:
                # lazy expiry: the poll that observes the deadline passes
                # retires the job (the dequeue path does the same)
                self._expire_locked(job)
            if job.status == "queued":
                ahead = self._position_locked(job)
                ra = None
            else:
                ahead, ra = None, None
        if job.status == "queued":
            ra = self.retry_after(ahead)
            return (
                202,
                {"JobID": job.id, "Status": "queued",
                 "QueuePosition": ahead, "RetryAfterSeconds": ra},
                {"Retry-After": str(ra)},
            )
        if job.status == "running":
            return 202, {"JobID": job.id, "Status": "running"}, {}
        doc: dict = {"JobID": job.id, "Status": job.status}
        if job.queue_wait is not None:
            doc["QueueWaitSeconds"] = round(job.queue_wait, 3)
        if job.status == "done":
            doc["Result"] = job.result
        elif job.error:
            doc["Error"] = job.error
        return 200, doc, {}

    def _position_locked(self, job: _Job) -> int:
        """How many queued jobs sit ahead of this one (its own tenant's
        FIFO order; cross-tenant order depends on the DRR rotation, so the
        tenant-local position is the honest lower bound)."""
        q = self._queues.get(job.tenant) or ()
        for i, j in enumerate(q):
            if j is job:
                return i + 1
        return 1

    # -- queue internals (all called under self._cond) ----------------------

    def _sync_queue_gauges(self, tenant: str) -> None:
        q = self._queues.get(tenant) or ()
        self.queue_depth_g.set(len(q), tenant=tenant)
        self.queued_bytes_g.set(
            self._tenant_queued_bytes.get(tenant, 0), tenant=tenant
        )

    def _remove_locked(self, job: _Job) -> None:
        """Drop a job from its queue + byte accounting (dequeue, expiry,
        drain rejection)."""
        q = self._queues.get(job.tenant)
        if q is not None:
            try:
                q.remove(job)
            except ValueError:
                pass
            if not q:
                # classic DRR: an emptied queue forfeits its deficit so an
                # idle tenant cannot hoard credit for a later burst
                self._deficit[job.tenant] = 0.0
        self._queued_bytes = max(0, self._queued_bytes - job.nbytes)
        self._tenant_queued_bytes[job.tenant] = max(
            0, self._tenant_queued_bytes.get(job.tenant, 0) - job.nbytes
        )
        self._sync_queue_gauges(job.tenant)

    def _finish_locked(self, job: _Job, status: str,
                       error: str | None = None) -> None:
        job.status = status
        job.error = error
        job.finished = time.monotonic()
        # only the worker ever reads the request document; a terminal job
        # serves id/status/result, so keeping req (a blob-id list that can
        # run to thousands of digests) in the retention table would pin
        # memory the result_keep bound was supposed to cap
        job.req = None
        job.traceparent = None
        self.jobs_c.inc(status=status)
        self._jobs.pop(job.id, None)
        self._finished[job.id] = job
        self._finished.move_to_end(job.id)
        while len(self._finished) > self.cfg.result_keep:
            self._finished.popitem(last=False)

    def _expire_locked(self, job: _Job) -> None:
        self._remove_locked(job)
        self._finish_locked(
            job, "expired",
            f"deadline expired after "
            f"{time.monotonic() - job.submitted:.1f}s in queue",
        )
        logger.warning("job %s (tenant %s) expired in queue", job.id[:8],
                       job.tenant)

    def _pop_next_locked(self) -> _Job | None:
        """Weighted deficit-round-robin dequeue over bytes.

        Each visit to a tenant credits ``quantum x weight`` bytes of
        deficit (quantum = the largest head-of-queue cost, so every
        tenant can afford at least one job per round); a tenant serves
        jobs while its deficit covers them, then the rotation moves on.
        Byte-costed service is what makes a registry sweep and an
        interactive scan commensurable: the sweep burns its credit in one
        job while the interactive tenant gets a job through every round.

        Tenants at their in-flight limit are skipped (their queue keeps
        its deficit); expired jobs are retired on the way.
        """
        now = time.monotonic()
        for t in list(self._order):
            q = self._queues.get(t)
            while q and q[0].deadline is not None and now > q[0].deadline:
                self._expire_locked(q[0])
        active = []
        for t in self._order:
            if not self._queues.get(t):
                continue
            tenant = self.cfg.tenants.get(t) or self._default_tenant
            if (self._tenant_inflight.get(t, 0)
                    >= self._tenant_inflight_limit(tenant)):
                continue
            active.append((t, tenant))
        if not active:
            return None
        # quantum scaled by the smallest active weight: one credit of
        # quantum x weight must afford every tenant's head job (otherwise
        # a sub-1-weight tenant needs many passes to accumulate credit
        # and an idle-budget queue drains at the worker wake cadence);
        # relative service stays proportional to the weights
        quantum = max(
            max(1, self._queues[t][0].nbytes) for t, _ in active
        ) / min(tenant.weight for _, tenant in active)
        # two passes bound the loop: the first credits every visited
        # tenant enough for >= 1 head job, so the second always pops
        for _ in range(2 * len(active)):
            t, tenant = active[self._rr % len(active)]
            q = self._queues[t]
            cost = max(1, q[0].nbytes)
            if self._deficit.get(t, 0.0) < cost:
                self._deficit[t] = (
                    self._deficit.get(t, 0.0) + quantum * tenant.weight
                )
                self._rr += 1  # credit granted; rotation moves on
                continue
            self._deficit[t] -= cost
            job = q.popleft()
            self._remove_locked(job)
            return job
        return None

    # -- workers ------------------------------------------------------------

    def start(self) -> "AdmissionController":
        for i in range(self.cfg.max_concurrent):
            th = threading.Thread(
                target=self._worker, daemon=True,
                name=f"admission-worker-{i}",
            )
            th.start()
            self._workers.append(th)
        logger.info(
            "admission control on: %d concurrent, queue depth %d, "
            "queued-bytes budget %d MB, %d tenant(s)",
            self.cfg.max_concurrent, self.cfg.queue_depth,
            self.cfg.queued_bytes >> 20, len(self.cfg.tenants),
        )
        return self

    def _worker(self) -> None:
        while True:
            with self._cond:
                job = None
                while not self._stop:
                    if self._running < self.cfg.max_concurrent:
                        job = self._pop_next_locked()
                        if job is not None:
                            break
                    # the periodic wake re-checks queued-job deadlines
                    # even when no enqueue/completion notifies
                    self._cond.wait(0.1)
                if job is None:
                    return
                self._running += 1
                self._running_jobs += 1
                self._tenant_inflight[job.tenant] = (
                    self._tenant_inflight.get(job.tenant, 0) + 1
                )
                self.inflight_g.set(
                    self._tenant_inflight[job.tenant], tenant=job.tenant
                )
                job.status = "running"
                job.started = time.monotonic()
                job.queue_wait = job.started - job.submitted
            self.queue_wait_h.observe(job.queue_wait)
            tenant = (self.cfg.tenants.get(job.tenant)
                      or self._default_tenant)
            try:
                faults.check("admission.dequeue", key=job.tenant)
                from trivy_tpu_torch import obs

                # the job id IS the scan's trace id; drop a client
                # traceparent whose trace id lost the mint-time collision
                # check (the scan must not join a trace the progress and
                # result APIs aren't keyed by). Fleet SHARD jobs are the
                # exception: N concurrent shards share one coordinator
                # trace (a single merged timeline) while each keeps its
                # own job id — the server registers the job id as the
                # shard's progress key, so the poll keying holds
                tp = job.traceparent
                joined = obs.parse_traceparent(tp)
                if joined and joined[0] != job.id \
                        and not job.req.get("Shard"):
                    tp = None
                # async jobs hold the DBReloader in-flight guard exactly
                # like the sync _dispatch path: an advisory-DB hot swap
                # must never land mid-scan (one request reading two DBs)
                reloader = getattr(self.server, "reloader", None)
                if reloader is not None:
                    reloader.request_begin()
                try:
                    resp = self.server.scan(
                        job.req, traceparent=tp, trace_id=job.id,
                        queue_wait_s=job.queue_wait, tenant=job.tenant,
                    )
                finally:
                    if reloader is not None:
                        reloader.request_end()
                with self._cond:
                    job.result = resp
                    self._finish_locked(job, "done")
            except Exception as e:
                logger.warning("job %s (tenant %s) failed: %s",
                               job.id[:8], job.tenant, e)
                with self._cond:
                    self._finish_locked(job, "failed", str(e))
            finally:
                self.release(tenant, job=True)

    # -- lifecycle / introspection ------------------------------------------

    def reject_queued(self, reason: str = "server draining") -> int:
        """Loudly fail every queued-but-unstarted job (the drain path):
        each flips to ``rejected`` so pollers get a terminal answer
        instead of a stranded 202. Returns the count."""
        rejected = 0
        with self._cond:
            for q in list(self._queues.values()):
                for job in list(q):
                    self._remove_locked(job)
                    self._finish_locked(job, "rejected", reason)
                    rejected += 1
            self._cond.notify_all()
        if rejected:
            logger.warning(
                "drain: rejected %d queued job(s) (%s) — pollers see "
                "status 'rejected', clients should resubmit elsewhere",
                rejected, reason,
            )
        return rejected

    def shutdown(self, timeout: float = 5.0) -> None:
        self.reject_queued()
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        for th in self._workers:
            th.join(timeout=timeout)
        self._workers = []

    def queue_depth(self) -> int:
        with self._cond:
            return sum(len(q) for q in self._queues.values())

    def running(self) -> int:
        with self._cond:
            return self._running

    def running_jobs(self) -> int:
        """Async jobs currently executing on worker threads. Sync scans
        are excluded — they are already visible as in-flight HTTP
        requests, and the drain path sums the two."""
        with self._cond:
            return self._running_jobs

    def doc(self) -> dict:
        """Operator-facing snapshot (rides /healthz when enabled)."""
        with self._cond:
            return {
                "MaxConcurrent": self.cfg.max_concurrent,
                "Running": self._running,
                "QueueDepth": sum(len(q) for q in self._queues.values()),
                "QueuedBytes": self._queued_bytes,
                "QueueDepthLimit": self.cfg.queue_depth,
                "QueuedBytesLimit": self.cfg.queued_bytes,
                "Tenants": {
                    t: {
                        "Queued": len(self._queues.get(t, ())),
                        "QueuedBytes": self._tenant_queued_bytes.get(t, 0),
                        "InFlight": self._tenant_inflight.get(t, 0),
                    }
                    for t in sorted(
                        set(self._order) | set(self._tenant_inflight)
                    )
                },
            }
