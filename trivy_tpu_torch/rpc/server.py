"""Scan server (ref: pkg/rpc/server/listen.go, server.go), the port of
``trivy_tpu/rpc/server.py``.

Serves the Cache and Scanner services over HTTP with optional token-header
auth, /healthz + /version probes, and a Prometheus-text ``GET /metrics``
surface (scan counts, per-stage latency histograms fed from each scan's
trace context, cache hit/miss, dedup bytes, in-flight gauge). Every
Scanner.Scan request runs in its own trace context — concurrent scans
record into disjoint span tables — and long scans emit heartbeat progress
logs. Detection runs server-side against the server's cache + advisory DB;
analysis stays client-side (ref: pkg/commands/artifact/run.go:348-355
split).

The server detects on its own device (``cuda`` unless asked for ``cpu``):
the advisory DB's resident CVE join stays on the card across requests, and
each request's constraint check runs ``verscmp.cu`` there. Concurrent
requests share the join but never one dispatch's buffers
(``detector/library.py``). A server asked for ``cuda`` without a card, or
whose kernel cannot be built, fails at boot. A DB hot swap releases the old
join's device bytes from the flight ledger once the guarded requests have
finished.

A request carrying a fleet ``Shard`` block (a JAX coordinator's, or the
port client's ``scan_shard`` and ``submit(shard=)``) runs the ANALYSIS of
that shard on this server's device (``fleet/plan.py::execute_shard``): on
the card the secret feed and the license kernels run here, and the answer
is the shard's ``Blobs`` with this server's ``Health`` delta (``Trace`` on
``WantTrace``); detection and the merge stay with the coordinator. A shard
with an unknown scanner, kind or ``Backend`` answers 400, at the async
front door too; one whose root or secret config this host cannot see fails
loudly.

With admission control enabled (:mod:`trivy_tpu_torch.rpc.admission`,
``--max-concurrent-scans > 0``) the server becomes an overload-safe
multi-tenant front end: synchronous scans are budget-gated (shed with
429/503 + Retry-After instead of competing for HBM), ``POST /scan/submit``
+ ``GET /scan/<id>/result`` form the async job API (the existing progress
route is the live-poll half), and draining rejects queued jobs loudly.
"""

from __future__ import annotations

import hmac
import json
import os
import threading
import time
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from trivy_tpu_torch import VERSION, log, obs, rpc
from trivy_tpu_torch.cache import cached_blobs
from trivy_tpu_torch.device import DEFAULT_DEVICE, resolve
from trivy_tpu_torch.fleet import plan as fleet_plan
from trivy_tpu_torch.obs import metrics as obs_metrics
from trivy_tpu_torch.obs import timeseries as obs_timeseries
from trivy_tpu_torch.scanner import ScanOptions

logger = log.logger("rpc:server")

# progress-log cadence for long-running server scans
HEARTBEAT_SECS = 30.0

# finished scans keep their final progress snapshot for late pollers; the
# table is bounded so trace ids can't accumulate forever
FINISHED_PROGRESS_KEEP = 256


def _progress_wire(snap: dict) -> dict:
    """ScanProgress.snapshot() -> the PascalCase wire form of the progress
    API (one place, so the client helper and tests can't drift)."""
    doc = {
        "FilesWalked": snap["files_walked"],
        "BytesWalked": snap["bytes_walked"],
        "FilesScanned": snap["files_scanned"],
        "BytesScanned": snap["bytes_scanned"],
        "WalkComplete": snap["walk_complete"],
        "Done": snap["done"],
        "Ratio": snap["ratio"],
        "ElapsedSeconds": snap["elapsed_s"],
        "MBs": snap["mbs"],
    }
    if snap.get("eta_s") is not None:
        doc["ETASeconds"] = snap["eta_s"]
    return doc

# request-body ceiling; blobs are analysis metadata, not file contents, so
# 256 MiB is generous headroom while bounding a hostile Content-Length.
# Overridable via TRIVY_TPU_MAX_REQUEST_BYTES, validated once at server
# construction (garbage env kills boot, not the Nth request)
MAX_REQUEST_BYTES = 256 * 1024 * 1024
ENV_MAX_REQUEST_BYTES = "TRIVY_TPU_MAX_REQUEST_BYTES"

# biggest unread POST body worth draining to keep an HTTP/1.1 connection
# alive after an early reply (shed, 401, draining); larger bodies close
# the connection instead of being read just to keep a socket warm
DRAIN_BODY_MAX = 1 * 1024 * 1024


class BadRequest(ValueError):
    """A request this server refuses with 400."""


def _resolve_max_request_bytes() -> int:
    from trivy_tpu_torch.rpc.admission import validate_count

    raw = os.environ.get(ENV_MAX_REQUEST_BYTES, "")
    if not raw:
        return MAX_REQUEST_BYTES
    v = validate_count(raw, ENV_MAX_REQUEST_BYTES)
    if v == 0:
        raise ValueError(f"{ENV_MAX_REQUEST_BYTES}: must be > 0, got {raw!r}")
    return v


class DBReloader:
    """Periodic advisory-DB hot swap with in-flight serialization
    (ref: pkg/rpc/server/listen.go:62-80 — the hourly updater waits for
    in-flight requests via paired WaitGroups; here one Condition carries
    both roles: requests wait while a swap runs, the swap waits for the
    in-flight count to drain)."""

    def __init__(self, server: "ScanServer", db_dir: str, interval: float = 3600.0):
        self.server = server
        self.db_dir = db_dir
        self.interval = interval
        self._cond = threading.Condition()
        self._inflight = 0
        self._updating = False
        self._stop = threading.Event()

    def start(self) -> None:
        threading.Thread(target=self._loop, daemon=True).start()

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.reload()
            except Exception as e:
                logger.warning("DB reload failed (keeping current DB): %s", e)

    def reload(self) -> None:
        """Load the DB fresh, then swap it in once no request is mid-scan.
        The old DB's resident join leaves the device (and the flight
        ledger) inside the swap, while no guarded request can touch it."""
        from trivy_tpu_torch.db import VulnDB
        from trivy_tpu_torch.detector.library import release_device

        new_db = VulnDB.load(self.db_dir)  # load OUTSIDE the lock
        new_db.db_dir = self.db_dir
        with self._cond:
            self._updating = True
            while self._inflight > 0:
                self._cond.wait()
            old = self.server.driver.vuln_client
            self.server.driver.vuln_client = new_db
            released = release_device(old) if old is not None else 0
            self._updating = False
            self._cond.notify_all()
        logger.info("advisory DB reloaded from %s (%d resident bytes released)",
                    self.db_dir, released)

    def request_begin(self) -> None:
        with self._cond:
            while self._updating:
                self._cond.wait()
            self._inflight += 1

    def request_end(self) -> None:
        with self._cond:
            self._inflight -= 1
            self._cond.notify_all()


class ServerMetrics:
    """The server's Prometheus registry plus its standard instruments."""

    def __init__(self):
        r = self.registry = obs_metrics.Registry()
        self.scans = r.counter(
            "trivy_tpu_scans_total", "Completed Scanner.Scan requests"
        )
        self.scan_seconds = r.histogram(
            "trivy_tpu_scan_seconds", "Scanner.Scan wall time",
            buckets=obs_metrics.SCAN_BUCKETS,
        )
        self.stage_seconds = r.histogram(
            "trivy_tpu_stage_seconds",
            "Per-pipeline-stage span latency, fed from scan trace contexts",
            labelnames=("stage",),
            buckets=obs_metrics.SCAN_BUCKETS,
        )
        self.requests = r.counter(
            "trivy_tpu_http_requests_total",
            "RPC requests by service method and status code",
            labelnames=("method", "code"),
        )
        self.request_seconds = r.histogram(
            "trivy_tpu_http_request_seconds", "RPC request wall time",
            labelnames=("method",),
        )
        self.in_flight = r.gauge(
            "trivy_tpu_requests_in_flight", "RPC requests currently executing"
        )
        self.cache_hits = r.counter(
            "trivy_tpu_cache_hits_total",
            "Blob IDs requested via MissingBlobs that were already cached",
        )
        self.cache_misses = r.counter(
            "trivy_tpu_cache_misses_total",
            "Blob IDs requested via MissingBlobs that were absent",
        )
        self.dedup_bytes = r.counter(
            "trivy_tpu_secret_dedup_bytes_total",
            "Corpus bytes resolved from the secret chunk-dedup hit cache",
        )
        # per-rule cost attribution, bounded to the TOP_K hottest rules of
        # each scan (label cardinality stays bounded; the full profile is
        # in the scan's Trace response / --profile-out)
        self.rule_gate_hits = r.counter(
            "trivy_tpu_rule_gate_hits_total",
            "Device prefilter hits by secret rule (top-K per scan)",
            labelnames=("rule",),
        )
        self.rule_confirm_seconds = r.counter(
            "trivy_tpu_rule_confirm_seconds_total",
            "Exact host confirmation wall time by rule (top-K per scan)",
            labelnames=("rule",),
        )
        self.rule_wasted_confirm_seconds = r.counter(
            "trivy_tpu_rule_wasted_confirm_seconds_total",
            "Confirmation time on device hits the host rejected "
            "(gate false positives), by rule (top-K per scan)",
            labelnames=("rule",),
        )

    def observe_scan(self, ctx, seconds: float) -> None:
        """Fold one finished scan's trace context into the registry.
        snapshot() is reservoir-bounded: per-stage histogram counts are
        exact up to obs.RESERVOIR spans per stage per scan and a uniform
        sample beyond."""
        from trivy_tpu_torch.obs import profile as obs_profile

        self.scans.inc()
        self.scan_seconds.observe(seconds)
        for stage, durs in ctx.snapshot().items():
            for d in durs:
                self.stage_seconds.observe(d, stage=stage)
        self.dedup_bytes.inc(ctx.counters.get("secret.bytes_dedup_hit", 0))
        for rid, f in obs_profile.top_rules(ctx.profile_doc()):
            self.rule_gate_hits.inc(f.get("gate_hits", 0), rule=rid)
            self.rule_confirm_seconds.inc(
                f.get("confirm_ms", 0.0) / 1e3, rule=rid
            )
            self.rule_wasted_confirm_seconds.inc(
                f.get("wasted_confirm_ms", 0.0) / 1e3, rule=rid
            )


class ScanServer:
    """Service implementation bound to a cache and a local driver, which
    detects on ``device``. On ``cuda`` the constraint kernel is built and
    loaded here: a card that is missing, or a kernel that cannot be built,
    fails the server at construction, never a request."""

    def __init__(self, cache, vuln_client=None, admission=None, device=DEFAULT_DEVICE):
        from trivy_tpu_torch.rpc.admission import AdmissionController, resolve_admission
        from trivy_tpu_torch.scanner.local_driver import LocalDriver

        self.device = resolve(device)
        if self.device.type == "cuda":
            from trivy_tpu_torch.ops import _build

            _build.preload("verscmp")
        self.cache = cache
        self.driver = LocalDriver(vuln_client, self.device)
        # validate the telemetry cadence AND the request/admission limits
        # once at construction: garbage TRIVY_TPU_TELEMETRY_INTERVAL /
        # _MAX_REQUEST_BYTES / admission env must kill the server at boot
        # with a clear error, not every scan request with a 500
        self.telemetry_interval = obs_timeseries.default_interval()
        self.max_request_bytes = _resolve_max_request_bytes()
        self.reloader: DBReloader | None = None
        self.metrics = ServerMetrics()
        # admission control (rpc/admission.py): an explicit
        # AdmissionConfig wins, else env resolution; disabled configs
        # allocate NOTHING — no worker threads, no per-tenant state, no
        # admission metrics — so an unadmitted server is byte-identical
        # to one predating the controller
        cfg = admission if admission is not None else resolve_admission()
        self.admission = (
            AdmissionController(self, cfg).start() if cfg.enabled else None
        )
        self.started = time.time()
        # graceful-shutdown state: while draining, /healthz reports
        # "draining" (load balancers stop routing) and new RPC requests
        # get 503 + Retry-After; in-flight scans run to completion
        self.draining = False
        # elastic fleet live-join seam: a coordinator embedded in this
        # process installs its register_replica here; None keeps
        # POST /fleet/register a plain 404 with ZERO register state (no CLI
        # path installs one, as in the JAX server). An optional dedicated
        # token gates the seam independently of the scan token
        self.fleet_register_hook = None
        self.fleet_register_token = ""
        # the explicit inverse seam: a coordinator installs its
        # deregister_replica here; same 404-when-absent contract
        self.fleet_deregister_hook = None
        # live progress registry for GET /scan/<trace_id>/progress:
        # in-flight scans map trace id -> their ScanProgress; finished
        # scans keep a bounded table of final snapshots for late pollers
        self._progress_lock = threading.Lock()
        self._progress_active: dict[str, object] = {}
        self._progress_finished: OrderedDict[str, dict] = OrderedDict()

    # -- live progress registry ---------------------------------------------

    def _progress_register(self, trace_id: str, progress) -> None:
        with self._progress_lock:
            self._progress_active[trace_id] = progress

    def _progress_retire(self, trace_id: str) -> None:
        with self._progress_lock:
            prog = self._progress_active.pop(trace_id, None)
            if prog is None:
                return
            self._progress_finished[trace_id] = prog.snapshot()
            self._progress_finished.move_to_end(trace_id)
            while len(self._progress_finished) > FINISHED_PROGRESS_KEEP:
                self._progress_finished.popitem(last=False)

    def progress_snapshot(self, trace_id: str) -> dict | None:
        with self._progress_lock:
            prog = self._progress_active.get(trace_id)
            if prog is not None:
                return prog.snapshot()
            return self._progress_finished.get(trace_id)

    # -- service methods (JSON dict in/out) ---------------------------------

    def scan(self, req: dict, traceparent: str | None = None,
             trace_id: str | None = None, queue_wait_s: float | None = None,
             tenant: str | None = None) -> dict:
        options = ScanOptions(
            scanners=req.get("Options", {}).get("Scanners", ["vuln"]),
            list_all_pkgs=bool(req.get("Options", {}).get("ListAllPkgs")),
        )
        target = req.get("Target", "")
        # fleet shard execution: a request carrying a Shard block runs the
        # ANALYSIS of that shard on this replica (its own device and feed)
        # and returns the resulting blobs; detection and the merge through
        # the applier stay on the coordinator. It rides the same trace-join,
        # progress-registry, sampler and admission plumbing as a detection
        # scan (the async job API works unchanged)
        shard = req.get("Shard")
        if shard is not None:
            try:
                fleet_plan.check_shard(shard)
            except fleet_plan.ShardRefused as e:
                raise BadRequest(str(e)) from None
        # per-request trace context: concurrent scans record into disjoint
        # tables (each handler thread carries its own contextvar value), and
        # the aggregates feed the shared /metrics registry afterwards. When
        # the client sent a traceparent header, this request JOINS that
        # trace — same trace id, root spans parented under the client's
        # rpc.scan span — instead of minting a fresh context. Async jobs
        # pass an explicit trace_id (their job id) so the progress/result
        # APIs share one key even when the submitter sent no traceparent
        joined = obs.parse_traceparent(traceparent)
        with obs.scan_context(
            name=f"server-scan:{target}",
            enabled=True,
            trace_id=joined[0] if joined else trace_id,
            parent_span_id=joined[1] if joined else None,
        ) as ctx:
            if queue_wait_s is not None:
                # the admission queue wait becomes a first-class span: it
                # rides --trace-out, folds into the stall verdict as the
                # `queue-bound` bucket, and ships back in the Trace block
                ctx.add("admission.queue_wait", queue_wait_s)
                ctx.count("admission.queued_ms", int(queue_wait_s * 1e3))
            if tenant is not None:
                ctx.count(f"admission.tenant.{tenant}")
            # live telemetry: one sampler per server-side scan (cadence via
            # TRIVY_TPU_TELEMETRY_INTERVAL, 0 disables) feeding the counter
            # tracks shipped back in the Trace block and the process gauges
            # on GET /metrics; the progress registry serves
            # GET /scan/<trace_id>/progress while this request runs, with
            # the request's blobs as a detection scan's work-list and the
            # shard's files as a shard's. A fleet shard job joins the
            # COORDINATOR's trace id (so N shards merge into one timeline)
            # but registers progress under its JOB id only: N concurrent
            # shards share one trace id, and registering it would let the
            # first to finish retire (and freeze) a sibling's live entry. A
            # job id equal to the trace id (the first job of a trace takes
            # it) is still its own job's key; a sync shard has no job id
            progress = ctx.progress()
            if shard is not None:
                progress_keys = [trace_id] if trace_id else []
            else:
                progress_keys = [ctx.trace_id]
            for key in progress_keys:
                self._progress_register(key, progress)
            blob_ids = list(req.get("BlobIDs", []))
            sampler = obs_timeseries.start_sampler(
                ctx, self.telemetry_interval
            )
            try:
                with obs.heartbeat(
                    logger, f"scan of {target or '<unnamed>'}", HEARTBEAT_SECS
                ):
                    t0 = time.perf_counter()
                    if shard is not None:
                        with ctx.span("server.shard"):
                            blobs = fleet_plan.execute_shard(
                                shard, self.cache, self.device,
                                list_all_pkgs=options.list_all_pkgs)
                    else:
                        progress.note_walked(0, files=len(blob_ids))
                        with ctx.span("server.scan"):
                            cached = cached_blobs(
                                self.cache, blob_ids,
                                on_read=lambda: progress.note_scanned(0))
                            results, os_info = self.driver.scan(target, cached, options)
                        progress.finish_walk()
                    dt = time.perf_counter() - t0
                progress.finish()
            finally:
                # scan death stops the sampler exactly like completion —
                # the finished table then serves the last honest snapshot
                if sampler is not None:
                    sampler.stop()
                for key in progress_keys:
                    self._progress_retire(key)
            self.metrics.observe_scan(ctx, dt)
        if shard is not None:
            # shard responses carry blobs plus this replica's health delta
            # (skipped files, degradations) so the coordinator's merged
            # report sums SkippedFiles/Degraded exactly like a local scan
            resp = {"Blobs": blobs, "Health": ctx.health_snapshot()}
        else:
            resp = {
                "OS": os_info.to_dict() if os_info else None,
                "Results": [r.to_dict() for r in results],
            }
        if req.get("WantTrace"):
            from trivy_tpu_torch.obs import export as obs_export

            # ship the span table back so the client's --trace-out emits
            # one merged timeline and its report folds in the server stalls
            resp["Trace"] = obs_export.context_doc(ctx)
        return resp

    def put_blob(self, req: dict) -> dict:
        self.cache.put_blob(req["DiffID"], req["BlobInfo"])
        return {}

    def put_artifact(self, req: dict) -> dict:
        self.cache.put_artifact(req["ArtifactID"], req["ArtifactInfo"])
        return {}

    def missing_blobs(self, req: dict) -> dict:
        blob_ids = list(req.get("BlobIDs", []))
        missing_artifact, missing = self.cache.missing_blobs(
            req.get("ArtifactID", ""), blob_ids
        )
        self.metrics.cache_hits.inc(len(blob_ids) - len(missing))
        self.metrics.cache_misses.inc(len(missing))
        return {"MissingArtifact": missing_artifact, "MissingBlobIDs": missing}

    def delete_blobs(self, req: dict) -> dict:
        delete = getattr(self.cache, "delete_blobs", None)
        if delete is not None:
            delete(list(req.get("BlobIDs", [])))
        return {}


_ROUTES = {
    rpc.SCANNER_SCAN: "scan",
    rpc.CACHE_PUT_BLOB: "put_blob",
    rpc.CACHE_PUT_ARTIFACT: "put_artifact",
    rpc.CACHE_MISSING_BLOBS: "missing_blobs",
    rpc.CACHE_DELETE_BLOBS: "delete_blobs",
}


def _make_handler(server: ScanServer, token: str, token_header: str):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route through our logger
            logger.debug("%s " + fmt, self.address_string(), *args)

        def _reply(self, code: int, payload: dict, headers: dict | None = None) -> None:
            import gzip as _gzip

            self._status = code
            self._drain_unread_body()
            body = json.dumps(payload).encode()
            accepts_gzip = "gzip" in self.headers.get("Accept-Encoding", "")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            if self.close_connection:
                self.send_header("Connection", "close")
            for name, value in (headers or {}).items():
                self.send_header(name, value)
            if accepts_gzip and len(body) > 1024:
                body = _gzip.compress(body)
                self.send_header("Content-Encoding", "gzip")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _drain_unread_body(self) -> None:
            """An early reply (shed, 401, draining, bad route) fires
            before ``_read_body``, leaving the POSTed body unread on the
            HTTP/1.1 keep-alive socket — where the next request parse
            would misread it as a request line and corrupt the
            connection. Sheds are the designed steady-state overload
            answer, so drain small bodies and keep the connection alive
            (the Retry-After retry reuses it); anything over
            :data:`DRAIN_BODY_MAX` closes instead."""
            if self.command != "POST" or getattr(
                self, "_body_consumed", False
            ):
                return
            try:
                length = int(self.headers.get("Content-Length", "0") or 0)
            except ValueError:
                length = -1
            if length == 0:
                return
            if 0 < length <= DRAIN_BODY_MAX:
                try:
                    self.rfile.read(length)
                    self._body_consumed = True
                    return
                except OSError:
                    pass
            self.close_connection = True

        def _token_ok(self) -> bool:
            """Constant-time token check shared by every authenticated
            route — one implementation, so the RPC POSTs and the per-scan
            GETs cannot drift apart. On a token-protected server, tenant
            tokens (admission control's token->tenant map) authenticate
            alongside the server token; every candidate is compared so
            timing reveals neither which token matched nor how much of
            the tenant table was walked. A server WITHOUT ``--token``
            stays open even with tenants configured — tenants alone buy
            fair scheduling (unmatched requests share the ``default``
            tenant), not authentication."""
            if not token:
                return True
            presented = self.headers.get(token_header, "")
            ok = hmac.compare_digest(
                presented.encode("latin-1", "replace"),
                token.encode("latin-1", "replace"),
            )
            if server.admission is not None:
                # the tenant walk runs unconditionally (no early exit on
                # a server-token hit) and is the SAME constant-time
                # matcher tenant_for uses, so auth and tenant resolution
                # cannot drift
                if server.admission.match_token(presented) is not None:
                    ok = True
            return ok

        def _reply_text(self, code: int, body: bytes, content_type: str) -> None:
            self._status = code
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == rpc.HEALTHZ:
                # liveness plus the numbers an operator checks first:
                # version, uptime, and the in-flight request count; while
                # draining, Status flips so load balancers stop routing.
                # Admission-controlled servers add their queue snapshot;
                # unadmitted servers keep the exact historical shape
                doc = {
                    "Status": "draining" if server.draining else "ok",
                    "Version": VERSION,
                    "UptimeSeconds": round(time.time() - server.started, 1),
                    "InFlight": int(server.metrics.in_flight.value()),
                }
                if server.admission is not None:
                    doc["Admission"] = server.admission.doc()
                # flight-recorder forensics: the last error / degraded /
                # breaker-trip events (with timestamps) from the ring, so
                # one /healthz poll answers "what happened last" without
                # pulling a full bundle
                from trivy_tpu_torch.obs import recorder as _flight

                doc.update(_flight.healthz_doc())
                self._reply(200, doc)
                return
            if self.path == rpc.VERSION:
                self._reply(200, {"Version": VERSION})
                return
            if self.path == rpc.METRICS:
                # monitoring must outlive admission: this route (like
                # /healthz) deliberately skips the draining check and keeps
                # answering 200 through a drain — the fleet telemetry
                # poller keeps scoring a draining replica from live gauges
                # instead of misreading a refused scrape as replica death.
                # Drain state itself is a gauge so scrapers see it flip.
                server.metrics.registry.gauge(
                    "trivy_tpu_server_draining",
                    "1 while this server drains (sheds new work, keeps "
                    "answering monitoring probes)",
                ).set(1.0 if server.draining else 0.0)
                # server-scoped registry plus the process-global one, which
                # carries the failure-domain gauges (device breaker state,
                # cache degradation, degraded-scan count) — metric names
                # are disjoint between the two
                body = (
                    server.metrics.registry.render()
                    + obs_metrics.REGISTRY.render()
                )
                self._reply_text(200, body.encode(), obs_metrics.CONTENT_TYPE)
                return
            if self.path.startswith(rpc.SCAN_PROGRESS_PREFIX) and (
                self.path.endswith(rpc.SCAN_PROGRESS_SUFFIX)
            ):
                # unlike the aggregate /healthz and /metrics probes, this
                # route exposes per-scan activity keyed by trace id, so a
                # token-protected server requires the token here too (the
                # client helper already sends it). The token check comes
                # BEFORE the trace-id lookup and fails with a uniform 403
                # either way: an unauthenticated probe must not be able to
                # oracle which trace ids exist from a 403/404 split
                if not self._token_ok():
                    self._reply(403, {"error": "invalid token"})
                    return
                trace_id = self.path[
                    len(rpc.SCAN_PROGRESS_PREFIX): -len(rpc.SCAN_PROGRESS_SUFFIX)
                ]
                snap = server.progress_snapshot(trace_id)
                if snap is None:
                    self._reply(404, {"error": f"unknown trace id {trace_id}"})
                    return
                self._reply(200, {"TraceID": trace_id, **_progress_wire(snap)})
                return
            if self.path.startswith(rpc.SCAN_PROGRESS_PREFIX) and (
                self.path.endswith(rpc.SCAN_RESULT_SUFFIX)
            ):
                # async job result poll — same 403-before-lookup order as
                # the progress route (job ids are trace ids)
                if not self._token_ok():
                    self._reply(403, {"error": "invalid token"})
                    return
                if server.admission is None:
                    self._reply(404, {
                        "error": "async job API requires admission control "
                                 "(--max-concurrent-scans > 0)"
                    })
                    return
                job_id = self.path[
                    len(rpc.SCAN_PROGRESS_PREFIX): -len(rpc.SCAN_RESULT_SUFFIX)
                ]
                try:
                    code, payload, headers = server.admission.result(job_id)
                except Exception as e:
                    logger.warning("job result fetch %s failed: %s",
                                   job_id, e)
                    self._reply(500, {"error": str(e)})
                    return
                self._reply(code, payload, headers=headers or None)
                return
            if self.path == rpc.DEBUG_BUNDLE:
                # forensics pull of this process's ring and ledgers.
                # Token-gated like the per-scan routes (the ring names scan
                # targets). The port's recorder is always on, so the JAX
                # server's 404 for a disabled recorder never answers here
                if not self._token_ok():
                    self._reply(403, {"error": "invalid token"})
                    return
                from trivy_tpu_torch.obs import recorder as _flight

                try:
                    self._reply(200, _flight.build_bundle(reason="on-demand"))
                except Exception as e:
                    self._reply(500, {"error": str(e)})
                return
            self._reply(404, {"error": "not found"})

        def do_POST(self):
            # per-REQUEST flag on a per-CONNECTION handler instance:
            # keep-alive reuses the handler, so a stale True from the
            # previous request would skip the drain and desync the socket
            self._body_consumed = False
            if self.path == rpc.SCAN_SUBMIT:
                self._handle_submit()
                return
            if self.path == rpc.FLEET_REGISTER:
                self._handle_fleet_register()
                return
            if self.path == rpc.FLEET_DEREGISTER:
                self._handle_fleet_deregister()
                return
            method = _ROUTES.get(self.path)
            if method is None:
                self._reply(404, {"error": f"no such route: {self.path}"})
                return
            if server.draining:
                # the client's retry loop honors Retry-After on 503, so a
                # rolling restart redirects traffic without failed scans
                self._reply(
                    503, {"error": "server is draining"},
                    headers={"Retry-After": "1"},
                )
                return
            if not self._token_ok():
                self._reply(401, {"error": "invalid token"})
                return
            adm = server.admission
            tenant = None
            reply_headers = None
            m = server.metrics
            # in-flight covers the BODY READ too: a slow upload must keep
            # drain_and_shutdown waiting (the pre-admission clean-drain
            # guarantee), even though the admission slot is only acquired
            # after the body is fully read — N trickling uploads may pin
            # their connections, never the concurrency budget
            m.in_flight.inc()
            t0 = time.perf_counter()
            try:
                raw, body_err = self._read_body()
                # admission gate for synchronous scans: over-budget
                # requests shed with 429/503 + Retry-After instead of
                # competing for arena slabs and HBM (the client's
                # full-jitter backoff turns the Retry-After into a later
                # successful attempt)
                shed = None
                if adm is not None and method == "scan" \
                        and body_err is None:
                    from trivy_tpu_torch.rpc.admission import SHED_STATUS

                    t_obj = adm.tenant_for(
                        self.headers.get(token_header, "")
                    )
                    reason = adm.try_acquire(t_obj)
                    if reason is not None:
                        ra = adm.retry_after()
                        shed = (SHED_STATUS[reason], {
                            "error": f"admission: {reason}",
                            "Tenant": t_obj.name,
                            "RetryAfterSeconds": ra,
                        })
                        reply_headers = {"Retry-After": str(ra)}
                    else:
                        tenant = t_obj
                if shed is not None:
                    # sheds ride the same request counter/histogram as
                    # admitted traffic — an operator computing error
                    # rates from requests_total must see the 429/503s
                    code, payload = shed
                else:
                    code, payload = self._dispatch(
                        method, tenant=tenant, raw=raw, err=body_err
                    )
            finally:
                # EVERY piece of request accounting (in-flight gauge,
                # request counter, latency histogram) finalizes BEFORE the
                # reply hits the wire: a client that reads its response
                # and immediately scrapes /metrics must see this request
                # completed — not a stale in-flight 1 or a missing count
                # from bookkeeping racing the socket write
                m.in_flight.dec()
                if tenant is not None:
                    adm.release(tenant)
            m.requests.inc(method=method, code=str(code))
            m.request_seconds.observe(
                time.perf_counter() - t0, method=method
            )
            self._reply(code, payload, headers=reply_headers)

        def _handle_fleet_register(self) -> None:
            """POST /fleet/register — the elastic fleet's live-join seam.
            404 unless a coordinator installed its hook (a plain replica
            server keeps zero register state); gated by the same
            ``_token_ok`` path as every authenticated route — or by the
            dedicated register token when one is set — answering 403 on a
            mismatch (the seam is an operator surface; a wrong token here
            is a misconfigured joiner, not an unauthenticated scan)."""
            self._handle_fleet_hook(
                server.fleet_register_hook, "fleet register",
                "fleet_register",
            )

        def _handle_fleet_deregister(self) -> None:
            """POST /fleet/deregister — the explicit inverse of register.
            Same 404/403/400 contract; the hook (the coordinator's
            ``deregister_replica``) reuses the drain hand-back path and is
            idempotent, so a leaver's retry ladder re-POSTing is safe.
            Deliberately NOT refused while draining: a coordinator server
            winding down must still let replicas leave cleanly."""
            self._handle_fleet_hook(
                server.fleet_deregister_hook, "fleet deregister",
                "fleet_deregister", allow_draining=True,
            )

        def _handle_fleet_hook(self, hook, label: str, method: str,
                               allow_draining: bool = False) -> None:
            if hook is None:
                self._reply(
                    404, {"error": "no fleet coordinator on this server"}
                )
                return
            if server.draining and not allow_draining:
                self._reply(
                    503, {"error": "server is draining"},
                    headers={"Retry-After": "1"},
                )
                return
            reg_token = server.fleet_register_token
            if reg_token:
                presented = self.headers.get(token_header, "")
                ok = hmac.compare_digest(
                    presented.encode("latin-1", "replace"),
                    reg_token.encode("latin-1", "replace"),
                )
            else:
                ok = self._token_ok()
            if not ok:
                self._reply(403, {"error": "invalid token"})
                return
            raw, err = self._read_body()
            if err is not None:
                self._reply(*err)
                return
            try:
                req = json.loads(raw or b"{}")
            except ValueError as e:
                self._reply(400, {"error": f"bad request: {e}"})
                return
            host = req.get("Host") if isinstance(req, dict) else None
            if not host or not isinstance(host, str):
                self._reply(400, {"error": "bad request: Host required"})
                return
            try:
                doc = hook(host)
            except Exception as e:
                # a refused join/leave (dead joiner, injected fault)
                # answers loudly and leaves the running fan-out untouched
                logger.warning("%s of %s refused: %s", label, host, e)
                self._reply(502, {"error": str(e)})
                return
            server.metrics.requests.inc(method=method, code="200")
            self._reply(200, doc)

        def _handle_submit(self) -> None:
            """POST /scan/submit — the async half of the job API."""
            if server.draining:
                self._reply(
                    503, {"error": "server is draining"},
                    headers={"Retry-After": "1"},
                )
                return
            if not self._token_ok():
                self._reply(401, {"error": "invalid token"})
                return
            if server.admission is None:
                self._reply(404, {
                    "error": "async job API requires admission control "
                             "(--max-concurrent-scans > 0)"
                })
                return
            raw, err = self._read_body()
            if err is not None:
                self._reply(*err)
                return
            try:
                req = json.loads(raw or b"{}")
            except ValueError as e:
                self._reply(400, {"error": f"bad request: {e}"})
                return
            if not isinstance(req, dict):
                # valid JSON but not an object ([1,2], "x", null) would
                # TypeError below and drop the connection instead of
                # answering — the _read_body contract is an HTTP error
                self._reply(400, {
                    "error": "bad request: body must be a JSON object"
                })
                return
            if req.get("Shard") is not None:
                # a shard this port cannot run is refused at the front
                # door, never queued as a job that would fail later
                try:
                    fleet_plan.check_shard(req["Shard"])
                except fleet_plan.ShardRefused as e:
                    self._reply(400, {"error": str(e)})
                    return
            deadline_s = req.pop("DeadlineSeconds", None)
            if deadline_s is not None:
                try:
                    deadline_s = float(deadline_s)
                    if deadline_s <= 0:
                        raise ValueError
                except (TypeError, ValueError):
                    self._reply(400, {
                        "error": "DeadlineSeconds must be a number > 0"
                    })
                    return
            submit_key = req.pop("SubmitKey", None)
            tenant = server.admission.tenant_for(
                self.headers.get(token_header, "")
            )
            code, payload, headers = server.admission.submit(
                req, tenant, len(raw),
                traceparent=self.headers.get("traceparent"),
                deadline_s=deadline_s,
                submit_key=str(submit_key) if submit_key else None,
            )
            server.metrics.requests.inc(method="submit", code=str(code))
            self._reply(code, payload, headers=headers or None)

        def _read_body(self):
            """Bounded request-body read; returns (raw, None) or
            (None, (status, payload)) on malformed/oversized input —
            never raises, so every POST route (the sync dispatch AND the
            submit route) answers garbage with an HTTP error instead of
            a dropped connection."""
            limit = server.max_request_bytes
            try:
                length = int(self.headers.get("Content-Length", "0") or 0)
            except ValueError:
                return None, (400, {"error": "bad Content-Length"})
            if length < 0 or length > limit:
                return None, (413, {"error": "request too large"})
            try:
                raw = self.rfile.read(length)
            except OSError as e:
                # client reset mid-body; the stream position is now
                # undefined, so the connection can't be reused either
                self.close_connection = True
                self._body_consumed = True
                return None, (400, {"error": f"body read failed: {e}"})
            self._body_consumed = True
            if self.headers.get("Content-Encoding") == "gzip":
                import gzip as _gzip
                import io as _io

                try:
                    # stream-decompress with a cap: checking size after a
                    # full decompress would let a gzip bomb OOM the server
                    with _gzip.GzipFile(fileobj=_io.BytesIO(raw)) as gz:
                        raw = gz.read(limit + 1)
                except (OSError, EOFError) as e:  # BadGzipFile is OSError
                    return None, (400, {"error": f"bad gzip body: {e}"})
                if len(raw) > limit:
                    return None, (413, {"error": "request too large"})
            return raw, None

        def _dispatch(self, method, tenant=None, raw=None,
                      err=None) -> tuple[int, dict]:
            """Run one RPC method; returns (status, payload) and never
            raises — the reply and the request metrics are the caller's.
            The body is read by ``do_POST`` (before the admission gate)
            and passed in as ``raw``/``err``."""
            try:
                if err is not None:
                    return err
                req = json.loads(raw or b"{}")
                reloader = server.reloader
                if reloader is not None:
                    reloader.request_begin()
                try:
                    if method == "scan":
                        resp = server.scan(
                            req, traceparent=self.headers.get("traceparent"),
                            tenant=tenant.name if tenant else None,
                        )
                    else:
                        resp = getattr(server, method)(req)
                finally:
                    if reloader is not None:
                        reloader.request_end()
                return 200, resp
            except KeyError as e:
                return 400, {"error": f"bad request: {e}"}
            except BadRequest as e:
                return 400, {"error": str(e)}
            except Exception as e:
                logger.warning("rpc %s failed: %s", self.path, e)
                return 500, {"error": str(e)}

    return Handler


def start_server(
    host: str = "127.0.0.1",
    port: int = 0,
    cache=None,
    cache_dir: str | None = None,
    vuln_client=None,
    token: str = "",
    token_header: str = rpc.DEFAULT_TOKEN_HEADER,
    db_reload_dir: str | None = None,
    db_reload_interval: float = 3600.0,
    admission=None,
    device=DEFAULT_DEVICE,
):
    """Start the server on a background thread; returns (httpd, actual_port).
    port=0 picks a free port — the reference's own client/server tests use
    exactly this in-process technique (ref: integration/client_server_test.go).
    Detection runs on ``device`` (``cuda`` unless ``cpu`` is asked for).
    With ``db_reload_dir``, an hourly worker hot-swaps the advisory DB
    (ref: listen.go:62-80). ``admission`` takes a resolved
    :class:`~trivy_tpu_torch.rpc.admission.AdmissionConfig`; None resolves
    from the environment (admission stays off unless configured)."""
    if cache is None:
        from trivy_tpu_torch.cache import new_cache

        cache = new_cache("fs", cache_dir)
    service = ScanServer(cache, vuln_client=vuln_client, admission=admission, device=device)
    if db_reload_dir:
        service.reloader = DBReloader(service, db_reload_dir, db_reload_interval)
        service.reloader.start()
    httpd = ThreadingHTTPServer(
        (host, port), _make_handler(service, token, token_header)
    )
    httpd.service = service  # the drain path and tests need the handle
    _orig_shutdown = httpd.shutdown

    def _shutdown_all():
        # the admission workers and the reload worker stop with the
        # listener even on a bare httpd.shutdown() (tests, abrupt
        # teardown); both stops are idempotent
        if service.admission is not None:
            service.admission.shutdown()
        if service.reloader is not None:
            service.reloader.stop()
        _orig_shutdown()

    httpd.shutdown = _shutdown_all
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, httpd.server_address[1]


# in-flight scans get this long to finish after SIGTERM before the
# listener closes under them
DRAIN_TIMEOUT = 30.0


def drain_and_shutdown(httpd, timeout: float = DRAIN_TIMEOUT,
                       poll: float = 0.05) -> int:
    """Graceful drain: flip /healthz to "draining" and 503 new RPCs (so
    load balancers and retrying clients move on), LOUDLY reject
    queued-but-unstarted admission jobs (their pollers get a terminal
    ``rejected`` status instead of a stranded 202), wait up to ``timeout``
    for in-flight requests and running jobs, then stop the listener.
    Returns the number of requests/jobs still in flight when the listener
    closed (0 = clean drain)."""
    service = httpd.service
    service.draining = True
    logger.info("draining: refusing new requests, waiting for in-flight")
    admission = service.admission
    if admission is not None:
        admission.reject_queued()

    def _in_flight() -> int:
        # in-flight HTTP requests (sync scans included) + async jobs on
        # worker threads; admission.running() would double-count sync
        # scans, which hold an HTTP request AND a budget slot
        n = int(service.metrics.in_flight.value())
        if admission is not None:
            n += admission.running_jobs()
        return n

    deadline = time.monotonic() + timeout
    while _in_flight() > 0 and time.monotonic() < deadline:
        time.sleep(poll)
    remaining = _in_flight()
    if remaining:
        logger.warning(
            "drain timeout after %.0fs: %d request(s)/job(s) still in "
            "flight", timeout, remaining,
        )
    else:
        logger.info("drained; shutting down")
    httpd.shutdown()  # stops the admission and reload workers too
    return remaining


def serve(host: str, port: int, cache_dir: str | None = None,
          token: str = "", token_header: str = rpc.DEFAULT_TOKEN_HEADER,
          db_repository: str | None = None,
          drain_timeout: float = DRAIN_TIMEOUT,
          admission=None, device=DEFAULT_DEVICE) -> None:
    """Blocking server entrypoint for ``python -m trivy_tpu_torch server``.
    SIGTERM (the orchestrator's stop signal) triggers a graceful drain:
    /healthz flips to "draining", queued admission jobs are rejected loudly,
    in-flight scans finish (bounded by ``drain_timeout``), then the listener
    closes. Detection runs on ``device``."""
    import signal

    from trivy_tpu_torch.db import load_default_db

    vuln_client = load_default_db(db_repository, cache_dir)
    if vuln_client is None:
        logger.warning("advisory DB not available; server scans skip vulns")
    httpd, actual = start_server(
        host, port, cache_dir=cache_dir, vuln_client=vuln_client,
        token=token, token_header=token_header,
        db_reload_dir=getattr(vuln_client, "db_dir", "") or None,
        admission=admission, device=device,
    )
    stop = threading.Event()

    def on_sigterm(signum, frame):
        logger.info("SIGTERM received; starting graceful drain")
        stop.set()

    signal.signal(signal.SIGTERM, on_sigterm)
    logger.info("listening on %s:%d", host, actual)
    try:
        stop.wait()
    except KeyboardInterrupt:
        pass
    drain_and_shutdown(httpd, timeout=drain_timeout)
