"""RPC client: remote cache + remote scan driver
(ref: pkg/rpc/client/client.go, pkg/cache/remote.go, pkg/rpc/retry.go), the
port of ``trivy_tpu/rpc/client.py``.

The client analyzes locally, ships blobs to the server's cache, and asks the
server to run detection. Requests retry with exponential backoff on
connectivity errors and 5xx — the reference retries only on
twirp.Unavailable (ref: retry.go:17-41); connection refused / 502 / 503 /
504 map to the same class here. The backoff is full-jitter (a fleet of
clients retrying a recovering server must not synchronize into a thundering
herd), honors ``Retry-After`` on 503 and 429 (the server sends it while
draining or shedding over-budget/over-quota scans), and the whole retry
loop is capped by a wall-clock deadline — 10 retries × 5 s of zero-jitter
sleep used to stall a caller ~50 s. Read-only polls (progress, job
results) skip the ladder entirely and fail fast on :data:`POLL_TIMEOUT`.
"""

from __future__ import annotations

import http.client
import json
import random
import threading
import time
import urllib.parse

from trivy_tpu_torch import faults, log, obs, rpc
from trivy_tpu_torch.scanner import ScanOptions
from trivy_tpu_torch.types import OS, Result

logger = log.logger("rpc:client")

# cadence of the client-side progress join: while a remote Scanner.Scan is
# in flight and telemetry is on, the driver polls the server's progress API
# this often and folds the snapshot into the local scan's ScanProgress
PROGRESS_POLL_SECS = 1.0

MAX_RETRIES = 10  # ref: retry.go retry count
MAX_BACKOFF = 5.0  # per-sleep cap (jittered: actual sleep ~U(0, backoff))
RETRY_DEADLINE = 60.0  # total retry wall-clock cap per request
# 429 joins the retryable set: an admission-controlled server sheds
# over-quota tenants with 429 + Retry-After, and the same backoff that
# rides out a draining 503 turns that into a later successful attempt
_RETRYABLE_HTTP = {429, 502, 503, 504}
_RETRY_AFTER_HTTP = {429, 503}

# read-only polls (progress, job results) get a short timeout and NO
# retry ladder: a wedged server must fail a poll fast — the next tick (or
# the caller's own poll loop) retries anyway, and a poll inheriting the
# full 60 s RETRY_DEADLINE used to stall the --live line for a minute
POLL_TIMEOUT = 5.0


class RPCError(Exception):
    pass


class ConnectionPool:
    """Per-(scheme, host, port) pooled keep-alive HTTP connections.

    Every request used to open a fresh TCP connection
    (``urllib.request.urlopen``); the fleet coordinator's fan-out and
    result-poll loops made that per-request setup a measurable cost, so
    requests now ride bounded per-host keep-alive
    :class:`http.client.HTTPConnection` pools instead. Safety rules:

    - a connection is used by exactly one thread at a time (popped from
      the pool, returned only after the response body is fully read);
    - any socket-level failure invalidates the connection (closed and
      dropped, never re-pooled) — with one transparent retry on a FRESH
      connection when a *reused* connection fails before yielding a
      response (the server legitimately closed an idle keep-alive socket
      between requests; timeouts are excluded, they must surface);
    - a response carrying ``Connection: close`` is honored (read fully,
      then closed, not re-pooled) — shed replies with small bodies keep
      the connection alive because the server drains them, which is
      regression-tested client-side.
    """

    MAX_IDLE_PER_HOST = 4

    def __init__(self):
        self._lock = threading.Lock()
        self._idle: dict[tuple, list] = {}
        self.created = 0
        self.reused = 0
        self.invalidated = 0

    # -- stats / lifecycle ---------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "idle": sum(len(v) for v in self._idle.values()),
                "hosts": len([k for k, v in self._idle.items() if v]),
                "created": self.created,
                "reused": self.reused,
                "invalidated": self.invalidated,
            }

    def clear(self) -> None:
        with self._lock:
            conns = [c for v in self._idle.values() for c in v]
            self._idle.clear()
        for c in conns:
            try:
                c.close()
            except Exception:
                pass

    # -- acquire / release ---------------------------------------------------

    def _acquire(self, key: tuple, timeout: float, fresh: bool = False):
        conn = None
        if not fresh:
            with self._lock:
                lst = self._idle.get(key)
                conn = lst.pop() if lst else None
                if conn is not None:
                    self.reused += 1
        if conn is not None:
            conn.timeout = timeout
            if conn.sock is not None:
                conn.sock.settimeout(timeout)
            return conn, True
        scheme, host, port = key
        cls = (
            http.client.HTTPSConnection
            if scheme == "https"
            else http.client.HTTPConnection
        )
        conn = cls(host, port, timeout=timeout)
        with self._lock:
            self.created += 1
        return conn, False

    def _release(self, key: tuple, conn) -> None:
        with self._lock:
            lst = self._idle.setdefault(key, [])
            if conn.sock is not None and len(lst) < self.MAX_IDLE_PER_HOST:
                lst.append(conn)
                return
        conn.close()

    def _discard(self, conn) -> None:
        with self._lock:
            self.invalidated += 1
        try:
            conn.close()
        except Exception:
            pass

    # -- one request ---------------------------------------------------------

    @staticmethod
    def _proxied(scheme: str, host: str) -> bool:
        """Does the environment route this host through an HTTP proxy?
        Pooled direct connections would silently bypass a mandatory
        egress proxy that the old ``urlopen`` path honored."""
        import urllib.request as _ur

        if scheme not in _ur.getproxies():
            return False
        try:
            return not _ur.proxy_bypass(host)
        except Exception:
            return True

    @staticmethod
    def _urllib_request(url: str, method: str, body: bytes | None,
                        headers: dict, timeout: float):
        """Legacy urllib path for proxied requests (keeps
        HTTP(S)_PROXY/no_proxy semantics; no pooling through proxies).
        Same ``(status, headers, data)`` contract as the pooled path —
        error statuses are returned, not raised."""
        import urllib.error as _ue
        import urllib.request as _ur

        req = _ur.Request(url, data=body, headers=headers, method=method)
        try:
            with _ur.urlopen(req, timeout=timeout) as resp:
                return resp.status, resp.headers, resp.read()
        except _ue.HTTPError as e:
            return e.code, e.headers, e.read() or b""

    def request(self, url: str, method: str, body: bytes | None,
                headers: dict, timeout: float):
        """One HTTP exchange over a pooled connection. Returns
        ``(status, headers message, body bytes)``; raises ``OSError`` /
        ``http.client.HTTPException`` on connectivity failures (the
        caller's retry ladder classifies them)."""
        parts = urllib.parse.urlsplit(url)
        port = parts.port or (443 if parts.scheme == "https" else 80)
        key = (parts.scheme, parts.hostname or "", port)
        if self._proxied(parts.scheme, parts.hostname or ""):
            return self._urllib_request(url, method, body, headers, timeout)
        path = parts.path or "/"
        if parts.query:
            path += "?" + parts.query
        force_fresh = False
        for _ in range(2):
            conn, reused = self._acquire(key, timeout, fresh=force_fresh)
            try:
                conn.request(method, path, body=body, headers=headers)
                resp = conn.getresponse()
                data = resp.read()
            except (TimeoutError, http.client.HTTPException, OSError) as e:
                self._discard(conn)
                stale = reused and not isinstance(e, TimeoutError)
                if stale and not force_fresh:
                    # the server closed this keep-alive socket between
                    # requests; one transparent retry on a fresh
                    # connection (timeouts surface — retrying would
                    # silently double the caller's wait)
                    force_fresh = True
                    continue
                raise
            if resp.will_close:
                conn.close()
            else:
                self._release(key, conn)
            return resp.status, resp.headers, data
        raise http.client.HTTPException(f"{url}: pooled request failed")


_POOL = ConnectionPool()


def _request_headers(token: str, token_header: str,
                     gzip_body: bool) -> dict:
    headers = {
        "Content-Type": "application/json",
        "Accept-Encoding": "gzip",
        # distributed tracing: every request carries the active trace id
        # (and the caller's open span as parent) so the server joins the
        # client's trace instead of minting a fresh one, and server logs
        # correlate with client traces even when tracing is off
        "traceparent": obs.traceparent(),
    }
    if gzip_body:
        headers["Content-Encoding"] = "gzip"
    if token:
        headers[token_header] = token
    return headers


def _decode_body(headers, data: bytes) -> bytes:
    if headers.get("Content-Encoding") == "gzip":
        import gzip as _gzip

        return _gzip.decompress(data)
    return data


def _post(base: str, path: str, payload: dict, token: str, token_header: str,
          timeout: float, retries: int = MAX_RETRIES,
          deadline: float = RETRY_DEADLINE) -> dict:
    import gzip as _gzip

    url = base.rstrip("/") + path
    raw = json.dumps(payload).encode()
    # blobs compress extremely well (JSON metadata); gzip above 1 KiB
    # (ref: the server mux wraps handlers in gzip middleware)
    body = _gzip.compress(raw) if len(raw) > 1024 else raw
    backoff = 0.1
    start = time.monotonic()
    last: Exception | None = None
    for attempt in range(retries + 1):
        retry_after: float | None = None
        try:
            faults.check("rpc.post", key=path)
            status, rheaders, data = _POOL.request(
                url, "POST", body,
                _request_headers(token, token_header, body is not raw),
                timeout,
            )
            if status < 300:
                # strictly 2xx: redirects are NOT followed (a replica
                # address should point at the server, not a redirecting
                # LB) — a 3xx must surface as an RPCError below, never be
                # json-parsed as a success body
                try:
                    body_bytes = _decode_body(rheaders, data)
                except OSError as e:
                    # corrupt gzip payload (BadGzipFile is an OSError) is
                    # deterministic, not connectivity — re-POSTing through
                    # the jitter ladder would burn the whole deadline
                    raise RPCError(
                        f"{path}: bad response body: {e}"
                    ) from e
                return json.loads(body_bytes or b"{}")
            if status in _RETRYABLE_HTTP and attempt < retries:
                last = RPCError(f"{path}: HTTP {status}")
                if status in _RETRY_AFTER_HTTP:
                    # a draining/overloaded/shedding server says when to
                    # come back (admission sheds carry a drain-rate-derived
                    # Retry-After on both 503 and 429)
                    try:
                        ra = rheaders.get("Retry-After")
                        retry_after = float(ra) if ra else None
                    except (TypeError, ValueError):
                        retry_after = None
            else:
                try:
                    detail = json.loads(
                        _decode_body(rheaders, data) or b"{}"
                    ).get("error", "")
                except Exception:
                    detail = ""
                raise RPCError(f"{path}: HTTP {status} {detail}".strip())
        except (
            OSError, http.client.HTTPException,
            faults.InjectedFault,  # default-kind rpc.post injections retry too
        ) as e:
            if attempt >= retries:
                raise RPCError(f"{path}: {e}") from e
            last = e
        # full jitter: sleep ~U(0, backoff) so synchronized failures
        # desynchronize on the first retry. Retry-After is a server-directed
        # MINIMUM with jitter on top — sleeping it verbatim would
        # re-synchronize every client a draining server turned away
        if retry_after is not None:
            delay = retry_after + random.uniform(0.0, backoff)
        else:
            delay = random.uniform(0.0, backoff)
        backoff = min(backoff * 2, MAX_BACKOFF)
        remaining = deadline - (time.monotonic() - start)
        if remaining <= delay:
            raise RPCError(
                f"{path}: retry deadline ({deadline:.0f}s) exceeded: {last}"
            ) from last
        logger.debug(
            "retrying %s after %s (attempt %d, sleeping %.2fs)",
            path, last, attempt + 1, delay,
        )
        time.sleep(delay)
    raise RPCError(f"{path}: retries exhausted: {last}")


def _get_json(url: str, token: str, token_header: str, timeout: float,
              what: str) -> tuple[int, dict, dict]:
    """One read-only GET poll: (status, body, headers). No retry ladder
    and the short :data:`POLL_TIMEOUT`-style timeout — polls must fail
    fast, the caller's loop is the retry (pooled keep-alive still applies:
    a poll loop reuses one warm connection instead of a TCP handshake per
    tick)."""
    headers = {}
    if token:
        headers[token_header] = token
    try:
        status, rheaders, data = _POOL.request(
            url, "GET", None, headers, timeout
        )
    except (OSError, http.client.HTTPException) as e:
        raise RPCError(f"{what}: {e}") from e
    if status >= 300:  # polls expect 200/202; redirects are config errors
        raise RPCError(f"{what}: HTTP {status}")
    return (
        status,
        json.loads(_decode_body(rheaders, data) or b"{}"),
        dict(rheaders),
    )


def get_progress(server: str, trace_id: str, token: str = "",
                 token_header: str = rpc.DEFAULT_TOKEN_HEADER,
                 timeout: float = POLL_TIMEOUT) -> dict:
    """One poll of the server's live progress API
    (``GET /scan/<trace_id>/progress``). Raises :class:`RPCError` on an
    unknown trace id or connectivity failure — deliberately no retry loop:
    progress polling is advisory and the next tick polls again anyway."""
    base = server if "://" in server else f"http://{server}"
    url = base.rstrip("/") + rpc.scan_progress_path(trace_id)
    _, doc, _ = _get_json(
        url, token, token_header, timeout, f"progress {trace_id}"
    )
    return doc


def get_metrics_text(server: str, token: str = "",
                     token_header: str = rpc.DEFAULT_TOKEN_HEADER,
                     timeout: float = POLL_TIMEOUT) -> str:
    """One scrape of the server's ``GET /metrics`` exposition text. Unlike
    the JSON polls this returns the raw Prometheus text body (the caller
    parses it with :func:`trivy_tpu_torch.obs.metrics.parse_text`) — same
    fail-fast discipline as :func:`get_progress`: no retry ladder, the
    telemetry tick loop IS the retry."""
    base = server if "://" in server else f"http://{server}"
    url = base.rstrip("/") + "/metrics"
    headers = {}
    if token:
        headers[token_header] = token
    try:
        status, rheaders, data = _POOL.request(
            url, "GET", None, headers, timeout
        )
    except (OSError, http.client.HTTPException) as e:
        raise RPCError(f"metrics scrape {server}: {e}") from e
    if status >= 300:
        raise RPCError(f"metrics scrape {server}: HTTP {status}")
    return (_decode_body(rheaders, data) or b"").decode(
        "utf-8", errors="replace"
    )


def get_result(server: str, job_id: str, token: str = "",
               token_header: str = rpc.DEFAULT_TOKEN_HEADER,
               timeout: float = POLL_TIMEOUT) -> dict:
    """One poll of the async job API (``GET /scan/<job_id>/result``).
    Returns the job document — ``Status`` is ``queued``/``running`` (the
    202 states, with ``QueuePosition``/``RetryAfterSeconds`` while
    queued) or a terminal ``done``/``failed``/``expired``/``rejected``.
    Same fail-fast discipline as :func:`get_progress`."""
    base = server if "://" in server else f"http://{server}"
    url = base.rstrip("/") + rpc.scan_result_path(job_id)
    _, doc, _ = _get_json(
        url, token, token_header, timeout, f"result {job_id}"
    )
    return doc


def get_healthz(server: str, token: str = "",
                token_header: str = rpc.DEFAULT_TOKEN_HEADER,
                deadline: float = POLL_TIMEOUT) -> dict:
    """One ``GET /healthz`` probe. Fail-fast like every poll: a dead
    server must be refused within one probe, not after a retry ladder."""
    base = server if "://" in server else f"http://{server}"
    url = base.rstrip("/") + rpc.HEALTHZ
    _, doc, _ = _get_json(
        url, token, token_header, min(deadline, POLL_TIMEOUT),
        f"healthz {server}",
    )
    return doc


def fetch_debug_bundle(server: str, token: str = "",
                       token_header: str = rpc.DEFAULT_TOKEN_HEADER,
                       deadline: float = POLL_TIMEOUT) -> dict:
    """One ``GET /debug/bundle`` pull of a server's flight-recorder
    bundle (ring dump, compile/HBM ledgers, verdict). Fail-fast like
    every poll: a hung pull must not stall the forensics path."""
    base = server if "://" in server else f"http://{server}"
    url = base.rstrip("/") + rpc.DEBUG_BUNDLE
    _, doc, _ = _get_json(
        url, token, token_header, min(deadline, POLL_TIMEOUT),
        f"debug bundle {server}",
    )
    return doc


def post_register(server: str, host: str, token: str = "",
                  token_header: str = rpc.DEFAULT_TOKEN_HEADER, timeout: float = 30.0,
                  retries: int = MAX_RETRIES, deadline: float = RETRY_DEADLINE) -> dict:
    """Announce replica ``host`` to the coordinator at ``server`` (``POST
    /fleet/register``). Rides the normal full-jitter retry ladder: the seam
    is idempotent server-side (a duplicate register answers ``Known:
    true``), so a retry after a lost 200 is safe."""
    return _post(server if "://" in server else f"http://{server}", rpc.FLEET_REGISTER,
                 {"Host": host}, token, token_header, timeout, retries, deadline)


def post_deregister(server: str, host: str, token: str = "",
                    token_header: str = rpc.DEFAULT_TOKEN_HEADER, timeout: float = 30.0,
                    retries: int = MAX_RETRIES, deadline: float = RETRY_DEADLINE) -> dict:
    """Withdraw replica ``host`` from the coordinator at ``server`` (``POST
    /fleet/deregister``), the inverse of :func:`post_register`; idempotent
    server-side, so the retry ladder is safe here too."""
    return _post(server if "://" in server else f"http://{server}", rpc.FLEET_DEREGISTER,
                 {"Host": host}, token, token_header, timeout, retries, deadline)


class RemoteCache:
    """Cache facade backed by the server's Cache service
    (ref: pkg/cache/remote.go) — what client-side analysis writes to."""

    def __init__(self, server: str, token: str = "",
                 token_header: str = rpc.DEFAULT_TOKEN_HEADER,
                 timeout: float = 30.0, retries: int = MAX_RETRIES,
                 deadline: float = RETRY_DEADLINE):
        self.base = server if "://" in server else f"http://{server}"
        self.token = token
        self.token_header = token_header
        self.timeout = timeout
        self.retries = retries
        self.deadline = deadline

    def _call(self, path: str, payload: dict) -> dict:
        return _post(self.base, path, payload, self.token, self.token_header,
                     self.timeout, self.retries, self.deadline)

    def put_blob(self, blob_id: str, blob: dict) -> None:
        self._call(rpc.CACHE_PUT_BLOB, {"DiffID": blob_id, "BlobInfo": blob})

    def put_artifact(self, artifact_id: str, info: dict) -> None:
        self._call(
            rpc.CACHE_PUT_ARTIFACT,
            {"ArtifactID": artifact_id, "ArtifactInfo": info},
        )

    def missing_blobs(self, artifact_id: str, blob_ids: list[str]):
        resp = self._call(
            rpc.CACHE_MISSING_BLOBS,
            {"ArtifactID": artifact_id, "BlobIDs": blob_ids},
        )
        return bool(resp.get("MissingArtifact")), list(resp.get("MissingBlobIDs", []))

    def delete_blobs(self, blob_ids: list[str]) -> None:
        self._call(rpc.CACHE_DELETE_BLOBS, {"BlobIDs": blob_ids})

    # local-read methods are not part of the remote surface
    def get_blob(self, blob_id: str):
        raise RPCError("RemoteCache has no local blob reads")


class RemoteDriver:
    """Scan driver that calls the server's Scanner service
    (ref: pkg/rpc/client/client.go:69-100)."""

    def __init__(self, server: str, token: str = "",
                 token_header: str = rpc.DEFAULT_TOKEN_HEADER,
                 timeout: float = 300.0, retries: int = MAX_RETRIES,
                 deadline: float = RETRY_DEADLINE):
        self.base = server if "://" in server else f"http://{server}"
        self.token = token or ""
        self.token_header = token_header
        self.timeout = timeout
        self.retries = retries
        self.deadline = deadline

    def progress(self, trace_id: str | None = None) -> dict:
        """Live progress of the remote scan joined to ``trace_id`` (the
        active trace by default) — the client half of the progress API."""
        return get_progress(
            self.base, trace_id or obs.current().trace_id,
            token=self.token, token_header=self.token_header,
        )

    def _scan_payload(self, target, artifact_id, blob_ids, options,
                     want_trace: bool) -> dict:
        return {
            "Target": target,
            "ArtifactID": artifact_id,
            "BlobIDs": blob_ids,
            "Options": {
                "Scanners": list(options.scanners),
                "ListAllPkgs": options.list_all_pkgs,
            },
            "WantTrace": want_trace,
        }

    # -- async job API (admission-controlled servers) -----------------------

    def submit(self, target: str, artifact_id: str, blob_ids: list[str],
               options: ScanOptions,
               deadline_s: float | None = None,
               shard: dict | None = None) -> dict:
        """Submit a scan to the server's admission queue
        (``POST /scan/submit``); returns the submit document (``JobID``,
        ``QueuePosition``, ...). Sheds (429/503 + Retry-After) ride the
        normal full-jitter retry loop, so a busy-but-draining queue turns
        into a later accepted submit, not an error. ``shard`` attaches a
        fleet shard spec: the server then runs that shard's ANALYSIS and
        the job result carries its ``Blobs`` instead of scan results."""
        import os as _os

        ctx = obs.current()
        payload = self._scan_payload(
            target, artifact_id, blob_ids, options, bool(ctx.enabled)
        )
        if shard is not None:
            payload["Shard"] = shard
        if deadline_s is not None:
            payload["DeadlineSeconds"] = deadline_s
        # submit is NOT idempotent on the wire (it enqueues); the key is
        # stable across this retry loop's attempts, so a retry after a
        # lost 202 returns the already-enqueued job instead of a twin
        # that would burn a budget slot nobody polls
        payload["SubmitKey"] = _os.urandom(8).hex()
        return _post(
            self.base, rpc.SCAN_SUBMIT, payload, self.token,
            self.token_header, self.timeout, self.retries, self.deadline,
        )

    def scan_shard(self, target: str, shard: dict,
                   options: ScanOptions) -> dict:
        """Synchronous fleet-shard execution (``Scanner.Scan`` with a
        ``Shard`` block) for replicas running without admission control /
        the async job API; returns the raw shard response
        (``Blobs``/``Health``/``Trace``)."""
        ctx = obs.current()
        payload = self._scan_payload(target, "", [], options,
                                     bool(ctx.enabled))
        payload["Shard"] = shard
        with ctx.span("rpc.scan"):
            return _post(
                self.base, rpc.SCANNER_SCAN, payload, self.token,
                self.token_header, self.timeout, self.retries,
                self.deadline,
            )

    def fetch_result(self, job_id: str) -> dict:
        """One fail-fast poll of a submitted job's result document."""
        return get_result(
            self.base, job_id, token=self.token,
            token_header=self.token_header,
        )

    def wait_result(self, job_id: str, timeout: float = 300.0,
                    poll: float = 0.25) -> dict:
        """Poll a job to a terminal state and return the scan response.
        Honors the server's queued-state ``RetryAfterSeconds`` as the
        poll cadence floor; raises :class:`RPCError` on ``failed``/
        ``expired``/``rejected`` jobs or when ``timeout`` elapses first."""
        deadline = time.monotonic() + timeout
        misses = 0
        while True:
            try:
                doc = self.fetch_result(job_id)
            except RPCError:
                # one transient blip (proxy restart, a single wedged
                # 5 s poll) must not abort a job that is still running
                # server-side and burning a budget slot; but a permanent
                # failure (unknown job id, dead server) should surface
                # after a few polls, not linger to the full timeout
                misses += 1
                if misses > 3 or time.monotonic() >= deadline:
                    raise
                time.sleep(min(poll, max(0.05,
                                         deadline - time.monotonic())))
                continue
            misses = 0
            status = doc.get("Status")
            if status == "done":
                return doc.get("Result") or {}
            if status in ("failed", "expired", "rejected"):
                raise RPCError(
                    f"job {job_id}: {status}: {doc.get('Error', '')}"
                )
            if time.monotonic() >= deadline:
                raise RPCError(
                    f"job {job_id}: still {status} after {timeout:.0f}s"
                )
            delay = poll
            if status == "queued" and doc.get("RetryAfterSeconds"):
                # the server knows its drain rate better than we do, but
                # a poll is cheap — cap the server's hint at 2 s so a
                # pessimistic estimate can't make a finished job linger
                delay = min(2.0, max(poll, float(doc["RetryAfterSeconds"])))
            time.sleep(min(delay, max(0.05, deadline - time.monotonic())))

    def scan_async(self, target: str, artifact_id: str,
                   blob_ids: list[str], options: ScanOptions,
                   deadline_s: float | None = None,
                   timeout: float = 300.0):
        """Submit + poll + parse: the async-shaped equivalent of
        :meth:`scan` for large artifacts against admission-controlled
        servers."""
        sub = self.submit(target, artifact_id, blob_ids, options,
                          deadline_s=deadline_s)
        resp = self.wait_result(sub["JobID"], timeout=timeout)
        ctx = obs.current()
        if ctx.enabled and resp.get("Trace"):
            ctx.ingest_remote(resp["Trace"])
        results = [Result.from_dict(r) for r in resp.get("Results", [])]
        os_info = OS.from_dict(resp["OS"]) if resp.get("OS") else None
        return results, os_info

    def _poll_progress(self, ctx, stop: threading.Event) -> None:
        """Background join of the server's live progress while the scan
        RPC is in flight: each snapshot folds into the local ScanProgress
        (its ``remote`` field), so ``--live`` and heartbeats can show the
        server side of a remote scan as it runs."""
        with obs.activate(ctx):
            while not stop.wait(PROGRESS_POLL_SECS):
                try:
                    snap = self.progress(ctx.trace_id)
                except Exception:
                    # advisory polling: ANY failure (scan not registered
                    # yet, a proxy's HTML error body breaking json.loads,
                    # a truncated read) skips this tick, never kills the
                    # poller for the rest of a long scan
                    continue
                ctx.progress().merge_remote(snap)

    def scan(self, target: str, artifact_id: str, blob_ids: list[str],
             options: ScanOptions):
        ctx = obs.current()
        # the rpc.scan span is the parent the server's trace joins under
        # (its id rides the traceparent header _post attaches); WantTrace
        # asks the server to return its span table, which merges into this
        # context so --trace-out/report cover both sides of the wire.
        # With telemetry attached (a sampler set ctx.timeseries), a poller
        # joins the server's live progress for the duration of the RPC.
        stop = threading.Event()
        poller = None
        if ctx.timeseries is not None:
            poller = threading.Thread(
                target=self._poll_progress, args=(ctx, stop), daemon=True,
                name="rpc-progress-poll",
            )
            poller.start()
        try:
            with ctx.span("rpc.scan"):
                resp = _post(
                    self.base,
                    rpc.SCANNER_SCAN,
                    self._scan_payload(
                        target, artifact_id, blob_ids, options,
                        bool(ctx.enabled),
                    ),
                    self.token,
                    self.token_header,
                    self.timeout,
                    self.retries,
                    self.deadline,
                )
        finally:
            if poller is not None:
                stop.set()
                poller.join(timeout=5.0)
        if ctx.enabled and resp.get("Trace"):
            ctx.ingest_remote(resp["Trace"])
        results = [Result.from_dict(r) for r in resp.get("Results", [])]
        os_info = OS.from_dict(resp["OS"]) if resp.get("OS") else None
        return results, os_info
