"""Client/server RPC surface (ref: rpc/scanner/service.proto,
rpc/cache/service.proto, pkg/rpc/server, pkg/rpc/client), the port of
``trivy_tpu/rpc/``.

The reference speaks Twirp (protobuf over HTTP POST). The port keeps the
JAX package's routes and JSON bodies, so a port client talks to a JAX
server and a JAX client to a port server: the client analyzes and pushes
blobs through the Cache service, the server runs detection through
Scanner.Scan (:mod:`trivy_tpu_torch.rpc.server`), against its advisory DB
on its own device.
"""

SCANNER_SCAN = "/twirp/trivy.scanner.v1.Scanner/Scan"
CACHE_PUT_ARTIFACT = "/twirp/trivy.cache.v1.Cache/PutArtifact"
CACHE_PUT_BLOB = "/twirp/trivy.cache.v1.Cache/PutBlob"
CACHE_MISSING_BLOBS = "/twirp/trivy.cache.v1.Cache/MissingBlobs"
CACHE_DELETE_BLOBS = "/twirp/trivy.cache.v1.Cache/DeleteBlobs"
HEALTHZ = "/healthz"
VERSION = "/version"
METRICS = "/metrics"

# live scan-progress API: GET /scan/<trace_id>/progress returns the
# monotonically non-decreasing progress snapshot of an in-flight (or
# recently finished) scan joined to that trace id
SCAN_PROGRESS_PREFIX = "/scan/"
SCAN_PROGRESS_SUFFIX = "/progress"


def scan_progress_path(trace_id: str) -> str:
    return f"{SCAN_PROGRESS_PREFIX}{trace_id}{SCAN_PROGRESS_SUFFIX}"


# async job API (admission-controlled servers): POST /scan/submit enqueues
# a Scanner.Scan request and returns a job id (the scan's trace id) plus
# its queue position; GET /scan/<job_id>/result polls it (202 while
# queued/running, 200 with the scan response once done, bounded
# retention); GET /scan/<job_id>/progress is the live-progress half
SCAN_SUBMIT = "/scan/submit"
SCAN_RESULT_SUFFIX = "/result"


def scan_result_path(job_id: str) -> str:
    return f"{SCAN_PROGRESS_PREFIX}{job_id}{SCAN_RESULT_SUFFIX}"


# elastic fleet live-join seam: POST /fleet/register with {"Host": addr}
# asks the coordinator embedded in this server to adopt a replica
# mid-sweep; 404 unless a coordinator installed its hook
# (``FleetCoordinator.register_replica``), 403 on a bad token, idempotent
# on duplicates
FLEET_REGISTER = "/fleet/register"

# the explicit inverse: POST /fleet/deregister with {"Host": addr} asks
# the coordinator to drain that replica out of rotation (queued shards
# hand back to survivors, in-flight attempts finish). Same 404/403/
# idempotency contract as register
FLEET_DEREGISTER = "/fleet/deregister"

# flight-recorder forensics pull: GET /debug/bundle returns this
# process's on-demand diagnostic bundle (ring dump, compile/HBM ledgers,
# verdict) as JSON; token-gated like the per-scan routes
DEBUG_BUNDLE = "/debug/bundle"

# ref: pkg/flag/server_flags.go default token header
DEFAULT_TOKEN_HEADER = "Trivy-Token"
