"""The port's fleet package: scatter-gather scanning of one artifact over
scan servers (the port of ``trivy_tpu/fleet/``).

- :mod:`trivy_tpu_torch.fleet.plan` holds the directory-atomic unit
  planner (``group_units``), which the incremental fs artifact
  (``trivy_tpu_torch/incremental/fs.py``) shares; the shard planner (fs
  trees by byte-balanced walk partitions, images by missing layer) and the
  shard's wire form, each equal to the JAX planner's; and
  :func:`~trivy_tpu_torch.fleet.plan.execute_shard`, which a port server
  runs for a request carrying a ``Shard`` block, on its own device.
- :mod:`trivy_tpu_torch.fleet.coordinator` fans the shards out as async
  jobs (or sync scans) over the replicas of ``--fleet``, with per-replica
  in-flight windows, work-stealing, speculation, straggler splits, drain
  hand-back, per-replica circuit breakers and, when every replica is dead,
  a local run on the coordinator's device.
- :mod:`trivy_tpu_torch.fleet.merge` puts the shards' blobs into the
  coordinator's cache, so the ordinary detection path gives the report a
  single-host scan gives.

- :mod:`trivy_tpu_torch.fleet.telemetry` (the replica poller: headroom
  scores, the dead and draining verdicts, the ``trivy_tpu_fleet_*`` gauges
  and the exports' ``fleet`` blocks) and
  :mod:`trivy_tpu_torch.fleet.controller` (headroom to placement weights)
  are the telemetry plane, which the coordinator starts when
  ``--fleet-telemetry-interval`` is above 0 (1.0 s by default); the
  coordinator's ``register_replica`` is the live join.

Nothing here is imported unless a scan asks for a fleet or a server runs a
shard, and the telemetry plane's modules not at interval 0.
"""

from __future__ import annotations


class FleetError(RuntimeError):
    """Unrecoverable fleet failure (every replica dead and host fallback
    disabled, or a shard that cannot complete anywhere)."""


def parse_fleet(hosts) -> list[str]:
    """Normalize a ``--fleet`` value (list or comma-joined string) into a
    deduplicated, order-preserving replica address list."""
    if hosts is None:
        return []
    if isinstance(hosts, str):
        hosts = hosts.split(",")
    out: list[str] = []
    for h in hosts:
        h = str(h).strip()
        if h and h not in out:
            out.append(h)
    return out
