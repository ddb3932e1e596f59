"""The port's fleet package: the replica half of ``trivy_tpu/fleet/``.

- :mod:`trivy_tpu_torch.fleet.plan` holds the directory-atomic unit
  planner (``group_units``), which the incremental fs artifact
  (``trivy_tpu_torch/incremental/fs.py``) shares; the shard planner (fs
  trees by byte-balanced walk partitions, images by missing layer) and the
  shard's wire form, each equal to the JAX planner's; and
  :func:`~trivy_tpu_torch.fleet.plan.execute_shard`, which a port server
  runs for a request carrying a ``Shard`` block, on its own device.

The coordinator side (fan-out, steal, speculation, breakers, the merge,
the telemetry plane and the ``--fleet`` flag group) is not ported yet: a
JAX coordinator (``trivy_tpu/fleet/``) fans a scan out over port replicas,
and the port's fleet flags exit 2 as every JAX flag the port lacks does.
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
