"""Convert a real trivy-db (bbolt) into the flattened shard layout.

The reference consumes trivy-db directly through bbolt cursors
(ref: pkg/db/db.go, bucket layout shown in the reference's bolt fixtures —
pkg/detector/library/testdata/fixtures/pip.yaml, integration/testdata/
fixtures/db/*.yaml). This build flattens the same data once into per-bucket
JSON shards that load lazily — the host-side layout the batched device
version-compare path wants (advisory boundary versions encode once per
bucket load, constant-time bucket access thereafter).

Output layout (consumed by :class:`trivy_tpu_torch.db.VulnDB`)::

    <out>/metadata.json              (copied when present next to the .db)
    <out>/manifest.json              {"buckets": {"<bucket>": "advisories/<n>.json"}}
    <out>/advisories/<n>.json        {"<bucket>": {"<pkg>": [advisory, ...]}}
    <out>/data-sources.json          {"<bucket>": {"ID":..,"Name":..,"URL":..}}
    <out>/vulnerability/<xx>.json    details sharded by id-hash byte

Advisory rows are normalized at conversion time: trivy-db stores Severity
and Status as integer enums (see integration/testdata/fixtures/db/
debian.yaml: ``Severity: 1.0``, ``Status: 7``); the shard layout stores the
string forms the scan pipeline uses.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil

from trivy_tpu_torch import log
from trivy_tpu_torch.db.bolt import BoltDB

logger = log.logger("db:convert")

SEVERITY_NAMES = ["UNKNOWN", "LOW", "MEDIUM", "HIGH", "CRITICAL"]
# trivy-db types.Status enum order
STATUS_NAMES = [
    "unknown",
    "not_affected",
    "affected",
    "fixed",
    "under_investigation",
    "will_not_fix",
    "fix_deferred",
    "end_of_life",
]

DETAIL_SHARDS = 256


def _severity_name(v) -> str:
    if isinstance(v, str):
        return v
    try:
        return SEVERITY_NAMES[int(v)]
    except (ValueError, TypeError, IndexError):
        return "UNKNOWN"


def _status_name(v) -> str:
    if isinstance(v, str):
        return v
    try:
        return STATUS_NAMES[int(v)]
    except (ValueError, TypeError, IndexError):
        return ""


def normalize_advisory(vuln_id: str, raw: dict) -> dict:
    """trivy-db advisory JSON -> shard advisory row (string enums, the
    vulnerability ID denormalized out of the bolt key)."""
    out: dict = {"VulnerabilityID": vuln_id}
    for k in ("FixedVersion", "VulnerableVersions", "PatchedVersions", "Arches"):
        if raw.get(k):
            out[k] = raw[k]
    if "Severity" in raw and raw["Severity"] not in (None, 0, "0"):
        out["Severity"] = _severity_name(raw["Severity"])
    if raw.get("Status"):
        out["Status"] = _status_name(raw["Status"])
    if raw.get("DataSource"):
        out["DataSource"] = raw["DataSource"]
    return out


def detail_shard(vuln_id: str) -> str:
    return hashlib.sha256(vuln_id.encode()).hexdigest()[:2]


def convert_bolt(bolt_path: str, out_dir: str) -> dict:
    """Flatten one trivy-db bbolt file; returns conversion stats."""
    db = BoltDB(bolt_path)
    # idempotent: stale shards from a previous conversion must not merge
    # into (or outlive) this one — entries removed upstream stay removed
    for sub in ("advisories", "vulnerability"):
        path = os.path.join(out_dir, sub)
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.makedirs(path, exist_ok=True)

    manifest: dict[str, str] = {}
    n_advisories = 0
    n_details = 0
    details: dict[str, dict[str, dict]] = {}
    pending_details = 0
    shard_i = 0

    def flush_details() -> None:
        """Merge buffered detail rows into their shard files; bounds RSS on
        a ~1M-row real DB instead of holding every decoded detail at once."""
        nonlocal pending_details
        for shard, rows in details.items():
            path = os.path.join(out_dir, "vulnerability", f"{shard}.json")
            if os.path.exists(path):
                with open(path) as f:
                    old = json.load(f)
                old.update(rows)
                rows = old
            with open(path, "w") as f:
                json.dump(rows, f)
        details.clear()
        pending_details = 0

    for name_b in db.buckets():
        name = name_b.decode("utf-8", "replace")
        if name == "vulnerability":
            for key, value, _sub in db.walk_bucket(name_b):
                vid = key.decode("utf-8", "replace")
                try:
                    details.setdefault(detail_shard(vid), {})[vid] = json.loads(value)
                    n_details += 1
                    pending_details += 1
                    if pending_details >= 100_000:
                        flush_details()
                except (json.JSONDecodeError, TypeError):
                    logger.warning("undecodable vulnerability detail %s", vid)
            continue
        if name == "data-source":
            sources = {}
            for key, value, _sub in db.walk_bucket(name_b):
                try:
                    sources[key.decode("utf-8", "replace")] = json.loads(value)
                except (json.JSONDecodeError, TypeError):
                    pass
            with open(os.path.join(out_dir, "data-sources.json"), "w") as f:
                json.dump(sources, f)
            continue
        # advisory bucket: "<family> <release>" or "<eco>::<source>"
        pkgs: dict[str, list[dict]] = {}
        for pkg_key, _value, sub in db.walk_bucket(name_b):
            pkg = pkg_key.decode("utf-8", "replace")
            rows = []
            for vid_b, raw in sorted(sub.items()):
                try:
                    rows.append(
                        normalize_advisory(
                            vid_b.decode("utf-8", "replace"), json.loads(raw)
                        )
                    )
                except (json.JSONDecodeError, TypeError):
                    logger.warning("undecodable advisory %s/%s", name, vid_b)
            if rows:
                pkgs.setdefault(pkg, []).extend(rows)
                n_advisories += len(rows)
        rel = f"advisories/{shard_i:04d}.json"
        shard_i += 1
        with open(os.path.join(out_dir, rel), "w") as f:
            json.dump({name: pkgs}, f)
        manifest[name] = rel

    flush_details()

    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump({"buckets": manifest, "detail_shards": True}, f)

    # the OCI artifact carries metadata.json next to trivy.db; keep it
    src_meta = os.path.join(os.path.dirname(bolt_path), "metadata.json")
    if os.path.exists(src_meta):
        shutil.copy(src_meta, os.path.join(out_dir, "metadata.json"))

    stats = {
        "buckets": len(manifest),
        "advisories": n_advisories,
        "details": n_details,
    }
    logger.info(
        "converted %s: %d buckets, %d advisories, %d details",
        bolt_path, stats["buckets"], n_advisories, n_details,
    )
    return stats
