"""Vulnerability database (ref: pkg/db + aquasecurity/trivy-db).

The reference distributes a bbolt DB as an OCI artifact with buckets
``"<family> <release>"`` (OS advisories) / ``"<eco>::<source>"`` (library
advisories) plus a ``vulnerability`` detail bucket. This build flattens the
same logical schema into immutable JSON shards loaded into hash indexes —
the host-side layout that feeds the batched device version-compare path
(advisory boundary versions encode once per load, packages join by name
host-side, comparisons run vectorized on device).

Directory layout::

    <db_dir>/metadata.json        {"Version": 2, "UpdatedAt": ..., "NextUpdate": ...}
    <db_dir>/advisories.json      {"<bucket>": {"<pkg>": [advisory, ...]}}
    <db_dir>/vulnerability.json   {"<vuln-id>": {detail}}

Both single files and ``advisories/<n>.json`` shard directories load.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any

from trivy_tpu_torch import log

logger = log.logger("db")

SCHEMA_VERSION = 2


@dataclass
class Advisory:
    """One advisory row (trivy-db schema: OS rows carry FixedVersion,
    library rows carry VulnerableVersions/PatchedVersions ranges)."""

    vulnerability_id: str
    fixed_version: str = ""
    vulnerable_versions: list[str] = field(default_factory=list)
    patched_versions: list[str] = field(default_factory=list)
    arches: list[str] = field(default_factory=list)
    status: str = ""
    severity: str = ""  # per-distro severity override
    data_source: dict[str, str] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Advisory":
        return cls(
            vulnerability_id=d.get("VulnerabilityID", ""),
            fixed_version=d.get("FixedVersion", ""),
            vulnerable_versions=list(d.get("VulnerableVersions", []) or []),
            patched_versions=list(d.get("PatchedVersions", []) or []),
            arches=list(d.get("Arches", []) or []),
            status=d.get("Status", ""),
            severity=d.get("Severity", ""),
            data_source=dict(d.get("DataSource", {}) or {}),
        )


class VulnDB:
    """Loaded advisory + detail indexes.

    Two storage modes share one API: eager (``buckets``/``details`` dicts,
    used by fixtures and tests) and lazy (a ``manifest.json`` maps bucket
    names to per-bucket shard files written by
    :func:`trivy_tpu_torch.db.convert.convert_bolt`; details load per hash
    shard). Lazy mode keeps full-trivy-db startup constant-time — the
    bbolt-cursor equivalent of the reference (pkg/db/db.go).
    """

    def __init__(
        self,
        buckets: dict[str, dict[str, list[Advisory]]],
        details: dict[str, dict],
        metadata: dict | None = None,
    ):
        self.buckets = buckets
        self.details = details
        self.metadata = metadata or {}
        self.db_dir = ""  # source directory, when loaded from disk
        self.data_sources: dict[str, dict] = {}
        self._prefix_index: dict[str, list[str]] = {}
        self._merged_prefix: dict[str, dict[str, list[Advisory]]] = {}
        # lazy mode state
        self._manifest: dict[str, str] = {}
        self._lazy_loaded: set[str] = set()
        self._detail_shards = False
        self._detail_loaded: set[str] = set()

    # -- advisory lookup ----------------------------------------------------

    def _ensure_bucket(self, bucket: str) -> None:
        if bucket in self._lazy_loaded or bucket not in self._manifest:
            return
        path = os.path.join(self.db_dir, self._manifest[bucket])
        with open(path) as f:
            raw = json.load(f)
        source = self.data_sources.get(bucket)
        for bname, pkgs in raw.items():
            dst = self.buckets.setdefault(bname, {})
            for pkg, rows in pkgs.items():
                advs = [Advisory.from_dict(r) for r in rows]
                if source:
                    for a in advs:
                        if not a.data_source:
                            a.data_source = source
                dst.setdefault(pkg, []).extend(advs)
        self._lazy_loaded.add(bucket)

    def get_advisories(self, bucket: str, pkg_name: str) -> list[Advisory]:
        """Exact bucket lookup (OS path: '<family> <release>')."""
        self._ensure_bucket(bucket)
        return self.buckets.get(bucket, {}).get(pkg_name, [])

    def buckets_with_prefix(self, prefix: str) -> list[str]:
        """Library path: every data source under '<eco>::' (ref:
        pkg/detector/library/driver.go:115-142)."""
        if prefix not in self._prefix_index:
            names = set(b for b in self.buckets if b.startswith(prefix))
            names.update(b for b in self._manifest if b.startswith(prefix))
            self._prefix_index[prefix] = sorted(names)
        return self._prefix_index[prefix]

    def prefix_advisories(self, prefix: str) -> dict[str, list[Advisory]]:
        """Merged ``pkg -> advisories`` index across every bucket under a
        prefix, built once per prefix — one dict probe per package instead
        of a probe per (package x bucket), which matters when a real DB has
        many '<eco>::<source>' buckets (the bolt-cursor-prefix equivalent,
        ref: pkg/detector/library/driver.go:115-142)."""
        if prefix not in self._merged_prefix:
            merged: dict[str, list[Advisory]] = {}
            for bucket in self.buckets_with_prefix(prefix):
                self._ensure_bucket(bucket)
                for pkg, advs in self.buckets.get(bucket, {}).items():
                    merged.setdefault(pkg, []).extend(advs)
            self._merged_prefix[prefix] = merged
        return self._merged_prefix[prefix]

    def get_detail(self, vuln_id: str) -> dict:
        if self._detail_shards:
            from trivy_tpu_torch.db.convert import detail_shard

            shard = detail_shard(vuln_id)
            if shard not in self._detail_loaded:
                self._detail_loaded.add(shard)
                path = os.path.join(self.db_dir, "vulnerability", f"{shard}.json")
                if os.path.exists(path):
                    with open(path) as f:
                        self.details.update(json.load(f))
        return self.details.get(vuln_id, {})

    # -- freshness (ref: pkg/db/db.go:98-140 NeedsUpdate/validate) ----------

    def next_update(self):
        """metadata NextUpdate as an aware datetime, or None."""
        import datetime

        raw = self.metadata.get("NextUpdate")
        if not raw:
            return None
        try:
            return datetime.datetime.fromisoformat(str(raw).replace("Z", "+00:00"))
        except ValueError:
            return None

    def is_stale(self, now=None) -> bool:
        """True when metadata says a newer DB should exist (NextUpdate in
        the past). A DB without metadata is never 'stale' — fixture DBs
        carry no freshness contract."""
        import datetime

        nu = self.next_update()
        if nu is None:
            return False
        now = now or datetime.datetime.now(datetime.timezone.utc)
        if nu.tzinfo is None:
            nu = nu.replace(tzinfo=datetime.timezone.utc)
        return nu < now

    # -- loading ------------------------------------------------------------

    @classmethod
    def load(cls, db_dir: str) -> "VulnDB":
        meta = {}
        meta_path = os.path.join(db_dir, "metadata.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            if meta.get("Version", SCHEMA_VERSION) != SCHEMA_VERSION:
                raise ValueError(
                    f"unsupported DB schema {meta.get('Version')}, want {SCHEMA_VERSION}"
                )
        buckets: dict[str, dict[str, list[Advisory]]] = {}

        def load_adv_file(path: str) -> None:
            with open(path) as f:
                raw = json.load(f)
            for bucket, pkgs in raw.items():
                dst = buckets.setdefault(bucket, {})
                for pkg, rows in pkgs.items():
                    dst.setdefault(pkg, []).extend(
                        Advisory.from_dict(r) for r in rows
                    )

        db = cls(buckets, {}, meta)
        db.db_dir = db_dir

        # data sources attach to advisory rows at bucket load
        ds_path = os.path.join(db_dir, "data-sources.json")
        if os.path.exists(ds_path):
            with open(ds_path) as f:
                db.data_sources = json.load(f)

        manifest_path = os.path.join(db_dir, "manifest.json")
        shard_dir = os.path.join(db_dir, "advisories")
        single = os.path.join(db_dir, "advisories.json")
        if os.path.exists(manifest_path):
            # lazy mode: buckets load on first access
            with open(manifest_path) as f:
                mf = json.load(f)
            db._manifest = mf.get("buckets", {})
            db._detail_shards = bool(mf.get("detail_shards"))
        else:
            if os.path.exists(single):
                load_adv_file(single)
            if os.path.isdir(shard_dir):
                for name in sorted(os.listdir(shard_dir)):
                    if name.endswith(".json"):
                        load_adv_file(os.path.join(shard_dir, name))

        vpath = os.path.join(db_dir, "vulnerability.json")
        if os.path.exists(vpath):
            with open(vpath) as f:
                db.details = json.load(f)
        elif os.path.isdir(os.path.join(db_dir, "vulnerability")):
            db._detail_shards = True
        logger.debug(
            "loaded DB: %d eager + %d lazy buckets, %d details",
            len(buckets), len(db._manifest), len(db.details),
        )
        return db


def load_default_db(db_repository: str | None, cache_dir: str | None) -> VulnDB | None:
    """DB resolution: explicit --db-repository dir, else <cache>/db.

    A real ``trivy.db`` bbolt file dropped into the DB dir (the file the
    reference's OCI download produces, ref: pkg/db/db.go:27-35) is
    converted to the flattened shard layout on first use and loaded from
    the conversion thereafter.
    """
    candidates = []
    if db_repository:
        candidates.append(db_repository)
    from trivy_tpu_torch.cache.fs import default_cache_dir

    candidates.append(os.path.join(cache_dir or default_cache_dir(), "db"))
    for cand in candidates:
        bolt_path = os.path.join(cand, "trivy.db")
        flat_dir = os.path.join(cand, "flattened")
        if os.path.exists(bolt_path):
            # a corrupt/truncated trivy.db degrades to the next candidate
            # (or a no-DB scan), never a crashed scan
            try:
                if not os.path.exists(os.path.join(flat_dir, "manifest.json")) or (
                    os.path.getmtime(bolt_path)
                    > os.path.getmtime(os.path.join(flat_dir, "manifest.json"))
                ):
                    import glob
                    import shutil

                    from trivy_tpu_torch.db.convert import convert_bolt

                    logger.info("flattening %s (first use)", bolt_path)
                    # stale scratch dirs from crashed prior runs (any pid)
                    for stale in glob.glob(f"{flat_dir}.tmp*") + glob.glob(
                        f"{flat_dir}.old*"
                    ):
                        shutil.rmtree(stale, ignore_errors=True)
                    # convert into a scratch dir, then swap: a crashed or
                    # concurrent conversion can't leave a half-written
                    # flattened dir that a later load trusts
                    tmp_dir = f"{flat_dir}.tmp{os.getpid()}"
                    os.makedirs(tmp_dir, exist_ok=True)
                    try:
                        convert_bolt(bolt_path, tmp_dir)
                    except Exception:
                        shutil.rmtree(tmp_dir, ignore_errors=True)
                        raise
                    old = f"{flat_dir}.old{os.getpid()}"
                    if os.path.exists(flat_dir):
                        os.rename(flat_dir, old)
                        shutil.rmtree(old, ignore_errors=True)
                    os.rename(tmp_dir, flat_dir)
                db = VulnDB.load(flat_dir)
            except Exception as e:
                logger.warning(
                    "cannot use advisory DB %s (%s: %s); continuing without it",
                    bolt_path, type(e).__name__, e,
                )
                continue
            if db.is_stale():
                logger.warning(
                    "advisory DB at %s is stale (NextUpdate %s has passed); "
                    "results may miss recent vulnerabilities",
                    bolt_path, db.metadata.get("NextUpdate"),
                )
            db.db_dir = flat_dir
            return db
        if os.path.isdir(cand) and (
            os.path.exists(os.path.join(cand, "advisories.json"))
            or os.path.isdir(os.path.join(cand, "advisories"))
            or os.path.exists(os.path.join(cand, "manifest.json"))
        ):
            db = VulnDB.load(cand)
            if db.is_stale():
                # a stale DB still scans — but silently missing the newest
                # advisories is worse than a loud warning
                # (ref: pkg/db/db.go NeedsUpdate NextUpdate check)
                logger.warning(
                    "advisory DB at %s is stale (NextUpdate %s has passed); "
                    "results may miss recent vulnerabilities",
                    cand, db.metadata.get("NextUpdate"),
                )
            db.db_dir = cand
            return db
    return None
