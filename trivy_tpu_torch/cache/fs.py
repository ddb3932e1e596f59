"""File-backed cache (ref: pkg/cache/fs.go — bolt buckets 'artifact'/'blob').

Layout: ``<cache_dir>/fanal/{artifact,blob}/<sha256-hex>.json``. JSON files
give the same durability/content-addressing as the reference's bbolt DB
without a native dependency; keys are already collision-free digests.
"""

from __future__ import annotations

import json
import os
import tempfile


def default_cache_dir() -> str:
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache"
    )
    return os.path.join(base, "trivy-tpu")


class FSCache:
    def __init__(self, cache_dir: str | None = None):
        self.dir = cache_dir or default_cache_dir()
        self._adir = os.path.join(self.dir, "fanal", "artifact")
        self._bdir = os.path.join(self.dir, "fanal", "blob")
        os.makedirs(self._adir, exist_ok=True)
        os.makedirs(self._bdir, exist_ok=True)

    @staticmethod
    def _fname(key: str) -> str:
        return key.replace("sha256:", "") + ".json"

    def _write(self, dirpath: str, key: str, obj: dict) -> None:
        path = os.path.join(dirpath, self._fname(key))
        fd, tmp = tempfile.mkstemp(dir=dirpath, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(obj, f, separators=(",", ":"))
            os.replace(tmp, path)  # atomic publish
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def _read(self, dirpath: str, key: str) -> dict | None:
        path = os.path.join(dirpath, self._fname(key))
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None

    # -- ArtifactCache ------------------------------------------------------

    def put_artifact(self, artifact_id: str, info: dict) -> None:
        self._write(self._adir, artifact_id, info)

    def put_blob(self, blob_id: str, info: dict) -> None:
        self._write(self._bdir, blob_id, info)

    def missing_blobs(self, artifact_id: str, blob_ids: list[str]) -> tuple[bool, list[str]]:
        missing_artifact = self.get_artifact(artifact_id) is None
        missing = [b for b in blob_ids if self.get_blob(b) is None]
        return missing_artifact, missing

    def delete_blobs(self, blob_ids: list[str]) -> None:
        for b in blob_ids:
            try:
                os.unlink(os.path.join(self._bdir, self._fname(b)))
            except OSError:
                pass

    # -- batched blob access (no transport to batch over; plain loops) ------

    def get_blobs(self, blob_ids: list[str]) -> dict[str, dict]:
        out = {}
        for b in blob_ids:
            v = self.get_blob(b)
            if v is not None:
                out[b] = v
        return out

    def set_blobs(self, pairs: dict[str, dict]) -> None:
        for b, info in pairs.items():
            self.put_blob(b, info)

    def warm_blobs(self, prefix: str, limit: int = 1024) -> dict[str, dict]:
        """Enumerate blob entries under a key prefix (dedup-store warming).
        Only exact for non-``sha256:``-prefixed namespaces — ``_fname``
        strips that scheme, and the dedup namespaces never carry it."""
        fname_prefix = self._fname(prefix)[: -len(".json")] if prefix else ""
        out: dict[str, dict] = {}
        try:
            names = sorted(os.listdir(self._bdir))
        except OSError:
            return out
        for name in names:
            if not name.endswith(".json") or not name.startswith(fname_prefix):
                continue
            key = name[: -len(".json")]
            v = self.get_blob(key)
            if v is not None:
                out[key] = v
                if len(out) >= limit:
                    break
        return out

    # -- LocalArtifactCache -------------------------------------------------

    def get_artifact(self, artifact_id: str) -> dict | None:
        return self._read(self._adir, artifact_id)

    def get_blob(self, blob_id: str) -> dict | None:
        return self._read(self._bdir, blob_id)

    def close(self) -> None:
        pass

    def clear(self) -> None:
        import shutil

        shutil.rmtree(os.path.join(self.dir, "fanal"), ignore_errors=True)
        os.makedirs(self._adir, exist_ok=True)
        os.makedirs(self._bdir, exist_ok=True)
