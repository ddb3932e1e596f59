"""In-memory cache backend (ref: pkg/cache/memory.go)."""

from __future__ import annotations

from typing import Any


class MemoryCache:
    def __init__(self):
        self._artifacts: dict[str, dict] = {}
        self._blobs: dict[str, dict] = {}

    # -- ArtifactCache (write side) ----------------------------------------

    def put_artifact(self, artifact_id: str, info: dict) -> None:
        self._artifacts[artifact_id] = info

    def put_blob(self, blob_id: str, info: dict) -> None:
        self._blobs[blob_id] = info

    def missing_blobs(self, artifact_id: str, blob_ids: list[str]) -> tuple[bool, list[str]]:
        missing_artifact = artifact_id not in self._artifacts
        missing = [b for b in blob_ids if b not in self._blobs]
        return missing_artifact, missing

    def delete_blobs(self, blob_ids: list[str]) -> None:
        for b in blob_ids:
            self._blobs.pop(b, None)

    # -- batched blob access (one call per dedup batch) --------------------

    def get_blobs(self, blob_ids: list[str]) -> dict[str, dict]:
        return {b: self._blobs[b] for b in blob_ids if b in self._blobs}

    def set_blobs(self, pairs: dict[str, dict]) -> None:
        self._blobs.update(pairs)

    def warm_blobs(self, prefix: str, limit: int = 1024) -> dict[str, dict]:
        out: dict[str, dict] = {}
        for k, v in self._blobs.items():
            if k.startswith(prefix):
                out[k] = v
                if len(out) >= limit:
                    break
        return out

    # -- LocalArtifactCache (read side) ------------------------------------

    def get_artifact(self, artifact_id: str) -> dict | None:
        return self._artifacts.get(artifact_id)

    def get_blob(self, blob_id: str) -> dict | None:
        return self._blobs.get(blob_id)

    def close(self) -> None:
        pass

    def clear(self) -> None:
        self._artifacts.clear()
        self._blobs.clear()
