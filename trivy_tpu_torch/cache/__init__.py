"""Content-addressed cache backends of the port: file-backed and in-memory.

The persistent dedup store (``secret/hitstore.py``) keeps its row verdicts
in one of these. The batched helpers below take one call per dedup batch.
The layout and the JSON documents are the JAX package's
(``trivy_tpu/cache``), so either package reads what the other wrote.
"""

from trivy_tpu_torch.cache.fs import FSCache  # noqa: F401
from trivy_tpu_torch.cache.memory import MemoryCache  # noqa: F401

BACKENDS = ("fs", "memory")


def get_blobs(cache, blob_ids: list[str]) -> dict[str, dict]:
    """Batched blob fetch: the backend's own ``get_blobs`` where it has one,
    a plain loop otherwise."""
    fn = getattr(cache, "get_blobs", None)
    if fn is not None:
        return fn(blob_ids)
    out = {}
    for b in blob_ids:
        v = cache.get_blob(b)
        if v is not None:
            out[b] = v
    return out


def set_blobs(cache, pairs: dict[str, dict]) -> None:
    """Batched blob store (see :func:`get_blobs`)."""
    fn = getattr(cache, "set_blobs", None)
    if fn is not None:
        fn(pairs)
        return
    for b, info in pairs.items():
        cache.put_blob(b, info)


def warm_blobs(cache, prefix: str, limit: int = 1024) -> dict[str, dict]:
    """Enumerate blob entries under a key prefix; {} when the backend
    cannot enumerate."""
    fn = getattr(cache, "warm_blobs", None)
    if fn is None:
        return {}
    return fn(prefix, limit)


def new_cache(backend: str = "fs", cache_dir: str | None = None):
    """Cache factory for ``fs`` (the default) and ``memory``."""
    if backend == "memory":
        return MemoryCache()
    if backend in ("fs", ""):
        return FSCache(cache_dir)
    raise ValueError(f"unknown cache backend {backend!r}: use one of {', '.join(BACKENDS)}")
