"""Persistent cross-scan chunk-dedup store.

The same base images and vendored trees are scanned again and again, so the
row verdicts the device computes are kept and reused:

- **byte-bounded** in-process LRU (``--secret-dedup-mb``): the bound is an
  RSS budget, not an entry count, so a streaming multi-GB scan's dedup
  state stays flat no matter how many distinct rows it sees;
- **fingerprint-versioned namespace**: every persisted key lives under
  ``secret-hitv<V>:<fingerprint>:`` where the fingerprint folds the full
  effective config (compiled ruleset, prefilter table, row length and the
  ``--secret-config`` file content), so a changed rule file can never serve
  stale verdicts across processes. A namespace marker records the
  fingerprints seen; a new one logs a LOUD cold-start line instead of
  silently missing forever;
- **batched backend IO**: lookups happen per assembled batch
  (:meth:`lookup_batch`), writes are write-behind buffered and flushed per
  resolved batch (:meth:`flush_writes`);
- **warm export / seed**: a store exports its hottest entries
  (:meth:`export_warm`) and another store of the same namespace takes them
  in (:meth:`seed`).

Verdict persist schema, shared with the JAX package's store so that either
reads the other's entries: ``{"r": hit_rules, "c": cand_rules, "n":
nfa_ran, "l": lic|None}``.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

from trivy_tpu_torch import cache as cache_mod
from trivy_tpu_torch import log

logger = log.logger("secret:hitstore")

# persisted-namespace version: bump when the verdict schema or the
# fingerprint recipe changes
STORE_VERSION = 3

# default in-process LRU byte budget; entries are tiny (most verdicts are
# empty tuples), so 32 MB holds ~10^5-10^6 rows
DEFAULT_STORE_MB = 32

# write-behind buffer flushed in one call once this many verdicts are
# pending (or at scan end, force=True)
WRITE_BATCH = 256

# warm export bound
WARM_EXPORT_LIMIT = 4096


def verdict_to_doc(verdict: tuple) -> dict:
    hit_rules, cand_rules, nfa_ran, lic = verdict
    return {
        "r": list(hit_rules),
        "c": list(cand_rules),
        "n": int(nfa_ran),
        "l": lic if lic is None else list(lic),
    }


def doc_to_verdict(doc: dict) -> tuple | None:
    try:
        lic = doc.get("l")
        return (
            tuple(doc["r"]),
            tuple(doc.get("c", ())),
            bool(doc.get("n", 1)),
            None if lic is None else tuple(lic),
        )
    except (KeyError, TypeError):
        return None


def _entry_bytes(key: bytes, verdict: tuple) -> int:
    hit_rules, cand_rules, _, lic = verdict
    return 64 + len(key) + 8 * (
        len(hit_rules) + len(cand_rules) + (len(lic) if lic else 0)
    )


class HitStore:
    """Row-verdict store: byte-bounded LRU in front of an optional
    persistent :mod:`trivy_tpu_torch.cache` backend. Thread-safe; all
    backend IO is serialized under one lock."""

    def __init__(
        self,
        fingerprint: bytes,
        backend=None,
        max_entries: int = 0,
        max_bytes: int = 0,
        write_batch: int = WRITE_BATCH,
    ):
        self.fingerprint = fingerprint
        self.backend = backend
        self.max_entries = int(max_entries) or (1 << 16)
        self.max_bytes = int(max_bytes) or DEFAULT_STORE_MB * (1 << 20)
        self.write_batch = max(1, int(write_batch))
        self._lru: OrderedDict[bytes, tuple] = OrderedDict()
        self._lru_bytes = 0
        self._lock = threading.Lock()
        self._io_lock = threading.Lock()
        self._pending: dict[str, dict] = {}  # write-behind buffer
        self.stats = {
            "lru_hits": 0,
            "warm_hits": 0,        # rows served from the backend
            "backend_lookups": 0,  # batched lookups issued
            "backend_writes": 0,   # batched writes issued
            "seeded": 0,           # entries pre-inserted from an export
            "evictions": 0,
        }
        if backend is not None:
            self._check_namespace()

    # -- namespace ----------------------------------------------------------

    @property
    def prefix(self) -> str:
        return f"secret-hitv{STORE_VERSION}:{self.fingerprint.hex()}:"

    def _persist_key(self, key: bytes) -> str:
        return self.prefix + key.hex()

    # namespaces remembered by the marker (coexisting configs against one
    # shared backend are legitimate: each warns once ever, not per scan)
    MARKER_FPS = 16

    def _check_namespace(self) -> None:
        """Loud-miss guard: the marker records the fingerprints this
        backend has served. A fingerprint the marker has never seen, while
        others exist, means the effective config changed (rule file edit,
        prefilter-table change, row-length change) or this is a new
        config's first scan; either way prior entries are invisible by
        design, so say so ONCE (the fingerprint then joins the marker)."""
        marker_key = f"secret-hit-ns:v{STORE_VERSION}"
        try:
            with self._io_lock:
                marker = self.backend.get_blob(marker_key) or {}
                fps = list(marker.get("fps") or [])
                # legacy single-fp marker shape
                if not fps and marker.get("fp"):
                    fps = [marker["fp"]]
                fp = self.fingerprint.hex()
                if fp in fps:
                    return
                if fps:
                    logger.warning(
                        "persistent dedup store: fingerprint %s not seen "
                        "before on this backend (last writers: %s) — the "
                        "effective secret config (rules, prefilter table, "
                        "--secret-config content, or chunk length) differs, "
                        "so this namespace starts COLD; prior entries stay "
                        "invisible by design",
                        fp[:16], ", ".join(f[:16] for f in fps[-3:]),
                    )
                fps = (fps + [fp])[-self.MARKER_FPS:]
                self.backend.put_blob(marker_key, {"fps": fps})
        except Exception as e:  # the store is an accelerator, never a dep
            logger.warning("dedup store namespace check failed: %s", e)

    # -- LRU ----------------------------------------------------------------

    def _insert_locked(self, key: bytes, verdict: tuple) -> None:
        old = self._lru.pop(key, None)
        if old is not None:
            self._lru_bytes -= _entry_bytes(key, old)
        self._lru[key] = verdict
        self._lru_bytes += _entry_bytes(key, verdict)
        # byte bound first (the RSS budget), entry bound as a backstop
        while self._lru and (
            self._lru_bytes > self.max_bytes
            or len(self._lru) > self.max_entries
        ):
            k, v = self._lru.popitem(last=False)
            self._lru_bytes -= _entry_bytes(k, v)
            self.stats["evictions"] += 1

    def get(self, key: bytes) -> tuple | None:
        """In-process LRU lookup only (the synchronous per-row path);
        persistent lookups are batched (:meth:`lookup_batch`)."""
        with self._lock:
            v = self._lru.get(key)
            if v is not None:
                self._lru.move_to_end(key)
                self.stats["lru_hits"] += 1
            return v

    def put(self, key: bytes, verdict: tuple) -> None:
        """Insert locally and buffer the persistent write (write-behind;
        call :meth:`flush_writes` per resolved batch)."""
        with self._lock:
            self._insert_locked(key, verdict)
            if self.backend is not None:
                self._pending[self._persist_key(key)] = verdict_to_doc(verdict)

    @property
    def entries(self) -> int:
        return len(self._lru)

    @property
    def bytes(self) -> int:
        return self._lru_bytes

    # -- batched backend IO --------------------------------------------------

    def lookup_batch(self, keys: list[bytes]) -> dict[bytes, tuple]:
        """Resolve row digests against the persistent backend in ONE
        batched call; found verdicts enter the LRU. Keys already resolved
        locally are answered from the LRU without IO."""
        out: dict[bytes, tuple] = {}
        if not keys:
            return out
        misses: list[bytes] = []
        with self._lock:
            for k in keys:
                v = self._lru.get(k)
                if v is not None:
                    self._lru.move_to_end(k)
                    out[k] = v
                else:
                    misses.append(k)
        if self.backend is None or not misses:
            return out
        ids = {self._persist_key(k): k for k in misses}
        try:
            with self._io_lock:
                found = cache_mod.get_blobs(self.backend, list(ids))
            self.stats["backend_lookups"] += 1
        except Exception as e:
            logger.warning("dedup store batch lookup failed: %s", e)
            return out
        warm = 0
        with self._lock:
            for pid, doc in found.items():
                v = doc_to_verdict(doc)
                if v is None:
                    continue
                k = ids[pid]
                self._insert_locked(k, v)
                out[k] = v
                warm += 1
            self.stats["warm_hits"] += warm
        return out

    def flush_writes(self, force: bool = False) -> None:
        """Push the write-behind buffer in one batched call once it reaches
        the batch size (or unconditionally with ``force``)."""
        if self.backend is None:
            return
        with self._lock:
            if not self._pending or (
                not force and len(self._pending) < self.write_batch
            ):
                return
            pending, self._pending = self._pending, {}
        try:
            with self._io_lock:
                cache_mod.set_blobs(self.backend, pending)
            self.stats["backend_writes"] += 1
        except Exception as e:
            logger.warning("dedup store batch write failed: %s", e)

    # -- warm export / seed --------------------------------------------------

    def export_warm(self, limit: int = WARM_EXPORT_LIMIT) -> list[list]:
        """Warm entries as ``[[persist_key, doc], ...]``: the hottest local
        entries (most recently used first), or, when the local LRU is cold
        but a persistent backend is warm, a bounded enumeration of this
        store's namespace. Entries carry their FULL namespace key (version
        + fingerprint), so a receiver can verify soundness without any
        side-channel fingerprint exchange."""
        entries: list[list] = []
        with self._lock:
            for k in reversed(self._lru):  # most recently used first
                entries.append(
                    [self._persist_key(k), verdict_to_doc(self._lru[k])]
                )
                if len(entries) >= limit:
                    break
        if not entries and self.backend is not None:
            try:
                with self._io_lock:
                    found = cache_mod.warm_blobs(
                        self.backend, self.prefix, limit
                    )
                entries = [[k, v] for k, v in sorted(found.items())]
            except Exception as e:
                logger.warning("dedup store warm export failed: %s", e)
        return entries

    def seed(self, entries: list) -> int:
        """Pre-insert exported warm entries. Only keys under THIS store's
        namespace (same version + fingerprint, i.e. provably the same
        effective config) are accepted; anything else is dropped, with one
        loud line naming the count (applying verdicts computed under
        different rules would be unsound)."""
        n = dropped = 0
        prefix = self.prefix
        with self._lock:
            for item in entries or []:
                try:
                    pid, doc = item[0], item[1]
                    if not str(pid).startswith(prefix):
                        dropped += 1
                        continue
                    key = bytes.fromhex(pid[len(prefix):])
                    v = doc_to_verdict(doc)
                except (ValueError, TypeError, IndexError):
                    dropped += 1
                    continue
                if v is None:
                    dropped += 1
                    continue
                self._insert_locked(key, v)
                n += 1
            self.stats["seeded"] += n
        if dropped:
            logger.warning(
                "dedup warm seed: %d entr%s dropped (different fingerprint "
                "namespace — the exporter runs different rules/config/chunking)",
                dropped, "y" if dropped == 1 else "ies",
            )
        return n
