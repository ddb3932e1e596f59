"""VM image artifact: a raw disk image analyzed like a root filesystem (ref:
pkg/fanal/artifact/vm/file.go, the local disk-image path), the port of
``trivy_tpu/artifact/vm.py``.

The files of every ext4 partition (``fanal/vm.py::walk_disk``) go through the
scan's one walk loop, ``fanal/scan.py::analyze_files``, with the secret and
license feeds of a tree. The blob is keyed by the image's digest and the
analyzer and handler versions, so a rescan of an unchanged image is a cache
hit that reads no file.
"""

from __future__ import annotations

import hashlib
import os
from collections import Counter

from trivy_tpu_torch import log
from trivy_tpu_torch.artifact.image import ArtifactReference
from trivy_tpu_torch.cache.key import calc_key
from trivy_tpu_torch.fanal.handler import HandlerManager
from trivy_tpu_torch.fanal.scan import ScanAnalyzers, analyze_files
from trivy_tpu_torch.fanal.vm import walk_disk
from trivy_tpu_torch.fanal.walker import FileInfo

logger = log.logger("artifact:vm")


class VMImageArtifact:
    """The disk image at ``path`` scanned with ``analyzers``; its one blob
    goes to ``cache``. ``stats`` gathers the files walked, scanned and
    skipped (none on a cache hit)."""

    type = "vm"

    def __init__(self, path: str, cache, analyzers: ScanAnalyzers, skip_files=(),
                 skip_dirs=()):
        if not os.path.exists(path):
            raise FileNotFoundError(f"disk image not found: {path}")
        self.path = path
        self.cache = cache
        self.analyzers = analyzers
        self.skip_files = list(skip_files)
        self.skip_dirs = list(skip_dirs)
        self.handlers = HandlerManager()
        self.stats: Counter = Counter()

    def _image_digest(self) -> str:
        """Digest of the image's head and tail MiB, size and mtime: rehashing
        a multi-GB image per scan defeats the cache; the mtime catches
        in-place rewrites whose changed blocks lie outside the sampled
        head and tail."""
        h = hashlib.sha256()
        st = os.stat(self.path)
        h.update(str(st.st_size).encode())
        h.update(str(st.st_mtime_ns).encode())
        with open(self.path, "rb") as f:
            h.update(f.read(1 << 20))
            if st.st_size > (1 << 20):
                f.seek(max(1 << 20, st.st_size - (1 << 20)))
                h.update(f.read(1 << 20))
        return h.hexdigest()

    def _entries(self):
        """``(path, info, opener)`` of every disk file the skip rules keep;
        every file reads as mode 0o644 (the JAX package's)."""
        skips = set(self.skip_files)
        skip_dirs = [d.strip("/") + "/" for d in self.skip_dirs]
        for _part, fpath, size, opener in walk_disk(self.path):
            if fpath in skips or any(fpath.startswith(d) for d in skip_dirs):
                continue
            yield fpath, FileInfo(size=size, mode=0o644), opener

    def inspect(self) -> ArtifactReference:
        """Analyze the disk unless the cache holds its blob; return the
        reference."""
        blob_id = calc_key(self._image_digest(), analyzer_versions=self.analyzers.versions(),
                           hook_versions=self.handlers.versions(),
                           skip_files=self.skip_files, skip_dirs=self.skip_dirs)
        ref = ArtifactReference(name=self.path, type=self.type, id=blob_id, blob_ids=[blob_id])
        _, missing = self.cache.missing_blobs(blob_id, [blob_id])
        if not missing:
            logger.debug("cache hit for %s -> %s", self.path, blob_id)
            return ref
        secret, batched = self.analyzers.batch("")
        result = analyze_files(self._entries(), "", self.analyzers.group, secret, batched,
                               self.stats)
        blob = result.to_blob_info()
        self.handlers.post_handle(result, blob)
        self.cache.put_blob(blob_id, blob.to_dict())
        logger.debug("inspected %d files in %s -> %s", self.stats["files_walked"], self.path,
                     blob_id)
        return ref
