"""Layer-tar walker (ref: pkg/fanal/walker/tar.go:16-35), the port of
``trivy_tpu/fanal/walker_tar.py``.

Streams one image layer's tar, yielding eligible regular files and
collecting overlayfs whiteout markers: a ``.wh.<name>`` entry deletes
``<name>`` from lower layers; a ``.wh..wh..opq`` entry marks its directory
opaque (everything below it in lower layers is hidden).
"""

from __future__ import annotations

import tarfile
from collections.abc import Iterator
from dataclasses import dataclass, field

from trivy_tpu_torch import log
from trivy_tpu_torch.fanal.walker import DEFAULT_SIZE_THRESHOLD, FileInfo, _match_any

logger = log.logger("walker:tar")

WHITEOUT_PREFIX = ".wh."
OPAQUE_MARKER = ".wh..wh..opq"


@dataclass
class LayerResult:
    whiteout_files: list[str] = field(default_factory=list)
    opaque_dirs: list[str] = field(default_factory=list)


def _normalize(name: str) -> str:
    name = name.lstrip("/")
    if name.startswith("./"):
        name = name[2:]
    return name


class LayerTarWalker:
    """Walk one uncompressed/compressed layer tar stream."""

    def __init__(self, skip_files=None, skip_dirs=None,
                 size_threshold: int = DEFAULT_SIZE_THRESHOLD):
        self.skip_files = list(skip_files or [])
        self.skip_dirs = list(skip_dirs or [])
        self.size_threshold = size_threshold

    def walk(
        self, fileobj, result: LayerResult
    ) -> Iterator[tuple[str, FileInfo, object]]:
        """Yield (path, info, opener) for files; fill ``result`` with
        whiteout/opaque markers. ``fileobj`` must be a readable stream of the
        layer tar (tarfile auto-detects gzip/bzip2/xz)."""
        with tarfile.open(fileobj=fileobj, mode="r:*") as tf:
            for member in tf:
                name = _normalize(member.name)
                if not name:
                    continue
                base = name.rsplit("/", 1)[-1]
                dirname = name[: -len(base)].rstrip("/")
                if base == OPAQUE_MARKER:
                    result.opaque_dirs.append(dirname)
                    continue
                if base.startswith(WHITEOUT_PREFIX):
                    restored = (
                        f"{dirname}/{base[len(WHITEOUT_PREFIX):]}"
                        if dirname
                        else base[len(WHITEOUT_PREFIX):]
                    )
                    result.whiteout_files.append(restored)
                    continue
                if not member.isreg():
                    continue
                if _match_any(name, self.skip_files):
                    continue
                if dirname and _match_any(dirname, self.skip_dirs):
                    continue
                if member.size > self.size_threshold:
                    logger.debug("layer file exceeds size threshold: %s", name)
                    continue
                # tar streaming: read the content now (the member is only
                # readable while the stream is positioned at it)
                f = tf.extractfile(member)
                if f is None:
                    continue
                content = f.read()

                def opener(data=content) -> bytes:
                    return data

                yield name, FileInfo(size=member.size, mode=member.mode), opener
