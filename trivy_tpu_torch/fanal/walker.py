"""Filesystem walker (ref: pkg/fanal/walker/fs.go, walk.go).

Yields (relative posix path, stat view, opener) for every unfiltered
regular file under a root, in sorted order: default skip dirs
(``**/.git``, ``proc``, ``sys``, ``dev``), user skip-dirs/files with
``**``-style glob patterns, a 100 MB size threshold, and tolerance of
permission errors (logged and counted in ``FSWalker.skipped``, never fatal —
ref: fs.go:80-96).
"""

from __future__ import annotations

import functools
import os
import re
import time
from collections.abc import Callable, Iterator
from dataclasses import dataclass, field

from trivy_tpu_torch import faults, log, obs

logger = log.logger("walker")

# ref: walk.go:9 — the Go comment says 200MB but the value is 100<<20
DEFAULT_SIZE_THRESHOLD = 100 << 20
DEFAULT_SKIP_DIRS = ["**/.git", "proc", "sys", "dev"]  # ref: walk.go:11-16


@dataclass
class WalkOption:
    skip_files: list[str] = field(default_factory=list)
    skip_dirs: list[str] = field(default_factory=list)
    size_threshold: int = DEFAULT_SIZE_THRESHOLD


@functools.lru_cache(maxsize=None)
def _glob_to_re(pat: str) -> "re.Pattern":
    """doublestar-style glob -> regex: ``*``/``?`` never cross ``/``,
    ``**`` crosses any number of segments (ref: pkg/fanal/utils/utils.go:117
    uses doublestar.Match). Cached: the walk tests every entry against the
    same few user patterns."""
    out = []
    i = 0
    while i < len(pat):
        c = pat[i]
        if c == "*":
            if pat[i : i + 3] == "**/":
                out.append("(?:[^/]+/)*")
                i += 3
                continue
            if pat[i : i + 2] == "**":
                out.append(".*")
                i += 2
                continue
            out.append("[^/]*")
        elif c == "?":
            out.append("[^/]")
        else:
            out.append(re.escape(c))
        i += 1
    return re.compile("^" + "".join(out) + "$")


def _match_any(rel: str, patterns: list[str]) -> bool:
    return any(_glob_to_re(pat.strip("/")).match(rel) for pat in patterns)


@dataclass
class FileInfo:
    """Minimal stat view passed to the analyzer's ``required``."""

    size: int
    mode: int

    @classmethod
    def from_stat(cls, st: os.stat_result) -> "FileInfo":
        return cls(size=st.st_size, mode=st.st_mode)


def _opener(path: str, rel: str) -> Callable[[], bytes]:
    """The reader of one walked file."""

    def opener() -> bytes:
        # an injected io fault reads as an unreadable file
        faults.check("walker.read", key=rel)
        with open(path, "rb") as f:
            return f.read()

    return opener


class FSWalker:
    """Walk a directory tree, yielding each eligible file."""

    def __init__(self, option: WalkOption | None = None):
        self.opt = option or WalkOption()
        self.skipped = 0  # unreadable/vanished entries in the last walk

    def walk(self, root: str) -> Iterator[tuple[str, FileInfo, Callable[[], bytes]]]:
        """Walk with per-file timing: when the active trace context is
        enabled, the time spent producing each entry (scandir, stat, skip
        filtering) records as a ``walk.next`` span and a ``walk.files``
        count, the walk's own track in the trace."""
        ctx = obs.current()
        if not ctx.enabled:
            yield from self._walk(root)
            return
        it = self._walk(root)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            ctx.add("walk.next", time.perf_counter() - t0)
            ctx.count("walk.files")
            yield item

    def _walk(self, root: str) -> Iterator[tuple[str, FileInfo, Callable[[], bytes]]]:
        root = os.path.abspath(root)
        self.skipped = 0
        skip_dirs = list(self.opt.skip_dirs) + DEFAULT_SKIP_DIRS
        skip_files = list(self.opt.skip_files)
        for dirpath, dirnames, filenames in os.walk(root, onerror=self._on_error):
            rel_dir = os.path.relpath(dirpath, root).replace(os.sep, "/")
            if rel_dir == ".":
                rel_dir = ""
            # prune skipped directories in place
            kept = []
            for d in dirnames:
                rel = f"{rel_dir}/{d}" if rel_dir else d
                if not _match_any(rel, skip_dirs):
                    kept.append(d)
            dirnames[:] = sorted(kept)
            for name in sorted(filenames):
                rel = f"{rel_dir}/{name}" if rel_dir else name
                if _match_any(rel, skip_files):
                    continue
                full = os.path.join(dirpath, name)
                try:
                    st = os.lstat(full)
                except OSError as e:
                    self._note_skip(rel, e)
                    continue
                # regular files only (no symlinks/devices/sockets)
                if not os.path.isfile(full) or os.path.islink(full):
                    continue
                if st.st_size > self.opt.size_threshold:
                    logger.debug("file exceeds size threshold, skipping %s", rel)
                    continue

                yield rel, FileInfo.from_stat(st), _opener(full, rel)

    def walk_paths(self, root: str, rels) -> Iterator[tuple[str, FileInfo, Callable[[], bytes]]]:
        """The files ``rels`` (slash-separated, relative to ``root``) in the
        given order, as :meth:`walk` yields them but without its skip rules:
        a fleet shard's planned paths. A path that cannot be stat'ed (deleted
        since the plan) is counted as the walk counts a stat failure."""
        root = os.path.abspath(root)
        self.skipped = 0
        for rel in rels:
            full = os.path.join(root, *rel.split("/"))
            try:
                st = os.lstat(full)
            except OSError as e:
                self._note_skip(rel, e)
                continue
            yield rel, FileInfo.from_stat(st), _opener(full, rel)

    def _note_skip(self, what: str, err: OSError) -> None:
        """One tolerated walk/stat failure: never fatal, never silent."""
        self.skipped += 1
        ctx = obs.current()
        ctx.count("walk.skipped")
        ctx.health_count("walk.skipped")
        logger.debug("skipping unreadable %s: %s", what, err)

    def _on_error(self, err: OSError) -> None:
        # permission errors are tolerated (ref: fs.go:80-96)
        self._note_skip(getattr(err, "filename", "") or "<dir>", err)
