"""The scan manifest, the port's copy of
``trivy_tpu/incremental/manifest.py``.

One manifest per (root, analysis fingerprint), kept in the scan cache's
artifact table (fs, memory or redis). It records each walked file's stat
signature ``(size, mtime_ns)`` and content key, the git commit of a clean
worktree, and the unit -> blob id map. ``--since-last`` reuses a content
key whose stat signature matches; ``--diff-base <commit>`` reuses the keys
of files the git diff calls unchanged since the manifest's commit.

The fingerprint is part of the storage key, so a rule file edit, an
analyzer version or a skip list change makes the old manifest unreachable.
"""

from __future__ import annotations

import hashlib
import subprocess
import time

from trivy_tpu_torch import log

logger = log.logger("incremental:manifest")

MANIFEST_VERSION = 1


def manifest_key(root: str, fingerprint: str) -> str:
    digest = hashlib.sha256(f"{root}|{fingerprint}".encode()).hexdigest()
    return f"incr-manifest:{digest}"


def load_manifest(cache, root: str, fingerprint: str) -> dict | None:
    """The manifest of ``root`` under ``fingerprint``, or None (logged when
    it cannot be read or has another version)."""
    try:
        doc = cache.get_artifact(manifest_key(root, fingerprint))
    except Exception as e:
        logger.warning("manifest load failed (%s); scanning without it", e)
        return None
    if not isinstance(doc, dict) or doc.get("Version") != MANIFEST_VERSION:
        if doc is not None:
            logger.warning("manifest for %s has version %r (want %d); ignoring it",
                           root, (doc or {}).get("Version"), MANIFEST_VERSION)
        return None
    return doc


def save_manifest(cache, root: str, fingerprint: str, files: dict[str, list],
                  units: dict[str, str], commit: str = "") -> dict:
    """Store the manifest: ``files`` rel -> ``[size, mtime_ns, content key]``,
    ``units`` unit -> blob id, ``commit`` the clean worktree's HEAD or "".
    A failed store is logged: the next scan then runs cold."""
    doc = {
        "Version": MANIFEST_VERSION,
        "Root": root,
        "Fingerprint": fingerprint,
        "Commit": commit,
        "Files": files,
        "Units": units,
        "CreatedWall": time.time(),
    }
    try:
        cache.put_artifact(manifest_key(root, fingerprint), doc)
    except Exception as e:
        logger.warning("manifest save failed (%s); next scan runs cold", e)
    return doc


# -- git (--diff-base) ---------------------------------------------------------


class GitDiffError(RuntimeError):
    """A git call failed: a bad ref, or a root that is no git worktree."""


def _git(root: str, args: list[str]) -> str:
    try:
        proc = subprocess.run(["git", *args], cwd=root, capture_output=True, text=True,
                              timeout=120)
    except FileNotFoundError as e:
        raise GitDiffError("git is not installed") from e
    except subprocess.TimeoutExpired as e:
        raise GitDiffError(f"git {args[0]} timed out") from e
    if proc.returncode != 0:
        raise GitDiffError(f"git {' '.join(args[:2])} failed: {proc.stderr.strip()[:300]}")
    return proc.stdout


def git_head(root: str) -> str:
    """The HEAD commit id, or "" when ``root`` is not a git worktree."""
    try:
        return _git(root, ["rev-parse", "HEAD"]).strip()
    except GitDiffError:
        return ""


def git_clean_head(root: str) -> str:
    """The HEAD commit id when the worktree is clean (nothing staged,
    modified or untracked), else "". Only such commits go into a manifest:
    keys hashed over uncommitted edits must never be reused through a later
    ``--diff-base`` diff, where a revert would call those paths unchanged."""
    head = git_head(root)
    if not head:
        return ""
    try:
        dirty = _git(root, ["status", "--porcelain", "--no-renames"]).strip()
    except GitDiffError:
        return ""
    return "" if dirty else head


def git_resolve(root: str, ref: str) -> str:
    """The full id of the commit-ish ``ref``; raises :class:`GitDiffError`
    (a mistyped ``--diff-base`` must not turn into a quiet full scan)."""
    return _git(root, ["rev-parse", "--verify", f"{ref}^{{commit}}"]).strip()


def git_changed_paths(root: str, base: str) -> set[str]:
    """The paths under ``root`` that changed between ``base`` and the
    worktree: the commits ``base..HEAD``, staged and unstaged edits,
    untracked files and files git ignores (git holds no record of their
    content, so a manifest key of theirs is never reused). A rename is a
    delete and an add (``--no-renames``), so both sides are keyed again.

    Paths are relative to ``root``, in posix form, as the walker gives
    them, also when ``root`` is a subdirectory of the repository (git names
    paths from the repository's top). An entry ending in ``/`` stands for
    every path under that directory; ``""`` stands for the whole root."""
    prefix = _git(root, ["rev-parse", "--show-prefix"]).strip()
    changed: set[str] = set()
    # --relative: paths under root only, relative to it, whatever diff.relative says
    out = _git(root, ["diff", "--name-only", "--relative", "--no-renames", "-z", base, "HEAD"])
    changed.update(p for p in out.split("\0") if p)
    # the porcelain status names paths from the repository's top
    out = _git(root, ["status", "--porcelain", "--no-renames", "--ignored", "-z"])
    for entry in out.split("\0"):
        if len(entry) <= 3:
            continue
        path = entry[3:]
        if path.startswith(prefix):
            changed.add(path[len(prefix):])
        elif path.endswith("/") and prefix.startswith(path):
            changed.add("")  # an untracked or ignored directory holds the root
    return changed

