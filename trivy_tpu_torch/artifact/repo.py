"""Git repository artifact (ref: pkg/fanal/artifact/repo/git.go), the port's
copy of ``trivy_tpu/artifact/repo.py``.

A remote (or local) git URL is checked out into a temporary directory with
the system ``git`` (the reference embeds go-git; the behavior — shallow
clone of one branch/commit/tag into a throwaway dir, then delegate to the
local-FS artifact — is the same). ``cli.py``'s ``repo`` command calls
:func:`checkout_repo` for a URL (:data:`REMOTE_PREFIXES`, or a ``.git``
suffix) and scans the returned path as ``fs`` scans a directory.
"""

from __future__ import annotations

import atexit
import os
import shutil
import subprocess
import tempfile

from trivy_tpu_torch import log

logger = log.logger("artifact:repo")


# a repo target starting with one of these (or ending in .git) is cloned
REMOTE_PREFIXES = ("http://", "https://", "git://", "file://", "ssh://")


class RepoError(RuntimeError):
    pass


def is_remote(target: str) -> bool:
    return target.startswith(REMOTE_PREFIXES) or target.endswith(".git")


def _git(args: list[str], cwd: str | None = None) -> None:
    try:
        proc = subprocess.run(
            ["git", *args],
            cwd=cwd,
            capture_output=True,
            text=True,
            timeout=600,
            env={**os.environ, "GIT_TERMINAL_PROMPT": "0"},  # never prompt
        )
    except subprocess.TimeoutExpired as e:
        raise RepoError(f"git {' '.join(args[:2])} timed out after 600s") from e
    if proc.returncode != 0:
        raise RepoError(
            f"git {' '.join(args[:2])} failed: {proc.stderr.strip()[:500]}"
        )


def checkout_repo(
    url: str,
    branch: str | None = None,
    tag: str | None = None,
    commit: str | None = None,
) -> str:
    """Clone ``url`` into a temp dir (removed at exit); returns the path.

    branch/tag clone shallowly; a commit needs history, so it fetches the
    full clone then checks out (ref: git.go cloneOptions/checkout split).
    """
    if sum(1 for r in (branch, tag, commit) if r) > 1:
        raise RepoError("--branch, --tag and --commit are mutually exclusive")
    tmp = tempfile.mkdtemp(prefix="trivy-tpu-repo-")
    atexit.register(shutil.rmtree, tmp, ignore_errors=True)
    args = ["clone", "--quiet"]
    ref = branch or tag
    if ref:
        args += ["--branch", ref]
    if not commit:
        args += ["--depth", "1"]
    args += ["--", url, tmp]
    try:
        _git(args)
        if commit:
            _git(["checkout", "--quiet", commit], cwd=tmp)
    except FileNotFoundError as e:  # git binary itself missing
        raise RepoError("git is not installed") from e
    logger.debug("checked out %s -> %s", url, tmp)
    return tmp
