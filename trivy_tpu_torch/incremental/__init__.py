"""Incremental scanning of the port, the copy of ``trivy_tpu/incremental``:
re-scans that analyze only what changed.

- ``fs.py``: the unit-level incremental fs artifact. The tree splits into
  the directory-atomic units of ``fleet/plan.py::group_units``; each unit's
  blob is cached under a key made of its files' content keys and the
  analysis fingerprint, and a re-scan analyzes only the units whose key the
  cache lacks. The applier merges the units' blobs, so the findings are a
  full scan's. Only the dirty units' files reach the secret feed, the fused
  license gate and the classifier on the card.
- ``manifest.py``: the scan manifest (each file's content key, stat
  signature and the git commit, kept through the scan cache), so that
  ``--since-last`` turns a repeat scan into a stat walk and ``--diff-base
  <commit>`` trusts the git diff instead of mtimes.

``image --diff-base`` is the image artifact's own (``artifact/image.py::
preseed_from_base``). The cache only speeds a scan up: a missing manifest
or a cold cache means files are hashed and units analyzed again.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class IncrementalOptions:
    """The resolved incremental flags (``--incremental``, ``--diff-base``,
    ``--since-last``; ``watch`` sets ``since_last``)."""

    enabled: bool = False
    diff_base: str = ""      # a git commit-ish: implies enabled
    since_last: bool = False  # reuse by stat signature: implies enabled

    @classmethod
    def from_opts(cls, opts: dict) -> "IncrementalOptions":
        diff_base = str(opts.get("diff_base") or "")
        since_last = bool(opts.get("since_last"))
        enabled = bool(opts.get("incremental")) or bool(diff_base) or since_last
        return cls(enabled=enabled, diff_base=diff_base, since_last=since_last)
