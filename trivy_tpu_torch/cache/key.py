"""Cache key calculation (ref: pkg/cache/key.go).

Keys are sha256 over a canonical JSON of (base id, analyzer versions, hook
versions, skip options) so any change to the analysis pipeline invalidates
exactly the affected entries.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any


def calc_key(
    base: str,
    analyzer_versions: dict[str, int] | None = None,
    hook_versions: dict[str, int] | None = None,
    skip_files: list[str] | None = None,
    skip_dirs: list[str] | None = None,
    policy_digest: str = "",
) -> str:
    payload = {
        "base": base,
        "analyzers": analyzer_versions or {},
        "hooks": hook_versions or {},
        "skip_files": sorted(skip_files or []),
        "skip_dirs": sorted(skip_dirs or []),
        "policy": policy_digest,
    }
    digest = hashlib.sha256(
        json.dumps(payload, sort_keys=True, separators=(",", ":")).encode()
    ).hexdigest()
    return f"sha256:{digest}"


def calc_blob_key(obj: Any) -> str:
    """Content hash of an arbitrary JSON-serializable object."""
    digest = hashlib.sha256(
        json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()
    ).hexdigest()
    return f"sha256:{digest}"
