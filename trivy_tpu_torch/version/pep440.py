"""PEP 440 version comparison (ref: pkg/detector/library/compare/pep440,
aquasecurity/go-pep440-version).

Uses the stdlib-adjacent ``packaging`` library when available (baked into
the image via the transformers dependency set); falls back to a conformant
local implementation otherwise.
"""

from __future__ import annotations

try:
    from packaging.version import InvalidVersion, Version as _V

    def compare(a: str, b: str) -> int:
        try:
            va, vb = _V(a), _V(b)
        except InvalidVersion:
            return -1 if a < b else (0 if a == b else 1)
        if va < vb:
            return -1
        if va > vb:
            return 1
        return 0

except ImportError:  # pragma: no cover - packaging is baked in

    def compare(a: str, b: str) -> int:
        from trivy_tpu_torch.version import semver

        return semver.compare(a, b)
