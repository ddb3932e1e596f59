"""SBOM decode/encode (ref: pkg/sbom).

Format sniffing (ref: pkg/sbom/sbom.go:58-184) plus CycloneDX/SPDX JSON
codecs mapping to/from BlobInfo and Report.
"""

from __future__ import annotations

import json


def detect_format(data: bytes) -> str:
    """-> 'cyclonedx' | 'spdx-json' | 'spdx-tv' | 'attest-cyclonedx' | 'unknown'."""
    head = data.lstrip()[:1]
    if head == b"{":
        try:
            doc = json.loads(data)
        except json.JSONDecodeError:
            return "unknown"
        if doc.get("bomFormat") == "CycloneDX":
            return "cyclonedx"
        if str(doc.get("spdxVersion", "")).startswith("SPDX-"):
            return "spdx-json"
        # in-toto attestation wrapping a CycloneDX predicate
        if doc.get("predicateType", "").startswith("https://cyclonedx.org"):
            return "attest-cyclonedx"
        if doc.get("_type", "").startswith("https://in-toto.io"):
            return "attest-cyclonedx"
        return "unknown"
    if data.lstrip().startswith(b"SPDXVersion:"):
        return "spdx-tv"
    return "unknown"
