"""License category/severity mapping (ref: pkg/licensing/scanner.go).

Maps a license name to a risk category (forbidden/restricted/reciprocal/
notice/permissive/unencumbered/unknown) and severity, honoring
user-configured category lists (``--license-forbidden`` etc. /
``license.forbidden`` config keys in the reference).
"""

from __future__ import annotations

from trivy_tpu_torch.types import DetectedLicense

# Default category assignment for well-known licenses (modeled on the
# categories the reference inherits from google/licenseclassifier).
_DEFAULT_CATEGORIES: dict[str, str] = {
    # forbidden-by-default in the classifier's taxonomy: none — users opt in
    # restricted
    "GPL-2.0": "restricted", "GPL-2.0-only": "restricted",
    "GPL-2.0-or-later": "restricted", "GPL-3.0": "restricted",
    "GPL-3.0-only": "restricted", "GPL-3.0-or-later": "restricted",
    "LGPL-2.0": "restricted", "LGPL-2.1": "restricted",
    "LGPL-2.1-only": "restricted", "LGPL-2.1-or-later": "restricted",
    "LGPL-3.0": "restricted", "LGPL-3.0-only": "restricted",
    "LGPL-3.0-or-later": "restricted",
    "LGPL-2.0-only": "restricted", "LGPL-2.0-or-later": "restricted",
    "GPL-1.0": "restricted", "GPL-1.0-only": "restricted",
    "GPL-1.0-or-later": "restricted",
    "GFDL-1.1-only": "restricted", "GFDL-1.2-only": "restricted",
    "GFDL-1.3-only": "restricted", "GFDL-1.3-or-later": "restricted",
    "AGPL-1.0": "forbidden", "AGPL-1.0-only": "forbidden",
    "AGPL-1.0-or-later": "forbidden",
    "AGPL-3.0": "forbidden", "AGPL-3.0-only": "forbidden",
    "AGPL-3.0-or-later": "forbidden",
    "SSPL-1.0": "forbidden", "BUSL-1.1": "forbidden",
    "Elastic-2.0": "forbidden", "JSON": "restricted",
    "CC-BY-ND-4.0": "restricted", "ODbL-1.0": "restricted",
    "CC-BY-NC-1.0": "forbidden", "CC-BY-NC-2.0": "forbidden",
    "CC-BY-NC-3.0": "forbidden", "CC-BY-NC-4.0": "forbidden",
    "CC-BY-NC-ND-4.0": "forbidden", "CC-BY-NC-SA-4.0": "forbidden",
    "CC-BY-SA-4.0": "restricted",
    # reciprocal
    "MPL-1.0": "reciprocal", "MPL-1.1": "reciprocal", "MPL-2.0": "reciprocal",
    "EPL-1.0": "reciprocal", "EPL-2.0": "reciprocal",
    "CDDL-1.0": "reciprocal", "CDDL-1.1": "reciprocal",
    "EUPL-1.1": "reciprocal", "EUPL-1.2": "reciprocal",
    "OSL-3.0": "reciprocal", "OSL-2.1": "reciprocal", "CPL-1.0": "reciprocal",
    "IPL-1.0": "reciprocal", "SPL-1.0": "reciprocal", "MS-RL": "reciprocal",
    "CPAL-1.0": "reciprocal", "APSL-2.0": "reciprocal", "NPL-1.1": "reciprocal",
    "CECILL-2.1": "reciprocal", "CECILL-B": "notice", "CECILL-C": "reciprocal",
    "RPSL-1.0": "reciprocal", "QPL-1.0": "restricted",
    "EUPL-1.0": "reciprocal",
    # notice
    "Apache-2.0": "notice", "Apache-1.1": "notice", "MIT": "notice",
    "BSD-2-Clause": "notice", "BSD-3-Clause": "notice", "BSD-4-Clause": "notice",
    "ISC": "notice", "Zlib": "notice", "PostgreSQL": "notice",
    "Python-2.0": "notice", "PSF-2.0": "notice", "Ruby": "notice",
    "PHP-3.01": "notice", "Artistic-2.0": "notice", "OpenSSL": "notice",
    "NCSA": "notice", "W3C": "notice", "X11": "notice", "BSL-1.0": "notice",
    "AFL-3.0": "notice", "AFL-2.1": "notice", "MS-PL": "notice",
    "UPL-1.0": "notice", "curl": "notice", "HPND": "notice", "NTP": "notice",
    "ICU": "notice", "Vim": "notice", "FTL": "notice", "IJG": "notice",
    "libpng-2.0": "notice", "MIT-CMU": "notice", "MIT-0": "notice",
    "Apache-1.0": "notice", "OFL-1.1": "notice", "ZPL-2.1": "notice",
    "Sleepycat": "restricted", "OpenLDAP": "notice", "OLDAP-2.8": "notice",
    "MulanPSL-2.0": "notice", "BlueOak-1.0.0": "notice",
    "Unicode-DFS-2016": "notice", "Unicode-3.0": "notice",
    "Artistic-1.0": "notice", "Artistic-1.0-Perl": "notice",
    "ECL-2.0": "notice", "EFL-2.0": "notice", "LPPL-1.3c": "notice",
    "wxWindows": "notice", "Zend-2.0": "notice", "TCL": "notice",
    "bzip2-1.0.6": "notice", "MirOS": "notice", "Fair": "notice",
    "Beerware": "notice", "GFDL-1.1": "restricted", "GFDL-1.2": "restricted",
    "GFDL-1.3": "restricted",
    "CC-BY-2.5": "notice", "CC-BY-3.0": "notice", "CC-BY-4.0": "notice",
    "CC-BY-SA-2.5": "restricted", "CC-BY-SA-3.0": "restricted",
    "MPL-1.0-or-later": "reciprocal", "CDDL": "reciprocal",
    "EUPL-1.1-or-later": "reciprocal",
    "Intel": "notice", "Watcom-1.0": "restricted", "gnuplot": "restricted",
    # unencumbered
    "CC0-1.0": "unencumbered", "Unlicense": "unencumbered", "0BSD": "unencumbered",
    "WTFPL": "unencumbered",
}

_CATEGORY_SEVERITY = {
    "forbidden": "CRITICAL",
    "restricted": "HIGH",
    "reciprocal": "MEDIUM",
    "notice": "LOW",
    "permissive": "LOW",
    "unencumbered": "LOW",
    "unknown": "UNKNOWN",
}

# severity order for picking the worst leaf of an SPDX expression
_CATEGORY_RANK = {
    "unknown": 0, "unencumbered": 1, "permissive": 2, "notice": 3,
    "reciprocal": 4, "restricted": 5, "forbidden": 6,
}


class LicenseCategorizer:
    """Name -> (category, severity), user config wins (ref: scanner.go)."""

    def __init__(self, user_categories: dict[str, list[str]] | None = None):
        from trivy_tpu_torch.licensing.normalize import normalize as spdx_normalize

        self.by_name: dict[str, str] = dict(_DEFAULT_CATEGORIES)
        for category, names in (user_categories or {}).items():
            for name in names:
                # user keys are free-form; register both the raw and the
                # normalized SPDX form so 'user config wins' holds after
                # leaf normalization in detect()
                self.by_name[name] = category
                self.by_name[spdx_normalize(name)] = category

    def detect(self, name: str, pkg_name: str = "", file_path: str = "") -> DetectedLicense:
        """Category lookup. Free-form names normalize to SPDX first
        ("Apache License, Version 2.0" → Apache-2.0); SPDX expressions
        categorize by their most severe leaf (the conservative reading of
        dual licensing, matching the reference's severity-priority pick)."""
        from trivy_tpu_torch.licensing.expression import leaf_licenses

        leaves = leaf_licenses(name) or [name]
        ranked = sorted(
            (self.by_name.get(leaf, "unknown") for leaf in leaves),
            key=lambda c: _CATEGORY_RANK.get(c, 0),
            reverse=True,
        )
        category = ranked[0]
        display = leaves[0] if len(leaves) == 1 else name
        return DetectedLicense(
            name=display,
            category=category,
            severity=_CATEGORY_SEVERITY.get(category, "UNKNOWN"),
            pkg_name=pkg_name,
            file_path=file_path,
        )
