"""License-name normalization to SPDX identifiers.

Free-form names from package metadata ("Apache License, Version 2.0",
"GPLv2+", "BSD") normalize to canonical SPDX ids before category mapping
and report rendering (ref: pkg/licensing/normalize.go — a large alias
table sourced from the public ORT simple-license-mapping; this build uses
a compact independently-authored table plus algorithmic rules, which cover
the same common cases).

``normalize_name`` returns (spdx_id, had_plus). ``normalize`` returns the
rendered form ("GPL-2.0-or-later" when a plus is present and the id has an
-only/-or-later pair, else "<id>+" or the id itself).
"""

from __future__ import annotations

import re

# ids with -only / -or-later SPDX forms
_ONLY_OR_LATER = {
    "GPL-1.0", "GPL-2.0", "GPL-3.0",
    "LGPL-2.0", "LGPL-2.1", "LGPL-3.0",
    "AGPL-1.0", "AGPL-3.0",
    "GFDL-1.1", "GFDL-1.2", "GFDL-1.3",
}

# canonical alias table; keys are squashed like inputs at build time below
_RAW_ALIASES = {
    # Apache family
    "APACHE": "Apache-2.0",
    "APACHE2": "Apache-2.0",
    "APACHE20": "Apache-2.0",
    "APACHELICENSE": "Apache-2.0",
    "APACHELICENSE2": "Apache-2.0",
    "APACHELICENSE20": "Apache-2.0",
    "APACHELICENSEVERSION20": "Apache-2.0",
    "APACHE SOFTWARE": "Apache-2.0",
    "ASL": "Apache-2.0",
    "ASL2": "Apache-2.0",
    "ASL20": "Apache-2.0",
    "AL2": "Apache-2.0",
    "AL20": "Apache-2.0",
    "APACHE1": "Apache-1.0",
    "APACHE10": "Apache-1.0",
    "APACHE11": "Apache-1.1",
    # BSD family
    "BSD": "BSD-3-Clause",
    "BSDLIKE": "BSD-3-Clause",
    "BSDSTYLE": "BSD-3-Clause",
    "NEWBSD": "BSD-3-Clause",
    "MODIFIEDBSD": "BSD-3-Clause",
    "BSD3": "BSD-3-Clause",
    "BSD3CLAUSE": "BSD-3-Clause",
    "BSD 3 CLAUSE NEW OR REVISED": "BSD-3-Clause",
    "THREECLAUSEBSD": "BSD-3-Clause",
    "BSD2": "BSD-2-Clause",
    "BSD2CLAUSE": "BSD-2-Clause",
    "SIMPLIFIEDBSD": "BSD-2-Clause",
    "FREEBSD": "BSD-2-Clause",
    "BSD4": "BSD-4-Clause",
    "BSD4CLAUSE": "BSD-4-Clause",
    "ORIGINALBSD": "BSD-4-Clause",
    "0BSD": "0BSD",
    "ZEROBSD": "0BSD",
    # MIT / ISC
    "MIT": "MIT",
    "MITLICENSE": "MIT",
    "EXPAT": "MIT",
    "XCONSORTIUM": "X11",
    "ISC": "ISC",
    "ISCL": "ISC",
    # GPL family (bare names default like the reference: GPL→2.0+, LGPL→2.0+)
    "GPL": ("GPL-2.0", True),
    "GPL1": "GPL-1.0",
    "GPL10": "GPL-1.0",
    "GPL2": "GPL-2.0",
    "GPL20": "GPL-2.0",
    "GPLV2": "GPL-2.0",
    "GPL3": "GPL-3.0",
    "GPL30": "GPL-3.0",
    "GPLV3": "GPL-3.0",
    "GNUGPL": ("GPL-2.0", True),
    "GNU GENERAL PUBLIC": ("GPL-2.0", True),
    "LGPL": ("LGPL-2.0", True),
    "LGPL2": "LGPL-2.0",
    "LGPL20": "LGPL-2.0",
    "LGPL21": "LGPL-2.1",
    "LGPLV21": "LGPL-2.1",
    "LGPL3": "LGPL-3.0",
    "LGPL30": "LGPL-3.0",
    "LGPLV3": "LGPL-3.0",
    "GNU LESSER GENERAL PUBLIC": ("LGPL-2.0", True),
    "AGPL": "AGPL-3.0",
    "AGPL3": "AGPL-3.0",
    "AGPL30": "AGPL-3.0",
    "AGPLV3": "AGPL-3.0",
    "FDL": ("GFDL-1.3", True),
    "GFDL": ("GFDL-1.3", True),
    # MPL / EPL / CDDL
    "MPL": "MPL-2.0",
    "MPL1": "MPL-1.0",
    "MPL10": "MPL-1.0",
    "MPL11": "MPL-1.1",
    "MPL2": "MPL-2.0",
    "MPL20": "MPL-2.0",
    "MOZILLA PUBLIC 2.0": "MPL-2.0",
    "EPL": "EPL-1.0",
    "EPL1": "EPL-1.0",
    "EPL10": "EPL-1.0",
    "EPL2": "EPL-2.0",
    "EPL20": "EPL-2.0",
    "ECLIPSE": "EPL-1.0",
    "ECLIPSE PUBLIC": "EPL-1.0",
    "CDDL": "CDDL-1.0",
    "CDDL1": "CDDL-1.0",
    "CDDL10": "CDDL-1.0",
    "CDDL11": "CDDL-1.1",
    # misc
    "UNLICENSE": "Unlicense",
    "UNLICENSED": "Unlicense",
    "PUBLICDOMAIN": "Unlicense",
    "CC0": "CC0-1.0",
    "CC010": "CC0-1.0",
    "CCBY3": "CC-BY-3.0",
    "CCBY30": "CC-BY-3.0",
    "CCBY4": "CC-BY-4.0",
    "CCBY40": "CC-BY-4.0",
    "CCBYSA40": "CC-BY-SA-4.0",
    "WTFPL": "WTFPL",
    "ZLIB": "Zlib",
    "ZLIBLICENSE": "Zlib",
    "PSF": "PSF-2.0",
    "PSF2": "PSF-2.0",
    "PSFL": "PSF-2.0",
    "PYTHON": "Python-2.0",
    "PYTHON SOFTWARE FOUNDATION": "PSF-2.0",
    "ARTISTIC": "Artistic-2.0",
    "ARTISTIC2": "Artistic-2.0",
    "ARTISTIC20": "Artistic-2.0",
    "PERL": "Artistic-1.0-Perl",
    "PERLARTISTIC": "Artistic-1.0-Perl",
    "RUBY": "Ruby",
    "BSL": "BSL-1.0",
    "BSL1": "BSL-1.0",
    "BSL10": "BSL-1.0",
    "BOOST": "BSL-1.0",
    "BOOST SOFTWARE": "BSL-1.0",
    "EUPL": "EUPL-1.0",
    "EUPL11": "EUPL-1.1",
    "EUPL12": "EUPL-1.2",
    "AFL": "AFL-3.0",
    "AFL3": "AFL-3.0",
    "AFL30": "AFL-3.0",
    "OFL": "OFL-1.1",
    "OFL11": "OFL-1.1",
    "POSTGRESQL": "PostgreSQL",
    "OPENSSL": "OpenSSL",
    "NETSCAPE": "NPL-1.1",
    "ZOPE": "ZPL-2.1",
    "ZPL21": "ZPL-2.1",
    "UPL": "UPL-1.0",
    "UPL1": "UPL-1.0",
    "MSPL": "MS-PL",
    "MSRL": "MS-RL",
    "VIM": "Vim",
    "ICU": "ICU",
    "CURL": "curl",
    "MITCMU": "MIT-CMU",
    "LATEX": "LPPL-1.3c",
    "LPPL": "LPPL-1.3c",
}

def _squash(name: str) -> str:
    up = name.upper()
    up = re.sub(r"\bV(?=[0-9])", "", up)  # v2 → 2
    up = re.sub(r"\b(THE|LICENCES?|LICENSES?|VERSIONS?)\b", "", up)
    return re.sub(r"[^A-Z0-9]", "", up)


# alias keys pass through the same squash as inputs, so table entries can be
# written in readable form and noise words never cause key mismatches
_ALIASES = {_squash(k): v for k, v in _RAW_ALIASES.items()}


_KNOWN_IDS: set[str] | None = None


def _known_ids() -> set[str]:
    global _KNOWN_IDS
    if _KNOWN_IDS is None:
        from trivy_tpu_torch.licensing.corpus import NORMALIZED_FINGERPRINTS

        ids = set(NORMALIZED_FINGERPRINTS)
        ids.update(v if isinstance(v, str) else v[0] for v in _ALIASES.values())
        _KNOWN_IDS = ids
    return _KNOWN_IDS


def normalize_name(name: str) -> tuple[str, bool]:
    """Free-form license name → (SPDX id, had_plus). Unrecognized names
    return unchanged (the reference also passes unknown names through)."""
    name = name.strip().strip('"')
    if not name:
        return name, False
    plus = False
    base = name
    if base.endswith("+"):
        plus = True
        base = base[:-1]
    low = base.lower()
    if low.endswith(("-or-later", " or later")):
        plus = True
        base = base[: -len("-or-later")]
    elif low.endswith("-only"):
        base = base[: -len("-only")]
    # exact SPDX id (case-insensitive match against known ids)
    for kid in _known_ids():
        if kid.lower() == base.lower():
            return kid, plus
    hit = _ALIASES.get(_squash(base))
    if hit is None:
        return name, False
    if isinstance(hit, tuple):
        return hit[0], plus or hit[1]
    return hit, plus


def normalize(name: str) -> str:
    """Free-form name → rendered SPDX form."""
    sid, plus = normalize_name(name)
    if not plus:
        if sid in _ONLY_OR_LATER:
            return sid + "-only"
        return sid
    if sid in _ONLY_OR_LATER:
        return sid + "-or-later"
    return sid + "+"
