"""Encode versions as int sequences with scheme-faithful lexicographic order.

The device CVE-match path (trivy_tpu_torch/ops/verscmp.py) compares versions as
flat int32 vectors: ``lexcmp(encode(a), encode(b)) == compare(scheme, a, b)``
for the schemes encoded here (deb, rpm, apk, semver/npm). All ordering
quirks — dpkg's ``~`` sorting before end-of-string, rpm's numeric-beats-
alpha segments and ``^``, apk's pre/post suffixes, semver's prerelease
rules — are folded into token values at encode time, leaving the device a
pure elementwise compare. Schemes not encoded (maven, pep440, gem) fall
back to host comparison in the detector.

Verified against the exact Python comparers by property tests
(tests/test_verscmp.py).
"""

from __future__ import annotations

from trivy_tpu_torch.version import apk as apk_mod, deb as deb_mod, rpm as rpm_mod, semver as semver_mod

# shared numeric-run encoding: [NUM_BASE + ndigits, *digit chars]
NUM_BASE = 2000
MAX_EPOCH = 1 << 20

ENCODABLE = {"deb", "rpm", "apk", "semver", "npm"}


def _digits(run: str) -> list[int]:
    run = run.lstrip("0")
    return [NUM_BASE + len(run)] + [ord(c) for c in run]


# --- deb -------------------------------------------------------------------
# token order within a non-digit run: ~(1) < PAD(2) < END(3) < letters < others
_DEB_PAD = 2
_DEB_END = 3


def _deb_char(c: str) -> int:
    if c == "~":
        return 1
    if c.isalpha():
        return ord(c) + 4
    return ord(c) + 260


def _deb_part(s: str) -> list[int]:
    out: list[int] = []
    i = 0
    while i < len(s) or i == 0:
        # non-digit run (possibly empty), terminated with END
        while i < len(s) and not s[i].isdigit():
            out.append(_deb_char(s[i]))
            i += 1
        out.append(_DEB_END)
        if i >= len(s):
            break
        j = i
        while j < len(s) and s[j].isdigit():
            j += 1
        out.extend(_digits(s[i:j]))
        i = j
        if i >= len(s):
            break
    return out


def encode_deb(v: str) -> list[int]:
    epoch, upstream, revision = deb_mod.parse(v)
    return (
        [min(epoch, MAX_EPOCH)]
        + _deb_part(upstream)
        + _deb_part(revision or "0")
    )


# --- rpm -------------------------------------------------------------------
# segment markers: ~(1) < PAD(2) < ^(3) < ALPHA(4) < NUM(5); alpha chars
# ord+7 with SEG_END(6)
_RPM_PAD = 2


def _rpm_part(s: str) -> list[int]:
    out: list[int] = []
    for seg in rpm_mod._SEG.findall(s):
        if seg == "~":
            out.append(1)
        elif seg == "^":
            out.append(3)
        elif seg[0].isdigit():
            out.append(5)
            out.extend(_digits(seg))
        else:
            out.append(4)
            out.extend(ord(c) + 7 for c in seg)
            out.append(6)
    return out


def encode_rpm(v: str) -> list[int]:
    epoch, version, release = rpm_mod.parse(v)
    out = [min(epoch, MAX_EPOCH)] + _rpm_part(version)
    out.append(_RPM_PAD)  # explicit end of version part
    out.extend(_rpm_part(release))
    return out


# --- apk -------------------------------------------------------------------
# in-band markers: LETTER('' = 1, else ord+2); suffix ranks shifted +10 with
# REV marker = 10 (the bare-version rank)
_APK_REV = 10


def encode_apk(v: str) -> list[int] | None:
    parsed = apk_mod.parse(v)
    if parsed is None:
        # invalid versions use a host-side string-compare fallback whose
        # order a flat encoding cannot reproduce; force the host path
        return None
    nums, letter, suffixes, rev = parsed
    out: list[int] = [1]
    for n in nums:
        out.extend(_digits(str(n)))
    out.append(1 + (ord(letter) - ord("a") + 1 if letter else 0))
    for rank, num in suffixes:
        out.append(rank + _APK_REV)
        out.append(num)
    out.append(_APK_REV)
    out.extend(_digits(str(rev)))
    return out


# --- semver ----------------------------------------------------------------
# core nums as digit runs with trailing zeros stripped (semver zero-pads, so
# "1.2" == "1.2.0"), then NUMS_END(1); NOPRE(3)/PRE(2); ids: numeric
# [1, digits...], alpha [2, ord+4..., CHAR_END(3)]; LIST_END(0)
def encode_semver(v: str) -> list[int]:
    nums, pre = semver_mod.parse(v)
    nums = list(nums)
    while nums and nums[-1] == 0:
        nums.pop()
    out: list[int] = []
    for n in nums:
        out.extend(_digits(str(n)))
    out.append(1)  # NUMS_END: sorts below any NUM_BASE length token
    if not pre:
        out.append(3)
        return out
    out.append(2)
    for pid in pre:
        if pid.isdigit():
            out.append(1)
            out.extend(_digits(pid))
        else:
            out.append(2)
            out.extend(ord(c) + 4 for c in pid)
            out.append(3)
    out.append(0)
    return out


_ENCODERS = {
    "deb": encode_deb,
    "rpm": encode_rpm,
    "apk": encode_apk,
    "semver": encode_semver,
    "npm": encode_semver,
}

_PADS = {"deb": _DEB_PAD, "rpm": _RPM_PAD, "apk": 0, "semver": 0, "npm": 0}


def encode(scheme: str, version: str) -> list[int] | None:
    enc = _ENCODERS.get(scheme)
    if enc is None:
        return None
    try:
        return enc(version)
    except Exception:
        return None


def pad_value(scheme: str) -> int:
    return _PADS.get(scheme, 0)


def encode_batch(scheme: str, versions: list[str], length: int | None = None):
    """-> int32 array [N, L] zero... pad-filled, or None if un-encodable."""
    import numpy as np

    rows = []
    for v in versions:
        r = encode(scheme, v)
        if r is None:
            return None
        rows.append(r)
    L = length or max((len(r) for r in rows), default=1)
    out = np.full((len(rows), L), pad_value(scheme), dtype=np.int32)
    for i, r in enumerate(rows):
        if len(r) > L:
            return None  # caller must re-pad with a larger length
        out[i, : len(r)] = r
    return out
