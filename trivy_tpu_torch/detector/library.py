"""Language-ecosystem vulnerability detection (ref: pkg/detector/library/driver.go).

Ecosystem → (bucket prefix, version scheme) map for advisory lookup by
``"<eco>::"`` bucket prefix; a package is vulnerable when its version
falls in VulnerableVersions (or below a PatchedVersion when only patches
are listed). The fixed version surfaced to the user is the smallest patched
version above the installed one.

A copy of the JAX package's ``trivy_tpu/detector/library.py``. The
constraint checks of a large SBOM run in one call of the
``csrc/verscmp.cu`` kernel against a bound matrix kept resident on the
card (``ops/verscmp.py::check_ops_gather_bucketed``); with ``device="cpu"``
the same call runs the kernel's plain version. Two differences: a device
error fails the scan (the JAX join degrades to the host comparator), and
the scan's counters and span seconds go to the ``stats`` counter the
caller passes, under the JAX package's names.
"""

from __future__ import annotations

import functools
import time
from collections import Counter
from contextlib import contextmanager

from trivy_tpu_torch import faults, log, obs
from trivy_tpu_torch.db import Advisory
from trivy_tpu_torch.device import DEFAULT_DEVICE, resolve
from trivy_tpu_torch.obs import recorder as flight
from trivy_tpu_torch.ops import _build
from trivy_tpu_torch.types import Application, DetectedVulnerability
from trivy_tpu_torch.version import compare, parse_constraints, satisfies
from trivy_tpu_torch.version.compare import Constraint

logger = log.logger("detector:library")

# app type -> (ecosystem bucket prefix, version scheme)
# (ref: driver.go:26-98 NewDriver ecosystem switch)
ECOSYSTEMS: dict[str, tuple[str, str]] = {
    "npm": ("npm", "npm"),
    "node-pkg": ("npm", "npm"),
    "yarn": ("npm", "npm"),
    "pnpm": ("npm", "npm"),
    "bun": ("npm", "npm"),
    "jar": ("maven", "maven"),
    "pom": ("maven", "maven"),
    "gradle-lockfile": ("maven", "maven"),
    "sbt-lockfile": ("maven", "maven"),
    "pip": ("pip", "pep440"),
    "pipenv": ("pip", "pep440"),
    "poetry": ("pip", "pep440"),
    "uv": ("pip", "pep440"),
    "python-pkg": ("pip", "pep440"),
    "gemspec": ("rubygems", "gem"),
    "bundler": ("rubygems", "gem"),
    "cargo": ("cargo", "semver"),
    "rust-binary": ("cargo", "semver"),
    "composer": ("composer", "semver"),
    "composer-vendor": ("composer", "semver"),
    "gomod": ("go", "semver"),
    "gobinary": ("go", "semver"),
    "conan-lock": ("conan", "semver"),
    "mix-lock": ("erlang", "semver"),
    "pubspec-lock": ("pub", "semver"),
    "swift": ("swift", "semver"),
    "cocoapods": ("cocoapods", "semver"),
    "nuget": ("nuget", "semver"),
    "dotnet-core": ("nuget", "semver"),
    "packages-props": ("nuget", "semver"),
    "bitnami": ("bitnami", "semver"),
    "k8s": ("k8s", "semver"),
}


# package count above which the constraint evaluation batches onto device
BATCH_THRESHOLD = 512


@contextmanager
def _span(stats: Counter, name: str):
    """The span ``name`` of the scan's trace context, its seconds also
    added to ``stats[name + ".seconds"]`` (the ``--stats-out`` key)."""
    t0 = time.perf_counter()
    try:
        with obs.span(name):
            yield
    finally:
        stats[f"{name}.seconds"] += time.perf_counter() - t0


def _dispatch_stage(owner, device):
    """``owner``'s :class:`DispatchStage` on ``device`` (its pinned and
    device buffers kept beside the resident bound matrix and reused across
    scans; a dispatch on another device replaces it)."""
    from trivy_tpu_torch.ops.verscmp import DispatchStage

    dev = resolve(device)
    if owner._stage is None or owner._stage.device != dev:
        owner._stage = DispatchStage(dev)
    return owner._stage


def _upload(mat, device, stats: Counter, replaced=None):
    """``mat`` on ``device``; its bytes count as bound-table bytes that
    crossed the link (a warm second scan must count 0) and as resident
    ``cve`` bytes of the HBM ledger, where they take the place of the
    ``replaced`` tensor's."""
    import torch

    dev = torch.from_numpy(mat).to(resolve(device))
    stats["cve.bounds_bytes_uploaded"] += int(mat.nbytes)
    obs.count("cve.bounds_bytes_uploaded", int(mat.nbytes))
    if replaced is not None:
        flight.release_resident("cve", replaced.nbytes)
    flight.note_resident("cve", mat.nbytes)
    return dev


class _CompiledPrefix:
    """Per-prefix constraint tables, parsed and encode-indexed once per DB
    load (SURVEY §7: advisory boundary versions encode once per load; only
    installed versions encode per scan). Constraint rows for every advisory
    live in flat arrays; an advisory owns the contiguous row span
    ``adv_span[id(adv)]`` so per-scan assembly is a vectorized ragged
    gather instead of per-candidate array concatenation."""

    def __init__(self, scheme: str):
        self.scheme = scheme
        self.bounds = None  # np.int32 [n_bounds, L] encoded boundary versions
        self.ops_flat = None  # np.int32 [R] op codes
        self.b_flat = None  # np.int32 [R] bound-matrix rows
        self.glocal_flat = None  # np.int32 [R] local AND-group per row
        # id(adv) -> (row_start, row_end, n_groups, empty_true, host_only)
        self.adv_span: dict[int, tuple] = {}
        self._bounds_dev: tuple | None = None  # (width, device tensor)
        self._stage = None  # the constraint dispatch's buffers (_dispatch_stage)
        self.upload_bytes = 0  # bound-table bytes that crossed the link

    def bounds_device(self, width: int, device, stats: Counter) -> tuple:
        """Device-resident bound matrix at >= ``width`` columns ->
        ``(device tensor, actual width)`` — the static side of the CVE join
        stays on the card across scans. Exactly ONE copy is ever resident: a
        wider request (or one for another device) re-uploads and drops the
        old buffer (a width-keyed cache would pin several padded copies of
        the same matrix for the lifetime of the DB)."""
        import numpy as np

        from trivy_tpu_torch.version.encode import pad_value

        w = max(width, self.bounds.shape[1])
        cached = self._bounds_dev
        if cached is not None and cached[0] >= w and cached[1].device == resolve(device):
            return cached[1], cached[0]
        mat = self.bounds
        if mat.shape[1] < w:
            out = np.full(
                (mat.shape[0], w), pad_value(self.scheme), dtype=np.int32
            )
            out[:, : mat.shape[1]] = mat
            mat = out
        self._bounds_dev = None  # the old buffer frees before the new one lands
        dev = _upload(mat, device, stats, replaced=cached[1] if cached else None)
        self.upload_bytes += mat.nbytes
        self._bounds_dev = (w, dev)
        return dev, w


def _compile_prefix(index: dict, scheme: str) -> "_CompiledPrefix":
    import numpy as np

    from trivy_tpu_torch.ops.verscmp import OPS
    from trivy_tpu_torch.version.encode import encode, pad_value

    cp = _CompiledPrefix(scheme)
    bound_rows: dict[str, int] = {}
    encoded: list[list[int]] = []

    def bound_idx(version: str) -> int | None:
        if version in bound_rows:
            return bound_rows[version]
        r = encode(scheme, version)
        if r is None:
            return None
        bound_rows[version] = len(encoded)
        encoded.append(r)
        return bound_rows[version]

    ops_flat: list[int] = []
    b_flat: list[int] = []
    glocal_flat: list[int] = []

    for advs in index.values():
        for adv in advs:
            if id(adv) in cp.adv_span:
                continue
            groups = _constraint_groups(adv)
            start = len(ops_flat)
            empty_true: tuple[int, ...] = ()
            host_only = False
            for gid, group in enumerate(groups):
                if not group:
                    empty_true += (gid,)
                    continue
                for c in group:
                    bi = bound_idx(c.version)
                    if bi is None:
                        host_only = True
                        break
                    ops_flat.append(OPS[c.op])
                    b_flat.append(bi)
                    glocal_flat.append(gid)
                if host_only:
                    break
            if host_only:
                del ops_flat[start:], b_flat[start:], glocal_flat[start:]
                cp.adv_span[id(adv)] = (0, 0, 0, (), True)
            else:
                cp.adv_span[id(adv)] = (
                    start, len(ops_flat), len(groups), empty_true, False,
                )
    cp.ops_flat = np.asarray(ops_flat, dtype=np.int32)
    cp.b_flat = np.asarray(b_flat, dtype=np.int32)
    cp.glocal_flat = np.asarray(glocal_flat, dtype=np.int32)
    if encoded:
        L = max(len(r) for r in encoded)
        mat = np.full((len(encoded), L), pad_value(scheme), dtype=np.int32)
        for i, r in enumerate(encoded):
            mat[i, : len(r)] = r
        cp.bounds = mat
    return cp




def _constraint_groups(adv: Advisory) -> list[list[Constraint]]:
    """OR-of-AND constraint groups for one advisory (trivy-db stores one
    AND-group per VulnerableVersions entry; patched/fixed-only advisories
    become one all-below-bounds group)."""
    if adv.vulnerable_versions:
        return [g for e in adv.vulnerable_versions for g in parse_constraints(e)]
    bounds = list(adv.patched_versions)
    if adv.fixed_version:
        bounds.extend(x.strip() for x in adv.fixed_version.split(","))
    return [[Constraint("<", _bound_version(b)) for b in bounds]] if bounds else []


def detect(db, app: Application, device=DEFAULT_DEVICE,
           stats: Counter | None = None) -> list[DetectedVulnerability]:
    stats = Counter() if stats is None else stats
    eco = ECOSYSTEMS.get(app.type)
    if eco is None:
        logger.debug("unsupported application type: %s", app.type)
        return []
    prefix, scheme = eco
    # merged pkg->advisories index across every '<eco>::<source>' bucket:
    # one dict probe per package, not one per (package x bucket) — a real
    # trivy-db has dozens of source buckets per ecosystem
    index = (
        db.prefix_advisories(f"{prefix}::")
        if hasattr(db, "prefix_advisories")
        else None
    )

    # host-side hash join: (pkg, advisory) candidate pairs
    candidates: list[tuple] = []
    for pkg in app.packages:
        if not pkg.version:
            continue
        name = _normalize_name(prefix, pkg.name)
        if index is not None:
            for adv in index.get(name, ()):
                candidates.append((pkg, adv))
        else:
            for bucket in db.buckets_with_prefix(f"{prefix}::"):
                for adv in db.get_advisories(bucket, name):
                    candidates.append((pkg, adv))

    verdicts = None
    if len(app.packages) >= BATCH_THRESHOLD:
        compiled = None
        if index is not None:
            from trivy_tpu_torch.version.encode import ENCODABLE

            if scheme in ENCODABLE:
                cache = getattr(db, "_lib_compiled", None)
                if cache is None:
                    cache = {}
                    try:
                        db._lib_compiled = cache
                    except AttributeError:
                        pass
                compiled = cache.get(prefix)
                if compiled is None:
                    compiled = cache[prefix] = _compile_prefix(index, scheme)
        if compiled is not None:
            verdicts = _batch_verdicts_compiled(compiled, candidates, device, stats)
        else:
            verdicts = _batch_verdicts(scheme, candidates, device)

    vulns: list[DetectedVulnerability] = []
    for i, (pkg, adv) in enumerate(candidates):
        vulnerable = (
            verdicts[i]
            if verdicts is not None
            else _is_vulnerable(scheme, pkg.version, adv)
        )
        if vulnerable:
            vulns.append(_finding(scheme, pkg, adv))
    vulns.sort(key=lambda v: (v.pkg_name, v.vulnerability_id, v.pkg_path))
    return vulns


def _finding(
    scheme: str, pkg, adv, fixed_version: str | None = None
) -> DetectedVulnerability:
    return DetectedVulnerability(
        vulnerability_id=adv.vulnerability_id,
        pkg_id=pkg.id,
        pkg_name=pkg.name,
        pkg_path=pkg.file_path,
        pkg_identifier=pkg.identifier,
        installed_version=pkg.version,
        fixed_version=(
            _fixed_version(scheme, pkg.version, adv)
            if fixed_version is None
            else fixed_version
        ),
        status="fixed"
        if (adv.patched_versions or adv.fixed_version)
        else "affected",
        severity=adv.severity or "UNKNOWN",
        data_source=adv.data_source,
        layer=pkg.layer,
    )


def _batch_verdicts_compiled(cp: _CompiledPrefix, candidates: list[tuple], device,
                             stats: Counter) -> list[bool] | None:
    """Device constraint evaluation against the pre-compiled prefix cache:
    advisory bounds are already parsed + encoded, so the per-scan host work
    is one encode per unique installed version, one scalar-append loop over
    candidates, and vectorized ragged gathers for row assembly."""
    import numpy as np

    from trivy_tpu_torch.version.encode import encode, pad_value

    if not candidates:
        return []
    # one encode per unique installed version
    inst_idx: dict[str, int | None] = {}
    inst_rows: list[list[int]] = []

    # per accepted candidate (scalar appends only)
    c_idx: list[int] = []  # candidate index
    c_start: list[int] = []  # flat row span
    c_len: list[int] = []
    c_groups: list[int] = []  # group count
    c_arow: list[int] = []  # installed-version row
    host_pairs: list[int] = []
    n_groups = 0

    for idx, (pkg, adv) in enumerate(candidates):
        span = cp.adv_span.get(id(adv))
        if span is None or span[4]:
            host_pairs.append(idx)
            continue
        start, end, groups, _empty_true, _ = span
        if groups == 0:
            continue  # no constraints -> not vulnerable
        version = pkg.version
        arow = inst_idx.get(version, -1)
        if arow == -1:
            r = encode(cp.scheme, version)
            if r is None:
                inst_idx[version] = None
                host_pairs.append(idx)
                continue
            arow = len(inst_rows)
            inst_idx[version] = arow
            inst_rows.append(r)
        elif arow is None:
            host_pairs.append(idx)
            continue
        c_idx.append(idx)
        c_start.append(start)
        c_len.append(end - start)
        c_groups.append(groups)
        c_arow.append(arow)
        n_groups += groups

    verdicts = [False] * len(candidates)
    if n_groups:
        # empty AND-groups stay True through np.ones + contributing no rows
        # to the logical_and reduction — trivially satisfied
        group_ok = np.ones(n_groups, dtype=bool)
        starts = np.asarray(c_start, dtype=np.int64)
        lens = np.asarray(c_len, dtype=np.int64)
        groups_np = np.asarray(c_groups, dtype=np.int64)
        nz = lens > 0
        if nz.any():
            from trivy_tpu_torch.ops.ragged import ragged_arange
            from trivy_tpu_torch.ops.verscmp import check_ops_gather_bucketed

            rows = ragged_arange(starts[nz], lens[nz])
            # each row's candidate among those with rows
            cand = np.repeat(np.arange(int(nz.sum())), lens[nz])
            # global group id = local group + this candidate's group base
            group_base = np.concatenate(([0], np.cumsum(groups_np)[:-1]))
            row_group = cp.glocal_flat[rows] + group_base[nz][cand]
            La = max(len(r) for r in inst_rows)
            Lb = cp.bounds.shape[1] if cp.bounds is not None else 1
            L = max(La, Lb)
            # width buckets of 8 keep inst widths from fragmenting compiles
            L = -(-L // 8) * 8
            bounds_dev, L = cp.bounds_device(L, device, stats)
            # the dispatch's arrays built straight into its buffer (the indices
            # are in range: "clip" takes them without a buffered copy)
            stage = _dispatch_stage(cp, device)
            inst_mat, a_idx, b_idx, ops = stage.views(len(rows), len(inst_rows), L)
            np.take(cp.ops_flat, rows, out=ops, mode="clip")
            np.take(cp.b_flat, rows, out=b_idx, mode="clip")
            np.take(np.asarray(c_arow, dtype=np.int32)[nz], cand, out=a_idx, mode="clip")
            inst_mat.fill(pad_value(cp.scheme))
            for i, r in enumerate(inst_rows):
                inst_mat[i, : len(r)] = r
            ok = check_ops_gather_bucketed(
                inst_mat, bounds_dev, a_idx, b_idx, ops, stage=stage
            )
            np.logical_and.at(group_ok, row_group, ok)
        # candidate is vulnerable when any of its groups holds
        group_pair = np.repeat(np.asarray(c_idx, dtype=np.int64), groups_np)
        for idx in np.unique(group_pair[group_ok]):
            verdicts[idx] = True
    for idx in host_pairs:
        pkg, adv = candidates[idx]
        verdicts[idx] = _is_vulnerable(cp.scheme, pkg.version, adv)
    return verdicts


# -- one-pass resident SBOM join (ROADMAP item 2, SURVEY §7) ----------------


def _fnv1a(s: str) -> int:
    """64-bit FNV-1a over the utf-8 bytes — the stable (ecosystem, name)
    join hash (the process ``hash()`` is salted per run; the join index
    must be deterministic across scans and processes)."""
    h = 0xCBF29CE484222325
    for b in s.encode("utf-8"):
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def _byte_rows(strs: list[str]) -> tuple:
    """utf-8 byte matrix (zero-padded) + per-row lengths for many strings."""
    import numpy as np

    enc = [s.encode("utf-8") for s in strs]
    n = len(enc)
    if not n:
        return np.zeros((0, 1), dtype=np.uint8), np.zeros(0, dtype=np.int64)
    L = max(max(len(b) for b in enc), 1)
    mat = np.zeros((n, L), dtype=np.uint8)
    lens = np.fromiter((len(b) for b in enc), dtype=np.int64, count=n)
    for i, b in enumerate(enc):
        mat[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
    return mat, lens


def _fnv1a_from_rows(mat, lens):
    """Column-wise vectorized :func:`_fnv1a` over a padded byte matrix."""
    import numpy as np

    h = np.full(len(lens), 0xCBF29CE484222325, dtype=np.uint64)
    prime = np.uint64(0x100000001B3)
    for col in range(mat.shape[1]):
        active = lens > col
        h[active] = (h[active] ^ mat[active, col].astype(np.uint64)) * prime
    return h


def _fnv1a_rows(strs: list[str]):
    """Vectorized :func:`_fnv1a` over many strings: one column-wise pass
    over a padded byte matrix instead of a Python loop per byte (the join
    side of a 100k-package SBOM hashes in milliseconds)."""
    mat, lens = _byte_rows(strs)
    return _fnv1a_from_rows(mat, lens)


class _ResidentJoin:
    """Every ecosystem's constraint tables flattened into ONE set of
    HBM-resident arrays at DB load: a global mixed-scheme bound matrix
    (each row padded with its own scheme's pad value — a row only ever
    compares against a same-scheme bound row, so the schemes can share
    one matrix), global flat op/bound/group tables, and a sorted
    (ecosystem, name)-hash join index with string verification.

    The bound matrix uploads once and stays device-resident across scans
    (widest-only, like :meth:`_CompiledPrefix.bounds_device`); per scan
    only installed-version encodings and int32 gather indices cross the
    link, and a whole SBOM of applications resolves in one staged
    dispatch instead of per-ecosystem dispatches. A ``DBReloader`` hot
    swap installs a fresh db object, hence a fresh join on first use —
    stale bounds cannot leak through a swap, and the old buffers free
    with the old db."""

    def __init__(self, db):
        import numpy as np

        from trivy_tpu_torch.version.encode import ENCODABLE, pad_value

        self.prefixes: dict[str, _CompiledPrefix] = {}
        self.adv_span: dict[int, tuple] = {}
        compiled: list[tuple[str, _CompiledPrefix, dict]] = []
        cache = getattr(db, "_lib_compiled", None)
        if cache is None:
            cache = {}
            try:
                db._lib_compiled = cache
            except AttributeError:
                pass
        for prefix, scheme in sorted(set(ECOSYSTEMS.values())):
            if scheme not in ENCODABLE:
                continue
            index = db.prefix_advisories(f"{prefix}::")
            if not index:
                continue
            cp = cache.get(prefix)
            if cp is None:
                cp = cache[prefix] = _compile_prefix(index, scheme)
            compiled.append((prefix, cp, index))
        Lmax = max(
            (cp.bounds.shape[1] for _p, cp, _i in compiled
             if cp.bounds is not None),
            default=1,
        )
        Lmax = -(-Lmax // 8) * 8
        bound_mats: list[np.ndarray] = []
        pad_parts: list[np.ndarray] = []
        ops_parts: list[np.ndarray] = []
        b_parts: list[np.ndarray] = []
        gl_parts: list[np.ndarray] = []
        slots: list[tuple[str, str, tuple]] = []
        bounds_base = 0
        flat_base = 0
        for prefix, cp, index in compiled:
            self.prefixes[prefix] = cp
            pv = pad_value(cp.scheme)
            nb = cp.bounds.shape[0] if cp.bounds is not None else 0
            mat = np.full((nb, Lmax), pv, dtype=np.int32)
            if nb:
                mat[:, : cp.bounds.shape[1]] = cp.bounds
            bound_mats.append(mat)
            pad_parts.append(np.full(nb, pv, dtype=np.int32))
            ops_parts.append(cp.ops_flat)
            b_parts.append(cp.b_flat + np.int32(bounds_base))
            gl_parts.append(cp.glocal_flat)
            for aid, (start, end, groups, empty_true, host_only) in (
                cp.adv_span.items()
            ):
                self.adv_span[aid] = (
                    start + flat_base, end + flat_base, groups,
                    empty_true, host_only,
                )
            for name, advs in index.items():
                slots.append((prefix, name, tuple(advs)))
            bounds_base += nb
            flat_base += len(cp.ops_flat)
        z32 = np.zeros(0, dtype=np.int32)
        self.bounds = (
            np.concatenate(bound_mats)
            if bounds_base
            else np.zeros((1, Lmax), dtype=np.int32)
        )
        self.row_pad = (
            np.concatenate(pad_parts)
            if bounds_base
            else np.zeros(1, dtype=np.int32)
        )
        self.ops_flat = np.concatenate(ops_parts) if ops_parts else z32
        self.b_flat = np.concatenate(b_parts) if b_parts else z32
        self.glocal_flat = np.concatenate(gl_parts) if gl_parts else z32
        self._slots = slots
        self._key_mat, self._key_len = _byte_rows(
            [p + "\x00" + n for p, n, _a in slots]
        )
        h = _fnv1a_from_rows(self._key_mat, self._key_len)
        self._slot_order = np.argsort(h, kind="stable")
        self._hash_sorted = h[self._slot_order]
        # dense advisory table: slot -> [base, base+count) rows of flat
        # per-advisory span arrays, so candidate assembly is numpy gathers
        # instead of an id()-keyed dict probe per candidate
        slot_base: list[int] = []
        slot_count: list[int] = []
        adv_objs: list = []
        a_start: list[int] = []
        a_len: list[int] = []
        a_groups: list[int] = []
        a_host: list[bool] = []
        for _p, _n, advs in slots:
            slot_base.append(len(adv_objs))
            slot_count.append(len(advs))
            for adv in advs:
                span = self.adv_span[id(adv)]
                adv_objs.append(adv)
                a_host.append(bool(span[4]))
                a_start.append(span[0])
                a_len.append(span[1] - span[0])
                a_groups.append(span[2])
        self.adv_objs = adv_objs
        self.slot_base = np.asarray(slot_base, dtype=np.int64)
        self.slot_count = np.asarray(slot_count, dtype=np.int64)
        self.adv_start = np.asarray(a_start, dtype=np.int64)
        self.adv_len = np.asarray(a_len, dtype=np.int64)
        self.adv_groups = np.asarray(a_groups, dtype=np.int64)
        self.adv_host = np.asarray(a_host, dtype=bool)
        self._bounds_dev: tuple | None = None  # (width, device array)
        self._stage = None  # the constraint dispatch's buffers (_dispatch_stage)
        self.upload_bytes = 0
        self.dispatch_count = 0

    def lookup_slots(self, queries: list[tuple[str, str]]):
        """Vectorized hash join with byte-matrix verification: (prefix,
        normalized name) queries -> slot index per query (-1 = absent).
        Every hash hit verifies against the stored key bytes, so a 64-bit
        collision cannot mis-join; the (rare) multi-candidate hash bucket
        falls back to a per-query string scan."""
        import numpy as np

        out = np.full(len(queries), -1, dtype=np.int64)
        if not queries or not len(self._hash_sorted):
            return out
        qmat, qlens = _byte_rows([p + "\x00" + n for p, n in queries])
        qh = _fnv1a_from_rows(qmat, qlens)
        lo = np.searchsorted(self._hash_sorted, qh, side="left")
        hi = np.searchsorted(self._hash_sorted, qh, side="right")
        single = (hi - lo) == 1
        if single.any():
            qi = np.nonzero(single)[0]
            si = self._slot_order[lo[qi]]
            W = min(self._key_mat.shape[1], qmat.shape[1])
            # equal lengths are <= W when a true match exists, and both
            # matrices zero-pad past the key, so equality on the common
            # width is exact
            ok = self._key_len[si] == qlens[qi]
            ok &= (self._key_mat[si, :W] == qmat[qi, :W]).all(axis=1)
            out[qi[ok]] = si[ok]
        for q in np.nonzero((hi - lo) > 1)[0]:
            p, n = queries[int(q)]
            for j in range(int(lo[q]), int(hi[q])):
                s = int(self._slot_order[j])
                sp, sn, _a = self._slots[s]
                if sp == p and sn == n:
                    out[q] = s
                    break
        return out

    def bounds_device(self, width: int, device, stats: Counter) -> tuple:
        """Widest-only residency over the ONE global matrix -> ``(device
        tensor, actual width)``; widening pads each row with its own
        scheme's pad value. A request for another device re-uploads."""
        import numpy as np

        w = max(-(-int(width) // 8) * 8, self.bounds.shape[1])
        cached = self._bounds_dev
        if cached is not None and cached[0] >= w and cached[1].device == resolve(device):
            return cached[1], cached[0]
        mat = self.bounds
        if mat.shape[1] < w:
            out = np.repeat(self.row_pad[:, None], w, axis=1)
            out[:, : mat.shape[1]] = mat
            mat = out
        self._bounds_dev = None  # the old buffer frees before the new one lands
        dev = _upload(mat, device, stats, replaced=cached[1] if cached else None)
        self.upload_bytes += mat.nbytes
        self._bounds_dev = (w, dev)
        return dev, w


def _resident_join(db) -> "_ResidentJoin | None":
    """The db object's resident join, built on first use and cached for
    the db's lifetime (the static side of the CVE join — SURVEY §7)."""
    if not hasattr(db, "prefix_advisories"):
        return None
    rj = getattr(db, "_lib_resident", None)
    if rj is None:
        rj = _ResidentJoin(db)
        try:
            db._lib_resident = rj
        except AttributeError:
            pass
    return rj


def detect_batch(db, apps: list[Application], device=DEFAULT_DEVICE,
                 stats: Counter | None = None,
                 host_fallback: bool = True) -> list[list[DetectedVulnerability]]:
    """Whole-SBOM detection in ONE pass: every application's packages
    hash-join the resident (ecosystem, name) index together, and every
    candidate's constraints evaluate in a single kernel launch against
    the card-resident global bound matrix — per-ecosystem dispatches and
    per-scan bound re-uploads both collapse. Falls back
    to per-app :func:`detect` when the batch is too small to beat the
    dispatch overhead, an ecosystem never compiled (un-encodable scheme),
    or the db lacks the merged prefix index. A device error in the join
    degrades, as in the JAX package, to the host comparator for every
    candidate pair, counted as ``cve.degraded`` (in ``stats``, the trace
    and the health channel), logged, and marked on the report
    (``obs.note_scan_degraded``, which the JAX package does not call here);
    with ``host_fallback`` off, on ``cuda``, or for a kernel fault it is
    raised (``obs.degrade_or_raise``). On ``cuda`` the ``verscmp`` library
    loads before the join.
    ``stats`` gathers the join's counters and span seconds."""
    import numpy as np

    from trivy_tpu_torch.ops.ragged import ragged_arange

    stats = Counter() if stats is None else stats

    out: list[list[DetectedVulnerability]] = [[] for _ in apps]
    supported: list[tuple] = []
    total = 0
    for ai, app in enumerate(apps):
        eco = ECOSYSTEMS.get(app.type)
        if eco is None:
            logger.debug("unsupported application type: %s", app.type)
            continue
        supported.append((ai, app, eco[0], eco[1]))
        total += len(app.packages)
    if total < BATCH_THRESHOLD or not hasattr(db, "prefix_advisories"):
        for ai, app, _prefix, _scheme in supported:
            out[ai] = detect(db, app, device, stats)
        return out
    rj = _resident_join(db)
    join_apps: list[tuple] = []
    for ai, app, prefix, scheme in supported:
        if prefix in rj.prefixes:
            join_apps.append((ai, app, prefix, scheme))
        else:
            out[ai] = detect(db, app, device, stats)
    if not join_apps:
        return out
    queries: list[tuple[str, str]] = []
    q_app: list[int] = []
    q_pkg: list = []
    q_scheme: list[str] = []
    for ai, app, prefix, scheme in join_apps:
        for pkg in app.packages:
            if not pkg.version:
                continue
            queries.append((prefix, _normalize_name(prefix, pkg.name)))
            q_app.append(ai)
            q_pkg.append(pkg)
            q_scheme.append(scheme)
    with _span(stats, "cve.join"):
        slot_idx = rj.lookup_slots(queries)
        hit = np.nonzero(slot_idx >= 0)[0]
        counts = rj.slot_count[slot_idx[hit]]
        nz = counts > 0
        hit, counts = hit[nz], counts[nz]
        # candidate (pkg, advisory) pairs as two parallel index arrays:
        # query index and dense advisory row
        cand_q = np.repeat(hit, counts)
        cand_adv = (
            ragged_arange(rj.slot_base[slot_idx[hit]], counts)
            if len(hit)
            else np.zeros(0, dtype=np.int64)
        )
    stats["cve.candidate_pairs"] += int(len(cand_q))
    if resolve(device).type == "cuda":
        _build.preload("verscmp")  # a kernel that cannot load fails here
    try:
        verdicts = _resident_verdicts(rj, cand_q, cand_adv, q_pkg, q_scheme, hit,
                                      device, stats)
    except Exception as e:
        # the device leg failed: the host comparator is the parity oracle
        obs.degrade_or_raise(e, device=resolve(device), host_fallback=host_fallback,
                             counter="cve.degraded", logger=logger,
                             message="resident CVE join failed (%s); degrading to the host "
                                     "comparator for this batch")
        stats["cve.degraded"] += 1
        verdicts = np.fromiter(
            (_is_vulnerable(q_scheme[q], q_pkg[q].version, rj.adv_objs[a])
             for q, a in zip(cand_q, cand_adv)),
            dtype=bool, count=len(cand_q),
        )
    # fixed-version strings repeat heavily across a large SBOM (same
    # advisory hit at the same installed version by many packages): one
    # computation per unique (advisory, scheme, version) triple
    fv_cache: dict[tuple, str] = {}
    for i in np.nonzero(verdicts)[0]:
        q = int(cand_q[i])
        adv = rj.adv_objs[int(cand_adv[i])]
        pkg = q_pkg[q]
        scheme = q_scheme[q]
        k = (id(adv), scheme, pkg.version)
        fv = fv_cache.get(k)
        if fv is None:
            fv = fv_cache[k] = _fixed_version(scheme, pkg.version, adv)
        out[q_app[q]].append(_finding(scheme, pkg, adv, fv))
    for ai, _app, _prefix, _scheme in join_apps:
        out[ai].sort(
            key=lambda v: (v.pkg_name, v.vulnerability_id, v.pkg_path)
        )
    return out


def _resident_verdicts(
    rj: _ResidentJoin, cand_q, cand_adv, q_pkg: list, q_scheme: list[str],
    hit_queries, device, stats: Counter,
):
    """:func:`_batch_verdicts_compiled` generalized over the one flattened
    table, with the per-candidate Python loop replaced by numpy gathers:
    one encode per unique (scheme, installed version), mixed-scheme rows
    in a single set (each padded with its own scheme's pad value), and the
    whole SBOM's constraints in ONE staged device dispatch."""
    import numpy as np

    from trivy_tpu_torch.ops.ragged import ragged_arange
    from trivy_tpu_torch.version.encode import encode, pad_value

    verdicts = np.zeros(len(cand_q), dtype=bool)
    if not len(cand_q):
        return verdicts
    # one encode per unique (scheme, installed version); -1 = unencodable
    inst_rows: list[list[int]] = []
    inst_pad: list[int] = []
    memo: dict[tuple, int] = {}
    inst_of_q = np.full(len(q_pkg), -1, dtype=np.int64)
    for q in hit_queries:
        q = int(q)
        key = (q_scheme[q], q_pkg[q].version)
        r = memo.get(key)
        if r is None:
            enc = encode(key[0], key[1])
            if enc is None:
                r = -1
            else:
                r = len(inst_rows)
                inst_rows.append(enc)
                inst_pad.append(pad_value(key[0]))
            memo[key] = r
        inst_of_q[q] = r
    a_row = inst_of_q[cand_q]
    host = rj.adv_host[cand_adv] | (a_row < 0)
    dev = np.nonzero(~host)[0]
    if len(dev) and inst_rows:
        starts = rj.adv_start[cand_adv[dev]]
        lens = rj.adv_len[cand_adv[dev]]
        groups_np = rj.adv_groups[cand_adv[dev]]
        gz = groups_np > 0  # no constraint groups -> not vulnerable
        dev, starts, lens, groups_np = (
            dev[gz], starts[gz], lens[gz], groups_np[gz],
        )
        n_groups = int(groups_np.sum())
        if n_groups:
            # empty AND-groups stay True through np.ones + contributing no
            # rows to the logical_and reduction — trivially satisfied
            group_ok = np.ones(n_groups, dtype=bool)
            nz = lens > 0
            if nz.any():
                from trivy_tpu_torch.ops.verscmp import check_ops_gather_bucketed

                rows = ragged_arange(starts[nz], lens[nz])
                # each row's candidate among those with rows
                cand = np.repeat(np.arange(int(nz.sum())), lens[nz])
                group_base = np.concatenate(([0], np.cumsum(groups_np)[:-1]))
                row_group = rj.glocal_flat[rows] + group_base[nz][cand]
                La = max(len(r) for r in inst_rows)
                bounds_dev, L = rj.bounds_device(La, device, stats)
                # the dispatch's arrays built straight into its buffer (the
                # indices are in range: "clip" takes them without a buffered copy)
                stage = _dispatch_stage(rj, device)
                inst_mat, a_idx, b_idx, ops = stage.views(len(rows), len(inst_rows), L)
                np.take(rj.ops_flat, rows, out=ops, mode="clip")
                np.take(rj.b_flat, rows, out=b_idx, mode="clip")
                np.take(a_row[dev][nz], cand, out=a_idx, mode="clip")
                inst_mat[:] = np.asarray(inst_pad, dtype=np.int32)[:, None]
                for i, r in enumerate(inst_rows):
                    inst_mat[i, : len(r)] = r
                faults.check("device.dispatch", key="cve")
                rj.dispatch_count += 1
                stats["cve.dispatch_count"] += 1
                stats["cve.resident_rows"] += int(len(ops))
                obs.count("cve.resident_rows", int(len(ops)))
                with _span(stats, "cve.dispatch"):
                    ok = check_ops_gather_bucketed(
                        inst_mat, bounds_dev, a_idx, b_idx, ops, stage=stage
                    )
                np.logical_and.at(group_ok, row_group, np.asarray(ok))
            # a candidate is vulnerable when ANY of its AND-groups holds
            group_cand = np.repeat(np.arange(len(dev)), groups_np)
            vuln = np.zeros(len(dev), dtype=bool)
            np.logical_or.at(vuln, group_cand[group_ok], True)
            verdicts[dev[vuln]] = True
    for i in np.nonzero(host)[0]:
        q = int(cand_q[i])
        verdicts[i] = _is_vulnerable(
            q_scheme[q], q_pkg[q].version, rj.adv_objs[int(cand_adv[i])]
        )
    return verdicts


def _batch_verdicts(scheme: str, candidates: list[tuple], device) -> list[bool] | None:
    """Evaluate every (pkg, advisory) pair's constraints in one device call.

    Builds flat (installed, boundary, op) rows with group indices, runs
    trivy_tpu_torch.ops.verscmp_cuda.check_ops once, then reduces AND within groups
    and OR across groups host-side. Returns None (host fallback) when any
    version fails to encode for the scheme.
    """
    import numpy as np

    from trivy_tpu_torch.version.encode import ENCODABLE, encode_batch, pad_value

    if scheme not in ENCODABLE or not candidates:
        return None

    import torch

    from trivy_tpu_torch.ops.verscmp import OPS
    from trivy_tpu_torch.ops.verscmp_cuda import check_ops

    rows_a: list[str] = []  # installed version per constraint row
    rows_b: list[str] = []  # boundary version
    rows_op: list[int] = []
    row_group: list[int] = []  # AND-group id per row
    group_pair: list[int] = []  # candidate index per AND-group
    group_empty_true: list[bool] = []

    n_groups = 0
    pair_has_group: list[list[int]] = []
    for idx, (pkg, adv) in enumerate(candidates):
        groups_for_pair: list[int] = []
        parsed = _constraint_groups(adv)
        for group in parsed:
            gid = n_groups
            n_groups += 1
            groups_for_pair.append(gid)
            group_pair.append(idx)
            group_empty_true.append(len(group) == 0)
            for c in group:
                rows_a.append(pkg.version)
                rows_b.append(c.version)
                rows_op.append(OPS[c.op])
                row_group.append(gid)
        pair_has_group.append(groups_for_pair)

    if not rows_a:
        return [False] * len(candidates)
    enc_a = encode_batch(scheme, rows_a)
    enc_b = encode_batch(scheme, rows_b)
    if enc_a is None or enc_b is None:
        return None
    L = max(enc_a.shape[1], enc_b.shape[1])
    pv = pad_value(scheme)

    dev = resolve(device)

    def widen(x):
        if x.shape[1] != L:
            out = np.full((x.shape[0], L), pv, dtype=np.int32)
            out[:, : x.shape[1]] = x
            x = out
        return torch.from_numpy(x).to(dev)

    ops = torch.from_numpy(np.asarray(rows_op, dtype=np.int32)).to(dev)
    ok = check_ops(widen(enc_a), widen(enc_b), ops).cpu().numpy()
    group_ok = np.ones(n_groups, dtype=bool)
    np.logical_and.at(group_ok, np.asarray(row_group), ok)
    for gid, empty in enumerate(group_empty_true):
        if empty:
            group_ok[gid] = True
    verdicts = [False] * len(candidates)
    for gid, idx in enumerate(group_pair):
        if group_ok[gid]:
            verdicts[idx] = True
    return verdicts


def _normalize_name(ecosystem: str, name: str) -> str:
    """Per-ecosystem package-name normalization (ref: each comparer's
    normalization: pip lowercases and folds -_. runs, maven uses g:a)."""
    if ecosystem == "pip":
        import re

        return re.sub(r"[-_.]+", "-", name).lower()
    if ecosystem == "rubygems":
        return name
    return name


def _is_vulnerable(scheme: str, installed: str, adv: Advisory) -> bool:
    if adv.vulnerable_versions:
        # trivy-db stores one constraint AND-group per entry; entries OR
        return satisfies(scheme, installed, " || ".join(adv.vulnerable_versions))
    # only patched/fixed listed: vulnerable when below every patched version
    bounds = list(adv.patched_versions)
    if adv.fixed_version:
        bounds.extend(x.strip() for x in adv.fixed_version.split(","))
    if not bounds:
        return False
    return all(
        not satisfies(scheme, installed, b)
        and compare(scheme, installed, _bound_version(b)) < 0
        for b in bounds
    )


@functools.lru_cache(maxsize=65536)
def _bound_version(expr: str) -> str:
    # memoized: a big SBOM resolves the same patched-version strings tens
    # of thousands of times while building findings
    groups = parse_constraints(expr)
    for g in groups:
        for c in g:
            return c.version
    return expr


def _fixed_version(scheme: str, installed: str, adv: Advisory) -> str:
    candidates = []
    for b in adv.patched_versions or []:
        candidates.append(_bound_version(b))
    if adv.fixed_version:
        candidates.extend(x.strip() for x in adv.fixed_version.split(","))
    ups = [c for c in candidates if compare(scheme, c, installed) > 0]
    if ups:
        return sorted(ups, key=lambda v: _sort_key(scheme, v, ups))[0]
    return ", ".join(candidates)


def _sort_key(scheme, v, all_versions):
    # total order via pairwise compares (small candidate lists)
    return sum(1 for o in all_versions if compare(scheme, o, v) < 0)
