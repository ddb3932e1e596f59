"""Command line of the port: the ``fs`` secret and license scans and the
``sbom`` vulnerability scan.

    python -m trivy_tpu_torch fs [--scanners secret|license|secret,license]
        [--license-full] [--no-shared-arena] [--secret-config F]
        [--format json|table] [-o OUT] [--device cuda|cpu]
        [--no-secret-dedup] [--secret-dedup-mb N]
        [--secret-hit-cache [--cache-dir D] [--cache-backend fs|memory]]
        [--secret-compress auto|on|off | --no-secret-compress]
        [--secret-compress-min-ratio R] <dir>
    python -m trivy_tpu_torch sbom [--db-repository DIR] [--cache-dir D]
        [--format json|table] [-o OUT] [--stats-out F] [--device cuda|cpu] <bom>

Runs on the card unless ``--device cpu`` is given, and fails when CUDA is
asked for and missing. Its JSON ``Results`` equal those of
``python -m trivy_tpu.cli fs --scanners <same> [--license-full] --backend cpu
--format json`` on the same tree, under every feed option. The options
carry the meanings and defaults of the JAX package's flags of the same
names: with both scanners, the secret feed's rows also run the license gram
gate (the fused pass) unless ``--no-shared-arena`` is given, and
``--license-full`` adds source-file headers to the license files.

``sbom`` matches a CycloneDX (plain or in an in-toto attestation) or SPDX
(JSON or tag-value) document against the advisory DB of ``--db-repository``
or else ``<cache-dir>/db``; its JSON ``Results`` and ``Metadata`` equal
those of ``python -m trivy_tpu.cli sbom --format json`` with the same DB.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import time
from collections import Counter

from trivy_tpu_torch import log
from trivy_tpu_torch.cache import BACKENDS, new_cache
from trivy_tpu_torch.db import load_default_db
from trivy_tpu_torch.detector import detect_all
from trivy_tpu_torch.device import DEFAULT_DEVICE, resolve
from trivy_tpu_torch.fanal.applier import apply_layers
from trivy_tpu_torch.fanal.license import LicenseAnalyzer
from trivy_tpu_torch.fanal.secret import SecretAnalyzer
from trivy_tpu_torch.fanal.walker import FSWalker, WalkOption
from trivy_tpu_torch.licensing.fused import FusedLicenseGate
from trivy_tpu_torch.licensing.scanner import LicenseCategorizer
from trivy_tpu_torch.report import WRITERS
from trivy_tpu_torch.sbom import detect_format
from trivy_tpu_torch.sbom.decode import decode
from trivy_tpu_torch.types import DetectedVulnerability, Report, Result, ResultClass

logger = log.logger("cli")

DEFAULT_SECRET_CONFIG = "trivy-secret.yaml"
SCANNERS = ("secret", "license")
# the CVE join's counters in an sbom scan's counters (the JAX package's names)
CVE_COUNTERS = ("cve.bounds_bytes_uploaded", "cve.resident_rows", "cve.dispatch_count",
                "cve.candidate_pairs", "cve.join.seconds", "cve.dispatch.seconds")


def license_result(files) -> list[Result]:
    """The ``Loose File License(s)`` section of a report from the license
    analyzers' ``LicenseFile``s, sorted as the JAX package's layer applier
    sorts them (ref: pkg/scanner/local/scan.go)."""
    cat = LicenseCategorizer()
    found = []
    for lf in sorted(files, key=lambda lf: (lf.file_path, lf.pkg_name, lf.type)):
        for f in lf.findings:
            d = cat.detect(f.name, file_path=lf.file_path)
            d.confidence = f.confidence
            d.link = f.link
            found.append(d)
    if not found:
        return []
    return [Result(target="Loose File License(s)", cls=ResultClass.LICENSE_FILE.value,
                   licenses=found)]


def scan_fs(root: str, config_path: str | None = None, device=DEFAULT_DEVICE,
            skip_dirs=(), skip_files=(), scanners=("secret",), license_full: bool = False,
            shared_arena: bool = True, **scanner_opts) -> tuple[Report, dict]:
    """Scan the tree under ``root`` with ``scanners`` (``secret``,
    ``license`` or both). Returns the report and the scan's counters (files
    walked and scanned, seconds, the secret scanner's feed counters, and
    the fused gate's file counts). With both scanners and ``shared_arena``,
    the license gram gate rides the secret feed's rows. ``scanner_opts``
    reach the :class:`~trivy_tpu_torch.secret.scanner.TorchSecretScanner`."""
    unknown = set(scanners) - set(SCANNERS)
    if unknown or not scanners:
        raise ValueError(f"unsupported scanners {sorted(unknown) or scanners!r}: "
                         f"use {', '.join(SCANNERS)}")
    t0 = time.perf_counter()
    gate = None
    if "secret" in scanners and "license" in scanners and shared_arena:
        gate = FusedLicenseGate(license_full=license_full)
    analyzers: list = []
    secret = None
    if "secret" in scanners:
        secret = SecretAnalyzer(root, config_path=config_path, device=device,
                                license_gate=gate, **scanner_opts)
        analyzers.append(secret)
    if "license" in scanners:
        kinds = ("license-file", "header") if license_full else ("license-file",)
        analyzers += [LicenseAnalyzer(k, device, gate=gate) for k in kinds]
    walker = FSWalker(WalkOption(skip_files=list(skip_files), skip_dirs=list(skip_dirs)))
    walked = scanned = 0
    try:
        for rel, info, opener in walker.walk(root):
            walked += 1
            takers = [a for a in analyzers if a.required(rel, info.size)]
            if not takers:
                continue
            try:
                content = opener()
            except OSError as e:
                # the file vanished or turned unreadable after the walk
                logger.debug("skipping unreadable %s: %s", rel, e)
                continue
            scanned += 1
            for a in takers:
                if a is secret:
                    a.collect(rel, content, dir_=root)
                else:
                    a.collect(rel, content)
        # the secret finalize first: the fused gate is complete only then
        secrets = secret.finalize() if secret is not None else []
        licenses = [lf for a in analyzers if a is not secret for lf in a.finalize()]
    except BaseException:
        if secret is not None:
            secret.abort()
        raise
    name = root if root == os.path.sep else root.rstrip(os.path.sep)
    results = [Result(target=s.file_path, secrets=s.findings) for s in secrets]
    if "license" in scanners:
        results += license_result(licenses)
    report = Report(
        created_at=datetime.datetime.now(datetime.timezone.utc).isoformat(),
        artifact_name=name,
        artifact_type="filesystem",
        metadata={"ImageID": "", "DiffIDs": []},
        results=results,
    )
    counters = {"files_walked": walked, "files_scanned": scanned,
                "seconds": time.perf_counter() - t0}
    if secret is not None:
        counters.update(secret.scanner.stats.snapshot())
    if gate is not None:
        counters.update(files_covered=gate.files_covered, files_flagged=gate.files_flagged,
                        files_patched=gate.files_patched)
    return report, counters


def load_db(db_repository: str | None = None, cache_dir: str | None = None):
    """The advisory DB of ``db_repository``, else ``<cache_dir>/db`` (a
    ``trivy.db`` there is flattened on first use); None, with a warning,
    when neither holds one."""
    db = load_default_db(db_repository, cache_dir)
    if db is None:
        logger.warning("vulnerability DB not available; skipping vuln detection")
    return db


def dedup_sorted(vulns: list[DetectedVulnerability]) -> list[DetectedVulnerability]:
    """One finding per (ID, package, path, installed version), in the
    report's order (ref: pkg/result/filter.go:77-120)."""
    seen = set()
    out = []
    for v in sorted(vulns, key=lambda v: (v.pkg_name, v.vulnerability_id, v.pkg_path,
                                          v.fixed_version)):
        key = (v.vulnerability_id, v.pkg_name, v.pkg_path, v.installed_version)
        if key not in seen:
            seen.add(key)
            out.append(v)
    return out


def scan_sbom(path: str, db=None, device=DEFAULT_DEVICE, db_repository: str | None = None,
              cache_dir: str | None = None) -> tuple[Report, dict]:
    """Match the SBOM at ``path`` against the advisory DB: ``db`` when
    given (a loaded DB keeps its resident join across scans), else the one
    :func:`load_db` finds. Returns the report and the scan's counters: the
    join's (``cve.*``, under the JAX package's names), the seconds of the
    decode, the detection and the whole scan, and, when this call loaded
    the DB, ``db_load_seconds`` (not part of ``seconds``)."""
    dev = resolve(device)
    stats: Counter = Counter()
    if db is None:
        t0 = time.perf_counter()
        db = load_db(db_repository, cache_dir)
        stats["db_load_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with open(path, "rb") as f:
        data = f.read()
    fmt = detect_format(data)
    detail = apply_layers([decode(data)])
    t1 = time.perf_counter()
    results = detect_all(db, path, detail, dev, stats) if db is not None else []
    t2 = time.perf_counter()
    for r in results:
        r.vulnerabilities = dedup_sorted(r.vulnerabilities)
    metadata = {"ImageID": "", "DiffIDs": []}
    if detail.os is not None:
        metadata["OS"] = detail.os.to_dict()
    report = Report(
        created_at=datetime.datetime.now(datetime.timezone.utc).isoformat(),
        artifact_name=path,
        artifact_type="spdx" if fmt.startswith("spdx") else "cyclonedx",
        metadata=metadata,
        results=[r for r in results if not r.is_empty],
    )
    stats.update({
        "components": len(detail.packages) + sum(len(a.packages) for a in detail.applications),
        "decode.seconds": t1 - t0, "detect.seconds": t2 - t1,
        "seconds": time.perf_counter() - t0,
    })
    return report, {**dict.fromkeys(CVE_COUNTERS, 0), **stats}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="trivy_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)
    sb = sub.add_parser("sbom", help="scan an SBOM (CycloneDX/SPDX) for vulnerabilities")
    sb.add_argument("target", help="SBOM file")
    sb.add_argument("--db-repository", default=None,
                    help="advisory DB directory (default: <cache-dir>/db)")
    sb.add_argument("--cache-dir", default=None, help="cache directory")
    sb.add_argument("-f", "--format", choices=sorted(WRITERS), default="table")
    sb.add_argument("-o", "--output", default="", help="output file (default stdout)")
    sb.add_argument("--device", choices=["cuda", "cpu"], default=DEFAULT_DEVICE)
    sb.add_argument("--stats-out", default="",
                    help="write the scan's counters (components, seconds, the CVE join's "
                         "rows, dispatches and bound bytes uploaded) as JSON")
    sb.add_argument("-q", "--quiet", action="store_true")
    fs = sub.add_parser("fs", help="scan a local filesystem for secrets and licenses")
    fs.add_argument("target", help="directory to scan")
    fs.add_argument("--scanners", default="secret",
                    help="comma-separated scanners: secret, license")
    fs.add_argument("--license-full", action="store_true",
                    help="also classify source-file headers, not only license files")
    fs.add_argument("--no-shared-arena", action="store_true",
                    help="with both scanners, classify every license candidate instead of "
                         "gating them on the secret feed's rows")
    fs.add_argument("--secret-config", default=DEFAULT_SECRET_CONFIG,
                    help="secret rule config (YAML); used when the file exists")
    fs.add_argument("-f", "--format", choices=sorted(WRITERS), default="table")
    fs.add_argument("-o", "--output", default="", help="output file (default stdout)")
    fs.add_argument("--device", choices=["cuda", "cpu"], default=DEFAULT_DEVICE)
    fs.add_argument("--skip-dirs", action="append", default=[],
                    help="glob of directories to skip (repeatable)")
    fs.add_argument("--skip-files", action="append", default=[],
                    help="glob of files to skip (repeatable)")
    fs.add_argument("--stats-out", default="",
                    help="write the scan's counters (files, seconds, rows, dedup and "
                         "wire bytes) as JSON")
    fs.add_argument("--no-secret-dedup", action="store_true",
                    help="disable the chunk-dedup hit cache on the device feed")
    fs.add_argument("--secret-dedup-mb", type=int, default=0,
                    help="byte budget (MB) for the in-process dedup hit-store LRU "
                         "(0 = default 32; the bound is bytes, not entries, so "
                         "streaming scans keep flat RSS)")
    fs.add_argument("--secret-hit-cache", action="store_true",
                    help="persist chunk hit vectors in the scan cache backend for "
                         "cross-scan dedup")
    fs.add_argument("--cache-dir", default=None, help="cache directory")
    fs.add_argument("--cache-backend", choices=BACKENDS, default="fs",
                    help="scan cache backend")
    fs.add_argument("--secret-compress", choices=["auto", "on", "off"], default=None,
                    help="compressed slab wire format on the device feed: auto (on "
                         "for the card, off for --device cpu), on, off")
    fs.add_argument("--no-secret-compress", action="store_true",
                    help="ship raw slabs unconditionally (shorthand for "
                         "--secret-compress off)")
    fs.add_argument("--secret-compress-min-ratio", type=float, default=None,
                    help="per-batch wire budget as a fraction of the raw slab: a "
                         "batch that can't compress below this ships raw (default "
                         "0.875, the 7-bit-packing line)")
    fs.add_argument("-q", "--quiet", action="store_true")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    log.init(quiet=args.quiet)
    if args.command == "sbom":
        report, counters = scan_sbom(args.target, device=args.device,
                                     db_repository=args.db_repository, cache_dir=args.cache_dir)
    else:
        report, counters = _run_fs(args)
    if args.stats_out:
        with open(args.stats_out, "w", encoding="utf-8") as f:
            json.dump(counters, f, indent=2)
    write = WRITERS[args.format]
    if args.output:
        with open(args.output, "w", encoding="utf-8") as f:
            write(report, f)
    else:
        write(report, sys.stdout)
    return 0


def _run_fs(args) -> tuple[Report, dict]:
    scanners = [s for s in args.scanners.split(",") if s]
    if not scanners or set(scanners) - set(SCANNERS):
        raise SystemExit(f"unsupported --scanners {args.scanners!r}: use {', '.join(SCANNERS)}")
    config = args.secret_config if os.path.exists(args.secret_config) else None
    return scan_fs(
        args.target, config_path=config, device=args.device,
        skip_dirs=args.skip_dirs, skip_files=args.skip_files, scanners=scanners,
        license_full=args.license_full, shared_arena=not args.no_shared_arena,
        dedup=not args.no_secret_dedup,
        hit_cache=(new_cache(args.cache_backend, args.cache_dir)
                   if args.secret_hit_cache else None),
        hit_cache_bytes=max(0, args.secret_dedup_mb) << 20,
        # --no-secret-compress is the loud opt-out shorthand
        compress="off" if args.no_secret_compress else (args.secret_compress or ""),
        compress_min_ratio=args.secret_compress_min_ratio or 0.0,
    )


if __name__ == "__main__":
    sys.exit(main())
