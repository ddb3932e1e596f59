"""Command line of the port: the ``fs``, ``rootfs`` and ``repo``
vulnerability, misconfiguration, secret and license scans, full or
incremental, the ``watch`` loop over a directory, the ``image`` scan of an
image archive, registry or daemon image, the ``vm`` scan of a disk image,
the ``sbom`` vulnerability scan, ``convert`` of a saved JSON report, the
``k8s`` scan of Kubernetes workloads, and the JAX CLI's ``clean``,
``plugin`` and ``version``.

    python -m trivy_tpu_torch fs [--scanners vuln,misconfig,secret,license]
        [--db-repository DIR] [--cache-dir D] [--java-db DIR] [--list-all-pkgs]
        [--license-full] [--no-shared-arena] [--secret-config F]
        [--config-check F|DIR,..] [--misconfig-scanners dockerfile,terraform,..]
        [--severity S,..] [--ignorefile F] [--ignore-policy F.py|F.rego]
        [--vex DOC|repo ..] [--show-suppressed] [--exit-code N] [-c CONFIG]
        [--compliance docker-cis-1.6.0|k8s-nsa-1.0|..|@SPEC.yaml]
        [--format FORMAT] [-t TEMPLATE|@FILE] [--dependency-tree] [-o OUT]
        [--device cuda|cpu] [--backend auto|pallas|xla|cpu] [-d] [--log-format plain|json]
        [--skip-db-update] [--offline-scan]
        [--no-secret-dedup] [--secret-dedup-mb N] [--secret-hit-cache]
        [--cache-backend fs|memory|redis://H:P|rediss://H:P] [--cache-ttl S]
        [--redis-ca F] [--redis-cert F] [--redis-key F] [--redis-insecure]
        [--secret-compress auto|on|off | --no-secret-compress]
        [--secret-compress-min-ratio R] [--parallel N] [--secret-streams N]
        [--secret-inflight N] [--secret-arena-slabs N] [--secret-bucket-rungs N]
        [--no-secret-pack] [--no-secret-prefilter] [--tuning-file F]
        [--tune [--tuning-interval S]] [--server URL [--token T]]
        [--fleet H:P,.. [--fleet-inflight N] [--fleet-shards-per-replica N]
         [--fleet-speculate X] [--fleet-split-threshold X]
         [--fleet-telemetry-interval S] [--fleet-register-token T]]
        [--incremental] [--since-last] [--diff-base <commit-ish>]
        [--stats-out F] <dir>
    python -m trivy_tpu_torch rootfs [the fs flags] <dir>
    python -m trivy_tpu_torch repo [the fs flags]
        [--branch B | --tag T | --commit C] (<url> | <dir>)
    python -m trivy_tpu_torch watch [the fs flags but --server, --token, the fleet
        and the incremental ones] [--watch-interval S] [--watch-count N] <dir>
    python -m trivy_tpu_torch image [the fs flags] [--diff-base <image>]
        [--image-src docker,containerd,podman,remote] [--docker-host H]
        [--podman-host H] [--containerd-host H] [--platform OS/ARCH]
        [--insecure] [--username U] [--password P]
        (<archive> | <image ref> | docker://<ref> | --input <archive>)
    python -m trivy_tpu_torch vm [the fs flags but the fleet ones] <disk>
    python -m trivy_tpu_torch sbom [--scanners vuln[,secret][,license]]
        [--skip-dirs D] [--skip-files F] [--parallel N] [--no-host-fallback]
        [--db-repository DIR] [--cache-dir D] [--list-all-pkgs]
        [report flags as above] [--server URL [--token T]]
        [--format FORMAT] [-o OUT] [--stats-out F] [--device cuda|cpu] <bom>
    python -m trivy_tpu_torch server [--listen HOST:PORT] [--token T]
        [--token-header H] [--db-repository DIR] [--cache-dir D]
        [--max-concurrent-scans N [admission flags]] [--device cuda|cpu]
    python -m trivy_tpu_torch convert [report flags as above] <report.json>
    python -m trivy_tpu_torch k8s [--manifests FILE|DIR | --context CTX]
        [--format table|json] [-o OUT] [--scan-images [--insecure]
        [--db-repository DIR]] [--compliance SPEC] [--device cuda|cpu]
    python -m trivy_tpu_torch debug <bundle.json.gz>
    python -m trivy_tpu_torch clean (--all | --scan-cache | --vuln-db) [--cache-dir D]
    python -m trivy_tpu_torch plugin (install <dir|archive> | list | run <name> [args]
        | uninstall <name>)
    python -m trivy_tpu_torch version [--format text|json]

``FORMAT`` is any of the JAX CLI's nine: ``table`` (the default; with
``--dependency-tree`` the reversed dependency tree of each vulnerable
package), ``json``, ``sarif``, ``cyclonedx``, ``spdx`` (tag-value),
``spdx-json``, ``github`` (a dependency snapshot), ``template`` (``-t``, a
Go-template subset or ``@file``) and ``cosign-vuln``. ``--dependency-tree``
and the SBOM and snapshot formats scan the whole package inventory, as
``--list-all-pkgs`` does. ``convert`` reads a JSON report, filters it and
writes it in the format asked for, as the JAX ``convert`` does; it touches
no device.

Every command can trace itself as the JAX CLI does: ``--trace`` prints the
span table, the stall verdict and the hottest rules after the scan;
``--trace-out F`` (Chrome trace JSON, Perfetto-loadable), ``--metrics-out
F``, ``--profile-out F`` and ``--timeseries-out F`` write the documents of
``obs/export.py`` (a ``.gz`` path gzips); ``--live`` prints a progress line
on stderr; ``--telemetry-interval S`` sets the sampler's cadence (0: off).
``--trace``, any of the exports or ``--live`` starts the sampler thread,
unless the interval is 0; without them no sampler starts and no file is
written.

Every command takes the JAX CLI's failure flags. ``--fault-inject SPEC``
arms the fault-injection harness (``faults.py``; a bad spec exits 2) for the
command and disarms it after. A device error the scan ladder cannot absorb
finishes the scan on the exact host path and marks the report
``"Degraded": true``, logged and counted in ``--stats-out``
(``degraded``, ``scan.degraded``, ``license.degraded``, ``cve.degraded``,
beside ``batch_retries`` and ``batch_splits``); with
``--no-host-fallback`` it fails the command instead. A kernel that cannot
be built, loaded or launched always fails it. ``--debug-dir D`` writes a
diagnostic bundle on a terminal failure or a degraded completion, which
``debug <bundle>`` renders. ``--timeout S`` (default 300; 0: none) ends a
scan that runs longer with exit code 1 (the alarm is a signal: on a thread
other than the main one ``main`` sets none).

The feed's knobs resolve into one
:class:`~trivy_tpu_torch.tuning.TuningConfig` per scan command (command
line, then ``TRIVY_TPU_*``, then an autotune record of ``--tuning-file`` or
``./AUTOTUNE.json``, then the default), which every export carries as its
``tuning`` block: the transfer streams, windows, arena and bucket ladder of
the secret feed, and ``--parallel``, the read-ahead workers of ``fs``,
``rootfs`` and ``repo`` (``image`` analyzes that many layers at once).
``--tune`` starts the online controller. ``--cache-backend`` takes a
``redis://`` or ``rediss://`` URL, a cache that degrades to memory when the
server dies, and marks the report ``CacheDegraded``.

Runs on the card unless ``--device cpu`` is given, and fails when CUDA is
asked for and missing; without ``--device``, ``--backend cpu`` (the JAX
flag) runs on the CPU and its other values on the card. ``-d`` logs debug
lines, ``--log-format json`` one JSON object per line with the scan's
``trace_id``. ``--skip-db-update`` and ``--offline-scan`` are taken and
read by nothing, as in the JAX package: no scan fetches a DB. Flags resolve
as the JAX package's do (``flag.py``): the command line, then
``TRIVY_TPU_<NAME>`` in the environment, then the config file (``-c``,
else ``trivy-tpu.yaml`` or ``trivy_tpu.yaml`` in the working directory),
then the default; ``--device`` and ``--stats-out`` are the port's own and
come from the command line only. The
report then passes the JAX package's filter: ``--severity``, VEX documents, the ignore file
(``.trivyignore`` in the working directory by default, plain or YAML), a
Python or Rego ``--ignore-policy``, and the dedup.

``fs`` (and ``rootfs``, the same scan) walks the tree once through the
analyzers of ``fanal/scan.py``: the OS identity analyzers always, the
lockfile, installed-package, binary and OS package DB analyzers when the
report can show packages (``vuln``, ``license`` or ``--list-all-pkgs``) or
with ``misconfig``, the secret, license and config analyzers as their
scanners ask. ``misconfig`` scans the ``dockerfile``, ``kubernetes``,
``terraform`` (``.tf``, ``.tf.json``, ``.tfvars``, local modules),
``cloudformation`` (YAML and JSON templates with their intrinsics),
``helm`` (a chart's templates rendered with its values; the YAML, JSON and
manifests under a chart's root feed the render instead of their own pass),
``azure-arm``, ``yaml`` and ``json`` types, and terraform plans (type
``terraformplan-json``, no ``--misconfig-scanners`` choice, as in JAX)
(``misconf/``) with the ``--config-check`` Python and Rego checks.
``image`` also checks the image history rebuilt as a Dockerfile.
``repo`` clones a URL (``artifact/repo.py``) and scans the checkout as
``fs``; a path is scanned in place. ``image`` walks each layer that its layer cache lacks the
same way (``artifact/image.py``), every package analyzer included: of a
docker-save or OCI-layout archive when the target is a path, else of the
first daemon in ``--image-src`` order that holds the image, else of a
registry pull (``remote``). On ``image`` ``--diff-base`` analyzes the
layers the derived image shares with the base from the base;
``--incremental`` and ``--since-last`` are ignored there with a warning, as
the JAX ``image`` ignores them. ``vm`` walks the ext4 partitions
of a raw disk image (``artifact/vm.py``) with the analyzers of an image
layer, its blob cached per image. Every application's packages then meet
the advisory DB of ``--db-repository`` (or ``<cache-dir>/db``) in one
resident CVE join. The JSON ``Results`` and ``Metadata`` equal those of
``python -m trivy_tpu.cli <command> --scanners <same> --backend cpu --format
json`` on the same target, DB and working directory; ``sbom``'s equal those
of ``python -m trivy_tpu.cli sbom --format json``. An image source that
cannot be resolved or read, a clone that fails and an unreadable
``--diff-base`` exit with code 1 and write no report.

``fs``, ``rootfs`` and ``repo`` with ``--incremental``, ``--since-last`` or
``--diff-base <commit-ish>`` scan incrementally, as the JAX package does
(``incremental/``): the tree's directory-atomic units are keyed by content
and the analysis fingerprint in the scan cache (``--cache-dir``,
``--cache-backend``), only the units the cache lacks are analyzed (only
their files reach the card's kernels), and detection runs over every unit's
blob. ``--since-last`` reuses a file's key when its size and mtime match the
last scan's manifest, ``--diff-base`` when git calls the file unchanged
since the clean commit the manifest was recorded at. A ref git cannot
resolve, or a tree that is no git worktree, exits 1 with no report; any of
the three with ``--server`` exits 2. ``--stats-out`` then holds the reuse
counts (``units_total``, ``units_analyzed``, ``files_stat_reused``,
``files_git_reused``, ``files_hashed``, ...). ``watch <dir>`` scans with
``--since-last`` every ``--watch-interval`` seconds and writes the report
after the first scan and after each one that analyzed a unit or lost one;
``--timeout`` arms no alarm for it, and Ctrl-C ends it with the last exit
code.

``server`` serves the JAX package's Cache and Scanner services
(``rpc/server.py``): clients push analysis blobs, the server detects on
its ``--device`` against its DB, with the JAX admission group
(``--max-concurrent-scans`` and the async job API). ``fs``, ``rootfs``
and ``repo --server URL`` run in client mode as the JAX CLI's do: analysis
(the secret feed and the license kernels) here, the blob to the server
when it lacks it, detection there; ``image``, ``vm`` and ``sbom`` take
``--server`` and scan locally, as the JAX CLI's do, with a warning. Either
package's client works with either package's server.

``fs``, ``rootfs``, ``repo`` and ``image`` with ``--fleet host:port,...``
scatter the analysis over scan servers as the JAX ``--fleet`` does
(``fleet/``, :func:`scan_fleet`): the plan's shards run on the servers'
devices, their blobs merge into the scan cache and detection runs here, so
the ``Results`` equal the scan's without a fleet; shards every server failed
run here and mark the report ``Degraded`` (with ``--no-host-fallback`` the
command exits 1). ``--fleet`` with ``--server``, or with an incremental
flag on a tree, exits 2 as in JAX. A shard with ``misconfig`` scans every
type with no custom checks, as a JAX replica does: ``--misconfig-scanners``
and ``--config-check`` reach no replica, and the port says so in a warning
(the JAX CLI ignores them there with no word). The fleet's telemetry plane
runs at ``--fleet-telemetry-interval`` (1.0 s by default, 0 turns it off): replica
scrapes, headroom-weighted placement, the dead and draining verdicts, and
the ``fleet`` blocks of ``--metrics-out``, ``--timeseries-out``,
``--trace-out``, ``--live`` and the heartbeat. ``--fleet-register-token``
is kept in the fleet config, and, as in JAX, no command installs a
register hook that reads it.

``--compliance SPEC`` (a builtin spec, ``docker-cis-1.6.0``,
``k8s-nsa-1.0``, ..., or ``@path`` of a YAML spec) writes the compliance
report of the filtered scan instead of the scan's (``compliance/``), in
``table`` or ``json`` only; another format or an unknown spec exits 2 after
the scan, as in JAX, and ``--exit-code`` applies when a control fails.
``k8s`` (``k8s.py``) checks the workloads of ``--manifests`` (a file,
directory or cluster dump) or of ``kubectl get`` on the ``PATH`` (exit 1
when it is missing or fails) with the Kubernetes checks and the host secret
engine, a ``NodeInfo`` document with the node checks; ``--scan-images``
scans each workload image from its registry as ``image`` does (the secret
feed's kernels and, with a DB, the CVE join on ``--device``).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time
from collections import Counter

from trivy_tpu_torch import VERSION, faults, log, obs
from trivy_tpu_torch import report as report_pkg
from trivy_tpu_torch.artifact.image import (
    ImageSourceOption,
    new_image_artifact,
    preseed_from_base,
)
from trivy_tpu_torch.artifact.vm import VMImageArtifact
from trivy_tpu_torch.artifact.repo import RepoError, checkout_repo, is_remote
from trivy_tpu_torch.cache import REDIS_SCHEMES, cached_blobs, check_backend, new_cache
from trivy_tpu_torch.db import load_default_db
from trivy_tpu_torch.device import DEFAULT_DEVICE, resolve
from trivy_tpu_torch.fanal.handler import HandlerManager
from trivy_tpu_torch.fanal.image_daemon import DaemonError
from trivy_tpu_torch.fanal.image_registry import RegistryError
from trivy_tpu_torch.fanal.scan import (
    DEFAULT_PARALLEL,
    SCANNERS,
    ScanAnalyzers,
    analyze_files,
    check_scanners,
)
from trivy_tpu_torch.fanal.walker import FSWalker, WalkOption
from trivy_tpu_torch.fleet import FleetError
from trivy_tpu_torch.fleet.plan import BACKENDS
from trivy_tpu_torch.flag import Flag, FlagGroup, load_config_file, resolve_all
from trivy_tpu_torch.obs import export
from trivy_tpu_torch.obs import recorder as flight
from trivy_tpu_torch.obs import timeseries
from trivy_tpu_torch.result import FilterOptions, IgnorePolicy, PolicyError, filter_report
from trivy_tpu_torch.rpc import DEFAULT_TOKEN_HEADER
from trivy_tpu_torch.sbom import detect_format
from trivy_tpu_torch.sbom.decode import decode
from trivy_tpu_torch.scanner import ScanOptions, build_report
from trivy_tpu_torch.scanner.local_driver import LocalDriver
from trivy_tpu_torch.tuning import TuningConfig, resolve_tuning, validate_interval
from trivy_tpu_torch.types import Report

logger = log.logger("cli")

SEVERITIES = ["UNKNOWN", "LOW", "MEDIUM", "HIGH", "CRITICAL"]
# the JAX --misconfig-scanners choices, the types of misconf/detection.py
MISCONFIG_TYPES = ["dockerfile", "terraform", "cloudformation", "kubernetes", "helm",
                   "azure-arm", "yaml", "json"]
# formats that force the whole package inventory, as --list-all-pkgs does
LIST_ALL_FORMATS = ("cyclonedx", "spdx", "spdx-json", "github")
# the walk's counters in a scan's counters (fanal/scan.py analyze_files)
FILE_COUNTERS = ("files_walked", "files_scanned", "files_skipped")
# the CVE join's counters in a scan's counters (the JAX package's names)
CVE_COUNTERS = ("cve.bounds_bytes_uploaded", "cve.resident_rows", "cve.dispatch_count",
                "cve.candidate_pairs", "cve.join.seconds", "cve.dispatch.seconds",
                "cve.degraded")
# the health counts of a scan that its counters carry: the scans and the
# license batches that fell back to the host
HEALTH_COUNTERS = ("scan.degraded", "license.degraded")
# the reuse counts of an incremental scan in its counters (the JAX
# artifact's ``last_stats`` apart from its unit keys)
INCREMENTAL_COUNTERS = ("units_total", "units_analyzed", "units_reused", "files_stat_reused",
                        "files_git_reused", "files_hashed", "bytes_reused")


class ScanTimeout(BaseException):
    """``--timeout``'s alarm went off. Not an ``Exception``: Python's
    ``TimeoutError`` is an ``OSError``, so an alarm landing in a file read
    would be taken for an unreadable file and the scan would go on; no
    handler below ``main`` takes this one."""


def load_db(db_repository: str | None = None, cache_dir: str | None = None):
    """The advisory DB of ``db_repository``, else ``<cache_dir>/db`` (a
    ``trivy.db`` there is flattened on first use); None, with a warning,
    when neither holds one."""
    db = load_default_db(db_repository, cache_dir)
    if db is None:
        logger.warning("vulnerability DB not available; skipping vuln detection")
    return db


def _components(blobs) -> int:
    return sum(sum(len(pi.packages) for pi in b.package_infos)
               + sum(len(a.packages) for a in b.applications) for b in blobs)


def _detect(blobs, target: str, artifact_type: str, scanners, db, dev, list_all_pkgs: bool,
            stats: Counter, health0: dict, host_fallback: bool = True,
            image_metadata: dict | None = None, skipped_files: int = 0) -> Report:
    """The report of the analyzed blobs, in layer order: detection, the
    result sections in the reference's order and the metadata, with
    ``Degraded`` when the scan's health counts (those since ``health0``)
    hold a degrade; those counts join ``stats`` (``HEALTH_COUNTERS``)."""
    t0 = time.perf_counter()
    results, os_info = LocalDriver(db, dev, stats, host_fallback=host_fallback).scan(
        target, blobs, ScanOptions(scanners=list(scanners), list_all_pkgs=list_all_pkgs))
    stats["detect.seconds"] += time.perf_counter() - t0
    health = obs.current().health_snapshot()
    delta = {k: v - health0.get(k, 0) for k, v in health.items()}
    for k in HEALTH_COUNTERS:
        stats[k] += delta.get(k, 0)
    return build_report(target, artifact_type, results, os_info, image_metadata, skipped_files,
                        health=delta)


def _load_db_for(scanners, db, db_repository, cache_dir, stats: Counter):
    """``db``, else with ``vuln`` the DB :func:`load_db` finds (its seconds
    in ``db_load_seconds``)."""
    if "vuln" in scanners and db is None:
        t0 = time.perf_counter()
        db = load_db(db_repository, cache_dir)
        stats["db_load_seconds"] = time.perf_counter() - t0
    return db


def _finish_stats(stats: Counter, analyzers: ScanAnalyzers, scanners, t0: float) -> dict:
    stats["seconds"] = time.perf_counter() - t0
    stats.update(analyzers.stats())
    if "vuln" in scanners:
        stats = Counter({**dict.fromkeys(CVE_COUNTERS, 0), **stats})
    return dict(stats)


def scan_fs(root: str, config_path: str | None = None, device=DEFAULT_DEVICE,
            skip_dirs=(), skip_files=(), scanners=("secret",), license_full: bool = False,
            shared_arena: bool = True, db=None, db_repository: str | None = None,
            cache_dir: str | None = None, java_db: str | None = None,
            list_all_pkgs: bool = False, host_fallback: bool = True, parallel: int = 0,
            tuning: TuningConfig | None = None, server: str | None = None, token: str = "",
            cache=None, incremental=None, **scanner_opts) -> tuple[Report, dict]:
    """Scan the tree under ``root`` with ``scanners`` (any of ``vuln``,
    ``misconfig``, ``secret``, ``license``; ``check_paths`` and
    ``misconfig_scanners`` in ``scanner_opts`` are the misconfiguration
    flags). With ``vuln``,
    packages meet ``db`` when given (a loaded DB keeps its resident join
    across scans), else the DB that
    :func:`load_db` finds. ``parallel`` workers (0: ``tuning.parallel``,
    else ``DEFAULT_PARALLEL``) read the files ahead of the analyzers;
    ``tuning`` (a :class:`~trivy_tpu_torch.tuning.TuningConfig`) also sets
    the secret feed's knobs. Returns the unfiltered report (the CLI filters
    it) and the scan's counters: files walked, scanned and skipped,
    components, the seconds of the walk with its analyzers
    (``analyze.seconds``), of the detection and of the whole scan, the CVE
    join's (``cve.*``), the secret feed's, the fused gate's file counts, and
    ``db_load_seconds`` when this call loaded the DB (not part of
    ``seconds``), and the health counts ``scan.degraded`` and
    ``license.degraded``. A device error the ladder cannot absorb finishes
    the scan on the host and marks the report ``Degraded``, or, with
    ``host_fallback`` off, fails it. ``scanner_opts`` reach the
    :class:`~trivy_tpu_torch.secret.scanner.TorchSecretScanner`.

    With ``server`` (a scan server's URL, ``token`` its auth token) the
    scan runs in client mode, as the JAX ``fs --server`` does: analysis here
    on ``device``, then the blob goes to the server's cache under the JAX
    key (sent only when ``MissingBlobs`` says the server lacks it), and the
    server runs detection against its own DB (:func:`_remote_detect`). The
    counters then hold no ``cve.*`` join counts (the server has them) but
    ``remote.blobs_sent``.

    With ``incremental`` (an :class:`~trivy_tpu_torch.incremental.
    IncrementalOptions`) the scan is the JAX incremental one
    (``incremental/fs.py``): the tree's units are keyed by content, only the
    units ``cache`` lacks are analyzed (their files alone reach the secret
    feed and the license kernels), and detection runs over every unit's blob
    read back from ``cache``. The counters then also hold the reuse counts
    (:data:`INCREMENTAL_COUNTERS`) and ``unit_set``, a digest of the unit
    keys; files walked cover the whole tree, files scanned the dirty units'.
    A ``diff_base`` git cannot resolve raises
    :class:`~trivy_tpu_torch.incremental.manifest.GitDiffError`."""
    if incremental is not None and server:
        raise ValueError("--incremental/--diff-base/--since-last require a local scan path "
                         "(drop --server or run the scan on the server)")
    check_scanners(scanners)
    dev = resolve(device)
    health0 = obs.current().health_snapshot()
    stats = Counter(dict.fromkeys(FILE_COUNTERS, 0))
    if not server:
        db = _load_db_for(scanners, db, db_repository, cache_dir, stats)
    t0 = time.perf_counter()
    analyzers = ScanAnalyzers(scanners, dev, license_full=license_full,
                              shared_arena=shared_arena, config_path=config_path,
                              java_db=java_db, list_all_pkgs=list_all_pkgs,
                              host_fallback=host_fallback, tuning=tuning, **scanner_opts)
    if incremental is not None:
        return _scan_incremental(root, analyzers, cache, incremental, skip_files, skip_dirs,
                                 parallel, scanners, db, dev, list_all_pkgs, host_fallback,
                                 stats, health0, t0)
    secret, batched = analyzers.batch(root)
    walker = FSWalker(WalkOption(skip_files=list(skip_files), skip_dirs=list(skip_dirs)))
    workers = parallel or (tuning.parallel if tuning is not None else 0) or DEFAULT_PARALLEL
    result = analyze_files(walker.walk(root), root, analyzers.group, secret, batched, stats,
                           read_ahead=workers)
    blob = result.to_blob_info()
    HandlerManager().post_handle(result, blob)
    stats["analyze.seconds"] = time.perf_counter() - t0
    # walk and stat failures count as the JAX package's walker counts them
    stats["files_skipped"] += walker.skipped
    logger.debug("walked %d files under %s: %d analyzed, %d skipped", stats["files_walked"],
                 root, stats["files_scanned"], stats["files_skipped"])
    name = root if root == os.path.sep else root.rstrip(os.path.sep)
    if server:
        report = _remote_detect(blob, name, analyzers, skip_files, skip_dirs, scanners,
                                list_all_pkgs, server, token, stats, health0)
    else:
        report = _detect([blob], name, "filesystem", scanners, db, dev, list_all_pkgs, stats,
                         health0, host_fallback, skipped_files=stats["files_skipped"])
    stats["components"] = _components([blob])
    return report, _finish_stats(stats, analyzers, () if server else scanners, t0)


def _scan_incremental(root: str, analyzers: ScanAnalyzers, cache, incremental, skip_files,
                      skip_dirs, parallel: int, scanners, db, dev, list_all_pkgs: bool,
                      host_fallback: bool, stats: Counter, health0: dict,
                      t0: float) -> tuple[Report, dict]:
    """:func:`scan_fs`'s incremental half: the unit artifact's inspect,
    then detection over its blobs as the applier merges them."""
    import hashlib

    from trivy_tpu_torch.incremental.fs import IncrementalFSArtifact

    artifact = IncrementalFSArtifact(root, cache, analyzers, skip_files=skip_files,
                                     skip_dirs=skip_dirs, parallel=parallel,
                                     incremental=incremental)
    ref = artifact.inspect()
    blobs = cached_blobs(cache, ref.blob_ids)
    stats.update(artifact.stats)
    stats.update({k: artifact.last_stats[k] for k in INCREMENTAL_COUNTERS})
    stats["analyze.seconds"] = time.perf_counter() - t0
    report = _detect(blobs, ref.name, ref.type, scanners, db, dev, list_all_pkgs, stats,
                     health0, host_fallback, skipped_files=stats["files_skipped"])
    stats["components"] = _components(blobs)
    out = _finish_stats(stats, analyzers, scanners, t0)
    out["unit_set"] = hashlib.sha256(
        "\n".join(sorted(artifact.last_stats["unit_keys"])).encode()).hexdigest()
    return report, out


def _remote_detect(blob, name: str, analyzers: ScanAnalyzers, skip_files, skip_dirs, scanners,
                   list_all_pkgs: bool, server: str, token: str, stats: Counter,
                   health0: dict) -> Report:
    """Client mode's half after the analysis (the JAX ``LocalFSArtifact.
    inspect`` and ``RemoteDriver.scan``): the blob's key as the JAX package
    computes it (``trivy_tpu/artifact/local_fs.py``), ``PutBlob`` when the
    server's ``MissingBlobs`` lacks it, then ``Scanner.Scan`` on the server;
    the report is built here from its ``Results`` and ``OS``."""
    from trivy_tpu_torch.cache.key import calc_blob_key, calc_key
    from trivy_tpu_torch.rpc.client import RemoteCache, RemoteDriver

    t0 = time.perf_counter()
    blob_dict = blob.to_wire_dict()  # the JAX client's blob, so the JAX key
    blob_id = calc_key(calc_blob_key(blob_dict), analyzer_versions=analyzers.versions(),
                       hook_versions=HandlerManager().versions(),
                       skip_files=list(skip_files), skip_dirs=list(skip_dirs))
    cache = RemoteCache(server, token=token or "")
    _, missing = cache.missing_blobs(blob_id, [blob_id])
    if missing:
        cache.put_blob(blob_id, blob_dict)
    stats["remote.blobs_sent"] = len(missing)
    results, os_info = RemoteDriver(server, token=token or "").scan(
        name, blob_id, [blob_id],
        ScanOptions(scanners=list(scanners), list_all_pkgs=list_all_pkgs))
    stats["detect.seconds"] += time.perf_counter() - t0
    health = obs.current().health_snapshot()
    delta = {k: v - health0.get(k, 0) for k, v in health.items()}
    for k in HEALTH_COUNTERS:
        stats[k] += delta.get(k, 0)
    return build_report(name, "filesystem", results, os_info,
                        skipped_files=stats["files_skipped"], health=delta)


class DiffBaseError(RuntimeError):
    """The ``--diff-base`` image could not be resolved or read."""


def scan_image(target: str, config_path: str | None = None, device=DEFAULT_DEVICE,
               skip_dirs=(), skip_files=(), scanners=("secret",), license_full: bool = False,
               shared_arena: bool = True, db=None, db_repository: str | None = None,
               cache_dir: str | None = None, cache=None, cache_backend: str | None = None,
               java_db: str | None = None, list_all_pkgs: bool = False, parallel: int = 0,
               image_source: ImageSourceOption | None = None, diff_base: str | None = None,
               host_fallback: bool = True, **scanner_opts) -> tuple[Report, dict]:
    """Scan the image ``target`` layer by layer with ``scanners``, as
    :func:`scan_fs` scans a tree: an archive when the path exists (a
    docker-save tar, or an OCI layout as a directory or a tar), else an
    image of a daemon or a registry, looked for as ``image_source`` says
    (``artifact/image.py::new_image_artifact``). Layer blobs are kept in
    ``cache``, else in the ``cache_backend`` cache (``fs`` by default, under
    ``cache_dir``), so a second scan walks no layer it has seen; ``parallel``
    layers (0: 5) are analyzed at once over one secret scanner. With
    ``diff_base``, the layers the image shares with that base image are
    analyzed from the base first (``preseed_from_base``). Returns the
    unfiltered report and the counters of :func:`scan_fs` (files and
    components over the layers analyzed and the image's blobs) with
    ``layers``, ``layers_analyzed``, ``layers_cached``, ``layers_seeded``
    (from the base) and ``layer_bytes``, the stored bytes of the layers
    analyzed (a registry's compressed bytes). Raises
    :class:`~trivy_tpu_torch.fanal.image_daemon.DaemonError` or
    :class:`~trivy_tpu_torch.fanal.image_registry.RegistryError` when the
    image cannot be found or pulled, :class:`DiffBaseError` for the base.
    A device error in any layer walks the ladder of :func:`scan_fs`."""
    check_scanners(scanners)
    dev = resolve(device)
    health0 = obs.current().health_snapshot()
    stats = Counter(dict.fromkeys(FILE_COUNTERS, 0))
    db = _load_db_for(scanners, db, db_repository, cache_dir, stats)
    t0 = time.perf_counter()
    # every layer runs the package analyzers, whatever the scanners, as in
    # the JAX package: a layer's blob then serves any later scan of it
    analyzers = ScanAnalyzers(scanners, dev, license_full=license_full,
                              shared_arena=shared_arena, config_path=config_path,
                              java_db=java_db, packages=True, host_fallback=host_fallback,
                              **scanner_opts)
    if cache is None:
        cache = new_cache(cache_backend or "fs", cache_dir)
    artifact = new_image_artifact(target, cache, analyzers, skip_files=skip_files,
                                  skip_dirs=skip_dirs, parallel=parallel, option=image_source)
    try:
        if diff_base:
            try:
                preseed_from_base(artifact, diff_base)
            except Exception as e:
                # the user asked for a diff against this base: never a
                # silent full scan
                raise DiffBaseError(f"--diff-base {diff_base}: {e}") from e
        ref = artifact.inspect()
    finally:
        artifact.close()
    blobs = cached_blobs(cache, ref.blob_ids)
    stats.update({"layers_seeded": 0, **artifact.stats})
    stats["analyze.seconds"] = time.perf_counter() - t0
    report = _detect(blobs, ref.name, ref.type, scanners, db, dev, list_all_pkgs, stats,
                     health0, host_fallback, image_metadata=ref.image_metadata,
                     skipped_files=stats["files_skipped"])
    stats["components"] = _components(blobs)
    return report, _finish_stats(stats, analyzers, scanners, t0)


def scan_vm(path: str, config_path: str | None = None, device=DEFAULT_DEVICE,
            skip_dirs=(), skip_files=(), scanners=("secret",), license_full: bool = False,
            shared_arena: bool = True, db=None, db_repository: str | None = None,
            cache_dir: str | None = None, cache=None, cache_backend: str | None = None,
            java_db: str | None = None, list_all_pkgs: bool = False,
            host_fallback: bool = True, **scanner_opts) -> tuple[Report, dict]:
    """Scan the raw disk image at ``path`` (MBR or GPT, ext4 partitions)
    with ``scanners``: its files through the analyzers of an image layer, as
    the JAX package's ``vm`` runs every package analyzer whatever the
    scanners. The blob is kept in ``cache`` (as :func:`scan_image` keeps
    layers), so a rescan of an unchanged image reads no file. Returns the
    unfiltered report and the counters of :func:`scan_fs`."""
    check_scanners(scanners)
    dev = resolve(device)
    health0 = obs.current().health_snapshot()
    stats = Counter(dict.fromkeys(FILE_COUNTERS, 0))
    db = _load_db_for(scanners, db, db_repository, cache_dir, stats)
    t0 = time.perf_counter()
    analyzers = ScanAnalyzers(scanners, dev, license_full=license_full,
                              shared_arena=shared_arena, config_path=config_path,
                              java_db=java_db, packages=True, host_fallback=host_fallback,
                              **scanner_opts)
    if cache is None:
        cache = new_cache(cache_backend or "fs", cache_dir)
    artifact = VMImageArtifact(path, cache, analyzers, skip_files=skip_files,
                               skip_dirs=skip_dirs)
    ref = artifact.inspect()
    blobs = cached_blobs(cache, ref.blob_ids)
    stats.update(artifact.stats)
    stats["analyze.seconds"] = time.perf_counter() - t0
    report = _detect(blobs, ref.name, ref.type, scanners, db, dev, list_all_pkgs, stats,
                     health0, host_fallback, skipped_files=stats["files_skipped"])
    stats["components"] = _components(blobs)
    return report, _finish_stats(stats, analyzers, scanners, t0)


def scan_sbom(path: str, db=None, device=DEFAULT_DEVICE, db_repository: str | None = None,
              cache_dir: str | None = None, list_all_pkgs: bool = False,
              host_fallback: bool = True, scanners=("vuln",)) -> tuple[Report, dict]:
    """Match the SBOM at ``path`` against the advisory DB: ``db`` when
    given (a loaded DB keeps its resident join across scans), else the one
    :func:`load_db` finds. ``scanners`` follow the JAX ``sbom``'s rule: a
    list without ``vuln`` becomes ``["vuln"]``, any other stays as given,
    so ``license`` adds the licenses of the SBOM's packages. Returns the
    unfiltered report (the CLI filters it) and the scan's counters: the
    join's (``cve.*``, under the JAX package's names), the seconds of the
    decode, the detection and the whole scan, and, when this call loaded the
    DB, ``db_load_seconds`` (not part of ``seconds``). A device error in the
    join finishes on the host comparator (``Degraded``), or with
    ``host_fallback`` off fails the scan."""
    check_scanners(scanners)
    scanners = list(scanners) if "vuln" in scanners else ["vuln"]
    dev = resolve(device)
    health0 = obs.current().health_snapshot()
    stats: Counter = Counter()
    if db is None:
        t0 = time.perf_counter()
        db = load_db(db_repository, cache_dir)
        stats["db_load_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with open(path, "rb") as f:
        data = f.read()
    fmt = detect_format(data)
    blob = decode(data)
    stats["decode.seconds"] = time.perf_counter() - t0
    report = _detect([blob], path, "spdx" if fmt.startswith("spdx") else "cyclonedx",
                     scanners, db, dev, list_all_pkgs, stats, health0, host_fallback)
    stats.update({"components": _components([blob]), "seconds": time.perf_counter() - t0})
    return report, {**dict.fromkeys(CVE_COUNTERS, 0), **stats}


def scan_fleet(kind: str, target: str, fleet, cache=None, config_path: str | None = None,
               device=DEFAULT_DEVICE, skip_dirs=(), skip_files=(), scanners=("secret",),
               license_full: bool = False, shared_arena: bool = True, db=None,
               db_repository: str | None = None, cache_dir: str | None = None,
               list_all_pkgs: bool = False, parallel: int = 0,
               image_source: ImageSourceOption | None = None,
               host_fallback: bool = True) -> tuple[Report, dict]:
    """Scatter the analysis of ``target`` (``kind`` ``fs``: a tree, as
    :func:`scan_fs`; ``image``: as :func:`scan_image`) over the scan servers
    of ``fleet`` (a :class:`~trivy_tpu_torch.fleet.coordinator.FleetConfig`),
    as the JAX ``--fleet`` does: the plan's shards run on the replicas'
    devices, their blobs land in ``cache`` (a memory cache by default), and
    detection runs here on ``device`` (the CVE join's ``verscmp`` launch).
    The ``Results`` equal those of the scan without a fleet. Shards every
    replica failed run here on ``device`` and mark the report ``Degraded``;
    with ``host_fallback`` off they raise
    :class:`~trivy_tpu_torch.fleet.FleetError`. Returns the unfiltered
    report and the counters of :func:`scan_fs` (files walked and the
    analysis counters stay on the replicas), with ``fleet.<stat>`` for the
    coordinator's stats, ``fleet.plan.seconds``, ``fleet.fanout.seconds``
    and ``detect.seconds`` (the fold)."""
    from trivy_tpu_torch.fleet.merge import FleetArtifact
    from trivy_tpu_torch.fleet.plan import ShardSettings

    check_scanners(scanners)
    dev = resolve(device)
    health0 = obs.current().health_snapshot()
    stats: Counter = Counter()
    db = _load_db_for(scanners, db, db_repository, cache_dir, stats)
    t0 = time.perf_counter()
    if cache is None:
        cache = new_cache("memory")
    settings = ShardSettings(scanners=list(scanners), license_full=license_full, device=str(dev),
                             skip_files=list(skip_files), skip_dirs=list(skip_dirs),
                             shared_arena=shared_arena, parallel=parallel,
                             secret_config=config_path,
                             image_source=image_source or ImageSourceOption())
    artifact = FleetArtifact(kind, target, cache, settings, fleet,
                             ScanOptions(scanners=list(scanners), list_all_pkgs=list_all_pkgs))
    ref = artifact.inspect()
    blobs = cached_blobs(cache, ref.blob_ids)
    stats["analyze.seconds"] = time.perf_counter() - t0
    stats["fleet.plan.seconds"] = artifact.seconds["plan"]
    stats["fleet.fanout.seconds"] = artifact.seconds["fanout"]
    for k, v in artifact.stats().items():
        stats[f"fleet.{k}"] = dict(v) if isinstance(v, dict) else v
    skipped = obs.current().health_snapshot().get("walk.skipped", 0) - health0.get(
        "walk.skipped", 0)
    report = _detect(blobs, ref.name, ref.type, scanners, db, dev, list_all_pkgs, stats,
                     health0, host_fallback, image_metadata=ref.image_metadata,
                     skipped_files=skipped)
    stats["components"] = _components(blobs)
    stats["seconds"] = time.perf_counter() - t0
    if "vuln" in scanners:
        stats = Counter({**dict.fromkeys(CVE_COUNTERS, 0), **stats})
    return report, dict(stats)


# -- flags: the JAX package's names, defaults and config keys (trivy_tpu/cli.py)


def global_flags() -> FlagGroup:
    return FlagGroup("global", [
        Flag("debug", default=False, value_type=bool, help="debug logging",
             config_name="debug", short="d"),
        Flag("quiet", default=False, value_type=bool, help="errors only",
             config_name="quiet", short="q"),
        Flag("cache-dir", default=None, help="cache directory", config_name="cache.dir"),
        Flag("cache-backend", default=None, config_name="cache.backend",
             validator=check_backend,
             help="scan cache backend: fs, memory, redis://host:port (rediss:// for TLS)"),
        Flag("cache-ttl", default=None, config_name="cache.ttl",
             help="redis cache TTL in seconds"),
        Flag("redis-ca", default=None, config_name="cache.redis.ca",
             help="redis TLS CA certificate path"),
        Flag("redis-cert", default=None, config_name="cache.redis.cert",
             help="redis TLS client certificate path"),
        Flag("redis-key", default=None, config_name="cache.redis.key",
             help="redis TLS client key path"),
        Flag("redis-insecure", default=False, value_type=bool,
             config_name="cache.redis.insecure",
             help="skip redis TLS certificate verification (rediss:// verifies against "
                  "system roots by default)"),
        Flag("config", default=None, help="config file path", short="c"),
        Flag("trace", default=False, value_type=bool, config_name="trace",
             help="print per-stage timing spans, histograms, and the "
                  "stall-attribution verdict after the scan"),
        Flag("trace-out", default=None, config_name="trace.out",
             help="write spans as Chrome trace-event JSON (Perfetto-loadable; "
                  "implies span recording; .gz path gzips)"),
        Flag("metrics-out", default=None, config_name="trace.metrics-out",
             help="write aggregate span/counter metrics as JSON "
                  "(implies span recording; .gz path gzips)"),
        Flag("profile-out", default=None, config_name="trace.profile-out",
             help="write the per-rule / per-bucket cost profile (gate hits, confirm "
                  "time, false-positive rate, dispatch-bucket timing) as JSON "
                  "(implies span recording; .gz path gzips)"),
        Flag("telemetry-interval", default=None, value_type=float,
             config_name="telemetry.interval",
             validator=lambda v: validate_interval(v, "interval"),
             help="live-telemetry sampling interval in seconds "
                  "(default 0.25; 0 disables the sampler entirely)"),
        Flag("timeseries-out", default=None, config_name="telemetry.timeseries-out",
             help="write the scan's live-telemetry time series (link MB/s, arena "
                  "occupancy, queue depths, device busy, progress) as JSON "
                  "(implies the sampler; .gz gzips)"),
        Flag("live", default=False, value_type=bool, config_name="telemetry.live",
             help="print a live progress line (progress %, MB/s, ETA, device "
                  "busy, arena occupancy) to stderr during the scan"),
        Flag("timeout", default=300, value_type=int, config_name="timeout",
             help="scan timeout seconds (ref default 5m); a scan past it exits 1"),
        Flag("log-format", default="plain", choices=["plain", "json"], config_name="log.format",
             help="log line format: plain, or one JSON object per line"),
        Flag("fault-inject", default=None, config_name="fault-inject",
             help="arm the deterministic fault-injection harness, e.g. "
                  "'device.dispatch@d0:at=2,device.dispatch@license:times=-1' "
                  "(see trivy_tpu_torch/faults.py for the grammar)"),
        Flag("debug-dir", default=None, config_name="debug.dir",
             help="directory for auto-emitted flight-recorder diagnostic bundles "
                  "(terminal failure, degraded completion); bounded retention "
                  "(TRIVY_TPU_DEBUG_KEEP, default 8); env TRIVY_TPU_DEBUG_DIR; "
                  "render with `python -m trivy_tpu_torch debug <bundle>`"),
    ])


def no_host_fallback_flag() -> Flag:
    return Flag("no-host-fallback", default=False, value_type=bool,
                config_name="scan.no-host-fallback",
                help="fail the scan on unrecoverable device errors instead of "
                     "degrading to the exact host engine")


def scan_flags() -> FlagGroup:
    return FlagGroup("scan", [
        Flag("scanners", default=["secret"], is_list=True, choices=list(SCANNERS),
             config_name="scan.scanners", help="comma-separated scanners"),
        Flag("skip-dirs", default=[], is_list=True, config_name="scan.skip-dirs",
             help="directories to skip"),
        Flag("skip-files", default=[], is_list=True, config_name="scan.skip-files",
             help="files to skip"),
        Flag("backend", default="auto", choices=list(BACKENDS), config_name="scan.backend",
             help="the JAX backend's name for the device: cpu runs on the CPU, auto, "
                  "pallas and xla on cuda; an explicit --device wins"),
        Flag("parallel", default=0, value_type=int, config_name="scan.parallel",
             help="host workers (0 = 5): the read-ahead pool of fs, rootfs and repo, the "
                  "layers image analyzes at once, and the secret confirm pool"),
        no_host_fallback_flag(),
    ])


def report_flags() -> FlagGroup:
    return FlagGroup("report", [
        Flag("format", default="table", choices=report_pkg.FORMATS, short="f",
             config_name="format", help="output format"),
        Flag("output", default=None, short="o", config_name="output",
             help="output file (default stdout)"),
        Flag("severity", default=[], is_list=True, choices=SEVERITIES,
             config_name="severity", help="severities to include"),
        Flag("exit-code", default=0, value_type=int, config_name="exit-code",
             help="exit code when findings exist"),
        Flag("ignorefile", default=".trivyignore", config_name="ignorefile",
             help="ignore file path"),
        Flag("ignore-policy", default=None, config_name="ignore-policy",
             help="suppress findings with a Python predicate file "
                  "(ignore_vulnerability/ignore_secret/... or ignore()) or a "
                  "rego policy (package trivy; ignore)"),
        Flag("vex", default=[], is_list=True, config_name="vex",
             help="VEX document paths (OpenVEX / CycloneDX VEX / CSAF), or "
                  "'repo' for the VEX repositories under <cache-dir>/vex"),
        Flag("show-suppressed", default=False, value_type=bool,
             config_name="show-suppressed", help="list policy-suppressed findings"),
        Flag("template", default=None, short="t", config_name="template",
             help="go-template style output template, or @file (for --format template)"),
        Flag("list-all-pkgs", default=False, value_type=bool,
             config_name="list-all-pkgs", help="include all packages in report"),
        Flag("dependency-tree", default=False, value_type=bool,
             config_name="dependency-tree",
             help="show the reversed dependency origin tree for vulnerable packages "
                  "(table format)"),
        Flag("compliance", default=None, config_name="compliance",
             help="render a compliance report (docker-cis-1.6.0, k8s-nsa-1.0, or "
                  "@spec.yaml)"),
    ])


def secret_flags() -> FlagGroup:
    return FlagGroup("secret", [
        Flag("secret-config", default="trivy-secret.yaml", config_name="secret.config",
             help="secret rule config (YAML); used when the file exists"),
        Flag("no-secret-dedup", default=False, value_type=bool,
             config_name="secret.no-dedup",
             help="disable the chunk-dedup hit cache on the device feed"),
        Flag("no-secret-pack", default=False, value_type=bool,
             config_name="secret.no-pack",
             help="disable small-file row packing on the device feed"),
        Flag("secret-hit-cache", default=False, value_type=bool,
             config_name="secret.hit-cache",
             help="persist chunk hit vectors in the scan cache backend (fs/redis) for "
                  "cross-scan dedup"),
        Flag("secret-streams", default=0, value_type=int, config_name="secret.streams",
             help="transfer streams feeding the card, each on its own CUDA stream "
                  "(0 = auto: 1)"),
        Flag("secret-inflight", default=0, value_type=int, config_name="secret.inflight",
             help="batches in flight per transfer stream (0 = auto: 2, double-buffered)"),
        Flag("no-secret-prefilter", default=False, value_type=bool,
             config_name="secret.no-prefilter",
             help="disable the on-device keyword prefilter pass (every batch then pays "
                  "the full anchored kernel)"),
        Flag("no-shared-arena", default=False, value_type=bool,
             config_name="secret.no-shared-arena",
             help="with both scanners, classify every license candidate instead of "
                  "gating them on the secret feed's rows"),
        Flag("secret-arena-slabs", default=0, value_type=int,
             config_name="secret.arena-slabs",
             help="chunk-arena slab count for the device feed (0 = derived from "
                  "streams x in-flight windows; at least 2)"),
        Flag("secret-bucket-rungs", default=0, value_type=int,
             config_name="secret.bucket-rungs",
             help="dispatch bucket-ladder depth (0 = default 3: B, B/2, B/4)"),
        Flag("secret-dedup-mb", default=0, value_type=int, config_name="secret.dedup-mb",
             help="byte budget (MB) for the in-process dedup hit-store LRU "
                  "(0 = default 32; the bound is bytes, not entries, so "
                  "streaming scans keep flat RSS)"),
        Flag("secret-compress", default=None, choices=["auto", "on", "off"],
             config_name="secret.compress",
             help="compressed slab wire format on the device feed: auto (on "
                  "for the card, off for --device cpu), on, off"),
        Flag("no-secret-compress", default=False, value_type=bool,
             config_name="secret.no-compress",
             help="ship raw slabs unconditionally (shorthand for --secret-compress off)"),
        Flag("secret-compress-min-ratio", default=None, value_type=float,
             config_name="secret.compress-min-ratio",
             help="per-batch wire budget as a fraction of the raw slab: a "
                  "batch that can't compress below this ships raw (default "
                  "0.875, the 7-bit-packing line)"),
    ])


def tuning_flags() -> FlagGroup:
    """The JAX tuning group: autotune records and the online controller."""
    return FlagGroup("tuning", [
        Flag("tuning-file", default=None, config_name="tuning.file",
             help="AUTOTUNE.json with per-topology knob records (default: ./AUTOTUNE.json "
                  "when present); unset knobs resolve from the record for this "
                  "topology fingerprint (cuda:<cards>:<link>, or cpu:1:host)"),
        Flag("tune", default=False, value_type=bool, config_name="tuning.controller",
             help="enable the online tuning controller: adapt the stream count, in-flight "
                  "windows and arena mid-scan from live gauges (every decision is logged "
                  "and exported)"),
        Flag("tuning-interval", default=None, value_type=float, config_name="tuning.interval",
             validator=lambda v: validate_interval(v, "interval"),
             help="online-controller decision cadence in seconds (default 0.5; 0 disables "
                  "the controller)"),
    ])


def license_flags() -> FlagGroup:
    return FlagGroup("license", [
        Flag("license-full", default=False, value_type=bool, config_name="license.full",
             help="also classify source-file headers, not only license files"),
    ])


def misconf_flags() -> FlagGroup:
    return FlagGroup("misconfiguration", [
        Flag("config-check", default=[], is_list=True,
             config_name="misconfiguration.config-check",
             help="paths to custom check files/dirs (Python check API or .rego)"),
        Flag("misconfig-scanners", default=[], is_list=True,
             config_name="misconfiguration.scanners", choices=MISCONFIG_TYPES,
             help="limit misconfig file types"),
    ])


def db_flags() -> FlagGroup:
    """The JAX db group. ``--skip-db-update`` and ``--offline-scan`` are
    taken and read by nothing, as in the JAX package: no scan fetches a
    DB."""
    return FlagGroup("db", [
        Flag("skip-db-update", default=False, value_type=bool, config_name="db.skip-update",
             help="do not refresh the vuln DB (no command refreshes it)"),
        Flag("db-repository", default=None, config_name="db.repository",
             help="advisory DB directory (default: <cache-dir>/db)"),
        Flag("java-db", default=None, config_name="db.java-repository",
             help="java DB directory (jar sha1 -> maven coordinates)"),
        Flag("offline-scan", default=False, value_type=bool, config_name="offline-scan",
             help="no network access (no scan reaches the network for a DB)"),
    ])


def image_flags() -> FlagGroup:
    return FlagGroup("image", [
        Flag("insecure", default=False, value_type=bool, config_name="image.insecure",
             help="allow plain-HTTP / self-signed registries"),
        Flag("username", default=None, config_name="image.username",
             help="registry basic-auth username"),
        Flag("password", default=None, config_name="image.password",
             help="registry basic-auth password"),
        Flag("platform", default=None, config_name="image.platform",
             help="platform for multi-arch images (os/arch)"),
        Flag("image-src", default=None, is_list=True, config_name="image.source",
             help="image source resolution order (docker,containerd,podman,remote)"),
        Flag("docker-host", default=None, config_name="image.docker.host",
             help="docker daemon socket/host (unix path or tcp:// URL)"),
        Flag("podman-host", default=None, config_name="image.podman.host",
             help="podman service socket"),
        Flag("containerd-host", default=None, config_name="image.containerd.host",
             help="containerd socket path"),
    ])


def incremental_flags() -> FlagGroup:
    """The JAX incremental group. On ``fs``, ``rootfs`` and ``repo`` the
    unit-level incremental scan (``incremental/``); on ``image``
    ``--diff-base`` is the base image, and ``--incremental`` and
    ``--since-last`` are ignored with a warning, as the JAX ``image``
    ignores them."""
    return FlagGroup("incremental", [
        Flag("incremental", default=False, value_type=bool, config_name="incremental.enabled",
             help="unit-level incremental scan: directory-atomic units are cached by content "
                  "and analysis fingerprint, and unchanged units merge out of the cache "
                  "(findings equal to a full scan's)"),
        Flag("diff-base", default=None, config_name="incremental.diff-base",
             help="scan only what changed since this base: a git commit-ish (fs, rootfs, "
                  "repo; unchanged files keyed from the manifest recorded at that commit) "
                  "or a base image ref or archive (image; layers present in the base are "
                  "seeded from it, only new layers are analyzed)"),
        Flag("since-last", default=False, value_type=bool,
             config_name="incremental.since-last",
             help="stat-walk repeat scan: files whose (size, mtime) match the last scan's "
                  "manifest are not read"),
    ])


def server_client_flags() -> FlagGroup:
    """The JAX client/server group: ``--server`` puts ``fs``, ``rootfs``
    and ``repo`` in client mode; ``image``, ``vm`` and ``sbom`` take it and
    scan locally, as the JAX CLI does."""
    return FlagGroup("client/server", [
        Flag("server", default=None, config_name="server.addr",
             help="server address for client mode (http://host:port)"),
        Flag("token", default=None, config_name="server.token", help="server auth token"),
    ])


def fleet_flags() -> FlagGroup:
    """The JAX fleet group of ``fs``, ``rootfs``, ``repo`` and ``image``:
    scatter one artifact's analysis over scan servers and merge the blobs
    here."""
    interval = lambda v: validate_interval(v, "interval")  # noqa: E731
    return FlagGroup("fleet", [
        Flag("fleet", default=None, is_list=True, config_name="fleet.replicas",
             help="comma-separated replica addresses (host:port) for a scatter-gather scan: "
                  "the artifact splits at natural boundaries (image layers, byte-balanced "
                  "walk partitions) and shards fan out as async jobs, with work-stealing, "
                  "speculative re-dispatch and per-replica circuit breakers"),
        Flag("fleet-inflight", default=0, value_type=int, config_name="fleet.inflight",
             help="async shard jobs in flight per replica (0 = auto: 2; resolves through "
                  "the tuning config: env TRIVY_TPU_FLEET_INFLIGHT, autotune record)"),
        Flag("fleet-shards-per-replica", default=0, value_type=int,
             config_name="fleet.shards-per-replica",
             help="fs-tree overpartition factor: the target shard count is replicas x this "
                  "(0 = auto: 4)"),
        Flag("fleet-speculate", default=None, value_type=float, config_name="fleet.speculate",
             help="straggler multiplier: an in-flight shard past this x the median shard wall "
                  "time is re-dispatched to an idle replica too, first result wins (default "
                  "2.0; 0 disables)"),
        Flag("fleet-telemetry-interval", default=None, value_type=float,
             config_name="fleet.telemetry-interval", validator=interval,
             help="replica health-poll cadence in seconds: the coordinator scrapes each "
                  "replica's /metrics and live progress into per-replica headroom series "
                  "(default 1.0; 0 disables the poller entirely: no thread, no fleet "
                  "gauges; env TRIVY_TPU_FLEET_TELEMETRY_INTERVAL)"),
        Flag("fleet-split-threshold", default=None, value_type=float,
             config_name="fleet.split-threshold", validator=interval,
             help="mid-scan re-planning multiplier: an in-flight fs shard past this x the "
                  "median shard wall is split at a directory boundary and the fragments "
                  "re-scattered (default 3.0; 0 disables; env "
                  "TRIVY_TPU_FLEET_SPLIT_THRESHOLD)"),
        Flag("fleet-register-token", default=None, config_name="fleet.register-token",
             help="dedicated bearer token for the POST /fleet/register live-join seam "
                  "(default: the scan --token gates it; a bad token answers 403)"),
    ])


def _count(v):
    from trivy_tpu_torch.rpc.admission import validate_count

    return validate_count(v, "value")


def _seconds(v):
    from trivy_tpu_torch.rpc.admission import validate_seconds

    return validate_seconds(v, "value")


def admission_flags() -> FlagGroup:
    """The JAX admission group of ``server``: the admission queue, tenant
    quotas and the async job API, validated at flag resolution (a garbage
    value, from the environment too, fails the server's start)."""
    return FlagGroup("admission", [
        Flag("max-concurrent-scans", default=0, value_type=int,
             config_name="admission.max-concurrent-scans", validator=_count,
             help="concurrent-scan budget; > 0 enables admission control and the async "
                  "job API (0 = off)"),
        Flag("admission-queue-depth", default=None, value_type=int,
             config_name="admission.queue-depth", validator=_count,
             help="max queued jobs before submits shed with 503 (default 64)"),
        Flag("admission-queued-mb", default=None, value_type=int,
             config_name="admission.queued-mb", validator=_count,
             help="queued-bytes budget in MB (default: TRIVY_TPU_HBM_BUDGET_MB, 1024, "
                  "x device count)"),
        Flag("tenants", default=None, is_list=True, config_name="admission.tenants",
             help="tenant map, comma-separated name:token[:weight[:max_inflight"
                  "[:queued_mb]]] entries; tokens authenticate like --token and key "
                  "per-tenant quotas and the weighted fair dequeue"),
        Flag("tenant-max-inflight", default=None, value_type=int,
             config_name="admission.tenant-max-inflight", validator=_count,
             help="per-tenant concurrent-scan quota (default: the whole budget)"),
        Flag("tenant-queued-mb", default=None, value_type=int,
             config_name="admission.tenant-queued-mb", validator=_count,
             help="per-tenant queued-bytes quota in MB (default: the global budget)"),
        Flag("job-retention", default=None, value_type=int,
             config_name="admission.job-retention", validator=_count,
             help="finished async jobs kept for result polling (default 64)"),
        Flag("job-deadline", default=None, value_type=float,
             config_name="admission.job-deadline", validator=_seconds,
             help="default queue deadline in seconds for jobs that supply none "
                  "(0 = none); a client DeadlineSeconds always wins"),
    ])


_FS_GROUPS = [global_flags, scan_flags, report_flags, secret_flags, license_flags,
              misconf_flags, db_flags, server_client_flags, tuning_flags]
# the JAX fleet commands' groups: the fleet group after client/server
_FLEET_GROUPS = [*_FS_GROUPS[:8], fleet_flags, tuning_flags]
# the commands that resolve a TuningConfig and scan through the secret feed
TUNED_COMMANDS = ("fs", "rootfs", "repo", "watch", "image", "vm")
# the commands whose --server runs the scan in client mode; the others with
# the flag scan locally, as the JAX CLI's do
CLIENT_COMMANDS = ("fs", "rootfs", "repo")
# the commands with the fleet group (--fleet scatters the scan over servers)
FLEET_COMMANDS = ("fs", "rootfs", "repo", "image")
_TARGET_GROUPS = {
    "fs": [*_FLEET_GROUPS, incremental_flags],
    "rootfs": [*_FLEET_GROUPS, incremental_flags],
    "repo": [*_FLEET_GROUPS, incremental_flags],
    # the JAX watch's groups: no client/server, no incremental flags
    "watch": [global_flags, scan_flags, report_flags, secret_flags, license_flags,
              misconf_flags, db_flags, tuning_flags],
    "image": [*_FLEET_GROUPS, image_flags, incremental_flags],
    "vm": _FS_GROUPS,
    "sbom": [global_flags, scan_flags, report_flags, db_flags, server_client_flags],
    "convert": [global_flags, report_flags],
    "server": [global_flags, db_flags, admission_flags],
    "clean": [global_flags],
}
_HELP = {
    "fs": "scan a local filesystem for vulnerabilities, secrets and licenses",
    "rootfs": "scan an exported root filesystem (the fs scan under another name)",
    "repo": "scan a git repository (local path or remote URL)",
    "watch": "watch a directory: incremental re-scan on change (CI mode)",
    "image": "scan a container image (archive, OCI layout, daemon or registry ref)",
    "vm": "scan a VM disk image (raw; MBR/GPT + ext4)",
    "sbom": "scan an SBOM (CycloneDX/SPDX) for vulnerabilities",
    "convert": "convert a saved JSON report into another format",
    "server": "run the scan server (detection on --device)",
    "clean": "clean caches and databases",
}
_TARGET_HELP = {"fs": "directory to scan", "rootfs": "root filesystem directory",
                "repo": "repository path or URL", "watch": "directory to watch",
                "vm": "raw disk image", "sbom": "SBOM file", "convert": "JSON report"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="trivy_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)
    groups_by_cmd = {}
    for cmd, factories in _TARGET_GROUPS.items():
        sp = sub.add_parser(cmd, help=_HELP[cmd])
        groups = [f() for f in factories]
        for g in groups:
            g.add_to_parser(sp)
        groups_by_cmd[cmd] = groups
        if cmd == "server":
            sp.add_argument("--listen", default="0.0.0.0:4954", help="listen address")
            sp.add_argument("--token", default="", help="auth token required from clients")
            sp.add_argument("--token-header", default=DEFAULT_TOKEN_HEADER,
                            help="header carrying the auth token")
            sp.add_argument("--device", choices=["cuda", "cpu"], default=DEFAULT_DEVICE,
                            help="device of the detection (the resident CVE join)")
            continue
        if cmd == "clean":
            sp.add_argument("--all", action="store_true", dest="clean_all")
            sp.add_argument("--scan-cache", action="store_true")
            sp.add_argument("--vuln-db", action="store_true", dest="vuln_db")
            continue
        if cmd != "convert":  # convert touches no device and scans nothing
            # the port's own flags: the command line only; an unset
            # --device follows --backend (cuda unless it is cpu)
            sp.add_argument("--device", choices=["cuda", "cpu"], default=None,
                            help="device of the scan (default: cuda; the CPU with "
                                 "--backend cpu)")
            sp.add_argument("--stats-out", default="",
                            help="write the scan's counters (files, components, seconds, "
                                 "the CVE join's rows, dispatches and bound bytes uploaded, "
                                 "the secret feed's rows, dedup and wire bytes; for an image "
                                 "its layers analyzed and cached) as JSON")
        if cmd == "image":
            # ref: trivy image --input for archives; positional for names
            sp.add_argument("--input", default=None,
                            help="image archive (docker save tar / OCI layout)")
            sp.add_argument("target", nargs="?", default=None,
                            help="image archive path or image reference")
        else:
            if cmd == "repo":
                for ref in ("branch", "tag", "commit"):
                    sp.add_argument(f"--{ref}", default=None, help=f"{ref} to check out")
            elif cmd == "watch":
                sp.add_argument("--watch-interval", default=2.0, type=float,
                                help="seconds between re-scans (default 2)")
                sp.add_argument("--watch-count", default=0, type=int,
                                help="stop after N scans (0 = run until ^C)")
            sp.add_argument("target", help=_TARGET_HELP[cmd])
    # the JAX CLI's bundle renderer, with its global flags
    sp = sub.add_parser("debug", help="render a flight-recorder diagnostic bundle "
                                      "(timeline + verdict)")
    groups_by_cmd["debug"] = [global_flags()]
    groups_by_cmd["debug"][0].add_to_parser(sp)
    sp.add_argument("target", help="diagnostic bundle path (.json.gz or .json)")
    # the JAX CLI's k8s command, with its own flags (trivy_tpu/cli.py:595-609)
    kp = sub.add_parser("k8s", help="scan Kubernetes workloads (manifests dump or kubectl)")
    kp.add_argument("--manifests", default=None,
                    help="manifest file/dir or cluster dump (kubectl get -o yaml/json)")
    kp.add_argument("--context", default=None, help="kubectl context (live cluster)")
    kp.add_argument("--format", default="table", choices=["table", "json"])
    kp.add_argument("-o", "--output", default=None)
    kp.add_argument("--scan-images", action="store_true",
                    help="also pull and scan workload images (registry source)")
    kp.add_argument("--insecure", action="store_true",
                    help="allow plain-HTTP registries for image pulls")
    kp.add_argument("--db-repository", default=None,
                    help="advisory DB location for image vulnerability scans")
    kp.add_argument("--compliance", default=None,
                    help="compliance spec over the scan (k8s-cis-1.23, eks-cis-1.4, "
                         "k8s-nsa-1.0, @path)")
    kp.add_argument("--device", choices=["cuda", "cpu"], default=DEFAULT_DEVICE,
                    help="device of the image scans (the secret feed, the CVE join)")
    # the JAX CLI's flagless commands (trivy_tpu/cli.py build_parser)
    pp = sub.add_parser("plugin", help="manage plugins (install/list/run/uninstall)")
    psub = pp.add_subparsers(dest="plugin_cmd")
    psub.add_parser("install").add_argument("source")
    psub.add_parser("list")
    psub.add_parser("uninstall").add_argument("name")
    pr = psub.add_parser("run")
    pr.add_argument("name")
    pr.add_argument("plugin_args", nargs=argparse.REMAINDER)
    vp = sub.add_parser("version", help="print version")
    vp.add_argument("--format", default="text", choices=["text", "json"])
    p.set_defaults(_groups_by_cmd=groups_by_cmd)
    return p


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command == "version":
        print(json.dumps({"Version": VERSION}) if args.format == "json"
              else f"trivy-tpu version {VERSION}")
        return 0
    if args.command == "plugin":
        return _run_plugin(parser, args)
    if args.command == "k8s":
        return _run_k8s(args)
    try:
        config = load_config_file(args.config)
        opts = resolve_all(args._groups_by_cmd[args.command], args, config)
        if "backend" in opts and args.device is None:
            args.device = "cpu" if opts["backend"] == "cpu" else DEFAULT_DEVICE
        interval = opts["telemetry_interval"]
        if interval is None:
            interval = timeseries.default_interval()
        if opts["fault_inject"]:
            faults.parse(opts["fault_inject"])  # a bad spec exits 2
        # one TuningConfig per run (a bad knob in the environment exits 2)
        args.tuning = (_resolve_tuning(opts, args.device)
                       if args.command in TUNED_COMMANDS else None)
        args.fleet_config = None
        if args.command in FLEET_COMMANDS:
            args.fleet_config = _fleet_config(opts, args.tuning)
    except (ValueError, FileNotFoundError) as e:
        parser.error(str(e))
    log.init(debug=opts["debug"], quiet=opts["quiet"], fmt=opts["log_format"])
    if args.command == "debug":
        return _run_debug(args.target)
    # flight-recorder forensics destination (--debug-dir wins over
    # TRIVY_TPU_DEBUG_DIR); without one, no bundle is written
    if opts["debug_dir"]:
        flight.set_debug_dir(opts["debug_dir"])
    # the fault-injection harness is armed for this command only
    if opts["fault_inject"]:
        faults.configure(opts["fault_inject"])
        logger.warning("fault injection armed: %s", opts["fault_inject"])
    if args.command == "server":
        # not one scan: no --timeout alarm and no process-wide sampler (the
        # server samples each request), as in the JAX package
        try:
            return _run_server(args, opts)
        finally:
            if opts["fault_inject"]:
                faults.clear()
    timeout = int(opts["timeout"] or 0)

    def on_timeout(signum, frame):
        raise ScanTimeout(f"scan exceeded --timeout={timeout}s")

    # the alarm is a signal, which only the main thread can take: a caller
    # running main() on another thread gets no timeout; watch is no one scan
    alarm = (timeout > 0 and args.command != "watch"
             and threading.current_thread() is threading.main_thread())
    if alarm:
        prev_handler = signal.signal(signal.SIGALRM, on_timeout)
        signal.alarm(timeout)
    # span recording for --trace and whenever an export is asked for; the
    # sampler only when something reads it (the JAX package's rule)
    trace_on = bool(opts["trace"] or opts["trace_out"] or opts["metrics_out"]
                    or opts["profile_out"])
    telemetry_on = (trace_on or bool(opts["timeseries_out"]) or opts["live"]) and interval > 0
    with obs.scan_context(name=args.command, enabled=trace_on or None) as ctx:
        if args.tuning is not None:
            # every export carries the knobs the scan resolved
            ctx.tuning = {"config": args.tuning.to_dict()}
        sampler = timeseries.start_sampler(ctx, interval) if telemetry_on else None
        live = timeseries.LiveProgress(ctx).start() if opts["live"] and telemetry_on else None
        completed = False
        try:
            rc = _run(args, opts)
            completed = True
            return rc
        except ScanTimeout as e:
            logger.error("%s", e)
            return 1
        finally:
            if opts["fault_inject"]:
                faults.clear()
            if alarm:
                signal.alarm(0)
                signal.signal(signal.SIGALRM, prev_handler)
            # a scan that died emits its black box, and so does a scan that
            # completed on a degraded path (no-ops without a debug dir)
            if not completed:
                flight.auto_emit("terminal-failure", ctx=ctx, error=sys.exc_info()[1])
            elif ctx.health_snapshot().get("scan.degraded"):
                flight.auto_emit("degraded-completion", ctx=ctx)
            # on every exit path: the sampler and the live line stop (a final
            # tick), then the files are written; progress reads 100% only
            # for a scan that completed
            if completed and ctx.progress_peek() is not None:
                ctx.progress().finish()
            if live is not None:
                live.stop()
            if sampler is not None:
                sampler.stop()
            _write_exports(ctx, opts)


def _write_exports(ctx, opts: dict) -> None:
    """``--timeseries-out``, then (tracing on) ``--trace``'s table and the
    trace, metrics and profile documents."""
    if opts["timeseries_out"]:
        export.write_timeseries_json(ctx, opts["timeseries_out"])
        logger.info("telemetry time series written to %s", opts["timeseries_out"])
    if not ctx.enabled:
        return
    if opts["trace"]:
        ctx.report()
    for key, write, what in (("trace_out", export.write_chrome_trace, "chrome trace"),
                             ("metrics_out", export.write_metrics_json, "metrics"),
                             ("profile_out", export.write_profile_json, "scan profile")):
        if opts[key]:
            write(ctx, opts[key])
            logger.info("%s written to %s", what, opts[key])


def _run(args, opts: dict) -> int:
    """The command's scan, its ``--stats-out`` counters and its report."""
    if args.command == "clean":
        return _run_clean(args, opts)
    try:
        # validate the ignore policy up front: a broken policy file must not
        # cost the user a full scan before failing
        if opts["ignore_policy"]:
            IgnorePolicy(opts["ignore_policy"])
        if args.command == "convert":
            return _run_convert(args.target, opts)
        # the SBOM and snapshot formats and the dependency tree need the
        # whole inventory (trivy_tpu/commands.py::_scan_options)
        opts["list_all_pkgs"] = (opts["list_all_pkgs"] or opts["dependency_tree"]
                                 or opts["format"] in LIST_ALL_FORMATS)
        if args.fleet_config is not None and "misconfig" in opts["scanners"]:
            # a JAX shard carries neither, so the JAX replicas scan every
            # type with the builtin checks; the JAX CLI says nothing
            for key in ("misconfig_scanners", "config_check"):
                if opts[key]:
                    logger.warning("--%s is ignored by the fleet's replicas: a shard carries "
                                   "no misconfiguration settings, as in the JAX package",
                                   key.replace("_", "-"))
        if (opts.get("server") and args.command not in CLIENT_COMMANDS
                and args.fleet_config is None):
            # the JAX image, vm and sbom runners never read --server
            logger.warning("--server is ignored by %s: the scan runs locally, as the JAX "
                           "CLI's does", args.command)
        if args.command == "watch":
            return _run_watch(args, opts)
        if args.command == "sbom":
            # --skip-dirs, --skip-files and --parallel have no effect on an
            # SBOM, as in the JAX sbom
            report, counters = scan_sbom(args.target, device=args.device,
                                         db_repository=opts["db_repository"],
                                         cache_dir=opts["cache_dir"],
                                         list_all_pkgs=opts["list_all_pkgs"],
                                         host_fallback=not opts["no_host_fallback"],
                                         scanners=opts["scanners"])
        elif args.command == "image":
            target = args.input or args.target
            if not target:
                logger.error("specify an image archive path (positional or --input)")
                return 1
            if args.fleet_config is not None and opts["server"]:
                logger.error("--fleet and --server are mutually exclusive")
                return 2
            # the JAX _run_image reads only --diff-base of the group, and
            # with --fleet not even that
            ignored = [f"--{k.replace('_', '-')}" for k in ("incremental", "since_last")
                       + (("diff_base",) if args.fleet_config is not None else ()) if opts[k]]
            if ignored:
                logger.warning("%s ignored by image%s: the scan runs as without it, as the "
                               "JAX CLI's does", " and ".join(ignored),
                               " --fleet" if args.fleet_config is not None else "")
            if args.fleet_config is not None:
                report, counters = _run_fleet("image", target, args, opts)
            else:
                report, counters = _run_scan(scan_image, target, args, opts,
                                             cache=_make_cache(opts),
                                             parallel=max(0, opts["parallel"]),
                                             image_source=_image_source(opts),
                                             diff_base=opts["diff_base"])
        elif args.command == "vm":
            report, counters = _run_scan(scan_vm, args.target, args, opts,
                                         cache=_make_cache(opts))
        else:
            incr = _incremental_options(opts)
            if args.fleet_config is not None:
                # the JAX _run_fs_like's refusals
                if opts["server"]:
                    logger.error("--fleet and --server are mutually exclusive")
                    return 2
                if incr is not None:
                    logger.error("--incremental/--diff-base/--since-last do not compose with "
                                 "--fleet yet (replicas already skip cached layers; use the "
                                 "shared cache backend for cross-scan reuse)")
                    return 2
            if opts["server"] and incr is not None:
                # the JAX _run_fs_like's refusal: the diff needs a local cache
                logger.error("--incremental/--diff-base/--since-last require a local scan "
                             "path (drop --server or run the scan on the server)")
                return 2
            target = args.target
            if args.command == "repo" and is_remote(target):
                target = checkout_repo(target, branch=args.branch, tag=args.tag,
                                       commit=args.commit)
            if args.fleet_config is not None:
                report, counters = _run_fleet("fs", target, args, opts)
            elif incr is None:
                report, counters = _run_scan(scan_fs, target, args, opts,
                                             parallel=max(0, opts["parallel"]),
                                             server=opts["server"], token=opts["token"] or "")
            else:
                from trivy_tpu_torch.incremental.manifest import GitDiffError

                try:
                    report, counters = _run_scan(scan_fs, target, args, opts,
                                                 parallel=max(0, opts["parallel"]),
                                                 cache=_make_cache(opts), incremental=incr)
                except GitDiffError as e:
                    # a mistyped ref or no git worktree: an error, never a
                    # quiet full scan
                    logger.error("--diff-base %s: %s", incr.diff_base, e)
                    return 1
        if args.stats_out:
            with open(args.stats_out, "w", encoding="utf-8") as f:
                json.dump(counters, f, indent=2)
        return _emit(report, opts)
    except PolicyError as e:
        # a broken policy: no report
        logger.error("%s", e)
        return 2
    except (DaemonError, RegistryError, RepoError, DiffBaseError) as e:
        # a target or base that cannot be found, pulled or cloned: no report
        logger.error("%s", e)
        return 1
    except FleetError as e:
        # every replica dead with --no-host-fallback, a failed local
        # fallback, a daemon image: no report
        logger.error("fleet scan failed: %s", e)
        return 1


def _incremental_options(opts: dict):
    """The :class:`~trivy_tpu_torch.incremental.IncrementalOptions` of the
    flags, None when none is set: a scan without them imports nothing of
    ``incremental`` and writes no manifest (the JAX package's rule)."""
    if not (opts["incremental"] or opts["diff_base"] or opts["since_last"]):
        return None
    from trivy_tpu_torch.incremental import IncrementalOptions

    return IncrementalOptions.from_opts(opts)


def _pause(seconds: float) -> None:
    """The wait between two ``watch`` scans."""
    time.sleep(seconds)


def _run_watch(args, opts: dict) -> int:
    """``watch <dir>`` (the JAX package's ``commands._run_watch``): scan,
    then scan again every ``--watch-interval`` seconds, each scan a
    ``--since-last`` incremental one on one cache. A report (and
    ``--stats-out``) is written after the first scan and after every scan
    that analyzed a unit or whose set of unit keys changed (a deletion).
    Stops after ``--watch-count`` scans (0: never) or at Ctrl-C, with the
    last report's exit code."""
    from trivy_tpu_torch.incremental import IncrementalOptions

    interval = float(args.watch_interval or 0) or 2.0
    max_scans = int(args.watch_count or 0)
    cache = _make_cache(opts)
    # one DB for every scan, as the JAX watch keeps one driver
    db = load_db(opts["db_repository"], opts["cache_dir"]) if "vuln" in opts["scanners"] else None
    incr = IncrementalOptions(enabled=True, since_last=True)
    rc = n = 0
    prev_units = None
    try:
        while True:
            n += 1
            report, counters = _run_scan(scan_fs, args.target, args, opts,
                                         parallel=max(0, opts["parallel"]), db=db,
                                         cache=cache, incremental=incr)
            analyzed = counters["units_analyzed"]
            if n == 1 or analyzed > 0 or counters["unit_set"] != prev_units:
                if args.stats_out:
                    with open(args.stats_out, "w", encoding="utf-8") as f:
                        json.dump(counters, f, indent=2)
                rc = _emit(report, opts)
                logger.info("watch scan #%d: %d/%d unit(s) re-analyzed", n, analyzed,
                            counters["units_total"])
            else:
                logger.info("watch scan #%d: no changes", n)
            prev_units = counters["unit_set"]
            if max_scans and n >= max_scans:
                return rc
            _pause(interval)
    except KeyboardInterrupt:
        logger.info("watch stopped after %d scan(s)", n)
        return rc


def _run_server(args, opts: dict) -> int:
    """``server``: serve the Cache and Scanner services on ``--listen``
    until SIGTERM, detecting on ``--device`` (the JAX package's
    ``commands._run_server``). A garbage admission setting exits 1 at
    boot."""
    from trivy_tpu_torch.rpc.admission import resolve_admission
    from trivy_tpu_torch.rpc.server import serve

    host, _, port = args.listen.rpartition(":")
    try:
        admission = resolve_admission(opts)
    except ValueError as e:
        logger.error("%s", e)
        return 1
    serve(host or "0.0.0.0", int(port), cache_dir=opts["cache_dir"], token=args.token or "",
          token_header=args.token_header or DEFAULT_TOKEN_HEADER,
          db_repository=opts["db_repository"], admission=admission, device=args.device)
    return 0


def _run_debug(path: str) -> int:
    """``debug <bundle>``: render a flight-recorder diagnostic bundle as
    the machine verdict, a relative event timeline and the device-lane and
    stall summaries (the JAX package's ``commands._run_debug``)."""
    import datetime

    try:
        doc = flight.read_bundle(path)
    except (OSError, ValueError) as e:
        logger.error("cannot read bundle %s: %s", path, e)
        return 1
    w = sys.stdout.write
    w(f"bundle:  {path}\n")
    w(f"schema:  {doc.get('schema', '?')}\n")
    w(f"reason:  {doc.get('reason', '?')}\n")
    w(f"created: {doc.get('created', '?')}\n")
    w(f"scan:    {doc.get('name', '?')} (trace {str(doc.get('trace_id', ''))[:8]})\n")
    if doc.get("error"):
        w(f"error:   {doc['error']}\n")
    w("\nverdict\n  " + str(doc.get("verdict", "(none)")) + "\n")
    events = doc.get("events") or doc.get("process_events") or []
    if events:
        w(f"\ntimeline ({len(events)} event(s))\n")
        t0 = events[0].get("t", 0.0)
        for ev in events:
            ts = datetime.datetime.fromtimestamp(
                ev.get("t", 0.0), datetime.timezone.utc).strftime("%H:%M:%S")
            line = (f"  +{ev.get('t', 0.0) - t0:8.2f}s {ts} "
                    f"{ev.get('kind', '?'):8s} {ev.get('what', '')}")
            detail = ev.get("detail")
            if detail:
                line += "  " + " ".join(f"{k}={v}" for k, v in detail.items())
            w(line + "\n")
    dev = doc.get("device")
    if dev:
        w("\ndevice lane\n")
        if dev.get("card"):
            w(f"  card: {dev['card']}\n")
        w(f"  compiles: {dev.get('compile_total', 0)} ({dev.get('compile_wall_s', 0.0)}s wall) "
          f"across {len(dev.get('compiles', {}))} kernel(s)\n")
        for kern, row in sorted((dev.get("compiles") or {}).items()):
            w(f"    {kern}: {row.get('count', 0)} compile(s), {row.get('wall_s', 0.0)}s\n")
        storms = dev.get("recompile_storms") or []
        if storms:
            w(f"  RECOMPILE STORMS: {', '.join(storms)} "
              f"(threshold {dev.get('storm_threshold')})\n")
        hbm = dev.get("hbm") or {}
        if hbm:
            w(f"  hbm: {hbm}\n")
    stall = doc.get("stall")
    if stall:
        w(f"\nstall attribution\n  {stall}\n")
    return 0


def _image_source(opts: dict) -> ImageSourceOption:
    """The image flags as the JAX package's ``ArtifactOption`` takes them
    (``trivy_tpu/commands.py:148-160``); unset ``--image-src`` keeps the
    default order."""
    src = ImageSourceOption(
        docker_host=opts["docker_host"] or "", podman_host=opts["podman_host"] or "",
        containerd_host=opts["containerd_host"] or "", insecure_registry=opts["insecure"],
        registry_username=opts["username"] or "", registry_password=opts["password"] or "",
        platform=opts["platform"] or "")
    if opts["image_src"]:
        src.image_src = list(opts["image_src"])
    return src


def _run_convert(path: str, opts: dict) -> int:
    """Re-render the saved JSON report at ``path`` through :func:`_emit`
    (the JAX package's ``commands._run_convert``)."""
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    return _emit(Report.from_dict(doc), opts)


def _run_clean(args, opts: dict) -> int:
    """``clean`` (the JAX package's ``commands._run_clean``): with
    ``--scan-cache`` the fs scan cache of ``--cache-dir`` is cleared, with
    ``--vuln-db`` ``<cache-dir>/db`` is removed, ``--all`` does both; with
    neither it exits 1."""
    import shutil

    from trivy_tpu_torch.cache.fs import default_cache_dir

    scan_cache = args.scan_cache or args.clean_all
    vuln_db = args.vuln_db or args.clean_all
    if not (scan_cache or vuln_db):
        logger.error("specify what to clean: --scan-cache, --vuln-db or --all")
        return 1
    if scan_cache:
        new_cache("fs", opts["cache_dir"]).clear()
        logger.info("scan cache cleared")
    if vuln_db:
        target = os.path.join(opts["cache_dir"] or default_cache_dir(), "db")
        if os.path.isdir(target):
            shutil.rmtree(target)
            logger.info("%s removed", target)
        else:
            logger.info("%s not present", target)
    return 0


def _run_k8s(args) -> int:
    """``k8s`` (the JAX CLI's ``main`` branch): the workloads of
    ``--manifests`` or of ``kubectl`` (exit 1 when neither loads), their
    summary, or with ``--compliance`` the spec's report over their rows (an
    unknown spec exits 1, as in JAX); ``--scan-images`` adds a row per
    workload image, scanned on ``--device``."""
    from trivy_tpu_torch import k8s

    try:
        docs = (k8s.load_manifests(args.manifests) if args.manifests
                else k8s.load_cluster(args.context))
    except RuntimeError as e:
        logger.error("%s", e)
        return 1
    rows = k8s.scan_workloads(docs)
    if args.compliance:
        from trivy_tpu_torch.compliance import apply_spec, load_spec, write_report
        from trivy_tpu_torch.types import Result

        try:
            spec = load_spec(args.compliance)
        except Exception as e:
            # exit 1 as in JAX, where a file that is no YAML spec ends
            # with a traceback instead
            logger.error("--compliance %s: %s", args.compliance, e)
            return 1
        report = Report(artifact_name="k8s cluster", results=[
            Result(target=f"{r['namespace']}/{r['kind']}/{r['name']}", cls="config",
                   misconfigurations=list(r["failures"]) + list(r.get("successes", [])))
            for r in rows])
        creport = apply_spec(spec, report)
        if args.output:
            with open(args.output, "w", encoding="utf-8") as f:
                write_report(creport, f, args.format)
        else:
            write_report(creport, sys.stdout, args.format)
        return 0
    image_rows = None
    if args.scan_images:
        db = load_default_db(args.db_repository, None)
        if db is None:
            logger.warning("no advisory DB found; image scans report secrets only "
                           "(--db-repository to supply one)")
        image_rows = k8s.scan_images(k8s.workload_images(docs), insecure=args.insecure, db=db,
                                     device=args.device)
    if args.output:
        with open(args.output, "w", encoding="utf-8") as f:
            k8s.write_summary(rows, f, args.format, image_rows)
    else:
        k8s.write_summary(rows, sys.stdout, args.format, image_rows)
    return 0


def _run_plugin(parser, args) -> int:
    """``plugin install|list|uninstall|run`` (the JAX CLI's, over the same
    plugin root): a :class:`~trivy_tpu_torch.plugin.PluginError` or an
    ``OSError`` exits 1, ``run`` exits with the plugin's code."""
    from trivy_tpu_torch import plugin

    try:
        if args.plugin_cmd == "install":
            manifest = plugin.install(args.source)
            print(f"installed {manifest['name']} {manifest.get('version', '')}")
        elif args.plugin_cmd == "list":
            for m in plugin.list_installed():
                print(f"{m['name']}\t{m.get('version', '')}\t{m.get('summary', '')}")
        elif args.plugin_cmd == "uninstall":
            print("removed" if plugin.uninstall(args.name) else f"{args.name} is not installed")
        elif args.plugin_cmd == "run":
            return plugin.run(args.name, list(args.plugin_args or []))
        else:
            parser.parse_args(["plugin", "--help"])
        return 0
    except plugin.PluginError as e:
        logger.error("%s", e)
        return 1
    except OSError as e:  # an unreadable archive, a binary that will not run
        logger.error("plugin %s failed: %s", args.plugin_cmd, e)
        return 1


def _emit(report: Report, opts: dict) -> int:
    """Filter, write, and the exit code (ref: pkg/commands/artifact/run.go;
    the JAX package's ``commands._emit``). With ``--compliance`` the
    compliance report of the filtered scan is written instead."""
    filter_report(report, FilterOptions(
        severities=opts["severity"], ignore_file=opts["ignorefile"],
        vex_sources=opts["vex"], policy_file=opts["ignore_policy"],
        show_suppressed=opts["show_suppressed"], cache_dir=opts["cache_dir"] or ""))
    if opts.get("compliance"):
        return _emit_compliance(report, opts)
    kw = {k: True for k in ("show_suppressed", "dependency_tree") if opts[k]}
    if opts["template"]:
        kw["template"] = opts["template"]
    if opts["output"]:
        with open(opts["output"], "w", encoding="utf-8") as f:
            report_pkg.write(report, opts["format"], f, **kw)
    else:
        report_pkg.write(report, opts["format"], sys.stdout, **kw)
    if opts["exit_code"] and any(not r.is_empty for r in report.results):
        return opts["exit_code"]
    return 0


def _emit_compliance(report: Report, opts: dict) -> int:
    """``--compliance``: the spec's report over ``report`` in ``table`` or
    ``json``; any other format or a spec that cannot be loaded exits 2, and
    ``--exit-code`` applies when a control fails (the JAX ``_emit``; a spec
    file that YAML cannot parse ends the JAX CLI with a traceback)."""
    from trivy_tpu_torch.compliance import apply_spec, load_spec, write_report

    fmt = opts["format"]
    if fmt not in ("table", "json"):
        logger.error("--compliance supports only table and json output, not %s", fmt)
        return 2
    try:
        spec = load_spec(opts["compliance"])
    except Exception as e:
        # the JAX CLI exits 2 for an unknown name or a missing file, and
        # ends with a traceback for a file that is no YAML spec
        logger.error("--compliance %s: %s", opts["compliance"], e)
        return 2
    creport = apply_spec(spec, report)
    if opts["output"]:
        with open(opts["output"], "w", encoding="utf-8") as f:
            write_report(creport, f, fmt)
    else:
        write_report(creport, sys.stdout, fmt)
    if opts["exit_code"] and any(r.status == "FAIL" for r in creport.results):
        return opts["exit_code"]
    return 0


def _resolve_tuning(opts: dict, device) -> TuningConfig:
    """The run's one :class:`~trivy_tpu_torch.tuning.TuningConfig` (the JAX
    package's ``commands._resolve_tuning``): the feed knobs, ``--parallel``,
    the dedup budget, the wire codec, the autotune record and the
    controller, each CLI > env > autotune record > default."""
    return resolve_tuning(opts={
        "secret_streams": opts["secret_streams"],
        "secret_inflight": opts["secret_inflight"],
        "secret_arena_slabs": opts["secret_arena_slabs"],
        "secret_bucket_rungs": opts["secret_bucket_rungs"],
        "parallel": opts["parallel"],
        "secret_dedup_mb": opts["secret_dedup_mb"],
        # --no-secret-compress is the loud opt-out shorthand
        "secret_compress": "off" if opts["no_secret_compress"] else opts["secret_compress"],
        "secret_compress_min_ratio": opts["secret_compress_min_ratio"],
        "tuning_file": opts["tuning_file"],
        # only an explicit --tune is a command-line decision
        "tuning_controller": opts["tune"] or None,
        "tuning_interval": opts["tuning_interval"],
        # the fleet group's knobs, on the commands that have it
        "fleet_inflight": opts.get("fleet_inflight"),
        "fleet_telemetry_interval": opts.get("fleet_telemetry_interval"),
        "fleet_split_threshold": opts.get("fleet_split_threshold"),
    }, device=device)


def _make_cache(opts: dict):
    """The cache of ``--cache-backend`` (``fs`` by default), with the redis
    flags for a redis URL (the JAX package's ``commands._make_cache``)."""
    backend = opts["cache_backend"] or "fs"
    kw = {}
    if backend.startswith(REDIS_SCHEMES):
        kw = {"ttl": int(opts["cache_ttl"] or 0), "ca_cert": opts["redis_ca"] or "",
              "client_cert": opts["redis_cert"] or "", "client_key": opts["redis_key"] or "",
              "insecure_skip_verify": bool(opts["redis_insecure"])}
    return new_cache(backend, opts["cache_dir"], **kw)


def _run_scan(scan, target: str, args, opts: dict, **extra) -> tuple[Report, dict]:
    """``scan`` (:func:`scan_fs`, :func:`scan_image` or :func:`scan_vm`) of
    ``target`` with the resolved flags and the run's TuningConfig."""
    config = opts["secret_config"] if os.path.exists(opts["secret_config"]) else None
    return scan(
        target, config_path=config, device=args.device,
        skip_dirs=opts["skip_dirs"], skip_files=opts["skip_files"], scanners=opts["scanners"],
        license_full=opts["license_full"], shared_arena=not opts["no_shared_arena"],
        db_repository=opts["db_repository"], cache_dir=opts["cache_dir"],
        java_db=opts["java_db"], list_all_pkgs=opts["list_all_pkgs"],
        check_paths=opts["config_check"], misconfig_scanners=opts["misconfig_scanners"],
        dedup=not opts["no_secret_dedup"],
        # its own handle: the hit store outlives any one use of the cache
        hit_cache=_make_cache(opts) if opts["secret_hit_cache"] else None,
        pack_small=not opts["no_secret_pack"], prefilter=not opts["no_secret_prefilter"],
        # the JAX package sizes the confirm pool by --parallel too
        confirm_workers=max(0, opts["parallel"]), tuning=args.tuning,
        host_fallback=not opts["no_host_fallback"],
        **extra,
    )


def _fleet_config(opts: dict, tuning: TuningConfig | None):
    """The run's :class:`~trivy_tpu_torch.fleet.coordinator.FleetConfig`,
    None without ``--fleet``; its ``telemetry_interval`` resolves the flag,
    its variable, the config file and the default 1.0 in that order."""
    if not opts["fleet"]:
        return None
    from trivy_tpu_torch.fleet.coordinator import FleetConfig

    return FleetConfig.from_opts(opts, tuning=tuning)


def _run_fleet(kind: str, target: str, args, opts: dict) -> tuple[Report, dict]:
    """:func:`scan_fleet` of ``target`` with the resolved flags; with
    ``--secret-hit-cache`` the scan cache's warm dedup entries ride each
    replica's first shard."""
    cfg = args.fleet_config
    cache = _make_cache(opts)
    if opts["secret_hit_cache"]:
        from trivy_tpu_torch.secret.hitstore import export_backend_warm

        try:
            cfg.warm_seed = export_backend_warm(cache)
        except Exception as e:
            logger.warning("dedup warm export skipped: %s", e)
        if cfg.warm_seed:
            logger.info("fleet dedup warming: %d entr%s exported for replica pre-seeding",
                        len(cfg.warm_seed), "y" if len(cfg.warm_seed) == 1 else "ies")
    # the shards carry the rule file's path: absolute, so that a replica
    # running elsewhere on the same filesystem finds it
    config = (os.path.abspath(opts["secret_config"]) if os.path.exists(opts["secret_config"])
              else None)
    return scan_fleet(
        kind, target, cfg, cache=cache, config_path=config, device=args.device,
        skip_dirs=opts["skip_dirs"], skip_files=opts["skip_files"], scanners=opts["scanners"],
        license_full=opts["license_full"], shared_arena=not opts["no_shared_arena"],
        db_repository=opts["db_repository"], cache_dir=opts["cache_dir"],
        list_all_pkgs=opts["list_all_pkgs"], parallel=max(0, opts["parallel"]),
        image_source=_image_source(opts) if kind == "image" else None,
        host_fallback=not opts["no_host_fallback"])


if __name__ == "__main__":
    sys.exit(main())
