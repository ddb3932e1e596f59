"""Shard planner and replica-side shard executor, the port of
``trivy_tpu/fleet/plan.py``.

An artifact splits at its natural boundaries into self-contained shard
specs small enough to balance and steal, big enough that per-shard RPC
overhead stays noise:

- **Image artifacts** shard by layer: every layer the cache already holds
  is left out of the plan, and each missing layer becomes one shard
  carrying the exact blob key the single-host scan would store it under.
- **Filesystem/repo artifacts** shard by deterministic walk partition: one
  walk (the skip rules of a single-host scan) collects directory-atomic
  units (:func:`group_units`: sibling files and Helm chart subtrees never
  split), then LPT-balances them into byte-balanced partitions. The plan is
  a pure function of the tree.

The shard's wire form (its JSON keys and values) is the JAX planner's,
letter for letter, so a JAX coordinator can hand its shards to a port
server and the port's plan of a tree equals the JAX plan of it. The
incremental fs artifact (``trivy_tpu_torch/incremental/fs.py``) keys and
analyzes a tree over the same units.

The executor half (:func:`execute_shard`) runs on a replica, inside
``ScanServer.scan`` when a request carries a ``Shard`` block: the shard's
settings build a :class:`~trivy_tpu_torch.fanal.scan.ScanAnalyzers` on the
server's device, so on the card the secret feed and the license kernels run
there, and the shard's files go through the one walk loop
(:func:`~trivy_tpu_torch.fanal.scan.analyze_files`). It returns the blobs a
single-host scan would produce, under the JAX keys (a secret-only fs shard
aside: the port runs only the OS identity analyzers there, so its blob and
key differ while its findings do not).
"""

from __future__ import annotations

import os
from collections import Counter
from dataclasses import dataclass, field

from trivy_tpu_torch import log, obs
from trivy_tpu_torch.artifact.image import (
    DaemonImageArtifact,
    ImageArchiveArtifact,
    ImageRegistryArtifact,
    ImageSourceOption,
)
from trivy_tpu_torch.cache.key import calc_blob_key, calc_key
from trivy_tpu_torch.device import DEFAULT_DEVICE
from trivy_tpu_torch.fanal.handler import HandlerManager
from trivy_tpu_torch.fanal.scan import DEFAULT_PARALLEL, ScanAnalyzers, analyze_files, check_scanners
from trivy_tpu_torch.fanal.walker import FSWalker, WalkOption
from trivy_tpu_torch.fleet import FleetError

logger = log.logger("fleet:plan")

SHARD_KINDS = ("fs", "image-layer")
# fs-tree overpartition factor: a coordinator plans replicas x this many
# shards (--fleet-shards-per-replica 0); more shards give a finer steal
# grain at more per-shard RPC overhead
DEFAULT_SHARDS_PER_REPLICA = 4
# a shard's Backend: the JAX --backend choices (trivy_tpu/cli.py). "cpu"
# runs the shard on the CPU, every other one on the executing server's device
BACKENDS = ("auto", "pallas", "xla", "cpu")


class ShardRefused(ValueError):
    """A shard this port cannot run as asked: an unknown kind, scanner or
    backend. A server answers it with 400, never with a scan that would
    give other keys and findings."""


@dataclass
class ShardSpec:
    """One self-contained unit of fleet work. ``wire`` is the JSON body a
    replica executes; ``nbytes`` is the planner's balance/steal weight;
    ``blob_ids`` are the cache keys this shard's blobs land under (image
    shards know them up front; fs shards discover them post-analysis)."""

    index: int
    kind: str  # "fs" | "image-layer"
    nbytes: int
    wire: dict = field(default_factory=dict)
    blob_ids: list = field(default_factory=list)

    def label(self) -> str:
        return f"shard {self.index} ({self.kind}, {self.nbytes >> 10} KiB)"


@dataclass
class ShardSettings:
    """The scan settings a shard carries, the port's counterpart of the
    JAX ``ArtifactOption`` and ``ScanOptions`` fields the wire holds:
    ``scanners`` (any of ``vuln``, ``secret``, ``license``), ``license_full``,
    the ``device`` the analysis runs on, the skip lists, ``shared_arena``
    (the fused license gate), ``parallel`` read-ahead workers (0: the
    default), the ``--secret-config`` path, the registry options of an image
    source, and on a replica the ``warm_hits`` that seed its dedup store."""

    scanners: list = field(default_factory=lambda: ["secret"])
    license_full: bool = False
    device: str = DEFAULT_DEVICE
    skip_files: list = field(default_factory=list)
    skip_dirs: list = field(default_factory=list)
    shared_arena: bool = True
    parallel: int = 0
    secret_config: str | None = None
    image_source: ImageSourceOption = field(default_factory=ImageSourceOption)
    warm_hits: list | None = None


def _on_cpu(device) -> bool:
    return str(device).split(":")[0] == "cpu"


def _analysis_wire(settings: ShardSettings) -> dict:
    """The analysis-affecting knobs a shard must carry so the replica's
    analyzers match the coordinator's plan (cache keys and findings both
    depend on them), under the JAX wire keys."""
    wire = {
        "Scanners": list(settings.scanners),
        "LicenseFull": bool(settings.license_full),
        "Backend": "cpu" if _on_cpu(settings.device) else "auto",
        "SkipFiles": list(settings.skip_files),
        "SkipDirs": list(settings.skip_dirs),
        "SharedArena": bool(settings.shared_arena),
        "Parallel": int(settings.parallel or 0),
    }
    # a custom secret ruleset changes findings AND cache keys: ship the
    # path (fleet fs mode assumes a shared filesystem; a replica missing the
    # file fails the shard loudly, see shard_settings)
    if settings.secret_config:
        wire["SecretConfig"] = settings.secret_config
    # registry image sources need the coordinator's pull options on the
    # replica (the same trust domain as the token-authed RPC channel)
    src = settings.image_source
    reg = {
        "Insecure": bool(src.insecure_registry),
        "Username": src.registry_username or "",
        "Password": src.registry_password or "",
        "Platform": src.platform or "",
    }
    if any(reg.values()):
        wire["Registry"] = reg
    return wire


# -- filesystem planning -----------------------------------------------------


def group_units(files: list[tuple[str, int]]) -> list[tuple[str, list, int]]:
    """Directory-atomic unit grouping over ``[(rel, size), ...]``.

    Each unit is ``(unit_key, [(rel, size), ...], bytes)``, in the order of
    their keys, each unit's files sorted. A directory holding
    ``Chart.yaml`` pulls its whole subtree into one unit (a Helm chart is
    evaluated as a whole), the nearest enclosing chart winning; every other
    directory is its own unit, so sibling files (a manifest and its
    lockfile) stay together."""
    by_dir: dict[str, list[tuple[str, int]]] = {}
    chart_roots: list[str] = []
    for rel, size in files:
        d = rel.rsplit("/", 1)[0] if "/" in rel else ""
        by_dir.setdefault(d, []).append((rel, size))
        if rel.rsplit("/", 1)[-1] == "Chart.yaml":
            chart_roots.append(d)
    chart_roots.sort(key=len, reverse=True)

    def unit_for(d: str) -> str:
        for cr in chart_roots:  # longest (nearest enclosing) chart first
            if cr == "":
                return ""
            if d == cr or d.startswith(cr + "/"):
                return cr
        return d

    units_map: dict[str, list[tuple[str, int]]] = {}
    for d, entries in by_dir.items():
        units_map.setdefault(unit_for(d), []).extend(entries)
    units = []
    for key in sorted(units_map):
        entries = sorted(units_map[key])
        units.append((key, entries, sum(s for _, s in entries)))
    return units


def _walk_units(root: str, settings: ShardSettings) -> tuple[list[tuple[str, list, int]], int, int]:
    """One deterministic walk → directory-atomic units (see
    :func:`group_units`). Returns ``(units, total_bytes, total_files)``."""
    walker = FSWalker(WalkOption(skip_files=list(settings.skip_files),
                                 skip_dirs=list(settings.skip_dirs)))
    flat = [(rel, info.size) for rel, info, _opener in walker.walk(root)]
    return group_units(flat), sum(s for _, s in flat), len(flat)


def _lpt(units: list[tuple[str, list, int]], n: int) -> tuple[list[list], list[int]]:
    """Biggest unit first into the lightest of ``n`` bins; ties resolve by
    bin index, so the partition is a pure function of the units."""
    bins: list[list] = [[] for _ in range(n)]
    loads = [0] * n
    for _key, files, nbytes in sorted(units, key=lambda u: (-u[2], u[0])):
        i = min(range(n), key=lambda j: (loads[j], j))
        bins[i].extend(files)
        loads[i] += nbytes
    return bins, loads


def plan_fs_shards(root: str, settings: ShardSettings,
                   n_shards: int) -> tuple[list[ShardSpec], int, int]:
    """Deterministic byte-balanced fs partition plan. Returns
    ``(shards, total_bytes, total_files)``; shards come out largest-first
    (the dispatch order a coordinator's queues want)."""
    units, total_bytes, total_files = _walk_units(root, settings)
    n_shards = max(1, min(n_shards, len(units)) if units else 1)
    bins, loads = _lpt(units, n_shards)
    analysis = _analysis_wire(settings)
    shards = []
    order = sorted(range(n_shards), key=lambda j: (-loads[j], j))
    for idx, j in enumerate(order):
        if not bins[j]:
            continue
        shards.append(ShardSpec(
            index=idx, kind="fs", nbytes=loads[j],
            wire={
                "Kind": "fs",
                "Root": os.path.abspath(root),
                "Paths": sorted(rel for rel, _ in bins[j]),
                "Bytes": loads[j],
                **analysis,
            },
        ))
    return shards, total_bytes, total_files


def split_fs_shard(spec: ShardSpec, n: int = 2) -> list[ShardSpec] | None:
    """Mid-scan re-plan of one fs shard into ``n`` byte-balanced fragments
    at the same directory-atomic unit boundaries the original plan used, so
    the fragments are an exact partition of the shard's paths and the merge
    stays byte-identical.

    Fragment indexes interleave between the parent's and the next integer
    (``index + k/(n+1)``), so a sorted result fold keeps plan order without
    renumbering untouched shards. Returns None when the shard has fewer
    than 2 units (nothing to split at a directory boundary); image-layer
    shards are atomic and never split."""
    if spec.wire.get("Kind") != "fs" or n < 2:
        return None
    root = spec.wire["Root"]
    files = []
    for rel in spec.wire["Paths"]:
        try:
            size = os.path.getsize(os.path.join(root, rel))
        except OSError:
            # a file deleted since the plan: carried at zero weight — the
            # replica's walk owns per-file error semantics, the split must
            # not change WHICH paths are scanned
            size = 0
        files.append((rel, size))
    units = group_units(files)
    if len(units) < 2:
        return None
    n = min(n, len(units))
    bins, loads = _lpt(units, n)
    frags = []
    order = sorted(range(n), key=lambda j: (-loads[j], j))
    for k, j in enumerate(order):
        if not bins[j]:
            continue
        wire = dict(spec.wire)
        wire["Paths"] = sorted(rel for rel, _ in bins[j])
        wire["Bytes"] = loads[j]
        frags.append(ShardSpec(index=spec.index + (k + 1) / (n + 1), kind="fs",
                               nbytes=loads[j], wire=wire))
    return frags if len(frags) >= 2 else None


# -- image planning ----------------------------------------------------------


@dataclass
class ImagePlan:
    """Everything a merger needs to reassemble a fleet image scan into the
    exact single-host reference: the full blob-id list (cached + planned),
    artifact identity, and image metadata."""

    name: str
    artifact_key: str
    blob_ids: list
    config_key: str
    config_missing: bool
    image_metadata: dict
    shards: list


def plan_image_shards(artifact: ImageArchiveArtifact, cache,
                      settings: ShardSettings) -> ImagePlan:
    """Per-layer shard plan for an image artifact: the ``missing_blobs``
    diff leaves every cached layer out, and each missing layer becomes one
    shard carrying its planned blob key. Raises :class:`FleetError` for a
    daemon's image: its export is a temp file of this host that replicas
    cannot open, and the wire would carry the bare reference, which a
    replica would pull from a registry, possibly with other content."""
    if isinstance(artifact, DaemonImageArtifact):
        raise FleetError(
            f"fleet image scans need an archive path or a registry reference the replicas "
            f"can fetch; {artifact.path!r} resolved to a local daemon export (save it to an "
            "archive or push it to a registry first)")
    archive = artifact._open_source()
    try:
        plan = artifact.layer_plan(archive)
        blob_ids = plan["layer_keys"] + [plan["config_key"]]
        _, missing = cache.missing_blobs(plan["artifact_key"], blob_ids)
        missing_set = set(missing)
        analysis = _analysis_wire(settings)
        shards = []
        history = plan["history"]
        for i, (diff_id, lkey) in enumerate(zip(plan["diff_ids"], plan["layer_keys"])):
            if lkey not in missing_set:
                continue
            try:  # a registry source may not expose stored layer sizes;
                nbytes = max(1, int(archive.layer_size(i)))
            except Exception:  # weight 1 keeps the plan balanced by count
                nbytes = 1
            shards.append(ShardSpec(
                index=len(shards), kind="image-layer", nbytes=nbytes, blob_ids=[lkey],
                wire={
                    "Kind": "image-layer",
                    "Archive": artifact.path,
                    "Index": i,
                    "DiffID": diff_id,
                    "BlobID": lkey,
                    "CreatedBy": history[i].get("created_by", "") if i < len(history) else "",
                    "SkipSecret": i in plan["base_layers"],
                    "Bytes": nbytes,
                    **analysis,
                },
            ))
        # largest-first dispatch order, deterministic on ties
        shards.sort(key=lambda s: (-s.nbytes, s.index))
        for idx, s in enumerate(shards):
            s.index = idx
        cfg = archive.config
        return ImagePlan(
            name=archive.name,
            artifact_key=plan["artifact_key"],
            blob_ids=blob_ids,
            config_key=plan["config_key"],
            config_missing=plan["config_key"] in missing_set,
            image_metadata={
                "id": archive.image_id,
                "diff_ids": plan["diff_ids"],
                "config": {
                    "architecture": cfg.get("architecture", ""),
                    "created": cfg.get("created", ""),
                    "os": cfg.get("os", ""),
                    "config": cfg.get("config", {}),
                },
            },
            shards=shards,
        )
    finally:
        archive.close()


# -- replica-side execution --------------------------------------------------


def check_shard(shard) -> None:
    """Raise :class:`ShardRefused` for a shard this port cannot run as
    asked: not an object, a kind other than ``fs`` and ``image-layer``, a
    scanner unknown to the port or a backend outside the JAX choices.
    Host-independent and cheap: a server checks it before it queues a shard
    job."""
    if not isinstance(shard, dict):
        raise ShardRefused("Shard must be a JSON object")
    if shard.get("Kind") not in SHARD_KINDS:
        raise ShardRefused(f"unknown shard kind: {shard.get('Kind')!r}")
    scanners = list(shard.get("Scanners") or ["secret"])
    try:
        check_scanners(scanners)
    except ValueError as e:
        raise ShardRefused(f"shard: {e}") from None
    backend = shard.get("Backend") or "auto"
    if backend not in BACKENDS:
        raise ShardRefused(f"shard: unknown backend {backend!r}: use {', '.join(BACKENDS)}")


def shard_settings(shard: dict, device=DEFAULT_DEVICE) -> ShardSettings:
    """The settings a shard spec carries, to run on ``device`` (or the CPU
    for a ``Backend`` of ``cpu``): the replica's analyzers, and so its cache
    keys and findings, must match what the coordinator planned. Raises
    :class:`ShardRefused` (see :func:`check_shard`), and
    ``FileNotFoundError`` for a ``SecretConfig`` this host cannot see:
    scanning with the default rules instead would return wrong findings
    under the planned keys."""
    check_shard(shard)
    secret_cfg = shard.get("SecretConfig")
    if secret_cfg and not os.path.exists(secret_cfg):
        raise FileNotFoundError(
            f"secret config {secret_cfg!r} does not exist on this host — fleet scans with "
            "--secret-config require replicas to share the config file")
    reg = shard.get("Registry") or {}
    return ShardSettings(
        scanners=list(shard.get("Scanners") or ["secret"]),
        license_full=bool(shard.get("LicenseFull")),
        device="cpu" if shard.get("Backend") == "cpu" else device,
        skip_files=list(shard.get("SkipFiles") or []),
        skip_dirs=list(shard.get("SkipDirs") or []),
        shared_arena=bool(shard.get("SharedArena", True)),
        parallel=int(shard.get("Parallel") or 0),
        secret_config=secret_cfg or None,
        image_source=ImageSourceOption(
            insecure_registry=bool(reg.get("Insecure")),
            registry_username=reg.get("Username", "") or "",
            registry_password=reg.get("Password", "") or "",
            platform=reg.get("Platform", "") or ""),
        warm_hits=shard.get("WarmHits") or None,
    )


def _analyzers(settings: ShardSettings, packages: bool | None,
               list_all_pkgs: bool = False) -> ScanAnalyzers:
    """The shard's :class:`ScanAnalyzers` on its device, its secret scanner
    seeded with the shard's ``WarmHits`` (cross-replica dedup warming;
    entries of another ruleset's namespace are dropped with a warning). As
    on the JAX replica, the license analyzers ride the secret feed's rows
    only on a device: on the CPU the fused gate's plain version costs more
    than the unfused classifier, with the same findings. With ``misconfig``
    the config analyzer scans every type with no custom checks, as the JAX
    ``shard_artifact_option`` builds it: a shard names neither."""
    analyzers = ScanAnalyzers(settings.scanners, settings.device,
                              license_full=settings.license_full,
                              shared_arena=settings.shared_arena and not _on_cpu(settings.device),
                              config_path=settings.secret_config,
                              list_all_pkgs=list_all_pkgs, packages=packages)
    if settings.warm_hits and analyzers.scanner is not None:
        n = analyzers.scanner.seed_hit_entries(settings.warm_hits)
        logger.info("dedup store warm-seeded with %d entr%s", n, "y" if n == 1 else "ies")
    return analyzers


def execute_shard(shard: dict, cache, device=DEFAULT_DEVICE,
                  list_all_pkgs: bool = False) -> list[dict]:
    """Run one shard spec to completion on ``device`` (a replica's
    ``ScanServer.scan`` passes its own) and return its ``[{"BlobID",
    "BlobInfo"}, ...]`` list; the blob also lands in ``cache``.
    ``list_all_pkgs`` (the request's ``ListAllPkgs``) makes a secret-only
    fs shard run the package analyzers too, as a single-host scan would.
    Progress notes land on the active trace context, so a replica's shard
    job feeds the standard ``GET /scan/<job_id>/progress`` poll.

    On the card a kernel fault or an exhausted ladder fails the shard, as
    it fails any scan there (``obs.degrade_or_raise``); a coordinator then
    re-dispatches it."""
    settings = shard_settings(shard, device)
    if shard["Kind"] == "fs":
        return _execute_fs_shard(shard, settings, cache, list_all_pkgs)
    return _execute_image_shard(shard, settings, cache)


def _execute_fs_shard(shard: dict, settings: ShardSettings, cache,
                      list_all_pkgs: bool) -> list[dict]:
    root = shard["Root"]
    if not os.path.isdir(root):
        # a replica that does not share the coordinator's filesystem must
        # fail the shard LOUDLY — absorbing every path as a per-file skip
        # would return an empty blob and a silently wrong fleet scan
        raise FileNotFoundError(
            f"fs shard root {root!r} does not exist on this host — fleet fs scans require "
            "replicas to share the scanned filesystem")
    analyzers = _analyzers(settings, None, list_all_pkgs)
    secret, batched = analyzers.batch(root)
    # a path deleted since the plan counts as walk.skipped (the response's
    # Health), as a single-host walk counts it
    entries = FSWalker().walk_paths(root, shard.get("Paths") or [])
    result = analyze_files(entries, root, analyzers.group, secret, batched, Counter(),
                           read_ahead=settings.parallel or DEFAULT_PARALLEL)
    blob = result.to_blob_info()
    handlers = HandlerManager()
    handlers.post_handle(result, blob)
    blob_dict = blob.to_wire_dict()
    blob_id = calc_key(calc_blob_key(blob_dict), analyzer_versions=analyzers.versions(),
                       hook_versions=handlers.versions(), skip_files=settings.skip_files,
                       skip_dirs=settings.skip_dirs)
    _, missing = cache.missing_blobs(blob_id, [blob_id])
    if missing:
        cache.put_blob(blob_id, blob_dict)
    return [{"BlobID": blob_id, "BlobInfo": blob_dict}]


def _execute_image_shard(shard: dict, settings: ShardSettings, cache) -> list[dict]:
    blob_id = shard["BlobID"]
    # a warm replica: the layer's analyzed blob is already cached under the
    # exact key the coordinator planned — never re-walked, never re-analyzed
    _, missing = cache.missing_blobs("", [blob_id])
    if not missing:
        cached = cache.get_blob(blob_id)
        if cached is not None:
            obs.current().count("fleet.layer_cache_hits")
            return [{"BlobID": blob_id, "BlobInfo": cached}]
    # every layer runs the package analyzers, whatever the scanners, as a
    # single-host image scan does
    artifact = _image_artifact(shard["Archive"], cache, _analyzers(settings, True), settings)
    try:
        blob, _counts = artifact._analyze_layer(shard["Index"], shard.get("DiffID", ""),
                                                shard.get("CreatedBy", ""),
                                                bool(shard.get("SkipSecret")))
    finally:
        artifact.close()
    blob_dict = blob.to_wire_dict()
    cache.put_blob(blob_id, blob_dict)
    return [{"BlobID": blob_id, "BlobInfo": blob_dict}]


def _image_artifact(path: str, cache, analyzers: ScanAnalyzers,
                    settings: ShardSettings) -> ImageArchiveArtifact:
    """The archive when ``path`` exists on this host (shared storage, an
    in-process fleet), else a registry reference: the replica pulls its own
    layers, so layer bytes never cross the coordinator's link."""
    cls = ImageArchiveArtifact if os.path.exists(path) else ImageRegistryArtifact
    return cls(path, cache, analyzers, skip_files=settings.skip_files,
               skip_dirs=settings.skip_dirs, option=settings.image_source)
