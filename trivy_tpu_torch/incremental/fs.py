"""The unit-level incremental fs artifact, the port's copy of
``trivy_tpu/incremental/fs.py``.

The tree is split into the directory-atomic units of
:func:`~trivy_tpu_torch.fleet.plan.group_units` (Helm chart subtrees whole,
every other directory its own unit). Each unit's blob is cached under a key
made of its files' content keys and the analysis fingerprint, and only the
units whose key the cache lacks are analyzed. The applier merges the units'
blobs as it merges an image's layers, so the findings are those of the
one-blob scan.

The re-scan ladder, cheapest first:

1. ``--since-last``: a file whose ``(size, mtime_ns)`` matches the manifest
   reuses its recorded content key and is not read;
2. ``--diff-base <commit>``: a file the git diff calls unchanged since the
   manifest's (clean worktree) commit reuses its key, whatever its mtime;
3. otherwise the file is hashed; an unchanged unit is still not analyzed.

The dirty units' files go through one :func:`~trivy_tpu_torch.fanal.scan.
analyze_files` pass, so the secret feed, the fused license gate and the
classifier run on the card over those files only, and not at all when no
unit is dirty.
"""

from __future__ import annotations

import hashlib
import json
import os
from collections import Counter

from trivy_tpu_torch import log, obs
from trivy_tpu_torch.artifact.image import ArtifactReference
from trivy_tpu_torch.cache.key import calc_key
from trivy_tpu_torch.fanal.analyzer import AnalysisResult
from trivy_tpu_torch.fanal.handler import HandlerManager
from trivy_tpu_torch.fanal.scan import DEFAULT_PARALLEL, ScanAnalyzers, analyze_files
from trivy_tpu_torch.fanal.walker import FSWalker, WalkOption
from trivy_tpu_torch.fleet.plan import group_units
from trivy_tpu_torch.incremental import IncrementalOptions
from trivy_tpu_torch.incremental import manifest as manifest_mod

logger = log.logger("incremental:fs")


def _hash_file(path: str) -> str | None:
    """The file's content key (a streaming blake2b), None when it cannot be
    read."""
    h = hashlib.blake2b(digest_size=16)
    try:
        with open(path, "rb") as f:
            while True:
                chunk = f.read(1 << 20)
                if not chunk:
                    break
                h.update(chunk)
    except OSError:
        return None
    return h.hexdigest()


class IncrementalFSArtifact:
    """The tree at ``root`` scanned unit by unit with ``analyzers``; unit
    blobs and the manifest go to ``cache``. ``parallel`` read-ahead workers
    (0: the tuning config's, else ``DEFAULT_PARALLEL``) read the dirty
    units' files. ``stats`` gathers the files walked (the whole tree),
    scanned (the dirty units' files) and skipped (the walk's, the hash's and
    the reads'); ``last_stats`` the reuse of the last :meth:`inspect`."""

    type = "filesystem"

    def __init__(self, root: str, cache, analyzers: ScanAnalyzers, skip_files=(),
                 skip_dirs=(), parallel: int = 0,
                 incremental: IncrementalOptions | None = None):
        self.root = root
        self.cache = cache
        self.analyzers = analyzers
        self.skip_files = list(skip_files)
        self.skip_dirs = list(skip_dirs)
        tuning = analyzers.tuning
        self.parallel = parallel or (tuning.parallel if tuning is not None else 0) \
            or DEFAULT_PARALLEL
        self.incremental = incremental or IncrementalOptions(enabled=True)
        self.handlers = HandlerManager()
        # part of every unit key: computed once, not per unit
        self.versions = analyzers.versions()
        self.hook_versions = self.handlers.versions()
        self.walker = FSWalker(WalkOption(skip_files=self.skip_files, skip_dirs=self.skip_dirs))
        self.stats: Counter = Counter()
        # {unit_keys, units_total, units_analyzed, units_reused,
        # files_stat_reused, files_git_reused, files_hashed, bytes_reused}
        self.last_stats: dict = {}

    # -- fingerprint ---------------------------------------------------------

    def fingerprint(self) -> str:
        """Digest of everything that can change the findings: the analyzer
        and handler versions, the skip lists, the ``--secret-config`` file's
        content and the misconfiguration knobs (``--config-check`` paths,
        ``--misconfig-scanners``), as in the JAX fingerprint. A manifest or
        unit blob of another configuration is then unreachable, never
        served."""
        secret_cfg_digest = ""
        path = self.analyzers.config_path
        if path and os.path.exists(path):
            try:
                with open(path, "rb") as f:
                    secret_cfg_digest = hashlib.sha256(f.read()).hexdigest()
            except OSError:
                secret_cfg_digest = "unreadable"
        doc = {
            "v": manifest_mod.MANIFEST_VERSION,
            "analyzers": self.versions,
            "hooks": self.hook_versions,
            "skip_files": sorted(self.skip_files),
            "skip_dirs": sorted(self.skip_dirs),
            "secret_config": secret_cfg_digest,
            "check_paths": sorted(self.analyzers.check_paths),
            "misconfig_scanners": sorted(self.analyzers.misconfig_scanners),
        }
        return hashlib.sha256(
            json.dumps(doc, sort_keys=True, separators=(",", ":")).encode()).hexdigest()

    def _unit_blob_key(self, unit: str, files: dict[str, str], fingerprint: str) -> str:
        base = json.dumps({"incr_unit": unit, "files": files, "fp": fingerprint},
                          sort_keys=True, separators=(",", ":"))
        return calc_key(base, analyzer_versions=self.versions,
                        hook_versions=self.hook_versions,
                        skip_files=self.skip_files, skip_dirs=self.skip_dirs)

    def _skipped(self, rel: str, err: OSError) -> None:
        """One file that could not be read: logged and counted, as the
        walk's read failures are (the report's ``SkippedFiles``)."""
        logger.warning("skipping %s: unreadable (%s)", rel, err)
        self.stats["files_skipped"] += 1
        ctx = obs.current()
        ctx.count("walk.skipped")
        ctx.health_count("walk.skipped")

    # -- inspect -------------------------------------------------------------

    def inspect(self) -> ArtifactReference:
        """Walk, key, diff against the cache, analyze the dirty units and
        record the manifest. Raises
        :class:`~trivy_tpu_torch.incremental.manifest.GitDiffError` for a
        ``--diff-base`` that git cannot resolve."""
        ctx = obs.current()
        progress = ctx.progress()
        fingerprint = self.fingerprint()
        root_abs = os.path.abspath(self.root)
        incr = self.incremental

        # 1. the walk: stat only
        entries: list[tuple] = []  # (rel, info, mtime_ns, opener, full)
        for rel, info, opener in self.walker.walk(self.root):
            full = os.path.join(root_abs, *rel.split("/"))
            try:
                mtime_ns = os.lstat(full).st_mtime_ns
            except OSError:
                mtime_ns = -1
            entries.append((rel, info, mtime_ns, opener, full))
            progress.note_walked(info.size)
        progress.finish_walk()
        self.stats["files_walked"] += len(entries)
        self.stats["files_skipped"] += self.walker.skipped

        # 2. the last manifest, and git's view of what changed since it
        manifest = manifest_mod.load_manifest(self.cache, root_abs, fingerprint)
        man_files = (manifest or {}).get("Files") or {}
        git_clean: set[str] | None = None  # rels unchanged since the manifest
        commit = manifest_mod.git_clean_head(root_abs)
        if incr.diff_base:
            base = manifest_mod.git_resolve(root_abs, incr.diff_base)
            if manifest and manifest.get("Commit") == base:
                changed = manifest_mod.git_changed_paths(root_abs, base)
                dirs = tuple(p for p in changed if p == "" or p.endswith("/"))
                git_clean = {e[0] for e in entries
                             if e[0] not in changed and not e[0].startswith(dirs)}
            else:
                logger.warning(
                    "--diff-base %s: no clean-worktree manifest recorded at that commit "
                    "(have %s); falling back to content hashing", incr.diff_base,
                    ((manifest or {}).get("Commit") or "none")[:12])

        # 3. each file's content key, the cheapest source first
        stat_reused = git_reused = hashed = 0
        file_keys: dict[str, str] = {}
        for rel, info, mtime_ns, _opener, full in entries:
            rec = man_files.get(rel)
            if (incr.since_last and rec is not None and rec[0] == info.size
                    and rec[1] == mtime_ns and mtime_ns >= 0):
                file_keys[rel] = rec[2]
                stat_reused += 1
                continue
            if git_clean is not None and rel in git_clean and rec is not None:
                file_keys[rel] = rec[2]
                git_reused += 1
                continue
            key = _hash_file(full)
            if key is None:  # vanished or unreadable since the walk
                self._skipped(rel, OSError("unreadable during hashing"))
                continue
            file_keys[rel] = key
            hashed += 1
        entries = [e for e in entries if e[0] in file_keys]

        # 4. units and their content-addressed keys
        units = group_units([(rel, info.size) for rel, info, *_ in entries])
        by_rel = {e[0]: e for e in entries}
        unit_keys = {unit: self._unit_blob_key(unit, {rel: file_keys[rel] for rel, _ in files},
                                               fingerprint)
                     for unit, files, _nbytes in units}
        blob_ids = [unit_keys[u] for u, _, _ in units]
        artifact_id = calc_key(json.dumps({"incr_root": root_abs, "units": blob_ids},
                                          sort_keys=True, separators=(",", ":")))

        # 5. the cache diff: only the dirty units are analyzed
        missing = self.cache.missing_blobs(artifact_id, blob_ids)[1] if blob_ids else []
        missing_set = set(missing)
        dirty = [u for u in units if unit_keys[u[0]] in missing_set]
        reused_bytes = sum(n for u, _, n in units if unit_keys[u] not in missing_set)
        ctx.count("incr.units_reused", len(units) - len(dirty))
        ctx.count("incr.bytes_reused", reused_bytes)
        progress.note_scanned(reused_bytes)
        if dirty:
            self._analyze_units(dirty, by_rel, unit_keys)

        # 6. the manifest for the next scan
        manifest_mod.save_manifest(
            self.cache, root_abs, fingerprint,
            files={rel: [info.size, mtime_ns, file_keys[rel]]
                   for rel, info, mtime_ns, *_ in entries},
            units={u: unit_keys[u] for u, _, _ in units}, commit=commit)
        self.last_stats = {
            "unit_keys": tuple(blob_ids),
            "units_total": len(units),
            "units_analyzed": len(dirty),
            "units_reused": len(units) - len(dirty),
            "files_stat_reused": stat_reused,
            "files_git_reused": git_reused,
            "files_hashed": hashed,
            "bytes_reused": reused_bytes,
        }
        logger.info("incremental scan of %s: %d/%d unit(s) reused (%d stat-reused, "
                    "%d git-reused, %d hashed file(s))", self.root, len(units) - len(dirty),
                    len(units), stat_reused, git_reused, hashed)
        name = self.root if self.root == os.path.sep else self.root.rstrip(os.path.sep)
        return ArtifactReference(name=name, type=self.type, id=artifact_id, blob_ids=blob_ids)

    # -- the dirty units -----------------------------------------------------

    def _analyze_units(self, dirty: list, by_rel: dict, unit_keys: dict) -> None:
        """One :func:`analyze_files` pass over every dirty unit's files: the
        per-file analyzers write into their unit's result (OS identity
        included), the batched ones finalize once for the whole set and
        their findings are split by path. Each unit's blob then goes
        through the handlers into the cache under its key."""
        unit_of = {rel: unit for unit, files, _ in dirty for rel, _size in files}
        unit_results = {unit: AnalysisResult() for unit, _, _ in dirty}
        secret, batched = self.analyzers.batch(self.root)
        counts: Counter = Counter()
        batch = analyze_files(
            ((rel, by_rel[rel][1], by_rel[rel][3]) for _u, files, _n in dirty
             for rel, _size in files),
            self.root, self.analyzers.group, secret, batched, counts,
            read_ahead=self.parallel, result_for=lambda rel: unit_results[unit_of[rel]],
            walk_progress=False)
        self.stats["files_scanned"] += counts["files_scanned"]
        self.stats["files_skipped"] += counts["files_skipped"]
        self._split_batch_result(batch, unit_of, unit_results, dirty)
        for unit, _files, _nbytes in dirty:
            result = unit_results[unit]
            blob = result.to_blob_info()
            self.handlers.post_handle(result, blob)
            self.cache.put_blob(unit_keys[unit], blob.to_dict())

    @staticmethod
    def _split_batch_result(batch: AnalysisResult, unit_of: dict, unit_results: dict,
                            dirty: list) -> None:
        """The batched analyzers' findings (all that ``analyze_files`` with
        ``result_for`` returns: misconfigurations, secrets and licenses) into
        the units of their paths. A path outside the dirty set cannot occur; one is kept,
        loudly, in the first unit rather than dropped."""
        first_unit = min(u for u, _, _ in dirty)
        for attr in ("misconfigurations", "secrets", "licenses"):
            for item in getattr(batch, attr):
                r = unit_results.get(unit_of.get(item.file_path, ""))
                if r is None:
                    logger.warning("batched %s finding for unplanned path %s kept in unit %r",
                                   attr, item.file_path, first_unit)
                    r = unit_results[first_unit]
                getattr(r, attr).append(item)
