"""Fleet merger: shard results back into one single-host-identical report
(the port of ``trivy_tpu/fleet/merge.py``).

:class:`FleetArtifact` keeps the merge byte-exact by giving the scan what a
single-host artifact gives it, an
:class:`~trivy_tpu_torch.artifact.image.ArtifactReference` over blobs in a
cache: every shard's blobs land in the coordinator's cache under the keys
a replica returned (image layers keep their planned per-layer keys; fs
partitions get their content keys, applied in plan order), and the
ordinary detection path (``cache.cached_blobs`` -> ``LocalDriver`` on the
coordinator's device -> ``build_report``) merges them through the applier.
Dedup across overlapping layer paths, whiteouts and finding order are
therefore inherited, not re-implemented. ``Degraded`` and ``SkippedFiles``
sum the same way: shard responses carry their health deltas and the
coordinator folds them into the scan context the report reads.
"""

from __future__ import annotations

import hashlib
import os
import time

from trivy_tpu_torch import log, obs
from trivy_tpu_torch.artifact.image import ArtifactReference, new_image_artifact
from trivy_tpu_torch.fleet import plan as fleet_plan
from trivy_tpu_torch.fleet.coordinator import FleetConfig, FleetCoordinator
from trivy_tpu_torch.fleet.plan import ShardSettings

logger = log.logger("fleet:merge")


class FleetArtifact:
    """Artifact facade that scatters analysis across the fleet and gathers
    blobs into ``cache``; detection and report assembly then run through the
    standard local path. ``settings`` are the shards' analysis settings;
    their ``device`` is the coordinator's, which the local fallback and an
    image's config analysis use, and a ``cpu`` device puts ``Backend: cpu``
    on the wire. ``seconds`` holds the plan's and the fan-out's wall time
    after :meth:`inspect`."""

    def __init__(self, kind: str, target: str, cache, settings: ShardSettings,
                 fleet_config: FleetConfig, scan_options):
        if kind not in ("fs", "image"):
            raise ValueError(f"fleet scans support fs/image, not {kind!r}")
        self.kind = kind
        self.type = "filesystem" if kind == "fs" else "container_image"
        self.target = target
        self.cache = cache
        self.settings = settings
        self.fleet_config = fleet_config
        self.scan_options = scan_options
        self.coordinator: FleetCoordinator | None = None  # set by inspect()
        self.seconds = {"plan": 0.0, "fanout": 0.0}

    def stats(self) -> dict:
        return dict(self.coordinator.stats) if self.coordinator else {}

    def telemetry(self) -> dict:
        """The fan-out's fleet telemetry doc (per-replica health series, set
        on the scan context at poller stop), or {} when the poller was off
        or no fan-out has run."""
        return dict(obs.current().fleet or {})

    def inspect(self) -> ArtifactReference:
        ctx = obs.current()
        self.coordinator = FleetCoordinator(self.fleet_config, self.scan_options,
                                            local_cache=self.cache, device=self.settings.device)
        with ctx.span("fleet.plan"):
            if self.kind == "fs":
                return self._inspect_fs(ctx)
            return self._inspect_image(ctx)

    def _run(self, shards) -> dict:
        t0 = time.perf_counter()
        try:
            return self.coordinator.run(shards)
        finally:
            self.seconds["fanout"] = time.perf_counter() - t0

    # -- fs ------------------------------------------------------------------

    def _inspect_fs(self, ctx) -> ArtifactReference:
        t0 = time.perf_counter()
        shards, total_bytes, total_files = fleet_plan.plan_fs_shards(
            self.target, self.settings, self.fleet_config.target_shards())
        self.seconds["plan"] = time.perf_counter() - t0
        progress = ctx.progress()
        progress.note_walked(total_bytes, files=total_files)
        progress.finish_walk()
        logger.info("fleet plan: %s -> %d shard(s) over %d replica(s) (%.1f MiB, %d files)",
                    self.target, len(shards), len(self.fleet_config.hosts),
                    total_bytes / (1 << 20), total_files)
        results = self._run(shards)
        # one blob per partition, applied in plan order: partitions are
        # path-disjoint, so the applier yields the sorted union a
        # single-host one-blob scan produces
        blob_ids: list[str] = []
        for idx in sorted(results):
            for b in results[idx]:
                self.cache.put_blob(b["BlobID"], b["BlobInfo"])
                blob_ids.append(b["BlobID"])
        artifact_id = "sha256:" + hashlib.sha256(
            ("fleet:" + ":".join(blob_ids)).encode()).hexdigest()
        name = self.target
        if name != os.path.sep:
            name = name.rstrip(os.path.sep)
        return ArtifactReference(name=name, type=self.type, id=artifact_id, blob_ids=blob_ids)

    # -- image ---------------------------------------------------------------

    def _inspect_image(self, ctx) -> ArtifactReference:
        from trivy_tpu_torch.fanal.scan import ScanAnalyzers

        st = self.settings
        t0 = time.perf_counter()
        # the single-host image scan's analyzers (every package analyzer on
        # every layer): the layer keys and the config blob come from them
        analyzers = ScanAnalyzers(st.scanners, st.device, license_full=st.license_full,
                                  shared_arena=st.shared_arena, config_path=st.secret_config,
                                  packages=True)
        artifact = new_image_artifact(self.target, self.cache, analyzers,
                                      skip_files=st.skip_files, skip_dirs=st.skip_dirs,
                                      option=st.image_source)
        try:
            # a daemon's image raises FleetError here: its export is a temp
            # file of this host that no replica can open
            plan = fleet_plan.plan_image_shards(artifact, self.cache, st)
            self.seconds["plan"] = time.perf_counter() - t0
            total = sum(s.nbytes for s in plan.shards)
            progress = ctx.progress()
            progress.note_walked(total, files=len(plan.shards))
            progress.finish_walk()
            logger.info("fleet plan: %s -> %d missing layer shard(s) over %d replica(s) "
                        "(%.1f MiB; %d layer(s) already cached)", plan.name, len(plan.shards),
                        len(self.fleet_config.hosts), total / (1 << 20),
                        len(plan.blob_ids) - 1 - len(plan.shards))
            if plan.shards:
                results = self._run(plan.shards)
                for idx in sorted(results):
                    for b in results[idx]:
                        self.cache.put_blob(b["BlobID"], b["BlobInfo"])
            if plan.config_missing:
                # the image config's analysis is one small synthetic blob:
                # the coordinator runs it
                archive = artifact._open_source()
                try:
                    blob = artifact._analyze_config(archive)
                finally:
                    archive.close()
                self.cache.put_blob(plan.config_key, blob.to_dict())
        finally:
            artifact.close()
        return ArtifactReference(name=plan.name, type=self.type, id=plan.artifact_key,
                                 blob_ids=plan.blob_ids, image_metadata=plan.image_metadata)
