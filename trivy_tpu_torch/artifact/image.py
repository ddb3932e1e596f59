"""Container-image artifact over docker-save and OCI-layout archives (ref:
pkg/fanal/artifact/image/image.go:56-231, pkg/fanal/image/archive.go), the
port of the archive half of ``trivy_tpu/artifact/image.py``.

Per layer: diff-ID → cache key (the analyzer and handler versions
included, and ``/secret-skipped`` for a base layer), a ``missing_blobs``
diff so cached layers are never walked again, then each missing layer is
tar-walked (whiteouts and opaque dirs collected) through the scan's
analyzers. The image config is analyzed into one more blob on top (ENV
secrets, apk history). Up to ``parallel`` layers (default
:data:`DEFAULT_PARALLEL`) are analyzed at once, each with its own archive
handle and batched analyzers over the scan's one secret scanner; every blob
is stored under its own key and the blobs are applied in layer order, so
the result does not depend on which layer finishes first.

Registry and daemon sources, and ``--diff-base``, are not ported: the
target must be an archive on disk.
"""

from __future__ import annotations

import hashlib
import json
import os
import tarfile
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

from trivy_tpu_torch import log, obs
from trivy_tpu_torch.cache.key import calc_key
from trivy_tpu_torch.fanal.analyzers.imgconf import analyze_image_config
from trivy_tpu_torch.fanal.handler import HandlerManager
from trivy_tpu_torch.fanal.scan import ScanAnalyzers, analyze_files
from trivy_tpu_torch.fanal.walker_tar import LayerResult, LayerTarWalker
from trivy_tpu_torch.types import BlobInfo

logger = log.logger("artifact:image")

DEFAULT_PARALLEL = 5  # layers analyzed at once (the JAX package's default)


@dataclass
class ArtifactReference:
    """What :meth:`ImageArchiveArtifact.inspect` returns for detection (ref:
    pkg/fanal/artifact ArtifactReference): the name, the type, the cache
    keys of the artifact and of its blobs in layer order (the config's
    last), and the image metadata of the report."""

    name: str
    type: str
    id: str
    blob_ids: list[str]
    image_metadata: dict = field(default_factory=dict)


class _ImageArchive:
    """Random access to a docker-save or OCI-layout archive (dir or tar)."""

    def __init__(self, path: str):
        self.path = path
        self._tar: tarfile.TarFile | None = None
        if os.path.isdir(path):
            self._read = self._read_dir
        else:
            self._tar = tarfile.open(path)
            self._read = self._read_tar
        self.name = os.path.basename(path.rstrip("/"))
        self._load()

    def close(self):
        if self._tar is not None:
            self._tar.close()

    def _read_dir(self, member: str) -> bytes:
        with open(os.path.join(self.path, member), "rb") as f:
            return f.read()

    def _read_tar(self, member: str) -> bytes:
        for cand in (member, f"./{member}"):
            try:
                f = self._tar.extractfile(cand)
            except KeyError:
                continue
            if f is not None:
                return f.read()
        raise KeyError(f"archive member not found: {member}")

    def _exists(self, member: str) -> bool:
        try:
            self._read(member)
            return True
        except (KeyError, FileNotFoundError):
            return False

    @staticmethod
    def _blob_path(digest: str) -> str:
        algo, _, hexd = digest.partition(":")
        return f"blobs/{algo}/{hexd}"

    def _load(self) -> None:
        if self._exists("manifest.json"):
            self._load_docker_save()
        elif self._exists("index.json"):
            self._load_oci()
        else:
            raise ValueError(
                f"{self.path}: neither docker-save (manifest.json) nor "
                "OCI layout (index.json)"
            )

    def _load_docker_save(self) -> None:
        manifest = json.loads(self._read("manifest.json"))[0]
        self.config_bytes = self._read(manifest["Config"])
        self.config = json.loads(self.config_bytes)
        tags = manifest.get("RepoTags") or []
        if tags:
            self.name = tags[0]
        self._layer_paths = list(manifest["Layers"])

    def _load_oci(self) -> None:
        desc = json.loads(self._read("index.json"))["manifests"][0]
        blob = json.loads(self._read(self._blob_path(desc["digest"])))
        while "manifests" in blob:  # nested image index → first platform
            blob = json.loads(
                self._read(self._blob_path(blob["manifests"][0]["digest"]))
            )
        self.config_bytes = self._read(self._blob_path(blob["config"]["digest"]))
        self.config = json.loads(self.config_bytes)
        self._layer_paths = [self._blob_path(l["digest"]) for l in blob["layers"]]

    @property
    def image_id(self) -> str:
        return f"sha256:{hashlib.sha256(self.config_bytes).hexdigest()}"

    @property
    def diff_ids(self) -> list[str]:
        return list(self.config.get("rootfs", {}).get("diff_ids", []))

    def layer_stream(self, index: int):
        """Readable file object for layer ``index``'s (possibly compressed)
        tar."""
        member = self._layer_paths[index]
        if self._tar is None:
            return open(os.path.join(self.path, member), "rb")
        for cand in (member, f"./{member}"):
            try:
                f = self._tar.extractfile(cand)
            except KeyError:
                continue
            if f is not None:
                return f
        raise KeyError(f"layer not found: {member}")

    def layer_size(self, index: int) -> int:
        """Stored byte size of layer ``index``'s tar."""
        member = self._layer_paths[index]
        if self._tar is None:
            try:
                return os.path.getsize(os.path.join(self.path, member))
            except OSError:
                return 0
        for cand in (member, f"./{member}"):
            try:
                return self._tar.getmember(cand).size
            except KeyError:
                continue
        return 0

    def layer_history(self) -> list[dict]:
        """History entries aligned to diff_ids (empty_layer entries skipped)."""
        return [h for h in self.config.get("history", []) if not h.get("empty_layer")]


class ImageArchiveArtifact:
    """One image archive scanned with ``analyzers``; blobs go to ``cache``.
    ``stats`` gathers the layers (all, analyzed, cached), the stored bytes
    of the analyzed layers and the files walked, scanned and skipped."""

    type = "container_image"

    def __init__(self, path: str, cache, analyzers: ScanAnalyzers, skip_files=(),
                 skip_dirs=(), parallel: int = 0):
        if not os.path.exists(path):
            raise FileNotFoundError(f"image archive not found: {path}")
        self.path = path
        self.cache = cache
        self.analyzers = analyzers
        self.skip_files = list(skip_files)
        self.skip_dirs = list(skip_dirs)
        self.parallel = parallel
        self.handlers = HandlerManager()
        self.walker = LayerTarWalker(skip_files=self.skip_files, skip_dirs=self.skip_dirs)
        self.stats: Counter = Counter()

    def _analyze_layer(self, index: int, diff_id: str, created_by: str,
                       skip_secret: bool = False, archive: _ImageArchive | None = None
                       ) -> tuple[BlobInfo, Counter]:
        """Analyze one layer; returns its blob and its file counts. Without
        ``archive`` it opens its own handle (tarfile handles are not
        thread-safe), so layers may run at once."""
        own_archive = archive is None
        if own_archive:
            archive = _ImageArchive(self.path)
        try:
            counts: Counter = Counter()
            layer_res = LayerResult()
            secret, licenses = self.analyzers.batch("", skip_secret=skip_secret)
            with archive.layer_stream(index) as stream:
                result = analyze_files(self.walker.walk(stream, layer_res), "",
                                       self.analyzers.group, secret, licenses, counts)
            blob = result.to_blob_info()
            self.handlers.post_handle(result, blob)
            blob.diff_id = diff_id
            blob.created_by = created_by
            blob.whiteout_files = sorted(layer_res.whiteout_files)
            blob.opaque_dirs = sorted(layer_res.opaque_dirs)
            return blob, counts
        finally:
            if own_archive:
                archive.close()

    def _analyze_config(self, archive: _ImageArchive) -> BlobInfo:
        """Image-config analysis as a synthetic top blob."""
        an = self.analyzers
        blob = analyze_image_config(archive.config, an.scanner is not None, an.config_path)
        blob.diff_id = archive.image_id
        return blob

    def layer_plan(self, archive: _ImageArchive) -> dict:
        """Cache-key plan for one image: per-layer blob keys, the config
        key, and the artifact key."""
        versions = self.analyzers.versions()
        hooks = self.handlers.versions()

        def key(base: str) -> str:
            return calc_key(base, analyzer_versions=versions, hook_versions=hooks,
                            skip_files=self.skip_files, skip_dirs=self.skip_dirs)

        base_layers = _base_layer_indices(archive.config.get("history", []))
        # the per-layer analyzer set is part of the key: a base layer is
        # analyzed without the secret analyzer, and that blob must never
        # satisfy a scan where the same diff-ID is NOT a base layer
        # (ref: image.go calcKeys appends the per-layer disabled list)
        layer_keys = [key(d + ("/secret-skipped" if i in base_layers else ""))
                      for i, d in enumerate(archive.diff_ids)]
        return {
            "diff_ids": archive.diff_ids,
            "history": archive.layer_history(),
            "base_layers": base_layers,
            "layer_keys": layer_keys,
            "config_key": key(archive.image_id + "/config"),
            "artifact_key": key(archive.image_id),
        }

    def inspect(self) -> ArtifactReference:
        """Analyze the layers and the config the cache lacks, store their
        blobs, and return the reference with the image metadata."""
        archive = _ImageArchive(self.path)
        try:
            plan = self.layer_plan(archive)
            diff_ids, history = plan["diff_ids"], plan["history"]
            layer_keys, config_key = plan["layer_keys"], plan["config_key"]
            blob_ids = layer_keys + [config_key]
            _, missing = self.cache.missing_blobs(plan["artifact_key"], blob_ids)
            missing_set = set(missing)
            todo = []
            for i, (diff_id, lkey) in enumerate(zip(diff_ids, layer_keys)):
                if lkey not in missing_set:
                    continue
                created_by = history[i].get("created_by", "") if i < len(history) else ""
                # base-image layers skip secret scanning (their secrets are
                # the base maintainer's problem; ref: image.go:209-213)
                todo.append((i, diff_id, lkey, created_by, i in plan["base_layers"]))
            self.stats.update(layers=len(diff_ids), layers_analyzed=len(todo),
                              layers_cached=len(diff_ids) - len(todo),
                              layer_bytes=sum(archive.layer_size(t[0]) for t in todo))
            workers = min(len(todo), self.parallel or DEFAULT_PARALLEL)
            if workers > 1:
                ctx = obs.current()

                def analyze_in_scan(*args):
                    # the layer's spans land in the scan's one trace context
                    with obs.activate(ctx):
                        return self._analyze_layer(*args)

                with ThreadPoolExecutor(max_workers=workers) as pool:
                    futs = [(lkey, pool.submit(analyze_in_scan, i, diff_id, created_by, skip))
                            for i, diff_id, lkey, created_by, skip in todo]
                    try:
                        for lkey, fut in futs:
                            blob, counts = fut.result()
                            self.stats.update(counts)
                            self.cache.put_blob(lkey, blob.to_dict())
                    except BaseException:
                        for _, fut in futs:
                            fut.cancel()
                        raise
            else:
                for i, diff_id, lkey, created_by, skip in todo:
                    blob, counts = self._analyze_layer(i, diff_id, created_by, skip,
                                                       archive=archive)
                    self.stats.update(counts)
                    self.cache.put_blob(lkey, blob.to_dict())
            if config_key in missing_set:
                self.cache.put_blob(config_key, self._analyze_config(archive).to_dict())
            cfg = archive.config
            return ArtifactReference(
                name=archive.name, type=self.type, id=plan["artifact_key"], blob_ids=blob_ids,
                image_metadata={
                    "id": archive.image_id,
                    "diff_ids": diff_ids,
                    "config": {
                        "architecture": cfg.get("architecture", ""),
                        "created": cfg.get("created", ""),
                        "os": cfg.get("os", ""),
                        "config": cfg.get("config", {}),
                    },
                },
            )
        finally:
            archive.close()


def _base_layer_indices(histories: list[dict]) -> set[int]:
    """Indices (in layer order) of layers that belong to the base image
    (ref: pkg/fanal/image/image.go:111-137 GuessBaseImageIndex): walking
    history backwards, the base image ends at the last empty-layer CMD
    entry before the final non-empty instruction."""
    base_history_idx = -1
    found_non_empty = False
    for i in range(len(histories) - 1, -1, -1):
        h = histories[i]
        empty = bool(h.get("empty_layer"))
        if not found_non_empty:
            if empty:
                continue
            found_non_empty = True
        if not empty:
            continue
        created_by = h.get("created_by", "")
        if created_by.startswith(("/bin/sh -c #(nop)  CMD", "CMD")):
            base_history_idx = i
            break
    if base_history_idx < 0:
        return set()
    # map history index -> layer index (only non-empty entries have layers)
    out = set()
    layer = 0
    for i, h in enumerate(histories):
        if not h.get("empty_layer"):
            if i <= base_history_idx:
                out.add(layer)
            layer += 1
    return out
