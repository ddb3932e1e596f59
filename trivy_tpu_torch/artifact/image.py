"""Container-image artifact over docker-save and OCI-layout archives,
registries and runtime daemons (ref: pkg/fanal/artifact/image/image.go:56-231,
pkg/fanal/image/archive.go, pkg/fanal/image/image.go:27-58), the port of
``trivy_tpu/artifact/image.py``.

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

Every source is a byte source under one pipeline: an archive on disk, a
registry image (``fanal/image_registry.py``, one shared puller for every
layer) or a daemon's ``docker save`` export to a temp archive
(``fanal/image_daemon.py``). :func:`new_image_artifact` resolves a target in
that order; :func:`preseed_from_base` is ``--diff-base``.
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
from trivy_tpu_torch.fanal.image_daemon import (
    DaemonError,
    export_to_tempfile,
    resolve_daemon_source,
)
from trivy_tpu_torch.fanal.image_registry import RegistryImage
from trivy_tpu_torch.fanal.scan import DEFAULT_PARALLEL, ScanAnalyzers, analyze_files
from trivy_tpu_torch.fanal.walker_tar import LayerResult, LayerTarWalker
from trivy_tpu_torch.types import BlobInfo

logger = log.logger("artifact:image")

# --image-src when unset (trivy_tpu/artifact/local_fs.py ArtifactOption)
DEFAULT_IMAGE_SRC = ("docker", "containerd", "podman", "remote")


@dataclass
class ImageSourceOption:
    """Where a target that is not a path is looked for, and how: the image
    fields of the JAX package's ``ArtifactOption`` under its names
    (``--image-src`` order, daemon hosts, registry credentials, platform)."""

    image_src: list[str] = field(default_factory=lambda: list(DEFAULT_IMAGE_SRC))
    docker_host: str = ""
    podman_host: str = ""
    containerd_host: str = ""
    insecure_registry: bool = False
    registry_username: str = ""
    registry_password: str = ""
    platform: str = ""


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
    ``stats`` gathers the layers (all, analyzed, cached, and seeded from a
    ``--diff-base``), the stored bytes of the analyzed layers and the files
    walked, scanned and skipped. ``option`` is where :func:`preseed_from_base`
    looks for the base image. Subclasses change only the byte source
    (:meth:`_open_source`)."""

    type = "container_image"

    def __init__(self, path: str, cache, analyzers: ScanAnalyzers, skip_files=(),
                 skip_dirs=(), parallel: int = 0, option: ImageSourceOption | None = None):
        self.path = path
        self.cache = cache
        self.analyzers = analyzers
        self.skip_files = list(skip_files)
        self.skip_dirs = list(skip_dirs)
        self.parallel = parallel
        self.option = option or ImageSourceOption()
        self.handlers = HandlerManager()
        self.walker = LayerTarWalker(skip_files=self.skip_files, skip_dirs=self.skip_dirs)
        self.stats: Counter = Counter()

    def _open_source(self):
        """A handle on the image's bytes, with the archive reader's surface;
        the caller closes it."""
        return _ImageArchive(self.path)

    def close(self) -> None:
        """Free what the source holds beyond a handle (a daemon's export)."""

    def _analyze_layer(self, index: int, diff_id: str, created_by: str,
                       skip_secret: bool = False, archive=None) -> tuple[BlobInfo, Counter]:
        """Analyze one layer; returns its blob and its file counts. Without
        ``archive`` it opens its own handle (tarfile handles are not
        thread-safe), so layers may run at once."""
        own_archive = archive is None
        if own_archive:
            archive = self._open_source()
        try:
            counts: Counter = Counter()
            layer_res = LayerResult()
            secret, batched = self.analyzers.batch("", skip_secret=skip_secret)
            with archive.layer_stream(index) as stream:
                result = analyze_files(self.walker.walk(stream, layer_res), "",
                                       self.analyzers.group, secret, batched, counts)
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

    def _analyze_config(self, archive) -> BlobInfo:
        """Image-config analysis as a synthetic top blob."""
        an = self.analyzers
        blob = analyze_image_config(archive.config, an.scanner is not None, an.config_path,
                                    misconfig=an.misconfig)
        blob.diff_id = archive.image_id
        return blob

    def layer_plan(self, archive) -> dict:
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
        archive = self._open_source()
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


class ImageRegistryArtifact(ImageArchiveArtifact):
    """An image pulled from an OCI registry (ref: pkg/fanal/image/image.go
    remote source): the archive's per-layer pipeline and cache keys over a
    :class:`~trivy_tpu_torch.fanal.image_registry.RegistryImage`."""

    _image: RegistryImage | None = None

    def _open_source(self) -> RegistryImage:
        # one shared puller: HTTP pulls are thread-safe (unlike tarfile
        # handles), and a puller per layer would refetch the manifest, the
        # config and the token; its close() is a no-op
        if self._image is None:
            opt = self.option
            self._image = RegistryImage(
                self.path, insecure=opt.insecure_registry, username=opt.registry_username,
                password=opt.registry_password, platform=opt.platform)
        return self._image


class DaemonImageArtifact(ImageArchiveArtifact):
    """An image exported from a runtime daemon (docker, podman) into a temp
    archive, then scanned as an archive; the report keeps the user's
    reference, and :meth:`close` removes the temp archive."""

    def __init__(self, ref: str, source, cache, analyzers: ScanAnalyzers, **kw):
        super().__init__(ref, cache, analyzers, **kw)
        self._tmp = export_to_tempfile(source)  # removed by it on a failed export

    def _open_source(self) -> _ImageArchive:
        return _ImageArchive(self._tmp)

    def close(self) -> None:
        if self._tmp and os.path.exists(self._tmp):
            os.unlink(self._tmp)
        self._tmp = ""


def new_image_artifact(target: str, cache, analyzers: ScanAnalyzers, skip_files=(),
                       skip_dirs=(), parallel: int = 0,
                       option: ImageSourceOption | None = None) -> ImageArchiveArtifact:
    """The artifact of ``target``: an archive when the path exists, else the
    first daemon of ``option.image_src`` that holds it (``docker://``,
    ``podman://`` and ``containerd://`` force that daemon), else, with
    ``remote`` in the list, a registry reference (ref:
    pkg/fanal/image/image.go:27-58). Raises
    :class:`~trivy_tpu_torch.fanal.image_daemon.DaemonError` when no daemon
    holds it and ``remote`` is not enabled."""
    option = option or ImageSourceOption()
    kw = dict(skip_files=skip_files, skip_dirs=skip_dirs, parallel=parallel, option=option)
    if os.path.exists(target):
        return ImageArchiveArtifact(target, cache, analyzers, **kw)
    image_src = list(option.image_src or DEFAULT_IMAGE_SRC)
    ref = target
    # an explicit skopeo-style source prefix; the bare ``docker:tag`` form
    # stays a registry reference (the image named "docker" is a real target)
    for src in ("docker", "podman", "containerd"):
        if target.startswith(src + "://"):
            image_src = [src]
            ref = target[len(src) + 3:]
            break
    source = resolve_daemon_source(ref, image_src, option)
    if source is not None:
        return DaemonImageArtifact(ref, source, cache, analyzers, **kw)
    if "remote" not in image_src:
        # an explicit daemon prefix or a restricted --image-src must not
        # fall through to the registry
        raise DaemonError(f"image {ref!r} not found via {image_src} (daemon socket "
                          "missing or image absent) and 'remote' is not enabled")
    return ImageRegistryArtifact(ref, cache, analyzers, **kw)


def preseed_from_base(artifact: ImageArchiveArtifact, base_target: str) -> dict:
    """``--diff-base`` for images: every layer of ``artifact``'s plan that
    its cache lacks and whose diff-ID the base image ``base_target`` (any
    target :func:`new_image_artifact` resolves, under ``artifact``'s
    options) also has is analyzed from the base, under the derived plan's
    key and with its secret-skip decision for base layers, which a scan of
    the base alone would key differently. ``artifact.inspect()`` then walks
    only the layers the base lacks. The seeded layers' file counts join
    ``artifact.stats``, with ``layers_seeded``. Returns the ``shared``,
    ``seeded`` and ``new`` layer counts (the JAX package's)."""
    archive = artifact._open_source()
    try:
        plan = artifact.layer_plan(archive)
        _, missing = artifact.cache.missing_blobs(
            plan["artifact_key"], plan["layer_keys"] + [plan["config_key"]])
        missing_set = set(missing)
        todo = [(i, d, k) for i, (d, k) in enumerate(zip(plan["diff_ids"], plan["layer_keys"]))
                if k in missing_set]
        if not todo:
            return {"shared": 0, "seeded": 0, "new": 0}
        base = new_image_artifact(base_target, artifact.cache, artifact.analyzers,
                                  skip_files=artifact.skip_files, skip_dirs=artifact.skip_dirs,
                                  option=artifact.option)
        try:
            base_archive = base._open_source()
            try:
                base_index = {d: i for i, d in enumerate(base_archive.diff_ids)}
                history = plan["history"]
                seeded = 0
                for i, diff_id, lkey in todo:
                    bi = base_index.get(diff_id)
                    if bi is None:
                        continue
                    created_by = history[i].get("created_by", "") if i < len(history) else ""
                    blob, counts = base._analyze_layer(
                        bi, diff_id, created_by, skip_secret=i in plan["base_layers"],
                        archive=base_archive)  # serial: one open source
                    artifact.stats.update(counts)
                    artifact.cache.put_blob(lkey, blob.to_dict())
                    seeded += 1
            finally:
                base_archive.close()
        finally:
            base.close()
        artifact.stats["layers_seeded"] += seeded
        logger.info("diff-base %s: %d shared layer(s) seeded from the base (%d layer(s) "
                    "remain to analyze from the target)", base_target, seeded, len(todo) - seeded)
        return {"shared": seeded, "seeded": seeded, "new": len(todo) - seeded}
    finally:
        archive.close()
