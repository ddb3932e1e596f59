"""Layer applier: merge per-layer BlobInfos into one ArtifactDetail with
overlayfs semantics (ref: pkg/fanal/applier/docker.go:94-165), the port of
``trivy_tpu/fanal/applier.py``.

Whiteout files delete the shadowed path; opaque dirs delete everything the
lower layers put under them; later layers win for OS identity, repository
and same-path packages, applications, misconfigurations, secrets and
licenses, which carry their layer id. A filesystem scan or an SBOM is one blob.
"""

from __future__ import annotations

from trivy_tpu_torch.types import ArtifactDetail, BlobInfo

# the package list an image scan rebuilds from its apk history (the image
# config analyzer's target); a real package DB supersedes it
APK_HISTORY_TARGET = "image history (apk commands)"


def _deleted_by_whiteouts(path: str, whiteouts: list[str], opaques: list[str]) -> bool:
    # secret/license paths from image layers carry a display-leading '/'
    # (ref: analyzer/secret secret.go:131-137); whiteout entries are raw tar
    # paths — compare both without the prefix
    path = path.lstrip("/")
    if path in whiteouts:
        return True
    return any(path == od or path.startswith(od.rstrip("/") + "/") for od in opaques)


def apply_layers(blobs: list[BlobInfo]) -> ArtifactDetail:
    """Merge blobs bottom-to-top (ref: docker.go:94 ApplyLayers)."""
    detail = ArtifactDetail()
    pkg_by_path: dict[str, object] = {}
    app_by_path: dict[tuple, object] = {}
    secret_by_path: dict[str, object] = {}
    lic_by_key: dict[tuple, object] = {}
    misconf_by_path: dict[str, object] = {}

    for blob in blobs:
        layer = blob.diff_id
        whiteouts = blob.whiteout_files
        opaques = blob.opaque_dirs
        if whiteouts or opaques:
            for d in (pkg_by_path, secret_by_path, misconf_by_path):
                for path in [p for p in d if _deleted_by_whiteouts(p, whiteouts, opaques)]:
                    del d[path]
            for d in (app_by_path, lic_by_key):  # tuple keys: path first
                for key in [k for k in d if _deleted_by_whiteouts(k[0], whiteouts, opaques)]:
                    del d[key]

        if blob.os is not None:
            detail.os = detail.os.merge(blob.os) if detail.os else blob.os
        if blob.repository is not None:
            detail.repository = blob.repository
        if blob.build_info is not None:
            merged = dict(detail.build_info or {})
            merged.update(blob.build_info)
            detail.build_info = merged
        if blob.digests:
            detail.digests.update(blob.digests)

        for pi in blob.package_infos:
            for p in pi.packages:
                p.layer = p.layer or layer
            pkg_by_path[pi.file_path] = pi
        for app in blob.applications:
            for p in app.packages:
                p.layer = p.layer or layer
            app_by_path[(app.file_path, app.type)] = app
        for sec in blob.secrets:
            for f in sec.findings:
                f.layer = f.layer or layer
            secret_by_path[sec.file_path] = sec
        for lic in blob.licenses:
            lic.layer = lic.layer or layer
            lic_by_key[(lic.file_path, lic.pkg_name, lic.type)] = lic
        for mc in blob.misconfigurations:
            mc.layer = mc.layer or layer
            misconf_by_path[mc.file_path] = mc

    # history-reconstructed apk packages are a fallback for stripped-DB
    # images only: when a real package DB was analyzed, reconstruction
    # would double-count every package (and its CVEs)
    if APK_HISTORY_TARGET in pkg_by_path and any(
        path != APK_HISTORY_TARGET and pi.packages for path, pi in pkg_by_path.items()
    ):
        del pkg_by_path[APK_HISTORY_TARGET]

    for pi in sorted(pkg_by_path.values(), key=lambda p: p.file_path):
        detail.packages.extend(pi.packages)
    detail.applications = [app_by_path[k] for k in sorted(app_by_path, key=lambda k: (k[0], k[1]))]
    detail.secrets = [secret_by_path[k] for k in sorted(secret_by_path)]
    detail.licenses = [lic_by_key[k] for k in sorted(lic_by_key)]
    detail.misconfigurations = [misconf_by_path[k] for k in sorted(misconf_by_path)]
    return detail
