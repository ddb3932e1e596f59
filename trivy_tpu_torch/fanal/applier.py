"""Layer applier: merge per-layer BlobInfos into one ArtifactDetail (ref:
pkg/fanal/applier/docker.go:94-165).

The part of the JAX package's ``trivy_tpu/fanal/applier.py::apply_layers``
that an SBOM's blob reaches: later layers win for OS identity and for
same-path package lists and applications, and packages carry their layer
id. Whiteouts, secrets, licenses and misconfigurations wait for the image
scan.
"""

from __future__ import annotations

from trivy_tpu_torch.types import ArtifactDetail, BlobInfo


def apply_layers(blobs: list[BlobInfo]) -> ArtifactDetail:
    """Merge blobs bottom-to-top (ref: docker.go:94 ApplyLayers)."""
    detail = ArtifactDetail()
    pkg_by_path: dict[str, object] = {}
    app_by_path: dict[tuple, object] = {}
    for blob in blobs:
        layer = blob.diff_id
        if blob.os is not None:
            detail.os = detail.os.merge(blob.os) if detail.os else blob.os
        for pi in blob.package_infos:
            for p in pi.packages:
                p.layer = p.layer or layer
            pkg_by_path[pi.file_path] = pi
        for app in blob.applications:
            for p in app.packages:
                p.layer = p.layer or layer
            app_by_path[(app.file_path, app.type)] = app
    for pi in sorted(pkg_by_path.values(), key=lambda p: p.file_path):
        detail.packages.extend(pi.packages)
    detail.applications = [app_by_path[k] for k in sorted(app_by_path)]
    return detail
