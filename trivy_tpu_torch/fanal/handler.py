"""Post-analysis handlers (ref: pkg/fanal/handler), the port of
``trivy_tpu/fanal/handler.py``.

Priority-ordered hooks over (AnalysisResult, BlobInfo). The built-in
``sysfile`` handler drops language packages that were installed by the OS
package manager (ref: pkg/fanal/handler/sysfile/filter.go:54-106) so they
are not double-reported.
"""

from __future__ import annotations

from trivy_tpu_torch.fanal.analyzer import AnalysisResult
from trivy_tpu_torch.types import BlobInfo


class Handler:
    name: str = ""
    version: int = 1
    priority: int = 0

    def handle(self, result: AnalysisResult, blob: BlobInfo) -> None:
        raise NotImplementedError


class SystemFileFilterHandler(Handler):
    """Remove lang packages whose files belong to OS packages
    (ref: sysfile/filter.go)."""

    name = "system-file-filter"
    version = 1
    priority = 100

    def handle(self, result: AnalysisResult, blob: BlobInfo) -> None:
        system = set(result.system_files)
        if not system:
            return
        kept = []
        for app in blob.applications:
            if app.file_path and app.file_path in system:
                continue
            # ref appends unconditionally after overwriting Packages
            app.packages = [
                p for p in app.packages if not (p.file_path and p.file_path in system)
            ]
            kept.append(app)
        blob.applications = kept


_handlers: list[type[Handler]] = [SystemFileFilterHandler]


class HandlerManager:
    def __init__(self):
        self.handlers = sorted((h() for h in _handlers), key=lambda h: -h.priority)

    def versions(self) -> dict[str, int]:
        return {h.name: h.version for h in self.handlers}

    def post_handle(self, result: AnalysisResult, blob: BlobInfo) -> None:
        for h in self.handlers:
            h.handle(result, blob)
