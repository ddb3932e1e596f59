"""Local scan driver (ref: pkg/scanner/local/scan.go), the port of
``trivy_tpu/scanner/local_driver.py``: applies the layers, then assembles
the per-class results in the reference's order — vulnerabilities (else,
with ``--list-all-pkgs``, the package inventory), misconfigurations,
secrets, licenses — and
runs the post-scan hooks (ref: scan.go:63-151, 229-318).
"""

from __future__ import annotations

from collections import Counter

from trivy_tpu_torch import obs
from trivy_tpu_torch.device import DEFAULT_DEVICE
from trivy_tpu_torch.fanal.applier import apply_layers
from trivy_tpu_torch.scanner import ScanOptions
from trivy_tpu_torch.scanner.post import post_scan
from trivy_tpu_torch.types import OS, BlobInfo, DetectedLicense, Result, ResultClass


class LocalDriver:
    """Detection against ``vuln_client`` (a loaded advisory DB, or None) on
    ``device``; ``stats`` gathers the CVE join's counters, and
    ``host_fallback`` lets a failed join finish on the host."""

    def __init__(self, vuln_client=None, device=DEFAULT_DEVICE, stats: Counter | None = None,
                 host_fallback: bool = True):
        self.vuln_client = vuln_client
        self.device = device
        self.host_fallback = host_fallback
        self.stats = stats if stats is not None else Counter()

    def scan(self, target: str, blobs: list[BlobInfo],
             options: ScanOptions) -> tuple[list[Result], OS | None]:
        ctx = obs.current()
        # with no walk before it (an SBOM), the blobs are the scan's
        # work-list for its progress, as in the JAX driver
        prog = ctx.progress()
        track_blobs = prog.files_walked == 0
        if track_blobs:
            prog.note_walked(0, files=len(blobs))
        with ctx.span("driver.apply_layers"):
            if track_blobs:
                prog.note_scanned(0, files=len(blobs))
            detail = apply_layers(blobs)
        results: list[Result] = []
        if "vuln" in options.scanners and self.vuln_client is not None:
            from trivy_tpu_torch.detector import detect_all

            with ctx.span("driver.detect_vulns"):
                results += detect_all(self.vuln_client, target, detail, self.device,
                                      self.stats, list_all_pkgs=options.list_all_pkgs,
                                      host_fallback=self.host_fallback)
        elif options.list_all_pkgs:
            # package inventory without detection
            results += self._package_results(target, detail)
        if "misconfig" in options.scanners:
            results += [Result(target=mc.file_path, cls=ResultClass.CONFIG.value,
                               type=mc.file_type, misconfigurations=mc.successes + mc.failures)
                        for mc in detail.misconfigurations]
        if "secret" in options.scanners:
            results += [Result(target=s.file_path, cls=ResultClass.SECRET.value,
                               secrets=s.findings) for s in detail.secrets]
        if "license" in options.scanners:
            results += self._license_results(detail)
        return post_scan(results), detail.os

    @staticmethod
    def _package_results(target, detail) -> list[Result]:
        results: list[Result] = []
        if detail.packages:
            name = target
            if detail.os:
                name = f"{target} ({detail.os.family} {detail.os.name})"
            results.append(Result(target=name, cls=ResultClass.OS_PKGS.value,
                                  type=detail.os.family if detail.os else "",
                                  packages=detail.packages))
        for app in sorted(detail.applications, key=lambda a: (a.file_path, a.type)):
            results.append(Result(target=app.file_path or app.type,
                                  cls=ResultClass.LANG_PKGS.value, type=app.type,
                                  packages=app.packages))
        return results

    @staticmethod
    def _license_results(detail) -> list[Result]:
        """``OS Packages``, ``Language Packages``, then ``Loose File
        License(s)`` (ref: scan.go:270-318)."""
        from trivy_tpu_torch.licensing.scanner import LicenseCategorizer

        cat = LicenseCategorizer()
        os_lics = [cat.detect(name, pkg_name=pkg.name)
                   for pkg in detail.packages for name in pkg.licenses]
        app_lics = [cat.detect(name, pkg_name=pkg.name)
                    for app in detail.applications for pkg in app.packages
                    for name in pkg.licenses]
        file_lics: list[DetectedLicense] = []
        for lf in detail.licenses:
            for f in lf.findings:
                d = cat.detect(f.name, file_path=lf.file_path)
                d.confidence = f.confidence
                d.link = f.link
                file_lics.append(d)
        results = []
        if os_lics:
            results.append(Result(target="OS Packages", cls=ResultClass.LICENSE.value,
                                  licenses=os_lics))
        if app_lics:
            results.append(Result(target="Language Packages", cls=ResultClass.LICENSE.value,
                                  licenses=app_lics))
        if file_lics:
            results.append(Result(target="Loose File License(s)",
                                  cls=ResultClass.LICENSE_FILE.value, licenses=file_lics))
        return results
