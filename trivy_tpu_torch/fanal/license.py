"""License analyzers (ref: pkg/fanal/analyzer/licensing/license.go).

The port of ``trivy_tpu/fanal/analyzers/license.py``, two batched
analyzers:

- ``license-file``: canonical license files (LICENSE, COPYING, NOTICE and
  their variants), classified whole whenever the license scanner is on;
- ``header``: the first 4 KiB of source files, behind ``--license-full``.

Both collect during the walk and classify in one ``classify_batch`` call at
finalize. With a :class:`~trivy_tpu_torch.licensing.fused.FusedLicenseGate`
(``--scanners secret,license``), finalize runs after the secret analyzer's
and classifies only the files the gate could not rule out.
"""

from __future__ import annotations

import os.path

from trivy_tpu_torch.device import resolve
from trivy_tpu_torch.fanal.analyzer import AnalysisResult, AnalyzerType
from trivy_tpu_torch.types import LicenseFile

# canonical license file stems (ref: licensing/license.go acceptable names)
LICENSE_STEMS = {
    "license", "licence", "copying", "copyright", "notice", "unlicense",
    "licenses", "licences",
}
LICENSE_EXTS = {"", ".txt", ".md", ".rst", ".html"}

# source extensions whose headers are worth classifying
HEADER_EXTS = {
    ".c", ".h", ".cc", ".cpp", ".hpp", ".go", ".py", ".js", ".ts", ".java",
    ".rb", ".rs", ".sh", ".swift", ".kt", ".scala", ".cs", ".m", ".mm",
}

MAX_LICENSE_BYTES = 512 << 10  # a license file larger than this is data
HEADER_BYTES = 4 << 10  # header classification reads the file head only


def is_license_file(file_path: str) -> bool:
    base = os.path.basename(file_path).lower()
    stem, ext = os.path.splitext(base)
    if ext in LICENSE_EXTS and stem in LICENSE_STEMS:
        return True
    # LICENSE-MIT / LICENSE.BSD / COPYING.LIB style; source files named
    # license.<ext> are code, not license texts
    if ext in HEADER_EXTS:
        return False
    return any(base.startswith(s + "-") or base.startswith(s + ".")
               for s in ("license", "licence", "copying"))


class LicenseAnalyzer:
    """One of the two license analyzers (``kind`` ``license-file`` or
    ``header``): ``required`` -> ``collect`` per walked file, then
    ``finalize`` classifies on ``device``, degrading a failed device batch
    to the host oracle unless ``host_fallback`` is off."""

    version = 1  # the JAX package's, part of an image layer's cache key

    def __init__(self, kind: str, device, gate=None, host_fallback: bool = True, tuning=None):
        if kind not in ("license-file", "header"):
            raise ValueError(f"unknown license analyzer {kind!r}")
        self.kind = kind
        self.type = AnalyzerType.LICENSE_FILE if kind == "license-file" else \
            AnalyzerType.LICENSE_HEADER
        self.device = resolve(device)
        self.gate = gate  # FusedLicenseGate of a fused scan, or None
        self.host_fallback = host_fallback
        # the classifier's device-path knobs (TuningConfig; 0: its default),
        # passed on as the JAX analyzer passes them
        self.gate_block_min = int(getattr(tuning, "license_gate_block_min", 0) or 0)
        self.row_width = int(getattr(tuning, "license_row_width", 0) or 0)
        self._files: list[tuple[str, str]] = []  # (path, text)

    def required(self, file_path: str, size: int) -> bool:
        if self.kind == "license-file":
            return size <= MAX_LICENSE_BYTES and is_license_file(file_path)
        return size > 0 and os.path.splitext(file_path)[1].lower() in HEADER_EXTS

    def collect(self, file_path: str, content: bytes) -> None:
        if self.kind == "header":
            content = content[:HEADER_BYTES]
        self._files.append((file_path, content.decode("utf-8", "replace")))

    def finalize(self) -> list[LicenseFile]:
        """The files with findings, in the order collected."""
        from trivy_tpu_torch.licensing.classify import LicenseClassifier

        files, self._files = self._files, []
        if self.gate is not None:
            files = [(p, t) for p, t in files if self.gate.should_classify(p)]
        if not files:
            return []
        clf = LicenseClassifier(device=self.device, host_fallback=self.host_fallback,
                                gate_block_min=self.gate_block_min, row_width=self.row_width)
        per_file = clf.classify_batch([t for _p, t in files])
        return [
            LicenseFile(type=self.kind, file_path=path, findings=findings)
            for (path, _t), findings in zip(files, per_file)
            if findings
        ]

    def finalize_into(self, result: AnalysisResult) -> None:
        """:meth:`finalize` into ``result``'s licenses."""
        result.licenses.extend(self.finalize())
