"""The CONFIG analyzer (ref: pkg/fanal/analyzer/config/*), the port of
``trivy_tpu/fanal/analyzers/config.py``: a batched analyzer that collects
the IaC candidates during the walk (a cheap name prefilter) and scans them
with the misconfiguration scanner at finalize, so the walk stays one pass
beside the secret feed and the license gate.
"""

from __future__ import annotations

from trivy_tpu_torch import log
from trivy_tpu_torch.fanal.analyzer import AnalysisResult, AnalyzerType
from trivy_tpu_torch.misconf import MisconfScanner, ScannerOption, detection
from trivy_tpu_torch.types import Misconfiguration

logger = log.logger("analyzer")

# config files larger than this are data dumps, not IaC
MAX_CONFIG_BYTES = 1 << 20


class ConfigAnalyzer:
    """Collects ``(path, content)`` of every relevant file; ``finalize``
    scans them with the ``--config-check`` files of ``check_paths``, limited
    to the types of ``file_types`` when given (``--misconfig-scanners``).
    The custom checks load at the first finalize, as in the JAX package."""

    type = AnalyzerType.CONFIG
    version = 1  # the JAX package's, part of every cache key

    def __init__(self, check_paths=(), file_types=()):
        self._files: list[tuple[str, bytes]] = []
        self._option = ScannerOption(check_paths=list(check_paths), file_types=list(file_types))

    def required(self, file_path: str, size: int) -> bool:
        if size > MAX_CONFIG_BYTES:
            return False
        return detection.relevant(file_path)

    def collect(self, file_path: str, content: bytes) -> None:
        self._files.append((file_path, content))

    def finalize(self) -> list[Misconfiguration]:
        files, self._files = self._files, []
        return MisconfScanner(self._option).scan_files(files)

    def finalize_into(self, result: AnalysisResult) -> None:
        """:meth:`finalize` into ``result``. A failure (a check file that
        does not load) costs the misconfigurations and is logged, as the
        JAX analyzer group logs a failed batch analyzer."""
        try:
            result.misconfigurations.extend(self.finalize())
        except Exception as e:
            logger.warning("batch analyzer %s failed: %s", self.type.value, e)
