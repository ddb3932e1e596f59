"""Secret analyzer: which files the secret scan reads, how their content is
prepared, and the streaming handoff into the device scanner.

File selection and content preparation follow the reference (ref:
pkg/fanal/analyzer/secret/secret.go:103-190) as the JAX package's
``fanal/analyzers/secret.py`` does: a 10-byte size floor, skip dirs
(.git, node_modules), lockfiles and binary-ish extensions, the secret
config file itself, and the global allow paths; a binary sniff with a
printable-strings extraction for allowed binaries, ``\\r`` stripping, and
a leading ``/`` for paths without a scan root (image layers).

Files stream from the walk into one ``TorchSecretScanner.scan_files`` call
running on a background thread, through a byte-bounded
:class:`~trivy_tpu_torch.secret.feed.FileStream`, so reading overlaps
chunking, copies and device matching.

In a fused ``--scanners secret,license`` scan the analyzer hands the scan a
:class:`~trivy_tpu_torch.licensing.fused.FusedLicenseGate` and marks as
skipped every file the license analyzers want that the secret feed will not
carry (too small, skipped dirs and names, allowed paths, binaries), so the
license analyzers classify those themselves.
"""

from __future__ import annotations

import os.path
import threading

from trivy_tpu_torch import log, obs
from trivy_tpu_torch.fanal.analyzer import AnalyzerType
from trivy_tpu_torch.fanal.utils import extract_printable_bytes, is_binary
from trivy_tpu_torch.secret.engine import ScannerConfig
from trivy_tpu_torch.secret.feed import FileStream
from trivy_tpu_torch.secret.scanner import TorchSecretScanner
from trivy_tpu_torch.types import Secret

logger = log.logger("secret")

# ref: secret.go:28-62
SKIP_FILES = {
    "go.mod",
    "go.sum",
    "package-lock.json",
    "yarn.lock",
    "pnpm-lock.yaml",
    "Pipfile.lock",
    "Gemfile.lock",
}
SKIP_DIRS = {".git", "node_modules"}
SKIP_EXTS = {
    ".jpg", ".png", ".gif", ".doc", ".pdf", ".bin", ".svg", ".socket",
    ".deb", ".rpm", ".zip", ".gz", ".gzip", ".tar",
}
ALLOWED_BINARIES = {".pyc"}

MIN_FILE_SIZE = 10  # ref: secret.go:152
LARGE_FILE_WARN = 10 * 1024 * 1024  # ref: secret.go:110
# byte budget of the walk→device handoff: the walk blocks once this much
# read content waits on the device pipeline
STREAM_BUFFER_BYTES = 64 * 1024 * 1024

class SecretAnalyzer:
    """Selects and prepares files for one scan and streams them to a
    :class:`TorchSecretScanner` on a background thread.

    ``required`` → ``collect`` per walked file, then ``finalize`` for the
    files with findings. ``abort`` ends the background scan early.
    ``scanner_opts`` (``dedup``, ``hit_cache``, ``hit_cache_bytes``,
    ``compress``, ``compress_min_ratio``) reach the
    :class:`TorchSecretScanner` it builds; ``scanner`` is one built
    already, which several analyzers may share (an image's layers, each
    streaming through its own ``scan_files`` call). ``license_gate`` is the
    fused scan's :class:`~trivy_tpu_torch.licensing.fused.FusedLicenseGate`.
    """

    type = AnalyzerType.SECRET
    version = 1  # the JAX package's, part of an image layer's cache key

    def __init__(self, root: str, config_path: str | None = None,
                 device="cuda", scanner: TorchSecretScanner | None = None,
                 license_gate=None, **scanner_opts):
        self.config_path = config_path
        self.license_gate = license_gate
        # the config file's scan-root-relative path, so its self-exclusion
        # matches at any nesting depth
        self._config_rel_path = None
        cfg = None
        if config_path:
            rel = os.path.relpath(os.path.abspath(config_path), os.path.abspath(root))
            if not rel.startswith(".."):
                self._config_rel_path = os.path.normpath(rel)
            if scanner is None and os.path.exists(config_path):
                cfg = ScannerConfig.from_yaml_file(config_path)
        self.scanner = scanner or TorchSecretScanner(cfg, device=device, **scanner_opts)
        self._stream: FileStream | None = None
        self._thread: threading.Thread | None = None
        self._found: list[Secret] = []
        self._error: BaseException | None = None

    def required(self, file_path: str, size: int) -> bool:
        ok = self._required(file_path, size)
        if not ok:
            self._lic_skip(file_path)
        return ok

    def _lic_skip(self, file_path: str) -> None:
        """The fused gate will have no verdict for this file: the license
        analyzers (whose eligibility differs) must classify it."""
        if self.license_gate is not None and self.license_gate.wants(file_path):
            self.license_gate.skip(file_path)

    def _required(self, file_path: str, size: int) -> bool:
        if size < MIN_FILE_SIZE:
            return False
        parts = file_path.split("/")
        if any(p in SKIP_DIRS for p in parts[:-1]):
            return False
        name = parts[-1]
        if name in SKIP_FILES:
            return False
        if self.config_path and self._config_rel_path == os.path.normpath(file_path):
            return False
        if os.path.splitext(name)[1] in SKIP_EXTS:
            return False
        # global allow paths, checked with the exact engine's rule set
        return not self.scanner.exact.allow_path(self._normalize(file_path, dir_="x"))

    @staticmethod
    def _normalize(file_path: str, dir_: str) -> str:
        # files without a scan root (image layers) get a leading '/'
        # (ref: secret.go:131-137)
        return file_path if dir_ else f"/{file_path}"

    def prepare(self, file_path: str, content: bytes, dir_: str) -> tuple[str, bytes] | None:
        """The (path, content) the scanner sees, or None for a binary file
        whose extension is not an allowed binary."""
        binary = is_binary(content)
        if binary and os.path.splitext(file_path)[1] not in ALLOWED_BINARIES:
            return None
        if len(content) > LARGE_FILE_WARN:
            logger.warning(
                "large file in secret scan (%d MB): %s — consider --skip-files",
                len(content) >> 20, file_path,
            )
        if binary:
            content = extract_printable_bytes(content)
        else:
            content = content.replace(b"\r", b"")
        return self._normalize(file_path, dir_), content

    def collect(self, file_path: str, content: bytes, dir_: str) -> None:
        prepared = self.prepare(file_path, content, dir_)
        if prepared is None:
            self._lic_skip(file_path)  # binary-sniffed out of the feed
            return
        if self._stream is None:
            self._stream = FileStream(STREAM_BUFFER_BYTES)
            self._thread = threading.Thread(
                target=self._run, args=(obs.current(),), daemon=True,
                name="secret-stream-scan",
            )
            self._thread.start()
        # blocks only once STREAM_BUFFER_BYTES of content waits on the
        # device pipeline; raises the scan thread's error instead of
        # buffering into a dead pipeline
        self._stream.put(*prepared)

    def _run(self, ctx) -> None:
        """The scan, on its own thread inside the walk's trace context."""
        try:
            with obs.activate(ctx):
                for s in self.scanner.scan_files(self._stream,
                                                 license_gate=self.license_gate):
                    if s.findings:
                        self._found.append(s)
        except BaseException as e:
            self._error = e
            # unblock (and poison) a producer waiting on the byte budget
            self._stream.fail(e)

    def finalize(self) -> list[Secret]:
        """Files with findings, sorted by path."""
        if self._stream is not None:
            self._stream.close()
            self._thread.join()
            self._stream = self._thread = None
            if self._error is not None:
                raise self._error
        found, self._found = self._found, []
        return sorted(found, key=lambda s: s.file_path)

    def abort(self) -> None:
        """End the background scan without results; the fused gate's
        verdicts are then incomplete, so it degrades."""
        if self._stream is not None:
            self._stream.fail(RuntimeError("scan aborted"))
            self._thread.join(timeout=10.0)
            self._stream = self._thread = None
        if self.license_gate is not None:
            self.license_gate.degrade()
        self._found = []
