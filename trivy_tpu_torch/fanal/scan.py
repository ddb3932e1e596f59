"""The analyzers of one scan and the one walk loop that feeds them, for a
directory tree (``fs``, ``rootfs``) and for every layer of an image.

:class:`ScanAnalyzers` holds what one scan shares: the per-file analyzer
group, the one :class:`~trivy_tpu_torch.secret.scanner.TorchSecretScanner`
(its kernels and tables are built once per scan, however many layers it
reads), the fused license gate and the misconfiguration settings.
:meth:`ScanAnalyzers.batch` gives a tree or a layer its own batched
analyzers over them; each streams through its own ``scan_files`` call, so
layers may run at once.
:func:`analyze_files` walks one tree or layer through them (ref:
pkg/fanal/artifact/local/fs.go and image/image.go, which share
``AnalyzerGroup.AnalyzeFile``).
"""

from __future__ import annotations

import os.path
import queue
import threading
from collections import Counter, deque
from collections.abc import Callable, Iterable
from concurrent.futures import Future

from trivy_tpu_torch import log, obs
from trivy_tpu_torch.device import resolve
from trivy_tpu_torch.fanal.analyzer import (
    OS_IDENTITY,
    AnalysisResult,
    AnalyzerGroup,
    AnalyzerOptions,
)
from trivy_tpu_torch.fanal.config import ConfigAnalyzer
from trivy_tpu_torch.fanal.license import LicenseAnalyzer
from trivy_tpu_torch.fanal.secret import SecretAnalyzer
from trivy_tpu_torch.fanal.walker import FileInfo

logger = log.logger("analyze")

SCANNERS = ("vuln", "misconfig", "secret", "license")


def check_scanners(scanners) -> None:
    unknown = set(scanners) - set(SCANNERS)
    if unknown or not scanners:
        raise ValueError(f"unsupported scanners {sorted(unknown) or scanners!r}: "
                         f"use {', '.join(SCANNERS)}")


class ScanAnalyzers:
    """The analyzers of one scan with ``scanners``: the OS identity
    analyzers always, the package analyzers when ``packages`` is true or,
    left None, when the report can show packages (``vuln``, ``license`` or
    ``list_all_pkgs``) or with ``misconfig`` (whose cache keys then equal the
    JAX package's), the secret and license analyzers as their scanners ask
    (source headers only with ``license_full``), and with ``misconfig`` the
    config analyzer, with the ``--config-check`` files of ``check_paths``
    and limited to the types of ``misconfig_scanners`` when given. With both scanners and
    ``shared_arena`` the license analyzers ride the secret feed's rows
    through one :class:`~trivy_tpu_torch.licensing.fused.FusedLicenseGate`.
    ``host_fallback`` lets the secret feed and the license classifier finish
    a failed device pass on the host (off: the error fails the scan).
    ``scanner_opts`` reach the secret scanner."""

    def __init__(self, scanners, device, license_full: bool = False,
                 shared_arena: bool = True, config_path: str | None = None,
                 java_db: str | None = None, list_all_pkgs: bool = False,
                 packages: bool | None = None, host_fallback: bool = True,
                 check_paths=(), misconfig_scanners=(), **scanner_opts):
        from trivy_tpu_torch.licensing.fused import FusedLicenseGate
        from trivy_tpu_torch.secret.engine import ScannerConfig
        from trivy_tpu_torch.secret.scanner import TorchSecretScanner

        check_scanners(scanners)
        self.device = resolve(device)
        self.misconfig = "misconfig" in scanners
        self.check_paths = list(check_paths)
        self.misconfig_scanners = list(misconfig_scanners)
        self.config_path = config_path
        self.host_fallback = host_fallback
        self.tuning = scanner_opts.get("tuning")
        self.license_kinds = ()
        if "license" in scanners:
            self.license_kinds = ("license-file", "header") if license_full else ("license-file",)
        self.gate = None
        if "secret" in scanners and "license" in scanners and shared_arena:
            self.gate = FusedLicenseGate(license_full=license_full)
        self.scanner = None
        if "secret" in scanners:
            cfg = None
            if config_path and os.path.exists(config_path):
                cfg = ScannerConfig.from_yaml_file(config_path)
            self.scanner = TorchSecretScanner(cfg, device=self.device,
                                              host_fallback=host_fallback, **scanner_opts)
            if self.gate is not None:
                # the gram gate's kernel loads with the scan, not mid-feed
                self.scanner._ensure_license_stage()
        if packages is None:
            packages = (list_all_pkgs
                        or any(s in scanners for s in ("vuln", "license", "misconfig")))
        self.group = AnalyzerGroup(AnalyzerOptions(enabled=None if packages else OS_IDENTITY,
                                                   extra={"java_db_path": java_db}))

    def batch(self, root: str, skip_secret: bool = False
              ) -> tuple[SecretAnalyzer | None, list[ConfigAnalyzer | LicenseAnalyzer]]:
        """Fresh batched analyzers for the tree or layer at ``root`` (``""``
        for a layer): the secret analyzer, and the others in the JAX
        package's finalize order (config, then license). ``skip_secret``
        leaves the secret analyzer out (an image's base layers); the license
        analyzers then classify every file, as no feed covers any."""
        secret = None
        if self.scanner is not None and not skip_secret:
            secret = SecretAnalyzer(root, config_path=self.config_path, scanner=self.scanner,
                                    license_gate=self.gate)
        gate = self.gate if secret is not None else None
        others: list = []
        if self.misconfig:
            others.append(ConfigAnalyzer(self.check_paths, self.misconfig_scanners))
        others += [LicenseAnalyzer(k, self.device, gate=gate, host_fallback=self.host_fallback,
                                   tuning=self.tuning)
                   for k in self.license_kinds]
        return secret, others

    def versions(self) -> dict[str, int]:
        """type -> version of every analyzer this scan runs on a layer that
        is not a base layer, the batched ones included (the JAX package's
        ``AnalyzerGroup.versions``)."""
        out = self.group.versions()
        if self.scanner is not None:
            out[SecretAnalyzer.type.value] = SecretAnalyzer.version
        for a in self.batch("", skip_secret=True)[1]:
            out[a.type.value] = a.version
        return dict(sorted(out.items()))

    def stats(self) -> dict:
        """The secret feed's counters and the fused gate's file counts, over
        every tree or layer this scan fed."""
        out = {}
        if self.scanner is not None:
            out.update(self.scanner.stats.snapshot())
        if self.gate is not None:
            out.update(files_covered=self.gate.files_covered,
                       files_flagged=self.gate.files_flagged,
                       files_patched=self.gate.files_patched)
        return out


# host workers when neither --parallel nor the tuning config sets them: a
# directory walk's read-ahead readers, the layers an image scan analyzes at
# once (the JAX package's DEFAULT_PARALLEL)
DEFAULT_PARALLEL = 5
# the read-ahead window: at most this many bytes of read-ahead files, and
# max(PREFETCH_FILES, 16 * workers) files, between the walk and the analyzers
PREFETCH_BYTES = 256 << 20
PREFETCH_FILES = 128


class ReadAheadPool:
    """``workers`` daemon threads that run file openers ahead of the walk
    (the JAX fs artifact's reader pool), each returning a
    :class:`~concurrent.futures.Future`, in the trace context ``ctx`` (a
    ``walker.read`` fault lands in the scan's flight ring, as an inline
    read's does). Its threads are daemons, so a read still running when the
    scan ends (a timeout, a failure) cannot keep the process alive;
    :meth:`shutdown` cancels the reads not yet begun."""

    def __init__(self, workers: int, ctx=None):
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._ctx = ctx or obs.current()
        self._closed = False
        self._threads = [threading.Thread(target=self._run, daemon=True, name=f"fs-read-{i}")
                         for i in range(workers)]
        for t in self._threads:
            t.start()

    def submit(self, fn: Callable[[], bytes]) -> Future:
        fut: Future = Future()
        self._q.put((fn, fut))
        return fut

    def _run(self) -> None:
        with obs.activate(self._ctx):
            while True:
                task = self._q.get()
                if task is None:
                    return
                fn, fut = task
                if self._closed or not fut.set_running_or_notify_cancel():
                    fut.cancel()
                    continue
                try:
                    fut.set_result(fn())
                except BaseException as e:  # the reader's error, for the walk to take
                    fut.set_exception(e)

    def shutdown(self) -> None:
        self._closed = True
        for _ in self._threads:
            self._q.put(None)


def analyze_files(entries: Iterable[tuple[str, FileInfo, Callable[[], bytes]]], root: str,
                  group: AnalyzerGroup, secret: SecretAnalyzer | None,
                  batched: list, counts: Counter,
                  read_ahead: int = 0,
                  result_for: Callable[[str], AnalysisResult] | None = None,
                  walk_progress: bool = True) -> AnalysisResult:
    """Walk ``entries`` (``(rel, info, opener)`` of a tree under ``root`` or
    of a layer, ``root`` ``""``) through ``group`` and the batched analyzers
    (``secret`` and the ``batched`` others of :meth:`ScanAnalyzers.batch`),
    then finalize them: the secret analyzer first, as the fused gate is
    complete only then. ``counts`` gains ``files_walked``,
    ``files_scanned`` and ``files_skipped``, the files an analyzer wanted
    that could not be read (ref: the JAX package's ``note_file_skipped``,
    the report's ``SkippedFiles``).

    With ``read_ahead`` workers (a directory tree: ``fs``, ``rootfs``,
    ``repo``) a :class:`ReadAheadPool` reads the wanted files ahead of the
    analyzers, within a window of ``PREFETCH_BYTES`` and
    ``max(PREFETCH_FILES, 16 * read_ahead)`` files; files are still
    analyzed in walk order, so results and counters do not depend on it.
    With 0 each file is read inline (a layer's or a disk's entries read
    from one stream).

    With ``result_for`` (the incremental artifact's dirty units) each file's
    per-file analyzer output goes into ``result_for(rel)`` and the returned
    result holds only the batched analyzers' findings. ``walk_progress``
    off leaves the walked bytes and the walk's end out of the progress, for
    a caller that walked the entries itself.

    The scan's trace context gets the JAX walk's spans: ``fs.read_wait``
    (each read, or the wait on its read-ahead) and ``fs.batch_analyze``
    (the batched analyzers' finalize, where the secret, misconfiguration
    and license scans drain), ``walk.skipped``, and the always-on progress
    (bytes walked against scanned); a heartbeat logs the progress every 30 s
    of a long walk."""
    ctx = obs.current()
    progress = ctx.progress()
    read_span = ctx.enabled
    result = AnalysisResult()
    batch = ([secret] if secret is not None else []) + batched
    n_analyzed = [0]  # read by the heartbeat thread

    def analyze(rel, info, takers, batch_takers, load) -> None:
        if load is None:  # no analyzer wants the file
            progress.note_scanned(info.size)
            return
        try:
            if read_span:
                with ctx.span("fs.read_wait"):
                    content = load()
            else:
                content = load()
        except OSError as e:
            # the file vanished or turned unreadable after the walk
            logger.warning("skipping %s: unreadable (%s)", rel, e)
            counts["files_skipped"] += 1
            ctx.count("walk.skipped")
            ctx.health_count("walk.skipped")
            progress.note_scanned(info.size)
            return
        counts["files_scanned"] += 1
        group.analyze_file(result if result_for is None else result_for(rel), takers, root,
                           rel, info, content)
        for a in batch_takers:
            if a is secret:
                a.collect(rel, content, dir_=root)
            else:
                a.collect(rel, content)
        n_analyzed[0] += 1
        progress.note_scanned(info.size)

    pool = ReadAheadPool(read_ahead, ctx) if read_ahead > 0 else None
    max_files = max(PREFETCH_FILES, 16 * read_ahead)
    window: deque = deque()  # (rel, info, takers, batch_takers, load)
    buffered = 0
    try:
        with obs.heartbeat(logger, f"fs scan of {root}" if root else "layer scan",
                           progress=lambda: f"{n_analyzed[0]} files analyzed"):
            for rel, info, opener in entries:
                counts["files_walked"] += 1
                if walk_progress:
                    progress.note_walked(info.size)
                takers = group.required(rel, info)
                batch_takers = [a for a in batch if a.required(rel, info.size)]
                wanted = bool(takers or batch_takers)
                if pool is None:
                    analyze(rel, info, takers, batch_takers, opener if wanted else None)
                    continue
                window.append((rel, info, takers, batch_takers,
                               pool.submit(opener).result if wanted else None))
                buffered += info.size if wanted else 0
                while buffered > PREFETCH_BYTES or len(window) > max_files:
                    entry = window.popleft()
                    buffered -= entry[1].size if entry[4] is not None else 0
                    analyze(*entry)
            if walk_progress:
                progress.finish_walk()
            while window:
                analyze(*window.popleft())
            # the batched analyzers join their streaming device scans here
            with ctx.span("fs.batch_analyze"):
                if secret is not None:
                    result.secrets = secret.finalize()
                for a in batched:
                    a.finalize_into(result)
    except BaseException:
        if secret is not None:
            secret.abort()
        raise
    finally:
        if pool is not None:
            pool.shutdown()
    return result
