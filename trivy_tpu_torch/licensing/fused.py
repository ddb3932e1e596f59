"""Shared-arena license gating: ride the secret feed's device pass.

The port of ``trivy_tpu/licensing/fused.py``. With ``--scanners
secret,license`` the secret feed's resident rows also run the license gram
gate (``ops/gram_gate.py``), and the license analyzer classifies only the
files the gate flagged, plus every file the gate could not cover. The gate
only selects; the classifier still produces the findings, so they are those
of classifying everything, because the selection is a superset of the files
with findings:

- a license finding needs a corpus gram, a pooled phrase gram or a short
  fingerprint phrase; the first two show as gram-key hits, the third as an
  anchor-word hit (the anchor word is part of the phrase);
- gram and anchor windows wider than the row overlap (the only ones the
  device can miss) are checked on the host by
  :meth:`FusedLicenseGate._host_patch`, on the file's full bytes;
- non-ASCII bytes flag their block, and files the secret feed never carries
  (binaries, files under 10 bytes, skipped dirs, allowed paths) are
  *uncovered*: the license analyzer classifies them itself.

Coverage is kept per canonical path and uncovered is sticky.

Unlike the JAX package, the port has no ``degrade``: a device error fails
the scan instead of sending every file to the classifier.
"""

from __future__ import annotations

import os.path
import threading

import numpy as np

from trivy_tpu_torch import log

logger = log.logger("license:fused")

__all__ = ["FusedLicenseGate", "get_gate_fn", "wants_license_path"]

# gram gates keyed by (chunk_len, device): their tables stay resident
_GATE_FN_CACHE: dict = {}
_GATE_LOCK = threading.Lock()


def get_gate_fn(chunk_len: int, device):
    """The ``[B, chunk_len] uint8 -> [B, chunk_len / block] uint8`` license
    gate (lane bits; a block is flagged when any is set) on ``device``, one
    per process per row shape."""
    from trivy_tpu_torch.device import resolve

    dev = resolve(device)
    with _GATE_LOCK:
        fn = _GATE_FN_CACHE.get((chunk_len, dev))
        if fn is None:
            from trivy_tpu_torch.licensing.classify import LicenseClassifier, classifier_tables
            from trivy_tpu_torch.ops.gram_gate import build_gram_gate_fn

            clf = classifier_tables()
            fn = build_gram_gate_fn(
                chunk_len, LicenseClassifier._LUT, clf._gate_keys, clf._anchor_sorted,
                int(LicenseClassifier._P1), int(LicenseClassifier._P2),
                int(LicenseClassifier._HASH_P), ngram=LicenseClassifier._NGRAM, device=dev,
            )
            _GATE_FN_CACHE[(chunk_len, dev)] = fn
    return fn


def wants_license_path(license_full: bool):
    """Predicate over walk paths: the files the license analyzers will ask
    the gate about (canonical license files; source headers only under
    ``--license-full``). Other files skip the gate stage, so secret-only
    traffic pays nothing for fusion."""
    from trivy_tpu_torch.fanal.license import HEADER_EXTS, is_license_file

    def wants(path: str) -> bool:
        if is_license_file(path):
            return True
        return license_full and os.path.splitext(path)[1].lower() in HEADER_EXTS

    return wants


def _canon(path: str) -> str:
    # the secret analyzer prefixes image-layer paths with '/', the license
    # analyzer asks with the raw walk path: one key space for both
    return path[1:] if path.startswith("/") else path


class FusedLicenseGate:
    """One scan's license-candidate verdicts (thread-safe).

    Producers: the secret analyzer and scanner, ``skip`` for files the
    device feed will never carry, ``cover`` and ``flag`` for files it does.
    Consumer: the license analyzers' finalize, which runs after the secret
    finalize, through :meth:`should_classify`. After :meth:`degrade` (the
    device pass failed or degraded) every collected file is classified.
    """

    def __init__(self, license_full: bool = False):
        self.wants = wants_license_path(license_full)
        self._lock = threading.Lock()
        self._covered: set[str] = set()
        self._skipped: set[str] = set()
        self._flagged: set[str] = set()
        self._degraded = False
        self.files_covered = 0
        self.files_flagged = 0
        self.files_patched = 0  # the host long-gram patch flagged the file

    # -- producer side ------------------------------------------------------

    def skip(self, path: str) -> None:
        """Sticky: this path's bytes will not (all) ride the device pass."""
        with self._lock:
            self._skipped.add(_canon(path))

    def cover(self, path: str) -> None:
        p = _canon(path)
        with self._lock:
            if p not in self._covered:
                self._covered.add(p)
                self.files_covered += 1

    def flag(self, path: str) -> None:
        p = _canon(path)
        with self._lock:
            if p not in self._flagged:
                self._flagged.add(p)
                self.files_flagged += 1

    def degrade(self) -> None:
        """The device pass died: no verdict can be trusted, so every query
        falls back to exact classification."""
        with self._lock:
            if not self._degraded:
                self._degraded = True
                logger.warning("fused license gate degraded; the license analyzer will "
                               "classify every collected file")

    # -- consumer side ------------------------------------------------------

    def should_classify(self, path: str) -> bool:
        """True unless the device pass covered every byte of this path and
        flagged nothing: the only case where skipping the classifier is
        safe."""
        p = _canon(path)
        with self._lock:
            if self._degraded or p in self._flagged:
                return True
            return p not in self._covered or p in self._skipped

    # -- host patch for windows wider than the device coverage bound -------

    def feed_file(self, path: str, data: bytes, span_bound: int) -> None:
        """Register coverage for a file entering the device feed and check on
        the host the gram and anchor windows wider than ``span_bound`` (the
        widest window guaranteed to lie inside some row)."""
        self.cover(path)
        if not data:
            return
        try:
            if self._host_patch(data, span_bound):
                with self._lock:
                    self.files_patched += 1
                self.flag(path)
        except Exception as e:  # a failed patch must fail safe: classify
            logger.warning("license host patch failed for %s: %s", path, e)
            self.skip(path)

    def _host_patch(self, data: bytes, span_bound: int) -> bool:
        from trivy_tpu_torch.licensing.classify import LicenseClassifier as C
        from trivy_tpu_torch.licensing.classify import classifier_tables

        b = np.frombuffer(data, dtype=np.uint8)
        bm = C._LUT[b]
        nz = bm != 0
        if not nz.any():
            return False
        n = len(b)
        prev = np.empty(n, dtype=bool)
        prev[0] = False
        prev[1:] = nz[:-1]
        nxt = np.empty(n, dtype=bool)
        nxt[-1] = False
        nxt[:-1] = nz[1:]
        starts = np.nonzero(nz & ~prev)[0]
        ends = np.nonzero(nz & ~nxt)[0] + 1  # exclusive, aligned with starts
        ng = C._NGRAM
        long_words = np.nonzero(ends - starts > span_bound)[0]
        if len(starts) >= ng:
            gspan = ends[ng - 1 :] - starts[: len(starts) - ng + 1]
            long_grams = np.nonzero(gspan > span_bound)[0]
        else:
            long_grams = np.zeros(0, dtype=np.int64)
        if not len(long_words) and not len(long_grams):
            return False
        # hash every word once (the classifier's formula)
        pos = C._positions(n)
        s0 = np.add.reduceat(bm, starts)
        with np.errstate(over="ignore"):
            s1 = np.add.reduceat(bm * pos, starts) - starts * s0
            wh = s0 * C._P1 + s1 * C._P2
        clf = classifier_tables()
        if len(long_words) and len(clf._anchor_sorted):
            p = np.searchsorted(clf._anchor_sorted, wh[long_words])
            p[p >= len(clf._anchor_sorted)] = 0
            if (clf._anchor_sorted[p] == wh[long_words]).any():
                return True
        if len(long_grams):
            with np.errstate(over="ignore"):
                keys = wh[long_grams].copy()
                for j in range(1, ng):
                    keys *= C._HASH_P
                    keys += wh[long_grams + j]
            p = np.searchsorted(clf._gate_keys, keys)
            p[p >= len(clf._gate_keys)] = 0
            if (clf._gate_keys[p] == keys).any():
                return True
        return False
