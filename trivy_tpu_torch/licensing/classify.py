"""License classification over file contents.

The port of ``trivy_tpu/licensing/classify.py``. Classification is word
5-gram similarity against the normalized full license texts
(``corpus_texts``) plus a phrase lane for headers and abbreviated notices
(ref: pkg/licensing/classifier.go:17-84, which wraps
google/licenseclassifier).

Two engines share one scoring model:

- **host path**, the oracle: candidate gating by an inverted gram index,
  then per-candidate numpy scoring. Batches of fewer than
  ``DEVICE_MIN_TEXTS`` texts take it.
- **device path**, for larger batches: the texts cross to the device as
  zero-padded uint8 rows on a width ladder; the shingle gate
  (``ops/bytes_gate.py``) picks the rows worth scoring and the raw-bytes
  scorer (``ops/bytes_score.py``) tokenizes, hashes, dedups and scores them
  against the resident corpus table. The host settles texts at or above the
  widest rung, rows whose distinct grams exceed the scorer's cap, and
  confidences within ``EPS`` of the threshold, so the findings are the
  oracle's. On ``device="cpu"`` the same pipeline runs the kernels' plain
  versions.

A device error on ``device="cpu"`` degrades the batch to the host oracle,
as in the JAX package (``obs.degrade_or_raise``): ``license.degraded`` is
counted, the first failure of a classifier is logged and marks the scan
degraded (``obs.note_scan_degraded``). With ``host_fallback=False``, on
``cuda``, or for a kernel fault (a kernel that cannot build, load or
launch, or a CUDA error from the card) the error is raised.
"""

from __future__ import annotations

import functools
import threading
import time
from collections import Counter, deque

import numpy as np

from trivy_tpu_torch import faults, log
from trivy_tpu_torch.device import DEFAULT_DEVICE, resolve
from trivy_tpu_torch.licensing.corpus import (
    MIN_CONFIDENCE,
    NORMALIZED_FINGERPRINTS,
    SUBSUMES,
    normalize,
)
from trivy_tpu_torch.ops import _build
from trivy_tpu_torch.ops.ragged import ragged_arange
from trivy_tpu_torch.types import LicenseFinding

logger = log.logger("license")

_SPDX_URL = "https://spdx.org/licenses/{}.html"

# batches in flight before the oldest result is fetched
DEVICE_PIPELINE_DEPTH = 3
# below this many texts the fixed dispatch overhead beats the device win
DEVICE_MIN_TEXTS = 8
# shingle-gate density floor: 8-byte-window corpus hits required in some
# 512-byte block of a row before the scorer sees it (recall-tuned: a single
# ~30-byte fingerprint phrase contributes ~20 windows to its block)
GATE_BLOCK_MIN = 16
# float32 accumulation slack of the device sums: comparisons within it are
# settled by the exact host scorer
EPS = 1e-4

# corpus-derived tables, built once per process and shared by every
# classifier (the analyzer builds one per scan)
_STATIC_TABLES: dict | None = None
_STATIC_LOCK = threading.Lock()


def _static_scoring_tables() -> dict:
    global _STATIC_TABLES
    if _STATIC_TABLES is None:
        with _STATIC_LOCK:
            if _STATIC_TABLES is None:
                _STATIC_TABLES = LicenseClassifier._compute_static_tables()
    return _STATIC_TABLES


class LicenseClassifier:
    """``classify(text)`` -> findings on the host; ``classify_batch(texts)``
    for many files, on ``device`` (``cuda`` by default, raising without
    CUDA, or ``cpu``) from ``DEVICE_MIN_TEXTS`` texts up. ``host_fallback``
    (default on) lets a device error on the CPU degrade the batch to the
    host oracle.
    On ``cuda`` the two kernel libraries load here."""

    def __init__(self, device=DEFAULT_DEVICE, confidence: float = MIN_CONFIDENCE,
                 host_fallback: bool = True):
        self.device = resolve(device)
        if self.device.type == "cuda":
            _build.preload("bytes_gate", "bytes_score")
        self.confidence = confidence
        self.host_fallback = host_fallback
        self._device_failed_logged = False
        self._scorer = None  # ops.ngram_score.DeviceBytesScorer, lazy
        self.licenses = sorted(NORMALIZED_FINGERPRINTS)
        self.phrases: list[tuple[int, str]] = [
            (li, ph) for li, lic in enumerate(self.licenses) for ph in NORMALIZED_FINGERPRINTS[lic]
        ]

    # -- host path ----------------------------------------------------------

    def classify(self, text: str) -> list[LicenseFinding]:
        if not hasattr(self, "_gate_keys"):
            self._build_scoring()
        whashes = self._word_hashes(text)  # raw text; the LUT lowercases
        grams = np.unique(self._keys_from_hashes(whashes))
        # inverted-index gate: which licenses share any gram with the text
        pos = np.searchsorted(self._gate_keys, grams)
        pos[pos >= len(self._gate_keys)] = 0
        hit_idx = pos[self._gate_keys[pos] == grams]
        cands: set[int] = set()
        if len(hit_idx):
            starts = self._gate_off[hit_idx]
            lens = self._gate_off[hit_idx + 1] - starts
            nzl = lens > 0
            if nzl.any():
                rows = ragged_arange(starts[nzl], lens[nzl])
                cands = set(np.unique(self._gate_lic[rows]).tolist())
        # short fingerprint phrases (no 5-gram): anchor-word test, then the
        # exact substring check on the normalized text
        norm: str | None = None
        if self._short_gate and len(whashes):
            sw = np.sort(whashes)
            p = np.searchsorted(sw, self._short_anchors)
            p[p >= len(sw)] = 0
            for i in np.nonzero(sw[p] == self._short_anchors)[0].tolist():
                li, ph, _anchor = self._short_gate[i]
                if li not in cands:
                    if norm is None:
                        norm = normalize(text)
                    if ph in norm:
                        cands.add(li)
        if not cands:
            return []
        if norm is None:
            norm = normalize(text)
        return self._findings_candidates(cands, norm, grams)

    # -- batched path --------------------------------------------------------

    def classify_batch(self, texts: list[str]) -> list[list[LicenseFinding]]:
        if len(texts) >= DEVICE_MIN_TEXTS:
            try:
                return self._classify_batch_device(texts)
            except Exception as e:
                # the host batch scorer is the parity oracle: degrade to it
                # (findings identical, slower) where the policy allows
                from trivy_tpu_torch import obs

                obs.degrade_or_raise(
                    e, device=self.device, host_fallback=self.host_fallback,
                    counter="license.degraded", first=not self._device_failed_logged,
                    logger=logger, message="license device scoring failed (%s); degrading to "
                                           "the host scorer for this classifier")
                self._device_failed_logged = True
        if len(texts) < 4:
            return [self.classify(t) for t in texts]
        return self._classify_batch_host(texts)

    @classmethod
    def _batch_hashes(cls, texts: list[str]):
        """One vectorized pass over every text's bytes -> ``(whashes,
        word_text, keys, gt)``: int64 word hashes with the owning text of
        each word, and int64 gram keys with the owning text of each gram."""
        encoded = [t.encode("latin-1", "replace") for t in texts]
        offsets = np.zeros(len(texts) + 1, dtype=np.int64)
        np.cumsum([len(e) + 1 for e in encoded], out=offsets[1:])
        b = np.frombuffer(b"\x00".join(encoded) + b"\x00", dtype=np.uint8)
        bm = cls._LUT[b]
        nz = bm != 0
        prev_nz = np.empty(len(b), dtype=bool)
        prev_nz[0] = False
        prev_nz[1:] = nz[:-1]
        starts = np.nonzero(nz & ~prev_nz)[0]
        empty = np.zeros(0, dtype=np.int64)
        if len(starts) == 0:
            return empty, empty, empty, empty
        pos = cls._positions(len(b))
        with np.errstate(over="ignore"):
            s0 = np.add.reduceat(bm, starts)
            np.multiply(bm, pos, out=bm)  # bm no longer needed raw
            s1 = np.add.reduceat(bm, starts)
            s1 -= starts * s0
            s0 *= cls._P1
            s1 *= cls._P2
            whashes = s0
            whashes += s1
        word_text = np.searchsorted(offsets, starts, side="right") - 1
        n = cls._NGRAM
        if len(whashes) >= n:
            m = len(whashes) - n + 1
            with np.errstate(over="ignore"):
                keys = whashes[:m].copy()
                for j in range(1, n):
                    keys *= cls._HASH_P
                    keys += whashes[j : m + j]
            # a gram is valid only when all n words share one text
            gt = word_text[:m]
            valid = gt == word_text[n - 1 :]
            keys, gt = keys[valid], gt[valid]
        else:
            keys, gt = empty, empty
        return whashes, word_text, keys, gt

    def _classify_batch_host(self, texts: list[str]) -> list[list[LicenseFinding]]:
        """Whole-batch gating in single numpy passes: per-file Python work
        happens only for the texts that gate a candidate license."""
        if not hasattr(self, "_gate_keys"):
            self._build_scoring()
        out: list[list[LicenseFinding]] = [[] for _ in texts]
        whashes, word_text, keys, gt = self._batch_hashes(texts)
        if len(whashes) == 0:
            return out
        L = len(self.licenses)
        # global gate: per-(text, license) hit counts drive pruning (a
        # license whose count cannot reach the floor on either lane is
        # never scored)
        cand_pairs: set[tuple[int, int]] = set()
        if len(keys):
            bl = self._gate_bloom[keys & self._BLOOM_MASK]
            keys_b, gt_b = keys[bl], gt[bl]
            p = np.searchsorted(self._gate_keys, keys_b)
            p[p >= len(self._gate_keys)] = 0
            hm = self._gate_keys[p] == keys_b
            hit_idx, hit_text = p[hm], gt_b[hm]
            if len(hit_idx):
                gstarts = self._gate_off[hit_idx]
                glens = self._gate_off[hit_idx + 1] - gstarts
                nzl = glens > 0
                gstarts, glens, gtexts = gstarts[nzl], glens[nzl], hit_text[nzl]
                if len(gstarts):
                    owners = self._gate_lic[ragged_arange(gstarts, glens)]
                    otext = np.repeat(gtexts, glens)
                    combo, ccnt = np.unique(otext * L + owners, return_counts=True)
                    for c, cnt in zip(combo.tolist(), ccnt.tolist()):
                        ti, li = c // L, c % L
                        if cnt >= self._prune_min[li]:
                            cand_pairs.add((ti, li))
        norm_cache: dict[int, str] = {}

        def get_norm(ti: int) -> str:
            if ti not in norm_cache:
                norm_cache[ti] = normalize(texts[ti])
            return norm_cache[ti]

        # short-phrase anchors across the batch: bloom over all word hashes,
        # exact match of the survivors
        if self._short_gate and len(whashes):
            surv_idx = np.nonzero(self._anchor_bloom[whashes & self._BLOOM_MASK])[0]
            if len(surv_idx):
                sh = whashes[surv_idx]
                ap = np.searchsorted(self._anchor_sorted, sh)
                ap[ap >= len(self._anchor_sorted)] = 0
                exact = self._anchor_sorted[ap] == sh
                seen: set[tuple[int, int]] = set()
                for wi, ai in zip(surv_idx[exact].tolist(), ap[exact].tolist()):
                    ti = int(word_text[wi])
                    if (ti, ai) in seen:
                        continue
                    seen.add((ti, ai))
                    for gi in self._anchor_gates[
                        self._anchor_off[ai] : self._anchor_off[ai + 1]
                    ].tolist():
                        li, ph, _anchor = self._short_gate[gi]
                        if (ti, li) not in cand_pairs and ph in get_norm(ti):
                            cand_pairs.add((ti, li))
        by_text: dict[int, set[int]] = {}
        for ti, li in cand_pairs:
            by_text.setdefault(ti, set()).add(li)
        if by_text:
            gorder = np.argsort(gt, kind="stable")
            gsorted = gt[gorder]
            for ti, cands in by_text.items():
                lo = int(np.searchsorted(gsorted, ti))
                hi = int(np.searchsorted(gsorted, ti, side="right"))
                grams = np.unique(keys[gorder[lo:hi]])
                out[ti] = self._findings_candidates(cands, get_norm(ti), grams)
        return out

    def _classify_batch_device(self, texts: list[str]) -> list[list[LicenseFinding]]:
        """Raw-bytes device scoring: zero-padded uint8 text rows are all that
        crosses to the device. The shingle gate runs on each uploaded batch;
        flagged rows are gathered on the device and scored there. The host
        settles wide texts, cap overflows and threshold-grazing scores.

        Spans, under the JAX package's names: ``license.dispatch`` (the copy
        and the launches, which only enqueue), ``license.device_wait`` (the
        blocking fetches, where the card's time lands) and
        ``license.finalize``; with tracing on, each dispatch's rung in the
        profile (one card: the shard count is 1)."""
        from trivy_tpu_torch import obs
        from trivy_tpu_torch.ops import ngram_score as ng

        ctx = obs.current()
        prof = ctx.profile() if ctx.enabled else None
        if not hasattr(self, "_gate_keys"):
            self._build_scoring()
        scorer = self._device_scorer()
        table = scorer.table
        L = len(self.licenses)
        out: list[list[LicenseFinding]] = [[] for _ in texts]
        groups, wide = ng.pack_text_rows([t.encode("latin-1", "replace") for t in texts])
        anchor_min = max(1, int(table.gate.anchor_min))
        pending: deque = deque()  # shingle-gate dispatches in flight
        spending: deque = deque()  # scoring dispatches in flight
        acc: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        anchor_tis: set[int] = set()  # rows whose 4-byte anchor lane fired
        host_tis = set(wide)  # host-oracle rung: wide and overflow rows

        def fetch_score() -> None:
            (fw_d, pp_d, nu_d), tis, keep, n_rows, width = spending.popleft()
            t0 = time.perf_counter()
            with ctx.span("license.device_wait"):
                fw = fw_d.cpu().numpy().astype(np.float64)
                pp = pp_d.cpu().numpy().astype(np.float64)
                nu = nu_d.cpu().numpy()
            if prof is not None:
                prof.bucket_dispatch(f"license.score:{n_rows}x{width}x1", len(keep),
                                     time.perf_counter() - t0)
            ctx.count("license.score_rows", len(keep))
            cap = scorer.gram_cap(width)
            for i in keep.tolist():
                ti = int(tis[i])
                if int(nu[i]) > cap:
                    # more distinct grams than the scorer credits
                    host_tis.add(ti)
                else:
                    acc[ti] = (fw[i, :L], pp[i, :L])

        def dispatch_score(rows, tis, flag_idx) -> None:
            n = len(flag_idx)
            if 2 * n >= len(tis):
                # dense chunk: score the resident batch whole
                sel, sel_tis, keep = rows, tis, flag_idx
            else:
                b = 8
                while b < n:
                    b *= 2
                sel = scorer.take_rows(rows, flag_idx, b)
                sel_tis, keep = tis[flag_idx], np.arange(n)
            faults.check("device.dispatch", key="license")
            with ctx.span("license.dispatch"):
                spending.append((scorer.score_from_bytes(sel), sel_tis, keep,
                                 int(sel.shape[0]), rows.shape[1]))
            ctx.sample("license.queue_depth", len(pending) + len(spending))
            if len(spending) >= DEVICE_PIPELINE_DEPTH:
                fetch_score()

        def fetch_gate() -> None:
            (blk_d, ah_d, _nb), rows, tis = pending.popleft()
            t0 = time.perf_counter()
            with ctx.span("license.device_wait"):
                blk = blk_d.cpu().numpy()[: len(tis)]
                ah = ah_d.cpu().numpy()[: len(tis)]
            if prof is not None:
                prof.bucket_dispatch(f"license.gate:{blk.shape[0]}x{rows.shape[1]}x1", len(tis),
                                     time.perf_counter() - t0)
            anchor_tis.update(int(tis[i]) for i in np.nonzero(ah >= anchor_min)[0])
            flag_idx = np.nonzero(blk.max(axis=1) >= GATE_BLOCK_MIN)[0]
            if len(flag_idx):
                dispatch_score(rows, tis, flag_idx)

        # one pass per width bucket: copy a row chunk, gate it, chain flagged
        # rows straight into scoring
        for width in sorted(groups):
            rows_np, tis = groups[width]
            rung = scorer.rows_per_dispatch(width)
            for off in range(0, len(rows_np), rung):
                part = rows_np[off : off + rung]
                part_t = tis[off : off + rung]
                if len(part) < rung:
                    part = np.concatenate([part, np.zeros((rung - len(part), width), np.uint8)])
                faults.check("device.dispatch", key="license")
                ctx.count("license.bytes_uploaded", part.nbytes)
                with ctx.span("license.dispatch"):
                    rows = scorer.put_rows(part)
                    pending.append((scorer.gate_bytes(rows), rows, part_t))
                ctx.sample("license.queue_depth", len(pending) + len(spending))
                if len(pending) >= DEVICE_PIPELINE_DEPTH:
                    fetch_gate()
        while pending:
            fetch_gate()
        while spending:
            fetch_score()

        # wide texts and cap overflows take the exact host oracle
        overflow_set = set(host_tis)
        for ti in sorted(overflow_set):
            out[ti] = self.classify(texts[ti])

        # a license is worth finalizing when its potential confidence (full
        # lane, or phrase lane with every short phrase assumed present)
        # clears the threshold: the fold only overcounts, and EPS covers the
        # two-sided float32 rounding
        wtot, n_units, n_short = table.wtot, table.n_units, table.n_short
        by_text: dict[int, set[int]] = {}
        zero_row = np.zeros(L, dtype=np.float64)
        for ti, (fw_row, pp_row) in acc.items():
            with np.errstate(divide="ignore", invalid="ignore"):
                cf = np.where(wtot > 0, fw_row / np.maximum(wtot, 1e-300), 0.0)
                pot_p = np.where(n_units > 0, (pp_row + n_short) / np.maximum(n_units, 1), 0.0)
            pot = np.maximum(cf, pot_p)
            pot[~((fw_row > 0) | (pp_row > 0))] = 0.0
            lis = np.nonzero(pot >= self.confidence - EPS)[0]
            if len(lis):
                by_text[ti] = set(lis.tolist())

        norm_cache: dict[int, str] = {}

        def get_norm(ti: int) -> str:
            if ti not in norm_cache:
                norm_cache[ti] = normalize(texts[ti])
            return norm_cache[ti]

        # short-phrase anchor lane: the 4-byte shingle count (a sound floor)
        # flags rows that may hold a short phrase; the substring check
        # settles it, and an unscored row with a real hit takes the oracle
        if self._short_gate:
            for ti in sorted(anchor_tis - overflow_set):
                norm = get_norm(ti)
                matched = {li for li, ph, _anchor in self._short_gate if ph in norm}
                if not matched:
                    continue
                if ti in acc:
                    by_text.setdefault(ti, set()).update(matched)
                else:
                    overflow_set.add(ti)
                    out[ti] = self.classify(texts[ti])

        with ctx.span("license.finalize"):
            for ti, cands in by_text.items():
                if ti in overflow_set:
                    continue  # resolved by the host oracle
                norm = get_norm(ti)
                fw_row, pp_row = acc.get(ti, (zero_row, zero_row))
                grams = None  # host int64 grams, computed only if needed
                scored: list[tuple[float, float, str]] = []
                for li in cands:
                    lic = self.licenses[li]
                    shorts = self._phrase_short[lic]
                    got_short = sum(1 for p in shorts if p in norm) if shorts else 0
                    nu = int(n_units[li])
                    conf_p = (pp_row[li] + got_short) / nu if nu else 0.0
                    cf = fw_row[li] / wtot[li] if wtot[li] > 0 else 0.0
                    conf = max(cf, conf_p)
                    if abs(conf - self.confidence) <= EPS:
                        # float32 sums can land a hair on either side of the
                        # threshold: the exact host scorer settles the call
                        if grams is None:
                            grams = self._text_grams(norm)
                        conf, matched_w = self._score(li, norm, grams)
                        if conf >= self.confidence:
                            scored.append((conf, matched_w, lic))
                    elif conf >= self.confidence:
                        scored.append((float(conf), float(fw_row[li]), lic))
                out[ti] = self._rank_findings(scored)
        return out

    def corpus_table(self):
        """The raw-bytes corpus table (``ops.ngram_score.CorpusTable32``)
        built from this classifier's scoring tables."""
        from trivy_tpu_torch.licensing.corpus_texts import FULL_TEXTS
        from trivy_tpu_torch.ops import ngram_score as ng

        if not hasattr(self, "_gate_keys"):
            self._build_scoring()
        # main lane: raw and normalized full texts (the gate sees raw file
        # bytes) and every gram-bearing phrase; anchor lane: the short
        # fingerprints the substring lane must never miss
        gate_texts: list[str] = []
        for lic in sorted(FULL_TEXTS):
            gate_texts.append(FULL_TEXTS[lic])
            gate_texts.append(normalize(FULL_TEXTS[lic]))
        short_set = {ph for _li, ph, _a in self._short_gate}
        gate_texts.extend(ph for _li, ph in self.phrases if ph not in short_set)
        return ng.build_corpus_table32(
            self.licenses, self._full_keys, self._full_weights, self._phrase_keys,
            self._phrase_short, gate_texts, sorted(short_set), self._LUT, int(self._P1),
            int(self._P2), int(self._HASH_P), self._NGRAM,
        )

    def _device_scorer(self):
        """The process-cached raw-bytes scorer of this classifier's device,
        with the corpus table and the blooms resident there."""
        if self._scorer is None:
            from trivy_tpu_torch.ops.ngram_score import get_bytes_scorer

            self._scorer = get_bytes_scorer(self.corpus_table, self.device)
        return self._scorer

    # -- shared scoring -----------------------------------------------------

    _NGRAM = 5  # word n-gram width for similarity confidence
    _SEPS = " \"'(),.;:!?"

    # byte -> lowered int64 value, separators (all whitespace and control
    # bytes too) -> 0: one LUT gather folds lowercasing and tokenization
    _LUT = np.zeros(256, dtype=np.int64)
    for _b in range(256):
        _ch = chr(_b)
        if _ch in " \"'(),.;:!?" or _ch.isspace() or _b < 32:
            _LUT[_b] = 0
        else:
            _LUT[_b] = ord(_ch.lower()[0])
    del _b, _ch

    _P1 = np.int64(-8796714831421723037)  # odd 64-bit mix constants
    _P2 = np.int64(1099511628211)
    _HASH_P = np.int64(1099511628211)
    _ARANGE = np.arange(1 << 20, dtype=np.int64)  # reused position buffer
    _ARANGE_CAP = 1 << 23  # 64 MB int64: largest buffer worth keeping

    @classmethod
    def _positions(cls, n: int) -> np.ndarray:
        """Shared 0..n-1 int64 view, growing the cached buffer on demand up
        to ``_ARANGE_CAP``."""
        if n <= len(cls._ARANGE):
            return cls._ARANGE[:n]
        if n <= cls._ARANGE_CAP:
            size = len(cls._ARANGE)
            while size < n:
                size *= 2
            cls._ARANGE = np.arange(size, dtype=np.int64)
            return cls._ARANGE[:n]
        return np.arange(n, dtype=np.int64)

    @classmethod
    def _gram_words(cls, text: str) -> list[str]:
        """Word tokens (separator-split), for corpus-side bookkeeping."""
        import re

        return [w for w in re.split("[" + re.escape(cls._SEPS) + "]+", text) if w]

    @classmethod
    def _word_hashes(cls, text: str) -> np.ndarray:
        """Order-sensitive int64 hash per word: one LUT gather lowercases and
        zeroes separators, word spans are the zero-run boundaries, and the
        two hash moments are segment sums."""
        b = np.frombuffer(text.encode("latin-1", "replace"), dtype=np.uint8)
        n = len(b)
        if n == 0:
            return np.zeros(0, dtype=np.int64)
        bm = cls._LUT[b]
        nz = bm != 0
        prev_nz = np.empty(n, dtype=bool)
        prev_nz[0] = False
        prev_nz[1:] = nz[:-1]
        starts = np.nonzero(nz & ~prev_nz)[0]
        if len(starts) == 0:
            return np.zeros(0, dtype=np.int64)
        pos = cls._positions(n)
        s0 = np.add.reduceat(bm, starts)
        # position-weighted sum, rebased per word: sum(b*i) - start*sum(b)
        s1 = np.add.reduceat(bm * pos, starts) - starts * s0
        with np.errstate(over="ignore"):
            return s0 * cls._P1 + s1 * cls._P2

    @classmethod
    def _word_hash_one(cls, word: str) -> np.int64:
        h = cls._word_hashes(word)
        return h[0] if len(h) else np.int64(0)

    @classmethod
    def _keys_from_hashes(cls, wh: np.ndarray) -> np.ndarray:
        """int64 gram keys for every word 5-gram of the word-hash array."""
        n = cls._NGRAM
        if len(wh) < n:
            return np.zeros(0, dtype=np.int64)
        with np.errstate(over="ignore"):
            keys = wh[: len(wh) - n + 1].copy()
            for j in range(1, n):
                keys = keys * cls._HASH_P + wh[j : len(wh) - n + 1 + j]
        return keys

    def _gram_keys(self, text: str) -> np.ndarray:
        """Gram keys of a text."""
        return self._keys_from_hashes(self._word_hashes(text))

    # corpus-derived attributes shared across instances
    _STATIC_ATTRS = (
        "_full_keys", "_full_weights", "_family", "_phrase_keys",
        "_phrase_short", "_BLOOM_MASK", "_gate_keys", "_gate_off",
        "_gate_lic", "_gate_bloom", "_short_gate", "_short_anchors",
        "_anchor_sorted", "_anchor_off", "_anchor_gates", "_anchor_bloom",
    )

    @classmethod
    def _compute_static_tables(cls) -> dict:
        """Build the corpus-derived scoring tables once per process on a
        bare probe instance."""
        probe = cls.__new__(cls)
        probe.licenses = sorted(NORMALIZED_FINGERPRINTS)
        probe.phrases = [
            (li, ph) for li, lic in enumerate(probe.licenses)
            for ph in NORMALIZED_FINGERPRINTS[lic]
        ]
        probe._compute_scoring_impl()
        return {name: getattr(probe, name) for name in cls._STATIC_ATTRS}

    def _build_scoring(self) -> None:
        for name, value in _static_scoring_tables().items():
            setattr(self, name, value)
        # batch-gate pruning floor per license: the fewest gate hits with
        # which either lane can reach the confidence threshold (safe upper
        # bounds, so pruning never drops a passing candidate)
        self._prune_min: list[float] = []
        for lic in self.licenses:
            full_min = float("inf")
            keys = self._full_keys.get(lic)
            if keys is not None and len(keys):
                w = self._full_weights[lic]
                wmax = float(w.max())
                if wmax > 0:
                    full_min = self.confidence * float(w.sum()) / wmax
            n_short = len(self._phrase_short[lic])
            n_units = len(self._phrase_keys[lic]) + n_short
            phrase_min = (
                max(0.0, self.confidence * n_units - n_short) if n_units else float("inf")
            )
            self._prune_min.append(min(full_min, phrase_min) - 1e-9)

    def _compute_scoring_impl(self) -> None:
        """Two scoring lanes, built once:

        - **full-text lane**: distinctiveness-weighted gram tables from the
          normalized full texts; *families* (weighted gram-subset overlap
          >= 0.8, e.g. MIT/MIT-0/X11) report only their best explainer.
        - **phrase lane**: pooled grams of the fingerprint phrases (whole
          phrase for short ones), for notices, headers and licenses without
          a full text.
        """
        from trivy_tpu_torch.licensing.corpus_texts import FULL_TEXTS

        self._full_keys: dict[str, np.ndarray] = {}
        df = Counter()
        for lic in self.licenses:
            if lic not in FULL_TEXTS:
                continue
            keys = np.unique(self._gram_keys(FULL_TEXTS[lic]))
            self._full_keys[lic] = keys
            df.update(keys.tolist())
        self._full_weights = {
            lic: np.asarray([1.0 / df[k] for k in keys.tolist()], dtype=np.float64)
            for lic, keys in self._full_keys.items()
        }

        # family partition by weighted subset overlap
        lics = sorted(self._full_keys)
        parent = {lic: lic for lic in lics}

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for i, a in enumerate(lics):
            ka, wa = self._full_keys[a], self._full_weights[a]
            if wa.sum() <= 0:
                continue
            for b in lics[i + 1 :]:
                kb = self._full_keys[b]
                inter = np.isin(ka, kb, assume_unique=True)
                if wa[inter].sum() / wa.sum() >= 0.8 or (
                    self._full_weights[b].sum() > 0
                    and self._full_weights[b][np.isin(kb, ka, assume_unique=True)].sum()
                    / self._full_weights[b].sum()
                    >= 0.8
                ):
                    parent[find(a)] = find(b)
        self._family = {lic: find(lic) for lic in lics}

        # phrase lane: pooled gram keys + short whole phrases per license
        self._phrase_keys: dict[str, np.ndarray] = {}
        self._phrase_short: dict[str, list[str]] = {}
        for li, lic in enumerate(self.licenses):
            keys: list[np.ndarray] = []
            short: list[str] = []
            for pli, ph in self.phrases:
                if pli != li:
                    continue
                if len(self._gram_words(ph)) < self._NGRAM:
                    short.append(ph)
                else:
                    keys.append(self._gram_keys(ph))
            self._phrase_keys[lic] = (
                np.unique(np.concatenate(keys)) if keys else np.zeros(0, np.int64)
            )
            self._phrase_short[lic] = short

        # inverted gate index: sorted global gram keys -> owning licenses (CSR)
        owners: dict[int, set[int]] = {}
        for li, lic in enumerate(self.licenses):
            for arr in (self._full_keys.get(lic), self._phrase_keys[lic]):
                if arr is None:
                    continue
                for k in arr.tolist():
                    owners.setdefault(k, set()).add(li)
        self._BLOOM_MASK = np.int64((1 << 22) - 1)
        gate_keys = np.asarray(sorted(owners), dtype=np.int64)
        off = [0]
        lic_flat: list[int] = []
        for k in gate_keys.tolist():
            lic_flat.extend(sorted(owners[k]))
            off.append(len(lic_flat))
        self._gate_keys = gate_keys
        self._gate_off = np.asarray(off, dtype=np.int64)
        self._gate_lic = np.asarray(lic_flat, dtype=np.int64)
        # 4M-slot membership mask: one gather rejects most text grams
        # before the binary search
        self._gate_bloom = np.zeros(1 << 22, dtype=bool)
        self._gate_bloom[(gate_keys & self._BLOOM_MASK).astype(np.int64)] = True
        # short phrases gate by their longest word's hash
        self._short_gate: list[tuple[int, str, int]] = []
        for li, lic in enumerate(self.licenses):
            for ph in self._phrase_short[lic]:
                words = self._gram_words(ph)
                if not words:
                    continue
                anchor = max(words, key=len)
                self._short_gate.append((li, ph, int(self._word_hash_one(anchor))))
        self._short_anchors = np.asarray([a for _li, _ph, a in self._short_gate], dtype=np.int64)
        # unique anchors + CSR to gate entries, plus a bloom mask
        a_owner: dict[int, list[int]] = {}
        for gi, (_li, _ph, a) in enumerate(self._short_gate):
            a_owner.setdefault(a, []).append(gi)
        self._anchor_sorted = np.asarray(sorted(a_owner), dtype=np.int64)
        aoff = [0]
        aflat: list[int] = []
        for a in self._anchor_sorted.tolist():
            aflat.extend(a_owner[a])
            aoff.append(len(aflat))
        self._anchor_off = np.asarray(aoff, dtype=np.int64)
        self._anchor_gates = np.asarray(aflat, dtype=np.int64)
        self._anchor_bloom = np.zeros(1 << 22, dtype=bool)
        if len(self._anchor_sorted):
            self._anchor_bloom[self._anchor_sorted & self._BLOOM_MASK] = True

    def _text_grams(self, norm: str) -> np.ndarray:
        if not hasattr(self, "_gate_keys"):
            self._build_scoring()
        return np.unique(self._gram_keys(norm))

    def _score(self, li: int, norm: str, grams: np.ndarray) -> tuple[float, float]:
        """-> (confidence, matched_weight): the better of the full-text and
        phrase lanes, and the full lane's matched weight (which ranks family
        members)."""
        lic = self.licenses[li]
        if not hasattr(self, "_gate_keys"):
            self._build_scoring()
        full_conf = 0.0
        matched_w = 0.0
        keys = self._full_keys.get(lic)
        if keys is not None and len(keys) and len(grams):
            w = self._full_weights[lic]
            p = np.searchsorted(grams, keys)
            p[p >= len(grams)] = 0
            matched = grams[p] == keys
            total = w.sum()
            if total > 0:
                matched_w = float(w[matched].sum())
                full_conf = matched_w / float(total)
        pk = self._phrase_keys[lic]
        short = self._phrase_short[lic]
        n_units = len(pk) + len(short)
        phrase_conf = 0.0
        if n_units:
            got = 0
            if len(pk) and len(grams):
                p = np.searchsorted(grams, pk)
                p[p >= len(grams)] = 0
                got = int((grams[p] == pk).sum())
            got += sum(1 for ph in short if ph in norm)
            phrase_conf = got / n_units
        return max(full_conf, phrase_conf), matched_w

    def _findings_candidates(
        self, candidates: set[int], norm: str, grams: np.ndarray
    ) -> list[LicenseFinding]:
        if not candidates:
            return []
        found = []
        for li in candidates:
            conf, matched_w = self._score(li, norm, grams)
            if conf >= self.confidence:
                found.append((conf, matched_w, self.licenses[li]))
        return self._rank_findings(found)

    def _rank_findings(self, found: list[tuple[float, float, str]]) -> list[LicenseFinding]:
        """Rank scored (confidence, matched_weight, license) candidates into
        findings; shared by the host and device paths."""
        if not found:
            return []
        # a fully-matched license suppresses phrase-level siblings it subsumes
        full = {name for conf, _w, name in found if conf >= 0.999}
        suppressed = {s for name in full for s in SUBSUMES.get(name, [])}
        found = [f for f in found if f[2] not in suppressed]
        if not found:
            return []
        # confidence first, then which license's full text explains more of
        # the input (MIT beats MIT-0/X11 on an MIT text)
        found.sort(key=lambda x: (-round(x[0], 3), -x[1], x[2]))
        best_conf = round(found[0][0], 3)
        out: list[LicenseFinding] = []
        seen_families: set[str] = set()
        for conf, _w, name in found:
            if round(conf, 3) < best_conf and out:
                break
            fam = self._family.get(name, name)
            if fam in seen_families:
                continue  # a better-matching family member already reported
            seen_families.add(fam)
            out.append(LicenseFinding(name=name, confidence=round(conf, 3),
                                      link=_SPDX_URL.format(name)))
        return out


@functools.cache
def classifier_tables() -> LicenseClassifier:
    """A CPU classifier with its scoring tables built (the process-cached
    corpus tables the fused gate and the host patch read)."""
    probe = LicenseClassifier(device="cpu")
    probe._build_scoring()
    return probe

