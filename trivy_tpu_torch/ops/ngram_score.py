"""Raw-bytes license scoring: the corpus table, the shingle blooms, the
width ladder of text rows, and the device scorer that keeps them resident.

The port of the raw-bytes half of ``trivy_tpu/ops/ngram_score.py``. The
classifier's two gram lanes (full-text distinctiveness weights and pooled
fingerprint-phrase grams, see ``licensing/classify.py``) compile into one
table: a sorted uint32 key column (the low 32 bits of the host's int64 gram
keys, clamped to 0xFFFFFFFE) and a dense ``[Ku, 2 * Ls]`` float32 credit
matrix holding each key's full-lane weight and phrase-lane credit for every
license. Texts travel to the card as zero-padded uint8 rows on a width
ladder; the shingle gate (``ops/bytes_gate.py``) and the scorer
(``ops/bytes_score.py``) run on those resident rows.

Soundness of the fold: corpus and text keys fold from the same int64 hashes,
so every true match survives it, and credit tables count fold multiplicity:
collisions can only add matched weight or phrase credit. The device scores
are therefore a superset of the host oracle's, and the classifier settles
everything near its threshold on the host.

The port keeps one corpus shard: the JAX package's model-axis sharding of
the table is multi-device work, not yet ported.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from trivy_tpu_torch.device import resolve
from trivy_tpu_torch.obs import recorder as flight
from trivy_tpu_torch.ops.bytes_gate import SHINGLE_BITS, SHINGLE_MIX, SHINGLE_P2
from trivy_tpu_torch.ops.bytes_gate_cuda import CudaBytesGate
from trivy_tpu_torch.ops.bytes_score_cuda import CudaBytesScorer

# padding sentinel of the uint32 key domain: real keys clamp to 0xFFFFFFFE
# on both sides (corpus build and scorer), so the all-ones value is free
SENT32 = np.uint32(0xFFFFFFFF)
_MASK64 = np.uint64(0xFFFFFFFF)
_MIX = np.uint32(SHINGLE_MIX)
_P2 = np.uint32(SHINGLE_P2)

# width ladder of packed text rows: 49152 covers the longest common full
# license text (GPL-3.0, about 35 KB); longer texts take the host oracle
BYTES_WIDTHS = (1024, 2048, 4096, 8192, 16384, 32768, 49152)
# per-dispatch element budget: rows per dispatch = BYTES_ROW_ELEMS // width
BYTES_ROW_ELEMS = 1 << 20


def fold_u32(keys64: np.ndarray) -> np.ndarray:
    """Raw-bytes key fold: the low 32 bits of the int64 hash domain, clamped
    to 0xFFFFFFFE so that SENT32 stays reserved for padding."""
    k = np.asarray(keys64, dtype=np.int64).astype(np.uint64) & _MASK64
    return np.minimum(k.astype(np.uint32), np.uint32(0xFFFFFFFE))


def lut_low32(lut: np.ndarray) -> np.ndarray:
    """The classifier's byte LUT folded to uint32 (separators stay 0)."""
    return (np.asarray(lut, dtype=np.int64).astype(np.uint64) & _MASK64).astype(np.uint32)


def _pack_words(sv: np.ndarray, n: int, width: int) -> np.ndarray:
    """Little-endian byte packing of the ``width``-byte windows at positions
    0..n-1 of a space-substituted LUT image, hashed with the shingle mix
    constants (the bloom build's half of ``bytes_gate_plain``)."""
    with np.errstate(over="ignore"):
        wlo = (sv[:n] + (sv[1 : n + 1] << np.uint32(8)) + (sv[2 : n + 2] << np.uint32(16))
               + (sv[3 : n + 3] << np.uint32(24)))
        if width == 4:
            return (wlo * _MIX) >> np.uint32(32 - SHINGLE_BITS)
        whi = (sv[4 : n + 4] + (sv[5 : n + 5] << np.uint32(8)) + (sv[6 : n + 6] << np.uint32(16))
               + (sv[7 : n + 7] << np.uint32(24)))
        return (wlo * _MIX + whi * _P2) >> np.uint32(32 - SHINGLE_BITS)


def shingle_hashes(data: np.ndarray, lut32: np.ndarray, width: int) -> tuple[np.ndarray, np.ndarray]:
    """``(hashes [n] uint32, valid [n] bool)``: one window per byte position
    of a uint8 buffer (trailing windows pad with spaces). Separators shingle
    as a space; a window is valid when it starts on a word byte."""
    v = lut32[data.astype(np.int64)]
    sv = np.concatenate([np.where(v == 0, np.uint32(32), v), np.full(width, 32, dtype=np.uint32)])
    return _pack_words(sv, len(v), width), v != 0


def _robust_windows(text: str, lut: np.ndarray, width: int) -> list[bytes]:
    """Shingle windows of ``text`` that survive arbitrary whitespace-run
    edits: fully inside one word, or word bytes followed by exactly one
    trailing separator byte."""
    lut32 = lut_low32(lut)
    words: list[bytes] = []
    cur = bytearray()
    for byte in text.encode("latin-1", "replace"):
        if lut32[byte] == 0:
            if cur:
                words.append(bytes(cur))
                cur = bytearray()
        else:
            cur.append(byte)
    if cur:
        words.append(bytes(cur))
    out: list[bytes] = []
    for w in words:
        for i in range(max(0, len(w) - width + 1)):
            out.append(w[i : i + width])
        if len(w) >= width - 1:
            out.append(w[len(w) - (width - 1) :] + b" ")
    return out


@dataclass
class ShingleGate:
    """The two bloom masks and the anchor lane's soundness floor."""

    bloom8: np.ndarray  # [2^SHINGLE_BITS] uint8, main-lane 8-byte windows
    bloom4: np.ndarray  # [2^SHINGLE_BITS] uint8, anchor-lane 4-byte windows
    # the fewest robust-window hits any short phrase occurrence produces,
    # however the file spaces or wraps it
    anchor_min: int


def build_shingle_gate(corpus_texts: list[str], anchor_texts: list[str],
                       lut: np.ndarray) -> ShingleGate:
    """The two-lane shingle gate from the corpus texts (main lane, recall
    tuned) and the short fingerprint phrases (anchor lane, sound for the
    host's substring check, with its threshold computed here)."""
    lut32 = lut_low32(lut)
    bloom8 = np.zeros(1 << SHINGLE_BITS, dtype=np.uint8)
    bloom4 = np.zeros(1 << SHINGLE_BITS, dtype=np.uint8)
    for texts, bloom, width in ((corpus_texts, bloom8, 8), (anchor_texts, bloom4, 4)):
        for t in texts:
            b = np.frombuffer((t + " ").encode("latin-1", "replace"), dtype=np.uint8)
            h, valid = shingle_hashes(b, lut32, width)
            bloom[h[valid]] = 1
    anchor_min = 1
    if anchor_texts:
        counts = []
        for t in anchor_texts:
            n = 0
            for rw in _robust_windows(t, lut, 4):
                h, valid = shingle_hashes(np.frombuffer(rw, dtype=np.uint8), lut32, 4)
                if valid[0] and bloom4[h[0]]:
                    n += 1
            counts.append(n)
        anchor_min = max(1, min(counts))
    return ShingleGate(bloom8=bloom8, bloom4=bloom4, anchor_min=anchor_min)


@dataclass
class CorpusTable32:
    """The raw-bytes corpus table: keys in the uint32 low-32 hash domain, the
    credit matrix, the shingle gate, and the classifier constants the
    kernels need."""

    keys: np.ndarray  # [Ku] uint32, sorted
    credit: np.ndarray  # [Ku, 2*Ls] f32: [:Ls] full weight, [Ls:] phrase
    gate: ShingleGate
    lut: np.ndarray  # [256] int64 classifier byte LUT
    p1: int  # word-hash and gram-fold constants (int64 domain)
    p2: int
    hash_p: int
    ngram: int
    lic_per_shard: int  # Ls (one shard: the padded license count)
    n_licenses: int
    wtot: np.ndarray = field(default=None)  # [L] full-lane weight totals
    n_units: np.ndarray = field(default=None)  # [L] phrase-lane unit counts
    n_short: np.ndarray = field(default=None)  # [L] short phrases per license


def build_corpus_table32(
    licenses: list[str],
    full_keys: dict[str, np.ndarray],
    full_weights: dict[str, np.ndarray],
    phrase_keys: dict[str, np.ndarray],
    phrase_short: dict[str, list[str]],
    corpus_texts: list[str],
    anchor_texts: list[str],
    lut: np.ndarray,
    p1: int,
    p2: int,
    hash_p: int,
    ngram: int = 5,
) -> CorpusTable32:
    """Compile the classifier's scoring tables for the raw-bytes scorer:
    per folded key, the summed full-lane weight and the count of distinct
    phrase grams of every license (the JAX package's ``model_shards=1``
    build, array for array)."""
    L = len(licenses)
    pairs: dict[int, dict[int, list[float]]] = {}
    for li, lic in enumerate(licenses):
        fk = full_keys.get(lic)
        if fk is not None and len(fk):
            for k, kw in zip(fold_u32(fk).tolist(), full_weights[lic].tolist()):
                pairs.setdefault(k, {}).setdefault(li, [0.0, 0.0])[0] += kw
        pk = phrase_keys.get(lic)
        if pk is not None and len(pk):
            for k in fold_u32(np.unique(pk)).tolist():
                pairs.setdefault(k, {}).setdefault(li, [0.0, 0.0])[1] += 1.0
    Ku = max(1, len(pairs))
    keys = np.full(Ku, SENT32, dtype=np.uint32)
    credit = np.zeros((Ku, 2 * L), dtype=np.float32)
    for ki, k in enumerate(sorted(pairs)):
        keys[ki] = k
        for li, (w, p) in pairs[k].items():
            credit[ki, li] = w
            credit[ki, L + li] = p
    wtot = np.zeros(L, dtype=np.float64)
    n_units = np.zeros(L, dtype=np.int64)
    n_short = np.zeros(L, dtype=np.int64)
    for li, lic in enumerate(licenses):
        w = full_weights.get(lic)
        wtot[li] = float(w.sum()) if w is not None and len(w) else 0.0
        pk = phrase_keys.get(lic)
        shorts = phrase_short.get(lic, [])
        n_short[li] = len(shorts)
        n_units[li] = (len(pk) if pk is not None else 0) + len(shorts)
    return CorpusTable32(
        keys=keys, credit=credit, gate=build_shingle_gate(corpus_texts, anchor_texts, lut),
        lut=np.asarray(lut, dtype=np.int64), p1=int(p1), p2=int(p2), hash_p=int(hash_p),
        ngram=int(ngram), lic_per_shard=L, n_licenses=L, wtot=wtot, n_units=n_units,
        n_short=n_short,
    )


def load_corpus_table32(keys, credit, bloom8, bloom4, anchor_min, lut, p1, p2, hash_p, ngram,
                        n_licenses, wtot, n_units, n_short) -> CorpusTable32:
    """A corpus table carried across from arrays built elsewhere (the JAX
    package's ``CorpusTable32`` of one shard, field for field, as numpy
    arrays): ``keys`` ``[1, Ku]`` or ``[Ku]`` uint32, ``credit`` ``[1, Ku,
    2 * Ls]`` or ``[Ku, 2 * Ls]`` float32, the two ``[2^22]`` uint8 blooms,
    the LUT, the constants and the per-license finalization arrays."""
    keys = np.asarray(keys, dtype=np.uint32)
    credit = np.asarray(credit, dtype=np.float32)
    if keys.ndim == 2:
        if keys.shape[0] != 1 or credit.shape[0] != 1:
            raise ValueError(f"one corpus shard expected, got {keys.shape[0]}")
        keys, credit = keys[0], credit[0]
    if credit.shape[0] != keys.shape[0] or credit.shape[1] % 2:
        raise ValueError(f"credit {credit.shape} does not fit keys {keys.shape}")
    return CorpusTable32(
        keys=keys.copy(), credit=credit.copy(),
        gate=ShingleGate(bloom8=np.asarray(bloom8, dtype=np.uint8).copy(),
                         bloom4=np.asarray(bloom4, dtype=np.uint8).copy(),
                         anchor_min=int(anchor_min)),
        lut=np.asarray(lut, dtype=np.int64).copy(), p1=int(p1), p2=int(p2),
        hash_p=int(hash_p), ngram=int(ngram), lic_per_shard=credit.shape[1] // 2,
        n_licenses=int(n_licenses), wtot=np.asarray(wtot, dtype=np.float64).copy(),
        n_units=np.asarray(n_units, dtype=np.int64).copy(),
        n_short=np.asarray(n_short, dtype=np.int64).copy(),
    )


def pack_text_rows(encoded: list[bytes], max_width: int = 0, widths=BYTES_WIDTHS):
    """Pack latin-1 text buffers into zero-padded uint8 row matrices,
    bucketed by width -> ``(groups, wide)``: ``groups`` maps width ->
    ``(rows [n, W] uint8, text_indices [n])``; ``wide`` lists texts at or
    above the width cap (the host-oracle rung). A text always packs strictly
    below its bucket width, so at least one trailing zero separator ends its
    last word as the host tokenizer's end of text does."""
    cap = int(max_width) or widths[-1]
    ladder = [w for w in widths if w <= cap] or [widths[0]]
    buckets: dict[int, list[int]] = {}
    wide: list[int] = []
    for ti, e in enumerate(encoded):
        n = len(e)
        if n == 0:
            continue
        if n >= ladder[-1]:
            wide.append(ti)
            continue
        buckets.setdefault(next(w for w in ladder if n < w), []).append(ti)
    groups: dict[int, tuple[np.ndarray, np.ndarray]] = {}
    for w in sorted(buckets):
        tis = buckets[w]
        rows = np.zeros((len(tis), w), dtype=np.uint8)
        for ri, ti in enumerate(tis):
            rows[ri, : len(encoded[ti])] = np.frombuffer(encoded[ti], dtype=np.uint8)
        groups[w] = (rows, np.asarray(tis, dtype=np.int64))
    return groups, wide


class DeviceBytesScorer:
    """The raw-bytes scorer with the corpus table and the blooms resident on
    ``device``: per scan only zero-padded uint8 text rows cross to it. Both
    kernels launch on CUDA rows; CPU rows run their plain versions."""

    def __init__(self, table: CorpusTable32, device="cuda"):
        self.table = table
        self.device = resolve(device)
        self._gate = CudaBytesGate(table.lut, table.gate.bloom8, table.gate.bloom4, self.device)
        self._score = CudaBytesScorer(table.lut, table.keys, table.credit, table.p1, table.p2,
                                      table.hash_p, table.ngram, self.device)
        # HBM ledger: the corpus table and the blooms stay resident for the
        # process
        flight.note_resident("corpus", sum(int(a.nbytes) for a in (
            table.keys, table.credit, table.gate.bloom8, table.gate.bloom4)))
        self.dispatch_count = 0

    @staticmethod
    def rows_per_dispatch(width: int) -> int:
        """Rows per dispatch at one width: a fixed function of the width."""
        return max(8, BYTES_ROW_ELEMS // int(width))

    def put_rows(self, rows: np.ndarray) -> torch.Tensor:
        """Copy one padded row batch to the device."""
        t = torch.from_numpy(rows)
        return t.to(self.device, non_blocking=True) if self.device.type == "cuda" else t

    def gate_bytes(self, rows: torch.Tensor):
        """The shingle gate on resident rows -> (block_hits, anchor_hits,
        word_bytes)."""
        self.dispatch_count += 1
        return self._gate(rows)

    def score_from_bytes(self, rows: torch.Tensor):
        """The scorer on resident rows -> (full_w [B, Ls], phrase [B, Ls],
        n_uniq [B])."""
        self.dispatch_count += 1
        return self._score(rows, self.gram_cap(rows.shape[1]))

    @staticmethod
    def gram_cap(width: int) -> int:
        """Distinct-gram capacity of the scorer at one width (rows whose
        n_uniq exceeds it take the host oracle)."""
        return max(256, width // 4)

    @staticmethod
    def take_rows(rows: torch.Tensor, idx: np.ndarray, out_rows: int) -> torch.Tensor:
        """Flagged rows gathered from a resident batch (no second upload),
        padded to ``out_rows`` with copies of row 0."""
        full = np.zeros(out_rows, dtype=np.int64)
        full[: len(idx)] = idx
        return torch.index_select(rows, 0, torch.from_numpy(full).to(rows.device))


_SCORER_CACHE: dict = {}
_SCORER_LOCK = threading.Lock()


def get_bytes_scorer(build_table, device="cuda") -> DeviceBytesScorer:
    """Process-wide scorer cache, one per device: the corpus table and the
    blooms are copied to a device once and stay there across scans and
    classifier instances. ``build_table`` is called only on a miss."""
    dev = resolve(device)
    with _SCORER_LOCK:
        scorer = _SCORER_CACHE.get(dev)
        if scorer is None:
            scorer = DeviceBytesScorer(build_table(), dev)
            _SCORER_CACHE[dev] = scorer
    return scorer
