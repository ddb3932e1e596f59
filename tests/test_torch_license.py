"""The port's license classifier against the JAX package's: the corpus and
name tables, the raw-bytes corpus table, the text-row ladder, the shingle
gate and the scorer (plain versions against the JAX functions on the same
rows), numpy models of the two CUDA kernels' formulations, and the
classifier on the CPU device pipeline against the JAX host oracle.

Tolerances: booleans, counts and the phrase lane (sums of small integers in
float32) must be equal; ``full_w``, a float32 sum of ``1/df`` weights whose
low bits depend on the order of summation, agrees to rtol 1e-5 with the JAX
function (which sums in chunks of 256), an order of magnitude inside the
classifier's 1e-4 band.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tests.test_torch_match import few_torch_threads  # noqa: F401
from trivy_tpu.licensing import corpus as jax_corpus
from trivy_tpu.licensing import corpus_texts as jax_texts
from trivy_tpu.licensing import expression as jax_expression
from trivy_tpu.licensing import normalize as jax_normalize
from trivy_tpu.licensing.classify import LicenseClassifier as JaxClassifier
from trivy_tpu.licensing.scanner import LicenseCategorizer as JaxCategorizer
from trivy_tpu.ops import ngram_score as jng
from trivy_tpu_torch.licensing import corpus, corpus_texts, expression, normalize
from trivy_tpu_torch.licensing.classify import LicenseClassifier
from trivy_tpu_torch.licensing.corpus_texts import FULL_TEXTS
from trivy_tpu_torch.licensing.scanner import LicenseCategorizer
from trivy_tpu_torch.ops import bytes_gate_cuda
from trivy_tpu_torch.ops import ngram_score as ng
from trivy_tpu_torch.ops.bytes_gate import bytes_gate_plain
from trivy_tpu_torch.ops.bytes_score import SENT32, bytes_score_plain, effective_cap
from trivy_tpu_torch.ops.gram_gate import M32

# the text whose repeated grams overflow the reference's duplicate-counting
# cap: 3,033 bytes (the 4096 rung, cap 1,024), 1,164 words, 166 distinct grams
FAULT_TEXT = " a b" * 500 + "\n" + FULL_TEXTS["MIT"]


@pytest.fixture(scope="module")
def port_clf():
    c = LicenseClassifier(device="cpu")
    c._build_scoring()
    return c


@pytest.fixture(scope="module")
def jax_clf():
    c = JaxClassifier(backend="cpu")
    c._build_scoring()
    return c


@pytest.fixture(scope="module")
def jax_table(jax_clf):
    """The JAX package's raw-bytes corpus table, built as its classifier
    builds it, with one shard."""
    c = jax_clf
    gate_texts = []
    for lic in sorted(jax_texts.FULL_TEXTS):
        gate_texts += [jax_texts.FULL_TEXTS[lic], jax_corpus.normalize(jax_texts.FULL_TEXTS[lic])]
    short = {ph for _li, ph, _a in c._short_gate}
    gate_texts += [ph for _li, ph in c.phrases if ph not in short]
    return jng.build_corpus_table32(
        c.licenses, c._full_keys, c._full_weights, c._phrase_keys, c._phrase_short,
        gate_texts, sorted(short), c._LUT, int(c._P1), int(c._P2), int(c._HASH_P), c._NGRAM)


@pytest.fixture(scope="module")
def table(jax_table):
    """The same table carried into the port (``load_corpus_table32``)."""
    t = jax_table
    return ng.load_corpus_table32(
        t.keys, t.credit, t.gate.bloom8, t.gate.bloom4, t.gate.anchor_min, t.lut, t.p1, t.p2,
        t.hash_p, t.ngram, t.n_licenses, t.wtot, t.n_units, t.n_short)


def t64(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def text_rows(texts: list[str], width: int) -> np.ndarray:
    out = np.zeros((len(texts), width), np.uint8)
    for i, t in enumerate(texts):
        b = t.encode("latin-1", "replace")[: width - 1]
        out[i, : len(b)] = np.frombuffer(b, np.uint8)
    return out


def mixed_texts(seed: int, n: int, width: int) -> list[str]:
    """License texts (raw, re-wrapped, CRLF, cut at random points), source
    text, non-ASCII and words running to the row's last byte."""
    rng = np.random.default_rng(seed)
    keys = sorted(FULL_TEXTS)
    out = []
    for i in range(n):
        t = FULL_TEXTS[keys[i % len(keys)]]
        t = [t, t.replace(". ", ".\r\n"), t.upper().replace(" ", "\n  "),
             "def f(x):\n    return x + 1  # café\n" * 40, "é" * 7 + t][i % 5]
        start = int(rng.integers(0, max(1, len(t) - width)))
        out.append(t[start : start + width])
    out[-1] = ("w" * (width + 8))  # one word over the whole row
    return out


# -- data copies ---------------------------------------------------------------


def test_corpus_and_name_tables_equal_jax():
    assert corpus_texts.FULL_TEXTS == jax_texts.FULL_TEXTS
    assert corpus.NORMALIZED_FINGERPRINTS == jax_corpus.NORMALIZED_FINGERPRINTS
    assert corpus.SUBSUMES == jax_corpus.SUBSUMES
    assert corpus.MIN_CONFIDENCE == jax_corpus.MIN_CONFIDENCE
    assert normalize._RAW_ALIASES == jax_normalize._RAW_ALIASES
    assert normalize._ONLY_OR_LATER == jax_normalize._ONLY_OR_LATER
    text = FULL_TEXTS["MIT"].upper().replace(" ", " \t\n ")
    assert corpus.normalize(text) == jax_corpus.normalize(text)


NAMES = [
    "MIT", "Apache License, Version 2.0", "GPLv2+", "GPL-2.0-or-later", "LGPL-2.1-only",
    "BSD", "bsd 3-clause", "(MIT OR GPL-2.0+) AND Apache 2.0", "Apache-2.0 WITH LLVM-exception",
    "AGPL-3.0", "Nonsense License 9", "", "MPL 2.0 OR EPL-2.0", "GPL-3.0+ AND (BSD OR ISC)",
]


@pytest.mark.parametrize("name", NAMES)
def test_normalize_expression_and_categories_equal_jax(name):
    assert normalize.normalize(name) == jax_normalize.normalize(name)
    assert expression.normalize_expression(name) == jax_expression.normalize_expression(name)
    assert expression.leaf_licenses(name) == jax_expression.leaf_licenses(name)
    user = {"forbidden": ["MIT"], "notice": ["GPL-2.0"]}
    for cat, ref in ((LicenseCategorizer(), JaxCategorizer()),
                     (LicenseCategorizer(user), JaxCategorizer(user))):
        got, want = cat.detect(name, file_path="x"), ref.detect(name, file_path="x")
        assert got.to_dict() == want.to_dict()


# -- corpus table and row ladder -------------------------------------------------


def test_corpus_table32_equals_jax(port_clf, jax_table):
    """The port's own build, array for array, against the JAX package's."""
    mine, theirs = port_clf.corpus_table(), jax_table
    assert theirs.n_shards == 1
    np.testing.assert_array_equal(mine.keys, theirs.keys[0])
    np.testing.assert_array_equal(mine.credit, theirs.credit[0])
    np.testing.assert_array_equal(mine.gate.bloom8, theirs.gate.bloom8)
    np.testing.assert_array_equal(mine.gate.bloom4, theirs.gate.bloom4)
    assert mine.gate.anchor_min == theirs.gate.anchor_min >= 1
    np.testing.assert_array_equal(mine.lut, theirs.lut)
    for f in ("wtot", "n_units", "n_short"):
        np.testing.assert_array_equal(getattr(mine, f), getattr(theirs, f))
    assert (mine.p1, mine.p2, mine.hash_p, mine.ngram, mine.n_licenses) == (
        theirs.p1, theirs.p2, theirs.hash_p, theirs.ngram, theirs.n_licenses)
    assert mine.lic_per_shard == theirs.lic_per_shard == len(port_clf.licenses)
    assert mine.keys.shape[0] > 20000 and mine.credit.shape[1] == 2 * mine.lic_per_shard


def test_load_corpus_table32_checks_shapes(jax_table):
    t = jax_table
    with pytest.raises(ValueError):
        ng.load_corpus_table32(np.zeros((2, 4), np.uint32), np.zeros((2, 4, 2), np.float32),
                               t.gate.bloom8, t.gate.bloom4, 1, t.lut, 1, 1, 1, 5, 1,
                               t.wtot, t.n_units, t.n_short)


def test_pack_text_rows_equal_jax():
    encoded = [t.encode() for t in mixed_texts(1, 30, 3000)]
    encoded += [b"", b"x" * 1023, b"y" * 1024, b"z" * 49151, b"q" * 49152, b"r" * 70000]
    for cap in (0, 4096):
        groups, wide = ng.pack_text_rows(encoded, max_width=cap)
        jgroups, jwide = jng.pack_text_rows(encoded, max_width=cap)
        assert wide == jwide and sorted(groups) == sorted(jgroups)
        for w in groups:
            np.testing.assert_array_equal(groups[w][0], jgroups[w][0])
            np.testing.assert_array_equal(groups[w][1], jgroups[w][1])
    assert ng.BYTES_WIDTHS == jng.BYTES_WIDTHS and ng.BYTES_ROW_ELEMS == jng.BYTES_ROW_ELEMS


# -- the shingle gate ---------------------------------------------------------------


@pytest.mark.parametrize("width", [1024, 4096, 49152])
def test_bytes_gate_plain_equals_jax(table, width):
    rows = text_rows(mixed_texts(width, 8, width), width)
    rows[2, -3:] = 200  # non-ASCII at the row end, read past it as spaces
    got = bytes_gate_plain(torch.from_numpy(rows), t64(ng.lut_low32(table.lut)),
                           torch.from_numpy(table.gate.bloom8), torch.from_numpy(table.gate.bloom4))
    want = jng.build_bytes_gate_fn(width, table.lut)(rows, table.gate.bloom8, table.gate.bloom4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].max() > 16 and got[1].max() > 0  # license rows light both lanes


# csrc/bytes_gate.cu's tile: a 512-byte density block per warp, 16 positions a lane
GATE_SRC = (Path(bytes_gate_cuda.__file__).parent / "csrc" / "bytes_gate.cu").read_text()
WARPS = int(re.search(r"constexpr int kThreads = (\d+);", GATE_SRC).group(1)) // 32
TILE = WARPS * 512
HALO_STAGE = 16  # the halo piece staged after a tile


def screen_bits(screen: np.ndarray, h: np.ndarray, bits: int) -> np.ndarray:
    """Bit ``h >> (22 - bits)`` of a uint32 bitset screen."""
    b = h >> np.uint32(22 - bits)
    return ((screen[b >> np.uint32(5)] >> (b & np.uint32(31))) & np.uint32(1)).astype(bool)


def bytes_gate_model(rows: np.ndarray, lut32: np.ndarray, bloom8: np.ndarray,
                     bloom4: np.ndarray, s4_bits: int = 15, s8_bits: int = 18,
                     unaligned: bool = False):
    """csrc/bytes_gate.cu's formulation: a block per tile of WARPS density
    blocks of the flattened rows, each staged with a 16-byte halo piece
    (bytes past the input are not staged: they hold garbage); warp w of a tile counts
    density block ``WARPS t + w`` over its 512 positions, its 7-byte halo read from the tile
    or as spaces at a row end; each window reads the screen first and the
    bitset only when the screen passes (asserting the screen never rejects
    a set bit); a row inside one tile is written by its block, the pieces
    of a row across tiles go to a scratch at their first block, and the
    last block sums them in order. Outputs start at -1, so a count never
    written shows."""
    B, C = rows.shape
    nblk = C // 512
    flat = rows.reshape(-1)
    total = B * C
    tiles = -(-total // TILE)
    b4, b8 = bytes_gate_cuda.bitset(bloom4), bytes_gate_cuda.bitset(bloom8)
    s4 = bytes_gate_cuda.fold(bloom4, s4_bits)
    s8 = bytes_gate_cuda.fold(bloom8, s8_bits)
    blk = np.full(B * nblk, -1, np.int64)
    ah = np.full(B, -1, np.int64)
    nb = np.full(B, -1, np.int64)
    partial = np.full((B * nblk, 2), -1, np.int64)

    def lookup(screen, bits, bitset_, h, valid):
        hit = ((bitset_[h >> np.uint32(5)] >> (h & np.uint32(31))) & np.uint32(1)).astype(bool)
        passed = screen_bits(screen, h, bits)
        assert not (hit & ~passed).any()  # a screen never rejects a set bit
        return passed & hit & valid

    with np.errstate(over="ignore"):
        for t in range(tiles):
            stage = np.full(TILE + HALO_STAGE, 0xEE, np.uint8)  # garbage where not staged
            seg = flat[t * TILE : min(total, t * TILE + TILE + HALO_STAGE)]
            # the vector path stages whole 16-byte pieces; the byte path every byte
            n_staged = len(seg) if unaligned else len(seg) // 16 * 16
            stage[:n_staged] = seg[:n_staged]
            sums = np.zeros((WARPS, 2), np.int64)
            for w in range(WARPS):
                d = t * WARPS + w
                if d >= B * nblk:
                    continue
                v = lut32[stage[512 * w : 512 * w + 520]].astype(np.uint32)
                if d % nblk == nblk - 1:
                    v[512:] = 0  # past the row end: spaces
                sv = np.where(v == 0, np.uint32(32), v)
                i = np.arange(512)
                wlo = sv[i] | sv[i + 1] << 8 | sv[i + 2] << 16 | sv[i + 3] << 24
                whi = sv[i + 4] | sv[i + 5] << 8 | sv[i + 6] << 16 | sv[i + 7] << 24
                m = wlo * np.uint32(2654435761)
                valid = v[:512] != 0
                h4 = m >> np.uint32(10)
                h8 = (m + whi * np.uint32(40503)) >> np.uint32(10)
                blk[d] = int(lookup(s8, s8_bits, b8, h8, valid).sum())
                sums[w] = (int(lookup(s4, s4_bits, b4, h4, valid).sum()), int(valid.sum()))
            for w in range(WARPS):
                dw = t * WARPS + w
                if dw >= B * nblk or not (w == 0 or dw % nblk == 0):
                    continue
                row = dw // nblk
                row_last = (row + 1) * nblk - 1
                e = w
                while e < WARPS and t * WARPS + e <= row_last:
                    e += 1
                a, n = sums[w:e].sum(axis=0)
                if dw % nblk == 0 and t * WARPS + e - 1 == row_last:
                    ah[row], nb[row] = a, n
                else:
                    partial[dw] = (a, n)
        # the last block: rows across tiles, pieces in order
        for row in range(B):
            first, end = row * nblk, (row + 1) * nblk
            b1 = (first // WARPS + 1) * WARPS
            if b1 >= end:
                continue
            pieces = [first] + list(range(b1, end, WARPS))
            assert (partial[pieces] >= 0).all()
            ah[row], nb[row] = partial[pieces].sum(axis=0)
    assert (blk >= 0).all() and (ah >= 0).all() and (nb >= 0).all()
    return (blk.reshape(B, nblk).astype(np.int32), ah.astype(np.int32), nb.astype(np.int32))


def gate_rows(rng: np.random.Generator, n: int, width: int) -> np.ndarray:
    """Rows of license text cut at random points (the blooms' hits), random
    bytes from a small alphabet with separators and non-ASCII, and words
    running to the row's last byte."""
    texts = mixed_texts(int(rng.integers(1 << 30)), n, width)
    rows = text_rows(texts, width)
    alphabet = np.frombuffer(b"the licens permito grant\n\r\t.,;\x00\xc8\xff", np.uint8)
    for i in range(2, n, 3):
        rows[i] = alphabet[rng.integers(0, len(alphabet), width)]
    if n > 1:
        rows[1, -5:] = ord("w")  # a word to the row's last byte
    return rows


def port_gate(table, rows: np.ndarray):
    return [g.numpy() for g in bytes_gate_plain(
        torch.from_numpy(rows), t64(ng.lut_low32(table.lut)), torch.from_numpy(table.gate.bloom8),
        torch.from_numpy(table.gate.bloom4))]


@settings(max_examples=25, deadline=None)
@given(data=st.data())
def test_bytes_gate_kernel_model_equals_plain(table, data):
    """The model at row widths whose rows fit a tile (512-2048), straddle
    tiles (1536, 5120) and span several (16384), on 1-5 rows, with bloom8
    screens of 2^17-2^19 bits, on aligned and unaligned rows."""
    width = data.draw(st.sampled_from([512, 1024, 1536, 2048, 5120, 16384]))
    n = data.draw(st.integers(1, 5))
    rows = gate_rows(np.random.default_rng(data.draw(st.integers(0, 2**31))), n, width)
    kw = {"s8_bits": data.draw(st.sampled_from([17, 18, 19])),
          "unaligned": data.draw(st.booleans())}
    want = port_gate(table, rows)
    got = bytes_gate_model(rows, ng.lut_low32(table.lut), table.gate.bloom8, table.gate.bloom4,
                           **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("width, n, unaligned", [
    (49152, 3, False),  # a row spans 12 tiles
    (49152, 2, True),   # the same through the byte staging
    (1024, 1, False),   # one row, half a tile
    (1536, 7, True),    # rows straddling tile boundaries
    (4096, 4, False),   # two rows a tile
])
def test_bytes_gate_model_edges_equal_plain(table, width, n, unaligned):
    rows = gate_rows(np.random.default_rng(width + n), n, width)
    want = port_gate(table, rows)
    for s8_bits in (17, 19):
        got = bytes_gate_model(rows, ng.lut_low32(table.lut), table.gate.bloom8,
                               table.gate.bloom4, s8_bits=s8_bits, unaligned=unaligned)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    if n > 1:  # a license row lights both lanes
        assert want[0].max() > 16 and want[1].max() > 0


@pytest.mark.parametrize("bits", [17, 18, 19])
def test_folded_screens_never_reject_a_set_bloom_bit(table, bits):
    """On the real corpus table: every set slot of either bloom passes its
    folded screen, and the screens are as sparse as the kernel counts on
    (bloom4's screen under 2% set)."""
    for bloom in (table.gate.bloom4, table.gate.bloom8):
        screen = bytes_gate_cuda.fold(bloom, bits)
        h = np.nonzero(bloom)[0].astype(np.uint32)
        assert h.size and screen_bits(screen, h, bits).all()
        set_share = np.unpackbits(screen.view(np.uint8)).mean()
        assert set_share <= h.size / (1 << bits)
    s4 = bytes_gate_cuda.fold(table.gate.bloom4, bytes_gate_cuda.SCREEN4_BITS)
    assert np.unpackbits(s4.view(np.uint8)).mean() < 0.02


# -- the scorer ---------------------------------------------------------------------


def port_score(table, rows: np.ndarray, cap: int):
    return bytes_score_plain(torch.from_numpy(rows), t64(ng.lut_low32(table.lut)), t64(table.keys),
                             torch.from_numpy(table.credit), table.p1, table.p2, table.hash_p,
                             cap, table.ngram)


def jax_score(table, rows: np.ndarray, width: int):
    fn = jng.build_bytes_score_fn(width, width // 4, table.lic_per_shard, table.lut, table.p1,
                                  table.p2, table.hash_p, table.ngram)
    return [np.asarray(a) for a in fn(rows, table.keys[None], table.credit[None])]


@pytest.mark.parametrize("width", [1024, 4096])
def test_bytes_score_plain_equals_jax_within_the_cap(table, width):
    rows = text_rows(mixed_texts(width + 1, 8, width), width)
    cap = width // 4
    fw, ph, nu = port_score(table, rows, effective_cap(cap, width))
    jfw, jph, jnu = jax_score(table, rows, width)
    assert (jnu <= cap).sum() >= 4
    within = jnu <= cap
    np.testing.assert_array_equal(nu.numpy(), jnu)
    np.testing.assert_array_equal(ph.numpy()[within], jph[within])
    np.testing.assert_allclose(fw.numpy()[within], jfw[within], rtol=1e-5, atol=0)
    assert fw.numpy()[within].max() > 1.0  # license rows score


def test_scorer_cap_counts_distinct_keys(port_clf, jax_clf, table):
    """The reference's fault: a row whose distinct grams fit the cap but
    whose repeated ones do not. The port's full_w equals the host oracle's
    matched weight; the JAX function's falls short, without a reroute."""
    width = 4096
    rows = text_rows([FAULT_TEXT], width)
    fw, _, nu = port_score(table, rows, effective_cap(width // 4, width))
    jfw, _, jnu = jax_score(table, rows, width)
    assert len(FAULT_TEXT) == 3033 and int(nu[0]) == int(jnu[0]) == 166 <= width // 4
    li = jax_clf.licenses.index("MIT")
    norm = jax_corpus.normalize(FAULT_TEXT)
    conf, matched_w = jax_clf._score(li, norm, jax_clf._text_grams(norm))
    assert conf == 1.0
    assert float(fw[0, li]) == pytest.approx(matched_w, rel=1e-5)
    assert float(jfw[0, li]) < 0.99 * matched_w
    # the classifiers: the port reports the oracle's confidence, the JAX
    # device path a lower one
    batch = [FAULT_TEXT] + [FULL_TEXTS[k] for k in sorted(FULL_TEXTS)[:7]]
    oracle = jax_clf.classify_batch(batch)
    assert [f.to_dict() for f in port_clf.classify_batch(batch)[0]] == [
        f.to_dict() for f in oracle[0]]
    assert oracle[0][0].confidence == 1.0
    dev = JaxClassifier(backend="device").classify_batch(batch)
    assert dev[0][0].name == "MIT" and dev[0][0].confidence < 1.0


def radix_sort(keys: np.ndarray) -> np.ndarray:
    """The kernel's LSD radix sort: four stable passes of 8-bit digits."""
    a = keys.copy()
    for shift in (0, 8, 16, 24):
        a = a[np.argsort((a >> np.uint32(shift)) & np.uint32(0xFF), kind="stable")]
    return a


def bytes_score_model(rows, lut32, keys, credit, p1, p2, hp, gcap, S, ngram=5):
    """csrc/bytes_score.cu's cluster formulation, S blocks per row: slices
    of ``align16(ceil(C / S))`` bytes, each with its word starts (the byte
    before the slice decides the first); each word's sums of v[k] and
    k v[k] as differences of the row's prefix sums (mod 2^32), subtracted at
    its start and added at its last byte by the block that holds it (an
    earlier block's word when no start precedes it in the slice); gram keys
    folded across later slices; keys split into S buckets by their top bits
    (a bucket over its shared-memory capacity spills, with the same result),
    each bucket radix-sorted and deduplicated, global ranks from the
    scanned distinct counts, the first ``gcap`` looked up, and the found
    rows summed in float32 over the buckets' lists in order. Returns
    ``(full_w, phrase, n_uniq, spills)``."""
    B, C = rows.shape
    L2 = credit.shape[1]
    out = np.zeros((B, L2), np.float32)
    nuniq = np.zeros(B, np.int32)
    P1, P2, HP = np.uint32(p1 & M32), np.uint32(p2 & M32), np.uint32(hp & M32)
    Cs = (-(-C // S) + 15) & ~15
    word_cap = Cs // 2 + 1
    bucket_cap = word_cap if S == 1 else 2 * word_cap
    top = 32 - (S.bit_length() - 1)
    spills = 0
    with np.errstate(over="ignore"):
        for b in range(B):
            v = lut32[rows[b]].astype(np.uint32)
            pre0 = np.concatenate([[0], np.cumsum(v, dtype=np.uint32)]).astype(np.uint32)
            pre1 = np.concatenate([[0], np.cumsum(v * np.arange(C, dtype=np.uint32),
                                                   dtype=np.uint32)]).astype(np.uint32)
            sums = []  # per block: [s0, s1, start] of each word starting in its slice
            for r in range(S):
                lo, hi = min(r * Cs, C), min(r * Cs + Cs, C)
                words = []
                for k in range(lo, hi):
                    if v[k] and not (v[k - 1] if k > 0 else 0):
                        words.append([np.uint32(0) - pre0[k], np.uint32(0) - pre1[k], k])
                    if v[k] and (k + 1 == C or not v[k + 1]):  # the last byte of a word
                        owner = words if words else next(w for w in sums[::-1] if w)
                        owner[-1][0] += pre0[k + 1]
                        owner[-1][1] += pre1[k + 1]
                assert len(words) <= word_cap
                sums.append(words)
            hashes = [[s0 * P1 + (s1 - np.uint32(i) * s0) * P2 for s0, s1, i in words]
                      for words in sums]
            base = np.concatenate([[0], np.cumsum([len(h) for h in hashes])])
            flat = [h for H in hashes for h in H]  # what the DSMEM reads see
            buckets = [[] for _ in range(S)]
            for r in range(S):
                for j in range(min(len(hashes[r]), max(0, len(flat) - ngram + 1 - base[r]))):
                    g = base[r] + j
                    key = hashes[r][j]
                    for t in range(1, ngram):
                        key = key * HP + flat[g + t]
                    key = min(key, np.uint32(SENT32 - 1))
                    buckets[0 if S == 1 else int(key) >> top].append(key)
            uniq, lists = [], []
            for bk in buckets:
                spills += len(bk) > bucket_cap
                a = radix_sort(np.asarray(bk, np.uint32))
                uniq.append(a[np.concatenate([[True], a[1:] != a[:-1]])] if len(a) else a)
            ubase = np.concatenate([[0], np.cumsum([len(u) for u in uniq])])
            for q, u in enumerate(uniq):
                found = [int(np.searchsorted(keys, k)) for k in u[: max(0, gcap - ubase[q])]]
                lists.append([p for p, k in zip(found, u) if p < len(keys) and keys[p] == k])
            nuniq[b] = ubase[-1]
            acc = np.zeros(L2, np.float32)
            for lst in lists:
                for p in lst:
                    acc += credit[p]
            out[b] = acc
    return out[:, : L2 // 2], out[:, L2 // 2 :], nuniq, spills


@settings(max_examples=40, deadline=None)
@given(data=st.data())
def test_bytes_score_kernel_model_equals_plain(table, data):
    """On random word soups, corpus sentences, the over-cap row, a row with
    no words, one word over the whole row and words straddling slice ends,
    at every cluster size and a cap that cuts: the model and the plain
    version agree exactly (both sum in ascending key order)."""
    S = data.draw(st.sampled_from([1, 2, 4, 8]))
    width = data.draw(st.sampled_from([64, 256, 1000, 1024, 2048]))
    words = ["the", "software", "is", "provided", "as", "without", "warranty", "of", "any",
             "kind", "x", "é", "a", "b", "w" * 40]
    texts = []
    for _ in range(data.draw(st.integers(1, 3))):
        kind = data.draw(st.integers(0, 4))
        if kind == 0:
            texts.append(FULL_TEXTS["MIT"][data.draw(st.integers(0, 900)):])
        elif kind == 1:
            texts.append(" ".join(data.draw(st.lists(st.sampled_from(words), max_size=300))))
        elif kind == 2:
            texts.append(FAULT_TEXT)
        elif kind == 3:
            texts.append(data.draw(st.sampled_from(["", " \n ", "w" * (width + 8)])))
        else:  # a word across every possible slice end
            t = bytearray(b" " * width)
            for e in range(16, width - 2, 16):
                t[e - 2 : e + 2] = b"abcd"
            texts.append(t.decode())
    rows = text_rows(texts, width)
    cap = data.draw(st.sampled_from([1, 3, 256]))
    lut32 = ng.lut_low32(table.lut)
    *want, _ = bytes_score_model(rows, lut32, table.keys, table.credit, table.p1, table.p2,
                                 table.hash_p, cap, S)
    got = port_score(table, rows, cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


SKEWED_TEXT = " a" * 2000  # 1,996 copies of one gram key


@pytest.mark.parametrize("S", [4, 8])
def test_bytes_score_model_spills_a_skewed_row(table, S):
    """A row of one repeated key overfills its bucket: the kernel sorts that
    bucket in its device scratch, with the plain version's result, beside
    the over-cap row."""
    width = 4096
    rows = text_rows([SKEWED_TEXT, FAULT_TEXT, FULL_TEXTS["MIT"]], width)
    cap = effective_cap(width // 4, width)
    fw, ph, nu, spills = bytes_score_model(rows, ng.lut_low32(table.lut), table.keys,
                                           table.credit, table.p1, table.p2, table.hash_p, cap, S)
    assert spills >= 1 and list(nu[:2]) == [1, 166]
    for g, w in zip(port_score(table, rows, cap), (fw, ph, nu)):
        np.testing.assert_array_equal(g.numpy(), w)


def test_cluster_size_bounds_the_slice():
    """Clusters of 1, 2, 4 or 8 blocks, by width only: the smallest whose
    slices hold at most 8 KiB."""
    from trivy_tpu_torch.ops.bytes_score_cuda import SLICE_MAX, cluster_size

    sizes = [cluster_size(w) for w in ng.BYTES_WIDTHS]
    assert sizes == [1, 1, 1, 1, 2, 4, 8]
    for w, s in zip(ng.BYTES_WIDTHS, sizes):
        assert -(-w // s) <= SLICE_MAX < -(-w // max(1, s // 2)) or s == 1


# -- the classifier -----------------------------------------------------------------


def assert_parity(port_clf, jax_clf, texts: list[str]) -> list:
    """The port's classify_batch (device pipeline, plain versions) against
    the JAX host oracle: findings equal, field for field."""
    got = port_clf.classify_batch(texts)
    want = jax_clf.classify_batch(texts)
    for i, (a, b) in enumerate(zip(got, want)):
        assert [f.to_dict() for f in a] == [f.to_dict() for f in b], (i, texts[i][:60])
    return want


@pytest.mark.parametrize("form", ["raw", "rewrapped", "crlf"])
def test_classify_full_texts_equal_oracle(port_clf, jax_clf, form):
    texts = []
    for k in sorted(FULL_TEXTS):
        t = FULL_TEXTS[k]
        if form == "rewrapped":
            words = t.split(" ")
            t = "\n".join(" ".join(words[i : i + 9]) for i in range(0, len(words), 9)).upper()
        elif form == "crlf":
            t = t.replace(". ", ".\r\n")
        texts.append(t)
    want = assert_parity(port_clf, jax_clf, texts)
    assert sum(1 for w in want if w) >= 20


def test_classify_headers_phrases_and_odd_texts_equal_oracle(port_clf, jax_clf):
    mit = FULL_TEXTS["MIT"]
    texts = [
        "# Licensed under the Apache License, Version 2.0 (the \"License\");\n"
        "# you may not use this file except in compliance with the License.\n" + "x = 1\n" * 50,
        "// SPDX-License-Identifier: MIT\n// Released under the MIT License\nint x;\n",
        "This program is free software; you can redistribute it and/or modify it under "
        "the terms of the GNU General Public License as published by the Free Software "
        "Foundation; either version 2 of the License",
        "mozilla public license, v. 2.0",
        "apache license",
        mit.replace("copyright", "cópyright “notice”"),
        mit[: len(mit) // 2] + " 许可证 MIT 许可 " + mit[len(mit) // 2 :],
        "\U0001f512 " + mit + " \U0001f513",
        "договір " * 200,
        "﻿" + mit,
        "x" * 300 + " " + mit,
        ("y" * 9 + " ") * 400,
        "z" * 65600,
        mit + " " + "w" * 70000,
        "", " ", "\n\n\n", "\t \r\n \t", " " * 5000,
        FAULT_TEXT,
    ]
    want = assert_parity(port_clf, jax_clf, texts)
    assert want[-1] and sum(1 for w in want if w) >= 6


def test_classify_every_width_rung_equal_oracle(port_clf, jax_clf):
    mit = FULL_TEXTS["MIT"]

    def sized(n: int) -> str:
        body = mit + " "
        while len(body) < n:
            body += "filler words to reach the boundary "
        return body[:n]

    texts = []
    for w in ng.BYTES_WIDTHS:
        texts += [sized(w - 1), sized(w), sized(w + 1)]
    want = assert_parity(port_clf, jax_clf, texts)
    assert all(any(f.name == "MIT" for f in w) for w in want[:6])


@pytest.mark.parametrize("host_fallback", [False, True], ids=["no-fallback", "fallback"])
def test_device_path_runs_on_eight_texts_and_fails_loudly(port_clf, monkeypatch, host_fallback):
    """Eight texts take the device pipeline. An error there fails the call
    with the fallback off; on (the default), the batch degrades to the
    host oracle, as the JAX classifier does: the same findings,
    ``license.degraded`` counted and the scan marked degraded once."""
    from trivy_tpu_torch import obs as tobs

    texts = [FULL_TEXTS["MIT"]] * 4 + [FULL_TEXTS["Apache-2.0"], "no license here"] * 2
    scorer = port_clf._device_scorer()
    before = scorer.dispatch_count
    want = port_clf.classify_batch(texts)
    assert scorer.dispatch_count >= before + 2  # a gate and a score dispatch

    def boom(rows):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(scorer, "gate_bytes", boom)
    monkeypatch.setattr(port_clf, "host_fallback", host_fallback)
    monkeypatch.setattr(port_clf, "_device_failed_logged", False)
    with tobs.scan_context(name="lic", enabled=True) as ctx:
        if not host_fallback:
            with pytest.raises(RuntimeError, match="kernel launch failed"):
                port_clf.classify_batch(texts)
            assert not ctx.health_snapshot()
        else:
            for _ in range(2):
                got = port_clf.classify_batch(texts)
                assert [[(f.name, f.confidence) for f in fs] for fs in got] == [
                    [(f.name, f.confidence) for f in fs] for fs in want]
            assert ctx.counters["license.degraded"] == 2
            assert ctx.health_snapshot() == {"license.degraded": 2, "scan.degraded": 1}
    assert port_clf.classify_batch([FULL_TEXTS["MIT"]] * 3)[0][0].name == "MIT"  # host path
