"""The port's compressed feed against the JAX package's.

Three layers, all with exact equality (the outputs are bytes):

1. **Codec.** ``trivy_tpu_torch.secret.compress.SlabCodec`` builds the JAX
   codec's tables and makes its ``plan`` and ``emit`` outputs on the fuzz
   cases of ``tests/test_compress.py``.
2. **Decoder.** ``decompress_plain`` (the plain version of
   ``csrc/decompress.cu``) equals the JAX ``build_decompress_fn``, jitted on
   the CPU, and the host reference decoder ``SlabCodec.decode_slab`` on the
   codec's frames and on hand-built edge frames. A numpy model that follows
   the CUDA kernel step by step (a block per row, the staged stream, each
   thread's stretch of tokens, the warp-shuffle scan, the expansion into a
   shared row) equals ``decompress_plain``, also under a ``hypothesis``
   property over random frames. The kernel itself runs only on the card
   (``tests/test_torch_card.py``).
3. **Scanner.** ``TorchSecretScanner(device="cpu")`` with compression on
   keeps findings equal to the exact engine and every counter equal to
   ``TpuSecretScanner``'s, and mirrors the JAX package's compressed-feed
   tests.
"""

import re
import threading
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tests.test_compress import RESTRICTED, mixed_corpus
from tests.test_torch_match import few_torch_threads  # noqa: F401
from trivy_tpu.cache import new_cache as jax_new_cache
from trivy_tpu.ops.decompress import build_decompress_fn as jax_decompress_fn
from trivy_tpu.secret import compress as JC
from trivy_tpu.secret.engine import ScannerConfig as JaxConfig
from trivy_tpu.secret.engine import SecretScanner as JaxEngine
from trivy_tpu.secret.tpu_scanner import TpuSecretScanner
from trivy_tpu_torch import cache
from trivy_tpu_torch.ops import match_cuda
from trivy_tpu_torch.ops.decompress import build_decompress_fn, decompress_plain
from trivy_tpu_torch.secret import compress as PC
from trivy_tpu_torch.secret import scanner as scanner_mod
from trivy_tpu_torch.secret.engine import ScannerConfig
from trivy_tpu_torch.secret.scanner import TorchSecretScanner

KERNEL_SRC = (Path(__file__).resolve().parents[1] / "trivy_tpu_torch" / "ops" / "csrc"
              / "decompress.cu").read_text()
KERNEL_THREADS = int(re.search(r"constexpr int kThreads = (\d+);", KERNEL_SRC).group(1))


# -- layer 1: the codec ------------------------------------------------------


def fuzz_cases():
    """The row sets of ``tests/test_compress.py``'s fuzz test (same seed,
    same makers, same zero splices) and of its run-length/pad-row test, as
    ``(chunk_len, rows, rows_pad)``."""
    rng = np.random.default_rng(42)
    makers = [
        lambda n: rng.integers(0, 256, size=(n, 1024), dtype=np.uint8),
        lambda n: rng.integers(0x20, 0x7F, size=(n, 1024), dtype=np.uint8),
        lambda n: np.repeat(
            np.array(JC.RUN_BYTES, np.uint8)[rng.integers(0, 8, size=(n, 64))], 16, axis=1),
        lambda n: np.frombuffer(
            (b"the secret token rate stands on the line; // == -- ##\n" * 200)[: n * 1024],
            np.uint8).reshape(n, 1024).copy(),
    ]
    cases = []
    for trial in range(12):
        n = int(rng.integers(1, 9))
        rows = makers[trial % 4](n)
        if trial % 3 == 0:
            s = int(rng.integers(0, 900))
            rows[rng.integers(0, n)][s : s + 100] = 0
        cases.append((1024, rows, n + int(rng.integers(0, 3))))
    runs = np.zeros((6, 512), dtype=np.uint8)
    for i, b in enumerate(JC.RUN_BYTES[:6]):
        runs[i] = b
    cases.append((512, runs, 8))
    row = np.tile(np.r_[np.full(8, 0x20, np.uint8), np.frombuffer(b"abcdefgh", np.uint8)], 512 // 16)
    cases.append((512, np.stack([row] * 3), 3))
    return cases


CASES = fuzz_cases()


def encode(codec, rows, rows_pad):
    plan = codec.plan(rows)
    out = np.zeros(max(plan.total(), 1) + 256, dtype=np.uint8)
    return plan, codec.emit(plan, rows_pad, out.size, out)


def test_codec_tables_equal_jax():
    for name in ("RUN_BYTES", "_PAIRS", "MAX_EXPANSION", "COMPRESS_MIN_RATIO",
                 "MODE_RAW", "MODE_PACK7", "MODE_TOKEN"):
        assert getattr(PC, name) == getattr(JC, name), name
    mine, theirs = PC.SlabCodec(1024), JC.SlabCodec(1024)
    for t in ("tab_bytes", "tab_len", "run_map", "pair_map"):
        np.testing.assert_array_equal(getattr(mine, t), getattr(theirs, t), err_msg=t)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_plan_and_emit_equal_jax(case):
    C, rows, rows_pad = CASES[case]
    mp, mcs = encode(PC.SlabCodec(C), rows, rows_pad)
    jp, jcs = encode(JC.SlabCodec(C), rows, rows_pad)
    for f in ("binary", "is_run", "ptok", "clen", "mode"):
        np.testing.assert_array_equal(getattr(mp, f), getattr(jp, f), err_msg=f)
    for a, b in zip(mcs.arrays(), jcs.arrays()):
        np.testing.assert_array_equal(a, b)
    assert (mcs.n_rows, mcs.rows_pad, mcs.wire_bytes, mcs.frame_bytes()) == \
        (jcs.n_rows, jcs.rows_pad, jcs.wire_bytes, jcs.frame_bytes())


# -- layer 2: the decoder ----------------------------------------------------


def plain(codec, buf, offs, clen, mode) -> np.ndarray:
    return decompress_plain(torch.from_numpy(codec.tab_bytes), torch.from_numpy(codec.tab_len),
                            torch.from_numpy(buf), torch.from_numpy(offs), torch.from_numpy(clen),
                            torch.from_numpy(mode), codec.chunk_len).numpy()


def jax_decode(codec, buf, offs, clen, mode) -> np.ndarray:
    fn = jax_decompress_fn(codec.chunk_len, codec.tab_bytes, codec.tab_len)
    return np.asarray(fn(*(jnp.asarray(a) for a in (buf, offs, clen, mode))))


def edge_frames(C: int, rng) -> tuple[tuple, tuple]:
    """Hand-built frames over one buffer, as ``(well_formed, malformed)``,
    each ``(buf, offs, clen, mode)``. Well-formed rows (every stream inside
    the buffer, modes 0-2) are: a TOKEN stream whose last token straddles
    ``C`` (a literal, then ``C/8`` runs of 8), a short RAW stream, a full
    PACK7 stream of 0xFF bytes (all 0x7F rows), a RAW stream ending at the
    last byte of the buffer, and a ``clen == 0`` TOKEN row. Malformed rows
    are the ones only the device decoders define: a TOKEN stream that runs
    far past ``C``, a mode byte of 3, a stream that starts before the
    buffer or runs past its end, ``clen > C``, and a 10-byte PACK7 stream
    followed by 0xFF bytes, whose output must read zeros past the stream."""
    tok = np.r_[np.uint8(ord("x")), np.full(C // 8, 0x81, np.uint8), np.full(40, 0x88, np.uint8)]
    straddle = tok[: C // 8 + 1]
    pack = np.full(C * 7 // 8, 0xFF, np.uint8)
    raw = rng.integers(0, 256, 300, dtype=np.uint8)
    buf = np.concatenate([straddle, raw[:5], pack, tok, rng.integers(0, 256, C, dtype=np.uint8),
                          raw])
    W = len(buf)
    o_pack = len(straddle) + 5
    o_tok = o_pack + len(pack)
    good = (
        np.array([0, len(straddle), o_pack, W - len(raw), 0], np.int32),
        np.array([len(straddle), 5, len(pack), len(raw), 0], np.int32),
        np.array([PC.MODE_TOKEN, PC.MODE_RAW, PC.MODE_PACK7, PC.MODE_RAW, PC.MODE_TOKEN],
                 np.uint8),
    )
    bad = (
        np.array([o_tok, 0, -7, W - 3, o_tok, o_pack], np.int32),
        np.array([len(tok), C, C, 10, 2 * C, 10], np.int32),
        np.array([PC.MODE_TOKEN, 3, PC.MODE_RAW, PC.MODE_PACK7, PC.MODE_RAW, PC.MODE_PACK7],
                 np.uint8),
    )
    return (buf, *good), (buf, *bad)


def test_edge_frames_read_as_designed():
    C = 1024
    codec = PC.SlabCodec(C)
    good, bad = edge_frames(C, np.random.default_rng(0))
    got = plain(codec, *good)
    buf, offs = good[0], good[1]
    assert (got[0, :1] == ord("x")).all() and (got[0, 1:] == 0x20).all()  # straddler cut at C
    np.testing.assert_array_equal(got[1, :5], buf[offs[1] : offs[1] + 5])
    assert not got[1, 5:].any()  # short RAW zero-fills
    assert (got[2] == 0x7F).all()
    assert not got[4].any()
    short = plain(codec, *bad)[5]  # 80 bits of ones, then the masked zeros
    assert (short[:11] == 0x7F).all() and short[11] == 0x70 and not short[12:].any()


@pytest.mark.parametrize("case", range(len(CASES)))
def test_decoders_equal_on_codec_frames(case):
    C, rows, rows_pad = CASES[case]
    codec = PC.SlabCodec(C)
    _, cs = encode(codec, rows, rows_pad)
    want = np.zeros((rows_pad, C), np.uint8)
    want[: len(rows)] = rows
    got = plain(codec, *cs.arrays())
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_decode(codec, *cs.arrays()))
    np.testing.assert_array_equal(got, JC.SlabCodec(C).decode_slab(cs))


@pytest.mark.parametrize("C", [1024, 2048, 1000])
def test_decoders_equal_on_edge_frames(C):
    """Well-formed edge frames against all three decoders; malformed ones
    against the JAX device decoder only: the host reference decoder reads
    no clamp and decodes every mode but 0 and 1 as TOKEN, so it does not
    define them."""
    codec = PC.SlabCodec(C)
    good, bad = edge_frames(C, np.random.default_rng(C))
    for frame in (good, bad):
        np.testing.assert_array_equal(plain(codec, *frame), jax_decode(codec, *frame))
    np.testing.assert_array_equal(plain(codec, *good), JC.SlabCodec(C).decode_rows(*good))


def warp_scan(v: np.ndarray) -> np.ndarray:
    """Inclusive scan of one warp's 32 values by ``__shfl_up_sync`` steps of
    1, 2, 4, 8, 16, each lane reading its neighbour's value from before the
    step, as ``csrc/decompress.cu::warp_scan`` does."""
    lane = np.arange(32)
    v = v.copy()
    for d in (1, 2, 4, 8, 16):
        up = np.r_[np.zeros(d, v.dtype), v[:-d]]
        v = np.where(lane >= d, v + up, v)
    return v


def kernel_model(tab_bytes, tab_len, buf, offs, clen, mode, C, threads=KERNEL_THREADS, grid=3,
                 addr=0):
    """``csrc/decompress.cu`` step by step in numpy: ``grid`` persistent
    blocks, block b taking row b and then its share of the other rows
    (TOKEN rows dealt out first), each block with two stream buffers and a
    TOKEN row that keep what earlier rows left in them. A row's stream is
    staged at its shift (``addr``, the buffer's address mod 16, plus its
    offset), as the 16-byte pieces that hold it: a piece wholly inside the
    buffer is copied whole (bytes past the stream included), any other
    byte by byte with the clamp (asserted inside the buffer). Every read of
    the stream is masked past ``n`` in registers: RAW in 16-byte chunks,
    PACK7 as two 7-byte groups per 16 output bytes decoded as 56-bit
    big-endian values, TOKEN by per-warp stretches whose totals a scan
    places, each expanded 128 tokens at a time, four neighbouring tokens a
    lane (a shuffle scan of the lanes' lengths, asserting no byte is written
    twice) into the shared row, which
    goes out masked past its expanded length. Output bytes start as 0xAB,
    so a byte the kernel never writes shows."""
    W = len(buf)
    B = len(offs)
    G = min(grid, B)
    warps = threads // 32
    pad = -(-C // 16) * 16
    chunks = [(16 * c, min(16, C - 16 * c)) for c in range(-(-C // 16))]
    out = np.full((B, C), 0xAB, np.uint8)
    sbuf = [[np.full(pad + 32, 0xCD, np.uint8) for _ in range(2)] for _ in range(G)]
    rowbuf = [np.full(pad + 16, 0xEF, np.uint8) for _ in range(G)]
    # row b first, then positions b, b + G, ... of the other rows ordered
    # TOKEN rows first (ascending), the rest after them (descending)
    rest = [r for r in range(G, B) if mode[r] == PC.MODE_TOKEN]
    rest += [r for r in range(B - 1, G - 1, -1) if mode[r] != PC.MODE_TOKEN]
    rows = [[b] + rest[b::G] for b in range(G)]

    def load16(s, p):  # two aligned 16-byte words, shifted: inside the buffer
        assert (p & ~15) + 32 <= len(s)
        return s[p : p + 16].copy()

    def first(x, v):
        x[max(0, min(16, v)) :] = 0
        return x

    for b in range(G):
        row = rowbuf[b]
        for it, i in enumerate(rows[b]):
            s = sbuf[b][it & 1]
            off, n = int(offs[i]), min(max(int(clen[i]), 0), C)
            shift = (addr + off) & 15
            a0 = addr + off - shift
            for q in range((shift + n + 15) >> 4 if n else 0):
                g = a0 + 16 * q
                if g >= addr and g + 16 <= addr + W:
                    s[16 * q : 16 * q + 16] = buf[g - addr : g - addr + 16]
                    continue
                for e in range(16):
                    j = 16 * q + e - shift
                    if 0 <= j < n:
                        k = min(max(off + j, 0), W - 1)
                        assert 0 <= k < W
                        s[16 * q + e] = buf[k]
                    else:
                        s[16 * q + e] = 0
            m = int(mode[i])
            if n == 0:
                for j0, cnt in chunks:
                    out[i, j0 : j0 + cnt] = 0
            elif m == PC.MODE_PACK7:
                for c, (j0, cnt) in enumerate(chunks):
                    x = first(load16(s, shift + 14 * c), n - 14 * c)
                    ga = int.from_bytes(x[:7].tobytes(), "big")
                    gb = int.from_bytes(x[7:14].tobytes(), "big")
                    dec = [(g >> (49 - 7 * k)) & 0x7F for g in (ga, gb) for k in range(8)]
                    out[i, j0 : j0 + cnt] = np.array(dec[:cnt], np.uint8)
            elif m != PC.MODE_TOKEN:
                for j0, cnt in chunks:
                    out[i, j0 : j0 + cnt] = first(load16(s, shift + j0), n - j0)[:cnt]
            else:
                tok = s[shift : shift + n]
                per = -(-n // warps)
                t0 = np.minimum(np.arange(warps) * per, n)
                t1 = np.minimum(t0 + per, n)
                lens = tab_len[tok].astype(np.int64)
                totals = np.array([lens[a:z].sum() for a, z in zip(t0, t1)])
                w_in = np.r_[totals, np.zeros(32 - warps, np.int64)]
                w_incl = warp_scan(w_in)
                warp_off = (w_incl - w_in)[:warps]
                L = min(int(w_incl[warps - 1]), C)
                written = np.zeros(pad + 16, bool)
                for w in range(warps):
                    base = int(warp_off[w])
                    for k0 in range(int(t0[w]), int(t1[w]), 128):
                        if base >= C:
                            break
                        k = k0 + np.arange(128).reshape(32, 4)  # four tokens a lane
                        live = k < t1[w]
                        t = np.where(live, tok[np.minimum(k, n - 1)], 0)
                        ln = np.where(live, tab_len[t], 0).astype(np.int64)
                        sums = ln.sum(axis=1)
                        incl = warp_scan(sums)
                        for lane in range(32):
                            pos = base + int(incl[lane] - sums[lane])
                            for u in range(4):
                                for e in range(min(int(ln[lane, u]), C - pos)):
                                    assert not written[pos + e]
                                    written[pos + e] = True
                                    row[pos + e] = tab_bytes[t[lane, u], e]
                                pos += int(ln[lane, u])
                        base += int(incl[31])
                assert written[:L].all()
                for j0, cnt in chunks:
                    out[i, j0 : j0 + cnt] = first(row[j0 : j0 + 16].copy(), L - j0)[:cnt]
    return out


def model(codec, C, frame, threads=KERNEL_THREADS, **kw):
    return kernel_model(codec.tab_bytes, codec.tab_len, *frame, C, threads, **kw)


@pytest.mark.parametrize("threads", [KERNEL_THREADS, 64])
def test_kernel_model_equals_plain(threads):
    rng = np.random.default_rng(5)
    for C, rows, rows_pad in CASES[::3] + CASES[-2:]:
        codec = PC.SlabCodec(C)
        _, cs = encode(codec, rows, rows_pad)
        np.testing.assert_array_equal(model(codec, C, cs.arrays(), threads), plain(codec, *cs.arrays()))
    for C in (1024, 1000):
        codec = PC.SlabCodec(C)
        for frame in edge_frames(C, rng):
            for addr in (0, 5):
                np.testing.assert_array_equal(model(codec, C, frame, threads, addr=addr),
                                              plain(codec, *frame))


def odd_frame(C: int, rng) -> tuple:
    """A wire buffer whose length is no multiple of 16, with streams at
    every shift: negative offsets, streams past either end, a stream wholly
    past the buffer, clen 0 and clen > C, in every mode."""
    W = 5 * C + 13
    buf = rng.choice(np.array([0x80, 0x81, 0x88, 0x20, ord("a"), 0, 0xFF], np.uint8), W)
    B = 24
    offs = np.r_[rng.integers(0, W - C, B - 6), [-9, -C - 3, W - 5, W + 7, 3, W - C]]
    clen = np.r_[rng.integers(1, C + 1, B - 6), [C, C, 40, 12, 0, 2 * C]]
    mode = (np.arange(B) % 4).astype(np.uint8)
    return buf, offs.astype(np.int32), clen.astype(np.int32), mode


@pytest.mark.parametrize("C, grid, addr", [
    (1024, 1, 0),      # one block walks every row, both buffers reused
    (1024, 4, 3),      # a buffer address off 16-byte alignment
    (1000, 2, 15),     # rows of 8-byte stores
    (256, 64, 8),      # more blocks than rows
])
def test_kernel_model_edges_equal_plain(C, grid, addr):
    codec = PC.SlabCodec(C)
    frame = odd_frame(C, np.random.default_rng(C + grid))
    assert len(frame[0]) % 16 and (frame[1] < 0).any() and (frame[1] >= len(frame[0])).any()
    np.testing.assert_array_equal(model(codec, C, frame, grid=grid, addr=addr), plain(codec, *frame))


@st.composite
def frames(draw):
    """Random frames: a random buffer (text-like, run-heavy or any byte) and
    rows with random offsets (some past either end), lengths (0 to past C)
    and mode bytes (0-3)."""
    C = draw(st.sampled_from([64, 128, 200, 256]))
    seed = draw(st.integers(0, 2**31))
    rng = np.random.default_rng(seed)
    W = int(rng.integers(1, 4 * C))
    kind = draw(st.sampled_from(["any", "text", "runs"]))
    if kind == "any":
        buf = rng.integers(0, 256, W, dtype=np.uint8)
    elif kind == "text":
        buf = rng.integers(0x20, 0x7F, W, dtype=np.uint8)
    else:
        buf = rng.choice(np.array([0x80, 0x81, 0x88, 0xC0, ord("a"), 0], np.uint8), W)
    B = int(rng.integers(1, 6))
    offs = rng.integers(-8, W + 8, B).astype(np.int32)
    clen = rng.integers(-2, 2 * C, B).astype(np.int32)
    clen[rng.random(B) < 0.2] = 0
    mode = rng.integers(0, 4, B).astype(np.uint8)
    return C, (buf, offs, clen, mode)


@settings(max_examples=40, deadline=None)
@given(frames(), st.integers(1, 6), st.integers(0, 15))
def test_kernel_model_equals_plain_property(frame, grid, addr):
    """Random frames, grids and buffer alignments."""
    C, f = frame
    codec = PC.SlabCodec(C)
    np.testing.assert_array_equal(model(codec, C, f, threads=64, grid=grid, addr=addr),
                                  plain(codec, *f))


def test_wrapper_checks_input_and_counts_no_cpu_launch():
    codec = PC.SlabCodec(1024)
    fn = build_decompress_fn(1024, codec.tab_bytes, codec.tab_len, "cpu")
    _, cs = encode(codec, np.zeros((2, 1024), np.uint8), 2)
    parts = [torch.from_numpy(a) for a in cs.arrays()]
    before = dict(match_cuda.LAUNCHES)
    assert not fn(*parts).any()
    assert dict(match_cuda.LAUNCHES) == before  # the plain version counts nothing
    with pytest.raises(ValueError, match="int32"):
        fn(parts[0], parts[1].long(), parts[2], parts[3])
    with pytest.raises(ValueError, match="differ in length"):
        fn(parts[0], parts[1][:1], parts[2], parts[3])
    with pytest.raises(ValueError, match="empty"):
        fn(parts[0][:0], *parts[1:])
    with pytest.raises(ValueError, match="multiple of 8"):
        build_decompress_fn(1020, codec.tab_bytes, codec.tab_len, "cpu")


# -- layer 3: the scanner ----------------------------------------------------


@pytest.fixture(scope="module")
def cpu():
    return JaxEngine(JaxConfig.from_dict(RESTRICTED))


def build(compress="on", **kw):
    kw.setdefault("chunk_len", 2048)
    kw.setdefault("batch_size", 8)
    return TorchSecretScanner(ScannerConfig.from_dict(RESTRICTED), compress=compress,
                              device="cpu", **kw)


def jax_build(compress="on", **kw):
    kw.setdefault("chunk_len", 2048)
    kw.setdefault("batch_size", 8)
    return TpuSecretScanner(JaxConfig.from_dict(RESTRICTED), compress=compress, backend="xla",
                            **kw)


def assert_parity(cpu, scanner, files):
    got = list(scanner.scan_files(files))
    assert len(got) == len(files)
    for (path, data), secret in zip(files, got):
        assert secret.to_dict() == cpu.scan_bytes(path, data).to_dict(), path
    return got


def delta(scanner, before):
    return {k: v - before[k] for k, v in scanner.stats.snapshot().items()}


def test_compressed_scan_parity_and_counters(cpu):
    t, j = build("on"), jax_build("on")
    assert_parity(cpu, t, mixed_corpus())
    assert_parity(cpu, j, mixed_corpus())
    d, jd = t.stats.snapshot(), j.stats.snapshot()
    assert {k: d[k] for k in jd if k in d} == {k: jd[k] for k in d if k in jd}
    assert d["batches_compressed"] > 0 and d["bytes_compressed"] > 0
    assert d["bytes_uploaded"] < d["bytes_raw_equiv"] + d["bytes_raw_fallback"]
    assert d["chunks_gated_zero"] > 0 and d["bytes_gated"] > 0
    assert d["bytes_gated_binary"] > 0


def test_compress_off_is_zero_cost(cpu):
    t = build("off")
    assert t._codec is None and t._decompress is None and not t.compress_on
    assert t._wire_rungs == {}
    assert_parity(cpu, t, mixed_corpus())
    d = t.stats.snapshot()
    assert d["batches_compressed"] == 0 and d["bytes_compressed"] == 0
    assert d["chunks_gated_zero"] == 0  # the zero gate rides the codec
    assert d["bytes_uploaded"] > 0 and d["bytes_raw_equiv"] == 0
    assert d["bytes_raw_fallback"] == 0 and d["bytes_gated"] == 0


def test_auto_mode_resolves_by_device():
    # auto is off on the CPU (on for CUDA: tests/test_torch_card.py)
    assert not build("auto").compress_on and not build("").compress_on
    assert build("on").compress_on and build("on").compress_min_ratio == PC.COMPRESS_MIN_RATIO


def test_dedup_keys_are_codec_invariant(cpu):
    """A hit store warmed by a compressed scan serves a raw scan: keys hash
    uncompressed rows."""
    shared = cache.new_cache("memory")
    files = mixed_corpus(8)
    assert_parity(cpu, build("on", hit_cache=shared), files)
    b = build("off", hit_cache=shared)
    assert_parity(cpu, b, files)
    d = b.stats.snapshot()
    assert d["chunks_uploaded"] == 0 and d["chunks_dedup_hit"] > 0


def test_warm_rescan_uploads_nothing(cpu):
    t = build("on")
    files = mixed_corpus(8)
    list(t.scan_files(files))
    before = t.stats.snapshot()
    assert_parity(cpu, t, files)
    d = delta(t, before)
    assert d["bytes_uploaded"] == 0 and d["batches_compressed"] == 0


def test_scanner_rejects_bad_knobs():
    with pytest.raises(ValueError):
        build("sideways")
    with pytest.raises(ValueError):
        build("on", compress_min_ratio=1.5)
    # chunk_len % 8 != 0 breaks 7-bit packing: compression turns off
    # (with a warning), as in the JAX package
    t = build("on", chunk_len=1020)
    assert not t.compress_on and t._codec is None


@pytest.mark.parametrize("host_fallback", [False, True], ids=["no-fallback", "fallback"])
def test_encoder_error_fails_the_scan(cpu, monkeypatch, host_fallback):
    """An encoder exception no longer fails the scan: as in the JAX
    package's feeder, it is logged, the wire slab returns to the arena and
    the batch ships raw through the kernels. A raw batch is the codec's
    failure contract, not a host fallback, so the scan stays on the device
    with the fallback on or off: no retry, no degrade."""
    t = build("on", host_fallback=host_fallback)

    def boom(*a, **k):
        raise RuntimeError("encoder broke")

    monkeypatch.setattr(t._codec, "emit", boom)
    files = mixed_corpus(8)
    assert_parity(cpu, t, files)
    s = t.stats.snapshot()
    assert s["batches_compressed"] == 0 and s["batches_raw_fallback"] == s["batches"] > 0
    assert s["batch_retries"] == s["batch_splits"] == s["degraded"] == 0
    assert t._codec is not None and s["bytes_uploaded"] == s["bytes_raw_fallback"]


def test_every_batch_compressed_with_the_minimum_arena(cpu, monkeypatch):
    """Printable rows always fit the 0.875 budget, so every batch ships
    compressed and the feeder holds a source and a wire slab at once. With
    the worker slowed down the queue fills and the arena's
    ``FEED_QUEUE_DEPTH + ARENA_MARGIN`` slabs are all taken; the scan must
    still finish."""
    rng = np.random.default_rng(11)
    files = [(f"t/{i}.txt", rng.integers(0x21, 0x7F, 6000, dtype=np.uint8).tobytes())
             for i in range(40)]
    t = build("on", dedup=False)
    run_batch = t.run_batch

    def slow(rows, n):
        time.sleep(0.02)
        return run_batch(rows, n)

    monkeypatch.setattr(t, "run_batch", slow)
    acquires = []
    real = scanner_mod.ChunkArena

    def arena(*a, **k):
        acquires.append(real(*a, **k))
        return acquires[-1]

    monkeypatch.setattr(scanner_mod, "ChunkArena", arena)
    out = []
    th = threading.Thread(target=lambda: out.extend(t.scan_files(files)), daemon=True)
    th.start()
    th.join(timeout=120)
    assert not th.is_alive(), "scan did not finish: the arena deadlocked"
    assert len(out) == len(files)
    for (path, data), secret in zip(files, out):
        assert secret.to_dict() == cpu.scan_bytes(path, data).to_dict()
    d = t.stats.snapshot()
    assert d["batches"] == d["batches_compressed"] > 10 and d["batches_raw_fallback"] == 0
    assert acquires[0].n_slabs == scanner_mod.FEED_QUEUE_DEPTH + scanner_mod.ARENA_MARGIN
    assert acquires[0].free_slabs == acquires[0].n_slabs


def test_hit_store_written_by_the_port_serves_the_jax_scanner(cpu, tmp_path):
    """Codec on in the port, off in the JAX scanner, one FSCache directory:
    the JAX scanner re-scans without an upload."""
    files = mixed_corpus(8)
    assert_parity(cpu, build("on", hit_cache=cache.new_cache("fs", str(tmp_path))), files)
    j = jax_build("off", hit_cache=jax_new_cache("fs", str(tmp_path)))
    assert_parity(cpu, j, files)
    s = j.stats.snapshot()
    assert s["chunks_uploaded"] == 0 and s["chunks_warm_hit"] > 0
