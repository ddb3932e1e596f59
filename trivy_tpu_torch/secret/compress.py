"""Compressed slab wire format: host-side codec for the secret feed.

The host half of the compressed feed: the feeder compresses assembled arena
slabs with a deliberately *decoder-shaped* codec. Every row decodes with a
fixed-shape kernel (``ops/decompress.py``, ``ops/csrc/decompress.cu``),
which rules out general LZ (back-references serialize the decode) in favor
of three per-row modes a byte-class gate picks between:

- **TOKEN** (RLE + static byte-pair dictionary): one output byte per
  token. Tokens 0x00-0x7F are literals; 0x80-0x87 expand to a run of 8
  of a common filler byte (zero guard gaps / pack-row tails, NUL pages,
  indentation); 0x88-0xFF expand to one of 120 static common byte pairs
  (English + source-code digraphs). The decoder is a per-token length
  table, an exclusive prefix sum for output positions, and a scatter of
  each token's expansion. Wins on real text and on packed/tail rows that
  are mostly zeros (a zero row compresses 8x).
- **PACK7** (printable-class 7-bit packing): rows whose every byte is
  < 0x80 pack 8 bytes into 7, a guaranteed 0.875 ratio even on
  incompressible printable data. Decode is a fixed-position gather + shift.
- **RAW**: rows with any byte >= 0x80 (the binary gate) ship verbatim
  inside the compressed frame; a whole batch whose total wire size can't
  beat the configured ratio budget ships as a plain raw slab (per-batch
  fallback: the decompressor never runs for it).

The codec is *framing only*: compressed rows hash (dedup) and resolve
against their **uncompressed** content, so dedup keys, the hit cache and
every verdict are codec-invariant. ``SlabCodec.decode_slab`` is the host
reference decoder the device kernel must match byte for byte. The format,
tables and encoder are the JAX package's (``trivy_tpu/secret/compress.py``),
so a frame either package encodes decodes the same in both.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = [
    "MODE_RAW", "MODE_PACK7", "MODE_TOKEN", "MAX_EXPANSION",
    "COMPRESS_MIN_RATIO", "CompressedSlab", "SlabCodec",
]

MODE_RAW = 0
MODE_PACK7 = 1
MODE_TOKEN = 2

# widest token expansion (the run tokens): bounds the decoder's scatter
# unroll and the host reference decoder's per-position loop
MAX_EXPANSION = 8

# default per-batch wire budget as a fraction of the raw (bucketed) slab:
# a compressed batch must fit in min_ratio * rows * chunk_len or the whole
# batch ships raw. 0.875 is the PACK7 line — an all-printable batch always
# fits exactly, so "compression must beat raw by >= 12.5% or not bother"
COMPRESS_MIN_RATIO = 0.875

# filler bytes worth a run-of-8 token (0x80..0x87): zero pages / guard
# gaps / pack tails, then the common text/source fillers
RUN_BYTES = (0x00, 0x20, 0x0A, 0x09, 0x2D, 0x3D, 0x23, 0x2A)

# 120 static byte pairs (0x88..0xFF): English digraphs + source/config
# idiom. Static by design — a per-corpus dictionary would have to ship
# with every batch and flip dedup keys; this one is part of the codec.
_PAIRS = (
    "e ", " t", "th", "he", "s ", " a", "in", "er", "an", "re",
    "on", " s", "t ", "en", "at", "or", "es", " c", "it", "is",
    "te", "d ", "ar", "nd", " o", "al", " p", "st", "to", "nt",
    "ng", "se", "ha", "as", "ou", "io", "le", "o ", " m", " f",
    " w", "ve", "co", "me", "de", "hi", "ri", "ro", "ic", "ne",
    "ea", "ra", "ce", "li", "ch", "ll", " b", " d", "ma", "n ",
    "ti", "om", "ur", "r ", "la", "ed", "y ", "el", "ec", "un",
    " i", "no", "ns", "et", "il", "pe", "us", "na", "ss", "ni",
    "ol", "ot", "tr", "lo", "ac", "ca", "ut", "g ", "ly", "sa",
    "em", "po", "ke", "ey", "id", "ge", "ia", "so", "fo", "mo",
    "rt", "we", "ho", "wa", "pr", "ad", "ai", "di", "si", "ul",
    '="', '":', '",', "//", "--", "==", "()", "{}", "[]", ";\n",
)

_SENT = np.uint16(0xFFFF)  # suppressed slot in the token-stream layout


def _build_tables():
    """Static expansion/lookup tables shared by the encoder, the host
    reference decoder, and the device kernel (which closes over copies)."""
    assert len(RUN_BYTES) == 8 and len(_PAIRS) == 120
    tab_bytes = np.zeros((256, MAX_EXPANSION), dtype=np.uint8)
    tab_len = np.zeros(256, dtype=np.int32)
    for t in range(128):  # literals
        tab_bytes[t, 0] = t
        tab_len[t] = 1
    run_map = np.zeros(256, dtype=np.uint8)  # byte -> run token (0 = none)
    for i, b in enumerate(RUN_BYTES):
        tok = 0x80 + i
        tab_bytes[tok, :] = b
        tab_len[tok] = MAX_EXPANSION
        run_map[b] = tok
    pair_map = np.zeros(65536, dtype=np.uint8)  # (b0<<8)|b1 -> token
    for j, p in enumerate(_PAIRS):
        tok = 0x88 + j
        b0, b1 = ord(p[0]), ord(p[1])
        assert b0 < 0x80 and b1 < 0x80
        tab_bytes[tok, 0] = b0
        tab_bytes[tok, 1] = b1
        tab_len[tok] = 2
        pair_map[(b0 << 8) | b1] = tok
    return tab_bytes, tab_len, run_map, pair_map


@dataclass
class CompressedSlab:
    """One batch in wire form: a flat compressed buffer (bucketed to a
    compile-once rung) plus per-row framing. Rows past ``n_rows`` are
    bucket padding (``clen`` 0 → they decode to zero rows, exactly like
    raw-path pad rows). ``shape`` mirrors the raw batch the decompress
    stage expands to, so shape-keyed call sites need no special case."""

    buf: np.ndarray    # uint8 [wire_rung] — concatenated per-row streams
    offs: np.ndarray   # int32 [rows_pad] — row start offsets into buf
    clen: np.ndarray   # int32 [rows_pad] — per-row compressed length
    mode: np.ndarray   # uint8 [rows_pad] — MODE_RAW / MODE_PACK7 / MODE_TOKEN
    n_rows: int        # live rows (== len(batch meta))
    rows_pad: int      # bucketed row count
    chunk_len: int
    wire_bytes: int    # actual compressed payload (sum of clen)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.rows_pad, self.chunk_len)

    def frame_bytes(self) -> int:
        """Link bytes of the per-row framing arrays themselves."""
        return self.offs.nbytes + self.clen.nbytes + self.mode.nbytes

    def arrays(self) -> tuple[np.ndarray, ...]:
        return (self.buf, self.offs, self.clen, self.mode)


@dataclass
class _Plan:
    """Per-row encode decision for one slab (phase 1 of 2): everything
    needed to size the wire before any byte is written, so the raw
    fallback costs no stream build and no destination buffer."""

    rows: np.ndarray
    binary: np.ndarray   # bool [n] — binary-gated rows (ship RAW)
    is_run: np.ndarray   # bool [n, C/8] — all-equal runnable blocks
    ptok: np.ndarray     # uint8 [n, C/2] — pair token per even pair (0=none)
    clen: np.ndarray     # int64 [n] — chosen wire length per row
    mode: np.ndarray     # uint8 [n]

    def total(self) -> int:
        return int(self.clen.sum())


class SlabCodec:
    """Vectorized slab encoder + host reference decoder.

    One instance per scanner (the zero-cost-when-off bar: a scanner with
    compression off never builds these tables). ``chunk_len`` must be a
    multiple of 8 (PACK7 packs bit-exact octets; every shipped chunk_len
    is).
    """

    def __init__(self, chunk_len: int):
        if chunk_len % 8:
            raise ValueError(
                f"SlabCodec needs chunk_len % 8 == 0, got {chunk_len}"
            )
        self.chunk_len = chunk_len
        self.pack7_len = chunk_len * 7 // 8
        self.tab_bytes, self.tab_len, self.run_map, self.pair_map = (
            _build_tables()
        )

    # -- encode -----------------------------------------------------------

    def plan(self, rows: np.ndarray) -> _Plan:
        """Phase 1: pick a mode and wire length per row (no bytes moved).
        ``rows`` is the live [n, chunk_len] uint8 slab prefix."""
        n, C = rows.shape
        binary = (rows > 0x7F).any(axis=1)
        blocks = rows.reshape(n, C // 8, 8)
        first = blocks[:, :, 0]
        is_run = (blocks == first[:, :, None]).all(axis=2) & (
            self.run_map[first] != 0
        )
        pair = (rows[:, 0::2].astype(np.uint16) << 8) | rows[:, 1::2]
        ptok = self.pair_map[pair]  # [n, C/2]
        pair_len = np.where(ptok != 0, 1, 2).astype(np.int32)
        blk_len = np.where(
            is_run, 1, pair_len.reshape(n, C // 8, 4).sum(axis=2)
        )
        token_len = blk_len.sum(axis=1, dtype=np.int64)
        clen = np.where(
            binary, C, np.minimum(token_len, self.pack7_len)
        ).astype(np.int64)
        mode = np.where(
            binary,
            MODE_RAW,
            np.where(token_len < self.pack7_len, MODE_TOKEN, MODE_PACK7),
        ).astype(np.uint8)
        return _Plan(rows, binary, is_run, ptok, clen, mode)

    def emit(
        self, plan: _Plan, rows_pad: int, rung: int, out: np.ndarray
    ) -> CompressedSlab:
        """Phase 2: write every row's stream into ``out`` (a flat uint8
        buffer of >= ``rung`` bytes — the feeder hands a spare arena
        slab's flat view, so the wire stays in pinned, reused memory)
        and return the framed batch. ``rung`` is the compile-once wire
        bucket the caller picked (>= plan.total())."""
        rows = plan.rows
        n, C = rows.shape
        total = plan.total()
        if total > rung or rung > out.size:
            raise ValueError(
                f"wire rung {rung} cannot hold {total} bytes "
                f"(out buffer: {out.size})"
            )
        offs = np.zeros(rows_pad, dtype=np.int32)
        clen = np.zeros(rows_pad, dtype=np.int32)
        mode = np.zeros(rows_pad, dtype=np.uint8)
        clen[:n] = plan.clen
        mode[:n] = plan.mode
        offs[1 : n + 1 if n < rows_pad else n] = np.cumsum(plan.clen)[
            : rows_pad - 1 if n == rows_pad else n
        ]
        # (pad rows keep offs 0 / clen 0: they decode to zero rows)

        sel_p = np.nonzero(plan.mode == MODE_PACK7)[0]
        packed = self._pack7(rows[sel_p]) if len(sel_p) else None
        stream = self._token_streams(plan) if (plan.mode == MODE_TOKEN).any() else None
        for i in range(n):
            o, c = offs[i], clen[i]
            m = plan.mode[i]
            if m == MODE_RAW:
                out[o : o + C] = rows[i]
            elif m == MODE_PACK7:
                out[o : o + c] = packed[np.searchsorted(sel_p, i)]
            else:
                flat, keep = stream
                out[o : o + c] = flat[i][keep[i]].astype(np.uint8)
        return CompressedSlab(
            buf=out[:rung], offs=offs, clen=clen, mode=mode,
            n_rows=n, rows_pad=rows_pad, chunk_len=C, wire_bytes=total,
        )

    def _token_streams(self, plan: _Plan):
        """Slot layout for the TOKEN rows of a slab, fully vectorized:
        each even byte pair owns two uint16 slots — ``[pair_token, ✗]``
        or ``[lit0, lit1]`` — and a run block's first pair carries the
        run token with every other slot suppressed. The per-row stream
        is the unsuppressed slots in order (one boolean take per row)."""
        rows, ptok, is_run = plan.rows, plan.ptok, plan.is_run
        n, C = rows.shape
        e0 = np.where(ptok != 0, ptok.astype(np.uint16), rows[:, 0::2])
        e1 = np.where(ptok != 0, _SENT, rows[:, 1::2].astype(np.uint16))
        run_pair = np.repeat(is_run, 4, axis=1)  # [n, C/2]
        first_pair = np.zeros(C // 2, dtype=bool)
        first_pair[0::4] = True
        run_tok = np.repeat(
            self.run_map[rows[:, 0::8]], 4, axis=1
        ).astype(np.uint16)
        e0 = np.where(run_pair, np.where(first_pair, run_tok, _SENT), e0)
        e1 = np.where(run_pair, _SENT, e1)
        flat = np.stack([e0, e1], axis=2).reshape(n, C)
        return flat, flat != _SENT

    def _pack7(self, rows: np.ndarray) -> np.ndarray:
        """[m, C] printable rows -> [m, 7C/8]: drop every byte's MSB
        (guaranteed 0 by the binary gate) and repack big-endian."""
        m, C = rows.shape
        bits = np.unpackbits(rows, axis=1).reshape(m, C, 8)[:, :, 1:]
        return np.packbits(bits.reshape(m, C * 7), axis=1)

    # -- host reference decode --------------------------------------------

    def _unpack7(self, comp: np.ndarray) -> np.ndarray:
        C = self.chunk_len
        bits = np.unpackbits(comp)[: C * 7].reshape(C, 7)
        full = np.concatenate(
            [np.zeros((C, 1), dtype=np.uint8), bits], axis=1
        )
        return np.packbits(full, axis=1).ravel()

    def _untoken(self, comp: np.ndarray) -> np.ndarray:
        C = self.chunk_len
        lens = self.tab_len[comp]
        pos = np.cumsum(lens) - lens
        out = np.zeros(C + MAX_EXPANSION, dtype=np.uint8)
        for k in range(MAX_EXPANSION):
            sel = lens > k
            out[pos[sel] + k] = self.tab_bytes[comp[sel], k]
        return out[:C]

    def decode_rows(
        self, buf: np.ndarray, offs, clen, mode, n_rows: int | None = None
    ) -> np.ndarray:
        """Reference decoder: the pure-numpy mirror of the device kernel.
        Used by the retry ladder (a failed compressed batch re-dispatches
        as raw rows) and as the parity oracle in the codec fuzz tests."""
        rows_pad = len(offs)
        n = rows_pad if n_rows is None else n_rows
        out = np.zeros((rows_pad, self.chunk_len), dtype=np.uint8)
        for i in range(n):
            c = np.asarray(buf[offs[i] : offs[i] + clen[i]])
            if clen[i] == 0:
                continue
            if mode[i] == MODE_RAW:
                out[i, : len(c)] = c
            elif mode[i] == MODE_PACK7:
                out[i] = self._unpack7(c)
            else:
                out[i] = self._untoken(c)
        return out

    def decode_slab(self, cs: CompressedSlab) -> np.ndarray:
        return self.decode_rows(
            cs.buf, cs.offs, cs.clen, cs.mode, n_rows=cs.n_rows
        )
