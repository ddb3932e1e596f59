"""License gram gate over the secret feed's resident rows, and the word and
gram hashing it shares with the raw-bytes license scorer.

The port of ``trivy_tpu/ops/gram_gate.py``. The license classifier hashes a
word as ``s0*P1 + s1*P2`` (``s0`` the sum of its LUT-lowered bytes, ``s1``
their sum weighted by the offset in the word) and folds five consecutive
words into a gram key ``k = k*HP + w``, all mod 2^64. That is ring
arithmetic, so its low 32 bits are the same formula computed mod 2^32 with
the constants' low 32 bits: the gate computes exactly that image from raw
row bytes, and the corpus side keeps ``keys64 & 0xFFFFFFFF``
(:func:`fold_low32`). Truncation collisions only add candidates.

:func:`gram_gate_plain` maps ``[B, C]`` uint8 rows to ``[B, C / block]``
uint8 block flags, one bit per lane: ``LANE_GRAM`` when a corpus gram key
starts in the block, ``LANE_ANCHOR`` when a short-phrase anchor word starts
in it, ``LANE_NONASCII`` when it holds a byte of 0x80 or above (the license
analyzer hashes UTF-8-decoded text, which diverges from the raw bytes
there). A block is flagged, as in the JAX package's boolean output, when any
bit is set; the lanes are kept apart so that a scan can count which one
flags its rows. Words are the runs of non-zero LUT values; a word that runs to
the row end is summed to the row end, and a gram counts only when all its
words start inside the row. On the card the gate is the hand-written kernel
``csrc/gram_gate.cu`` (``ops/gram_gate_cuda.py``); this module is its plain
PyTorch version.

PyTorch has little uint32 arithmetic, so every value here is an int64
holding a uint32: sums and products are masked to 32 bits, and products
with a 32-bit constant go through :func:`mul32`, which never leaves int64.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF

# output block width: small enough that packed-row segments resolve to
# their own blocks, large enough that the output stays tiny ([B, C/256])
GATE_BLOCK = 256
# the bits of a block flag
LANE_GRAM, LANE_ANCHOR, LANE_NONASCII = 1, 2, 4
# rows per step of the plain versions: bounds their int64 intermediates
PLAIN_ELEMS = 1 << 22
# the CUDA gate's membership prescreen: a 2^SCREEN_BITS-bit set holding, for
# every gate key k, bits k >> (32 - SCREEN_BITS) and
# (k * SCREEN_MUL mod 2^32) >> (32 - SCREEN_BITS)
SCREEN_BITS = 18
SCREEN_MUL = 0x9E3779B1
DIR_BITS = 12  # the CUDA kernels' directories of their key tables, by top bits


def gate_block(chunk_len: int) -> int:
    """Largest power-of-two block <= GATE_BLOCK dividing ``chunk_len``
    (degenerates to row-level for odd row shapes)."""
    b = GATE_BLOCK
    while b > 1 and chunk_len % b:
        b //= 2
    return b if chunk_len % b == 0 else chunk_len


def fold_low32(keys64: np.ndarray) -> np.ndarray:
    """Corpus-side key fold: low 32 bits of the int64 hash domain, sorted
    unique, as uint32 (the ring-homomorphic image the gate computes)."""
    k = np.asarray(keys64, dtype=np.int64).astype(np.uint64) & np.uint64(M32)
    return np.unique(k.astype(np.uint32))


def screen_index(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The two prescreen bit indices of each uint32 key."""
    k = np.asarray(keys, dtype=np.uint32)
    with np.errstate(over="ignore"):
        shift = np.uint32(32 - SCREEN_BITS)
        return k >> shift, (k * np.uint32(SCREEN_MUL)) >> shift


def screen_bits(gate32: np.ndarray) -> np.ndarray:
    """The prescreen bitset of the gate keys, ``[2^SCREEN_BITS / 32]`` uint32
    words (bit ``i`` is bit ``i % 32`` of word ``i // 32``)."""
    words = np.zeros((1 << SCREEN_BITS) // 32, dtype=np.uint32)
    for idx in screen_index(gate32):
        np.bitwise_or.at(words, idx >> 5, np.uint32(1) << (idx & np.uint32(31)))
    return words


def key_directory(keys32: np.ndarray) -> np.ndarray:
    """``[2^DIR_BITS + 1]`` uint32: entry ``b`` is the index of the first
    key of the sorted ``keys32`` whose top ``DIR_BITS`` bits are ``b`` or
    more (the last entry is the table's length). The CUDA kernels search a
    key only in its run ``[dir[b], dir[b + 1])``."""
    bounds = np.arange((1 << DIR_BITS) + 1, dtype=np.uint64) << np.uint64(32 - DIR_BITS)
    return np.searchsorted(np.asarray(keys32, np.uint64), bounds).astype(np.uint32)


def screen_pass(words: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """Whether each uint32 key passes the prescreen ``words``: both its bits
    set (every gate key passes; a key that fails is not a gate key)."""
    a, b = screen_index(keys)
    w = np.asarray(words, dtype=np.uint32)
    one = np.uint32(1)
    return (((w[a >> 5] >> (a & 31)) & (w[b >> 5] >> (b & 31)) & one) == one)


def u32(v: int) -> int:
    """Low 32 bits of an int64 constant, as a non-negative int."""
    return int(v) & M32


def mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """``a * b mod 2^32`` for int64 ``a`` in [0, 2^32) and a constant ``b``
    in [0, 2^32): ``b`` is split into 16-bit halves so that no product
    leaves int64."""
    lo, hi = b & 0xFFFF, b >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & M32


def _rev_cummin(x: torch.Tensor) -> torch.Tensor:
    """Running minimum from the right along dim 1."""
    return torch.cummin(x.flip(1), dim=1).values.flip(1)


def lut_image(rows: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """``[B, C]`` uint8 rows -> their int64 LUT values (separators 0)."""
    return lut.to(rows.device)[rows.long()]


def word_hashes(vals: torch.Tensor, p1: int, p2: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(starts, H)`` of a ``[B, C]`` int64 LUT image: ``starts`` marks the
    first byte of each word, and ``H`` there holds the word's hash mod 2^32
    (the word summed to the next separator, or to the row end)."""
    B, C = vals.shape
    nz = vals != 0
    prev = torch.zeros_like(nz)
    prev[:, 1:] = nz[:, :-1]
    starts = nz & ~prev
    idx = torch.arange(C, device=vals.device)
    nsep = _rev_cummin(torch.where(nz, C, idx))  # next separator at or after i
    zero = torch.zeros((B, 1), dtype=torch.int64, device=vals.device)
    pref0 = torch.cat([zero, torch.cumsum(vals, dim=1)], dim=1)
    pref1 = torch.cat([zero, torch.cumsum(vals * idx, dim=1)], dim=1)
    # exact (no wrap) below 2^40 for rows of up to 64 KiB
    s0 = torch.gather(pref0, 1, nsep) - pref0[:, :C]
    s1 = torch.gather(pref1, 1, nsep) - pref1[:, :C] - idx * s0
    H = (mul32(s0 & M32, u32(p1)) + mul32(s1 & M32, u32(p2))) & M32
    return starts, H


def gram_keys(starts: torch.Tensor, H: torch.Tensor, hash_p: int,
              ngram: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(key, valid)``: at each word start, the key of the ``ngram``-word
    gram that starts there, valid when all its words start inside the row."""
    B, C = H.shape
    dev = H.device
    idx = torch.arange(C, device=dev)
    nxt = _rev_cummin(torch.where(starts, idx, C))
    big = torch.full((B, 2), C, dtype=torch.int64, device=dev)
    ns_pad = torch.cat([nxt[:, 1:], big], dim=1)  # next start after i; [C] -> C
    H_pad = torch.cat([H, torch.zeros((B, 1), dtype=torch.int64, device=dev)], dim=1)
    key = H
    p = idx.expand(B, C)
    hp = u32(hash_p)
    for _ in range(ngram - 1):
        p = torch.gather(ns_pad, 1, p)
        key = (mul32(key, hp) + torch.gather(H_pad, 1, p)) & M32
    return key, starts & (p < C)


def member(table: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Elementwise membership of int64 values in a sorted int64 table."""
    if table.numel() == 0:
        return torch.zeros_like(v, dtype=torch.bool)
    pos = torch.searchsorted(table, v.contiguous()).clamp_(max=table.numel() - 1)
    return table[pos] == v


def row_steps(rows: torch.Tensor):
    """Row slices of at most ``PLAIN_ELEMS`` bytes (at least one row)."""
    step = max(1, PLAIN_ELEMS // max(1, rows.shape[1]))
    for r0 in range(0, rows.shape[0], step):
        yield r0, rows[r0 : r0 + step]


def gram_gate_plain(rows: torch.Tensor, lut: torch.Tensor, gate: torch.Tensor,
                    anchor: torch.Tensor, p1: int, p2: int, hash_p: int,
                    block: int, ngram: int = 5) -> torch.Tensor:
    """``[B, C]`` uint8 rows -> ``[B, C / block]`` uint8 block flags (lane
    bits), in plain PyTorch on the device of ``rows``. ``lut`` is the
    ``[256]`` int64 LUT image (low 32 bits), ``gate`` and ``anchor`` sorted
    int64 tables of uint32 keys."""
    B, C = rows.shape
    dev = rows.device
    gate, anchor = gate.to(dev), anchor.to(dev)
    out = torch.zeros((B, C // block), dtype=torch.uint8, device=dev)
    for r0, x in row_steps(rows):
        starts, H = word_hashes(lut_image(x, lut), p1, p2)
        key, valid = gram_keys(starts, H, hash_p, ngram)
        lanes = ((LANE_GRAM, member(gate, key) & valid), (LANE_ANCHOR, member(anchor, H) & starts),
                 (LANE_NONASCII, x >= 128))
        for bit, hit in lanes:
            blocks = hit.view(x.shape[0], C // block, block).any(dim=2)
            out[r0 : r0 + x.shape[0]] |= blocks.to(torch.uint8) * bit
    return out


def build_gram_gate_fn(chunk_len: int, lut: np.ndarray, gate_keys64: np.ndarray,
                       anchor_keys64: np.ndarray, p1: int, p2: int, hash_p: int,
                       ngram: int = 5, device="cuda"):
    """The gate for rows of ``chunk_len`` bytes with its tables resident on
    ``device``: a callable ``[B, chunk_len] uint8 -> [B, chunk_len / block]
    uint8`` lane bits (``fn.block`` is the block width) that launches
    ``csrc/gram_gate.cu`` for CUDA rows and runs :func:`gram_gate_plain`
    for CPU rows."""
    from trivy_tpu_torch.ops.gram_gate_cuda import CudaGramGate

    return CudaGramGate(chunk_len, lut, fold_low32(gate_keys64),
                        fold_low32(anchor_keys64) if len(anchor_keys64) else np.zeros(0, np.uint32),
                        p1, p2, hash_p, ngram, device)
