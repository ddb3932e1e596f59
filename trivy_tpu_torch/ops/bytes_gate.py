"""Two-lane shingle gate on the license classifier's text rows.

The port of ``trivy_tpu/ops/ngram_score.py::build_bytes_gate_fn``. Each row
is read as its LUT image with separators replaced by a space (32), and bytes
past the row end read as spaces too. At every position ``i`` the 8-byte
window packs into two little-endian words ``wlo = sv[i..i+3]`` and ``whi =
sv[i+4..i+7]``:

- main lane: ``h8 = (wlo * MIX + whi * P2) >> (32 - SHINGLE_BITS)`` looked
  up in ``bloom8``, hits counted per 512-byte block;
- anchor lane: ``h4 = (wlo * MIX) >> (32 - SHINGLE_BITS)`` looked up in
  ``bloom4``, hits counted per row;

a window counts only when it starts on a word byte (LUT value non-zero), and
the third output counts those word bytes per row. On the card the gate is
the hand-written kernel ``csrc/bytes_gate.cu`` (``ops/bytes_gate_cuda.py``);
:func:`bytes_gate_plain` is its plain PyTorch version.
"""

from __future__ import annotations

import torch

from trivy_tpu_torch.ops.gram_gate import M32, lut_image, mul32, row_steps

SHINGLE_BITS = 22
SHINGLE_BLOCK = 512  # main-lane density block (divides every row width)
SHINGLE_MIX = 2654435761  # Knuth multiplicative hash
SHINGLE_P2 = 40503


def pack_windows(sv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(wlo, whi)``: the two little-endian words of the 8-byte window at
    every position of a ``[B, C]`` int64 space-substituted image, with the
    bytes past the row end read as spaces."""
    B, C = sv.shape
    p = torch.cat([sv, torch.full((B, 7), 32, dtype=sv.dtype, device=sv.device)], dim=1)

    def word(d: int) -> torch.Tensor:
        return (p[:, d : d + C] + (p[:, d + 1 : d + 1 + C] << 8)
                + (p[:, d + 2 : d + 2 + C] << 16) + (p[:, d + 3 : d + 3 + C] << 24))

    return word(0), word(4)


def bytes_gate_plain(rows: torch.Tensor, lut: torch.Tensor, bloom8: torch.Tensor,
                     bloom4: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``[B, C]`` uint8 rows -> ``(block_hits [B, C / 512] int32,
    anchor_hits [B] int32, word_bytes [B] int32)`` in plain PyTorch on the
    device of ``rows``; ``bloom8`` and ``bloom4`` are ``[2^SHINGLE_BITS]``
    uint8 masks."""
    B, C = rows.shape
    if C % SHINGLE_BLOCK:
        raise ValueError(f"row width {C} not a multiple of {SHINGLE_BLOCK}")
    dev = rows.device
    bloom8, bloom4 = bloom8.to(dev), bloom4.to(dev)
    shift = 32 - SHINGLE_BITS
    blk = torch.empty((B, C // SHINGLE_BLOCK), dtype=torch.int32, device=dev)
    ah = torch.empty(B, dtype=torch.int32, device=dev)
    nb = torch.empty(B, dtype=torch.int32, device=dev)
    for r0, x in row_steps(rows):
        n = x.shape[0]
        v = lut_image(x, lut)
        valid = v != 0
        wlo, whi = pack_windows(torch.where(valid, v, 32))
        h4 = mul32(wlo, SHINGLE_MIX)
        h8 = ((h4 + mul32(whi, SHINGLE_P2)) & M32) >> shift
        hit8 = (bloom8[h8] != 0) & valid
        blk[r0 : r0 + n] = hit8.view(n, C // SHINGLE_BLOCK, SHINGLE_BLOCK).sum(dim=2)
        ah[r0 : r0 + n] = ((bloom4[h4 >> shift] != 0) & valid).sum(dim=1)
        nb[r0 : r0 + n] = valid.sum(dim=1)
    return blk, ah, nb
