"""Slab decompressor: expand a compressed wire frame into the raw ``[B, C]``
uint8 batch the prefilter and matcher read.

Host half (format, gate, encoder, reference decoder):
``trivy_tpu_torch/secret/compress.py``. On the card the decoder is the
hand-written kernel ``csrc/decompress.cu`` (``ops/decompress_cuda.py``);
:func:`decompress_plain` is its plain PyTorch version, a row-batched
transcription of the JAX package's ``trivy_tpu/ops/decompress.py``.

Per row ``i`` the decoder sees ``(buf, offs[i], clen[i], mode[i])`` and
produces ``out[i, :C]``. Stream byte ``j`` is ``buf[clip(offs[i] + j, 0,
W - 1)]`` when ``j < clen[i]`` and 0 otherwise; then:

- **RAW** (and any mode other than PACK7 and TOKEN): the stream is the row.
- **PACK7**: output byte ``j`` is bits ``[7j, 7j + 7)`` of the stream,
  read from the big-endian 16-bit window at ``p = 7j >> 3``.
- **TOKEN**: token ``k`` expands to ``tab_bytes[tok, :tab_len[tok]]`` at
  the exclusive prefix sum of the lengths before it; bytes at or past ``C``
  are dropped.

Rows with ``clen == 0`` (bucket padding) decode to zero rows, which is what
the raw path ships for padding.
"""

from __future__ import annotations

import numpy as np
import torch

from trivy_tpu_torch.secret.compress import MAX_EXPANSION, MODE_PACK7, MODE_TOKEN

__all__ = ["build_decompress_fn", "decompress_plain"]


def decompress_plain(tab_bytes: torch.Tensor, tab_len: torch.Tensor, buf: torch.Tensor,
                     offs: torch.Tensor, clen: torch.Tensor, mode: torch.Tensor,
                     chunk_len: int) -> torch.Tensor:
    """``(buf [W] u8, offs [B] i32, clen [B] i32, mode [B] u8) -> [B, C]
    u8`` in plain PyTorch, on the device of ``buf``. ``tab_bytes``
    (``[256, MAX_EXPANSION]`` uint8) and ``tab_len`` (``[256]`` int32) are
    the TOKEN expansion tables of the codec."""
    C = chunk_len
    dev = buf.device
    B = offs.shape[0]
    W = buf.shape[0]
    j = torch.arange(C, device=dev, dtype=torch.int64)
    in_row = j[None, :] < clen.to(torch.int64)[:, None]  # [B, C]
    idx = (offs.to(torch.int64)[:, None] + j[None, :]).clamp_(0, W - 1)
    cb = torch.where(in_row, buf[idx], torch.zeros((), dtype=torch.uint8, device=dev))

    # PACK7: output byte j = bits [7j, 7j+7) of the stream, big-endian
    t0 = 7 * j
    p = t0 >> 3
    o = t0 & 7
    cb16 = cb.to(torch.int32)
    nxt = torch.where(p + 1 < C, cb16[:, (p + 1).clamp(max=C - 1)], 0)
    word = cb16[:, p] * 256 + nxt
    pack7 = ((word >> (16 - 7 - o)) & 0x7F).to(torch.uint8)

    # TOKEN: lengths -> exclusive prefix sum -> one scatter per expansion
    # byte; column C is a spill slot for lanes that write nothing, cut below
    tl = tab_len.to(device=dev, dtype=torch.int64)
    tb = tab_bytes.to(device=dev)
    tok = cb.to(torch.int64)
    lens = torch.where(in_row, tl[tok], 0)
    pos = torch.cumsum(lens, dim=1) - lens
    token = torch.zeros((B, C + 1), dtype=torch.uint8, device=dev)
    for k in range(MAX_EXPANSION):
        valid = (lens > k) & (pos + k < C)
        token.scatter_(1, torch.where(valid, pos + k, C), torch.where(valid, tb[tok, k], 0))
    token = token[:, :C]

    mode = mode.to(device=dev)[:, None]
    return torch.where(mode == MODE_TOKEN, token, torch.where(mode == MODE_PACK7, pack7, cb))


def build_decompress_fn(chunk_len: int, tab_bytes: np.ndarray, tab_len: np.ndarray,
                        device="cuda"):
    """The decompressor for rows of ``chunk_len`` bytes, its tables resident
    on ``device``: a callable ``(buf, offs, clen, mode) -> [B, C] uint8``
    that launches ``csrc/decompress.cu`` for CUDA tensors and runs
    :func:`decompress_plain` for CPU tensors."""
    from trivy_tpu_torch.ops.decompress_cuda import CudaDecompressor

    return CudaDecompressor(chunk_len, tab_bytes, tab_len, device)
