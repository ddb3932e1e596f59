"""The license classifier's shingle gate as a hand-written CUDA kernel.

Replaces the JAX package's device computation
``trivy_tpu/ops/ngram_score.py::build_bytes_gate_fn`` with
``csrc/bytes_gate.cu`` (one thread block per 512-byte block of a row; see
the source for the design). This module keeps the LUT and the two blooms
resident on the card (the blooms as 512 KiB bitsets: the function is the
same) and launches the kernel. The function computed is that of
:func:`trivy_tpu_torch.ops.bytes_gate.bytes_gate_plain`.

A gate called with a CUDA tensor launches the kernel (or raises); with a CPU
tensor it runs ``bytes_gate_plain``; any other device raises.
"""

from __future__ import annotations

import numpy as np
import torch

from trivy_tpu_torch.device import resolve
from trivy_tpu_torch.ops import _build
from trivy_tpu_torch.ops.bytes_gate import SHINGLE_BITS, SHINGLE_BLOCK, bytes_gate_plain
from trivy_tpu_torch.ops.gram_gate_cuda import check_rows, launch_error, lut32, on_card
from trivy_tpu_torch.ops.match_cuda import LAUNCH_SHAPES, LAUNCHES

# the key this kernel's launches are counted under in match_cuda.LAUNCHES
NAME = "bytes_gate"


def bitset(bloom: np.ndarray) -> np.ndarray:
    """A ``[2^SHINGLE_BITS]`` uint8 mask as a uint32 bitset: bit ``h & 31``
    of word ``h >> 5`` is set when ``bloom[h]`` is non-zero."""
    bloom = np.asarray(bloom)
    if bloom.shape != (1 << SHINGLE_BITS,):
        raise ValueError(f"bloom must hold 2^{SHINGLE_BITS} slots, got {bloom.shape}")
    return np.packbits(bloom != 0, bitorder="little").view("<u4").astype(np.uint32)


class CudaBytesGate:
    """``[B, C] uint8 -> (block_hits [B, C/512] i32, anchor_hits [B] i32,
    word_bytes [B] i32)``: the CUDA kernel on the card,
    :func:`bytes_gate_plain` on the CPU."""

    def __init__(self, lut: np.ndarray, bloom8: np.ndarray, bloom4: np.ndarray, device):
        self.device = resolve(device)
        lut = lut32(lut)
        self.lut = torch.from_numpy(lut.astype(np.int64)).to(self.device)
        self.bloom8 = torch.from_numpy(np.asarray(bloom8, dtype=np.uint8)).to(self.device)
        self.bloom4 = torch.from_numpy(np.asarray(bloom4, dtype=np.uint8)).to(self.device)
        if self.device.type == "cuda":
            self._k = (on_card(lut, self.device), on_card(bitset(bloom8), self.device),
                       on_card(bitset(bloom4), self.device))

    def __call__(self, rows: torch.Tensor):
        check_rows(rows)
        dev = rows.device
        if dev.type == "cpu":
            return bytes_gate_plain(rows, self.lut, self.bloom8, self.bloom4)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        if dev != self.device:
            raise ValueError(f"rows on {dev}, gate tables on {self.device}")
        B, C = rows.shape
        if C % SHINGLE_BLOCK:
            raise ValueError(f"row width {C} not a multiple of {SHINGLE_BLOCK}")
        blk = torch.empty((B, C // SHINGLE_BLOCK), dtype=torch.int32, device=dev)
        ah = torch.zeros(B, dtype=torch.int32, device=dev)
        nb = torch.zeros(B, dtype=torch.int32, device=dev)
        if B == 0:
            return blk, ah, nb
        lut, b8, b4 = self._k
        lib = _build.load("bytes_gate")
        with torch.cuda.device(dev):
            rc = lib.trivy_bytes_gate_launch(
                rows.data_ptr(), B, C, lut.data_ptr(), b8.data_ptr(), b4.data_ptr(),
                blk.data_ptr(), ah.data_ptr(), nb.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream,
            )
        if rc != 0:
            raise launch_error(lib, rc, "bytes gate")
        LAUNCHES[NAME] += 1
        LAUNCH_SHAPES[NAME, B, C] += 1
        return blk, ah, nb
