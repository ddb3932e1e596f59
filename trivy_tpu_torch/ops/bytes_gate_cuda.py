"""The license classifier's shingle gate as a hand-written CUDA kernel.

Replaces the JAX package's device computation
``trivy_tpu/ops/ngram_score.py::build_bytes_gate_fn`` with
``csrc/bytes_gate.cu`` (one launch per dispatch: a block per 8 KiB tile,
screens in shared memory ahead of the bitsets; see the source for the
design). This module keeps the LUT, the two blooms (as 512 KiB
bitsets: the function is the same) and their folded screens resident on
the card, holds the scratch the kernel sums split rows in, and launches the
kernel. The function computed is that of
:func:`trivy_tpu_torch.ops.bytes_gate.bytes_gate_plain`.

A gate called with a CUDA tensor launches the kernel (or raises); with a CPU
tensor it runs ``bytes_gate_plain``; any other device raises.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from trivy_tpu_torch.device import resolve
from trivy_tpu_torch.ops import _build
from trivy_tpu_torch.ops.bytes_gate import SHINGLE_BITS, SHINGLE_BLOCK, bytes_gate_plain
from trivy_tpu_torch.ops.gram_gate_cuda import check_rows, launch_error, lut32, on_card
from trivy_tpu_torch.ops.match_cuda import LAUNCH_SHAPES, LAUNCHES

# the key this kernel's launches are counted under in match_cuda.LAUNCHES
NAME = "bytes_gate"
# log2 of the bits of the screens the kernel reads ahead of each bitset.
# On the H100 the smallest bloom4 screen was the fastest at every rung, and
# a bloom8 screen of 2^18 bits cost license rows nothing and took a third
# off source rows (``tools/kernel_study.py bytes-gate``)
SCREEN4_BITS = 15
SCREEN8_BITS = 18


def bitset(bloom: np.ndarray) -> np.ndarray:
    """A ``[2^SHINGLE_BITS]`` uint8 mask as a uint32 bitset: bit ``h & 31``
    of word ``h >> 5`` is set when ``bloom[h]`` is non-zero."""
    bloom = np.asarray(bloom)
    if bloom.shape != (1 << SHINGLE_BITS,):
        raise ValueError(f"bloom must hold 2^{SHINGLE_BITS} slots, got {bloom.shape}")
    return np.packbits(bloom != 0, bitorder="little").view("<u4").astype(np.uint32)


def fold(bloom: np.ndarray, bits: int) -> np.ndarray:
    """The ``2^bits``-bit screen of a ``[2^SHINGLE_BITS]`` uint8 mask, as a
    uint32 bitset: screen bit ``j`` is the OR of the mask's slots ``h`` with
    ``h >> (SHINGLE_BITS - bits) == j``, so no set slot is screened out."""
    bloom = np.asarray(bloom)
    if bloom.shape != (1 << SHINGLE_BITS,) or not 7 <= bits <= SHINGLE_BITS:
        raise ValueError(f"cannot fold {bloom.shape} slots into 2^{bits} bits")
    hit = (bloom.reshape(1 << bits, -1) != 0).any(axis=1)
    return np.packbits(hit, bitorder="little").view("<u4").astype(np.uint32)


class CudaBytesGate:
    """``[B, C] uint8 -> (block_hits [B, C/512] i32, anchor_hits [B] i32,
    word_bytes [B] i32)``: the CUDA kernel on the card,
    :func:`bytes_gate_plain` on the CPU."""

    def __init__(self, lut: np.ndarray, bloom8: np.ndarray, bloom4: np.ndarray, device):
        self.device = resolve(device)
        if self.device.type == "cuda":
            _build.preload("bytes_gate")  # a kernel that cannot load fails here
        lut = lut32(lut)
        self.lut = torch.from_numpy(lut.astype(np.int64)).to(self.device)
        self.bloom8 = torch.from_numpy(np.asarray(bloom8, dtype=np.uint8)).to(self.device)
        self.bloom4 = torch.from_numpy(np.asarray(bloom4, dtype=np.uint8)).to(self.device)
        if self.device.type == "cuda":
            self._k = (on_card(lut, self.device), on_card(bitset(bloom8), self.device),
                       on_card(bitset(bloom4), self.device),
                       on_card(fold(bloom4, SCREEN4_BITS), self.device),
                       on_card(fold(bloom8, SCREEN8_BITS), self.device))
        self._smem: int | None = None  # shared memory per block, from the first launch
        # per stream: the split rows' partials and the last-block ticket
        self._scratch: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        self._lock = threading.Lock()

    def smem(self) -> int:
        """The kernel's dynamic shared memory per block (the device is
        prepared for it on the first call)."""
        if self._smem is None:
            smem = ctypes.c_int()
            lib = _build.load("bytes_gate")
            with torch.cuda.device(self.device):
                rc = lib.trivy_bytes_gate_smem(SCREEN4_BITS, SCREEN8_BITS, smem)
            if rc != 0:
                raise launch_error(lib, rc, "bytes gate")
            self._smem = smem.value
        return self._smem

    def scratch(self, stream: torch.cuda.Stream, blocks: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The stream's scratch with room for ``blocks`` density blocks: the
        ticket is zeroed once, when the stream first launches; the kernel
        leaves it 0."""
        with self._lock:
            part, ticket = self._scratch.get(stream.cuda_stream, (None, None))
            if ticket is None:
                ticket = torch.zeros(1, dtype=torch.int32, device=self.device)
            if part is None or part.numel() < 2 * blocks:
                part = torch.empty(2 * blocks, dtype=torch.int32, device=self.device)
            self._scratch[stream.cuda_stream] = (part, ticket)
            return part, ticket

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
        if C == 0 or C % SHINGLE_BLOCK:
            raise ValueError(f"row width {C} not a positive multiple of {SHINGLE_BLOCK}")
        if B * (C // SHINGLE_BLOCK) >= 1 << 31:
            raise ValueError(f"{B} rows of {C} bytes: too many blocks for one launch")
        blk = torch.empty((B, C // SHINGLE_BLOCK), dtype=torch.int32, device=dev)
        ah = torch.empty(B, dtype=torch.int32, device=dev)
        nb = torch.empty(B, dtype=torch.int32, device=dev)
        if B == 0:
            return blk, ah, nb
        lut, b8, b4, s4, s8 = self._k
        smem = self.smem()
        stream = torch.cuda.current_stream(dev)
        part, ticket = self.scratch(stream, B * (C // SHINGLE_BLOCK))
        lib = _build.load("bytes_gate")
        with torch.cuda.device(dev):
            rc = lib.trivy_bytes_gate_launch(
                rows.data_ptr(), B, C, lut.data_ptr(), b8.data_ptr(), b4.data_ptr(),
                s4.data_ptr(), SCREEN4_BITS, s8.data_ptr(), SCREEN8_BITS, blk.data_ptr(),
                ah.data_ptr(), nb.data_ptr(), part.data_ptr(), ticket.data_ptr(), smem,
                stream.cuda_stream,
            )
        if rc != 0:
            raise launch_error(lib, rc, "bytes gate")
        LAUNCHES[NAME] += 1
        LAUNCH_SHAPES[NAME, B, C] += 1
        return blk, ah, nb
