"""The license gram gate as a hand-written CUDA kernel.

Replaces the JAX package's device computation
``trivy_tpu/ops/gram_gate.py::build_byte_gate_fn`` with
``csrc/gram_gate.cu`` (one thread block per row; see the source for the
design). This module keeps the LUT, the two key tables, the gate keys'
prescreen bitset (:func:`~trivy_tpu_torch.ops.gram_gate.screen_bits`) and
the gate table's directory
(:func:`~trivy_tpu_torch.ops.gram_gate.key_directory`), both built once
here, resident on the card and launches the kernel. The function computed is that of
:func:`trivy_tpu_torch.ops.gram_gate.gram_gate_plain`.

A gate called with a CUDA tensor launches the kernel (or raises); with a CPU
tensor it runs ``gram_gate_plain``; any other device raises. There is no
fallback from one to the other.
"""

from __future__ import annotations

import numpy as np
import torch

from trivy_tpu_torch.device import resolve
from trivy_tpu_torch.ops import _build
from trivy_tpu_torch.ops.gram_gate import (
    M32, gate_block, key_directory, gram_gate_plain, screen_bits, u32,
)
from trivy_tpu_torch.ops.match_cuda import LAUNCHES

# the key this kernel's launches are counted under in match_cuda.LAUNCHES
NAME = "gram_gate"
MAX_ROW = 1 << 16  # word starts are kept as 16-bit offsets


def lut32(lut: np.ndarray) -> np.ndarray:
    """The classifier's int64 byte LUT folded to uint32. Every value fits a
    byte (the kernels keep the lowered row as bytes); raises otherwise."""
    out = (np.asarray(lut, dtype=np.int64).astype(np.uint64) & np.uint64(M32)).astype(np.uint32)
    if out.shape != (256,) or int(out.max()) > 255:
        raise ValueError("the byte LUT must map 256 bytes to values below 256")
    return out


def on_card(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A uint32 array on ``dev`` as int32 bits (what the kernels read)."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)).to(dev)


def check_rows(rows: torch.Tensor, width: int | None = None) -> None:
    if rows.dtype != torch.uint8 or rows.dim() != 2 or not rows.is_contiguous():
        raise ValueError(f"rows must be a contiguous 2-D uint8 tensor, got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    if width is not None and rows.shape[1] != width:
        raise ValueError(f"rows are {rows.shape[1]} bytes wide, the kernel was built for {width}")


def launch_error(lib, rc: int, what: str) -> _build.KernelError:
    return _build.KernelError(f"{what} kernel launch failed: "
                              f"{lib.trivy_cuda_error_string(rc).decode()} ({rc})")


class CudaGramGate:
    """``[B, C] uint8 -> [B, C / block] uint8`` lane bits (``LANE_*`` of
    :mod:`trivy_tpu_torch.ops.gram_gate`): the CUDA kernel on the card,
    :func:`gram_gate_plain` on the CPU."""

    def __init__(self, chunk_len: int, lut: np.ndarray, gate32: np.ndarray,
                 anchor32: np.ndarray, p1: int, p2: int, hash_p: int, ngram: int, device):
        if not 0 < chunk_len <= MAX_ROW:
            raise ValueError(f"chunk_len must be in (0, {MAX_ROW}], got {chunk_len}")
        self.chunk_len = chunk_len
        self.block = gate_block(chunk_len)
        self.device = resolve(device)
        if self.device.type == "cuda":
            _build.preload("gram_gate")  # a kernel that cannot load fails here
        self.p1, self.p2, self.hash_p, self.ngram = u32(p1), u32(p2), u32(hash_p), int(ngram)
        lut = lut32(lut)
        gate32 = np.asarray(gate32, dtype=np.uint32)
        anchor32 = np.asarray(anchor32, dtype=np.uint32)
        # plain forms (int64 values) and, on the card, the kernel's uint32 forms
        self.lut = torch.from_numpy(lut.astype(np.int64)).to(self.device)
        self.gate = torch.from_numpy(gate32.astype(np.int64)).to(self.device)
        self.anchor = torch.from_numpy(anchor32.astype(np.int64)).to(self.device)
        if self.device.type == "cuda":
            self._k = tuple(on_card(a, self.device) for a in (
                lut, gate32, anchor32, screen_bits(gate32), key_directory(gate32)))

    def __call__(self, rows: torch.Tensor) -> torch.Tensor:
        check_rows(rows, self.chunk_len)
        dev = rows.device
        if dev.type == "cpu":
            return gram_gate_plain(rows, self.lut, self.gate, self.anchor, self.p1, self.p2,
                                   self.hash_p, self.block, self.ngram)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        if dev != self.device:
            raise ValueError(f"rows on {dev}, gate tables on {self.device}")
        B, C = rows.shape
        out = torch.zeros((B, C // self.block), dtype=torch.uint8, device=dev)
        if B == 0:
            return out
        lut, gate, anchor, screen, directory = self._k
        lib = _build.load("gram_gate")
        with torch.cuda.device(dev):
            rc = lib.trivy_gram_gate_launch(
                rows.data_ptr(), B, C, self.block, lut.data_ptr(), gate.data_ptr(),
                gate.numel(), anchor.data_ptr(), anchor.numel(), screen.data_ptr(),
                directory.data_ptr(), self.p1, self.p2, self.hash_p, self.ngram, out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream,
            )
        if rc != 0:
            raise launch_error(lib, rc, "gram gate")
        LAUNCHES[NAME] += 1
        return out
