"""The slab decompressor as a hand-written CUDA kernel.

Replaces the JAX package's device computation
``trivy_tpu/ops/decompress.py::build_decompress_fn`` with
``csrc/decompress.cu`` (a persistent grid that stages each row's stream in
16-byte pieces while it expands the row before; see the source for the
design). This module keeps the codec's TOKEN tables resident on the card,
checks the frame it is given and launches the kernel. The function computed
is that of :func:`trivy_tpu_torch.ops.decompress.decompress_plain`.

A decompressor called with CUDA tensors launches the kernel (or raises);
with CPU tensors it runs ``decompress_plain``; any other device raises.
There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from trivy_tpu_torch.device import resolve
from trivy_tpu_torch.ops import _build
from trivy_tpu_torch.ops.decompress import decompress_plain
from trivy_tpu_torch.ops.match_cuda import LAUNCHES
from trivy_tpu_torch.secret.compress import MAX_EXPANSION

# the key this kernel's launches are counted under in match_cuda.LAUNCHES
NAME = "decompress"


class CudaDecompressor:
    """``(buf [W] u8, offs [B] i32, clen [B] i32, mode [B] u8) -> [B, C]
    u8``: the CUDA kernel on the card, :func:`decompress_plain` on the
    CPU."""

    def __init__(self, chunk_len: int, tab_bytes: np.ndarray, tab_len: np.ndarray, device):
        if chunk_len <= 0 or chunk_len % 8:
            raise ValueError(f"chunk_len must be a positive multiple of 8, got {chunk_len}")
        tab_bytes = np.ascontiguousarray(tab_bytes, dtype=np.uint8)
        tab_len = np.ascontiguousarray(tab_len, dtype=np.int32)
        if tab_bytes.shape != (256, MAX_EXPANSION) or tab_len.shape != (256,):
            raise ValueError(
                f"tables must be [256, {MAX_EXPANSION}] and [256], got "
                f"{tab_bytes.shape} and {tab_len.shape}")
        if tab_len.min() < 0 or tab_len.max() > MAX_EXPANSION:
            raise ValueError(f"tab_len must lie in [0, {MAX_EXPANSION}]")
        self.chunk_len = chunk_len
        self.device = resolve(device)
        if self.device.type == "cuda":
            _build.preload(NAME)  # a kernel that cannot load fails here
        self.tab_bytes = torch.from_numpy(tab_bytes).to(self.device)
        self.tab_len = torch.from_numpy(tab_len).to(self.device)
        self._plan: tuple[int, int] | None = None  # (grid, smem), from the first launch

    def plan(self) -> tuple[int, int]:
        """(blocks resident on the card at once, dynamic shared memory of
        each): the kernel's grid is this, capped by the rows."""
        if self._plan is None:
            grid, smem = ctypes.c_int(), ctypes.c_int()
            lib = _build.load("decompress")
            with torch.cuda.device(self.device):
                rc = lib.trivy_decompress_grid(self.chunk_len, grid, smem)
            if rc != 0:
                msg = lib.trivy_cuda_error_string(rc).decode()
                raise _build.KernelError(f"decompress kernel launch failed: {msg} ({rc})")
            self._plan = (grid.value, smem.value)
        return self._plan

    def __call__(self, buf: torch.Tensor, offs: torch.Tensor, clen: torch.Tensor,
                 mode: torch.Tensor) -> torch.Tensor:
        self._check(buf, offs, clen, mode)
        dev = buf.device
        if dev.type == "cpu":
            return decompress_plain(self.tab_bytes, self.tab_len, buf, offs, clen, mode,
                                    self.chunk_len)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        if dev != self.device:
            raise ValueError(f"frame on {dev}, decompressor tables on {self.device}")
        B, C = offs.shape[0], self.chunk_len
        out = torch.empty((B, C), dtype=torch.uint8, device=dev)
        if B == 0:
            return out
        grid, smem = self.plan()
        lib = _build.load("decompress")
        with torch.cuda.device(dev):  # the kernel runs on the current device
            rc = lib.trivy_decompress_launch(
                buf.data_ptr(), buf.numel(), offs.data_ptr(), clen.data_ptr(), mode.data_ptr(),
                B, C, self.tab_bytes.data_ptr(), self.tab_len.data_ptr(), out.data_ptr(),
                grid, smem, torch.cuda.current_stream(dev).cuda_stream,
            )
        if rc != 0:
            msg = lib.trivy_cuda_error_string(rc).decode()
            raise _build.KernelError(f"decompress kernel launch failed: {msg} ({rc})")
        LAUNCHES[NAME] += 1
        return out

    @staticmethod
    def _check(buf, offs, clen, mode) -> None:
        for name, t, dtype in (("buf", buf, torch.uint8), ("offs", offs, torch.int32),
                               ("clen", clen, torch.int32), ("mode", mode, torch.uint8)):
            if t.dtype != dtype or t.dim() != 1:
                raise ValueError(f"{name} must be 1-D {dtype}, got {t.dtype} {tuple(t.shape)}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
            if t.device != buf.device:
                raise ValueError(f"{name} on {t.device}, buf on {buf.device}")
        if buf.numel() == 0:
            raise ValueError("buf is empty")
        if not offs.shape[0] == clen.shape[0] == mode.shape[0]:
            raise ValueError(
                f"offs, clen and mode differ in length: {offs.shape[0]}, {clen.shape[0]}, "
                f"{mode.shape[0]}")
