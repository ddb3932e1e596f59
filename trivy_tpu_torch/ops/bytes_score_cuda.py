"""The raw-bytes license scorer as a hand-written CUDA kernel.

Replaces the JAX package's device computation
``trivy_tpu/ops/ngram_score.py::build_bytes_score_fn`` with
``csrc/bytes_score.cu`` (one thread block per row; see the source for the
design), with the gram cap counted in distinct keys. This module keeps the
LUT, the corpus keys and the credit table resident on the card and launches
the kernel. The function computed is that of
:func:`trivy_tpu_torch.ops.bytes_score.bytes_score_plain`.

A scorer called with a CUDA tensor launches the kernel (or raises); with a
CPU tensor it runs ``bytes_score_plain``; any other device raises.
"""

from __future__ import annotations

import numpy as np
import torch

from trivy_tpu_torch.device import resolve
from trivy_tpu_torch.ops import _build
from trivy_tpu_torch.ops.bytes_score import bytes_score_plain, effective_cap
from trivy_tpu_torch.ops.gram_gate import u32
from trivy_tpu_torch.ops.gram_gate_cuda import check_rows, launch_error, lut32, on_card
from trivy_tpu_torch.ops.match_cuda import LAUNCHES

# the key this kernel's launches are counted under in match_cuda.LAUNCHES
NAME = "bytes_score"
# the widest rung: the kernel's buffers at this width fill the 227 KB of
# shared memory a block may use
MAX_ROW = 49152


class CudaBytesScorer:
    """``[B, C] uint8 -> (full_w [B, Ls] f32, phrase [B, Ls] f32, n_uniq [B]
    i32)``: the CUDA kernel on the card, :func:`bytes_score_plain` on the
    CPU."""

    def __init__(self, lut: np.ndarray, keys: np.ndarray, credit: np.ndarray, p1: int, p2: int,
                 hash_p: int, ngram: int, device):
        self.device = resolve(device)
        self.p1, self.p2, self.hash_p, self.ngram = u32(p1), u32(p2), u32(hash_p), int(ngram)
        lut = lut32(lut)
        keys = np.asarray(keys, dtype=np.uint32).reshape(-1)
        credit = np.ascontiguousarray(credit, dtype=np.float32).reshape(keys.size, -1)
        if credit.shape[1] % 2:
            raise ValueError("credit must hold 2 * Ls columns")
        self.lut = torch.from_numpy(lut.astype(np.int64)).to(self.device)
        self.keys = torch.from_numpy(keys.astype(np.int64)).to(self.device)
        self.credit = torch.from_numpy(credit).to(self.device)
        if self.device.type == "cuda":
            self._k = (on_card(lut, self.device), on_card(keys, self.device))

    def __call__(self, rows: torch.Tensor, gram_cap: int):
        """Scores ``rows`` crediting ``effective_cap(gram_cap, C)`` distinct
        keys per row."""
        check_rows(rows)
        dev = rows.device
        cap = effective_cap(gram_cap, rows.shape[1])
        if dev.type == "cpu":
            return bytes_score_plain(rows, self.lut, self.keys, self.credit, self.p1, self.p2,
                                     self.hash_p, cap, self.ngram)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        if dev != self.device:
            raise ValueError(f"rows on {dev}, corpus tables on {self.device}")
        B, C = rows.shape
        if C > MAX_ROW:
            raise ValueError(f"row width {C} exceeds the scorer's {MAX_ROW} bytes")
        ls = self.credit.shape[1] // 2
        full_w = torch.empty((B, ls), dtype=torch.float32, device=dev)
        phrase = torch.empty((B, ls), dtype=torch.float32, device=dev)
        n_uniq = torch.empty(B, dtype=torch.int32, device=dev)
        if B == 0:
            return full_w, phrase, n_uniq
        lut, keys = self._k
        lib = _build.load("bytes_score")
        with torch.cuda.device(dev):
            rc = lib.trivy_bytes_score_launch(
                rows.data_ptr(), B, C, lut.data_ptr(), keys.data_ptr(), keys.numel(),
                self.credit.data_ptr(), ls, cap, self.p1, self.p2,
                self.hash_p, self.ngram, full_w.data_ptr(), phrase.data_ptr(), n_uniq.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream,
            )
        if rc != 0:
            raise launch_error(lib, rc, "bytes score")
        LAUNCHES[NAME] += 1
        return full_w, phrase, n_uniq
