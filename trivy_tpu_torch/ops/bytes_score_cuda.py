"""The raw-bytes license scorer as a hand-written CUDA kernel.

Replaces the JAX package's device computation
``trivy_tpu/ops/ngram_score.py::build_bytes_score_fn`` with
``csrc/bytes_score.cu`` (a thread block cluster per row; see the source for
the design), with the gram cap counted in distinct keys. This module keeps
the LUT, the corpus keys and the credit table resident on the card, chooses
each launch's cluster size (:func:`cluster_size`) and launches the kernel.
The function computed is that of
:func:`trivy_tpu_torch.ops.bytes_score.bytes_score_plain`.

A scorer called with a CUDA tensor launches the kernel (or raises, also when
the card cannot schedule the cluster: there is no fallback to a smaller
cluster or to the plain version); with a CPU tensor it runs
``bytes_score_plain``; any other device raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from trivy_tpu_torch.device import resolve
from trivy_tpu_torch.ops import _build
from trivy_tpu_torch.ops.bytes_score import bytes_score_plain, effective_cap
from trivy_tpu_torch.ops.gram_gate import key_directory, u32
from trivy_tpu_torch.ops.gram_gate_cuda import check_rows, launch_error, lut32, on_card
from trivy_tpu_torch.ops.match_cuda import LAUNCH_SHAPES, LAUNCHES

# the key this kernel's launches are counted under in match_cuda.LAUNCHES
NAME = "bytes_score"
MAX_ROW = 49152  # the widest rung of the text-row ladder
# blocks per row: powers of two (the keys are split by their top bits) up
# to the portable cluster size
CLUSTER_SIZES = (1, 2, 4, 8)
# bytes of a row one block holds at most, by the launch policy: smaller
# slices add fixed work per block (about ten cluster barriers and four radix
# passes) and were slower on an H100 at every batch size; larger ones
# serialise a wide row's sort and lookups on one block (PERF.md, the
# scorer's times by cluster size)
SLICE_MAX = 8192


def cluster_size(width: int) -> int:
    """Blocks per row for rows of ``width`` bytes: the smallest size of
    :data:`CLUSTER_SIZES` whose slices hold at most ``SLICE_MAX`` bytes (1 up
    to 8 KiB, 2 at 16 KiB, 4 at 32 KiB, 8 at 48 KiB)."""
    return next((s for s in CLUSTER_SIZES if -(-width // s) <= SLICE_MAX), CLUSTER_SIZES[-1])


class CudaBytesScorer:
    """``[B, C] uint8 -> (full_w [B, Ls] f32, phrase [B, Ls] f32, n_uniq [B]
    i32)``: the CUDA kernel on the card, :func:`bytes_score_plain` on the
    CPU."""

    def __init__(self, lut: np.ndarray, keys: np.ndarray, credit: np.ndarray, p1: int, p2: int,
                 hash_p: int, ngram: int, device):
        self.device = resolve(device)
        if self.device.type == "cuda":
            _build.preload("bytes_score")  # a kernel that cannot load fails here
        self.p1, self.p2, self.hash_p, self.ngram = u32(p1), u32(p2), u32(hash_p), int(ngram)
        lut = lut32(lut)
        keys = np.asarray(keys, dtype=np.uint32).reshape(-1)
        credit = np.ascontiguousarray(credit, dtype=np.float32).reshape(keys.size, -1)
        if credit.shape[1] % 2:
            raise ValueError("credit must hold 2 * Ls columns")
        self.lut = torch.from_numpy(lut.astype(np.int64)).to(self.device)
        self.keys = torch.from_numpy(keys.astype(np.int64)).to(self.device)
        self.credit = torch.from_numpy(credit).to(self.device)
        self._plans: dict[tuple[int, int], dict] = {}
        if self.device.type == "cuda":
            self._k = (on_card(lut, self.device), on_card(keys, self.device),
                       on_card(key_directory(keys), self.device))

    def plan(self, width: int, cluster: int) -> dict:
        """The launch shape of rows of ``width`` bytes in clusters of
        ``cluster`` blocks: threads and shared memory per block, clusters
        active at once, blocks per SM. Raises when the card cannot schedule
        such a cluster."""
        key = (int(width), int(cluster))
        plan = self._plans.get(key)
        if plan is None:
            lib = _build.load("bytes_score")
            out = (ctypes.c_int * 4)()
            with torch.cuda.device(self.device):
                rc = lib.trivy_bytes_score_plan(key[0], key[1], out)
            if rc != 0:
                raise launch_error(lib, rc, f"bytes score (cluster of {cluster} at {width})")
            plan = dict(zip(("threads", "smem", "clusters", "blocks_per_sm"), out))
            if plan["clusters"] < 1:
                raise _build.KernelError(
                    f"bytes score: a cluster of {cluster} blocks with {plan['smem']} bytes of "
                    f"shared memory each cannot be scheduled on {self.device}")
            self._plans[key] = plan
        return plan

    def __call__(self, rows: torch.Tensor, gram_cap: int, *, cluster: int | None = None):
        """Scores ``rows`` crediting ``effective_cap(gram_cap, C)`` distinct
        keys per row. On the card ``cluster`` forces the blocks per row
        (one of :data:`CLUSTER_SIZES`; by default :func:`cluster_size`)."""
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
        S = cluster_size(C) if cluster is None else int(cluster)
        if S not in CLUSTER_SIZES:
            raise ValueError(f"cluster must be one of {CLUSTER_SIZES}, got {cluster}")
        ls = self.credit.shape[1] // 2
        full_w = torch.empty((B, ls), dtype=torch.float32, device=dev)
        phrase = torch.empty((B, ls), dtype=torch.float32, device=dev)
        n_uniq = torch.empty(B, dtype=torch.int32, device=dev)
        if B == 0:
            return full_w, phrase, n_uniq
        self.plan(C, S)
        # room for every key of each row, twice: buckets that overflow
        # shared memory are sorted here
        scratch = torch.empty(B * 2 * (C // 2 + 1), dtype=torch.int32, device=dev)
        lut, keys, kdir = self._k
        lib = _build.load("bytes_score")
        with torch.cuda.device(dev):
            rc = lib.trivy_bytes_score_launch(
                rows.data_ptr(), B, C, S, lut.data_ptr(), keys.data_ptr(), kdir.data_ptr(),
                self.credit.data_ptr(), ls, cap, self.p1, self.p2,
                self.hash_p, self.ngram, full_w.data_ptr(), phrase.data_ptr(), n_uniq.data_ptr(),
                scratch.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
            )
        if rc != 0:
            raise launch_error(lib, rc, "bytes score")
        LAUNCHES[NAME] += 1
        LAUNCH_SHAPES[NAME, B, C] += 1
        return full_w, phrase, n_uniq
