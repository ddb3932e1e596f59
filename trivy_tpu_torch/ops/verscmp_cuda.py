"""The version-constraint check as a hand-written CUDA kernel.

Replaces the JAX package's device computation
``trivy_tpu/ops/verscmp.py::_check_ops_gather`` (and, through its null-index
entry, ``_lexcmp`` and ``_check_ops``) with ``csrc/verscmp.cu`` (lane
groups with 16-byte loads and many rows in flight; see the source for the
design). The functions computed are those of
:mod:`trivy_tpu_torch.ops.verscmp`'s plain versions. The kernel takes its
vector path when the width is a multiple of 4 and both matrices are
16-byte aligned, and its scalar path otherwise (:func:`plan` says which).

Each function here called with CUDA tensors launches the kernel (or
raises); with CPU tensors it runs the plain version; any other device
raises. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from trivy_tpu_torch.ops import _build
from trivy_tpu_torch.ops.match_cuda import LAUNCHES
from trivy_tpu_torch.ops.verscmp import check_ops_gather_plain, check_ops_plain, lexcmp_plain

# the key this kernel's launches are counted under in match_cuda.LAUNCHES
NAME = "verscmp"


def check_ops_gather(inst: torch.Tensor, bounds: torch.Tensor, a_idx: torch.Tensor,
                     b_idx: torch.Tensor, ops: torch.Tensor) -> torch.Tensor:
    """``inst[a_idx[r]] <ops[r]> bounds[b_idx[r]]`` -> bool ``[R]``: inst
    ``[Ni, L]`` and bounds ``[Nb, L]`` int32, the rest ``[R]`` int32."""
    _check_matrices(inst, bounds)
    _check_rows(inst.device, a_idx=a_idx, b_idx=b_idx, ops=ops)
    if inst.device.type == "cpu":
        return check_ops_gather_plain(inst, bounds, a_idx, b_idx, ops)
    return _launch(inst, bounds, a_idx, b_idx, ops, verdict=True)


def check_ops(a: torch.Tensor, b: torch.Tensor, ops: torch.Tensor) -> torch.Tensor:
    """``a[r] <ops[r]> b[r]`` -> bool ``[N]``: a and b ``[N, L]`` int32."""
    _check_matrices(a, b, same_rows=True)
    _check_rows(a.device, ops=ops, n=a.shape[0])
    if a.device.type == "cpu":
        return check_ops_plain(a, b, ops)
    return _launch(a, b, None, None, ops, verdict=True)


def lexcmp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The sign of the first differing column of each row -> int32 ``[N]``
    in {-1, 0, 1}: a and b ``[N, L]`` int32."""
    _check_matrices(a, b, same_rows=True)
    if a.device.type == "cpu":
        return lexcmp_plain(a, b)
    return _launch(a, b, None, None, None, verdict=False)


def plan(inst: torch.Tensor, bounds: torch.Tensor, rows: int) -> dict:
    """How the kernel launches over ``rows`` rows of ``inst`` and ``bounds``
    (CUDA tensors): lanes per row (``group``), rows a group takes per step
    (``rows_per_group``), whether it takes the vector path, and the blocks
    of its grid."""
    _check_matrices(inst, bounds)
    if inst.device.type != "cuda":
        raise ValueError(f"plan needs CUDA tensors, got {inst.device}")
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(inst.device):
        rc = _build.load(NAME).trivy_verscmp_plan(inst.shape[1], rows, inst.data_ptr(),
                                                  bounds.data_ptr(), out)
    if rc != 0:
        raise _build.KernelError(f"verscmp plan failed ({rc})")
    return {"group": out[0], "rows_per_group": out[1], "vector": bool(out[2]), "grid": out[3]}


def _launch(inst, bounds, a_idx, b_idx, ops, verdict: bool) -> torch.Tensor:
    dev = inst.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    R = (a_idx if a_idx is not None else inst).shape[0]
    # the kernel writes 0 or 1 bytes: a bool tensor's storage
    out = torch.empty(R, dtype=torch.bool if verdict else torch.int32, device=dev)
    if R == 0:
        return out
    lib = _build.load(NAME)

    def ptr(t):  # a null pointer for an absent index or op row
        return t.data_ptr() if t is not None else None

    with torch.cuda.device(dev):  # the kernel runs on the current device
        rc = lib.trivy_verscmp_launch(
            inst.data_ptr(), inst.shape[0], bounds.data_ptr(), bounds.shape[0], inst.shape[1],
            ptr(a_idx), ptr(b_idx), ptr(ops), R, out.data_ptr() if verdict else None,
            None if verdict else out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        msg = lib.trivy_cuda_error_string(rc).decode()
        raise _build.KernelError(f"verscmp kernel launch failed: {msg} ({rc})")
    LAUNCHES[NAME] += 1
    return out


def _check_matrices(a: torch.Tensor, b: torch.Tensor, same_rows: bool = False) -> None:
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.int32 or t.dim() != 2:
            raise ValueError(f"{name} must be 2-D int32, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.shape[0] == 0 and not same_rows:
            raise ValueError(f"{name} has no rows")
    if a.device != b.device:
        raise ValueError(f"matrices on {a.device} and {b.device}")
    if a.shape[1] != b.shape[1] or a.shape[1] == 0:
        raise ValueError(f"widths differ or are 0: {a.shape[1]} and {b.shape[1]}")
    if same_rows and a.shape[0] != b.shape[0]:
        raise ValueError(f"row counts differ: {a.shape[0]} and {b.shape[0]}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {a.device}")


def _check_rows(device: torch.device, n: int | None = None, **rows: torch.Tensor) -> None:
    for name, t in rows.items():
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"{name} must be 1-D int32, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, the matrices on {device}")
        n = t.shape[0] if n is None else n
        if t.shape[0] != n:
            raise ValueError(f"{name} has {t.shape[0]} rows, want {n}")
