"""Batched version comparison and constraint checks: the CVE match's device
computation.

Packages join advisories on the host (a hash join by name); then every
(installed version, bound) pair of the whole SBOM is compared in one call
over int32 encodings whose lexicographic order is the scheme's order
(``trivy_tpu_torch/version/encode.py``). On the card the check is the
hand-written kernel ``csrc/verscmp.cu`` (``ops/verscmp_cuda.py``); the
``*_plain`` functions here are its plain PyTorch versions, transcriptions
of the JAX package's ``trivy_tpu/ops/verscmp.py`` (``_lexcmp``,
``_check_ops``, ``_check_ops_gather``).

The JAX package pads rows to powers of two only to reuse XLA compilations;
the port does not pad: :func:`check_ops_gather_bucketed` keeps its name and
returns the ``R`` verdicts. On a CUDA device its arrays cross the link as
one pinned buffer of a :class:`DispatchStage`, which the detector keeps
beside its resident bound matrix and builds the arrays into.
"""

from __future__ import annotations

import numpy as np
import torch

from trivy_tpu_torch.device import DEFAULT_DEVICE, resolve

# op codes for constraint checks
OPS = {"<": 0, "<=": 1, ">": 2, ">=": 3, "=": 4, "!=": 5}


def lexcmp_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``[N, L]`` against ``[N, L]`` int32 -> the sign (int32 in {-1, 0, 1})
    of the first differing column of each row, 0 where the rows are
    equal."""
    diff = torch.sign(a - b)
    ne = diff != 0
    first = ne.to(torch.uint8).argmax(dim=1)  # the first differing column, 0 if none
    picked = diff.gather(1, first[:, None])[:, 0]
    return torch.where(ne.any(dim=1), picked, torch.zeros_like(picked)).to(torch.int32)


def _verdicts(s: torch.Tensor, ops: torch.Tensor) -> torch.Tensor:
    table = torch.stack([s < 0, s <= 0, s > 0, s >= 0, s == 0, s != 0], dim=1)
    return table.gather(1, ops.to(torch.int64).clamp(0, 5)[:, None])[:, 0]


def check_ops_plain(a: torch.Tensor, b: torch.Tensor, ops: torch.Tensor) -> torch.Tensor:
    """``a[r] <ops[r]> b[r]`` for each row -> bool ``[N]``."""
    return _verdicts(lexcmp_plain(a, b), ops)


def check_ops_gather_plain(inst: torch.Tensor, bounds: torch.Tensor, a_idx: torch.Tensor,
                           b_idx: torch.Tensor, ops: torch.Tensor) -> torch.Tensor:
    """``inst[a_idx[r]] <ops[r]> bounds[b_idx[r]]`` for each row -> bool
    ``[R]``. Indices are clamped into their matrix, as the kernel clamps
    them."""
    a = inst.index_select(0, a_idx.to(torch.int64).clamp(0, inst.shape[0] - 1))
    b = bounds.index_select(0, b_idx.to(torch.int64).clamp(0, bounds.shape[0] - 1))
    return check_ops_plain(a, b, ops)


class DispatchStage:
    """The buffers of one device's constraint dispatches, reused across
    scans and grown only: on a CUDA device one pinned host buffer holding
    ``a_idx``, ``b_idx``, ``ops`` and the installed-version matrix, which
    crosses the link by one copy, its device twin, and a pinned buffer the
    verdicts come back into. The caller builds its arrays straight into
    :meth:`views`; on the CPU they are plain numpy arrays and nothing is
    copied. One dispatch at a time (the detector dispatches from one
    thread)."""

    ALIGN = 32  # int32 words: each part of the buffer starts on 128 bytes

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.pin = self.device.type == "cuda"
        self.host = torch.empty(0, dtype=torch.int32, pin_memory=self.pin)
        self.dev = torch.empty(0, dtype=torch.int32, device=self.device)
        self.verdict = torch.empty(0, dtype=torch.bool, pin_memory=self.pin)
        self._layout = (0, 0, 0)  # rows, inst rows, width of the current views

    def _offsets(self) -> tuple[int, int]:
        R, n_inst, L = self._layout
        rows = -(-R // self.ALIGN) * self.ALIGN
        return rows, 3 * rows + n_inst * L

    def views(self, R: int, n_inst: int, L: int) -> tuple[np.ndarray, ...]:
        """``(inst [n_inst, L], a_idx [R], b_idx [R], ops [R])``: int32 views
        of the host buffer for the next dispatch, to be filled."""
        self._layout = (R, n_inst, L)
        rows, total = self._offsets()
        if self.host.numel() < total:
            self.host = torch.empty(total, dtype=torch.int32, pin_memory=self.pin)
        h = self.host.numpy()
        return (h[3 * rows : total].reshape(n_inst, L), h[:R], h[rows : rows + R],
                h[2 * rows : 2 * rows + R])

    def upload(self) -> tuple[torch.Tensor, ...]:
        """The views on the device, after one non-blocking copy of the used
        part of the host buffer."""
        R, n_inst, L = self._layout
        rows, total = self._offsets()
        if self.dev.numel() < total:
            self.dev = torch.empty(self.host.numel(), dtype=torch.int32, device=self.device)
        d = self.dev
        d[:total].copy_(self.host[:total], non_blocking=True)
        return (d[3 * rows : total].view(n_inst, L), d[:R], d[rows : rows + R],
                d[2 * rows : 2 * rows + R])

    def copy_back(self, out: torch.Tensor) -> torch.Tensor:
        """Enqueues the copy of the device verdicts ``out`` into the pinned
        buffer; returns its view (valid once the stream has synchronised)."""
        if self.verdict.numel() < out.numel():
            self.verdict = torch.empty(out.numel(), dtype=torch.bool, pin_memory=self.pin)
        host = self.verdict[: out.numel()]
        host.copy_(out, non_blocking=True)
        return host

    def dispatch(self, inst: np.ndarray, bounds_dev: torch.Tensor, a_idx: np.ndarray,
                 b_idx: np.ndarray, ops: np.ndarray) -> np.ndarray:
        """``inst[a_idx] <ops> bounds_dev[b_idx]`` -> bool ``[R]``: the
        arrays go into the views unless they are the views already."""
        from trivy_tpu_torch.ops.verscmp_cuda import check_ops_gather

        if self.device.type == "cpu":
            a, b, o, i = (torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32))
                          for x in (a_idx, b_idx, ops, inst))
            return check_ops_gather(i, bounds_dev, a, b, o).numpy()
        views = self.views(len(a_idx), *inst.shape)
        for src, dst in zip((inst, a_idx, b_idx, ops), views):
            if src.ctypes.data != dst.ctypes.data:
                np.copyto(dst, src, casting="same_kind")
        inst_d, a_d, b_d, ops_d = self.upload()
        host = self.copy_back(check_ops_gather(inst_d, bounds_dev, a_d, b_d, ops_d))
        torch.cuda.current_stream(self.device).synchronize()
        return host.numpy().copy()


def check_ops_gather_bucketed(inst: np.ndarray, bounds_dev: torch.Tensor, a_idx: np.ndarray,
                              b_idx: np.ndarray, ops: np.ndarray,
                              stage: DispatchStage | None = None) -> np.ndarray:
    """``inst[a_idx] <ops> bounds_dev[b_idx]`` on the device of the resident
    bound matrix ``bounds_dev`` -> bool ``[R]``: the installed-version matrix
    and the int32 index and op rows cross the link in one copy through
    ``stage`` (a new one when None), the verdicts come back in one."""
    if stage is None or stage.device != bounds_dev.device:
        stage = DispatchStage(bounds_dev.device)
    return stage.dispatch(inst, bounds_dev, a_idx, b_idx, ops)


def batch_compare(scheme: str, pairs: list[tuple[str, str]],
                  device=DEFAULT_DEVICE) -> np.ndarray | None:
    """Compare many ``(a, b)`` version pairs on ``device`` -> int32 signs,
    or None when a version does not encode in ``scheme``."""
    from trivy_tpu_torch.ops.verscmp_cuda import lexcmp
    from trivy_tpu_torch.version.encode import encode_batch, pad_value

    if not pairs:
        return np.zeros(0, dtype=np.int32)
    a = encode_batch(scheme, [p[0] for p in pairs])
    b = encode_batch(scheme, [p[1] for p in pairs])
    if a is None or b is None:
        return None
    L = max(a.shape[1], b.shape[1])
    pv = pad_value(scheme)

    def widen(x: np.ndarray) -> torch.Tensor:
        if x.shape[1] < L:
            out = np.full((x.shape[0], L), pv, dtype=np.int32)
            out[:, : x.shape[1]] = x
            x = out
        return torch.from_numpy(x).to(resolve(device))

    return lexcmp(widen(a), widen(b)).cpu().numpy()
