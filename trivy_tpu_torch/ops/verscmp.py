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
signature and returns the ``R`` verdicts.
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


def check_ops_gather_bucketed(inst: np.ndarray, bounds_dev: torch.Tensor, a_idx: np.ndarray,
                              b_idx: np.ndarray, ops: np.ndarray) -> np.ndarray:
    """``inst[a_idx] <ops> bounds_dev[b_idx]`` on the device of the resident
    bound matrix ``bounds_dev``: the installed-version matrix and the int32
    index and op rows cross the link, the verdicts (bool ``[R]``) come
    back."""
    from trivy_tpu_torch.ops.verscmp_cuda import check_ops_gather

    dev = bounds_dev.device

    def put(x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(dev)

    out = check_ops_gather(put(inst), bounds_dev, put(a_idx), put(b_idx), put(ops))
    return out.cpu().numpy()


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
