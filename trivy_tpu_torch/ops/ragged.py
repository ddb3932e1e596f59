"""Shared numpy ragged-gather helpers for the host-side batch pipelines."""

from __future__ import annotations

import numpy as np


def ragged_arange(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Vectorized ``np.concatenate([np.arange(s, s + l) ...])``.

    Every ``lens`` entry must be positive (filter zero-length spans first:
    duplicate cumsum positions would overwrite each other's step).
    """
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    out = np.ones(total, dtype=np.int64)
    out[0] = starts[0]
    cum = np.cumsum(lens)[:-1]
    out[cum] = starts[1:] - (starts[:-1] + lens[:-1] - 1)
    return np.cumsum(out)
