"""Raw-bytes license scorer: tokenize, hash, dedup and score text rows
against the corpus table.

The port of ``trivy_tpu/ops/ngram_score.py::build_bytes_score_fn``. Per
``[C]`` uint8 row: the gram keys of :mod:`trivy_tpu_torch.ops.gram_gate`
(word hashes from the LUT image, five words folded), clamped to 0xFFFFFFFE
so that 0xFFFFFFFF stays free; the row's distinct keys in ascending order;
``n_uniq``, their number; and for the first ``cap`` of them, each one
found in the corpus ``keys`` adds its ``credit`` row into a float32 sum,
in ascending key order. The sum's first ``Ls`` columns are ``full_w``, the
rest ``phrase``.

The cap counts DISTINCT keys, as the reference's docstring says and as the
host's overflow test (``n_uniq > cap`` reroutes the row to the host oracle)
assumes. The reference's code credits the first ``gram_cap`` sorted entries
with their duplicates, so a row whose distinct keys fit the cap but whose
repeated ones do not loses credit without being rerouted; the port does not
copy that (``tests/test_torch_license.py`` shows the difference).

On the card the scorer is the hand-written kernel ``csrc/bytes_score.cu``
(``ops/bytes_score_cuda.py``); :func:`bytes_score_plain` is its plain
PyTorch version. No matrix product anywhere: a float32 product may run in
TF32 on the card, far outside the classifier's 1e-4 band.
"""

from __future__ import annotations

import torch

from trivy_tpu_torch.ops.gram_gate import gram_keys, lut_image, word_hashes

SENT32 = 0xFFFFFFFF  # padding: real keys clamp to 0xFFFFFFFE
ROW_STEP = 16  # rows per step of the plain version


def effective_cap(gram_cap: int, width: int) -> int:
    """Distinct keys credited per row: ``gram_cap`` raised to at least 256,
    rounded up to a multiple of 256, at most the row width (the
    reference's rounding)."""
    g = max(256, int(gram_cap))
    return min(-(-g // 256) * 256, int(width))


def credited_keys(rows: torch.Tensor, lut: torch.Tensor, keys: torch.Tensor, p1: int, p2: int,
                  hash_p: int, cap: int, ngram: int = 5):
    """``(row, pos, n_uniq)``: for every credited key (one of its row's
    first ``cap`` distinct keys found in ``keys``), its row and its index in
    ``keys`` (row-major, ascending keys within a row), and the number of
    distinct valid keys per row. ``keys`` is a sorted int64 table of uint32
    keys."""
    starts, H = word_hashes(lut_image(rows, lut), p1, p2)
    key, valid = gram_keys(starts, H, hash_p, ngram)
    kk = torch.where(valid, key.clamp(max=SENT32 - 1), SENT32)
    ks = torch.sort(kk, dim=1).values
    fresh = torch.ones_like(ks, dtype=torch.bool)
    fresh[:, 1:] = ks[:, 1:] != ks[:, :-1]
    fresh &= ks != SENT32
    n_uniq = fresh.sum(dim=1, dtype=torch.int32)
    take = fresh & (torch.cumsum(fresh, dim=1) <= cap)
    pos = torch.searchsorted(keys, ks).clamp_(max=keys.numel() - 1)
    row, col = torch.nonzero(take & (keys[pos] == ks), as_tuple=True)
    return row, pos[row, col], n_uniq


def bytes_score_plain(rows: torch.Tensor, lut: torch.Tensor, keys: torch.Tensor,
                      credit: torch.Tensor, p1: int, p2: int, hash_p: int, cap: int,
                      ngram: int = 5):
    """``[B, C]`` uint8 rows -> ``(full_w [B, Ls] f32, phrase [B, Ls] f32,
    n_uniq [B] int32)`` in plain PyTorch on the device of ``rows``;
    ``credit`` is ``[Ku, 2 * Ls]`` float32 beside the ``[Ku]`` keys, and
    ``cap`` the distinct keys credited per row (:func:`effective_cap`)."""
    B, C = rows.shape
    dev = rows.device
    keys, credit = keys.to(dev), credit.to(dev)
    s = torch.zeros((B, credit.shape[1]), dtype=torch.float32, device=dev)
    n_uniq = torch.zeros(B, dtype=torch.int32, device=dev)
    for r0 in range(0, B, ROW_STEP):
        x = rows[r0 : r0 + ROW_STEP]
        row, pos, nu = credited_keys(x, lut, keys, p1, p2, hash_p, cap, ngram)
        # index_add_ on the CPU adds in index order: ascending keys per row
        s[r0 : r0 + x.shape[0]].index_add_(0, row, credit[pos])
        n_uniq[r0 : r0 + x.shape[0]] = nu
    ls = credit.shape[1] // 2
    return s[:, :ls], s[:, ls:], n_uniq
