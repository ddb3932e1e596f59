"""How well two ways of bucketing literals screen real text, on the host.

    python -m trivy_tpu_torch.ops.screen_study [--seed 0]

The CUDA matcher (``csrc/match.cu``) verifies only the positions where
some bucket passes its screen, so the share of such positions is what a
bucketing is worth. This prints, as one JSON line per matcher use
(prefilter and anchored, built-in rules), that share for two bucketings:

- ``runs``: :func:`match_cuda.assign_buckets`, the one the matcher uses:
  literal groups in sorted order, cut into 64 runs of nearly equal length;
- ``greedy``: a merge of the two groups whose union adds the least
  expected pass rate, repeated down to 64 buckets, under a fixed byte
  model of source text (``GREEDY_FREQ``, a guess with no measured source).

on two corpora: ``seeded``, the seeded source-like text that
``chip_smoke.py`` times the kernel on (its identifiers are uniform a-z,
as ``GREEDY_FREQ`` assumes), and ``repo``, every ``*.py`` file under the
checkout's ``trivy_tpu/`` read as bytes. Runs on the CPU; needs no card.
"""

from __future__ import annotations

import argparse
import json
import random
import runpy
from pathlib import Path

import numpy as np

from trivy_tpu_torch.ops import match_cuda
from trivy_tpu_torch.ops.match import match_tables
from trivy_tpu_torch.ops.prefilter import _keyword_only
from trivy_tpu_torch.secret.device_compile import compile_rules
from trivy_tpu_torch.secret.engine import SecretScanner

REPO = Path(__file__).resolve().parents[2]

GREEDY_FREQ = np.full(256, 2e-4)
GREEDY_FREQ[32:127] = 3e-3
GREEDY_FREQ[ord("a") : ord("z") + 1] = 2.2e-2
GREEDY_FREQ[ord("A") : ord("Z") + 1] = 4e-3
GREEDY_FREQ[ord("0") : ord("9") + 1] = 6e-3
GREEDY_FREQ[[ord(" "), ord("\n"), ord("_")]] = [0.14, 0.02, 0.02]


def greedy_buckets(sets: np.ndarray, n_buckets: int) -> np.ndarray:
    """Bucket of each literal: groups of equal screen sets, merged two at
    a time where the union adds the least expected pass rate under
    ``GREEDY_FREQ``, until ``n_buckets`` remain."""
    uniq, inverse = np.unique(sets.reshape(len(sets), -1), axis=0, return_inverse=True)
    g_sets = uniq.reshape(len(uniq), *sets.shape[1:])  # [g, k, 256]
    members = [[i] for i in range(len(uniq))]
    single = (g_sets * GREEDY_FREQ).sum(axis=2)  # [g, k] admitted frequency per byte
    inter = np.einsum("akc,bkc->kab", g_sets * GREEDY_FREQ, g_sets)  # [k, g, g] shared
    while len(members) > n_buckets:
        cost = single.prod(axis=1)
        union = single.T[:, :, None] + single.T[:, None, :] - inter  # [k, g, g]
        delta = union.prod(axis=0) - cost[:, None] - cost[None, :]
        np.fill_diagonal(delta, np.inf)
        a, b = sorted(np.unravel_index(int(np.argmin(delta)), delta.shape))
        members[a].extend(members.pop(b))
        g_sets[a] |= g_sets[b]
        g_sets = np.delete(g_sets, b, axis=0)
        single = np.delete(single, b, axis=0)
        inter = np.delete(np.delete(inter, b, axis=1), b, axis=2)
        fa = g_sets[a] * GREEDY_FREQ
        single[a] = fa.sum(axis=1)
        row = np.einsum("kc,bkc->kb", fa, g_sets)
        inter[:, a, :] = row
        inter[:, :, a] = row
    bucket_of_group = np.empty(len(uniq), dtype=np.int64)
    for gi, m in enumerate(members):
        bucket_of_group[m] = gi
    return bucket_of_group[inverse.ravel()]


def pass_share(tables, assign, data: np.ndarray) -> float:
    """Share of the positions of ``data`` where some bucket passes the
    screen, with buckets chosen by ``assign``."""
    sets = np.stack([match_cuda.screen_sets(lit) for lit in match_cuda.literals(tables)])
    bucket_of = assign(sets, match_cuda.SCREEN_BUCKETS)
    screen = np.zeros((match_cuda.SCREEN_BYTES, 256), dtype=np.uint64)
    for s, b in zip(sets, bucket_of):
        screen[s] |= np.uint64(1) << np.uint64(b)
    padded = np.concatenate([data, np.zeros(match_cuda.SCREEN_BYTES, np.uint8)])
    cand = np.full(len(data), ~np.uint64(0))
    for j in range(match_cuda.SCREEN_BYTES):
        cand &= screen[j][padded[j : j + len(data)]]
    return float((cand != 0).mean())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    text_base = runpy.run_path(str(REPO / "chip_smoke.py"))["text_base"]
    corpora = {
        "seeded": np.frombuffer(text_base(random.Random(args.seed), 1 << 18), dtype=np.uint8),
        "repo": np.frombuffer(b"".join(
            p.read_bytes() for p in sorted((REPO / "trivy_tpu").rglob("*.py"))), dtype=np.uint8),
    }
    compiled = compile_rules(SecretScanner().rules)
    for use, tables in (("prefilter", match_tables(_keyword_only(compiled))),
                        ("anchored", match_tables(compiled, include_keywords=False))):
        print(json.dumps({"use": use, **{
            f"{corpus}_{name}": pass_share(tables, assign, data)
            for corpus, data in corpora.items()
            for name, assign in (("runs", match_cuda.assign_buckets), ("greedy", greedy_buckets))
        }, "corpus_bytes": {k: len(v) for k, v in corpora.items()}}), flush=True)


if __name__ == "__main__":
    main()
