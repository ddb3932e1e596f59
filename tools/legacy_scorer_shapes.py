"""Shapes and memory bound of the JAX package's legacy int32 license gate
and scorer (``trivy_tpu/ops/ngram_score.py:427 build_gate_fn``, ``:457
build_score_fn``) at the sizes ``bench.py:757`` packs for them: the fused
benchmark's license corpus (``bench.make_license_corpus``, seed 0) hashed by
the classifier, packed by ``pack_gram_rows`` and cut into dispatches of at
most ``MAX_DEVICE_ROWS`` rows padded to a power of two (at least 8), as
``bench.py`` counts its upload. The corpus table is the classifier's own
(``build_corpus_table``, one shard).

The bound of each dispatch is its bytes over the H100's 3.35 TB/s: every
input read once (the rows, the key column and, for the scorer, the whole
credit table) and every output written once (the gate's ``[B]`` counts,
the scorer's ``full_w`` and ``phrase_hits``). Host-only: it imports the JAX
package but runs no device computation.

    JAX_PLATFORMS=cpu python -m tools.legacy_scorer_shapes
"""

from __future__ import annotations

import json

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)


def main() -> int:
    import bench
    from trivy_tpu.licensing import classify
    from trivy_tpu.licensing.classify import LicenseClassifier
    from trivy_tpu.ops import ngram_score as ng

    files = bench.make_license_corpus(np.random.default_rng(0))
    texts = [d.decode("utf-8", "replace") for _, d in files]
    clf = LicenseClassifier(backend="cpu")
    clf._build_scoring()
    table = ng.build_corpus_table(clf.licenses, clf._full_keys, clf._full_weights,
                                  clf._phrase_keys, clf._phrase_short)
    Ku, two_ls = table.credit.shape[1:]
    _wh, _wt, keys, gt = LicenseClassifier._batch_hashes(texts)
    groups, overflow = ng.pack_gram_rows(ng.fold32(keys), gt, len(texts))
    dispatches = []
    for rows, _tis in groups:
        for off in range(0, len(rows), classify.MAX_DEVICE_ROWS):
            n = min(classify.MAX_DEVICE_ROWS, len(rows) - off)
            b = 8
            while b < n:
                b *= 2
            T = int(rows.shape[1])
            gate_bytes = b * T * 4 + Ku * 4 + b * 4
            score_bytes = b * T * 4 + Ku * 4 + Ku * two_ls * 4 + 2 * b * (two_ls // 2) * 4
            dispatches.append({
                "rows": n, "shape": [b, T], "gate_bound_ms": gate_bytes / HBM_BYTES_PER_S * 1e3,
                "score_bound_ms": score_bytes / HBM_BYTES_PER_S * 1e3,
            })
    print(json.dumps({"texts": len(texts), "overflow": len(overflow), "keys": int(Ku),
                      "credit": [int(Ku), int(two_ls)], "dispatches": dispatches}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
