"""Version parsing and comparison per packaging ecosystem.

Mirrors the reference's per-ecosystem comparers (ref:
pkg/detector/library/compare/{maven,npm,pep440,rubygems}/,
pkg/detector/ospkg/version/ — deb/rpm/apk version algebra). Each scheme
exposes ``compare(a, b) -> -1|0|1`` and ``Constraint`` evaluation used by
advisory matching; schemes also *encode* versions into flat int token
sequences whose plain lexicographic order equals the scheme's order, which
is what lets the CVE-match kernel run batched compares on device
(trivy_tpu_torch/ops/verscmp.py) with all scheme quirks folded in at encode time.
"""

from trivy_tpu_torch.version.compare import (  # noqa: F401
    Constraint,
    compare,
    parse_constraints,
    satisfies,
)
