"""Post-scan hook registry (ref: pkg/scanner/post/post_scan.go), the port of
``trivy_tpu/scanner/post.py``.

Post scanners run after result assembly and may rewrite the result list —
the extension seam WASM modules and plugins use in the reference
(ref: pkg/module/module.go:417). The registry is empty by default.
"""

from __future__ import annotations

from trivy_tpu_torch import log

logger = log.logger("scanner:post")

_post_scanners: dict[str, object] = {}


class PostScanner:
    """Interface: subclass with name/version attrs and post_scan()."""

    name: str = ""
    version: int = 1

    def post_scan(self, results: list) -> list:  # pragma: no cover - iface
        return results


def register_post_scanner(scanner: PostScanner) -> None:
    _post_scanners[scanner.name] = scanner


def post_scan(results: list) -> list:
    """Run every registered post scanner in name order (deterministic —
    the reference iterates a map; sorted order is strictly better)."""
    for name in sorted(_post_scanners):
        try:
            out = _post_scanners[name].post_scan(results)
        except Exception as e:
            # hooks must not kill a scan (analyzer-error policy applies)
            logger.warning("post scanner %s failed: %s", name, e)
            continue
        if isinstance(out, list):
            results = out
        else:
            logger.warning(
                "post scanner %s returned %s, not a result list; ignored",
                name, type(out).__name__,
            )
    return results
