"""Check registry + evaluation engine, the port of
``trivy_tpu/misconf/checks/__init__.py``.

The replacement for the rego engine (ref: pkg/iac/rego/scanner.go):
checks are pure Python functions over typed parsed inputs, registered with
the same metadata surface the rego metadata blocks carry (ID, AVD ID,
severity, title, recommended actions, url) so results render identically
(ref: pkg/misconf/scanner.go:443-499 ResultsToMisconf).

A check yields Failure records with line causes; checks that run and yield
nothing become Successes — matching the reference's successes/failures
split per file.

The built-in sets are the Docker (DS*) and Kubernetes (KSV*) checks. Cloud
checks (``register_cloud``) are kept apart, as in the JAX package; the
port has no typed cloud state to run them over yet, so a custom
``cloud_check`` registers and is not evaluated.
"""

from __future__ import annotations

import threading
from collections.abc import Callable, Iterator
from dataclasses import dataclass, field

from trivy_tpu_torch.types import Misconfiguration, MisconfResult


@dataclass
class Failure:
    message: str
    start_line: int = 0
    end_line: int = 0
    resource: str = ""

    def __post_init__(self):
        if self.end_line < self.start_line:
            self.end_line = self.start_line


@dataclass(frozen=True)
class Check:
    id: str  # e.g. "DS002"
    avd_id: str  # e.g. "AVD-DS-0002"
    title: str
    severity: str
    file_types: tuple  # detection types this check applies to
    fn: Callable  # (parsed_input) -> Iterator[Failure]
    description: str = ""
    resolution: str = ""
    url: str = ""
    service: str = "general"
    provider: str = ""
    targets: str = ""  # cloud checks: state collection they inspect

    @property
    def namespace(self) -> str:
        # stable namespace string shaped like the reference's rego namespaces
        return f"builtin.{self.provider or self.file_types[0]}.{self.id}"


@dataclass
class CloudFailure:
    """A cloud-check failure anchored to a tracked value (file + lines)."""

    message: str
    val: object = None  # state.Val cause; None -> resource anchor
    resource: str = ""


_registry: dict[str, Check] = {}
_cloud_registry: dict[str, Check] = {}


def register(check: Check) -> Check:
    if check.id in _registry:
        raise ValueError(f"check {check.id} registered twice")
    _registry[check.id] = check
    return check


def register_cloud(check: Check) -> Check:
    """Register a check over typed provider state (terraform + CFN)."""
    if check.id in _cloud_registry:
        raise ValueError(f"cloud check {check.id} registered twice")
    _cloud_registry[check.id] = check
    return check


def unregister(check_id: str) -> None:
    """Remove a check by id (custom-check reload support)."""
    _registry.pop(check_id, None)
    _cloud_registry.pop(check_id, None)


def checks_for(file_type: str) -> list[Check]:
    _load_builtins()
    return sorted(
        (c for c in _registry.values() if file_type in c.file_types),
        key=lambda c: c.id,
    )


def all_checks() -> list[Check]:
    _load_builtins()
    return sorted(_registry.values(), key=lambda c: c.id)


_loaded = False
_load_lock = threading.Lock()


def _load_builtins() -> None:
    """Register the built-in sets once. The flag is set after the imports,
    under a lock: the JAX package sets it first, so a second thread (an
    image's layers analyzed at once) can read a registry still without the
    Kubernetes checks and drop every manifest of its layer."""
    global _loaded
    if _loaded:
        return
    with _load_lock:
        if not _loaded:
            import trivy_tpu_torch.misconf.checks.docker  # noqa: F401
            import trivy_tpu_torch.misconf.checks.kubernetes  # noqa: F401

            _loaded = True


def evaluate(
    file_type: str,
    file_path: str,
    parsed,
    scanner_name: str,
    enabled: Callable[[Check], bool] = lambda c: True,
) -> Misconfiguration | None:
    """Run every applicable check over one parsed file."""
    checks = [c for c in checks_for(file_type) if enabled(c)]
    if not checks:
        return None
    mc = Misconfiguration(file_type=file_type, file_path=file_path)
    for check in checks:
        failures = list(check.fn(parsed))
        base = _result_base(check, scanner_name)
        if not failures:
            mc.successes.append(MisconfResult(status="PASS", **base))
            continue
        for f in failures:
            mc.failures.append(
                MisconfResult(
                    status="FAIL",
                    message=f.message,
                    start_line=f.start_line,
                    end_line=f.end_line,
                    resource=f.resource,
                    **base,
                )
            )
    mc.successes.sort(key=lambda r: r.id)
    mc.failures.sort(key=lambda r: (r.id, r.start_line, r.message))
    return mc


def _result_base(check: Check, scanner_name: str) -> dict:
    """The fields every result of ``check`` shares (ref:
    scanner.go:443-499 ResultsToMisconf)."""
    return dict(
        id=check.id,
        avd_id=check.avd_id,
        type=f"{scanner_name} Security Check",
        title=check.title,
        description=check.description,
        namespace=check.namespace,
        query=f"data.{check.namespace}.deny",
        resolution=check.resolution,
        severity=check.severity,
        primary_url=check.url,
        references=[check.url] if check.url else [],
        provider=check.provider,
        service=check.service,
    )
