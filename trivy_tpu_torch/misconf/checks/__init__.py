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

The built-in sets are the Docker (DS*) and Kubernetes (KSV*) checks, and
the cloud checks (``register_cloud``: AWS, Google, Azure with ARM's own,
GitHub and the five smaller providers), which :func:`evaluate_cloud` runs
over the typed provider state of a terraform set, a terraform plan or an
ARM template.
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


def cloud_checks() -> list[Check]:
    _load_builtins()
    return sorted(_cloud_registry.values(), key=lambda c: c.id)


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
    Kubernetes checks and drop every manifest of its layer. The imports
    follow the JAX order."""
    global _loaded
    if _loaded:
        return
    with _load_lock:
        if not _loaded:
            import trivy_tpu_torch.misconf.arm  # noqa: F401  (azure cloud checks)
            import trivy_tpu_torch.misconf.checks.cloud_aws  # noqa: F401
            import trivy_tpu_torch.misconf.checks.cloud_azure  # noqa: F401
            import trivy_tpu_torch.misconf.checks.cloud_extra  # noqa: F401
            import trivy_tpu_torch.misconf.checks.cloud_github  # noqa: F401
            import trivy_tpu_torch.misconf.checks.cloud_google  # noqa: F401
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


def evaluate_cloud(
    state,
    files: list[str],
    file_type: str,
    scanner_name: str,
    enabled: Callable[[Check], bool] = lambda c: True,
) -> dict[str, Misconfiguration]:
    """Run cloud checks over typed provider state; group results per file.

    A check with no failure in a given scanned file is a PASS for that file
    (per-file status, matching the reference's per-input successes).
    """
    out: dict[str, Misconfiguration] = {
        f: Misconfiguration(file_type=file_type, file_path=f) for f in files
    }
    state_provider = getattr(state, "provider", "")
    # plan JSON evaluates the terraform check set but keeps its own label
    match_type = "terraform" if file_type == "terraformplan-json" else file_type
    for check in cloud_checks():
        if not enabled(check):
            continue
        if check.file_types and match_type not in check.file_types:
            continue  # check routed to other IaC types
        if state_provider and check.provider and check.provider != state_provider:
            continue  # check belongs to another cloud provider's state
        if check.targets and not getattr(state, check.targets, None):
            continue  # no matching resources: check not evaluated (no PASS noise)
        failures = list(check.fn(state))
        base = _result_base(check, scanner_name)
        failed_files: set[str] = set()
        for f in failures:
            val = f.val
            file = getattr(val, "file", "") or ""
            if file not in out:
                # cause in an unscanned file (e.g. module dir outside input):
                # attribute to the first scanned file as a fallback
                file = files[0] if files else ""
                if file not in out:
                    continue
            failed_files.add(file)
            out[file].failures.append(
                MisconfResult(
                    status="FAIL",
                    message=f.message,
                    start_line=getattr(val, "line", 0) or 0,
                    end_line=getattr(val, "end_line", 0) or 0,
                    resource=f.resource,
                    **base,
                )
            )
        for file, mc in out.items():
            if file not in failed_files:
                mc.successes.append(MisconfResult(status="PASS", **base))
    for mc in out.values():
        mc.successes.sort(key=lambda r: r.id)
        mc.failures.sort(key=lambda r: (r.id, r.start_line, r.message))
    return out
