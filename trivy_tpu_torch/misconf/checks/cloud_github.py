"""Builtin GitHub checks over typed provider state (AVD-GIT IDs are the
public interface; logic written against this repo's state model — ref:
pkg/iac/providers/github for the modeled surface).

The port of ``trivy_tpu/misconf/checks/cloud_github.py``.
"""

from __future__ import annotations

from trivy_tpu_torch.misconf.adapters.github_state import GithubState
from trivy_tpu_torch.misconf.checks import Check, CloudFailure, register_cloud

_TYPES = ("terraform",)
_URL = "https://avd.aquasec.com/misconfig/{}"


def _check(id_, title, severity, targets, desc="", res=""):
    def wrap(fn):
        register_cloud(
            Check(
                id=id_,
                avd_id=id_,
                title=title,
                severity=severity,
                file_types=_TYPES,
                fn=fn,
                description=desc,
                resolution=res,
                url=_URL.format(id_.lower()),
                service="github",
                provider="github",
                targets=targets,
            )
        )
        return fn

    return wrap


@_check("AVD-GIT-0001", "GitHub repositories should be private", "HIGH",
        "github_repositories",
        "Public repositories expose the full history of their contents.",
        "Make the repository private unless it is deliberately open source.")
def repo_private(st: GithubState):
    for r in st.github_repositories:
        if r.archived.bool():
            continue
        if r.public.bool():
            yield CloudFailure(
                "Repository is public", r.public if r.public.explicit else r.anchor(),
                r.address,
            )


@_check("AVD-GIT-0002", "GitHub repositories should enable vulnerability alerts",
        "MEDIUM", "github_repositories",
        "Vulnerability alerts surface known-vulnerable dependencies.",
        "Set vulnerability_alerts = true.")
def repo_vulnerability_alerts(st: GithubState):
    for r in st.github_repositories:
        if r.archived.bool():
            continue
        if not r.vulnerability_alerts.bool():
            yield CloudFailure(
                "Repository does not enable vulnerability alerts",
                r.vulnerability_alerts
                if r.vulnerability_alerts.explicit
                else r.anchor(),
                r.address,
            )


@_check("AVD-GIT-0004", "GitHub branch protections should require signed commits",
        "HIGH", "github_branch_protections",
        "Signed commits provide cryptographic authorship guarantees.",
        "Set require_signed_commits = true.")
def branch_protection_signed_commits(st: GithubState):
    for bp in st.github_branch_protections:
        if not bp.require_signed_commits.bool():
            yield CloudFailure(
                "Branch protection does not require signed commits",
                bp.require_signed_commits
                if bp.require_signed_commits.explicit
                else bp.anchor(),
                bp.address,
            )


@_check("AVD-GIT-0003", "GitHub Actions secrets should not carry plain-text values",
        "CRITICAL", "github_environment_secrets",
        "plaintext_value lands in the terraform state unencrypted.",
        "Use encrypted_value, or inject the secret outside terraform.")
def actions_no_plaintext_secret(st: GithubState):
    for s in st.github_environment_secrets:
        if s.plaintext_value.is_set() and s.plaintext_value.str():
            yield CloudFailure(
                "Actions environment secret is supplied in plain text",
                s.plaintext_value, s.address,
            )
