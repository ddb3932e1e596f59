"""Typed GitHub provider state + terraform adapter + checks
(ref: pkg/iac/providers/github — repositories, branch protections,
actions environment secrets).

The port of ``trivy_tpu/misconf/adapters/github_state.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from trivy_tpu_torch.misconf.adapters.aws_state import Res, _v
from trivy_tpu_torch.misconf.state import BlockVal, Val


@dataclass
class Repository(Res):
    name: Val = field(default_factory=_v)
    public: Val = field(default_factory=_v)
    vulnerability_alerts: Val = field(default_factory=_v)
    archived: Val = field(default_factory=_v)


@dataclass
class BranchProtection(Res):
    require_signed_commits: Val = field(default_factory=_v)


@dataclass
class EnvironmentSecret(Res):
    repository: Val = field(default_factory=_v)
    secret_name: Val = field(default_factory=_v)
    plaintext_value: Val = field(default_factory=_v)
    encrypted_value: Val = field(default_factory=_v)


@dataclass
class GithubState:
    provider = "github"

    github_repositories: list[Repository] = field(default_factory=list)
    github_branch_protections: list[BranchProtection] = field(default_factory=list)
    github_environment_secrets: list[EnvironmentSecret] = field(default_factory=list)


def adapt(resources: list[BlockVal]) -> GithubState:
    st = GithubState()
    for r in resources:
        if r.type != "resource" or not r.labels:
            continue
        rtype = r.labels[0]
        if rtype == "github_repository":
            repo = Repository(resource=r)
            repo.name = r.get("name")
            vis = r.get("visibility")
            if vis.is_set():
                repo.public = vis.with_value(vis.str() == "public")
            else:
                # legacy boolean attribute; public is the provider default
                priv = r.get("private")
                repo.public = (
                    priv.with_value(not priv.bool())
                    if priv.is_set()
                    else r.get("visibility", True)
                )
            repo.vulnerability_alerts = r.get("vulnerability_alerts", False)
            repo.archived = r.get("archived", False)
            st.github_repositories.append(repo)
        elif rtype in ("github_branch_protection", "github_branch_protection_v3"):
            bp = BranchProtection(resource=r)
            bp.require_signed_commits = r.get("require_signed_commits", False)
            st.github_branch_protections.append(bp)
        elif rtype == "github_actions_environment_secret":
            sec = EnvironmentSecret(resource=r)
            sec.repository = r.get("repository")
            sec.secret_name = r.get("secret_name")
            sec.plaintext_value = r.get("plaintext_value")
            sec.encrypted_value = r.get("encrypted_value")
            st.github_environment_secrets.append(sec)
    return st
