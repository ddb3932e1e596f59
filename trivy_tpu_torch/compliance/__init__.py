"""Compliance specs and reports (ref: pkg/compliance/spec, pkg/compliance/report).

A spec maps check IDs onto controls; applying a spec to a scan report
yields per-control PASS/FAIL with the matching findings. Builtin specs
cover the docker-cis and k8s-nsa control sets over this build's check IDs;
user YAML specs load with ``--compliance @path/to/spec.yaml``
(the reference's custom-spec syntax).

The port of ``trivy_tpu/compliance/__init__.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from trivy_tpu_torch import log
from trivy_tpu_torch.types import Report

logger = log.logger("compliance")


@dataclass
class Control:
    id: str
    name: str
    severity: str = "MEDIUM"
    description: str = ""
    checks: list[str] = field(default_factory=list)  # check/rule IDs
    # a control with no automatable check reports this status (ref:
    # spec.ControlStatus "MANUAL")
    default_status: str = ""


@dataclass
class ComplianceSpec:
    id: str
    title: str
    version: str = ""
    description: str = ""
    controls: list[Control] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: dict) -> "ComplianceSpec":
        spec = d.get("spec", d)
        return cls(
            id=spec.get("id", ""),
            title=spec.get("title", ""),
            version=str(spec.get("version", "")),
            description=spec.get("description", ""),
            controls=[
                Control(
                    id=c.get("id", ""),
                    name=c.get("name", ""),
                    severity=c.get("severity", "MEDIUM"),
                    description=c.get("description", ""),
                    checks=[chk.get("id", "") for chk in c.get("checks", []) or []],
                    default_status=c.get("defaultStatus", ""),
                )
                for c in spec.get("controls", []) or []
            ],
        )


@dataclass
class ControlResult:
    control: Control
    status: str  # PASS | FAIL | MANUAL
    findings: list = field(default_factory=list)  # MisconfResult/finding dicts


@dataclass
class ComplianceReport:
    spec: ComplianceSpec
    results: list[ControlResult] = field(default_factory=list)

    @property
    def summary(self) -> dict:
        counts = {"PASS": 0, "FAIL": 0, "MANUAL": 0}
        for r in self.results:
            counts[r.status] = counts.get(r.status, 0) + 1
        return counts


def apply_spec(spec: ComplianceSpec, report: Report) -> ComplianceReport:
    """Per-control status from the scan's findings: a control FAILs when any
    of its check IDs produced a failure (misconfig FAIL or vulnerability),
    PASSes otherwise (ref: pkg/compliance/report/report.go buildControlCheckResults)."""
    failures: dict[str, list] = {}
    for result in report.results:
        for mc in result.misconfigurations:
            if mc.status == "FAIL":
                failures.setdefault(mc.id, []).append(mc)
                failures.setdefault(mc.avd_id, []).append(mc)
        for v in result.vulnerabilities:
            failures.setdefault(v.vulnerability_id, []).append(v)
        for s in result.secrets:
            failures.setdefault(s.rule_id, []).append(s)
    out = ComplianceReport(spec=spec)
    for control in spec.controls:
        if not control.checks:
            out.results.append(
                ControlResult(control, control.default_status or "MANUAL")
            )
            continue
        found: list = []
        for check_id in control.checks:
            found.extend(failures.get(check_id, []))
        out.results.append(
            ControlResult(control, "FAIL" if found else "PASS", found)
        )
    return out


def load_spec(name_or_path: str) -> ComplianceSpec:
    """``@file.yaml`` loads a user spec; otherwise a builtin spec name."""
    if name_or_path.startswith("@"):
        import yaml

        with open(name_or_path[1:], encoding="utf-8") as f:
            return ComplianceSpec.from_dict(yaml.safe_load(f) or {})
    spec = BUILTIN_SPECS.get(name_or_path)
    if spec is None:
        raise ValueError(
            f"unknown compliance spec {name_or_path!r} "
            f"(builtin: {', '.join(sorted(BUILTIN_SPECS))}; @path for custom)"
        )
    return spec


def write_report(creport: ComplianceReport, out, fmt: str = "table") -> None:
    if fmt == "json":
        import json

        json.dump(
            {
                "ID": creport.spec.id,
                "Title": creport.spec.title,
                "SummaryControls": creport.summary,
                "Results": [
                    {
                        "ID": r.control.id,
                        "Name": r.control.name,
                        "Severity": r.control.severity,
                        "Status": r.status,
                        "Findings": len(r.findings),
                    }
                    for r in creport.results
                ],
            },
            out, indent=2,
        )
        out.write("\n")
        return
    s = creport.summary
    out.write(f"\n{creport.spec.title} ({creport.spec.id})\n")
    out.write(
        f"PASS: {s.get('PASS', 0)}  FAIL: {s.get('FAIL', 0)}  "
        f"MANUAL: {s.get('MANUAL', 0)}\n"
    )
    out.write(f"{'ID':<12}{'Severity':<10}{'Status':<8}{'Issues':>7}  Name\n")
    out.write("-" * 78 + "\n")
    for r in creport.results:
        out.write(
            f"{r.control.id:<12}{r.control.severity:<10}{r.status:<8}"
            f"{len(r.findings):>7}  {r.control.name[:44]}\n"
        )


# ---------------------------------------------------------------------------
# builtin specs: public CIS / NSA control sets mapped onto this build's
# check IDs (docker DS* / kubernetes KSV*; control names follow the public
# benchmarks the reference's trivy-checks specs encode)
# ---------------------------------------------------------------------------

BUILTIN_SPECS: dict[str, ComplianceSpec] = {
    "docker-cis-1.6.0": ComplianceSpec(
        id="docker-cis-1.6.0",
        title="CIS Docker Community Edition Benchmark v1.6.0 (image checks)",
        version="1.6.0",
        controls=[
            Control(id="4.1", name="Ensure a user for the container has been created",
                    severity="MEDIUM", checks=["DS002"]),
            Control(id="4.2", name="Ensure containers use only trusted base images",
                    severity="MEDIUM", default_status="MANUAL"),
            Control(id="4.3", name="Ensure unnecessary packages are not installed",
                    severity="MEDIUM", checks=["DS015", "DS019", "DS020"]),
            Control(id="4.6", name="Ensure HEALTHCHECK instructions have been added",
                    severity="LOW", checks=["DS026"]),
            Control(id="4.7", name="Ensure update instructions are not used alone",
                    severity="MEDIUM", checks=["DS017"]),
            Control(id="4.9", name="Ensure COPY is used instead of ADD",
                    severity="LOW", checks=["DS005"]),
            Control(id="4.10", name="Ensure secrets are not stored in Dockerfiles",
                    severity="CRITICAL",
                    checks=["aws-access-key-id", "aws-secret-access-key",
                            "github-pat", "private-key", "generic-api-key"]),
            Control(id="4.11", name="Ensure only verified packages are installed",
                    severity="MEDIUM", default_status="MANUAL"),
        ],
    ),
    "k8s-nsa-1.0": ComplianceSpec(
        id="k8s-nsa-1.0",
        title="NSA/CISA Kubernetes Hardening Guidance v1.0 (workload checks)",
        version="1.0",
        controls=[
            Control(id="1.0", name="Non-root containers",
                    severity="MEDIUM", checks=["KSV012"]),
            Control(id="1.1", name="Immutable container file systems",
                    severity="LOW", checks=["KSV014"]),
            Control(id="1.2", name="Prevent privileged containers",
                    severity="HIGH", checks=["KSV017"]),
            Control(id="1.3", name="Share containers process namespaces",
                    severity="HIGH", checks=["KSV008"]),
            Control(id="1.4", name="Share host process namespaces",
                    severity="HIGH", checks=["KSV009"]),
            Control(id="1.5", name="Use the host network",
                    severity="HIGH", checks=["KSV010"]),
            Control(id="1.6", name="Run with root privileges or allow privilege escalation",
                    severity="MEDIUM", checks=["KSV001"]),
            Control(id="1.7", name="Restrict container capabilities",
                    severity="MEDIUM", checks=["KSV003", "KSV106"]),
            Control(id="1.8", name="Set memory requests and limits",
                    severity="LOW", checks=["KSV016", "KSV018"]),
            Control(id="1.9", name="Set CPU requests and limits",
                    severity="LOW", checks=["KSV015", "KSV011"]),
            Control(id="2.0", name="Protect pod service account tokens",
                    severity="MEDIUM", default_status="MANUAL"),
        ],
    ),
    # CIS Kubernetes Benchmark (worker-node sections evaluated through the
    # node-collector-equivalent KCV checks, trivy_tpu_torch/k8s_node.py; policy
    # sections through the KSV workload checks; control-plane flag checks
    # need the master collector -> MANUAL, like the reference marks
    # non-collectable controls)
    "k8s-cis-1.23": ComplianceSpec(
        id="k8s-cis-1.23",
        title="CIS Kubernetes Benchmark v1.23",
        version="1.23",
        controls=[
            Control(id="1.2.1", name="Ensure --anonymous-auth argument is false (API server)",
                    severity="CRITICAL", default_status="MANUAL"),
            Control(id="1.2.6", name="Ensure --authorization-mode is not AlwaysAllow (API server)",
                    severity="CRITICAL", default_status="MANUAL"),
            Control(id="4.1.1", name="Ensure kubelet service file permissions are 600 or more restrictive",
                    severity="HIGH", checks=["KCV0069"]),
            Control(id="4.1.2", name="Ensure kubelet service file ownership is root:root",
                    severity="HIGH", checks=["KCV0070"]),
            Control(id="4.1.3", name="If proxy kubeconfig exists ensure permissions are 600",
                    severity="HIGH", checks=["KCV0071"]),
            Control(id="4.1.4", name="If proxy kubeconfig exists ensure ownership is root:root",
                    severity="HIGH", checks=["KCV0072"]),
            Control(id="4.1.5", name="Ensure kubelet.conf file permissions are 600 or more restrictive",
                    severity="HIGH", checks=["KCV0073"]),
            Control(id="4.1.6", name="Ensure kubelet.conf file ownership is root:root",
                    severity="HIGH", checks=["KCV0074"]),
            Control(id="4.1.7", name="Ensure certificate authorities file permissions are 600",
                    severity="CRITICAL", checks=["KCV0075"]),
            Control(id="4.1.8", name="Ensure client CA file ownership is root:root",
                    severity="CRITICAL", checks=["KCV0076"]),
            Control(id="4.1.9", name="Ensure kubelet config.yaml permissions are 600",
                    severity="HIGH", checks=["KCV0077"]),
            Control(id="4.1.10", name="Ensure kubelet config.yaml ownership is root:root",
                    severity="HIGH", checks=["KCV0078"]),
            Control(id="4.2.1", name="Ensure --anonymous-auth argument is false",
                    severity="CRITICAL", checks=["KCV0079"]),
            Control(id="4.2.2", name="Ensure --authorization-mode is not AlwaysAllow",
                    severity="CRITICAL", checks=["KCV0080"]),
            Control(id="4.2.3", name="Ensure --client-ca-file argument is set",
                    severity="CRITICAL", checks=["KCV0081"]),
            Control(id="4.2.4", name="Verify that --read-only-port is 0",
                    severity="HIGH", checks=["KCV0082"]),
            Control(id="4.2.5", name="Ensure --streaming-connection-idle-timeout is not 0",
                    severity="HIGH", checks=["KCV0083"]),
            Control(id="4.2.6", name="Ensure --protect-kernel-defaults is true",
                    severity="HIGH", checks=["KCV0084"]),
            Control(id="4.2.7", name="Ensure --make-iptables-util-chains is true",
                    severity="HIGH", checks=["KCV0085"]),
            Control(id="4.2.8", name="Ensure --hostname-override is not set",
                    severity="HIGH", checks=["KCV0086"]),
            Control(id="4.2.9", name="Ensure --event-qps captures events",
                    severity="HIGH", checks=["KCV0087"]),
            Control(id="4.2.10", name="Ensure --tls-cert-file and --tls-private-key-file are set",
                    severity="CRITICAL", checks=["KCV0088", "KCV0089"]),
            Control(id="4.2.11", name="Ensure --rotate-certificates is present",
                    severity="HIGH", checks=["KCV0090"]),
            Control(id="4.2.12", name="Verify RotateKubeletServerCertificate is true",
                    severity="HIGH", checks=["KCV0091"]),
            Control(id="5.1.6", name="Ensure service account tokens only mounted when necessary",
                    severity="MEDIUM", default_status="MANUAL"),
            Control(id="5.2.2", name="Minimize admission of privileged containers",
                    severity="HIGH", checks=["KSV017"]),
            Control(id="5.2.3", name="Minimize wanting to share the host PID namespace",
                    severity="HIGH", checks=["KSV009"]),
            Control(id="5.2.4", name="Minimize admission of hostIPC containers",
                    severity="HIGH", checks=["KSV008"]),
            Control(id="5.2.5", name="Minimize admission of hostNetwork containers",
                    severity="HIGH", checks=["KSV010"]),
            Control(id="5.2.6", name="Minimize admission of allowPrivilegeEscalation",
                    severity="HIGH", checks=["KSV001"]),
            Control(id="5.2.7", name="Minimize admission of root containers",
                    severity="MEDIUM", checks=["KSV012"]),
            Control(id="5.2.8", name="Minimize admission of NET_RAW capability",
                    severity="MEDIUM", checks=["KSV003"]),
            Control(id="5.7.3", name="Apply security context to pods and containers",
                    severity="MEDIUM", checks=["KSV014"]),
        ],
    ),
    "eks-cis-1.4": ComplianceSpec(
        id="eks-cis-1.4",
        title="AWS EKS CIS Benchmark v1.4",
        version="1.4",
        controls=[
            Control(id="3.1.1", name="Ensure kubeconfig file permissions are 644 or more restrictive",
                    severity="HIGH", checks=["KCV0071"]),
            Control(id="3.1.2", name="Ensure kubelet kubeconfig file ownership is root:root",
                    severity="HIGH", checks=["KCV0072"]),
            Control(id="3.1.3", name="Ensure kubelet config file permissions are 644 or more restrictive",
                    severity="HIGH", checks=["KCV0077"]),
            Control(id="3.1.4", name="Ensure kubelet config file ownership is root:root",
                    severity="HIGH", checks=["KCV0078"]),
            Control(id="3.2.1", name="Ensure anonymous auth is not enabled",
                    severity="CRITICAL", checks=["KCV0079"]),
            Control(id="3.2.2", name="Ensure --authorization-mode is not AlwaysAllow",
                    severity="CRITICAL", checks=["KCV0080"]),
            Control(id="3.2.3", name="Ensure a client CA file is configured",
                    severity="CRITICAL", checks=["KCV0081"]),
            Control(id="3.2.4", name="Ensure --read-only-port is disabled",
                    severity="HIGH", checks=["KCV0082"]),
            Control(id="3.2.5", name="Ensure --streaming-connection-idle-timeout is not 0",
                    severity="HIGH", checks=["KCV0083"]),
            Control(id="3.2.6", name="Ensure --make-iptables-util-chains is true",
                    severity="HIGH", checks=["KCV0085"]),
            Control(id="3.2.7", name="Ensure --event-qps captures events",
                    severity="HIGH", checks=["KCV0087"]),
            Control(id="3.2.8", name="Ensure --rotate-certificates is true",
                    severity="HIGH", checks=["KCV0090"]),
            Control(id="3.2.9", name="Ensure RotateKubeletServerCertificate is true",
                    severity="HIGH", checks=["KCV0091"]),
            Control(id="4.2.1", name="Minimize admission of privileged containers",
                    severity="HIGH", checks=["KSV017"]),
            Control(id="4.2.2", name="Minimize hostPID sharing",
                    severity="HIGH", checks=["KSV009"]),
            Control(id="4.2.3", name="Minimize hostIPC sharing",
                    severity="HIGH", checks=["KSV008"]),
            Control(id="4.2.4", name="Minimize hostNetwork sharing",
                    severity="HIGH", checks=["KSV010"]),
            Control(id="4.2.5", name="Minimize allowPrivilegeEscalation",
                    severity="HIGH", checks=["KSV001"]),
            Control(id="4.2.6", name="Minimize admission of root containers",
                    severity="MEDIUM", checks=["KSV012"]),
            Control(id="5.1.1", name="Ensure image vulnerability scanning (ECR or third party)",
                    severity="MEDIUM", default_status="MANUAL"),
        ],
    ),
}
