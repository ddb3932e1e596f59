"""Kubernetes node-configuration assessment (node-collector equivalent).

The reference deploys aquasecurity's node-collector as a DaemonSet to
gather kubelet/control-plane configuration and file permissions, then
evaluates KCV checks over the resulting ``NodeInfo`` documents (ref:
pkg/k8s/scanner/scanner.go:276,442-520 nodeComponent + the trivy-checks
KCV bundle). A live DaemonSet needs a cluster; the offline equivalent here
evaluates the same checks over node-collector output documents found in
the cluster dump (``kind: NodeInfo`` / ``"type": "node-collector"``) —
the exact JSON the collector emits, so a dump captured with the real
collector scans identically.

Check IDs and expectations follow the public trivy-checks KCV set for
worker nodes (CIS Kubernetes Benchmark sections 4.1/4.2 — the sections
the node-collector covers on every node; control-plane checks apply only
to self-managed masters).

The port of ``trivy_tpu/k8s_node.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

from trivy_tpu_torch.types import Misconfiguration, MisconfResult


@dataclass(frozen=True)
class NodeCheck:
    id: str
    title: str
    severity: str
    info_key: str
    op: str  # mode_max | eq | ne | in | set | bool_true | bool_false | ge
    expected: object = None


# worker-node checks (CIS 4.1.x file permissions/ownership, 4.2.x kubelet
# arguments), matching the node-collector's info keys
NODE_CHECKS: list[NodeCheck] = [
    NodeCheck("KCV0069", "Ensure kubelet service file permissions are 600 or more restrictive",
              "HIGH", "kubeletServiceFilePermissions", "mode_max", 0o600),
    NodeCheck("KCV0070", "Ensure kubelet service file ownership is root:root",
              "HIGH", "kubeletServiceFileOwnership", "eq", "root:root"),
    NodeCheck("KCV0071", "Ensure proxy kubeconfig file permissions are 600 or more restrictive",
              "HIGH", "kubeconfigFileExistsPermissions", "mode_max", 0o600),
    NodeCheck("KCV0072", "Ensure proxy kubeconfig file ownership is root:root",
              "HIGH", "kubeconfigFileExistsOwnership", "eq", "root:root"),
    NodeCheck("KCV0073", "Ensure kubelet.conf file permissions are 600 or more restrictive",
              "HIGH", "kubeletConfFilePermissions", "mode_max", 0o600),
    NodeCheck("KCV0074", "Ensure kubelet.conf file ownership is root:root",
              "HIGH", "kubeletConfFileOwnership", "eq", "root:root"),
    NodeCheck("KCV0075", "Ensure certificate authorities file permissions are 600 or more restrictive",
              "CRITICAL", "certificateAuthoritiesFilePermissions", "mode_max", 0o600),
    NodeCheck("KCV0076", "Ensure client certificate authorities file ownership is root:root",
              "CRITICAL", "certificateAuthoritiesFileOwnership", "eq", "root:root"),
    NodeCheck("KCV0077", "Ensure kubelet config.yaml permissions are 600 or more restrictive",
              "HIGH", "kubeletConfigYamlConfigurationFilePermission", "mode_max", 0o600),
    NodeCheck("KCV0078", "Ensure kubelet config.yaml ownership is root:root",
              "HIGH", "kubeletConfigYamlConfigurationFileOwnership", "eq", "root:root"),
    NodeCheck("KCV0079", "Ensure kubelet --anonymous-auth argument is false",
              "CRITICAL", "kubeletAnonymousAuthArgumentSet", "bool_false", None),
    NodeCheck("KCV0080", "Ensure kubelet --authorization-mode argument is not AlwaysAllow",
              "CRITICAL", "kubeletAuthorizationModeArgumentSet", "ne", "AlwaysAllow"),
    NodeCheck("KCV0081", "Ensure kubelet --client-ca-file argument is set",
              "CRITICAL", "kubeletClientCaFileArgumentSet", "set", None),
    NodeCheck("KCV0082", "Ensure kubelet --read-only-port argument is 0",
              "HIGH", "kubeletReadOnlyPortArgumentSet", "eq", "0"),
    NodeCheck("KCV0083", "Ensure kubelet --streaming-connection-idle-timeout is not 0",
              "HIGH", "kubeletStreamingConnectionIdleTimeoutArgumentSet", "ne", "0"),
    NodeCheck("KCV0084", "Ensure kubelet --protect-kernel-defaults is true",
              "HIGH", "kubeletProtectKernelDefaultsArgumentSet", "bool_true", None),
    NodeCheck("KCV0085", "Ensure kubelet --make-iptables-util-chains is true",
              "HIGH", "kubeletMakeIptablesUtilChainsArgumentSet", "bool_true", None),
    NodeCheck("KCV0086", "Ensure kubelet --hostname-override is not set",
              "HIGH", "kubeletHostnameOverrideArgumentSet", "unset", None),
    NodeCheck("KCV0087", "Ensure kubelet --event-qps argument is 0 or a level that ensures capture",
              "HIGH", "kubeletEventQpsArgumentSet", "ge", 0),
    NodeCheck("KCV0088", "Ensure kubelet --tls-cert-file argument is set",
              "CRITICAL", "kubeletTlsCertFileTlsArgumentSet", "set", None),
    NodeCheck("KCV0089", "Ensure kubelet --tls-private-key-file argument is set",
              "CRITICAL", "kubeletTlsPrivateKeyFileArgumentSet", "set", None),
    NodeCheck("KCV0090", "Ensure kubelet --rotate-certificates argument is true",
              "HIGH", "kubeletRotateCertificatesArgumentSet", "bool_true", None),
    NodeCheck("KCV0091", "Ensure kubelet RotateKubeletServerCertificate is true",
              "HIGH", "kubeletRotateKubeletServerCertificateArgumentSet", "bool_true", None),
]


def is_node_info(doc: dict) -> bool:
    return (
        doc.get("kind") == "NodeInfo"
        or doc.get("type") == "node-collector"
    )


def _values(info: dict, key: str) -> list:
    entry = info.get(key)
    if isinstance(entry, dict):
        vals = entry.get("values")
        return list(vals) if isinstance(vals, list) else []
    if isinstance(entry, list):
        return list(entry)
    if entry is None:
        return []
    return [entry]


def _as_mode(v) -> int | None:
    """node-collector reports permissions as decimal-rendered octal (600
    means 0o600)."""
    try:
        return int(str(v), 8)
    except (TypeError, ValueError):
        return None


def _check_one(check: NodeCheck, info: dict) -> tuple[str, str]:
    """-> (status, message); missing info keys are MANUAL-ish passes the
    way the rego checks no-op when the collector didn't gather a field."""
    vals = _values(info, check.info_key)
    if not vals:
        if check.op in ("set", "bool_true"):
            # absence of a required setting is the failure the check exists
            # to catch only when the collector reported the key at all
            return ("PASS", "") if check.info_key not in info else (
                "FAIL", f"{check.info_key} is not set"
            )
        return "PASS", ""
    v = vals[0]
    ok = True
    if check.op == "mode_max":
        mode = _as_mode(v)
        ok = mode is not None and mode <= check.expected
    elif check.op == "eq":
        ok = str(v) == str(check.expected)
    elif check.op == "ne":
        ok = str(v) != str(check.expected)
    elif check.op == "set":
        ok = str(v) != ""
    elif check.op == "unset":
        ok = str(v) == ""
    elif check.op == "bool_true":
        ok = str(v).lower() == "true"
    elif check.op == "bool_false":
        ok = str(v).lower() == "false"
    elif check.op == "ge":
        try:
            ok = float(v) >= check.expected
        except (TypeError, ValueError):
            ok = False
    if ok:
        return "PASS", ""
    return "FAIL", f"{check.info_key} = {v!r} violates: {check.title}"


def scan_node_info(doc: dict) -> Misconfiguration:
    """Evaluate the node checks over one NodeInfo document."""
    meta = doc.get("metadata") or {}
    node_name = str(
        doc.get("nodeName") or meta.get("name") or "node"
    )
    info = doc.get("info") or {}
    mc = Misconfiguration(
        file_type="kubernetes", file_path=f"node/{node_name}"
    )
    for check in NODE_CHECKS:
        status, message = _check_one(check, info)
        res = MisconfResult(
            id=check.id,
            avd_id=f"AVD-{check.id[:3]}-{check.id[3:]}",
            type="Kubernetes Security Check",
            title=check.title,
            message=message or check.title,
            namespace=f"builtin.kubernetes.{check.id}",
            severity=check.severity,
            status=status,
            resource=node_name,
            service="node",
        )
        (mc.failures if status == "FAIL" else mc.successes).append(res)
    return mc


def scan_nodes(docs: list[dict]) -> list[Misconfiguration]:
    return [scan_node_info(d) for d in docs if is_node_info(d)]
