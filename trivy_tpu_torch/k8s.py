"""Kubernetes vertical: scan cluster workloads and aggregate per-resource
(ref: pkg/k8s — the reference enumerates a live cluster through the
trivy-kubernetes library, scans each resource, and renders summary/all
reports).

Sources, in order of preference:

- ``--manifests <dir-or-file>``: exported manifests / cluster dumps
  (``kubectl get ... -o yaml|json``, incl. List objects) — works with
  zero cluster access.
- a live cluster via the ``kubectl`` binary when present (``kubectl get
  <kinds> -A -o json``), the no-client-library analog of the reference's
  cluster enumeration.

Each workload document runs through the misconfiguration engine's
kubernetes checks; results aggregate into per-resource rows with a
severity summary, like the reference's summary writer (pkg/k8s/report).
Workload images additionally scan through the registry image source
(``--scan-images``; fanal/image_registry.py pulls them straight from
their registries, matching pkg/k8s scanning images per resource).

The port of ``trivy_tpu/k8s.py``.
"""

from __future__ import annotations

import json
import os
import subprocess

from trivy_tpu_torch import log
from trivy_tpu_torch.device import DEFAULT_DEVICE
from trivy_tpu_torch.misconf.scanner import MisconfScanner, ScannerOption

logger = log.logger("k8s")

WORKLOAD_KINDS = (
    "Pod", "Deployment", "StatefulSet", "DaemonSet", "ReplicaSet",
    "Job", "CronJob",
)
_KUBECTL_KINDS = "pods,deployments,statefulsets,daemonsets,replicasets,jobs,cronjobs"

SEVERITIES = ("CRITICAL", "HIGH", "MEDIUM", "LOW", "UNKNOWN")


def _flatten(doc) -> list[dict]:
    """Expand List/Table objects into their items."""
    if not isinstance(doc, dict):
        return []
    if doc.get("kind", "").endswith("List") and isinstance(doc.get("items"), list):
        out = []
        for item in doc["items"]:
            out.extend(_flatten(item))
        return out
    if doc.get("kind") and doc.get("apiVersion"):
        return [doc]
    return []


def load_manifests(path: str) -> list[dict]:
    """Workload documents from a manifest file or directory tree."""
    import yaml

    docs: list[dict] = []
    errors: list[str] = []

    def load_file(p: str) -> None:
        try:
            with open(p, encoding="utf-8", errors="replace") as f:
                text = f.read()
            if p.endswith(".json"):
                docs.extend(_flatten(json.loads(text)))
            else:
                for d in yaml.safe_load_all(text):
                    docs.extend(_flatten(d))
        except Exception as e:
            errors.append(f"{p}: {e}")
            logger.warning("cannot parse %s: %s", p, e)

    if os.path.isdir(path):
        for root, _dirs, names in os.walk(path):
            for name in sorted(names):
                if name.endswith((".yaml", ".yml", ".json")):
                    load_file(os.path.join(root, name))
    else:
        load_file(path)
    if not docs and errors:
        # every input failed: a clean '0 workloads' report would lie
        raise RuntimeError(
            f"no parseable manifests in {path} ({len(errors)} errors; first: "
            f"{errors[0][:200]})"
        )
    return docs


def load_cluster(context: str | None = None) -> list[dict]:
    """Enumerate workloads with kubectl (the zero-dependency cluster path)."""
    cmd = ["kubectl", "get", _KUBECTL_KINDS, "-A", "-o", "json"]
    if context:
        cmd += ["--context", context]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except FileNotFoundError:
        raise RuntimeError(
            "kubectl not found — use --manifests with exported resources"
        ) from None
    except subprocess.TimeoutExpired as e:
        raise RuntimeError("kubectl timed out after 120s") from e
    if proc.returncode != 0:
        raise RuntimeError(f"kubectl failed: {proc.stderr.strip()[:300]}")
    try:
        return _flatten(json.loads(proc.stdout))
    except json.JSONDecodeError as e:
        raise RuntimeError(f"kubectl produced invalid JSON: {e}") from e


def scan_workloads(docs: list[dict], scanner: MisconfScanner | None = None,
                   secret_scanner=None):
    """Per-resource rows carrying both scanner classes the manifest itself
    can produce (ref: the k8s report aggregates every class per resource):
    [{namespace, kind, name, severities{...}, failures[...], secrets[...]}].
    Image vulnerabilities ride the separate --scan-images rows."""
    import yaml

    from trivy_tpu_torch import k8s_node

    scanner = scanner or MisconfScanner(ScannerOption(file_types=["kubernetes"]))
    if secret_scanner is None:
        from trivy_tpu_torch.secret.engine import SecretScanner

        secret_scanner = SecretScanner()
    rows = []
    for doc in docs:
        kind = doc.get("kind", "")
        if k8s_node.is_node_info(doc):
            # node-collector output in the dump: infra assessment rows
            mc = k8s_node.scan_node_info(doc)
            sev = {s: 0 for s in SEVERITIES}
            for f in mc.failures:
                sev[f.severity if f.severity in sev else "UNKNOWN"] += 1
            rows.append({
                "namespace": "node",
                "kind": "NodeInfo",
                "name": mc.file_path.split("/", 1)[-1],
                "severities": sev,
                "failures": list(mc.failures),
                "successes": list(mc.successes),
            })
            continue
        if kind not in WORKLOAD_KINDS:
            continue
        meta = doc.get("metadata", {}) or {}
        name = meta.get("name", "")
        namespace = meta.get("namespace", "default")
        text = yaml.safe_dump(doc, sort_keys=False)
        mc = scanner.scan_file(f"{namespace}/{kind}/{name}.yaml", text.encode(),
                               "kubernetes")
        failures = list(mc.failures) if mc else []
        secret = secret_scanner.scan_bytes(
            f"{namespace}/{kind}/{name}.yaml", text.encode()
        )
        sev = {s: 0 for s in SEVERITIES}
        for f in failures:
            sev[f.severity if f.severity in sev else "UNKNOWN"] += 1
        for sf in secret.findings:
            sev[sf.severity if sf.severity in sev else "UNKNOWN"] += 1
        rows.append({
            "namespace": namespace,
            "kind": kind,
            "name": name,
            "severities": sev,
            "failures": failures,
            "secrets": list(secret.findings),
        })
    rows.sort(key=lambda r: (r["namespace"], r["kind"], r["name"]))
    return rows


def write_summary(rows: list[dict], out, fmt: str = "table",
                  image_rows: list[dict] | None = None) -> None:
    if fmt == "json":
        doc = {
            "Resources": [
                {
                    "Namespace": r["namespace"],
                    "Kind": r["kind"],
                    "Name": r["name"],
                    "Summary": r["severities"],
                    "Misconfigurations": [f.to_dict() for f in r["failures"]],
                    "Secrets": [s.to_dict() for s in r.get("secrets", [])],
                }
                for r in rows
            ],
        }
        if image_rows is not None:
            doc["Images"] = [
                {
                    "Image": r["image"],
                    "Summary": r["severities"],
                    "Findings": r["findings"],
                    "Error": r["error"],
                }
                for r in image_rows
            ]
        json.dump(doc, out, indent=2)
        out.write("\n")
        return
    out.write("\nWorkload Assessment\n")
    header = f"{'Namespace':<16}{'Kind':<13}{'Name':<28}" + "".join(
        f"{s[0]:>4}" for s in SEVERITIES
    )
    out.write(header + "\n")
    out.write("-" * len(header) + "\n")
    for r in rows:
        out.write(
            f"{r['namespace']:<16}{r['kind']:<13}{r['name'][:27]:<28}"
            + "".join(f"{r['severities'][s]:>4}" for s in SEVERITIES)
            + "\n"
        )
    total = sum(sum(r["severities"].values()) for r in rows)
    out.write(f"\n{len(rows)} workloads, {total} misconfigurations\n")
    if image_rows is not None:
        write_image_summary(image_rows, out)


def write_image_summary(image_rows: list[dict], out) -> None:
    out.write("\nWorkload Images\n")
    for r in image_rows:
        sev = " ".join(f"{k[0]}:{v}" for k, v in r["severities"].items() if v)
        status = r["error"] or (sev or "clean")
        out.write(f"  {r['image']:<52} {status}\n")


def workload_images(docs: list[dict]) -> list[str]:
    """Unique container image references across workload pod specs."""
    images: set[str] = set()
    for doc in docs:
        if doc.get("kind") not in WORKLOAD_KINDS:
            continue
        spec = doc.get("spec", {}) or {}
        pod = spec
        # walk template chains (Deployment -> template -> spec, CronJob ->
        # jobTemplate -> template -> spec)
        for key in ("jobTemplate", "template"):
            t = pod.get(key)
            if isinstance(t, dict):
                pod = t.get("spec", t) or {}
        for ckey in ("containers", "initContainers", "ephemeralContainers"):
            for c in pod.get(ckey, []) or []:
                if isinstance(c, dict) and c.get("image"):
                    images.add(str(c["image"]))
    return sorted(images)


def scan_images(images: list[str], cache_dir: str | None = None,
                insecure: bool = False, scanners: list[str] | None = None,
                db=None, device=DEFAULT_DEVICE) -> list[dict]:
    """Scan workload images via the registry source; per-image rows with a
    vulnerability/secret severity summary (pkg/k8s image scanning analog).
    Unreachable images degrade to an error row, never a failed scan.

    Each image is the port's ``image`` scan (``cli.scan_image``) on
    ``device``: its layers through the secret feed's kernels, and with a
    ``db`` its packages through the CVE join. Without a ``db`` no DB is
    looked for, and ``vuln`` finds nothing, as in the JAX package. A kernel
    fault (``ops._build.kernel_fault``) is raised, not made a row."""
    from trivy_tpu_torch.artifact.image import ImageSourceOption
    from trivy_tpu_torch.cache import new_cache
    from trivy_tpu_torch.cli import scan_image
    from trivy_tpu_torch.ops._build import kernel_fault

    scanners = scanners or ["vuln", "secret"]
    if db is None:
        # scan_image would look for a DB of its own
        scanners = [s for s in scanners if s != "vuln"] or ["secret"]
    cache = new_cache("fs" if cache_dir else "memory", cache_dir)
    rows: list[dict] = []
    for image in images:
        sev = {s: 0 for s in SEVERITIES}
        try:
            report, _counters = scan_image(
                image, device=device, scanners=scanners, db=db, cache=cache,
                image_source=ImageSourceOption(insecure_registry=insecure))
            findings = []
            for r in report.results:
                for v in r.vulnerabilities:
                    s = v.severity if v.severity in sev else "UNKNOWN"
                    sev[s] += 1
                    findings.append(v.to_dict())
                for s_f in r.secrets:
                    s = s_f.severity if s_f.severity in sev else "UNKNOWN"
                    sev[s] += 1
                    findings.append(s_f.to_dict())
            rows.append({"image": image, "severities": sev,
                         "findings": findings, "error": ""})
        except Exception as e:
            if kernel_fault(e):
                # a kernel that does not work fails the command, never a row
                raise
            logger.warning("image scan failed for %s: %s", image, e)
            rows.append({"image": image, "severities": sev,
                         "findings": [], "error": str(e)})
    return rows
