"""Kubernetes manifest view: normalized workload/container access (the
port of ``trivy_tpu/misconf/parse/kubernetes.py``).

Equivalent of the reference's k8s scanner input adaptation (ref:
pkg/iac/scanners/kubernetes/): each YAML document becomes a Workload with
pod-spec resolution across kinds (Pod, Deployment-family templates,
CronJob job templates) so KSV checks address containers uniformly.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from trivy_tpu_torch.misconf.parse.yamljson import LMap, LSeq, load_all, span_of

_TEMPLATE_KINDS = {
    "Deployment",
    "StatefulSet",
    "DaemonSet",
    "ReplicaSet",
    "ReplicationController",
    "Job",
}


@dataclass
class Container:
    raw: LMap
    name: str
    kind: str  # "container" | "initContainer" | "ephemeralContainer"

    @property
    def span(self):
        return span_of(self.raw)

    def security_context(self) -> dict:
        sc = self.raw.get("securityContext")
        return sc if isinstance(sc, dict) else {}

    def resources(self) -> dict:
        r = self.raw.get("resources")
        return r if isinstance(r, dict) else {}


@dataclass
class Workload:
    raw: LMap
    kind: str
    name: str
    pod_spec: LMap | None
    containers: list[Container] = field(default_factory=list)

    @property
    def span(self):
        return span_of(self.raw)

    def pod_security_context(self) -> dict:
        if self.pod_spec is None:
            return {}
        sc = self.pod_spec.get("securityContext")
        return sc if isinstance(sc, dict) else {}


def _pod_spec(doc: LMap) -> LMap | None:
    kind = doc.get("kind")
    spec = doc.get("spec")
    if not isinstance(spec, dict):
        return None
    if kind == "Pod":
        return spec if isinstance(spec, LMap) else None
    if kind in _TEMPLATE_KINDS:
        tmpl = spec.get("template")
        if isinstance(tmpl, dict):
            ps = tmpl.get("spec")
            return ps if isinstance(ps, LMap) else None
    if kind == "CronJob":
        jt = spec.get("jobTemplate")
        if isinstance(jt, dict):
            tmpl = jt.get("spec", {})
            if isinstance(tmpl, dict):
                tmpl = tmpl.get("template")
                if isinstance(tmpl, dict):
                    ps = tmpl.get("spec")
                    return ps if isinstance(ps, LMap) else None
    return None


def parse(content: bytes) -> list[Workload]:
    workloads = []
    for doc in load_all(content):
        if not isinstance(doc, LMap) or "kind" not in doc:
            continue
        kind = str(doc.get("kind"))
        meta = doc.get("metadata")
        name = ""
        if isinstance(meta, dict):
            name = str(meta.get("name", ""))
        ps = _pod_spec(doc)
        containers: list[Container] = []
        if ps is not None:
            for key, ckind in (
                ("containers", "container"),
                ("initContainers", "initContainer"),
                ("ephemeralContainers", "ephemeralContainer"),
            ):
                seq = ps.get(key)
                if isinstance(seq, LSeq):
                    for c in seq:
                        if isinstance(c, LMap):
                            containers.append(
                                Container(raw=c, name=str(c.get("name", "")), kind=ckind)
                            )
        workloads.append(
            Workload(raw=doc, kind=kind, name=name, pod_spec=ps, containers=containers)
        )
    return workloads
