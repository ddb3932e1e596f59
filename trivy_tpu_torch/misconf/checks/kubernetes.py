"""Builtin Kubernetes workload checks (KSV series), the port of
``trivy_tpu/misconf/checks/kubernetes.py``.

Independently-authored equivalents of the reference's embedded k8s check
bundle (pod-security best practices; KSV IDs are the public interface).
Checks walk the normalized Workload/Container views from
``misconf.parse.kubernetes`` and report line causes from the YAML spans.
"""

from __future__ import annotations

from trivy_tpu_torch.misconf.checks import Check, Failure, register
from trivy_tpu_torch.misconf.parse.kubernetes import Container, Workload
from trivy_tpu_torch.misconf.parse.yamljson import span_of

_K8S = ("kubernetes",)
_URL = "https://avd.aquasec.com/misconfig/{}"

# kinds that carry pod specs — checks are no-ops elsewhere (Service etc.)
_WORKLOAD_KINDS = {
    "Pod", "Deployment", "StatefulSet", "DaemonSet", "ReplicaSet",
    "ReplicationController", "Job", "CronJob",
}


def _check(id_, avd, title, severity, desc="", res=""):
    def wrap(fn):
        def run(workloads):
            for w in workloads:
                if w.kind in _WORKLOAD_KINDS and w.pod_spec is not None:
                    yield from fn(w)

        register(
            Check(
                id=id_,
                avd_id=avd,
                title=title,
                severity=severity,
                file_types=_K8S,
                fn=run,
                description=desc,
                resolution=res,
                url=_URL.format(id_.lower()),
                service="general",
                provider="kubernetes",
            )
        )
        return fn

    return wrap


def _cname(w: Workload, c: Container) -> str:
    return f"{w.kind.lower()} {w.name or '<unnamed>'} container {c.name or '<unnamed>'}"


def _cspan(c: Container):
    s, e = span_of(c.raw)
    return s, e


@_check("KSV001", "AVD-KSV-0001", "Process can elevate its own privileges", "MEDIUM",
        "A process can gain more privileges than its parent.",
        "Set securityContext.allowPrivilegeEscalation to false.")
def allow_priv_escalation(w: Workload):
    for c in w.containers:
        if c.security_context().get("allowPrivilegeEscalation") is not False:
            s, e = _cspan(c)
            yield Failure(
                message=f"Container '{c.name}' of {w.kind} '{w.name}' should set 'securityContext.allowPrivilegeEscalation' to false",
                start_line=s, end_line=e, resource=_cname(w, c),
            )


@_check("KSV003", "AVD-KSV-0003", "Default capabilities not dropped", "LOW",
        "Containers keep a broad default capability set.",
        "Add 'ALL' to securityContext.capabilities.drop.")
def drop_capabilities(w: Workload):
    for c in w.containers:
        caps = c.security_context().get("capabilities")
        drop = caps.get("drop", []) if isinstance(caps, dict) else []
        if not any(str(d).upper() == "ALL" for d in (drop or [])):
            s, e = _cspan(c)
            yield Failure(
                message=f"Container '{c.name}' of {w.kind} '{w.name}' should add 'ALL' to 'securityContext.capabilities.drop'",
                start_line=s, end_line=e, resource=_cname(w, c),
            )


@_check("KSV008", "AVD-KSV-0008", "Access to host IPC namespace", "HIGH",
        "Sharing the host IPC namespace exposes host processes.",
        "Remove 'hostIPC: true'.")
def host_ipc(w: Workload):
    if w.pod_spec.get("hostIPC") is True:
        line = w.pod_spec.line("hostIPC")
        yield Failure(
            message=f"{w.kind} '{w.name}' should not set 'spec.hostIPC' to true",
            start_line=line, end_line=line, resource=f"{w.kind} {w.name}",
        )


@_check("KSV009", "AVD-KSV-0009", "Access to host network", "HIGH",
        "Host networking bypasses network policy.", "Remove 'hostNetwork: true'.")
def host_network(w: Workload):
    if w.pod_spec.get("hostNetwork") is True:
        line = w.pod_spec.line("hostNetwork")
        yield Failure(
            message=f"{w.kind} '{w.name}' should not set 'spec.hostNetwork' to true",
            start_line=line, end_line=line, resource=f"{w.kind} {w.name}",
        )


@_check("KSV010", "AVD-KSV-0010", "Access to host PID namespace", "HIGH",
        "Sharing the host PID namespace exposes host processes.",
        "Remove 'hostPID: true'.")
def host_pid(w: Workload):
    if w.pod_spec.get("hostPID") is True:
        line = w.pod_spec.line("hostPID")
        yield Failure(
            message=f"{w.kind} '{w.name}' should not set 'spec.hostPID' to true",
            start_line=line, end_line=line, resource=f"{w.kind} {w.name}",
        )


@_check("KSV011", "AVD-KSV-0011", "CPU not limited", "LOW",
        "Unbounded CPU lets one workload starve the node.",
        "Set resources.limits.cpu.")
def cpu_limit(w: Workload):
    for c in w.containers:
        limits = c.resources().get("limits")
        if not isinstance(limits, dict) or "cpu" not in limits:
            s, e = _cspan(c)
            yield Failure(
                message=f"Container '{c.name}' of {w.kind} '{w.name}' should set 'resources.limits.cpu'",
                start_line=s, end_line=e, resource=_cname(w, c),
            )


@_check("KSV012", "AVD-KSV-0012", "Runs as root user", "MEDIUM",
        "Root in the container is root against the kernel.",
        "Set securityContext.runAsNonRoot to true.")
def run_as_non_root(w: Workload):
    pod_sc = w.pod_security_context()
    for c in w.containers:
        sc = c.security_context()
        if sc.get("runAsNonRoot") is not True and pod_sc.get("runAsNonRoot") is not True:
            s, e = _cspan(c)
            yield Failure(
                message=f"Container '{c.name}' of {w.kind} '{w.name}' should set 'securityContext.runAsNonRoot' to true",
                start_line=s, end_line=e, resource=_cname(w, c),
            )


@_check("KSV013", "AVD-KSV-0013", "Image tag ':latest' used", "MEDIUM",
        "Mutable tags make deployments unreproducible.",
        "Use a specific image tag or digest.")
def image_tag(w: Workload):
    for c in w.containers:
        image = str(c.raw.get("image", ""))
        if not image or "@" in image:
            continue
        name = image.rsplit("/", 1)[-1]
        tag = name.split(":", 1)[1] if ":" in name else ""
        if tag == "latest" or not tag:
            line = c.raw.line("image")
            yield Failure(
                message=f"Container '{c.name}' of {w.kind} '{w.name}' should specify an image tag",
                start_line=line, end_line=line, resource=_cname(w, c),
            )


@_check("KSV014", "AVD-KSV-0014", "Root file system is not read-only", "LOW",
        "A writable root filesystem lets attackers persist changes.",
        "Set securityContext.readOnlyRootFilesystem to true.")
def read_only_root_fs(w: Workload):
    for c in w.containers:
        if c.security_context().get("readOnlyRootFilesystem") is not True:
            s, e = _cspan(c)
            yield Failure(
                message=f"Container '{c.name}' of {w.kind} '{w.name}' should set 'securityContext.readOnlyRootFilesystem' to true",
                start_line=s, end_line=e, resource=_cname(w, c),
            )


@_check("KSV015", "AVD-KSV-0015", "CPU requests not specified", "LOW",
        "Schedulers need CPU requests to place pods sanely.",
        "Set resources.requests.cpu.")
def cpu_requests(w: Workload):
    for c in w.containers:
        req = c.resources().get("requests")
        if not isinstance(req, dict) or "cpu" not in req:
            s, e = _cspan(c)
            yield Failure(
                message=f"Container '{c.name}' of {w.kind} '{w.name}' should set 'resources.requests.cpu'",
                start_line=s, end_line=e, resource=_cname(w, c),
            )


@_check("KSV016", "AVD-KSV-0016", "Memory requests not specified", "LOW",
        "Schedulers need memory requests to place pods sanely.",
        "Set resources.requests.memory.")
def memory_requests(w: Workload):
    for c in w.containers:
        req = c.resources().get("requests")
        if not isinstance(req, dict) or "memory" not in req:
            s, e = _cspan(c)
            yield Failure(
                message=f"Container '{c.name}' of {w.kind} '{w.name}' should set 'resources.requests.memory'",
                start_line=s, end_line=e, resource=_cname(w, c),
            )


@_check("KSV017", "AVD-KSV-0017", "Privileged container", "HIGH",
        "Privileged containers get every capability and host device access.",
        "Remove 'privileged: true'.")
def privileged(w: Workload):
    for c in w.containers:
        if c.security_context().get("privileged") is True:
            line = c.security_context().line("privileged") if hasattr(
                c.security_context(), "line") else 0
            s, e = _cspan(c)
            yield Failure(
                message=f"Container '{c.name}' of {w.kind} '{w.name}' should set 'securityContext.privileged' to false",
                start_line=line or s, end_line=line or e, resource=_cname(w, c),
            )


@_check("KSV018", "AVD-KSV-0018", "Memory not limited", "LOW",
        "Unbounded memory invites node-level OOM kills.",
        "Set resources.limits.memory.")
def memory_limit(w: Workload):
    for c in w.containers:
        limits = c.resources().get("limits")
        if not isinstance(limits, dict) or "memory" not in limits:
            s, e = _cspan(c)
            yield Failure(
                message=f"Container '{c.name}' of {w.kind} '{w.name}' should set 'resources.limits.memory'",
                start_line=s, end_line=e, resource=_cname(w, c),
            )


@_check("KSV020", "AVD-KSV-0020", "Runs with UID <= 10000", "LOW",
        "Low UIDs may collide with host system users.",
        "Set securityContext.runAsUser to a value > 10000.")
def run_as_high_uid(w: Workload):
    pod_sc = w.pod_security_context()
    for c in w.containers:
        sc = c.security_context()
        uid = sc.get("runAsUser", pod_sc.get("runAsUser"))
        if uid is None or (isinstance(uid, int) and uid <= 10000):
            s, e = _cspan(c)
            yield Failure(
                message=f"Container '{c.name}' of {w.kind} '{w.name}' should set 'securityContext.runAsUser' > 10000",
                start_line=s, end_line=e, resource=_cname(w, c),
            )


@_check("KSV021", "AVD-KSV-0021", "Runs with GID <= 10000", "LOW",
        "Low GIDs may collide with host system groups.",
        "Set securityContext.runAsGroup to a value > 10000.")
def run_as_high_gid(w: Workload):
    pod_sc = w.pod_security_context()
    for c in w.containers:
        sc = c.security_context()
        gid = sc.get("runAsGroup", pod_sc.get("runAsGroup"))
        if gid is None or (isinstance(gid, int) and gid <= 10000):
            s, e = _cspan(c)
            yield Failure(
                message=f"Container '{c.name}' of {w.kind} '{w.name}' should set 'securityContext.runAsGroup' > 10000",
                start_line=s, end_line=e, resource=_cname(w, c),
            )


@_check("KSV023", "AVD-KSV-0023", "hostPath volume mounted", "MEDIUM",
        "hostPath mounts pierce the container filesystem boundary.",
        "Do not mount hostPath volumes.")
def host_path(w: Workload):
    vols = w.pod_spec.get("volumes")
    if not isinstance(vols, list):
        return
    for v in vols:
        if isinstance(v, dict) and "hostPath" in v:
            s, e = span_of(v, w.pod_spec.span)
            yield Failure(
                message=f"{w.kind} '{w.name}' should not set 'spec.volumes[*].hostPath'",
                start_line=s, end_line=e, resource=f"{w.kind} {w.name}",
            )


@_check("KSV030", "AVD-KSV-0030", "Runtime/default seccomp profile not set", "LOW",
        "Without a seccomp profile the syscall surface is unrestricted.",
        "Set securityContext.seccompProfile.type to RuntimeDefault.")
def seccomp(w: Workload):
    pod_sc = w.pod_security_context()
    pod_prof = pod_sc.get("seccompProfile")
    pod_ok = isinstance(pod_prof, dict) and pod_prof.get("type") in (
        "RuntimeDefault", "Localhost")
    for c in w.containers:
        prof = c.security_context().get("seccompProfile")
        ok = isinstance(prof, dict) and prof.get("type") in (
            "RuntimeDefault", "Localhost")
        if not ok and not pod_ok:
            s, e = _cspan(c)
            yield Failure(
                message=f"Container '{c.name}' of {w.kind} '{w.name}' should set 'securityContext.seccompProfile.type' to 'RuntimeDefault'",
                start_line=s, end_line=e, resource=_cname(w, c),
            )


@_check("KSV106", "AVD-KSV-0106", "Container capabilities must only include NET_BIND_SERVICE", "LOW",
        "Restricted pod security standard allows only NET_BIND_SERVICE adds.",
        "Drop ALL capabilities and add only NET_BIND_SERVICE if needed.")
def restricted_capabilities(w: Workload):
    for c in w.containers:
        caps = c.security_context().get("capabilities")
        add = caps.get("add", []) if isinstance(caps, dict) else []
        bad = [str(a) for a in (add or []) if str(a).upper() not in ("NET_BIND_SERVICE",)]
        if bad:
            s, e = _cspan(c)
            yield Failure(
                message=f"Container '{c.name}' of {w.kind} '{w.name}' adds disallowed capabilities {bad}",
                start_line=s, end_line=e, resource=_cname(w, c),
            )


# -- round-4 additions: pod hardening, volumes, namespaces, RBAC --------------

@_check("KSV002", "AVD-KSV-0002", "Default AppArmor profile not set", "MEDIUM",
        "Containers should run under an AppArmor profile.",
        "Annotate container.apparmor.security.beta.kubernetes.io/<name>.")
def apparmor_profile(w: Workload):
    meta = w.raw.get("metadata")
    annotations = (
        meta.get("annotations") if isinstance(meta, dict) else None
    )
    annotations = annotations if isinstance(annotations, dict) else {}
    # pod templates carry annotations in spec.template.metadata
    tmpl = w.raw.get("spec")
    if isinstance(tmpl, dict):
        t = tmpl.get("template")
        if isinstance(t, dict):
            tm = t.get("metadata")
            if isinstance(tm, dict) and isinstance(tm.get("annotations"), dict):
                annotations = {**annotations, **tm.get("annotations")}
    for c in w.containers:
        if c.kind != "container":
            continue
        key = f"container.apparmor.security.beta.kubernetes.io/{c.name}"
        if key not in annotations:
            s, e = _cspan(c)
            yield Failure(
                message=f"Container '{c.name}' of {w.kind} '{w.name}' should specify an AppArmor profile",
                start_line=s, end_line=e, resource=_cname(w, c),
            )


@_check("KSV005", "AVD-KSV-0005", "SYS_ADMIN capability added", "HIGH",
        "CAP_SYS_ADMIN is the most privileged capability.",
        "Remove SYS_ADMIN from securityContext.capabilities.add.")
def sys_admin_capability(w: Workload):
    for c in w.containers:
        caps = c.security_context().get("capabilities")
        add = caps.get("add", []) if isinstance(caps, dict) else []
        if any(str(a).upper() == "SYS_ADMIN" for a in (add or [])):
            s, e = _cspan(c)
            yield Failure(
                message=f"Container '{c.name}' of {w.kind} '{w.name}' should not add SYS_ADMIN capability",
                start_line=s, end_line=e, resource=_cname(w, c),
            )


@_check("KSV006", "AVD-KSV-0006", "hostPath volume mounts docker.sock", "HIGH",
        "Mounting the docker socket grants control of the container runtime.",
        "Remove the /var/run/docker.sock hostPath volume.")
def docker_sock_mount(w: Workload):
    vols = w.pod_spec.get("volumes")
    for v in (vols or []) if isinstance(vols, (list, tuple)) or hasattr(vols, "__iter__") else []:
        if not isinstance(v, dict):
            continue
        hp = v.get("hostPath")
        if isinstance(hp, dict) and str(hp.get("path", "")) == "/var/run/docker.sock":
            s, e = span_of(v)
            yield Failure(
                message=f"{w.kind} '{w.name}' should not mount /var/run/docker.sock",
                start_line=s, end_line=e, resource=f"{w.kind} {w.name}",
            )


@_check("KSV007", "AVD-KSV-0007", "hostAliases is set", "MEDIUM",
        "hostAliases undermines DNS-based controls.", "Remove hostAliases.")
def host_aliases(w: Workload):
    if w.pod_spec.get("hostAliases") is not None:
        line = w.pod_spec.line("hostAliases")
        yield Failure(
            message=f"{w.kind} '{w.name}' should not set 'spec.hostAliases'",
            start_line=line, end_line=line, resource=f"{w.kind} {w.name}",
        )


@_check("KSV022", "AVD-KSV-0022", "Non-default capabilities added", "MEDIUM",
        "Adding capabilities beyond the default set expands the attack surface.",
        "Remove entries from securityContext.capabilities.add.")
def added_capabilities(w: Workload):
    for c in w.containers:
        caps = c.security_context().get("capabilities")
        add = caps.get("add", []) if isinstance(caps, dict) else []
        for a in add or []:
            if str(a).upper() not in ("NET_BIND_SERVICE",):
                s, e = _cspan(c)
                yield Failure(
                    message=f"Container '{c.name}' of {w.kind} '{w.name}' should not add capability '{a}'",
                    start_line=s, end_line=e, resource=_cname(w, c),
                )
                break


@_check("KSV024", "AVD-KSV-0024", "hostPort is set", "HIGH",
        "hostPort binds the container to the node's network.",
        "Remove ports[].hostPort.")
def host_port(w: Workload):
    for c in w.containers:
        ports = c.raw.get("ports")
        for p in ports or []:
            if isinstance(p, dict) and p.get("hostPort") is not None:
                s, e = span_of(p)
                yield Failure(
                    message=f"Container '{c.name}' of {w.kind} '{w.name}' should not set hostPort",
                    start_line=s, end_line=e, resource=_cname(w, c),
                )


@_check("KSV025", "AVD-KSV-0025", "Custom SELinux options set", "MEDIUM",
        "Custom SELinux user/role options weaken isolation.",
        "Remove seLinuxOptions, or use only allowed type values.")
def selinux_options(w: Workload):
    scopes = [w.pod_security_context()] + [c.security_context() for c in w.containers]
    for sc in scopes:
        sel = sc.get("seLinuxOptions")
        if isinstance(sel, dict) and (sel.get("user") or sel.get("role")):
            s, e = span_of(sel) if hasattr(sel, "keys") else w.span
            yield Failure(
                message=f"{w.kind} '{w.name}' sets custom SELinux user/role options",
                start_line=s, end_line=e, resource=f"{w.kind} {w.name}",
            )


_UNSAFE_SYSCTLS_ALLOWED = {
    "kernel.shm_rmid_forced", "net.ipv4.ip_local_port_range",
    "net.ipv4.ip_unprivileged_port_start", "net.ipv4.tcp_syncookies",
    "net.ipv4.ping_group_range",
}


@_check("KSV026", "AVD-KSV-0026", "Unsafe sysctl options set", "MEDIUM",
        "Only a small allowlist of sysctls is considered safe.",
        "Remove sysctls outside the safe set.")
def unsafe_sysctls(w: Workload):
    sysctls = w.pod_security_context().get("sysctls")
    for sc in sysctls or []:
        if isinstance(sc, dict) and str(sc.get("name", "")) not in _UNSAFE_SYSCTLS_ALLOWED:
            s, e = span_of(sc) if hasattr(sc, "keys") else w.span
            yield Failure(
                message=f"{w.kind} '{w.name}' sets unsafe sysctl '{sc.get('name')}'",
                start_line=s, end_line=e, resource=f"{w.kind} {w.name}",
            )


@_check("KSV027", "AVD-KSV-0027", "Non-default /proc mount", "MEDIUM",
        "An Unmasked procMount exposes host kernel interfaces.",
        "Remove securityContext.procMount.")
def proc_mount(w: Workload):
    for c in w.containers:
        pm = c.security_context().get("procMount")
        if pm is not None and str(pm) != "Default":
            s, e = _cspan(c)
            yield Failure(
                message=f"Container '{c.name}' of {w.kind} '{w.name}' should not set a non-default procMount",
                start_line=s, end_line=e, resource=_cname(w, c),
            )


_RESTRICTED_VOLUME_TYPES = (
    "gcePersistentDisk", "awsElasticBlockStore", "gitRepo", "nfs", "iscsi",
    "glusterfs", "rbd", "flexVolume", "cinder", "cephfs", "flocker", "fc",
    "azureFile", "vsphereVolume", "quobyte", "azureDisk", "portworxVolume",
    "scaleIO", "storageos", "hostPath",
)


@_check("KSV028", "AVD-KSV-0028", "Non-ephemeral volume types used", "LOW",
        "Restricted pod security only permits ephemeral/approved volume types.",
        "Use configMap/secret/emptyDir/ephemeral/persistentVolumeClaim volumes.")
def restricted_volume_types(w: Workload):
    vols = w.pod_spec.get("volumes")
    for v in vols or []:
        if not isinstance(v, dict):
            continue
        for vt in _RESTRICTED_VOLUME_TYPES:
            if vt in v:
                s, e = span_of(v)
                yield Failure(
                    message=f"{w.kind} '{w.name}' uses restricted volume type '{vt}'",
                    start_line=s, end_line=e, resource=f"{w.kind} {w.name}",
                )
                break


@_check("KSV029", "AVD-KSV-0029", "Root group or supplemental groups set", "LOW",
        "A GID of 0 grants root-group file access.",
        "Set runAsGroup/fsGroup/supplementalGroups to non-zero values.")
def root_group(w: Workload):
    psc = w.pod_security_context()
    offenders = []
    if psc.get("runAsGroup") == 0:
        offenders.append("runAsGroup")
    if psc.get("fsGroup") == 0:
        offenders.append("fsGroup")
    if any(g == 0 for g in (psc.get("supplementalGroups") or [])):
        offenders.append("supplementalGroups")
    for c in w.containers:
        if c.security_context().get("runAsGroup") == 0:
            s, e = _cspan(c)
            yield Failure(
                message=f"Container '{c.name}' of {w.kind} '{w.name}' runs with GID 0",
                start_line=s, end_line=e, resource=_cname(w, c),
            )
    if offenders:
        s, e = w.span
        yield Failure(
            message=f"{w.kind} '{w.name}' sets root group via {', '.join(offenders)}",
            start_line=s, end_line=e, resource=f"{w.kind} {w.name}",
        )


@_check("KSV036", "AVD-KSV-0036", "Service account token auto-mounted", "MEDIUM",
        "Pods that do not call the API server should not mount a token.",
        "Set automountServiceAccountToken to false.")
def automount_sa_token(w: Workload):
    if w.pod_spec.get("automountServiceAccountToken") is not False:
        s, e = w.span
        yield Failure(
            message=f"{w.kind} '{w.name}' should set 'automountServiceAccountToken' to false",
            start_line=s, end_line=e, resource=f"{w.kind} {w.name}",
        )


@_check("KSV037", "AVD-KSV-0037", "Workload deployed into the system namespace", "MEDIUM",
        "User workloads in kube-system can tamper with cluster components.",
        "Deploy into a dedicated namespace.")
def system_namespace(w: Workload):
    meta = w.raw.get("metadata")
    ns = str(meta.get("namespace", "")) if isinstance(meta, dict) else ""
    if ns == "kube-system":
        s, e = w.span
        yield Failure(
            message=f"{w.kind} '{w.name}' should not be deployed into 'kube-system'",
            start_line=s, end_line=e, resource=f"{w.kind} {w.name}",
        )


# -- RBAC (Role/ClusterRole kinds, outside the pod-spec wrapper) -------------

def _rbac_check(id_, avd, title, severity, desc="", res=""):
    def wrap(fn):
        def run(workloads):
            for w in workloads:
                if w.kind in ("Role", "ClusterRole"):
                    yield from fn(w)

        register(
            Check(
                id=id_, avd_id=avd, title=title, severity=severity,
                file_types=_K8S, fn=run, description=desc, resolution=res,
                url=_URL.format(id_.lower()), service="rbac",
                provider="kubernetes",
            )
        )
        return fn

    return wrap


def _rules(w: Workload):
    rules = w.raw.get("rules")
    for r in rules or []:
        if isinstance(r, dict):
            yield r


@_rbac_check("KSV041", "AVD-KSV-0041", "Role permits management of secrets", "CRITICAL",
             "Managing secrets grants access to every credential in the namespace.",
             "Scope secret access to named resources, or drop write verbs.")
def rbac_manage_secrets(w: Workload):
    for r in _rules(w):
        resources = [str(x) for x in (r.get("resources") or [])]
        verbs = [str(x) for x in (r.get("verbs") or [])]
        if "secrets" in resources and any(
            v in ("create", "update", "patch", "delete", "deletecollection", "*")
            for v in verbs
        ):
            s, e = span_of(r) if hasattr(r, "keys") else w.span
            yield Failure(
                message=f"{w.kind} '{w.name}' permits managing secrets",
                start_line=s, end_line=e, resource=f"{w.kind} {w.name}",
            )


@_rbac_check("KSV044", "AVD-KSV-0044", "Role permits wildcard verb on wildcard resource",
             "CRITICAL",
             "A '*' verb on '*' resources is full cluster control.",
             "Enumerate the specific verbs and resources required.")
def rbac_wildcard(w: Workload):
    for r in _rules(w):
        resources = [str(x) for x in (r.get("resources") or [])]
        verbs = [str(x) for x in (r.get("verbs") or [])]
        if "*" in resources and "*" in verbs:
            s, e = span_of(r) if hasattr(r, "keys") else w.span
            yield Failure(
                message=f"{w.kind} '{w.name}' permits all verbs on all resources",
                start_line=s, end_line=e, resource=f"{w.kind} {w.name}",
            )


@_rbac_check("KSV042", "AVD-KSV-0042", "Role permits deleting pod logs", "MEDIUM",
             "Deleting pod logs lets an attacker cover their tracks.",
             "Remove delete verbs on pods/log.")
def rbac_delete_pod_logs(w: Workload):
    for r in _rules(w):
        resources = [str(x) for x in (r.get("resources") or [])]
        verbs = [str(x) for x in (r.get("verbs") or [])]
        if "pods/log" in resources and any(
            v in ("delete", "deletecollection", "*") for v in verbs
        ):
            s, e = span_of(r) if hasattr(r, "keys") else w.span
            yield Failure(
                message=f"{w.kind} '{w.name}' permits deleting pod logs",
                start_line=s, end_line=e, resource=f"{w.kind} {w.name}",
            )


@_rbac_check("KSV045", "AVD-KSV-0045", "Role permits wildcard verbs", "CRITICAL",
             "A '*' verb grants every present and future verb on the resource.",
             "Enumerate the specific verbs required.")
def rbac_wildcard_verbs(w: Workload):
    for r in _rules(w):
        resources = [str(x) for x in (r.get("resources") or [])]
        verbs = [str(x) for x in (r.get("verbs") or [])]
        if "*" in verbs and "*" not in resources:
            s, e = span_of(r) if hasattr(r, "keys") else w.span
            yield Failure(
                message=f"{w.kind} '{w.name}' permits wildcard verbs on specific resources",
                start_line=s, end_line=e, resource=f"{w.kind} {w.name}",
            )


@_rbac_check("KSV047", "AVD-KSV-0047", "Role permits privilege escalation verbs",
             "CRITICAL",
             "escalate/bind/impersonate allow privilege escalation past RBAC.",
             "Remove escalate, bind and impersonate verbs.")
def rbac_escalation_verbs(w: Workload):
    for r in _rules(w):
        verbs = [str(x) for x in (r.get("verbs") or [])]
        bad = [v for v in verbs if v in ("escalate", "bind", "impersonate")]
        if bad:
            s, e = span_of(r) if hasattr(r, "keys") else w.span
            yield Failure(
                message=f"{w.kind} '{w.name}' permits privilege escalation verb(s) {', '.join(bad)}",
                start_line=s, end_line=e, resource=f"{w.kind} {w.name}",
            )


@_rbac_check("KSV053", "AVD-KSV-0053", "Role permits getting a shell on pods", "HIGH",
             "pods/exec create grants interactive access to every pod.",
             "Remove create on pods/exec.")
def rbac_pod_exec(w: Workload):
    for r in _rules(w):
        resources = [str(x) for x in (r.get("resources") or [])]
        verbs = [str(x) for x in (r.get("verbs") or [])]
        if "pods/exec" in resources and any(v in ("create", "*") for v in verbs):
            s, e = span_of(r) if hasattr(r, "keys") else w.span
            yield Failure(
                message=f"{w.kind} '{w.name}' permits exec into pods",
                start_line=s, end_line=e, resource=f"{w.kind} {w.name}",
            )


@_rbac_check("KSV054", "AVD-KSV-0054", "Role permits attaching to pods", "HIGH",
             "pods/attach create grants access to running container streams.",
             "Remove create on pods/attach.")
def rbac_pod_attach(w: Workload):
    for r in _rules(w):
        resources = [str(x) for x in (r.get("resources") or [])]
        verbs = [str(x) for x in (r.get("verbs") or [])]
        if "pods/attach" in resources and any(v in ("create", "*") for v in verbs):
            s, e = span_of(r) if hasattr(r, "keys") else w.span
            yield Failure(
                message=f"{w.kind} '{w.name}' permits attaching to pods",
                start_line=s, end_line=e, resource=f"{w.kind} {w.name}",
            )


@_rbac_check("KSV056", "AVD-KSV-0056", "Role permits managing networking resources",
             "HIGH",
             "Control of services/networkpolicies/ingresses can reroute traffic.",
             "Scope networking write access narrowly.")
def rbac_manage_networking(w: Workload):
    net = {"services", "endpoints", "endpointslices", "networkpolicies", "ingresses"}
    for r in _rules(w):
        resources = {str(x) for x in (r.get("resources") or [])}
        verbs = [str(x) for x in (r.get("verbs") or [])]
        if resources & net and any(
            v in ("create", "update", "patch", "delete", "*") for v in verbs
        ):
            s, e = span_of(r) if hasattr(r, "keys") else w.span
            yield Failure(
                message=f"{w.kind} '{w.name}' permits managing networking resources",
                start_line=s, end_line=e, resource=f"{w.kind} {w.name}",
            )


# role bindings get their own kind wrapper
def _binding_check(id_, avd, title, severity, desc="", res=""):
    def wrap(fn):
        def run(workloads):
            for w in workloads:
                if w.kind in ("RoleBinding", "ClusterRoleBinding"):
                    yield from fn(w)

        register(
            Check(
                id=id_, avd_id=avd, title=title, severity=severity,
                file_types=_K8S, fn=run, description=desc, resolution=res,
                url=_URL.format(id_.lower()), service="rbac",
                provider="kubernetes",
            )
        )
        return fn

    return wrap


@_binding_check("KSV043", "AVD-KSV-0043", "Binding to the cluster-admin role",
                "CRITICAL",
                "cluster-admin grants unrestricted cluster control.",
                "Bind to a narrowly-scoped role instead.")
def rbac_cluster_admin_binding(w: Workload):
    ref = w.raw.get("roleRef")
    if isinstance(ref, dict) and str(ref.get("name")) == "cluster-admin":
        s, e = span_of(ref) if hasattr(ref, "keys") else w.span
        yield Failure(
            message=f"{w.kind} '{w.name}' binds to the cluster-admin role",
            start_line=s, end_line=e, resource=f"{w.kind} {w.name}",
        )


@_check("KSV117", "AVD-KSV-0117", "Container binds a privileged port", "MEDIUM",
        "Ports below 1024 require elevated capabilities.",
        "Use an unprivileged containerPort (>= 1024).")
def privileged_ports(w: Workload):
    for c in w.containers:
        ports = c.raw.get("ports")
        for p in ports or []:
            if isinstance(p, dict):
                cp = p.get("containerPort")
                if isinstance(cp, int) and 0 < cp < 1024:
                    s, e = span_of(p)
                    yield Failure(
                        message=f"Container '{c.name}' of {w.kind} '{w.name}' binds privileged port {cp}",
                        start_line=s, end_line=e, resource=_cname(w, c),
                    )
