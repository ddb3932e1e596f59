"""Builtin checks for the long-tail providers: digitalocean, openstack,
oracle, cloudstack, nifcloud (AVD IDs are the public reporting interface,
per the AVD catalog; logic written against this repo's typed states —
ref: pkg/iac/providers/* for the modeled surfaces).

The port of ``trivy_tpu/misconf/checks/cloud_extra.py``.
"""

from __future__ import annotations

from trivy_tpu_torch.misconf.checks import Check, CloudFailure, register_cloud

_TYPES = ("terraform",)
_URL = "https://avd.aquasec.com/misconfig/{}"


def _check(id_, title, severity, targets, provider, service,
           desc="", res=""):
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
                service=service,
                provider=provider,
                targets=targets,
            )
        )
        return fn

    return wrap


def _open_cidr(c: str) -> bool:
    c = (c or "").strip()
    return c in ("0.0.0.0/0", "::/0", "*", "0.0.0.0")


# -- digitalocean ------------------------------------------------------------


@_check("AVD-DIG-0001", "The firewall has an inbound rule with open access",
        "CRITICAL", "do_firewall_rules", "digitalocean", "compute",
        "Opening up ports to the public internet is generally to be avoided.",
        "Set a more restrictive source address range.")
def do_public_ingress(st):
    for r in st.do_firewall_rules:
        if r.direction != "inbound":
            continue
        if any(_open_cidr(str(a)) for a in r.addresses.list()):
            yield CloudFailure("Firewall rule allows ingress from the public "
                               "internet", r.addresses, r.address)


@_check("AVD-DIG-0002", "The firewall has an outbound rule with open access",
        "CRITICAL", "do_firewall_rules", "digitalocean", "compute",
        "Opening up ports to the public internet eases data exfiltration.",
        "Set a more restrictive destination address range.")
def do_public_egress(st):
    for r in st.do_firewall_rules:
        if r.direction != "outbound":
            continue
        if any(_open_cidr(str(a)) for a in r.addresses.list()):
            yield CloudFailure("Firewall rule allows egress to the public "
                               "internet", r.addresses, r.address)


@_check("AVD-DIG-0004", "Droplet does not have an SSH key specified",
        "CRITICAL", "do_droplets", "digitalocean", "compute",
        "Droplets without SSH keys fall back to password authentication.",
        "Assign at least one SSH key to the droplet.")
def do_droplet_ssh_keys(st):
    for d in st.do_droplets:
        if not d.ssh_keys.list():
            yield CloudFailure("Droplet has no SSH keys", d.anchor(), d.address)


@_check("AVD-DIG-0006", "Spaces bucket or object has public read ACL",
        "CRITICAL", "do_spaces_buckets", "digitalocean", "spaces",
        "Public read ACLs expose the bucket contents to the internet.",
        "Set the ACL to private.")
def do_spaces_acl(st):
    for b in st.do_spaces_buckets:
        if b.acl.str() == "public-read":
            yield CloudFailure("Spaces bucket is publicly readable", b.acl,
                               b.address)


@_check("AVD-DIG-0007", "Spaces bucket should have versioning enabled",
        "MEDIUM", "do_spaces_buckets", "digitalocean", "spaces",
        "Versioning protects against accidental or malicious overwrite.",
        "Enable versioning on the bucket.")
def do_spaces_versioning(st):
    for b in st.do_spaces_buckets:
        if not b.versioning_enabled.bool():
            yield CloudFailure("Spaces bucket has versioning disabled",
                               b.versioning_enabled if b.versioning_enabled.explicit
                               else b.anchor(), b.address)


@_check("AVD-DIG-0005", "Force destroy is enabled on Spaces bucket",
        "MEDIUM", "do_spaces_buckets", "digitalocean", "spaces",
        "force_destroy deletes all objects when the bucket is destroyed.",
        "Remove force_destroy.")
def do_spaces_force_destroy(st):
    for b in st.do_spaces_buckets:
        if b.force_destroy.bool():
            yield CloudFailure("Spaces bucket has force-destroy enabled",
                               b.force_destroy, b.address)


@_check("AVD-DIG-0008", "The load balancer forwarding rule uses an insecure protocol",
        "CRITICAL", "do_loadbalancers", "digitalocean", "compute",
        "HTTP traffic between the load balancer and clients is unencrypted.",
        "Use https or https-passthrough entry protocols.")
def do_lb_https(st):
    for lb in st.do_loadbalancers:
        if lb.redirect_http_to_https.bool():
            continue
        for fr in lb.forwarding_rules:
            if fr.entry_protocol.str() == "http":
                yield CloudFailure("Load balancer forwarding rule uses HTTP",
                                   fr.entry_protocol, lb.address)


@_check("AVD-DIG-0009", "The Kubernetes cluster does not enable surge upgrades",
        "MEDIUM", "do_kubernetes_clusters", "digitalocean", "compute",
        "Surge upgrades avoid workload disruption during node upgrades.",
        "Enable surge_upgrade.")
def do_k8s_surge(st):
    for k in st.do_kubernetes_clusters:
        if not k.surge_upgrade.bool():
            yield CloudFailure("Cluster does not enable surge upgrades",
                               k.surge_upgrade if k.surge_upgrade.explicit
                               else k.anchor(), k.address)


@_check("AVD-DIG-0010", "Kubernetes clusters should be auto-upgraded",
        "CRITICAL", "do_kubernetes_clusters", "digitalocean", "compute",
        "Clusters not auto-upgraded miss critical security patches.",
        "Enable auto_upgrade.")
def do_k8s_auto_upgrade(st):
    for k in st.do_kubernetes_clusters:
        if not k.auto_upgrade.bool():
            yield CloudFailure("Cluster is not set to auto-upgrade",
                               k.auto_upgrade if k.auto_upgrade.explicit
                               else k.anchor(), k.address)


# -- openstack ---------------------------------------------------------------


@_check("AVD-OPNSTK-0001", "A plaintext password is used for a compute instance",
        "MEDIUM", "os_instances", "openstack", "compute",
        "Hardcoded admin passwords end up in state files and VCS.",
        "Avoid admin_pass; use key pairs.")
def os_plaintext_password(st):
    for i in st.os_instances:
        if i.admin_pass.str():
            yield CloudFailure("Instance has a plaintext admin password",
                               i.admin_pass, i.address)


@_check("AVD-OPNSTK-0002", "A firewall rule allows traffic from/to any address",
        "MEDIUM", "os_firewall_rules", "openstack", "compute",
        "Unrestricted firewall rules negate the firewall's purpose.",
        "Restrict source and destination addresses.")
def os_firewall_any(st):
    for r in st.os_firewall_rules:
        if not r.enabled.bool(True):
            continue
        if not r.source.str() or not r.destination.str():
            yield CloudFailure(
                "Firewall rule does not restrict both source and destination",
                r.source if r.source.explicit else r.anchor(), r.address)


@_check("AVD-OPNSTK-0003", "Security group does not have a description",
        "LOW", "os_security_groups", "openstack", "networking",
        "Descriptions document intent for audits.",
        "Add a description.")
def os_sg_description(st):
    for sg in st.os_security_groups:
        if not sg.description.str():
            yield CloudFailure("Security group has no description",
                               sg.anchor(), sg.address)


@_check("AVD-OPNSTK-0004", "A security group rule allows ingress traffic from multiple public addresses",
        "MEDIUM", "os_security_group_rules", "openstack", "networking",
        "Public ingress exposes the attached instances to the internet.",
        "Restrict the remote IP prefix.")
def os_sg_public_ingress(st):
    for r in st.os_security_group_rules:
        if r.direction.str() == "ingress" and _open_cidr(r.cidr.str()):
            yield CloudFailure("Security group rule allows public ingress",
                               r.cidr, r.address)


@_check("AVD-OPNSTK-0005", "A security group rule allows egress traffic to multiple public addresses",
        "MEDIUM", "os_security_group_rules", "openstack", "networking",
        "Open egress eases exfiltration from compromised instances.",
        "Restrict the remote IP prefix.")
def os_sg_public_egress(st):
    for r in st.os_security_group_rules:
        if r.direction.str() == "egress" and _open_cidr(r.cidr.str()):
            yield CloudFailure("Security group rule allows public egress",
                               r.cidr, r.address)


# -- oracle ------------------------------------------------------------------


@_check("AVD-ORCL-0001", "Compute instance requests an IP reservation from a public pool",
        "CRITICAL", "orc_address_reservations", "oracle", "compute",
        "Public IP reservations expose the instance to the internet.",
        "Use a private address pool.")
def orc_public_pool(st):
    for r in st.orc_address_reservations:
        if r.pool.str() in ("public-ippool", "/oracle/public-ippool"):
            yield CloudFailure("Address reservation uses the public IP pool",
                               r.pool, r.address)


# -- cloudstack --------------------------------------------------------------

_SENSITIVE_MARKERS = ("password", "secret", "token", "aws_access_key_id",
                      "api_key", "private_key")


@_check("AVD-CLDSTK-0001", "Sensitive data stored in user_data",
        "HIGH", "cs_instances", "cloudstack", "compute",
        "user_data is visible to anyone with instance read access.",
        "Keep secrets out of user_data; use a secret store.")
def cs_sensitive_user_data(st):
    import base64

    for i in st.cs_instances:
        raw = i.user_data.str()
        if not raw:
            continue
        text = raw
        try:  # the provider accepts base64-encoded user_data
            text = base64.b64decode(raw, validate=True).decode("utf-8", "replace")
        except Exception:
            pass
        low = text.lower()
        if any(m in low for m in _SENSITIVE_MARKERS):
            yield CloudFailure("user_data appears to contain sensitive data",
                               i.user_data, i.address)


# -- nifcloud ----------------------------------------------------------------


@_check("AVD-NIF-0002", "Missing description for security group",
        "LOW", "nif_security_groups", "nifcloud", "computing",
        "Descriptions document intent for audits.", "Add a description.")
def nif_sg_description(st):
    for sg in st.nif_security_groups:
        if not sg.description.str():
            yield CloudFailure("Security group has no description",
                               sg.anchor(), sg.address)


@_check("AVD-NIF-0003", "Missing description for security group rule",
        "LOW", "nif_security_groups", "nifcloud", "computing",
        "Descriptions document intent for audits.",
        "Add a description to every rule.")
def nif_sgr_description(st):
    for sg in st.nif_security_groups:
        for r in sg.rules:
            if not r.description.str():
                yield CloudFailure("Security group rule has no description",
                                   r.anchor(), r.address)


@_check("AVD-NIF-0001", "An ingress security group rule allows traffic from /0",
        "CRITICAL", "nif_security_groups", "nifcloud", "computing",
        "Opening up ports to the public internet is to be avoided.",
        "Set a more restrictive CIDR range.")
def nif_public_ingress(st):
    for sg in st.nif_security_groups:
        for r in sg.rules:
            if r.type == "IN" and _open_cidr(r.cidr.str()):
                yield CloudFailure("Security group rule allows public ingress",
                                   r.cidr, r.address)


@_check("AVD-NIF-0004", "An egress security group rule allows traffic to /0",
        "CRITICAL", "nif_security_groups", "nifcloud", "computing",
        "Open egress eases data exfiltration.",
        "Set a more restrictive CIDR range.")
def nif_public_egress(st):
    for sg in st.nif_security_groups:
        for r in sg.rules:
            if r.type == "OUT" and _open_cidr(r.cidr.str()):
                yield CloudFailure("Security group rule allows public egress",
                                   r.cidr, r.address)


@_check("AVD-NIF-0019", "The elb listener protocol is not HTTPS",
        "CRITICAL", "nif_elbs", "nifcloud", "network",
        "Plain HTTP between clients and the ELB is unencrypted.",
        "Use the HTTPS protocol and attach a certificate.")
def nif_elb_https(st):
    for elb in st.nif_elbs:
        for ls in elb.listeners:
            if ls.protocol.str().upper() == "HTTP":
                yield CloudFailure("ELB listener uses HTTP", ls.protocol,
                                   elb.address)


@_check("AVD-NIF-0021", "The load balancer listener port is not HTTPS",
        "CRITICAL", "nif_load_balancers", "nifcloud", "network",
        "Plain HTTP between clients and the LB is unencrypted.",
        "Listen on 443 with an SSL policy.")
def nif_lb_https(st):
    for lb in st.nif_load_balancers:
        for ls in lb.listeners:
            if ls.protocol.str().upper() == "HTTP":
                yield CloudFailure("Load balancer listens on HTTP",
                                   ls.protocol, lb.address)


@_check("AVD-NIF-0008", "The db instance is publicly accessible",
        "CRITICAL", "nif_db_instances", "nifcloud", "rdb",
        "Public database endpoints are exposed to the internet.",
        "Set publicly_accessible = false.")
def nif_db_public(st):
    for db in st.nif_db_instances:
        if db.publicly_accessible.bool():
            yield CloudFailure("DB instance is publicly accessible",
                               db.publicly_accessible, db.address)


@_check("AVD-NIF-0010", "A db security group rule allows access from /0",
        "CRITICAL", "nif_db_security_groups", "nifcloud", "rdb",
        "The database accepts connections from the public internet.",
        "Restrict the CIDR range.")
def nif_db_sg_public(st):
    for g in st.nif_db_security_groups:
        if _open_cidr(g.cidr.str()):
            yield CloudFailure("DB security group rule allows public access",
                               g.cidr, g.address)


@_check("AVD-NIF-0014", "A NAS security group rule allows access from /0",
        "CRITICAL", "nif_nas_security_groups", "nifcloud", "nas",
        "The NAS accepts connections from the public internet.",
        "Restrict the CIDR range.")
def nif_nas_sg_public(st):
    for g in st.nif_nas_security_groups:
        if _open_cidr(g.cidr.str()):
            yield CloudFailure("NAS security group rule allows public access",
                               g.cidr, g.address)


@_check("AVD-NIF-0016", "Missing security group for router",
        "CRITICAL", "nif_routers", "nifcloud", "network",
        "Routers without a security group accept unfiltered traffic.",
        "Attach a security group.")
def nif_router_sg(st):
    for r in st.nif_routers:
        if not r.security_group.str():
            yield CloudFailure("Router has no security group", r.anchor(),
                               r.address)


@_check("AVD-NIF-0018", "Missing security group for vpn gateway",
        "CRITICAL", "nif_vpn_gateways", "nifcloud", "network",
        "VPN gateways without a security group accept unfiltered traffic.",
        "Attach a security group.")
def nif_vpngw_sg(st):
    for g in st.nif_vpn_gateways:
        if not g.security_group.str():
            yield CloudFailure("VPN gateway has no security group",
                               g.anchor(), g.address)
