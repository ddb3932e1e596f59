"""Typed state + terraform adapters for the long-tail cloud providers:
digitalocean, openstack, oracle, cloudstack, nifcloud
(ref: pkg/iac/providers/{digitalocean,openstack,oracle,cloudstack,nifcloud}
and pkg/iac/adapters/terraform/* — the modeled resources and attributes
follow the reference's adapter surfaces; logic is written against this
repo's Val/BlockVal state model).

The port of ``trivy_tpu/misconf/adapters/extra_providers.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from trivy_tpu_torch.misconf.adapters.aws_state import Res, _v
from trivy_tpu_torch.misconf.state import BlockVal, Val


# -- digitalocean ------------------------------------------------------------


@dataclass
class DOFirewallRule(Res):
    direction: str = "inbound"
    addresses: Val = field(default_factory=_v)  # list[str]


@dataclass
class DODroplet(Res):
    ssh_keys: Val = field(default_factory=_v)


@dataclass
class DOForwardingRule(Res):
    entry_protocol: Val = field(default_factory=_v)


@dataclass
class DOLoadBalancer(Res):
    forwarding_rules: list[DOForwardingRule] = field(default_factory=list)
    redirect_http_to_https: Val = field(default_factory=_v)


@dataclass
class DOSpacesBucket(Res):
    acl: Val = field(default_factory=_v)
    versioning_enabled: Val = field(default_factory=_v)
    force_destroy: Val = field(default_factory=_v)


@dataclass
class DOKubernetesCluster(Res):
    surge_upgrade: Val = field(default_factory=_v)
    auto_upgrade: Val = field(default_factory=_v)


@dataclass
class DigitaloceanState:
    provider = "digitalocean"

    do_firewall_rules: list[DOFirewallRule] = field(default_factory=list)
    do_droplets: list[DODroplet] = field(default_factory=list)
    do_loadbalancers: list[DOLoadBalancer] = field(default_factory=list)
    do_spaces_buckets: list[DOSpacesBucket] = field(default_factory=list)
    do_kubernetes_clusters: list[DOKubernetesCluster] = field(default_factory=list)


def adapt_digitalocean(resources: list[BlockVal]) -> DigitaloceanState:
    st = DigitaloceanState()
    for r in resources:
        if r.type != "resource" or not r.labels:
            continue
        rtype = r.labels[0]
        if rtype == "digitalocean_firewall":
            for btype, direction, attr in (
                ("inbound_rule", "inbound", "source_addresses"),
                ("outbound_rule", "outbound", "destination_addresses"),
            ):
                for blk in r.blocks(btype):
                    rule = DOFirewallRule(resource=r, direction=direction)
                    rule.addresses = blk.get(attr, [])
                    st.do_firewall_rules.append(rule)
        elif rtype == "digitalocean_droplet":
            d = DODroplet(resource=r)
            d.ssh_keys = r.get("ssh_keys", [])
            st.do_droplets.append(d)
        elif rtype == "digitalocean_loadbalancer":
            lb = DOLoadBalancer(resource=r)
            lb.redirect_http_to_https = r.get("redirect_http_to_https", False)
            for blk in r.blocks("forwarding_rule"):
                fr = DOForwardingRule(resource=r)
                fr.entry_protocol = blk.get("entry_protocol")
                lb.forwarding_rules.append(fr)
            st.do_loadbalancers.append(lb)
        elif rtype == "digitalocean_spaces_bucket":
            b = DOSpacesBucket(resource=r)
            b.acl = r.get("acl", "private")
            b.force_destroy = r.get("force_destroy", False)
            ver = r.block("versioning")
            b.versioning_enabled = (
                ver.get("enabled", False) if ver else r.get("versioning", False)
            )
            st.do_spaces_buckets.append(b)
        elif rtype == "digitalocean_kubernetes_cluster":
            k = DOKubernetesCluster(resource=r)
            k.surge_upgrade = r.get("surge_upgrade", False)
            k.auto_upgrade = r.get("auto_upgrade", False)
            st.do_kubernetes_clusters.append(k)
    return st


# -- openstack ---------------------------------------------------------------


@dataclass
class OSInstance(Res):
    admin_pass: Val = field(default_factory=_v)


@dataclass
class OSFirewallRule(Res):
    source: Val = field(default_factory=_v)
    destination: Val = field(default_factory=_v)
    enabled: Val = field(default_factory=_v)


@dataclass
class OSSecurityGroup(Res):
    name: Val = field(default_factory=_v)
    description: Val = field(default_factory=_v)


@dataclass
class OSSecurityGroupRule(Res):
    direction: Val = field(default_factory=_v)
    cidr: Val = field(default_factory=_v)


@dataclass
class OpenstackState:
    provider = "openstack"

    os_instances: list[OSInstance] = field(default_factory=list)
    os_firewall_rules: list[OSFirewallRule] = field(default_factory=list)
    os_security_groups: list[OSSecurityGroup] = field(default_factory=list)
    os_security_group_rules: list[OSSecurityGroupRule] = field(default_factory=list)


def adapt_openstack(resources: list[BlockVal]) -> OpenstackState:
    st = OpenstackState()
    for r in resources:
        if r.type != "resource" or not r.labels:
            continue
        rtype = r.labels[0]
        if rtype == "openstack_compute_instance_v2":
            inst = OSInstance(resource=r)
            inst.admin_pass = r.get("admin_pass")
            st.os_instances.append(inst)
        elif rtype == "openstack_fw_rule_v1":
            rule = OSFirewallRule(resource=r)
            rule.source = r.get("source_ip_address")
            rule.destination = r.get("destination_ip_address")
            rule.enabled = r.get("enabled", True)
            st.os_firewall_rules.append(rule)
        elif rtype == "openstack_networking_secgroup_v2":
            sg = OSSecurityGroup(resource=r)
            sg.name = r.get("name")
            sg.description = r.get("description")
            st.os_security_groups.append(sg)
        elif rtype == "openstack_networking_secgroup_rule_v2":
            sgr = OSSecurityGroupRule(resource=r)
            sgr.direction = r.get("direction", "ingress")
            sgr.cidr = r.get("remote_ip_prefix")
            st.os_security_group_rules.append(sgr)
    return st


# -- oracle ------------------------------------------------------------------


@dataclass
class OrcAddressReservation(Res):
    pool: Val = field(default_factory=_v)


@dataclass
class OracleState:
    provider = "oracle"

    orc_address_reservations: list[OrcAddressReservation] = field(
        default_factory=list
    )


def adapt_oracle(resources: list[BlockVal]) -> OracleState:
    st = OracleState()
    for r in resources:
        if r.type != "resource" or not r.labels:
            continue
        if r.labels[0] == "opc_compute_ip_address_reservation":
            res = OrcAddressReservation(resource=r)
            res.pool = r.get("ip_address_pool")
            st.orc_address_reservations.append(res)
    return st


# -- cloudstack --------------------------------------------------------------


@dataclass
class CSInstance(Res):
    user_data: Val = field(default_factory=_v)


@dataclass
class CloudstackState:
    provider = "cloudstack"

    cs_instances: list[CSInstance] = field(default_factory=list)


def adapt_cloudstack(resources: list[BlockVal]) -> CloudstackState:
    st = CloudstackState()
    for r in resources:
        if r.type != "resource" or not r.labels:
            continue
        if r.labels[0] == "cloudstack_instance":
            inst = CSInstance(resource=r)
            inst.user_data = r.get("user_data")
            st.cs_instances.append(inst)
    return st


# -- nifcloud ----------------------------------------------------------------


@dataclass
class NifSGRule(Res):
    type: str = "IN"
    cidr: Val = field(default_factory=_v)
    description: Val = field(default_factory=_v)


@dataclass
class NifSecurityGroup(Res):
    description: Val = field(default_factory=_v)
    rules: list[NifSGRule] = field(default_factory=list)


@dataclass
class NifELBListener(Res):
    protocol: Val = field(default_factory=_v)


@dataclass
class NifELB(Res):
    network_interfaces_public: list[Val] = field(default_factory=list)
    listeners: list[NifELBListener] = field(default_factory=list)


@dataclass
class NifLoadBalancer(Res):
    listeners: list[NifELBListener] = field(default_factory=list)
    ssl_policy: Val = field(default_factory=_v)


@dataclass
class NifDBInstance(Res):
    publicly_accessible: Val = field(default_factory=_v)
    network_id: Val = field(default_factory=_v)


@dataclass
class NifDBSecurityGroup(Res):
    cidr: Val = field(default_factory=_v)


@dataclass
class NifNASSecurityGroup(Res):
    cidr: Val = field(default_factory=_v)


@dataclass
class NifRouter(Res):
    security_group: Val = field(default_factory=_v)


@dataclass
class NifVpnGateway(Res):
    security_group: Val = field(default_factory=_v)


@dataclass
class NifcloudState:
    provider = "nifcloud"

    nif_security_groups: list[NifSecurityGroup] = field(default_factory=list)
    nif_elbs: list[NifELB] = field(default_factory=list)
    nif_load_balancers: list[NifLoadBalancer] = field(default_factory=list)
    nif_db_instances: list[NifDBInstance] = field(default_factory=list)
    nif_db_security_groups: list[NifDBSecurityGroup] = field(default_factory=list)
    nif_nas_security_groups: list[NifNASSecurityGroup] = field(default_factory=list)
    nif_routers: list[NifRouter] = field(default_factory=list)
    nif_vpn_gateways: list[NifVpnGateway] = field(default_factory=list)


def adapt_nifcloud(resources: list[BlockVal]) -> NifcloudState:
    st = NifcloudState()
    sgs: dict[str, NifSecurityGroup] = {}
    pending_rules: list[tuple[list, NifSGRule]] = []
    for r in resources:
        if r.type != "resource" or not r.labels:
            continue
        rtype = r.labels[0]
        if rtype == "nifcloud_security_group":
            sg = NifSecurityGroup(resource=r)
            sg.description = r.get("description")
            name = r.get("group_name").str() or (
                r.labels[1] if len(r.labels) > 1 else ""
            )
            sgs[name] = sg
            st.nif_security_groups.append(sg)
        elif rtype == "nifcloud_security_group_rule":
            rule = NifSGRule(
                resource=r, type=r.get("type", "IN").str() or "IN"
            )
            rule.cidr = r.get("cidr_ip")
            rule.description = r.get("description")
            names = r.get("security_group_names").list()
            pending_rules.append((names, rule))
        elif rtype == "nifcloud_elb":
            elb = NifELB(resource=r)
            for ni in r.blocks("network_interface"):
                elb.network_interfaces_public.append(
                    ni.get("is_vip_network", False)
                )
            listener = NifELBListener(resource=r)
            listener.protocol = r.get("protocol")
            elb.listeners.append(listener)
            for blk in r.blocks("listener"):
                ls = NifELBListener(resource=r)
                ls.protocol = blk.get("protocol")
                elb.listeners.append(ls)
            st.nif_elbs.append(elb)
        elif rtype == "nifcloud_load_balancer":
            lb = NifLoadBalancer(resource=r)
            ls = NifELBListener(resource=r)
            # the lb resource's own top-level listener attributes
            ls.protocol = r.get("load_balancer_port").with_value(
                _port_protocol(r.get("load_balancer_port"))
            )
            lb.listeners.append(ls)
            lb.ssl_policy = r.get("ssl_policy_id")
            st.nif_load_balancers.append(lb)
        elif rtype == "nifcloud_db_instance":
            db = NifDBInstance(resource=r)
            db.publicly_accessible = r.get("publicly_accessible", False)
            db.network_id = r.get("network_id")
            st.nif_db_instances.append(db)
        elif rtype == "nifcloud_db_security_group":
            for blk in r.blocks("rule"):
                g = NifDBSecurityGroup(resource=r)
                g.cidr = blk.get("cidr_ip")
                st.nif_db_security_groups.append(g)
        elif rtype == "nifcloud_nas_security_group":
            for blk in r.blocks("rule"):
                g = NifNASSecurityGroup(resource=r)
                g.cidr = blk.get("cidr_ip")
                st.nif_nas_security_groups.append(g)
        elif rtype == "nifcloud_router":
            rt = NifRouter(resource=r)
            rt.security_group = r.get("security_group")
            st.nif_routers.append(rt)
        elif rtype == "nifcloud_vpn_gateway":
            gw = NifVpnGateway(resource=r)
            gw.security_group = r.get("security_group")
            st.nif_vpn_gateways.append(gw)
    for names, rule in pending_rules:
        placed = False
        for n in names or []:
            if str(n) in sgs:
                sgs[str(n)].rules.append(rule)
                placed = True
        if not placed and sgs:
            next(iter(sgs.values())).rules.append(rule)
        elif not placed:
            orphan = NifSecurityGroup(resource=rule.resource)
            orphan.rules.append(rule)
            st.nif_security_groups.append(orphan)
            sgs["__orphan__"] = orphan
    return st


def _port_protocol(port_val: Val) -> str:
    try:
        return {80: "HTTP", 443: "HTTPS"}.get(int(port_val.value or 0), "TCP")
    except (TypeError, ValueError):
        return "TCP"
