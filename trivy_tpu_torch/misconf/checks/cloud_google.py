"""Builtin Google Cloud checks over typed provider state.

Independently-authored equivalents of the reference's embedded google check
bundle (AVD-GCP IDs are the public reporting/suppression interface, e.g.
AVD-GCP-0007 appears verbatim in the reference's own fixtures,
pkg/report/sarif_test.go:560; the check logic here is written against this
repo's own state model — ref: pkg/iac/providers/google for the modeled
surface).

The port of ``trivy_tpu/misconf/checks/cloud_google.py``.
"""

from __future__ import annotations

from trivy_tpu_torch.misconf.adapters.google_state import GoogleState
from trivy_tpu_torch.misconf.checks import Check, CloudFailure, register_cloud

_TYPES = ("terraform",)
_URL = "https://avd.aquasec.com/misconfig/{}"

_TARGETS = {
    "storage": "storage_buckets",
    "compute": "compute_instances",
    "gke": "gke_clusters",
    "sql": "sql_instances",
    "bigquery": "bigquery_datasets",
    "kms": "kms_keys",
    "dns": "dns_zones",
    "iam": "iam_bindings",
    "platform": "projects",
}


def _check(id_, title, severity, service, desc="", res="", targets=None):
    if targets is None:
        targets = _TARGETS.get(service, "")

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
                provider="google",
                targets=targets,
            )
        )
        return fn

    return wrap


_PUBLIC_MEMBERS = ("allUsers", "allAuthenticatedUsers")


# -- storage ------------------------------------------------------------------

@_check("AVD-GCP-0001", "Storage buckets should not be publicly accessible",
        "HIGH", "storage",
        "Public IAM grants expose every object in the bucket.",
        "Restrict bucket members to specific identities.")
def storage_no_public_access(st: GoogleState):
    for b in st.storage_buckets:
        for m in b.members:
            if str(m.value or "") in _PUBLIC_MEMBERS:
                yield CloudFailure(
                    f"Bucket grants access to {m.value}", m, b.address
                )


@_check("AVD-GCP-0002", "Storage buckets should enable uniform bucket-level access",
        "MEDIUM", "storage",
        "Uniform bucket-level access disables per-object ACLs.",
        "Enable uniform_bucket_level_access.")
def storage_uniform_access(st: GoogleState):
    for b in st.storage_buckets:
        if not b.resource.type:
            continue
        if b.resource.labels and b.resource.labels[0] != "google_storage_bucket":
            continue
        if not b.uniform_bucket_level_access.bool():
            yield CloudFailure(
                "Bucket has uniform bucket level access disabled",
                b.uniform_bucket_level_access
                if b.uniform_bucket_level_access.explicit
                else b.anchor(),
                b.address,
            )


@_check("AVD-GCP-0066", "Storage buckets should be encrypted with customer-managed keys",
        "LOW", "storage",
        "Customer-managed keys give control over encryption key rotation and revocation.",
        "Set encryption.default_kms_key_name.")
def storage_cmk(st: GoogleState):
    for b in st.storage_buckets:
        if b.resource.labels and b.resource.labels[0] != "google_storage_bucket":
            continue
        if not b.encryption_kms_key.str():
            yield CloudFailure(
                "Bucket is not encrypted with a customer-managed key",
                b.encryption_kms_key if b.encryption_kms_key.explicit else b.anchor(),
                b.address,
            )


# -- compute: disks / instances ----------------------------------------------

@_check("AVD-GCP-0037", "Compute disks should be encrypted with customer-managed keys",
        "LOW", "compute", targets="compute_disks")
def disk_cmk(st: GoogleState):
    for d in st.compute_disks:
        enc = d.encryption
        if enc is None or not enc.kms_key_link.str():
            yield CloudFailure(
                "Disk is not encrypted with a customer-managed key",
                enc.kms_key_link if enc and enc.kms_key_link.explicit else d.anchor(),
                d.address,
            )


@_check("AVD-GCP-0036", "Disk encryption keys should not be supplied in plaintext",
        "CRITICAL", "compute", targets="compute_disks")
def disk_no_plaintext_key(st: GoogleState):
    for d in st.compute_disks:
        if d.encryption is not None and d.encryption.raw_key.is_set():
            yield CloudFailure(
                "Disk encryption key is supplied in plaintext (raw_key)",
                d.encryption.raw_key, d.address,
            )
    for i in st.compute_instances:
        enc = i.boot_disk_encryption
        if enc is not None and enc.raw_key.is_set():
            yield CloudFailure(
                "Boot disk encryption key is supplied in plaintext",
                enc.raw_key, i.address,
            )


@_check("AVD-GCP-0041", "Instances should not have public IP addresses",
        "HIGH", "compute")
def instance_no_public_ip(st: GoogleState):
    for i in st.compute_instances:
        if i.public_ip.bool():
            yield CloudFailure(
                "Instance has a public IP address (access_config)",
                i.public_ip, i.address,
            )


@_check("AVD-GCP-0067", "Instances should enable Shielded VM secure boot",
        "MEDIUM", "compute")
def instance_secure_boot(st: GoogleState):
    for i in st.compute_instances:
        if not i.shielded_secure_boot.bool():
            yield CloudFailure(
                "Instance does not enable Shielded VM secure boot",
                i.shielded_secure_boot if i.shielded_secure_boot.explicit else i.anchor(),
                i.address,
            )


@_check("AVD-GCP-0068", "Instances should enable Shielded VM vTPM",
        "MEDIUM", "compute")
def instance_vtpm(st: GoogleState):
    for i in st.compute_instances:
        if i.shielded_vtpm.explicit and not i.shielded_vtpm.bool():
            yield CloudFailure(
                "Instance disables the Shielded VM vTPM", i.shielded_vtpm, i.address
            )


@_check("AVD-GCP-0045", "Instances should enable Shielded VM integrity monitoring",
        "MEDIUM", "compute")
def instance_integrity(st: GoogleState):
    for i in st.compute_instances:
        if i.shielded_integrity.explicit and not i.shielded_integrity.bool():
            yield CloudFailure(
                "Instance disables Shielded VM integrity monitoring",
                i.shielded_integrity, i.address,
            )


@_check("AVD-GCP-0042", "Instances should not use the default service account",
        "HIGH", "compute")
def instance_no_default_sa(st: GoogleState):
    for i in st.compute_instances:
        sa = i.service_account
        if sa is not None and sa.is_default.bool() and sa.email.is_set():
            yield CloudFailure(
                "Instance uses the default compute service account",
                sa.email, i.address,
            )


@_check("AVD-GCP-0044", "Instance service accounts should not have full API scopes",
        "HIGH", "compute")
def instance_no_full_scopes(st: GoogleState):
    for i in st.compute_instances:
        sa = i.service_account
        if sa is None:
            continue
        for s in sa.scopes:
            scope = str(s.value or "")
            if scope.endswith("cloud-platform") or scope == "cloud-platform":
                yield CloudFailure(
                    "Service account has full cloud-platform API scope",
                    s, i.address,
                )


@_check("AVD-GCP-0043", "OS Login should be enabled at instance level",
        "MEDIUM", "compute")
def instance_os_login(st: GoogleState):
    for i in st.compute_instances:
        if i.os_login_disabled.bool():
            yield CloudFailure(
                "Instance metadata disables OS Login", i.os_login_disabled, i.address
            )


@_check("AVD-GCP-0032", "Instance serial port access should be disabled",
        "MEDIUM", "compute")
def instance_serial_port(st: GoogleState):
    for i in st.compute_instances:
        if i.serial_port_enabled.bool():
            yield CloudFailure(
                "Instance metadata enables serial port access",
                i.serial_port_enabled, i.address,
            )


@_check("AVD-GCP-0029", "Instances should not forward IP traffic",
        "MEDIUM", "compute")
def instance_no_ip_forward(st: GoogleState):
    for i in st.compute_instances:
        if i.ip_forwarding.bool():
            yield CloudFailure(
                "Instance has IP forwarding enabled", i.ip_forwarding, i.address
            )


@_check("AVD-GCP-0030", "Instances should block project-wide SSH keys",
        "MEDIUM", "compute")
def instance_block_ssh_keys(st: GoogleState):
    for i in st.compute_instances:
        if i.block_project_ssh_keys.explicit and not i.block_project_ssh_keys.bool():
            yield CloudFailure(
                "Instance does not block project-wide SSH keys",
                i.block_project_ssh_keys, i.address,
            )


# -- compute: network ---------------------------------------------------------

def _public_ranges(vals):
    for v in vals:
        s = str(v.value or "")
        if s in ("0.0.0.0/0", "::/0") or s.endswith("/0"):
            yield v


@_check("AVD-GCP-0027", "Firewalls should not permit public ingress",
        "CRITICAL", "compute", targets="firewalls")
def firewall_no_public_ingress(st: GoogleState):
    for fw in st.firewalls:
        for r in fw.rules:
            if not r.is_allow or r.direction != "INGRESS":
                continue
            for v in _public_ranges(r.source_ranges):
                yield CloudFailure(
                    "Firewall allows ingress from the public internet",
                    v, fw.address,
                )


@_check("AVD-GCP-0035", "Firewalls should not permit unrestricted egress",
        "MEDIUM", "compute", targets="firewalls")
def firewall_no_public_egress(st: GoogleState):
    for fw in st.firewalls:
        for r in fw.rules:
            if not r.is_allow or r.direction != "EGRESS":
                continue
            for v in _public_ranges(r.dest_ranges):
                yield CloudFailure(
                    "Firewall allows egress to the public internet",
                    v, fw.address,
                )


def _rule_covers_port(rule, port: int) -> bool:
    if not rule.ports:
        return True  # all ports
    for p in rule.ports:
        s = str(p.value or "")
        if "-" in s:
            lo, _, hi = s.partition("-")
            try:
                if int(lo) <= port <= int(hi):
                    return True
            except ValueError:
                continue
        elif s.isdigit() and int(s) == port:
            return True
    return False


@_check("AVD-GCP-0056", "SSH access should not be allowed from the public internet",
        "CRITICAL", "compute", targets="firewalls")
def firewall_no_public_ssh(st: GoogleState):
    for fw in st.firewalls:
        for r in fw.rules:
            if not r.is_allow or r.direction != "INGRESS":
                continue
            if not _rule_covers_port(r, 22):
                continue
            for v in _public_ranges(r.source_ranges):
                yield CloudFailure(
                    "Firewall allows SSH (22) from the public internet",
                    v, fw.address,
                )


@_check("AVD-GCP-0057", "RDP access should not be allowed from the public internet",
        "CRITICAL", "compute", targets="firewalls")
def firewall_no_public_rdp(st: GoogleState):
    for fw in st.firewalls:
        for r in fw.rules:
            if not r.is_allow or r.direction != "INGRESS":
                continue
            if not _rule_covers_port(r, 3389):
                continue
            for v in _public_ranges(r.source_ranges):
                yield CloudFailure(
                    "Firewall allows RDP (3389) from the public internet",
                    v, fw.address,
                )


@_check("AVD-GCP-0028", "VPC subnetworks should enable flow logs",
        "LOW", "compute", targets="subnetworks")
def subnet_flow_logs(st: GoogleState):
    for sn in st.subnetworks:
        if sn.purpose.str() in ("REGIONAL_MANAGED_PROXY", "GLOBAL_MANAGED_PROXY"):
            continue  # proxy-only subnets cannot log flows
        if not sn.flow_logs_enabled.bool():
            yield CloudFailure(
                "Subnetwork does not enable VPC flow logs",
                sn.flow_logs_enabled if sn.flow_logs_enabled.explicit else sn.anchor(),
                sn.address,
            )


@_check("AVD-GCP-0039", "SSL policies should require TLS 1.2 or newer",
        "HIGH", "compute", targets="ssl_policies")
def ssl_policy_min_tls(st: GoogleState):
    for sp in st.ssl_policies:
        if sp.min_tls_version.str() != "TLS_1_2" and sp.profile.str() != "RESTRICTED":
            yield CloudFailure(
                "SSL policy permits TLS versions older than 1.2",
                sp.min_tls_version if sp.min_tls_version.explicit else sp.anchor(),
                sp.address,
            )


# -- GKE ----------------------------------------------------------------------

@_check("AVD-GCP-0060", "GKE clusters should not use legacy ABAC", "HIGH", "gke")
def gke_no_legacy_abac(st: GoogleState):
    for c in st.gke_clusters:
        if c.synthetic:
            continue
        if c.enable_legacy_abac.bool():
            yield CloudFailure(
                "Cluster has legacy ABAC enabled", c.enable_legacy_abac, c.address
            )


@_check("AVD-GCP-0061", "GKE clusters should have a network policy or Dataplane V2",
        "MEDIUM", "gke")
def gke_network_policy(st: GoogleState):
    for c in st.gke_clusters:
        if c.synthetic:
            continue
        if c.enable_autopilot.bool():
            continue
        if c.datapath_provider.str() == "ADVANCED_DATAPATH":
            continue
        if not c.network_policy_enabled.bool():
            yield CloudFailure(
                "Cluster does not enable a network policy",
                c.network_policy_enabled
                if c.network_policy_enabled.explicit
                else c.anchor(),
                c.address,
            )


@_check("AVD-GCP-0059", "GKE nodes should be private", "MEDIUM", "gke")
def gke_private_nodes(st: GoogleState):
    for c in st.gke_clusters:
        if c.synthetic:
            continue
        if not c.resource.labels:
            continue
        if not c.enable_private_nodes.bool():
            yield CloudFailure(
                "Cluster does not enable private nodes",
                c.enable_private_nodes
                if c.enable_private_nodes.explicit
                else c.anchor(),
                c.address,
            )


@_check("AVD-GCP-0053", "GKE control plane access should be restricted to authorized networks",
        "HIGH", "gke")
def gke_master_authorized_networks(st: GoogleState):
    for c in st.gke_clusters:
        if c.synthetic:
            continue
        if not c.master_authorized_networks_set.bool():
            yield CloudFailure(
                "Cluster does not restrict control plane access to authorized networks",
                c.anchor(), c.address,
            )
        else:
            for cidr in c.master_authorized_networks.list():
                if str(cidr).endswith("/0"):
                    yield CloudFailure(
                        "Master authorized networks include the public internet",
                        c.master_authorized_networks, c.address,
                    )


@_check("AVD-GCP-0064", "GKE basic (static password) authentication should be disabled",
        "HIGH", "gke")
def gke_no_basic_auth(st: GoogleState):
    for c in st.gke_clusters:
        if c.synthetic:
            continue
        if c.basic_auth_username.str() or c.basic_auth_password.str():
            yield CloudFailure(
                "Cluster enables basic (username/password) authentication",
                c.basic_auth_username
                if c.basic_auth_username.is_set()
                else c.basic_auth_password,
                c.address,
            )


@_check("AVD-GCP-0062", "GKE client certificate authentication should be disabled",
        "MEDIUM", "gke")
def gke_no_client_cert(st: GoogleState):
    for c in st.gke_clusters:
        if c.synthetic:
            continue
        if c.client_certificate.bool():
            yield CloudFailure(
                "Cluster issues legacy client certificates",
                c.client_certificate, c.address,
            )


@_check("AVD-GCP-0055", "GKE clusters should enable Shielded Nodes", "HIGH", "gke")
def gke_shielded_nodes(st: GoogleState):
    for c in st.gke_clusters:
        if c.synthetic:
            continue
        if c.enable_shielded_nodes.explicit and not c.enable_shielded_nodes.bool():
            yield CloudFailure(
                "Cluster disables Shielded Nodes", c.enable_shielded_nodes, c.address
            )


@_check("AVD-GCP-0051", "GKE clusters should have logging enabled", "MEDIUM", "gke")
def gke_logging(st: GoogleState):
    for c in st.gke_clusters:
        if c.synthetic:
            continue
        svc = c.logging_service.str()
        if svc == "none":
            yield CloudFailure(
                "Cluster disables Stackdriver logging", c.logging_service, c.address
            )


@_check("AVD-GCP-0052", "GKE clusters should have monitoring enabled", "MEDIUM", "gke")
def gke_monitoring(st: GoogleState):
    for c in st.gke_clusters:
        if c.synthetic:
            continue
        if c.monitoring_service.str() == "none":
            yield CloudFailure(
                "Cluster disables Stackdriver monitoring",
                c.monitoring_service, c.address,
            )


@_check("AVD-GCP-0048", "GKE node pools should enable auto-repair", "LOW", "gke")
def gke_auto_repair(st: GoogleState):
    for c in st.gke_clusters:
        for p in c.node_pools:
            if not p.auto_repair.bool():
                yield CloudFailure(
                    "Node pool does not enable auto-repair",
                    p.auto_repair if p.auto_repair.explicit else p.anchor(),
                    c.address,
                )


@_check("AVD-GCP-0058", "GKE node pools should enable auto-upgrade", "LOW", "gke")
def gke_auto_upgrade(st: GoogleState):
    for c in st.gke_clusters:
        for p in c.node_pools:
            if not p.auto_upgrade.bool():
                yield CloudFailure(
                    "Node pool does not enable auto-upgrade",
                    p.auto_upgrade if p.auto_upgrade.explicit else p.anchor(),
                    c.address,
                )


@_check("AVD-GCP-0054", "GKE nodes should use the COS image type", "LOW", "gke")
def gke_cos_image(st: GoogleState):
    for c in st.gke_clusters:
        configs = [(c.node_config, c.address)] + [
            (p.node_config, c.address) for p in c.node_pools
        ]
        for nc, addr in configs:
            if nc is None:
                continue
            img = nc.image_type.str()
            if img and not img.upper().startswith("COS"):
                yield CloudFailure(
                    f"Node image type {img!r} is not a COS image",
                    nc.image_type, addr,
                )


@_check("AVD-GCP-0050", "GKE legacy metadata endpoints should be disabled",
        "HIGH", "gke")
def gke_legacy_endpoints(st: GoogleState):
    for c in st.gke_clusters:
        configs = [c.node_config] + [p.node_config for p in c.node_pools]
        for nc in configs:
            if nc is not None and nc.enable_legacy_endpoints.bool():
                yield CloudFailure(
                    "Node config enables legacy metadata endpoints",
                    nc.enable_legacy_endpoints, c.address,
                )


@_check("AVD-GCP-0049", "GKE nodes should conceal instance metadata or use Workload Identity",
        "HIGH", "gke")
def gke_node_metadata(st: GoogleState):
    for c in st.gke_clusters:
        configs = [c.node_config] + [p.node_config for p in c.node_pools]
        for nc in configs:
            if nc is None:
                continue
            mode = nc.workload_metadata_mode.str().upper()
            if mode in ("UNSPECIFIED", "EXPOSE", "EXPOSED"):
                yield CloudFailure(
                    "Node workload metadata is exposed",
                    nc.workload_metadata_mode, c.address,
                )


@_check("AVD-GCP-0063", "GKE clusters should hold resource labels", "LOW", "gke")
def gke_resource_labels(st: GoogleState):
    for c in st.gke_clusters:
        if c.synthetic:
            continue
        if not c.resource.labels:
            continue
        labels = c.resource_labels.value
        if not isinstance(labels, dict) or not labels:
            yield CloudFailure(
                "Cluster does not define resource labels",
                c.resource_labels if c.resource_labels.explicit else c.anchor(),
                c.address,
            )


@_check("AVD-GCP-0065", "GKE clusters should use VPC-native (IP alias) networking",
        "LOW", "gke")
def gke_ip_aliasing(st: GoogleState):
    for c in st.gke_clusters:
        if c.synthetic:
            continue
        if not c.resource.labels:
            continue
        if c.enable_autopilot.bool():
            continue
        if not c.enable_ip_aliasing.bool():
            yield CloudFailure(
                "Cluster does not use VPC-native (ip_allocation_policy) networking",
                c.anchor(), c.address,
            )


# -- Cloud SQL ----------------------------------------------------------------

@_check("AVD-GCP-0017", "SQL instances should not be publicly accessible",
        "HIGH", "sql")
def sql_no_public_access(st: GoogleState):
    for i in st.sql_instances:
        if i.public_ipv4.bool():
            yield CloudFailure(
                "SQL instance has a public IPv4 address assigned",
                i.public_ipv4 if i.public_ipv4.explicit else i.anchor(),
                i.address,
            )
        for an in i.authorized_networks:
            if str(an.value or "").endswith("/0"):
                yield CloudFailure(
                    "SQL instance authorizes access from the public internet",
                    an, i.address,
                )


@_check("AVD-GCP-0015", "SQL instances should require TLS for connections",
        "HIGH", "sql")
def sql_require_tls(st: GoogleState):
    for i in st.sql_instances:
        if not i.require_tls.bool():
            yield CloudFailure(
                "SQL instance does not require TLS for all connections",
                i.require_tls if i.require_tls.explicit else i.anchor(),
                i.address,
            )


@_check("AVD-GCP-0024", "SQL instances should have automated backups enabled",
        "MEDIUM", "sql")
def sql_backups(st: GoogleState):
    for i in st.sql_instances:
        if not i.backups_enabled.bool():
            yield CloudFailure(
                "SQL instance does not enable automated backups",
                i.backups_enabled if i.backups_enabled.explicit else i.anchor(),
                i.address,
            )


def _pg_flag_check(id_, flag, title):
    @_check(id_, title, "LOW", "sql")
    def check(st: GoogleState, _flag=flag, _title=title):
        for i in st.sql_instances:
            if not i.is_postgres():
                continue
            v = i.flag(_flag)
            if v is None or v.str() not in ("on", "true", "1"):
                yield CloudFailure(
                    f"PostgreSQL instance does not enable {_flag}",
                    v if v is not None else i.anchor(),
                    i.address,
                )
    return check


_pg_flag_check("AVD-GCP-0025", "log_checkpoints",
               "PostgreSQL instances should log checkpoints")
_pg_flag_check("AVD-GCP-0016", "log_connections",
               "PostgreSQL instances should log connections")
_pg_flag_check("AVD-GCP-0022", "log_disconnections",
               "PostgreSQL instances should log disconnections")
_pg_flag_check("AVD-GCP-0020", "log_lock_waits",
               "PostgreSQL instances should log lock waits")


@_check("AVD-GCP-0026", "MySQL instances should disable local_infile", "HIGH", "sql")
def sql_mysql_local_infile(st: GoogleState):
    for i in st.sql_instances:
        if not i.is_mysql():
            continue
        v = i.flag("local_infile")
        if v is not None and v.str() in ("on", "true", "1"):
            yield CloudFailure(
                "MySQL instance enables local_infile", v, i.address
            )


@_check("AVD-GCP-0023", "SQL Server instances should disable contained database authentication",
        "MEDIUM", "sql")
def sql_sqlserver_contained_auth(st: GoogleState):
    for i in st.sql_instances:
        if not i.is_sqlserver():
            continue
        v = i.flag("contained database authentication")
        if v is not None and v.str() in ("on", "true", "1"):
            yield CloudFailure(
                "SQL Server instance enables contained database authentication",
                v, i.address,
            )


@_check("AVD-GCP-0019", "SQL Server instances should disable cross-database ownership chaining",
        "MEDIUM", "sql")
def sql_sqlserver_cross_db(st: GoogleState):
    for i in st.sql_instances:
        if not i.is_sqlserver():
            continue
        v = i.flag("cross db ownership chaining")
        if v is not None and v.str() in ("on", "true", "1"):
            yield CloudFailure(
                "SQL Server instance enables cross-database ownership chaining",
                v, i.address,
            )


# -- BigQuery / KMS / DNS -----------------------------------------------------

@_check("AVD-GCP-0046", "BigQuery datasets should not be publicly accessible",
        "CRITICAL", "bigquery")
def bigquery_no_public_access(st: GoogleState):
    for ds in st.bigquery_datasets:
        for g in ds.access_grants:
            if str(g.value or "") == "allAuthenticatedUsers":
                yield CloudFailure(
                    "Dataset grants access to allAuthenticatedUsers",
                    g, ds.address,
                )


@_check("AVD-GCP-0033", "KMS keys should be rotated at least every 90 days",
        "HIGH", "kms")
def kms_rotation(st: GoogleState):
    for k in st.kms_keys:
        secs = k.rotation_period_seconds.int()
        if secs == 0 or secs > 90 * 24 * 3600:
            yield CloudFailure(
                "KMS key is not rotated at least every 90 days",
                k.rotation_period_seconds
                if k.rotation_period_seconds.explicit
                else k.anchor(),
                k.address,
            )


@_check("AVD-GCP-0013", "Cloud DNS should use DNSSEC", "MEDIUM", "dns")
def dns_dnssec(st: GoogleState):
    for z in st.dns_zones:
        if z.visibility.str() == "private":
            continue
        if not z.dnssec_enabled.bool():
            yield CloudFailure(
                "Managed zone does not enable DNSSEC",
                z.dnssec_enabled if z.dnssec_enabled.explicit else z.anchor(),
                z.address,
            )


@_check("AVD-GCP-0012", "DNSSEC keys should not use RSASHA1", "MEDIUM", "dns")
def dns_no_rsasha1(st: GoogleState):
    for z in st.dns_zones:
        for alg in z.key_algorithms:
            if str(alg.value or "").lower() == "rsasha1":
                yield CloudFailure(
                    "DNSSEC key uses the deprecated RSASHA1 algorithm",
                    alg, z.address,
                )


# -- IAM / platform -----------------------------------------------------------

_PRIVILEGED_ROLES = ("roles/owner", "roles/editor")


@_check("AVD-GCP-0007", "Service accounts should not have roles assigned with excessive privileges",
        "HIGH", "iam",
        "Service accounts should have a minimal set of permissions assigned in "
        "order to do their job.",
        "Limit service account access to minimal required set")
def iam_no_privileged_sa(st: GoogleState):
    for b in st.iam_bindings:
        role = b.role.str()
        if role not in _PRIVILEGED_ROLES:
            continue
        for m in b.members:
            if str(m.value or "").startswith("serviceAccount:"):
                yield CloudFailure(
                    "Service account is granted a privileged role.",
                    m, b.address,
                )


@_check("AVD-GCP-0010", "Default service accounts should not be used in IAM bindings",
        "HIGH", "iam")
def iam_no_default_sa(st: GoogleState):
    for b in st.iam_bindings:
        if b.default_service_account.bool():
            yield CloudFailure(
                "IAM binding grants a role to a default service account",
                b.default_service_account, b.address,
            )


@_check("AVD-GCP-0006", "Projects should not auto-create default networks",
        "MEDIUM", "platform")
def project_no_auto_network(st: GoogleState):
    for p in st.projects:
        if p.auto_create_network.bool():
            yield CloudFailure(
                "Project auto-creates the permissive default network",
                p.auto_create_network if p.auto_create_network.explicit else p.anchor(),
                p.address,
            )


# -- round-4 second wave ------------------------------------------------------

@_check("AVD-GCP-0014", "Storage buckets should enable object versioning",
        "LOW", "storage")
def storage_versioning(st: GoogleState):
    for b in st.storage_buckets:
        if b.resource.labels and b.resource.labels[0] != "google_storage_bucket":
            continue
        if not b.versioning_enabled.bool():
            yield CloudFailure(
                "Bucket does not enable object versioning",
                b.versioning_enabled if b.versioning_enabled.explicit else b.anchor(),
                b.address,
            )


@_check("AVD-GCP-0018", "PostgreSQL instances should log temporary files",
        "LOW", "sql")
def sql_pg_log_temp_files(st: GoogleState):
    for i in st.sql_instances:
        if not i.is_postgres():
            continue
        v = i.flag("log_temp_files")
        if v is None or v.str() not in ("0",):
            yield CloudFailure(
                "PostgreSQL instance does not log all temporary files (log_temp_files=0)",
                v if v is not None else i.anchor(),
                i.address,
            )


@_check("AVD-GCP-0011", "Users should not hold service-account admin roles at project level",
        "HIGH", "iam")
def iam_no_sa_admin_users(st: GoogleState):
    bad_roles = ("roles/iam.serviceAccountUser", "roles/iam.serviceAccountAdmin")
    for b in st.iam_bindings:
        if b.role.str() not in bad_roles:
            continue
        for m in b.members:
            if str(m.value or "").startswith("user:"):
                yield CloudFailure(
                    f"User is granted {b.role.str()} at project level",
                    m, b.address,
                )


@_check("AVD-GCP-0031", "Project metadata should block project-wide SSH keys",
        "MEDIUM", "compute", targets="project_metadata")
def project_block_ssh_keys(st: GoogleState):
    for pm in st.project_metadata:
        if not pm.block_project_ssh_keys.bool():
            yield CloudFailure(
                "Project metadata does not block project-wide SSH keys",
                pm.block_project_ssh_keys
                if pm.block_project_ssh_keys.explicit
                else pm.anchor(),
                pm.address,
            )


@_check("AVD-GCP-0040", "Project metadata should enable OS Login",
        "MEDIUM", "compute", targets="project_metadata")
def project_os_login(st: GoogleState):
    for pm in st.project_metadata:
        if not pm.oslogin_enabled.bool():
            yield CloudFailure(
                "Project metadata does not enable OS Login",
                pm.oslogin_enabled if pm.oslogin_enabled.explicit else pm.anchor(),
                pm.address,
            )


@_check("AVD-GCP-0034", "Subnetworks should enable Private Google Access",
        "LOW", "compute", targets="subnetworks")
def subnet_private_google_access(st: GoogleState):
    for sn in st.subnetworks:
        if sn.purpose.str() in ("REGIONAL_MANAGED_PROXY", "GLOBAL_MANAGED_PROXY"):
            continue
        if not sn.private_google_access.bool():
            yield CloudFailure(
                "Subnetwork does not enable Private Google Access",
                sn.private_google_access
                if sn.private_google_access.explicit
                else sn.anchor(),
                sn.address,
            )


@_check("AVD-GCP-0021", "PostgreSQL should not log every statement duration",
        "LOW", "sql")
def sql_pg_min_duration(st: GoogleState):
    for i in st.sql_instances:
        if not i.is_postgres():
            continue
        v = i.flag("log_min_duration_statement")
        if v is not None and v.str() not in ("-1",):
            yield CloudFailure(
                "log_min_duration_statement records statement text (set -1)",
                v, i.address,
            )
