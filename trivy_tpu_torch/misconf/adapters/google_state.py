"""Typed Google Cloud provider state consumed by the cloud checks
(ref: pkg/iac/providers/google — independent lean equivalent; every leaf is
a tracked :class:`Val` so failures carry line causes).

The port of ``trivy_tpu/misconf/adapters/google_state.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from trivy_tpu_torch.misconf.adapters.aws_state import Res, _v
from trivy_tpu_torch.misconf.state import Val


# -- storage ------------------------------------------------------------------

@dataclass
class StorageBucket(Res):
    name: Val = field(default_factory=_v)
    location: Val = field(default_factory=_v)
    uniform_bucket_level_access: Val = field(default_factory=_v)
    encryption_kms_key: Val = field(default_factory=_v)
    logging_enabled: Val = field(default_factory=_v)
    versioning_enabled: Val = field(default_factory=_v)
    members: list[Val] = field(default_factory=list)  # IAM member strings


# -- compute ------------------------------------------------------------------

@dataclass
class DiskEncryption(Res):
    raw_key: Val = field(default_factory=_v)
    kms_key_link: Val = field(default_factory=_v)


@dataclass
class ComputeDisk(Res):
    name: Val = field(default_factory=_v)
    encryption: DiskEncryption | None = None


@dataclass
class FirewallRule(Res):
    is_allow: bool = True
    protocol: Val = field(default_factory=_v)
    ports: list[Val] = field(default_factory=list)  # "22", "1000-2000"
    source_ranges: list[Val] = field(default_factory=list)
    dest_ranges: list[Val] = field(default_factory=list)
    direction: str = "INGRESS"


@dataclass
class Firewall(Res):
    name: Val = field(default_factory=_v)
    rules: list[FirewallRule] = field(default_factory=list)


@dataclass
class Subnetwork(Res):
    name: Val = field(default_factory=_v)
    flow_logs_enabled: Val = field(default_factory=_v)
    purpose: Val = field(default_factory=_v)
    private_google_access: Val = field(default_factory=_v)


@dataclass
class SSLPolicy(Res):
    name: Val = field(default_factory=_v)
    min_tls_version: Val = field(default_factory=_v)
    profile: Val = field(default_factory=_v)


@dataclass
class ServiceAccountRef(Res):
    email: Val = field(default_factory=_v)
    scopes: list[Val] = field(default_factory=list)
    is_default: Val = field(default_factory=_v)


@dataclass
class ComputeInstance(Res):
    name: Val = field(default_factory=_v)
    shielded_secure_boot: Val = field(default_factory=_v)
    shielded_vtpm: Val = field(default_factory=_v)
    shielded_integrity: Val = field(default_factory=_v)
    public_ip: Val = field(default_factory=_v)
    os_login_disabled: Val = field(default_factory=_v)  # metadata enable-oslogin=false
    serial_port_enabled: Val = field(default_factory=_v)
    ip_forwarding: Val = field(default_factory=_v)
    block_project_ssh_keys: Val = field(default_factory=_v)
    service_account: ServiceAccountRef | None = None
    boot_disk_encryption: DiskEncryption | None = None


# -- GKE ----------------------------------------------------------------------

@dataclass
class NodeConfig(Res):
    image_type: Val = field(default_factory=_v)
    service_account: Val = field(default_factory=_v)
    enable_legacy_endpoints: Val = field(default_factory=_v)
    workload_metadata_mode: Val = field(default_factory=_v)


@dataclass
class NodePool(Res):
    auto_repair: Val = field(default_factory=_v)
    auto_upgrade: Val = field(default_factory=_v)
    node_config: NodeConfig | None = None


@dataclass
class GKECluster(Res):
    synthetic: bool = False  # wrapper for an orphan node pool, not a real cluster
    name: Val = field(default_factory=_v)
    logging_service: Val = field(default_factory=_v)
    monitoring_service: Val = field(default_factory=_v)
    enable_legacy_abac: Val = field(default_factory=_v)
    enable_shielded_nodes: Val = field(default_factory=_v)
    remove_default_node_pool: Val = field(default_factory=_v)
    enable_autopilot: Val = field(default_factory=_v)
    resource_labels: Val = field(default_factory=_v)  # dict
    network_policy_enabled: Val = field(default_factory=_v)
    datapath_provider: Val = field(default_factory=_v)
    enable_private_nodes: Val = field(default_factory=_v)
    master_authorized_networks: Val = field(default_factory=_v)  # list of cidrs
    master_authorized_networks_set: Val = field(default_factory=_v)
    basic_auth_username: Val = field(default_factory=_v)
    basic_auth_password: Val = field(default_factory=_v)
    client_certificate: Val = field(default_factory=_v)
    enable_ip_aliasing: Val = field(default_factory=_v)
    node_config: NodeConfig | None = None
    node_pools: list[NodePool] = field(default_factory=list)


# -- Cloud SQL ----------------------------------------------------------------

@dataclass
class SQLInstance(Res):
    name: Val = field(default_factory=_v)
    database_version: Val = field(default_factory=_v)
    require_tls: Val = field(default_factory=_v)
    public_ipv4: Val = field(default_factory=_v)
    authorized_networks: list[Val] = field(default_factory=list)
    backups_enabled: Val = field(default_factory=_v)
    flags: dict[str, Val] = field(default_factory=dict)

    def flag(self, name: str) -> Val | None:
        return self.flags.get(name)

    def is_postgres(self) -> bool:
        return self.database_version.str().upper().startswith("POSTGRES")

    def is_mysql(self) -> bool:
        return self.database_version.str().upper().startswith("MYSQL")

    def is_sqlserver(self) -> bool:
        return self.database_version.str().upper().startswith("SQLSERVER")


# -- BigQuery / KMS / DNS / IAM ----------------------------------------------

@dataclass
class BigQueryDataset(Res):
    id: Val = field(default_factory=_v)
    access_grants: list[Val] = field(default_factory=list)  # special_group values


@dataclass
class KMSKey(Res):
    rotation_period_seconds: Val = field(default_factory=_v)


@dataclass
class DNSManagedZone(Res):
    name: Val = field(default_factory=_v)
    visibility: Val = field(default_factory=_v)
    dnssec_enabled: Val = field(default_factory=_v)
    key_algorithms: list[Val] = field(default_factory=list)


@dataclass
class IAMBinding(Res):
    role: Val = field(default_factory=_v)
    members: list[Val] = field(default_factory=list)
    default_service_account: Val = field(default_factory=_v)


@dataclass
class GoogleProject(Res):
    auto_create_network: Val = field(default_factory=_v)


@dataclass
class ProjectMetadata(Res):
    block_project_ssh_keys: Val = field(default_factory=_v)
    oslogin_enabled: Val = field(default_factory=_v)


@dataclass
class GoogleState:
    provider = "google"

    storage_buckets: list[StorageBucket] = field(default_factory=list)
    compute_disks: list[ComputeDisk] = field(default_factory=list)
    compute_instances: list[ComputeInstance] = field(default_factory=list)
    firewalls: list[Firewall] = field(default_factory=list)
    subnetworks: list[Subnetwork] = field(default_factory=list)
    ssl_policies: list[SSLPolicy] = field(default_factory=list)
    gke_clusters: list[GKECluster] = field(default_factory=list)
    sql_instances: list[SQLInstance] = field(default_factory=list)
    bigquery_datasets: list[BigQueryDataset] = field(default_factory=list)
    kms_keys: list[KMSKey] = field(default_factory=list)
    dns_zones: list[DNSManagedZone] = field(default_factory=list)
    iam_bindings: list[IAMBinding] = field(default_factory=list)
    projects: list[GoogleProject] = field(default_factory=list)
    project_metadata: list[ProjectMetadata] = field(default_factory=list)
