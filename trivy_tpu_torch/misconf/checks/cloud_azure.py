"""Builtin Azure checks over typed provider state — additions beyond the
ARM-era base set in trivy_tpu_torch.misconf.arm (AVD-AZU IDs are the public
interface; logic written against this repo's state model, ref:
pkg/iac/providers/azure for the modeled surface). Served by both the ARM
template adapter and the terraform adapter (adapters/azure_tf.py).

The port of ``trivy_tpu/misconf/checks/cloud_azure.py``.
"""

from __future__ import annotations

from trivy_tpu_torch.misconf.arm import FILE_TYPE, AzureState
from trivy_tpu_torch.misconf.checks import Check, CloudFailure, register_cloud

_TYPES = (FILE_TYPE, "terraform")
_URL = "https://avd.aquasec.com/misconfig/{}"


def _check(id_, title, severity, service, targets, desc="", res=""):
    def wrap(fn):
        register_cloud(
            Check(
                id=id_, avd_id=id_, title=title, severity=severity,
                file_types=_TYPES, fn=fn, description=desc, resolution=res,
                url=_URL.format(id_.lower()), service=service,
                provider="azure", targets=targets,
            )
        )
        return fn

    return wrap


# -- AKS ----------------------------------------------------------------------

@_check("AVD-AZU-0042", "AKS clusters should have RBAC enabled", "HIGH",
        "container", "az_aks_clusters")
def aks_rbac(st: AzureState):
    for c in st.az_aks_clusters:
        if not c.rbac_enabled.bool(True):
            yield CloudFailure(
                "AKS cluster disables role-based access control",
                c.rbac_enabled, c.address,
            )


@_check("AVD-AZU-0043", "AKS clusters should define a network policy", "MEDIUM",
        "container", "az_aks_clusters")
def aks_network_policy(st: AzureState):
    for c in st.az_aks_clusters:
        if not c.network_policy.str():
            yield CloudFailure(
                "AKS cluster does not configure a network policy",
                c.network_policy if c.network_policy.explicit else c.anchor(),
                c.address,
            )


@_check("AVD-AZU-0041", "AKS API server should restrict authorized IP ranges",
        "MEDIUM", "container", "az_aks_clusters")
def aks_api_server_ranges(st: AzureState):
    for c in st.az_aks_clusters:
        if c.private_cluster.bool():
            continue
        ranges = c.authorized_ip_ranges.value
        if not (isinstance(ranges, list) and ranges):
            yield CloudFailure(
                "AKS API server is reachable from any network",
                c.authorized_ip_ranges
                if c.authorized_ip_ranges.explicit
                else c.anchor(),
                c.address,
            )


@_check("AVD-AZU-0040", "AKS clusters should enable control-plane logging",
        "MEDIUM", "container", "az_aks_clusters")
def aks_logging(st: AzureState):
    for c in st.az_aks_clusters:
        if not c.logging_enabled.bool():
            yield CloudFailure(
                "AKS cluster does not enable the OMS agent / control-plane logging",
                c.logging_enabled if c.logging_enabled.explicit else c.anchor(),
                c.address,
            )


# -- SQL ----------------------------------------------------------------------

@_check("AVD-AZU-0018", "SQL servers should have auditing enabled", "MEDIUM",
        "database", "az_sql_servers")
def sql_auditing(st: AzureState):
    for s in st.az_sql_servers:
        if s.flavor != "mssql":
            continue
        if not s.auditing_enabled.bool():
            yield CloudFailure(
                "SQL server does not enable extended auditing",
                s.auditing_enabled if s.auditing_enabled.explicit else s.anchor(),
                s.address,
            )


@_check("AVD-AZU-0025", "SQL server audit logs should be retained >= 90 days",
        "LOW", "database", "az_sql_servers")
def sql_audit_retention(st: AzureState):
    for s in st.az_sql_servers:
        if s.flavor != "mssql" or not s.auditing_enabled.bool():
            continue
        days = s.audit_retention_days.int()
        if 0 < days < 90:
            yield CloudFailure(
                f"Audit retention of {days} days is below 90",
                s.audit_retention_days, s.address,
            )


@_check("AVD-AZU-0022", "Database servers should not allow public network access",
        "MEDIUM", "database", "az_sql_servers")
def sql_public_network(st: AzureState):
    for s in st.az_sql_servers:
        if s.public_network_access.bool(True) and s.public_network_access.explicit:
            yield CloudFailure(
                "Database server enables public network access",
                s.public_network_access, s.address,
            )


@_check("AVD-AZU-0029", "Database firewalls should not open to the entire internet",
        "HIGH", "database", "az_sql_servers")
def sql_firewall_internet(st: AzureState):
    for s in st.az_sql_servers:
        for v in s.firewall_open_to_internet:
            yield CloudFailure(
                "Database firewall rule spans 0.0.0.0-255.255.255.255",
                v, s.address,
            )


@_check("AVD-AZU-0026", "PostgreSQL/MySQL servers should enforce SSL", "HIGH",
        "database", "az_sql_servers")
def sql_enforce_ssl(st: AzureState):
    for s in st.az_sql_servers:
        if s.flavor not in ("postgresql", "mysql"):
            continue
        if not s.ssl_enforce.bool():
            yield CloudFailure(
                "Database server does not enforce SSL connections",
                s.ssl_enforce if s.ssl_enforce.explicit else s.anchor(),
                s.address,
            )


@_check("AVD-AZU-0028", "Database servers should require TLS 1.2", "MEDIUM",
        "database", "az_sql_servers")
def sql_min_tls(st: AzureState):
    for s in st.az_sql_servers:
        tls = s.min_tls.str()
        if tls in ("1.0", "1.1", "TLS1_0", "TLS1_1", "TLSEnforcementDisabled"):
            yield CloudFailure(
                f"Database server allows TLS {tls}", s.min_tls, s.address
            )


# -- App Service --------------------------------------------------------------

@_check("AVD-AZU-0002", "App Services should enforce HTTPS only", "HIGH",
        "appservice", "az_app_services")
def app_https_only(st: AzureState):
    for a in st.az_app_services:
        if not a.https_only.bool():
            yield CloudFailure(
                "App Service does not enforce HTTPS-only traffic",
                a.https_only if a.https_only.explicit else a.anchor(),
                a.address,
            )


@_check("AVD-AZU-0006", "App Services should require TLS 1.2", "HIGH",
        "appservice", "az_app_services")
def app_min_tls(st: AzureState):
    for a in st.az_app_services:
        if a.min_tls.str() in ("1.0", "1.1"):
            yield CloudFailure(
                f"App Service allows TLS {a.min_tls.str()}", a.min_tls, a.address
            )


@_check("AVD-AZU-0001", "App Services should require client certificates",
        "LOW", "appservice", "az_app_services")
def app_client_cert(st: AzureState):
    for a in st.az_app_services:
        if not a.client_cert.bool():
            yield CloudFailure(
                "App Service does not require client certificates",
                a.client_cert if a.client_cert.explicit else a.anchor(),
                a.address,
            )


@_check("AVD-AZU-0005", "App Services should use a managed identity", "LOW",
        "appservice", "az_app_services")
def app_identity(st: AzureState):
    for a in st.az_app_services:
        if not a.identity.bool():
            yield CloudFailure(
                "App Service does not configure a managed identity",
                a.identity if a.identity.explicit else a.anchor(),
                a.address,
            )


@_check("AVD-AZU-0003", "App Services should enable HTTP/2", "LOW",
        "appservice", "az_app_services")
def app_http2(st: AzureState):
    for a in st.az_app_services:
        if not a.http2.bool():
            yield CloudFailure(
                "App Service does not enable HTTP/2",
                a.http2 if a.http2.explicit else a.anchor(),
                a.address,
            )


# -- Key Vault objects --------------------------------------------------------

@_check("AVD-AZU-0017", "Key vault secrets should have an expiration date",
        "MEDIUM", "keyvault", "az_key_vault_objects")
def keyvault_secret_expiry(st: AzureState):
    for o in st.az_key_vault_objects:
        if o.kind == "secret" and not o.expiry_set.bool():
            yield CloudFailure(
                "Key vault secret has no expiration date",
                o.expiry_set if o.expiry_set.explicit else o.anchor(),
                o.address,
            )


@_check("AVD-AZU-0014", "Key vault keys should have an expiration date",
        "MEDIUM", "keyvault", "az_key_vault_objects")
def keyvault_key_expiry(st: AzureState):
    for o in st.az_key_vault_objects:
        if o.kind == "key" and not o.expiry_set.bool():
            yield CloudFailure(
                "Key vault key has no expiration date",
                o.expiry_set if o.expiry_set.explicit else o.anchor(),
                o.address,
            )


@_check("AVD-AZU-0015", "Key vault secrets should declare a content type",
        "LOW", "keyvault", "az_key_vault_objects")
def keyvault_secret_content_type(st: AzureState):
    for o in st.az_key_vault_objects:
        if o.kind == "secret" and not o.content_type.str():
            yield CloudFailure(
                "Key vault secret does not declare a content type",
                o.content_type if o.content_type.explicit else o.anchor(),
                o.address,
            )


# -- NSG exposure (shared with the ARM-era base set's state) ------------------

def _nsg_public_sources(rule):
    srcs = rule.source_addresses.value
    for s in srcs if isinstance(srcs, list) else []:
        if str(s) in ("*", "0.0.0.0/0", "Internet", "any", "::/0"):
            yield s


def _nsg_covers_port(rule, port: int) -> bool:
    ports = rule.dest_ports.value
    for p in ports if isinstance(ports, list) else []:
        p = str(p)
        if p in ("*", "any"):
            return True
        if "-" in p:
            lo, _, hi = p.partition("-")
            try:
                if int(lo) <= port <= int(hi):
                    return True
            except ValueError:
                continue
        elif p.isdigit() and int(p) == port:
            return True
    return False


@_check("AVD-AZU-0051", "SSH should not be accessible from the internet", "CRITICAL",
        "network", "az_nsg_rules")
def nsg_ssh_blocked(st: AzureState):
    for r in st.az_nsg_rules:
        if not r.allow.bool() or r.outbound.bool():
            continue
        if _nsg_covers_port(r, 22) and any(True for _ in _nsg_public_sources(r)):
            yield CloudFailure(
                "Security rule allows SSH (22) from the public internet",
                r.source_addresses, r.address,
            )


@_check("AVD-AZU-0050", "RDP should not be accessible from the internet", "CRITICAL",
        "network", "az_nsg_rules")
def nsg_rdp_blocked(st: AzureState):
    for r in st.az_nsg_rules:
        if not r.allow.bool() or r.outbound.bool():
            continue
        if _nsg_covers_port(r, 3389) and any(True for _ in _nsg_public_sources(r)):
            yield CloudFailure(
                "Security rule allows RDP (3389) from the public internet",
                r.source_addresses, r.address,
            )
