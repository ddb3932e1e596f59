"""Terraform → Azure state adapter
(ref: pkg/iac/adapters/terraform/azure — independent lean equivalent;
produces the same :class:`AzureState` the ARM template adapter builds, so
one azure check set serves both input formats).

The port of ``trivy_tpu/misconf/adapters/azure_tf.py``.
"""

from __future__ import annotations

from trivy_tpu_torch.misconf.arm import (
    AzAKSCluster,
    AzAppService,
    AzKeyVault,
    AzKeyVaultObject,
    AzNSGRule,
    AzSQLServer,
    AzStorageAccount,
    AzureState,
    AzVM,
)
from trivy_tpu_torch.misconf.state import BlockVal, default_val


def adapt(resources: list[BlockVal]) -> AzureState:
    st = AzureState()
    by_type: dict[str, list[BlockVal]] = {}
    for r in resources:
        if r.type == "resource" and r.labels:
            by_type.setdefault(r.labels[0], []).append(r)

    for bv in by_type.get("azurerm_storage_account", []):
        acct = AzStorageAccount(resource=bv)
        acct.enforce_https = bv.get("enable_https_traffic_only", True)
        if not acct.enforce_https.explicit:
            acct.enforce_https = bv.get("https_traffic_only_enabled", True)
        acct.min_tls_version = bv.get("min_tls_version", "TLS1_2")
        rules = bv.block("network_rules")
        if rules is not None:
            da = rules.get("default_action", "Allow")
            acct.network_default_allow = da.with_value(da.str().lower() == "allow")
        st.az_storage_accounts.append(acct)

    for bv in by_type.get("azurerm_network_security_rule", []):
        r = AzNSGRule(resource=bv)
        acc = bv.get("access", "Allow")
        r.allow = acc.with_value(acc.str().lower() == "allow")
        direction = bv.get("direction", "Inbound")
        r.outbound = direction.with_value(direction.str().lower() == "outbound")
        src_one = bv.get("source_address_prefix")
        srcs = bv.get("source_address_prefixes")
        src_list = list(srcs.value) if isinstance(srcs.value, list) else []
        if src_one.is_set():
            src_list.append(src_one.str())
        r.source_addresses = (src_one if src_one.is_set() else srcs).with_value(
            src_list
        )
        port_one = bv.get("destination_port_range")
        ports = bv.get("destination_port_ranges")
        port_list = list(ports.value) if isinstance(ports.value, list) else []
        if port_one.is_set():
            port_list.append(port_one.str())
        r.dest_ports = (port_one if port_one.is_set() else ports).with_value(
            [str(p) for p in port_list]
        )
        st.az_nsg_rules.append(r)

    for rtype, attr, dflt in (
        ("azurerm_linux_virtual_machine", "disable_password_authentication", True),
        ("azurerm_virtual_machine", "", False),
    ):
        for bv in by_type.get(rtype, []):
            vm = AzVM(resource=bv)
            if attr:
                vm.password_auth_disabled = bv.get(attr, dflt)
            else:
                prof = bv.block("os_profile_linux_config")
                vm.password_auth_disabled = (
                    prof.get("disable_password_authentication", False)
                    if prof is not None
                    else default_val(True, bv)  # windows/unknown: not applicable
                )
            st.az_virtual_machines.append(vm)

    for bv in by_type.get("azurerm_key_vault", []):
        kv = AzKeyVault(resource=bv)
        kv.purge_protection = bv.get("purge_protection_enabled", False)
        acls = bv.block("network_acls")
        if acls is not None:
            da = acls.get("default_action", "Allow")
            kv.network_default_allow = da.with_value(da.str().lower() == "allow")
        st.az_key_vaults.append(kv)

    for rtype, kind in (
        ("azurerm_key_vault_secret", "secret"),
        ("azurerm_key_vault_key", "key"),
    ):
        for bv in by_type.get(rtype, []):
            obj = AzKeyVaultObject(resource=bv, kind=kind)
            exp = bv.get("expiration_date")
            obj.expiry_set = exp.with_value(bool(exp.str())) if exp.is_set() else exp
            obj.content_type = bv.get("content_type")
            st.az_key_vault_objects.append(obj)

    for bv in by_type.get("azurerm_kubernetes_cluster", []):
        c = AzAKSCluster(resource=bv)
        rbac = bv.get("role_based_access_control_enabled", True)
        legacy = bv.block("role_based_access_control")
        if legacy is not None:
            rbac = legacy.get("enabled", True)
        c.rbac_enabled = rbac
        np = bv.block("network_profile")
        if np is not None:
            c.network_policy = np.get("network_policy")
        c.private_cluster = bv.get("private_cluster_enabled", False)
        ranges = bv.get("api_server_authorized_ip_ranges")
        api = bv.block("api_server_access_profile")
        if api is not None and not ranges.is_set():
            ranges = api.get("authorized_ip_ranges")
        c.authorized_ip_ranges = ranges
        oms = bv.block("oms_agent")
        addon = bv.block("addon_profile")
        if oms is None and addon is not None:
            oms = addon.block("oms_agent")
        c.logging_enabled = (
            default_val(True, oms) if oms is not None else default_val(False, bv)
        )
        st.az_aks_clusters.append(c)

    servers: list[tuple[BlockVal, AzSQLServer]] = []
    for rtype, flavor in (
        ("azurerm_mssql_server", "mssql"),
        ("azurerm_sql_server", "mssql"),
        ("azurerm_postgresql_server", "postgresql"),
        ("azurerm_mysql_server", "mysql"),
    ):
        for bv in by_type.get(rtype, []):
            s = AzSQLServer(resource=bv, flavor=flavor)
            s.public_network_access = bv.get("public_network_access_enabled", True)
            s.min_tls = bv.get("minimum_tls_version", "1.2")
            if flavor in ("postgresql", "mysql"):
                s.ssl_enforce = bv.get("ssl_enforcement_enabled", False)
            ext = bv.block("extended_auditing_policy")
            if ext is not None:
                s.auditing_enabled = default_val(True, ext)
                s.audit_retention_days = ext.get("retention_in_days", 0)
            else:
                s.auditing_enabled = default_val(False, bv)
            servers.append((bv, s))
            st.az_sql_servers.append(s)
    def _target_server(bv: BlockVal, attrs: tuple[str, ...]) -> AzSQLServer | None:
        """Resolve a sub-resource's server: reference identity, then label
        substring, then the single-server fallback; None when ambiguous."""
        from trivy_tpu_torch.misconf.adapters.aws_tf import _target_block

        cands = [(sbv, srv) for sbv, srv in servers]
        for attr in attrs:
            v = bv.get(attr)
            tb = _target_block(v, cands, "name")
            if tb is not None:
                for sbv, srv in servers:
                    if sbv is tb:
                        return srv
            ref = v.str()
            if ref:
                for sbv, srv in servers:
                    if len(sbv.labels) > 1 and sbv.labels[1] == ref:
                        return srv
                for sbv, srv in servers:
                    if len(sbv.labels) > 1 and f".{sbv.labels[1]}." in f".{ref}.":
                        return srv
        return servers[0][1] if len(servers) == 1 else None

    for rtype in (
        "azurerm_mssql_server_extended_auditing_policy",
        "azurerm_mssql_database_extended_auditing_policy",
    ):
        for bv in by_type.get(rtype, []):
            s = _target_server(bv, ("server_id", "database_id"))
            if s is not None:
                s.auditing_enabled = default_val(True, bv)
                s.audit_retention_days = bv.get("retention_in_days", 0)
    for rtype in (
        "azurerm_sql_firewall_rule", "azurerm_mssql_firewall_rule",
        "azurerm_postgresql_firewall_rule", "azurerm_mysql_firewall_rule",
    ):
        for bv in by_type.get(rtype, []):
            start = bv.get("start_ip_address").str()
            end = bv.get("end_ip_address").str()
            if start == "0.0.0.0" and end in ("255.255.255.255", "0.0.0.0"):
                s = _target_server(bv, ("server_id", "server_name"))
                if s is None:
                    # orphan rule (server outside this config): a bare
                    # carrier so the firewall check still fires without
                    # fabricating mssql audit findings
                    s = AzSQLServer(resource=bv, flavor="")
                    st.az_sql_servers.append(s)
                s.firewall_open_to_internet.append(bv.get("start_ip_address"))

    for rtype in (
        "azurerm_app_service", "azurerm_linux_web_app", "azurerm_windows_web_app",
    ):
        for bv in by_type.get(rtype, []):
            app = AzAppService(resource=bv)
            app.https_only = bv.get("https_only", False)
            sc = bv.block("site_config")
            if sc is not None:
                app.min_tls = sc.get("minimum_tls_version", "1.2")
                app.http2 = sc.get("http2_enabled", False)
            else:
                app.min_tls = default_val("1.2", bv)
                app.http2 = default_val(False, bv)
            app.client_cert = bv.get(
                "client_certificate_enabled", bv.get("client_cert_enabled").value
            )
            app.identity = default_val(bv.block("identity") is not None, bv)
            st.az_app_services.append(app)

    return st
