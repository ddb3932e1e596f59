"""Terraform → Google Cloud state adapter
(ref: pkg/iac/adapters/terraform/google — independent lean equivalent).

The port of ``trivy_tpu/misconf/adapters/google_tf.py``.
"""

from __future__ import annotations

from trivy_tpu_torch.misconf.adapters import google_state as G
from trivy_tpu_torch.misconf.state import BlockVal, default_val


def adapt(resources: list[BlockVal]) -> G.GoogleState:
    st = G.GoogleState()
    by_type: dict[str, list[BlockVal]] = {}
    for r in resources:
        if r.type == "resource" and r.labels:
            by_type.setdefault(r.labels[0], []).append(r)

    _adapt_storage(by_type, st)
    _adapt_compute(by_type, st)
    _adapt_gke(by_type, st)
    _adapt_sql(by_type, st)
    _adapt_misc(by_type, st)
    return st


def _adapt_storage(by_type, st: G.GoogleState):
    buckets: list[tuple[BlockVal, G.StorageBucket]] = []
    for bv in by_type.get("google_storage_bucket", []):
        b = G.StorageBucket(resource=bv)
        b.name = bv.get("name")
        b.location = bv.get("location")
        b.uniform_bucket_level_access = bv.get(
            "uniform_bucket_level_access", False
        )
        enc = bv.block("encryption")
        if enc is not None:
            b.encryption_kms_key = enc.get("default_kms_key_name")
        logging = bv.block("logging")
        if logging is not None:
            b.logging_enabled = default_val(True, logging)
        ver = bv.block("versioning")
        if ver is not None:
            b.versioning_enabled = ver.get("enabled", False)
        buckets.append((bv, b))
        st.storage_buckets.append(b)
    # bucket IAM members/bindings attach by bucket name/reference
    for rtype, member_attr in (
        ("google_storage_bucket_iam_member", "member"),
        ("google_storage_bucket_iam_binding", "members"),
    ):
        for bv in by_type.get(rtype, []):
            target_name = bv.get("bucket").str()
            target = None
            for pbv, pb in buckets:
                if pb.name.str() == target_name or pbv.name == target_name.split(
                    "."
                )[-1]:
                    target = pb
                    break
            vals = []
            mv = bv.get(member_attr)
            if isinstance(mv.value, list):
                vals = [mv.with_value(x) for x in mv.value]
            elif mv.is_set():
                vals = [mv]
            if target is not None:
                target.members.extend(vals)
            else:
                # orphan grant: track on a synthetic bucket so public-access
                # checks still fire
                b = G.StorageBucket(resource=bv)
                b.members = vals
                st.storage_buckets.append(b)


def _disk_encryption(bv: BlockVal) -> G.DiskEncryption | None:
    enc = bv.block("disk_encryption_key")
    if enc is None:
        return None
    de = G.DiskEncryption(resource=enc)
    de.raw_key = enc.get("raw_key")
    de.kms_key_link = enc.get("kms_key_self_link")
    return de


def _adapt_compute(by_type, st: G.GoogleState):
    for bv in by_type.get("google_compute_disk", []):
        d = G.ComputeDisk(resource=bv)
        d.name = bv.get("name")
        d.encryption = _disk_encryption(bv)
        st.compute_disks.append(d)

    for rtype in ("google_compute_firewall",):
        for bv in by_type.get(rtype, []):
            fw = G.Firewall(resource=bv)
            fw.name = bv.get("name")
            direction = bv.get("direction", "INGRESS").str().upper()
            srcs = bv.get("source_ranges")
            dsts = bv.get("destination_ranges")
            src_vals = (
                [srcs.with_value(x) for x in srcs.value]
                if isinstance(srcs.value, list)
                else ([srcs] if srcs.is_set() else [])
            )
            dst_vals = (
                [dsts.with_value(x) for x in dsts.value]
                if isinstance(dsts.value, list)
                else ([dsts] if dsts.is_set() else [])
            )
            for kind, allow in (("allow", True), ("deny", False)):
                for rule_bv in bv.blocks(kind):
                    r = G.FirewallRule(resource=rule_bv, is_allow=allow)
                    r.protocol = rule_bv.get("protocol")
                    pv = rule_bv.get("ports")
                    if isinstance(pv.value, list):
                        r.ports = [pv.with_value(str(x)) for x in pv.value]
                    elif pv.is_set():
                        r.ports = [pv]
                    r.direction = direction
                    r.source_ranges = src_vals
                    r.dest_ranges = dst_vals
                    fw.rules.append(r)
            st.firewalls.append(fw)

    for bv in by_type.get("google_compute_subnetwork", []):
        sn = G.Subnetwork(resource=bv)
        sn.name = bv.get("name")
        sn.purpose = bv.get("purpose", "PRIVATE")
        sn.private_google_access = bv.get("private_ip_google_access", False)
        sn.flow_logs_enabled = default_val(
            bv.block("log_config") is not None, bv
        )
        if bv.block("log_config") is not None:
            sn.flow_logs_enabled = default_val(True, bv.block("log_config"))
        st.subnetworks.append(sn)

    for bv in by_type.get("google_compute_ssl_policy", []):
        sp = G.SSLPolicy(resource=bv)
        sp.name = bv.get("name")
        sp.min_tls_version = bv.get("min_tls_version", "TLS_1_0")
        sp.profile = bv.get("profile", "COMPATIBLE")
        st.ssl_policies.append(sp)

    for bv in by_type.get("google_compute_instance", []):
        inst = G.ComputeInstance(resource=bv)
        inst.name = bv.get("name")
        sh = bv.block("shielded_instance_config")
        if sh is not None:
            inst.shielded_secure_boot = sh.get("enable_secure_boot", False)
            inst.shielded_vtpm = sh.get("enable_vtpm", True)
            inst.shielded_integrity = sh.get("enable_integrity_monitoring", True)
        for ni in bv.blocks("network_interface"):
            if ni.blocks("access_config") or ni.blocks("ipv6_access_config"):
                inst.public_ip = default_val(True, ni)
        meta = bv.get("metadata")
        md = meta.value if isinstance(meta.value, dict) else {}

        def meta_val(key):
            v = md.get(key)
            return None if v is None else meta.with_value(v)

        v = meta_val("enable-oslogin")
        if v is not None:
            inst.os_login_disabled = v.with_value(
                str(v.value).lower() in ("false", "0")
            )
        v = meta_val("serial-port-enable")
        if v is not None:
            inst.serial_port_enabled = v.with_value(
                str(v.value).lower() in ("true", "1")
            )
        v = meta_val("block-project-ssh-keys")
        if v is not None:
            inst.block_project_ssh_keys = v.with_value(
                str(v.value).lower() in ("true", "1")
            )
        inst.ip_forwarding = bv.get("can_ip_forward", False)
        sa = bv.block("service_account")
        if sa is not None:
            ref = G.ServiceAccountRef(resource=sa)
            ref.email = sa.get("email")
            email = ref.email.str()
            ref.is_default = ref.email.with_value(
                email.endswith("-compute@developer.gserviceaccount.com")
                or email == ""
            )
            sv = sa.get("scopes")
            if isinstance(sv.value, list):
                ref.scopes = [sv.with_value(x) for x in sv.value]
            elif sv.is_set():
                ref.scopes = [sv]
            inst.service_account = ref
        bd = bv.block("boot_disk")
        if bd is not None:
            inst.boot_disk_encryption = _disk_encryption(bd)
            raw = bd.get("disk_encryption_key_raw")
            if raw.is_set():
                de = inst.boot_disk_encryption or G.DiskEncryption(resource=bd)
                de.raw_key = raw
                inst.boot_disk_encryption = de
        st.compute_instances.append(inst)


def _node_config(bv: BlockVal) -> G.NodeConfig | None:
    nc_bv = bv.block("node_config")
    if nc_bv is None:
        return None
    nc = G.NodeConfig(resource=nc_bv)
    nc.image_type = nc_bv.get("image_type")
    nc.service_account = nc_bv.get("service_account")
    wm = nc_bv.block("workload_metadata_config")
    if wm is not None:
        mode = wm.get("mode")
        if not mode.is_set():
            mode = wm.get("node_metadata")
        nc.workload_metadata_mode = mode
    meta = nc_bv.get("metadata")
    md = meta.value if isinstance(meta.value, dict) else {}
    if "disable-legacy-endpoints" in md:
        nc.enable_legacy_endpoints = meta.with_value(
            str(md["disable-legacy-endpoints"]).lower() not in ("true", "1")
        )
    return nc


def _adapt_gke(by_type, st: G.GoogleState):
    clusters: list[tuple[BlockVal, G.GKECluster]] = []
    for bv in by_type.get("google_container_cluster", []):
        c = G.GKECluster(resource=bv)
        c.name = bv.get("name")
        c.logging_service = bv.get(
            "logging_service", "logging.googleapis.com/kubernetes"
        )
        c.monitoring_service = bv.get(
            "monitoring_service", "monitoring.googleapis.com/kubernetes"
        )
        c.enable_legacy_abac = bv.get("enable_legacy_abac", False)
        c.enable_shielded_nodes = bv.get("enable_shielded_nodes", True)
        c.remove_default_node_pool = bv.get("remove_default_node_pool", False)
        c.enable_autopilot = bv.get("enable_autopilot", False)
        c.resource_labels = bv.get("resource_labels")
        c.datapath_provider = bv.get("datapath_provider", "LEGACY_DATAPATH")
        np_bv = bv.block("network_policy")
        if np_bv is not None:
            c.network_policy_enabled = np_bv.get("enabled", False)
        pc = bv.block("private_cluster_config")
        if pc is not None:
            c.enable_private_nodes = pc.get("enable_private_nodes", False)
        man = bv.block("master_authorized_networks_config")
        if man is not None:
            c.master_authorized_networks_set = default_val(True, man)
            cidrs = [
                cb.get("cidr_block")
                for cb in man.blocks("cidr_blocks")
                if cb.get("cidr_block").is_set()
            ]
            c.master_authorized_networks = default_val(
                [v.str() for v in cidrs], man
            )
        ma = bv.block("master_auth")
        if ma is not None:
            c.basic_auth_username = ma.get("username")
            c.basic_auth_password = ma.get("password")
            cc = ma.block("client_certificate_config")
            if cc is not None:
                c.client_certificate = cc.get("issue_client_certificate", False)
        if bv.block("ip_allocation_policy") is not None:
            c.enable_ip_aliasing = default_val(
                True, bv.block("ip_allocation_policy")
            )
        c.node_config = _node_config(bv)
        clusters.append((bv, c))
        st.gke_clusters.append(c)

    for bv in by_type.get("google_container_node_pool", []):
        pool = G.NodePool(resource=bv)
        mgmt = bv.block("management")
        if mgmt is not None:
            pool.auto_repair = mgmt.get("auto_repair", False)
            pool.auto_upgrade = mgmt.get("auto_upgrade", False)
        pool.node_config = _node_config(bv)
        target = None
        cv = bv.get("cluster")
        from trivy_tpu_torch.misconf.adapters.aws_tf import _target_block

        tb = _target_block(cv, clusters, "name")
        if tb is not None:
            for cbv, c in clusters:
                if cbv is tb:
                    target = c
                    break
        if target is None:
            cluster_ref = cv.str()
            # exact name/label match only — substring matching mis-binds
            # pools when cluster names prefix each other
            for cbv, c in clusters:
                if cluster_ref and (
                    c.name.str() == cluster_ref
                    or (len(cbv.labels) > 1 and cbv.labels[1] == cluster_ref)
                ):
                    target = c
                    break
        if target is None and len(clusters) == 1:
            target = clusters[0][1]
        if target is not None:
            target.node_pools.append(pool)
        else:
            # orphan/ambiguous pool: its own wrapper so pool checks run and
            # findings anchor to the pool resource, not a guessed cluster
            c = G.GKECluster(resource=bv, synthetic=True)
            c.node_pools.append(pool)
            st.gke_clusters.append(c)


def _adapt_sql(by_type, st: G.GoogleState):
    for bv in by_type.get("google_sql_database_instance", []):
        inst = G.SQLInstance(resource=bv)
        inst.name = bv.get("name")
        inst.database_version = bv.get("database_version")
        settings = bv.block("settings")
        if settings is not None:
            ip = settings.block("ip_configuration")
            if ip is not None:
                inst.require_tls = ip.get("require_ssl", False)
                inst.public_ipv4 = ip.get("ipv4_enabled", True)
                for an in ip.blocks("authorized_networks"):
                    v = an.get("value")
                    if v.is_set():
                        inst.authorized_networks.append(v)
            else:
                inst.public_ipv4 = default_val(True, settings)
            bk = settings.block("backup_configuration")
            if bk is not None:
                inst.backups_enabled = bk.get("enabled", False)
            for fl in settings.blocks("database_flags"):
                name = fl.get("name").str()
                if name:
                    inst.flags[name] = fl.get("value")
        else:
            inst.public_ipv4 = default_val(True, bv)
        st.sql_instances.append(inst)


def _adapt_misc(by_type, st: G.GoogleState):
    for bv in by_type.get("google_bigquery_dataset", []):
        ds = G.BigQueryDataset(resource=bv)
        ds.id = bv.get("dataset_id")
        for acc in bv.blocks("access"):
            sg = acc.get("special_group")
            if sg.is_set():
                ds.access_grants.append(sg)
        st.bigquery_datasets.append(ds)

    for bv in by_type.get("google_kms_crypto_key", []):
        k = G.KMSKey(resource=bv)
        rp = bv.get("rotation_period")
        secs = 0
        s = rp.str()
        if s.endswith("s"):
            try:
                secs = int(float(s[:-1]))
            except ValueError:
                secs = 0
        k.rotation_period_seconds = rp.with_value(secs) if rp.is_set() else rp
        st.kms_keys.append(k)

    for bv in by_type.get("google_dns_managed_zone", []):
        z = G.DNSManagedZone(resource=bv)
        z.name = bv.get("name")
        z.visibility = bv.get("visibility", "public")
        dnssec = bv.block("dnssec_config")
        if dnssec is not None:
            state = dnssec.get("state")
            z.dnssec_enabled = state.with_value(state.str() == "on")
            for spec in dnssec.blocks("default_key_specs"):
                alg = spec.get("algorithm")
                if alg.is_set():
                    z.key_algorithms.append(alg)
        st.dns_zones.append(z)

    for rtype, many in (
        ("google_project_iam_binding", True),
        ("google_project_iam_member", False),
        ("google_folder_iam_binding", True),
        ("google_folder_iam_member", False),
        ("google_organization_iam_binding", True),
        ("google_organization_iam_member", False),
    ):
        for bv in by_type.get(rtype, []):
            b = G.IAMBinding(resource=bv)
            b.role = bv.get("role")
            mv = bv.get("members" if many else "member")
            if isinstance(mv.value, list):
                b.members = [mv.with_value(x) for x in mv.value]
            elif mv.is_set():
                b.members = [mv]
            b.default_service_account = mv.with_value(
                any(
                    str(m.value or "").endswith(
                        ("-compute@developer.gserviceaccount.com",
                         "@appspot.gserviceaccount.com")
                    )
                    for m in b.members
                )
            )
            st.iam_bindings.append(b)

    for bv in by_type.get("google_compute_project_metadata", []):
        pm = G.ProjectMetadata(resource=bv)
        meta = bv.get("metadata")
        md = meta.value if isinstance(meta.value, dict) else {}
        if "block-project-ssh-keys" in md:
            pm.block_project_ssh_keys = meta.with_value(
                str(md["block-project-ssh-keys"]).lower() in ("true", "1")
            )
        if "enable-oslogin" in md:
            pm.oslogin_enabled = meta.with_value(
                str(md["enable-oslogin"]).lower() in ("true", "1")
            )
        st.project_metadata.append(pm)

    for bv in by_type.get("google_project", []):
        p = G.GoogleProject(resource=bv)
        p.auto_create_network = bv.get("auto_create_network", True)
        st.projects.append(p)
