"""Terraform → AWS state adapter
(ref: pkg/iac/adapters/terraform/aws — independent lean equivalent).

Handles both the legacy inline style (``acl``/``versioning`` on
``aws_s3_bucket``) and the provider-4 split-resource style
(``aws_s3_bucket_versioning`` et al.), linking sub-resources to their
parent via reference identity or bucket-name equality.

The port of ``trivy_tpu/misconf/adapters/aws_tf.py``.
"""

from __future__ import annotations

import json

from trivy_tpu_torch.misconf.adapters import aws_state as S
from trivy_tpu_torch.misconf.state import BlockVal, Val, default_val


def _target_block(val: Val, candidates: list[tuple[BlockVal, "object"]], name_attr: str):
    """Resolve a sub-resource's parent: by reference identity, else by name."""
    v = val.value
    target = getattr(v, "target", None)
    if target is not None:
        try:
            tb = target.to_block_val()
        except Exception:
            tb = None
        for bv, _ in candidates:
            if bv is tb:
                return bv
    if isinstance(v, str):
        for bv, state in candidates:
            if bv.get(name_attr).str() == v:
                return bv
    return None


def adapt(resources: list[BlockVal]) -> S.AWSState:
    st = S.AWSState()
    # drop data sources for state building (checks target managed resources)
    managed = [r for r in resources if r.type == "resource"]
    by_type: dict[str, list[BlockVal]] = {}
    for r in managed:
        if r.labels:
            by_type.setdefault(r.labels[0], []).append(r)

    _adapt_s3(by_type, st)
    _adapt_ec2(by_type, st)
    _adapt_rds(by_type, st)
    _adapt_cloudtrail(by_type, st)
    _adapt_iam(by_type, st)
    _adapt_eks(by_type, st)
    _adapt_misc(by_type, st)
    _adapt_breadth(by_type, st)
    _adapt_breadth2(by_type, st)
    return st


# -- S3 -----------------------------------------------------------------------

def _adapt_s3(by_type, st: S.AWSState):
    buckets: list[tuple[BlockVal, S.S3Bucket]] = []
    for bv in by_type.get("aws_s3_bucket", []):
        b = S.S3Bucket(resource=bv)
        b.name = bv.get("bucket")
        b.acl = bv.get("acl", "private")
        ver = bv.block("versioning")
        if ver is not None:
            b.versioning_enabled = ver.get("enabled", False)
        enc = bv.block("server_side_encryption_configuration")
        if enc is not None:
            b.encryption_enabled = default_val(True, enc)
            rule = enc.block("rule")
            if rule is not None:
                dflt = rule.block("apply_server_side_encryption_by_default")
                if dflt is not None:
                    b.kms_key_id = dflt.get("kms_master_key_id")
        logging = bv.block("logging")
        if logging is not None:
            b.logging_enabled = default_val(True, logging)
        buckets.append((bv, b))
        st.s3_buckets.append(b)

    for bv in by_type.get("aws_s3_bucket_acl", []):
        parent = _target_block(bv.get("bucket"), buckets, "bucket")
        acl = bv.get("acl")
        for pbv, b in buckets:
            if pbv is parent and acl.is_set():
                b.acl = acl
    for bv in by_type.get("aws_s3_bucket_versioning", []):
        parent = _target_block(bv.get("bucket"), buckets, "bucket")
        cfg = bv.block("versioning_configuration")
        if cfg is None:
            continue
        status = cfg.get("status")
        for pbv, b in buckets:
            if pbv is parent:
                b.versioning_enabled = status.with_value(status.str() == "Enabled")
    for bv in by_type.get("aws_s3_bucket_server_side_encryption_configuration", []):
        parent = _target_block(bv.get("bucket"), buckets, "bucket")
        for pbv, b in buckets:
            if pbv is parent:
                b.encryption_enabled = default_val(True, bv)
                for rule in bv.blocks("rule"):
                    dflt = rule.block("apply_server_side_encryption_by_default")
                    if dflt is not None:
                        b.kms_key_id = dflt.get("kms_master_key_id")
    for bv in by_type.get("aws_s3_bucket_logging", []):
        parent = _target_block(bv.get("bucket"), buckets, "bucket")
        for pbv, b in buckets:
            if pbv is parent:
                b.logging_enabled = default_val(True, bv)
    for bv in by_type.get("aws_s3_bucket_public_access_block", []):
        parent = _target_block(bv.get("bucket"), buckets, "bucket")
        pab = S.PublicAccessBlock(
            resource=bv,
            block_public_acls=bv.get("block_public_acls", False),
            block_public_policy=bv.get("block_public_policy", False),
            ignore_public_acls=bv.get("ignore_public_acls", False),
            restrict_public_buckets=bv.get("restrict_public_buckets", False),
        )
        for pbv, b in buckets:
            if pbv is parent:
                b.public_access_block = pab


# -- EC2 / VPC ---------------------------------------------------------------

def _sg_rule(bv: BlockVal, rtype: str, cidr_attrs=("cidr_blocks",)) -> S.SGRule:
    cidrs: list = []
    cval = None
    for a in cidr_attrs:
        v = bv.get(a)
        if v.is_set():
            cval = v
            got = v.value if isinstance(v.value, list) else [v.value]
            cidrs.extend(x for x in got if isinstance(x, str))
    rule = S.SGRule(
        resource=bv,
        type=rtype,
        cidrs=(cval or bv.get("cidr_blocks")).with_value(cidrs) if cval else default_val(cidrs, bv),
        from_port=bv.get("from_port", -1),
        to_port=bv.get("to_port", -1),
        description=bv.get("description"),
    )
    return rule


def _adapt_ec2(by_type, st: S.AWSState):
    groups: list[tuple[BlockVal, S.SecurityGroup]] = []
    for bv in by_type.get("aws_security_group", []):
        sg = S.SecurityGroup(resource=bv)
        sg.name = bv.get("name")
        sg.description = bv.get("description")
        for ing in bv.blocks("ingress"):
            sg.rules.append(_sg_rule(ing, "ingress"))
        for eg in bv.blocks("egress"):
            sg.rules.append(_sg_rule(eg, "egress"))
        groups.append((bv, sg))
        st.security_groups.append(sg)
    for bv in by_type.get("aws_security_group_rule", []):
        rtype = bv.get("type", "ingress").str() or "ingress"
        rule = _sg_rule(bv, "ingress" if rtype == "ingress" else "egress")
        parent = _target_block(bv.get("security_group_id"), groups, "name")
        placed = False
        for pbv, sg in groups:
            if pbv is parent:
                sg.rules.append(rule)
                placed = True
        if not placed:
            anon = S.SecurityGroup(resource=bv, rules=[rule])
            st.security_groups.append(anon)
    for tf_type, rtype in (
        ("aws_vpc_security_group_ingress_rule", "ingress"),
        ("aws_vpc_security_group_egress_rule", "egress"),
    ):
        for bv in by_type.get(tf_type, []):
            rule = _sg_rule(bv, rtype, cidr_attrs=("cidr_ipv4", "cidr_ipv6"))
            parent = _target_block(bv.get("security_group_id"), groups, "name")
            placed = False
            for pbv, sg in groups:
                if pbv is parent:
                    sg.rules.append(rule)
                    placed = True
            if not placed:
                st.security_groups.append(S.SecurityGroup(resource=bv, rules=[rule]))

    for bv in by_type.get("aws_instance", []):
        inst = S.Instance(resource=bv)
        mo = bv.block("metadata_options")
        if mo is not None:
            inst.http_tokens = mo.get("http_tokens", "optional")
            inst.http_endpoint = mo.get("http_endpoint", "enabled")
        else:
            inst.http_tokens = default_val("optional", bv)
            inst.http_endpoint = default_val("enabled", bv)
        inst.associate_public_ip = bv.get("associate_public_ip_address", False)
        inst.user_data = bv.get("user_data")
        root = bv.block("root_block_device")
        if root is not None:
            inst.root_device = S.EBSBlockDevice(
                resource=root, encrypted=root.get("encrypted", False)
            )
        else:
            inst.root_device = S.EBSBlockDevice(
                resource=bv, encrypted=default_val(False, bv)
            )
        for ebd in bv.blocks("ebs_block_device"):
            inst.ebs_devices.append(
                S.EBSBlockDevice(resource=ebd, encrypted=ebd.get("encrypted", False))
            )
        st.instances.append(inst)

    for bv in by_type.get("aws_launch_template", []):
        inst = S.Instance(resource=bv)
        mo = bv.block("metadata_options")
        if mo is not None:
            inst.http_tokens = mo.get("http_tokens", "optional")
        else:
            inst.http_tokens = default_val("optional", bv)
        st.instances.append(inst)

    for bv in by_type.get("aws_ebs_volume", []):
        st.volumes.append(
            S.Volume(
                resource=bv,
                encrypted=bv.get("encrypted", False),
                kms_key_id=bv.get("kms_key_id"),
            )
        )


# -- RDS ---------------------------------------------------------------------

def _adapt_rds(by_type, st: S.AWSState):
    for bv in by_type.get("aws_db_instance", []):
        st.rds_instances.append(
            S.RDSInstance(
                resource=bv,
                storage_encrypted=bv.get("storage_encrypted", False),
                iam_auth=bv.get("iam_database_authentication_enabled", False),
                publicly_accessible=bv.get("publicly_accessible", False),
                backup_retention=bv.get("backup_retention_period", 0),
                performance_insights=bv.get("performance_insights_enabled", False),
                performance_insights_kms=bv.get("performance_insights_kms_key_id"),
                deletion_protection=bv.get("deletion_protection", False),
            )
        )


# -- CloudTrail --------------------------------------------------------------

def _adapt_cloudtrail(by_type, st: S.AWSState):
    for bv in by_type.get("aws_cloudtrail", []):
        st.cloudtrails.append(
            S.CloudTrail(
                resource=bv,
                multi_region=bv.get("is_multi_region_trail", False),
                log_validation=bv.get("enable_log_file_validation", False),
                kms_key_id=bv.get("kms_key_id"),
                cloudwatch_logs_arn=bv.get("cloud_watch_logs_group_arn"),
            )
        )


# -- IAM ---------------------------------------------------------------------

def _parse_policy(val: Val) -> Val:
    v = val.value
    if isinstance(v, str):
        try:
            return val.with_value(json.loads(v))
        except Exception:
            return val.with_value(None)
    return val


def _adapt_iam(by_type, st: S.AWSState):
    for bv in by_type.get("aws_iam_account_password_policy", []):
        st.password_policies.append(
            S.PasswordPolicy(
                resource=bv,
                minimum_length=bv.get("minimum_password_length", 6),
                reuse_prevention=bv.get("password_reuse_prevention", 0),
                max_age=bv.get("max_password_age", 0),
                require_symbols=bv.get("require_symbols", False),
                require_numbers=bv.get("require_numbers", False),
            )
        )
    for t in ("aws_iam_policy", "aws_iam_role_policy", "aws_iam_user_policy",
              "aws_iam_group_policy"):
        for bv in by_type.get(t, []):
            st.iam_policies.append(
                S.IAMPolicy(
                    resource=bv,
                    name=bv.get("name"),
                    document=_parse_policy(bv.get("policy")),
                )
            )


# -- EKS ---------------------------------------------------------------------

def _adapt_eks(by_type, st: S.AWSState):
    for bv in by_type.get("aws_eks_cluster", []):
        c = S.EKSCluster(resource=bv)
        c.log_types = bv.get("enabled_cluster_log_types", [])
        enc = bv.block("encryption_config")
        if enc is not None:
            res = enc.get("resources")
            c.secrets_encrypted = res.with_value(
                "secrets" in (res.value if isinstance(res.value, list) else [])
            )
        else:
            c.secrets_encrypted = default_val(False, bv)
        vpc = bv.block("vpc_config")
        if vpc is not None:
            c.public_access = vpc.get("endpoint_public_access", True)
            c.public_access_cidrs = vpc.get("public_access_cidrs", ["0.0.0.0/0"])
        else:
            c.public_access = default_val(True, bv)
            c.public_access_cidrs = default_val(["0.0.0.0/0"], bv)
        st.eks_clusters.append(c)


# -- assorted single-resource services ---------------------------------------

def _adapt_misc(by_type, st: S.AWSState):
    for bv in by_type.get("aws_kms_key", []):
        st.kms_keys.append(
            S.KMSKey(
                resource=bv,
                rotation_enabled=bv.get("enable_key_rotation", False),
                usage=bv.get("key_usage", "ENCRYPT_DECRYPT"),
            )
        )
    for bv in by_type.get("aws_sns_topic", []):
        st.sns_topics.append(
            S.SNSTopic(resource=bv, kms_key_id=bv.get("kms_master_key_id"))
        )
    queues: list[tuple[BlockVal, S.SQSQueue]] = []
    for bv in by_type.get("aws_sqs_queue", []):
        q = S.SQSQueue(
            resource=bv,
            managed_sse=bv.get("sqs_managed_sse_enabled", False),
            kms_key_id=bv.get("kms_master_key_id"),
            policy_document=_parse_policy(bv.get("policy")),
        )
        queues.append((bv, q))
        st.sqs_queues.append(q)
    for bv in by_type.get("aws_sqs_queue_policy", []):
        parent = _target_block(bv.get("queue_url"), queues, "name")
        doc = _parse_policy(bv.get("policy"))
        for pbv, q in queues:
            if pbv is parent:
                q.policy_document = doc
        if parent is None and queues and len(queues) == 1:
            queues[0][1].policy_document = doc
    for t in ("aws_lb", "aws_alb"):
        for bv in by_type.get(t, []):
            st.load_balancers.append(
                S.LoadBalancer(
                    resource=bv,
                    internal=bv.get("internal", False),
                    drop_invalid_headers=bv.get("drop_invalid_header_fields", False),
                    type=bv.get("load_balancer_type", "application"),
                )
            )
    for t in ("aws_lb_listener", "aws_alb_listener"):
        for bv in by_type.get(t, []):
            st.lb_listeners.append(
                S.LBListener(
                    resource=bv,
                    protocol=bv.get("protocol", "HTTP"),
                    ssl_policy=bv.get("ssl_policy"),
                )
            )
    for bv in by_type.get("aws_ecr_repository", []):
        r = S.ECRRepository(resource=bv)
        isc = bv.block("image_scanning_configuration")
        r.scan_on_push = (
            isc.get("scan_on_push", False) if isc is not None else default_val(False, bv)
        )
        mut = bv.get("image_tag_mutability", "MUTABLE")
        r.immutable_tags = mut.with_value(mut.str() == "IMMUTABLE")
        enc = bv.block("encryption_configuration")
        if enc is not None:
            et = enc.get("encryption_type", "AES256")
            r.encrypted_kms = et.with_value(et.str() == "KMS")
        else:
            r.encrypted_kms = default_val(False, bv)
        st.ecr_repositories.append(r)
    for bv in by_type.get("aws_efs_file_system", []):
        st.efs_filesystems.append(
            S.EFSFileSystem(resource=bv, encrypted=bv.get("encrypted", False))
        )
    for bv in by_type.get("aws_elasticache_replication_group", []):
        st.elasticache_groups.append(
            S.ElastiCacheGroup(
                resource=bv,
                transit_encryption=bv.get("transit_encryption_enabled", False),
                at_rest_encryption=bv.get("at_rest_encryption_enabled", False),
            )
        )
    for bv in by_type.get("aws_redshift_cluster", []):
        st.redshift_clusters.append(
            S.RedshiftCluster(
                resource=bv,
                encrypted=bv.get("encrypted", False),
                publicly_accessible=bv.get("publicly_accessible", True),
            )
        )
    for bv in by_type.get("aws_dynamodb_table", []):
        t = S.DynamoDBTable(resource=bv)
        pitr = bv.block("point_in_time_recovery")
        t.point_in_time_recovery = (
            pitr.get("enabled", False) if pitr is not None else default_val(False, bv)
        )
        sse = bv.block("server_side_encryption")
        t.sse_enabled = (
            sse.get("enabled", False) if sse is not None else default_val(False, bv)
        )
        st.dynamodb_tables.append(t)
    for bv in by_type.get("aws_cloudfront_distribution", []):
        d = S.CloudFrontDistribution(resource=bv)
        dcb = bv.block("default_cache_behavior")
        if dcb is not None:
            d.viewer_protocol_policy = dcb.get("viewer_protocol_policy", "allow-all")
        else:
            d.viewer_protocol_policy = default_val("allow-all", bv)
        vc = bv.block("viewer_certificate")
        if vc is not None:
            d.minimum_protocol_version = vc.get("minimum_protocol_version", "TLSv1")
        else:
            d.minimum_protocol_version = default_val("TLSv1", bv)
        d.waf_id = bv.get("web_acl_id")
        st.cloudfront_distributions.append(d)
    for bv in by_type.get("aws_lambda_function", []):
        f = S.LambdaFunction(resource=bv)
        tc = bv.block("tracing_config")
        f.tracing_mode = (
            tc.get("mode", "PassThrough") if tc is not None
            else default_val("PassThrough", bv)
        )
        st.lambda_functions.append(f)


def _adapt_breadth(by_type, st: S.AWSState):
    """Round-4 service breadth: api gateway, athena, codebuild, docdb, ecs,
    elasticsearch/opensearch, kinesis, mq, msk, neptune, workspaces, launch
    templates (ref: pkg/iac/adapters/terraform/aws/* per service)."""
    for rtype in ("aws_api_gateway_stage", "aws_apigatewayv2_stage"):
        for bv in by_type.get(rtype, []):
            stg = S.APIGatewayStage(resource=bv)
            stg.name = bv.get("stage_name", bv.get("name").value)
            al = bv.block("access_log_settings")
            stg.access_logging = (
                default_val(True, al) if al is not None else default_val(False, bv)
            )
            stg.xray_tracing = bv.get("xray_tracing_enabled", False)
            st.api_gateway_stages.append(stg)

    for bv in by_type.get("aws_athena_workgroup", []):
        wg = S.AthenaWorkgroup(resource=bv)
        cfg = bv.block("configuration")
        wg.enforce_configuration = (
            cfg.get("enforce_workgroup_configuration", True)
            if cfg is not None
            else default_val(True, bv)
        )
        enc = None
        if cfg is not None:
            rc = cfg.block("result_configuration")
            if rc is not None:
                enc = rc.block("encryption_configuration")
        wg.encryption_enabled = (
            default_val(True, enc) if enc is not None else default_val(False, bv)
        )
        st.athena_workgroups.append(wg)

    for bv in by_type.get("aws_codebuild_project", []):
        p = S.CodeBuildProject(resource=bv)
        for art in bv.blocks("artifacts") + bv.blocks("secondary_artifacts"):
            v = art.get("encryption_disabled", False)
            if v.bool():
                p.artifact_encryption_disabled.append(v)
        st.codebuild_projects.append(p)

    for bv in by_type.get("aws_docdb_cluster", []):
        c = S.DocDBCluster(resource=bv)
        c.storage_encrypted = bv.get("storage_encrypted", False)
        c.kms_key_id = bv.get("kms_key_id")
        exp = bv.get("enabled_cloudwatch_logs_exports")
        if isinstance(exp.value, list):
            c.log_exports = [exp.with_value(x) for x in exp.value]
        st.docdb_clusters.append(c)

    for bv in by_type.get("aws_ecs_task_definition", []):
        td = S.ECSTaskDefinition(resource=bv)
        cd = bv.get("container_definitions")
        if isinstance(cd.value, str):
            try:
                td.container_definitions = cd.with_value(json.loads(cd.value))
            except ValueError:
                td.container_definitions = cd
        else:
            td.container_definitions = cd
        st.ecs_task_definitions.append(td)

    for bv in by_type.get("aws_ecs_cluster", []):
        c = S.ECSCluster(resource=bv)
        c.container_insights = default_val(False, bv)
        for s_bv in bv.blocks("setting"):
            if s_bv.get("name").str() == "containerInsights":
                val = s_bv.get("value")
                c.container_insights = val.with_value(
                    val.str() in ("enabled", "enhanced")
                )
        st.ecs_clusters.append(c)

    for rtype in ("aws_elasticsearch_domain", "aws_opensearch_domain"):
        for bv in by_type.get(rtype, []):
            d = S.ESDomain(resource=bv)
            ear = bv.block("encrypt_at_rest")
            d.encrypt_at_rest = (
                ear.get("enabled", False) if ear is not None
                else default_val(False, bv)
            )
            n2n = bv.block("node_to_node_encryption")
            d.node_to_node_encryption = (
                n2n.get("enabled", False) if n2n is not None
                else default_val(False, bv)
            )
            dep = bv.block("domain_endpoint_options")
            if dep is not None:
                d.enforce_https = dep.get("enforce_https", False)
                d.tls_policy = dep.get("tls_security_policy", "Policy-Min-TLS-1-0-2019-07")
            else:
                d.enforce_https = default_val(False, bv)
                d.tls_policy = default_val("Policy-Min-TLS-1-0-2019-07", bv)
            d.audit_logging = default_val(False, bv)
            for lp in bv.blocks("log_publishing_options"):
                if lp.get("log_type").str() == "AUDIT_LOGS":
                    d.audit_logging = lp.get("enabled", True)
            st.elasticsearch_domains.append(d)

    for bv in by_type.get("aws_kinesis_stream", []):
        k = S.KinesisStream(resource=bv)
        k.encryption_type = bv.get("encryption_type", "NONE")
        k.kms_key_id = bv.get("kms_key_id")
        st.kinesis_streams.append(k)

    for bv in by_type.get("aws_mq_broker", []):
        b = S.MQBroker(resource=bv)
        b.publicly_accessible = bv.get("publicly_accessible", False)
        logs = bv.block("logs")
        if logs is not None:
            b.general_logging = logs.get("general", False)
            b.audit_logging = logs.get("audit", False)
        else:
            b.general_logging = default_val(False, bv)
            b.audit_logging = default_val(False, bv)
        st.mq_brokers.append(b)

    for bv in by_type.get("aws_msk_cluster", []):
        c = S.MSKCluster(resource=bv)
        c.client_broker_encryption = default_val("TLS_PLAINTEXT", bv)
        enc = bv.block("encryption_info")
        if enc is not None:
            tr = enc.block("encryption_in_transit")
            if tr is not None:
                c.client_broker_encryption = tr.get("client_broker", "TLS")
        c.logging_enabled = default_val(False, bv)
        li = bv.block("logging_info")
        if li is not None:
            bl = li.block("broker_logs")
            if bl is not None:
                for kind in ("cloudwatch_logs", "firehose", "s3"):
                    kb = bl.block(kind)
                    if kb is not None and kb.get("enabled", False).bool():
                        c.logging_enabled = kb.get("enabled")
        st.msk_clusters.append(c)

    for bv in by_type.get("aws_neptune_cluster", []):
        n = S.NeptuneCluster(resource=bv)
        n.storage_encrypted = bv.get("storage_encrypted", False)
        n.kms_key_id = bv.get("kms_key_arn")
        exp = bv.get("enable_cloudwatch_logs_exports")
        if isinstance(exp.value, list):
            n.log_exports = [exp.with_value(x) for x in exp.value]
        st.neptune_clusters.append(n)

    for bv in by_type.get("aws_workspaces_workspace", []):
        w = S.Workspace(resource=bv)
        w.root_volume_encrypted = bv.get("root_volume_encryption_enabled", False)
        w.user_volume_encrypted = bv.get("user_volume_encryption_enabled", False)
        st.aws_workspaces.append(w)

    # launch templates and the legacy launch configurations share the
    # metadata_options surface
    for rtype in ("aws_launch_template",):
        for bv in by_type.get(rtype, []):
            st.launch_templates.append(_adapt_launch_metadata(bv))


def _adapt_launch_metadata(bv) -> S.LaunchTemplate:
    lt = S.LaunchTemplate(resource=bv)
    mo = bv.block("metadata_options")
    lt.http_tokens = (
        mo.get("http_tokens", "optional") if mo is not None
        else default_val("optional", bv)
    )
    return lt


def _adapt_breadth2(by_type, st: S.AWSState):
    """Second breadth wave: log groups, api gateway domains, rds clusters,
    secretsmanager, launch configurations, dax, ebs default encryption."""
    for bv in by_type.get("aws_cloudwatch_log_group", []):
        lg = S.LogGroup(resource=bv)
        lg.kms_key_id = bv.get("kms_key_id")
        lg.retention_days = bv.get("retention_in_days", 0)
        st.log_groups.append(lg)

    for bv in by_type.get("aws_api_gateway_domain_name", []):
        d = S.APIGatewayDomain(resource=bv)
        d.security_policy = bv.get("security_policy", "TLS_1_0")
        st.api_gateway_domains.append(d)

    for bv in by_type.get("aws_rds_cluster", []):
        c = S.RDSCluster(resource=bv)
        c.storage_encrypted = bv.get("storage_encrypted", False)
        c.backup_retention = bv.get("backup_retention_period", 1)
        st.rds_clusters.append(c)

    for bv in by_type.get("aws_secretsmanager_secret", []):
        sec = S.SecretsManagerSecret(resource=bv)
        sec.kms_key_id = bv.get("kms_key_id")
        st.secretsmanager_secrets.append(sec)

    for bv in by_type.get("aws_launch_configuration", []):
        st.launch_templates.append(_adapt_launch_metadata(bv))

    for bv in by_type.get("aws_dax_cluster", []):
        d = S.DAXCluster(resource=bv)
        sse = bv.block("server_side_encryption")
        d.sse_enabled = (
            sse.get("enabled", False) if sse is not None
            else default_val(False, bv)
        )
        st.dax_clusters.append(d)

    for bv in by_type.get("aws_ebs_encryption_by_default", []):
        st.ebs_default_encryption.append(
            S.EBSDefaultEncryption(resource=bv, enabled=bv.get("enabled", True))
        )
