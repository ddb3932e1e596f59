"""CloudFormation → AWS state adapter
(ref: pkg/iac/adapters/cloudformation/aws — independent lean equivalent).

Input resources come from ``misconf.cloudformation.load``: BlockVal with
``type`` = CFN resource type and children mirroring property nesting.

The port of ``trivy_tpu/misconf/adapters/aws_cfn.py``.
"""

from __future__ import annotations

import json

from trivy_tpu_torch.misconf.adapters import aws_state as S
from trivy_tpu_torch.misconf.state import BlockVal, Val, default_val


def adapt(resources: list[BlockVal]) -> S.AWSState:
    st = S.AWSState()
    by_type: dict[str, list[BlockVal]] = {}
    for r in resources:
        by_type.setdefault(r.type, []).append(r)

    for bv in by_type.get("AWS::S3::Bucket", []):
        b = S.S3Bucket(resource=bv)
        b.name = bv.get("BucketName")
        acl = bv.get("AccessControl", "Private")
        b.acl = acl.with_value(_dehump(acl.str("Private")))
        ver = bv.block("VersioningConfiguration")
        if ver is not None:
            status = ver.get("Status")
            b.versioning_enabled = status.with_value(status.str() == "Enabled")
        enc = bv.block("BucketEncryption")
        if enc is not None:
            rules = list(enc.walk_blocks("ServerSideEncryptionByDefault"))
            b.encryption_enabled = default_val(bool(rules), enc)
            for r in rules:
                if r.get("KMSMasterKeyID").is_set():
                    b.kms_key_id = r.get("KMSMasterKeyID")
        log = bv.block("LoggingConfiguration")
        if log is not None:
            b.logging_enabled = default_val(True, log)
        pab = bv.block("PublicAccessBlockConfiguration")
        if pab is not None:
            b.public_access_block = S.PublicAccessBlock(
                resource=pab,
                block_public_acls=pab.get("BlockPublicAcls", False),
                block_public_policy=pab.get("BlockPublicPolicy", False),
                ignore_public_acls=pab.get("IgnorePublicAcls", False),
                restrict_public_buckets=pab.get("RestrictPublicBuckets", False),
            )
        st.s3_buckets.append(b)

    for bv in by_type.get("AWS::EC2::SecurityGroup", []):
        sg = S.SecurityGroup(resource=bv)
        sg.name = bv.get("GroupName")
        sg.description = bv.get("GroupDescription")
        for ing in bv.blocks("SecurityGroupIngress"):
            sg.rules.append(_cfn_rule(ing, "ingress"))
        for eg in bv.blocks("SecurityGroupEgress"):
            sg.rules.append(_cfn_rule(eg, "egress"))
        st.security_groups.append(sg)
    for bv in by_type.get("AWS::EC2::SecurityGroupIngress", []):
        st.security_groups.append(
            S.SecurityGroup(resource=bv, rules=[_cfn_rule(bv, "ingress")])
        )
    for bv in by_type.get("AWS::EC2::SecurityGroupEgress", []):
        st.security_groups.append(
            S.SecurityGroup(resource=bv, rules=[_cfn_rule(bv, "egress")])
        )

    for bv in by_type.get("AWS::EC2::Instance", []):
        inst = S.Instance(resource=bv)
        mo = bv.block("MetadataOptions")
        if mo is not None:
            inst.http_tokens = mo.get("HttpTokens", "optional")
            inst.http_endpoint = mo.get("HttpEndpoint", "enabled")
        else:
            inst.http_tokens = default_val("optional", bv)
            inst.http_endpoint = default_val("enabled", bv)
        for bdm in bv.blocks("BlockDeviceMappings"):
            ebs = bdm.block("Ebs")
            if ebs is not None:
                inst.ebs_devices.append(
                    S.EBSBlockDevice(resource=ebs, encrypted=ebs.get("Encrypted", False))
                )
        inst.root_device = (
            inst.ebs_devices[0] if inst.ebs_devices
            else S.EBSBlockDevice(resource=bv, encrypted=default_val(False, bv))
        )
        st.instances.append(inst)

    for bv in by_type.get("AWS::EC2::Volume", []):
        st.volumes.append(
            S.Volume(
                resource=bv,
                encrypted=bv.get("Encrypted", False),
                kms_key_id=bv.get("KmsKeyId"),
            )
        )

    for bv in by_type.get("AWS::RDS::DBInstance", []):
        st.rds_instances.append(
            S.RDSInstance(
                resource=bv,
                storage_encrypted=bv.get("StorageEncrypted", False),
                publicly_accessible=bv.get("PubliclyAccessible", False),
                backup_retention=bv.get("BackupRetentionPeriod", 1),
                performance_insights=bv.get("EnablePerformanceInsights", False),
                performance_insights_kms=bv.get("PerformanceInsightsKMSKeyId"),
                deletion_protection=bv.get("DeletionProtection", False),
            )
        )

    for bv in by_type.get("AWS::CloudTrail::Trail", []):
        st.cloudtrails.append(
            S.CloudTrail(
                resource=bv,
                multi_region=bv.get("IsMultiRegionTrail", False),
                log_validation=bv.get("EnableLogFileValidation", False),
                kms_key_id=bv.get("KMSKeyId"),
                cloudwatch_logs_arn=bv.get("CloudWatchLogsLogGroupArn"),
            )
        )

    for t in ("AWS::IAM::Policy", "AWS::IAM::ManagedPolicy"):
        for bv in by_type.get(t, []):
            doc = bv.get("PolicyDocument")
            pd = bv.block("PolicyDocument")
            if pd is not None:
                doc = Val(_block_to_plain(pd), pd.file, pd.line, pd.end_line)
            st.iam_policies.append(
                S.IAMPolicy(resource=bv, name=bv.get("PolicyName"), document=doc)
            )

    for bv in by_type.get("AWS::EKS::Cluster", []):
        c = S.EKSCluster(resource=bv)
        logging = bv.block("Logging")
        types: list[str] = []
        if logging is not None:
            for cl in logging.walk_blocks("EnabledTypes"):
                tv = cl.get("Type")
                if tv.is_set():
                    types.append(tv.str())
        c.log_types = default_val(types, logging or bv)
        enc = bv.blocks("EncryptionConfig")
        secrets = False
        for e in enc:
            res = e.get("Resources")
            if "secrets" in (res.value if isinstance(res.value, list) else []):
                secrets = True
        c.secrets_encrypted = default_val(secrets, enc[0] if enc else bv)
        vpc = bv.block("ResourcesVpcConfig")
        if vpc is not None:
            c.public_access = vpc.get("EndpointPublicAccess", True)
            c.public_access_cidrs = vpc.get("PublicAccessCidrs", ["0.0.0.0/0"])
        else:
            c.public_access = default_val(True, bv)
            c.public_access_cidrs = default_val(["0.0.0.0/0"], bv)
        st.eks_clusters.append(c)

    for bv in by_type.get("AWS::KMS::Key", []):
        st.kms_keys.append(
            S.KMSKey(
                resource=bv,
                rotation_enabled=bv.get("EnableKeyRotation", False),
                usage=bv.get("KeyUsage", "ENCRYPT_DECRYPT"),
            )
        )
    for bv in by_type.get("AWS::SNS::Topic", []):
        st.sns_topics.append(
            S.SNSTopic(resource=bv, kms_key_id=bv.get("KmsMasterKeyId"))
        )
    for bv in by_type.get("AWS::SQS::Queue", []):
        st.sqs_queues.append(
            S.SQSQueue(
                resource=bv,
                managed_sse=bv.get("SqsManagedSseEnabled", False),
                kms_key_id=bv.get("KmsMasterKeyId"),
            )
        )
    for bv in by_type.get("AWS::SQS::QueuePolicy", []):
        pd = bv.block("PolicyDocument")
        if pd is not None and st.sqs_queues:
            st.sqs_queues[0].policy_document = Val(
                _block_to_plain(pd), pd.file, pd.line, pd.end_line
            )

    for bv in by_type.get("AWS::ElasticLoadBalancingV2::LoadBalancer", []):
        scheme = bv.get("Scheme", "internet-facing")
        drop = default_val(False, bv)
        for attr in bv.blocks("LoadBalancerAttributes"):
            if attr.get("Key").str() == "routing.http.drop_invalid_header_fields.enabled":
                v = attr.get("Value")
                drop = v.with_value(v.str() == "true")
        st.load_balancers.append(
            S.LoadBalancer(
                resource=bv,
                internal=scheme.with_value(scheme.str() == "internal"),
                drop_invalid_headers=drop,
                type=bv.get("Type", "application"),
            )
        )
    for bv in by_type.get("AWS::ElasticLoadBalancingV2::Listener", []):
        st.lb_listeners.append(
            S.LBListener(
                resource=bv,
                protocol=bv.get("Protocol", "HTTP"),
                ssl_policy=bv.get("SslPolicy"),
            )
        )

    for bv in by_type.get("AWS::ECR::Repository", []):
        r = S.ECRRepository(resource=bv)
        isc = bv.block("ImageScanningConfiguration")
        r.scan_on_push = (
            isc.get("ScanOnPush", False) if isc is not None else default_val(False, bv)
        )
        mut = bv.get("ImageTagMutability", "MUTABLE")
        r.immutable_tags = mut.with_value(mut.str() == "IMMUTABLE")
        enc = bv.block("EncryptionConfiguration")
        if enc is not None:
            et = enc.get("EncryptionType", "AES256")
            r.encrypted_kms = et.with_value(et.str() == "KMS")
        else:
            r.encrypted_kms = default_val(False, bv)
        st.ecr_repositories.append(r)

    for bv in by_type.get("AWS::EFS::FileSystem", []):
        st.efs_filesystems.append(
            S.EFSFileSystem(resource=bv, encrypted=bv.get("Encrypted", False))
        )
    for bv in by_type.get("AWS::ElastiCache::ReplicationGroup", []):
        st.elasticache_groups.append(
            S.ElastiCacheGroup(
                resource=bv,
                transit_encryption=bv.get("TransitEncryptionEnabled", False),
                at_rest_encryption=bv.get("AtRestEncryptionEnabled", False),
            )
        )
    for bv in by_type.get("AWS::Redshift::Cluster", []):
        st.redshift_clusters.append(
            S.RedshiftCluster(
                resource=bv,
                encrypted=bv.get("Encrypted", False),
                publicly_accessible=bv.get("PubliclyAccessible", True),
            )
        )
    for bv in by_type.get("AWS::DynamoDB::Table", []):
        t = S.DynamoDBTable(resource=bv)
        pitr = bv.block("PointInTimeRecoverySpecification")
        t.point_in_time_recovery = (
            pitr.get("PointInTimeRecoveryEnabled", False)
            if pitr is not None else default_val(False, bv)
        )
        sse = bv.block("SSESpecification")
        t.sse_enabled = (
            sse.get("SSEEnabled", False) if sse is not None
            else default_val(False, bv)
        )
        st.dynamodb_tables.append(t)

    for bv in by_type.get("AWS::CloudFront::Distribution", []):
        d = S.CloudFrontDistribution(resource=bv)
        cfg = bv.block("DistributionConfig") or bv
        dcb = cfg.block("DefaultCacheBehavior")
        if dcb is not None:
            d.viewer_protocol_policy = dcb.get("ViewerProtocolPolicy", "allow-all")
        else:
            d.viewer_protocol_policy = default_val("allow-all", bv)
        vc = cfg.block("ViewerCertificate")
        if vc is not None:
            d.minimum_protocol_version = vc.get("MinimumProtocolVersion", "TLSv1")
        else:
            d.minimum_protocol_version = default_val("TLSv1", bv)
        d.waf_id = cfg.get("WebACLId")
        st.cloudfront_distributions.append(d)

    for bv in by_type.get("AWS::Lambda::Function", []):
        f = S.LambdaFunction(resource=bv)
        tc = bv.block("TracingConfig")
        f.tracing_mode = (
            tc.get("Mode", "PassThrough") if tc is not None
            else default_val("PassThrough", bv)
        )
        st.lambda_functions.append(f)

    return st


def _cfn_rule(bv: BlockVal, rtype: str) -> S.SGRule:
    cidrs = []
    cval = None
    for a in ("CidrIp", "CidrIpv6"):
        v = bv.get(a)
        if v.is_set():
            cval = v
            cidrs.append(v.str())
    return S.SGRule(
        resource=bv,
        type=rtype,
        cidrs=(cval.with_value(cidrs) if cval else default_val(cidrs, bv)),
        from_port=bv.get("FromPort", -1),
        to_port=bv.get("ToPort", -1),
        description=bv.get("Description"),
    )


def _dehump(acl: str) -> str:
    """CFN AccessControl (PublicRead) → canned-ACL form (public-read)."""
    out = []
    for i, c in enumerate(acl):
        if c.isupper() and i:
            out.append("-")
        out.append(c.lower())
    return "".join(out)


def _block_to_plain(bv: BlockVal):
    out: dict = {k: v.value for k, v in bv.attrs.items()}
    for c in bv.children:
        child = _block_to_plain(c)
        if c.type in out and isinstance(out[c.type], list):
            out[c.type].append(child)
        elif c.type in out:
            out[c.type] = [out[c.type], child]
        else:
            out[c.type] = child
    return out


def _json_maybe(v):
    if isinstance(v, str):
        try:
            return json.loads(v)
        except Exception:
            return None
    return v
