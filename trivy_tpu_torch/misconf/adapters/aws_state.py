"""Typed AWS provider state consumed by the cloud checks
(ref: pkg/iac/providers/aws — independent lean equivalent; every leaf is a
tracked :class:`Val` so failures carry line causes).

The port of ``trivy_tpu/misconf/adapters/aws_state.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from trivy_tpu_torch.misconf.state import BlockVal, Val


@dataclass
class Res:
    """Common base: the defining block, for naming + fallback cause."""

    resource: BlockVal = field(default_factory=BlockVal)

    @property
    def address(self) -> str:
        labels = ".".join(self.resource.labels)
        return f"{self.resource.type}.{labels}" if labels else self.resource.type

    def anchor(self) -> Val:
        return Val(None, self.resource.file, self.resource.line, self.resource.line)


def _v(value=None) -> Val:
    return Val(value, explicit=False)


@dataclass
class PublicAccessBlock(Res):
    block_public_acls: Val = field(default_factory=_v)
    block_public_policy: Val = field(default_factory=_v)
    ignore_public_acls: Val = field(default_factory=_v)
    restrict_public_buckets: Val = field(default_factory=_v)


@dataclass
class S3Bucket(Res):
    name: Val = field(default_factory=_v)
    acl: Val = field(default_factory=_v)
    versioning_enabled: Val = field(default_factory=_v)
    encryption_enabled: Val = field(default_factory=_v)
    kms_key_id: Val = field(default_factory=_v)
    logging_enabled: Val = field(default_factory=_v)
    public_access_block: PublicAccessBlock | None = None


@dataclass
class SGRule(Res):
    type: str = "ingress"  # ingress | egress
    cidrs: Val = field(default_factory=_v)  # list[str]
    from_port: Val = field(default_factory=_v)
    to_port: Val = field(default_factory=_v)
    description: Val = field(default_factory=_v)


@dataclass
class SecurityGroup(Res):
    name: Val = field(default_factory=_v)
    description: Val = field(default_factory=_v)
    rules: list[SGRule] = field(default_factory=list)


@dataclass
class EBSBlockDevice(Res):
    encrypted: Val = field(default_factory=_v)


@dataclass
class Instance(Res):
    http_tokens: Val = field(default_factory=_v)  # metadata options
    http_endpoint: Val = field(default_factory=_v)
    associate_public_ip: Val = field(default_factory=_v)
    root_device: EBSBlockDevice | None = None
    ebs_devices: list[EBSBlockDevice] = field(default_factory=list)
    user_data: Val = field(default_factory=_v)


@dataclass
class Volume(Res):
    encrypted: Val = field(default_factory=_v)
    kms_key_id: Val = field(default_factory=_v)


@dataclass
class RDSInstance(Res):
    storage_encrypted: Val = field(default_factory=_v)
    iam_auth: Val = field(default_factory=_v)
    publicly_accessible: Val = field(default_factory=_v)
    backup_retention: Val = field(default_factory=_v)
    performance_insights: Val = field(default_factory=_v)
    performance_insights_kms: Val = field(default_factory=_v)
    deletion_protection: Val = field(default_factory=_v)


@dataclass
class CloudTrail(Res):
    multi_region: Val = field(default_factory=_v)
    log_validation: Val = field(default_factory=_v)
    kms_key_id: Val = field(default_factory=_v)
    cloudwatch_logs_arn: Val = field(default_factory=_v)


@dataclass
class PasswordPolicy(Res):
    minimum_length: Val = field(default_factory=_v)
    reuse_prevention: Val = field(default_factory=_v)
    max_age: Val = field(default_factory=_v)
    require_symbols: Val = field(default_factory=_v)
    require_numbers: Val = field(default_factory=_v)


@dataclass
class IAMPolicy(Res):
    name: Val = field(default_factory=_v)
    document: Val = field(default_factory=_v)  # parsed dict or JSON string


@dataclass
class EKSCluster(Res):
    log_types: Val = field(default_factory=_v)
    secrets_encrypted: Val = field(default_factory=_v)
    public_access: Val = field(default_factory=_v)
    public_access_cidrs: Val = field(default_factory=_v)


@dataclass
class KMSKey(Res):
    rotation_enabled: Val = field(default_factory=_v)
    usage: Val = field(default_factory=_v)


@dataclass
class SNSTopic(Res):
    kms_key_id: Val = field(default_factory=_v)


@dataclass
class SQSQueue(Res):
    managed_sse: Val = field(default_factory=_v)
    kms_key_id: Val = field(default_factory=_v)
    policy_document: Val = field(default_factory=_v)


@dataclass
class LoadBalancer(Res):
    internal: Val = field(default_factory=_v)
    drop_invalid_headers: Val = field(default_factory=_v)
    type: Val = field(default_factory=_v)


@dataclass
class LBListener(Res):
    protocol: Val = field(default_factory=_v)
    ssl_policy: Val = field(default_factory=_v)


@dataclass
class ECRRepository(Res):
    scan_on_push: Val = field(default_factory=_v)
    immutable_tags: Val = field(default_factory=_v)
    encrypted_kms: Val = field(default_factory=_v)


@dataclass
class EFSFileSystem(Res):
    encrypted: Val = field(default_factory=_v)


@dataclass
class ElastiCacheGroup(Res):
    transit_encryption: Val = field(default_factory=_v)
    at_rest_encryption: Val = field(default_factory=_v)


@dataclass
class RedshiftCluster(Res):
    encrypted: Val = field(default_factory=_v)
    publicly_accessible: Val = field(default_factory=_v)


@dataclass
class DynamoDBTable(Res):
    point_in_time_recovery: Val = field(default_factory=_v)
    sse_enabled: Val = field(default_factory=_v)


@dataclass
class CloudFrontDistribution(Res):
    viewer_protocol_policy: Val = field(default_factory=_v)
    minimum_protocol_version: Val = field(default_factory=_v)
    waf_id: Val = field(default_factory=_v)


@dataclass
class LambdaFunction(Res):
    tracing_mode: Val = field(default_factory=_v)


@dataclass
class AWSState:
    provider = "aws"

    s3_buckets: list[S3Bucket] = field(default_factory=list)
    security_groups: list[SecurityGroup] = field(default_factory=list)
    instances: list[Instance] = field(default_factory=list)
    volumes: list[Volume] = field(default_factory=list)
    rds_instances: list[RDSInstance] = field(default_factory=list)
    cloudtrails: list[CloudTrail] = field(default_factory=list)
    password_policies: list[PasswordPolicy] = field(default_factory=list)
    iam_policies: list[IAMPolicy] = field(default_factory=list)
    eks_clusters: list[EKSCluster] = field(default_factory=list)
    kms_keys: list[KMSKey] = field(default_factory=list)
    sns_topics: list[SNSTopic] = field(default_factory=list)
    sqs_queues: list[SQSQueue] = field(default_factory=list)
    load_balancers: list[LoadBalancer] = field(default_factory=list)
    lb_listeners: list[LBListener] = field(default_factory=list)
    ecr_repositories: list[ECRRepository] = field(default_factory=list)
    efs_filesystems: list[EFSFileSystem] = field(default_factory=list)
    elasticache_groups: list[ElastiCacheGroup] = field(default_factory=list)
    redshift_clusters: list[RedshiftCluster] = field(default_factory=list)
    dynamodb_tables: list[DynamoDBTable] = field(default_factory=list)
    cloudfront_distributions: list[CloudFrontDistribution] = field(default_factory=list)
    lambda_functions: list[LambdaFunction] = field(default_factory=list)
    api_gateway_stages: list["APIGatewayStage"] = field(default_factory=list)
    athena_workgroups: list["AthenaWorkgroup"] = field(default_factory=list)
    codebuild_projects: list["CodeBuildProject"] = field(default_factory=list)
    docdb_clusters: list["DocDBCluster"] = field(default_factory=list)
    ecs_task_definitions: list["ECSTaskDefinition"] = field(default_factory=list)
    ecs_clusters: list["ECSCluster"] = field(default_factory=list)
    elasticsearch_domains: list["ESDomain"] = field(default_factory=list)
    kinesis_streams: list["KinesisStream"] = field(default_factory=list)
    mq_brokers: list["MQBroker"] = field(default_factory=list)
    msk_clusters: list["MSKCluster"] = field(default_factory=list)
    neptune_clusters: list["NeptuneCluster"] = field(default_factory=list)
    aws_workspaces: list["Workspace"] = field(default_factory=list)
    launch_templates: list["LaunchTemplate"] = field(default_factory=list)
    log_groups: list["LogGroup"] = field(default_factory=list)
    api_gateway_domains: list["APIGatewayDomain"] = field(default_factory=list)
    rds_clusters: list["RDSCluster"] = field(default_factory=list)
    secretsmanager_secrets: list["SecretsManagerSecret"] = field(default_factory=list)
    dax_clusters: list["DAXCluster"] = field(default_factory=list)
    ebs_default_encryption: list["EBSDefaultEncryption"] = field(default_factory=list)


# -- round-4 service breadth (ref: pkg/iac/providers/aws/* service models) ----

@dataclass
class APIGatewayStage(Res):
    name: Val = field(default_factory=_v)
    access_logging: Val = field(default_factory=_v)
    xray_tracing: Val = field(default_factory=_v)


@dataclass
class AthenaWorkgroup(Res):
    encryption_enabled: Val = field(default_factory=_v)
    enforce_configuration: Val = field(default_factory=_v)


@dataclass
class CodeBuildProject(Res):
    artifact_encryption_disabled: list[Val] = field(default_factory=list)


@dataclass
class DocDBCluster(Res):
    storage_encrypted: Val = field(default_factory=_v)
    kms_key_id: Val = field(default_factory=_v)
    log_exports: list[Val] = field(default_factory=list)


@dataclass
class ECSTaskDefinition(Res):
    container_definitions: Val = field(default_factory=_v)  # parsed JSON


@dataclass
class ECSCluster(Res):
    container_insights: Val = field(default_factory=_v)


@dataclass
class ESDomain(Res):
    encrypt_at_rest: Val = field(default_factory=_v)
    node_to_node_encryption: Val = field(default_factory=_v)
    enforce_https: Val = field(default_factory=_v)
    tls_policy: Val = field(default_factory=_v)
    audit_logging: Val = field(default_factory=_v)


@dataclass
class KinesisStream(Res):
    encryption_type: Val = field(default_factory=_v)
    kms_key_id: Val = field(default_factory=_v)


@dataclass
class MQBroker(Res):
    publicly_accessible: Val = field(default_factory=_v)
    general_logging: Val = field(default_factory=_v)
    audit_logging: Val = field(default_factory=_v)


@dataclass
class MSKCluster(Res):
    client_broker_encryption: Val = field(default_factory=_v)
    logging_enabled: Val = field(default_factory=_v)


@dataclass
class NeptuneCluster(Res):
    storage_encrypted: Val = field(default_factory=_v)
    kms_key_id: Val = field(default_factory=_v)
    log_exports: list[Val] = field(default_factory=list)


@dataclass
class Workspace(Res):
    root_volume_encrypted: Val = field(default_factory=_v)
    user_volume_encrypted: Val = field(default_factory=_v)


@dataclass
class LaunchTemplate(Res):
    http_tokens: Val = field(default_factory=_v)


@dataclass
class LogGroup(Res):
    kms_key_id: Val = field(default_factory=_v)
    retention_days: Val = field(default_factory=_v)


@dataclass
class APIGatewayDomain(Res):
    security_policy: Val = field(default_factory=_v)


@dataclass
class RDSCluster(Res):
    storage_encrypted: Val = field(default_factory=_v)
    backup_retention: Val = field(default_factory=_v)


@dataclass
class SecretsManagerSecret(Res):
    kms_key_id: Val = field(default_factory=_v)


@dataclass
class DAXCluster(Res):
    sse_enabled: Val = field(default_factory=_v)


@dataclass
class EBSDefaultEncryption(Res):
    enabled: Val = field(default_factory=_v)
