"""Builtin AWS cloud checks over typed provider state.

Independently-authored equivalents of the reference's embedded AWS check
bundle (AVD-AWS IDs are the public reporting/suppression interface; the
check logic here is written against this repo's own state model). Each
check yields :class:`CloudFailure` records whose tracked values carry the
file + line causes, so one check serves terraform and CloudFormation.

The port of ``trivy_tpu/misconf/checks/cloud_aws.py``.
"""

from __future__ import annotations

from trivy_tpu_torch.misconf.adapters.aws_state import AWSState
from trivy_tpu_torch.misconf.checks import Check, CloudFailure, register_cloud

_TYPES = ("terraform", "cloudformation")
_URL = "https://avd.aquasec.com/misconfig/{}"


# which state collection a check inspects (used to skip checks with no
# matching resources); services with several collections pass targets=...
_SERVICE_TARGETS = {
    "s3": "s3_buckets", "rds": "rds_instances", "cloudtrail": "cloudtrails",
    "eks": "eks_clusters", "kms": "kms_keys", "sns": "sns_topics",
    "sqs": "sqs_queues", "ecr": "ecr_repositories", "efs": "efs_filesystems",
    "elasticache": "elasticache_groups", "redshift": "redshift_clusters",
    "dynamodb": "dynamodb_tables", "cloudfront": "cloudfront_distributions",
    "lambda": "lambda_functions",
}


def _check(id_, title, severity, service, desc="", res="", targets=None):
    if targets is None:
        targets = _SERVICE_TARGETS.get(service, "")

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
                provider="aws",
                targets=targets,
            )
        )
        return fn

    return wrap


_PUBLIC_CIDRS = ("0.0.0.0/0", "::/0")


def _is_public_cidr(c: str) -> bool:
    if c in _PUBLIC_CIDRS:
        return True
    if c.endswith("/0"):
        return True
    return False


# -- S3 -----------------------------------------------------------------------

@_check("AVD-AWS-0086", "S3 Access block should block public ACLs", "HIGH", "s3",
        "PUT calls with public ACLs should be blocked.",
        "Set block_public_acls on the bucket's public access block.")
def s3_block_public_acls(st: AWSState):
    for b in st.s3_buckets:
        pab = b.public_access_block
        if pab is None:
            continue  # AVD-AWS-0094 reports the missing block
        if not pab.block_public_acls.bool():
            yield CloudFailure(
                "No public access block so not blocking public acls",
                pab.block_public_acls if pab.block_public_acls.explicit else pab.anchor(),
                b.address,
            )


@_check("AVD-AWS-0087", "S3 Access block should block public policy", "HIGH", "s3",
        "Bucket policies granting public access should be blocked.",
        "Set block_public_policy on the bucket's public access block.")
def s3_block_public_policy(st: AWSState):
    for b in st.s3_buckets:
        pab = b.public_access_block
        if pab is None:
            continue
        if not pab.block_public_policy.bool():
            yield CloudFailure(
                "No public access block so not blocking public policies",
                pab.block_public_policy if pab.block_public_policy.explicit else pab.anchor(),
                b.address,
            )


@_check("AVD-AWS-0091", "S3 Access Block should ignore public ACLs", "HIGH", "s3",
        "Existing public ACLs should be ignored.",
        "Set ignore_public_acls on the bucket's public access block.")
def s3_ignore_public_acls(st: AWSState):
    for b in st.s3_buckets:
        pab = b.public_access_block
        if pab is None:
            continue
        if not pab.ignore_public_acls.bool():
            yield CloudFailure(
                "No public access block so not ignoring public acls",
                pab.ignore_public_acls if pab.ignore_public_acls.explicit else pab.anchor(),
                b.address,
            )


@_check("AVD-AWS-0093", "S3 Access block should restrict public buckets", "HIGH", "s3",
        "Public bucket policies should be restricted to AWS service principals.",
        "Set restrict_public_buckets on the bucket's public access block.")
def s3_restrict_public_buckets(st: AWSState):
    for b in st.s3_buckets:
        pab = b.public_access_block
        if pab is None:
            continue
        if not pab.restrict_public_buckets.bool():
            yield CloudFailure(
                "No public access block so not restricting public buckets",
                pab.restrict_public_buckets if pab.restrict_public_buckets.explicit else pab.anchor(),
                b.address,
            )


@_check("AVD-AWS-0094", "S3 buckets should each define a Public Access Block", "LOW", "s3",
        "Without a public access block, misconfigured policies/ACLs expose the bucket.",
        "Define an aws_s3_bucket_public_access_block for the bucket.")
def s3_missing_public_access_block(st: AWSState):
    for b in st.s3_buckets:
        if b.public_access_block is None:
            yield CloudFailure(
                "Bucket does not have a corresponding public access block.",
                b.anchor(),
                b.address,
            )


@_check("AVD-AWS-0092", "S3 Buckets not publicly accessible through ACL", "HIGH", "s3",
        "Public ACLs expose bucket contents to the internet.",
        "Use a private ACL.")
def s3_public_acl(st: AWSState):
    for b in st.s3_buckets:
        acl = b.acl.str()
        if acl in ("public-read", "public-read-write", "website", "authenticated-read"):
            yield CloudFailure(
                f"Bucket has a public ACL: {acl!r}.", b.acl, b.address
            )


@_check("AVD-AWS-0088", "Unencrypted S3 bucket", "HIGH", "s3",
        "Server-side encryption protects bucket contents at rest.",
        "Configure bucket encryption.")
def s3_encryption(st: AWSState):
    for b in st.s3_buckets:
        if not b.encryption_enabled.bool():
            yield CloudFailure(
                "Bucket does not have encryption enabled",
                b.encryption_enabled if b.encryption_enabled.explicit else b.anchor(),
                b.address,
            )


@_check("AVD-AWS-0090", "S3 Data should be versioned", "MEDIUM", "s3",
        "Versioning protects against accidental or malicious overwrite/delete.",
        "Enable versioning.")
def s3_versioning(st: AWSState):
    for b in st.s3_buckets:
        if not b.versioning_enabled.bool():
            yield CloudFailure(
                "Bucket does not have versioning enabled",
                b.versioning_enabled if b.versioning_enabled.explicit else b.anchor(),
                b.address,
            )


@_check("AVD-AWS-0089", "S3 Bucket Logging", "LOW", "s3",
        "Access logging provides an audit trail of requests.",
        "Add a logging block / LoggingConfiguration.")
def s3_logging(st: AWSState):
    for b in st.s3_buckets:
        if not b.logging_enabled.bool() and b.acl.str() != "log-delivery-write":
            yield CloudFailure(
                "Bucket does not have logging enabled",
                b.logging_enabled if b.logging_enabled.explicit else b.anchor(),
                b.address,
            )


# -- EC2 / VPC ---------------------------------------------------------------

@_check("AVD-AWS-0107", "An ingress security group rule allows traffic from /0", "CRITICAL", "ec2",
        "Opening ports to the entire internet maximizes attack surface.",
        "Restrict ingress CIDR ranges.", targets="security_groups")
def sg_public_ingress(st: AWSState):
    for sg in st.security_groups:
        for r in sg.rules:
            if r.type != "ingress":
                continue
            for c in r.cidrs.list() or ([r.cidrs.str()] if r.cidrs.is_set() and r.cidrs.str() else []):
                if isinstance(c, str) and _is_public_cidr(c):
                    yield CloudFailure(
                        f"Security group rule allows ingress from public internet ({c}).",
                        r.cidrs if r.cidrs.explicit else r.anchor(),
                        sg.address,
                    )
                    break


@_check("AVD-AWS-0104", "An egress security group rule allows traffic to /0", "CRITICAL", "ec2",
        "Unrestricted egress eases data exfiltration after compromise.",
        "Restrict egress CIDR ranges.", targets="security_groups")
def sg_public_egress(st: AWSState):
    for sg in st.security_groups:
        for r in sg.rules:
            if r.type != "egress":
                continue
            for c in r.cidrs.list() or ([r.cidrs.str()] if r.cidrs.is_set() and r.cidrs.str() else []):
                if isinstance(c, str) and _is_public_cidr(c):
                    yield CloudFailure(
                        f"Security group rule allows egress to multiple public internet addresses ({c}).",
                        r.cidrs if r.cidrs.explicit else r.anchor(),
                        sg.address,
                    )
                    break


@_check("AVD-AWS-0124", "Missing description for security group rule", "LOW", "ec2",
        "Descriptions document intent and ease audits.",
        "Add a description to every security group rule.", targets="security_groups")
def sg_rule_description(st: AWSState):
    for sg in st.security_groups:
        for r in sg.rules:
            if not r.description.str():
                yield CloudFailure(
                    "Security group rule does not have a description.",
                    r.anchor(),
                    sg.address,
                )


@_check("AVD-AWS-0028", "aws_instance should activate session tokens for Instance Metadata Service", "HIGH", "ec2",
        "IMDSv1 is vulnerable to SSRF; require session tokens (IMDSv2).",
        "Set metadata_options http_tokens = \"required\".", targets="instances")
def ec2_imdsv2(st: AWSState):
    for i in st.instances:
        if i.http_endpoint.str() == "disabled":
            continue
        if i.http_tokens.str() != "required":
            yield CloudFailure(
                "Instance does not require IMDS access to require a token",
                i.http_tokens if i.http_tokens.explicit else i.anchor(),
                i.address,
            )


@_check("AVD-AWS-0131", "Instances with unencrypted block devices", "HIGH", "ec2",
        "Root and EBS block devices should be encrypted at rest.",
        "Set encrypted = true on block devices.", targets="instances")
def ec2_encrypted_devices(st: AWSState):
    for i in st.instances:
        devices = ([i.root_device] if i.root_device is not None else []) + i.ebs_devices
        for d in devices:
            if not d.encrypted.bool():
                yield CloudFailure(
                    "Instance has an unencrypted block device.",
                    d.encrypted if d.encrypted.explicit else d.anchor(),
                    i.address,
                )


@_check("AVD-AWS-0026", "Enable EBS volume encryption", "HIGH", "ec2",
        "Unencrypted EBS volumes expose data at rest.",
        "Set encrypted = true on the volume.", targets="volumes")
def ebs_volume_encrypted(st: AWSState):
    for v in st.volumes:
        if not v.encrypted.bool():
            yield CloudFailure(
                "EBS volume is not encrypted.",
                v.encrypted if v.encrypted.explicit else v.anchor(),
                v.address,
            )


# -- RDS ---------------------------------------------------------------------

@_check("AVD-AWS-0080", "RDS Encryption", "HIGH", "rds",
        "Unencrypted RDS storage exposes data at rest.",
        "Set storage_encrypted = true.")
def rds_encrypted(st: AWSState):
    for db in st.rds_instances:
        if not db.storage_encrypted.bool():
            yield CloudFailure(
                "Instance does not have storage encryption enabled.",
                db.storage_encrypted if db.storage_encrypted.explicit else db.anchor(),
                db.address,
            )


@_check("AVD-AWS-0180", "RDS Publicly Accessible", "CRITICAL", "rds",
        "Publicly accessible databases are exposed to the internet.",
        "Set publicly_accessible = false.")
def rds_public(st: AWSState):
    for db in st.rds_instances:
        if db.publicly_accessible.bool():
            yield CloudFailure(
                "Instance is exposed publicly.",
                db.publicly_accessible,
                db.address,
            )


@_check("AVD-AWS-0077", "RDS Cluster and RDS instance should have backup retention longer than default 1 day", "MEDIUM", "rds",
        "Short retention windows limit point-in-time recovery.",
        "Set backup_retention_period greater than 1.")
def rds_backup_retention(st: AWSState):
    for db in st.rds_instances:
        if db.backup_retention.int() <= 1:
            yield CloudFailure(
                "Instance has very low backup retention.",
                db.backup_retention if db.backup_retention.explicit else db.anchor(),
                db.address,
            )


@_check("AVD-AWS-0133", "RDS Performance Insights Encryption", "LOW", "rds",
        "Performance Insights data should use a customer key.",
        "Set performance_insights_kms_key_id when insights are enabled.")
def rds_insights_kms(st: AWSState):
    for db in st.rds_instances:
        if db.performance_insights.bool() and not db.performance_insights_kms.str():
            yield CloudFailure(
                "Instance has performance insights enabled without a customer managed key.",
                db.performance_insights,
                db.address,
            )


# -- CloudTrail --------------------------------------------------------------

@_check("AVD-AWS-0014", "CloudTrail Multi Region", "MEDIUM", "cloudtrail",
        "Single-region trails miss events elsewhere.",
        "Set is_multi_region_trail = true.")
def trail_multi_region(st: AWSState):
    for t in st.cloudtrails:
        if not t.multi_region.bool():
            yield CloudFailure(
                "Trail is not enabled across all regions.",
                t.multi_region if t.multi_region.explicit else t.anchor(),
                t.address,
            )


@_check("AVD-AWS-0016", "CloudTrail Log File Validation", "HIGH", "cloudtrail",
        "Validation detects tampering with delivered logs.",
        "Set enable_log_file_validation = true.")
def trail_validation(st: AWSState):
    for t in st.cloudtrails:
        if not t.log_validation.bool():
            yield CloudFailure(
                "Trail does not have log validation enabled.",
                t.log_validation if t.log_validation.explicit else t.anchor(),
                t.address,
            )


@_check("AVD-AWS-0015", "CloudTrail Encryption", "HIGH", "cloudtrail",
        "Trail logs should be encrypted with a customer managed key.",
        "Set kms_key_id on the trail.")
def trail_cmk(st: AWSState):
    for t in st.cloudtrails:
        if not t.kms_key_id.str():
            yield CloudFailure(
                "Trail is not encrypted with a customer managed key.",
                t.kms_key_id if t.kms_key_id.explicit else t.anchor(),
                t.address,
            )


# -- IAM ---------------------------------------------------------------------

def _statements(doc) -> list[dict]:
    if not isinstance(doc, dict):
        return []
    stmts = doc.get("Statement", [])
    if isinstance(stmts, dict):
        stmts = [stmts]
    return [s for s in stmts if isinstance(s, dict)]


@_check("AVD-AWS-0057", "IAM policy should avoid use of wildcards and instead apply the principle of least privilege", "HIGH", "iam",
        "Wildcard actions/resources grant more than intended.",
        "Scope actions and resources explicitly.", targets="iam_policies")
def iam_wildcards(st: AWSState):
    for p in st.iam_policies:
        for s in _statements(p.document.value):
            if s.get("Effect", "Allow") != "Allow":
                continue
            actions = s.get("Action", [])
            actions = actions if isinstance(actions, list) else [actions]
            resources = s.get("Resource", [])
            resources = resources if isinstance(resources, list) else [resources]
            for a in actions:
                if isinstance(a, str) and a.strip() == "*":
                    yield CloudFailure(
                        "IAM policy document uses wildcarded action '*'",
                        p.document, p.address,
                    )
                    break
            else:
                for r in resources:
                    if isinstance(r, str) and r.strip() == "*":
                        yield CloudFailure(
                            "IAM policy document uses sensitive action '*' on wildcarded resource '*'"
                            if any(isinstance(a, str) and ":" in a for a in actions)
                            else "IAM policy document uses wildcarded resource '*'",
                            p.document, p.address,
                        )
                        break


@_check("AVD-AWS-0063", "IAM Password policy should have minimum password length of 14 or more characters", "MEDIUM", "iam",
        "Short passwords are easier to brute force.",
        "Set minimum_password_length >= 14.", targets="password_policies")
def iam_password_length(st: AWSState):
    for p in st.password_policies:
        if p.minimum_length.int() < 14:
            yield CloudFailure(
                "Password policy allows a maximum password age of less than 14 characters.",
                p.minimum_length if p.minimum_length.explicit else p.anchor(),
                p.address,
            )


@_check("AVD-AWS-0059", "IAM Password policy should prevent password reuse", "MEDIUM", "iam",
        "Reused passwords extend the life of compromised credentials.",
        "Set password_reuse_prevention >= 5.", targets="password_policies")
def iam_password_reuse(st: AWSState):
    for p in st.password_policies:
        if p.reuse_prevention.int() < 5:
            yield CloudFailure(
                "Password policy allows reuse of recent passwords.",
                p.reuse_prevention if p.reuse_prevention.explicit else p.anchor(),
                p.address,
            )


@_check("AVD-AWS-0062", "IAM Password policy should have expiry less than or equal to 90 days", "MEDIUM", "iam",
        "Long-lived passwords increase exposure.",
        "Set max_password_age <= 90.", targets="password_policies")
def iam_password_age(st: AWSState):
    for p in st.password_policies:
        age = p.max_age.int()
        if age == 0 or age > 90:
            yield CloudFailure(
                "Password policy allows passwords to live longer than 90 days.",
                p.max_age if p.max_age.explicit else p.anchor(),
                p.address,
            )


@_check("AVD-AWS-0060", "IAM Password policy should have requirement for at least one symbol in the password", "MEDIUM", "iam",
        "Symbols increase password entropy.",
        "Set require_symbols = true.", targets="password_policies")
def iam_password_symbols(st: AWSState):
    for p in st.password_policies:
        if not p.require_symbols.bool():
            yield CloudFailure(
                "Password policy does not require symbols.",
                p.require_symbols if p.require_symbols.explicit else p.anchor(),
                p.address,
            )


@_check("AVD-AWS-0061", "IAM Password policy should have requirement for at least one number in the password", "MEDIUM", "iam",
        "Numbers increase password entropy.",
        "Set require_numbers = true.", targets="password_policies")
def iam_password_numbers(st: AWSState):
    for p in st.password_policies:
        if not p.require_numbers.bool():
            yield CloudFailure(
                "Password policy does not require numbers.",
                p.require_numbers if p.require_numbers.explicit else p.anchor(),
                p.address,
            )


# -- EKS ---------------------------------------------------------------------

@_check("AVD-AWS-0038", "EKS Clusters should have cluster control plane logging turned on", "MEDIUM", "eks",
        "Control plane logs are needed for audit and forensics.",
        "Enable all control-plane log types.")
def eks_logging(st: AWSState):
    for c in st.eks_clusters:
        if not c.log_types.list():
            yield CloudFailure(
                "Cluster does not have control plane logging enabled.",
                c.log_types if c.log_types.explicit else c.anchor(),
                c.address,
            )


@_check("AVD-AWS-0039", "EKS should have the encryption of secrets enabled", "HIGH", "eks",
        "Secrets should be envelope-encrypted with KMS.",
        "Add an encryption_config with resources = [\"secrets\"].")
def eks_secrets(st: AWSState):
    for c in st.eks_clusters:
        if not c.secrets_encrypted.bool():
            yield CloudFailure(
                "Cluster does not have secret encryption enabled.",
                c.secrets_encrypted if c.secrets_encrypted.explicit else c.anchor(),
                c.address,
            )


@_check("AVD-AWS-0040", "EKS Clusters should have the public access disabled", "CRITICAL", "eks",
        "A public API endpoint is reachable from the internet.",
        "Set endpoint_public_access = false.")
def eks_public_access(st: AWSState):
    for c in st.eks_clusters:
        if c.public_access.bool(True):
            yield CloudFailure(
                "Public cluster access is enabled.",
                c.public_access if c.public_access.explicit else c.anchor(),
                c.address,
            )


@_check("AVD-AWS-0041", "EKS Clusters should restrict access to public API server", "CRITICAL", "eks",
        "Public API access should be restricted to known CIDRs.",
        "Restrict public_access_cidrs.")
def eks_public_cidrs(st: AWSState):
    for c in st.eks_clusters:
        if not c.public_access.bool(True):
            continue
        cidrs = c.public_access_cidrs.list()
        if any(isinstance(x, str) and _is_public_cidr(x) for x in cidrs):
            yield CloudFailure(
                "Cluster allows access from a public CIDR: 0.0.0.0/0.",
                c.public_access_cidrs if c.public_access_cidrs.explicit else c.anchor(),
                c.address,
            )


# -- KMS / messaging ---------------------------------------------------------

@_check("AVD-AWS-0065", "A KMS key is not configured to auto-rotate", "MEDIUM", "kms",
        "Rotation limits blast radius of a compromised key.",
        "Set enable_key_rotation = true.")
def kms_rotation(st: AWSState):
    for k in st.kms_keys:
        if k.usage.str() == "SIGN_VERIFY":
            continue
        if not k.rotation_enabled.bool():
            yield CloudFailure(
                "Key does not have rotation enabled.",
                k.rotation_enabled if k.rotation_enabled.explicit else k.anchor(),
                k.address,
            )


@_check("AVD-AWS-0095", "SNS topic not encrypt data with a customer managed key.", "HIGH", "sns",
        "Topics should be encrypted with a CMK.",
        "Set kms_master_key_id.")
def sns_encryption(st: AWSState):
    for t in st.sns_topics:
        if not t.kms_key_id.str():
            yield CloudFailure(
                "Topic does not have encryption enabled.",
                t.kms_key_id if t.kms_key_id.explicit else t.anchor(),
                t.address,
            )


@_check("AVD-AWS-0096", "Unencrypted SQS queue.", "HIGH", "sqs",
        "Queues should be encrypted at rest.",
        "Enable SSE-SQS or set kms_master_key_id.")
def sqs_encryption(st: AWSState):
    for q in st.sqs_queues:
        if not q.managed_sse.bool() and not q.kms_key_id.str():
            yield CloudFailure(
                "Queue is not encrypted",
                q.kms_key_id if q.kms_key_id.explicit else q.anchor(),
                q.address,
            )


@_check("AVD-AWS-0097", "AWS SQS policy document has wildcard action statement.", "HIGH", "sqs",
        "Wildcard actions on queue policies grant unintended rights.",
        "Scope queue policy actions.")
def sqs_policy_wildcard(st: AWSState):
    for q in st.sqs_queues:
        for s in _statements(q.policy_document.value):
            if s.get("Effect", "Allow") != "Allow":
                continue
            actions = s.get("Action", [])
            actions = actions if isinstance(actions, list) else [actions]
            if any(isinstance(a, str) and a in ("*", "sqs:*") for a in actions):
                yield CloudFailure(
                    "Queue policy does not restrict actions as required.",
                    q.policy_document, q.address,
                )


# -- ELB ---------------------------------------------------------------------

@_check("AVD-AWS-0053", "Load balancer is exposed to the internet.", "HIGH", "elb",
        "Internet-facing load balancers expose workloads.",
        "Set internal = true unless public exposure is intended.", targets="load_balancers")
def elb_internal(st: AWSState):
    for lb in st.load_balancers:
        if not lb.internal.bool():
            yield CloudFailure(
                "Load balancer is exposed publicly.",
                lb.internal if lb.internal.explicit else lb.anchor(),
                lb.address,
            )


@_check("AVD-AWS-0052", "Load balancers should drop invalid headers", "HIGH", "elb",
        "Dropping invalid headers mitigates request smuggling.",
        "Set drop_invalid_header_fields = true.", targets="load_balancers")
def elb_drop_headers(st: AWSState):
    for lb in st.load_balancers:
        if lb.type.str() != "application":
            continue
        if not lb.drop_invalid_headers.bool():
            yield CloudFailure(
                "Application load balancer is not set to drop invalid headers.",
                lb.drop_invalid_headers if lb.drop_invalid_headers.explicit else lb.anchor(),
                lb.address,
            )


@_check("AVD-AWS-0054", "Use of plain HTTP.", "CRITICAL", "elb",
        "Plain HTTP traffic can be read and modified in transit.",
        "Use HTTPS with a certificate.", targets="lb_listeners")
def elb_http(st: AWSState):
    for l in st.lb_listeners:
        if l.protocol.str().upper() == "HTTP":
            yield CloudFailure(
                "Listener for application load balancer does not use HTTPS.",
                l.protocol if l.protocol.explicit else l.anchor(),
                l.address,
            )


_OUTDATED_TLS = {
    "ELBSecurityPolicy-2015-05", "ELBSecurityPolicy-2016-08",
    "ELBSecurityPolicy-TLS-1-0-2015-04", "ELBSecurityPolicy-TLS-1-1-2017-01",
}


@_check("AVD-AWS-0047", "Use of outdated SSL policy.", "CRITICAL", "elb",
        "Old TLS policies permit weak protocol versions.",
        "Use a TLS 1.2+ security policy.", targets="lb_listeners")
def elb_tls_policy(st: AWSState):
    for l in st.lb_listeners:
        if l.ssl_policy.str() in _OUTDATED_TLS:
            yield CloudFailure(
                f"Listener uses an outdated TLS policy: {l.ssl_policy.str()}.",
                l.ssl_policy, l.address,
            )


# -- ECR / storage services --------------------------------------------------

@_check("AVD-AWS-0030", "ECR repository has image scans disabled.", "HIGH", "ecr",
        "Image scanning surfaces known vulnerabilities on push.",
        "Enable scan_on_push.")
def ecr_scanning(st: AWSState):
    for r in st.ecr_repositories:
        if not r.scan_on_push.bool():
            yield CloudFailure(
                "Image scanning is not enabled.",
                r.scan_on_push if r.scan_on_push.explicit else r.anchor(),
                r.address,
            )


@_check("AVD-AWS-0031", "ECR images tags shouldn't be mutable.", "HIGH", "ecr",
        "Mutable tags allow silently replacing deployed images.",
        "Set image_tag_mutability = \"IMMUTABLE\".")
def ecr_immutable(st: AWSState):
    for r in st.ecr_repositories:
        if not r.immutable_tags.bool():
            yield CloudFailure(
                "Repository tags are mutable.",
                r.immutable_tags if r.immutable_tags.explicit else r.anchor(),
                r.address,
            )


@_check("AVD-AWS-0033", "ECR Repo is not encrypted with KMS.", "LOW", "ecr",
        "Customer-managed keys give control over repo encryption.",
        "Use encryption_type = \"KMS\".")
def ecr_kms(st: AWSState):
    for r in st.ecr_repositories:
        if not r.encrypted_kms.bool():
            yield CloudFailure(
                "Repository is not encrypted using KMS.",
                r.encrypted_kms if r.encrypted_kms.explicit else r.anchor(),
                r.address,
            )


@_check("AVD-AWS-0037", "EFS Encryption", "HIGH", "efs",
        "EFS file systems should be encrypted at rest.",
        "Set encrypted = true.")
def efs_encrypted(st: AWSState):
    for f in st.efs_filesystems:
        if not f.encrypted.bool():
            yield CloudFailure(
                "File system is not encrypted.",
                f.encrypted if f.encrypted.explicit else f.anchor(),
                f.address,
            )


@_check("AVD-AWS-0051", "Elasticache Replication Group uses unencrypted traffic.", "HIGH", "elasticache",
        "In-transit encryption protects replication traffic.",
        "Set transit_encryption_enabled = true.")
def elasticache_transit(st: AWSState):
    for g in st.elasticache_groups:
        if not g.transit_encryption.bool():
            yield CloudFailure(
                "Replication group does not have transit encryption enabled.",
                g.transit_encryption if g.transit_encryption.explicit else g.anchor(),
                g.address,
            )


@_check("AVD-AWS-0045", "Elasticache Replication Group stores unencrypted data at-rest.", "HIGH", "elasticache",
        "At-rest encryption protects cached data.",
        "Set at_rest_encryption_enabled = true.")
def elasticache_at_rest(st: AWSState):
    for g in st.elasticache_groups:
        if not g.at_rest_encryption.bool():
            yield CloudFailure(
                "Replication group does not have at-rest encryption enabled.",
                g.at_rest_encryption if g.at_rest_encryption.explicit else g.anchor(),
                g.address,
            )


@_check("AVD-AWS-0084", "Redshift clusters should use at rest encryption", "HIGH", "redshift",
        "Unencrypted clusters expose warehouse data.",
        "Set encrypted = true with a KMS key.")
def redshift_encrypted(st: AWSState):
    for c in st.redshift_clusters:
        if not c.encrypted.bool():
            yield CloudFailure(
                "Cluster does not have encryption enabled.",
                c.encrypted if c.encrypted.explicit else c.anchor(),
                c.address,
            )


@_check("AVD-AWS-0024", "Point in time recovery in DynamoDB", "MEDIUM", "dynamodb",
        "PITR protects tables against accidental writes/deletes.",
        "Enable point-in-time recovery.")
def dynamodb_pitr(st: AWSState):
    for t in st.dynamodb_tables:
        if not t.point_in_time_recovery.bool():
            yield CloudFailure(
                "Table does not have point in time recovery enabled.",
                t.point_in_time_recovery if t.point_in_time_recovery.explicit else t.anchor(),
                t.address,
            )


@_check("AVD-AWS-0025", "DynamoDB tables should use at rest encryption with a Customer Managed Key", "LOW", "dynamodb",
        "CMK-based encryption gives control over table data keys.",
        "Enable server-side encryption with a KMS key.")
def dynamodb_sse(st: AWSState):
    for t in st.dynamodb_tables:
        if not t.sse_enabled.bool():
            yield CloudFailure(
                "Table encryption does not use a customer-managed KMS key.",
                t.sse_enabled if t.sse_enabled.explicit else t.anchor(),
                t.address,
            )


# -- CloudFront / Lambda ------------------------------------------------------

@_check("AVD-AWS-0010", "CloudFront distribution allows unencrypted (HTTP) communications.", "CRITICAL", "cloudfront",
        "Viewers should be redirected to HTTPS.",
        "Set viewer_protocol_policy to redirect-to-https or https-only.")
def cloudfront_https(st: AWSState):
    for d in st.cloudfront_distributions:
        if d.viewer_protocol_policy.str() == "allow-all":
            yield CloudFailure(
                "Distribution allows unencrypted communications.",
                d.viewer_protocol_policy if d.viewer_protocol_policy.explicit else d.anchor(),
                d.address,
            )


@_check("AVD-AWS-0013", "CloudFront distribution uses outdated SSL/TLS protocols.", "HIGH", "cloudfront",
        "Minimum protocol should be TLS 1.2.",
        "Set minimum_protocol_version to TLSv1.2_2021.")
def cloudfront_tls(st: AWSState):
    for d in st.cloudfront_distributions:
        mpv = d.minimum_protocol_version.str()
        if mpv and not mpv.startswith("TLSv1.2"):
            yield CloudFailure(
                f"Distribution allows outdated SSL/TLS protocols ({mpv}).",
                d.minimum_protocol_version if d.minimum_protocol_version.explicit else d.anchor(),
                d.address,
            )


@_check("AVD-AWS-0066", "Lambda functions should have X-Ray tracing enabled", "LOW", "lambda",
        "Tracing aids investigation of anomalous behavior.",
        "Set tracing_config mode = \"Active\".")
def lambda_tracing(st: AWSState):
    for f in st.lambda_functions:
        if f.tracing_mode.str() != "Active":
            yield CloudFailure(
                "Function does not have tracing enabled.",
                f.tracing_mode if f.tracing_mode.explicit else f.anchor(),
                f.address,
            )


# -- round-4 service breadth --------------------------------------------------

_SERVICE_TARGETS.update({
    "api-gateway": "api_gateway_stages",
    "athena": "athena_workgroups",
    "codebuild": "codebuild_projects",
    "documentdb": "docdb_clusters",
    "ecs": "ecs_task_definitions",
    "elastic-search": "elasticsearch_domains",
    "kinesis": "kinesis_streams",
    "mq": "mq_brokers",
    "msk": "msk_clusters",
    "neptune": "neptune_clusters",
    "workspaces": "aws_workspaces",
})


@_check("AVD-AWS-0001", "API Gateway stages should have access logging enabled",
        "MEDIUM", "api-gateway")
def apigw_access_logging(st: AWSState):
    for s in st.api_gateway_stages:
        if not s.access_logging.bool():
            yield CloudFailure(
                "API Gateway stage does not enable access logging",
                s.access_logging if s.access_logging.explicit else s.anchor(),
                s.address,
            )


@_check("AVD-AWS-0003", "API Gateway stages should enable X-Ray tracing",
        "LOW", "api-gateway")
def apigw_xray(st: AWSState):
    for s in st.api_gateway_stages:
        if s.resource.labels and s.resource.labels[0] == "aws_api_gateway_stage":
            if not s.xray_tracing.bool():
                yield CloudFailure(
                    "API Gateway stage does not enable X-Ray tracing",
                    s.xray_tracing if s.xray_tracing.explicit else s.anchor(),
                    s.address,
                )


@_check("AVD-AWS-0006", "Athena workgroups should encrypt query results",
        "HIGH", "athena")
def athena_encryption(st: AWSState):
    for wg in st.athena_workgroups:
        if not wg.encryption_enabled.bool():
            yield CloudFailure(
                "Athena workgroup does not encrypt query results",
                wg.encryption_enabled if wg.encryption_enabled.explicit else wg.anchor(),
                wg.address,
            )


@_check("AVD-AWS-0007", "Athena workgroups should enforce their configuration",
        "MEDIUM", "athena")
def athena_enforce(st: AWSState):
    for wg in st.athena_workgroups:
        if not wg.enforce_configuration.bool():
            yield CloudFailure(
                "Athena workgroup does not enforce its configuration",
                wg.enforce_configuration, wg.address,
            )


@_check("AVD-AWS-0018", "CodeBuild projects should encrypt artifacts",
        "HIGH", "codebuild")
def codebuild_encryption(st: AWSState):
    for p in st.codebuild_projects:
        for v in p.artifact_encryption_disabled:
            yield CloudFailure(
                "CodeBuild project disables artifact encryption", v, p.address
            )


@_check("AVD-AWS-0021", "DocumentDB clusters should encrypt storage",
        "HIGH", "documentdb")
def docdb_storage_encrypted(st: AWSState):
    for c in st.docdb_clusters:
        if not c.storage_encrypted.bool():
            yield CloudFailure(
                "DocumentDB cluster does not encrypt storage",
                c.storage_encrypted if c.storage_encrypted.explicit else c.anchor(),
                c.address,
            )


@_check("AVD-AWS-0020", "DocumentDB clusters should export audit logs",
        "MEDIUM", "documentdb")
def docdb_log_exports(st: AWSState):
    for c in st.docdb_clusters:
        kinds = {str(v.value) for v in c.log_exports}
        if "audit" not in kinds:
            yield CloudFailure(
                "DocumentDB cluster does not export audit logs",
                c.log_exports[0] if c.log_exports else c.anchor(),
                c.address,
            )


@_check("AVD-AWS-0022", "DocumentDB clusters should encrypt with a customer KMS key",
        "LOW", "documentdb")
def docdb_kms(st: AWSState):
    for c in st.docdb_clusters:
        if not c.kms_key_id.str():
            yield CloudFailure(
                "DocumentDB cluster does not use a customer-managed KMS key",
                c.kms_key_id if c.kms_key_id.explicit else c.anchor(),
                c.address,
            )


@_check("AVD-AWS-0034", "ECS task definitions should not embed plaintext secrets",
        "CRITICAL", "ecs")
def ecs_no_plaintext_secrets(st: AWSState):
    import re

    pat = re.compile(
        r"(?i)(password|secret|token|api_?key|access_?key)", re.ASCII
    )
    for td in st.ecs_task_definitions:
        defs = td.container_definitions.value
        if not isinstance(defs, list):
            continue
        for cd in defs:
            if not isinstance(cd, dict):
                continue
            for env in cd.get("environment", []) or []:
                if not isinstance(env, dict):
                    continue
                name = str(env.get("name", ""))
                value = str(env.get("value", ""))
                if value and pat.search(name):
                    yield CloudFailure(
                        f"Task definition embeds a plaintext secret in env var {name!r}",
                        td.container_definitions, td.address,
                    )


@_check("AVD-AWS-0035", "ECS clusters should enable container insights",
        "LOW", "ecs", targets="ecs_clusters")
def ecs_container_insights(st: AWSState):
    for c in st.ecs_clusters:
        if not c.container_insights.bool():
            yield CloudFailure(
                "ECS cluster does not enable container insights",
                c.container_insights if c.container_insights.explicit else c.anchor(),
                c.address,
            )


@_check("AVD-AWS-0048", "Elasticsearch domains should encrypt data at rest",
        "HIGH", "elastic-search")
def es_encrypt_at_rest(st: AWSState):
    for d in st.elasticsearch_domains:
        if not d.encrypt_at_rest.bool():
            yield CloudFailure(
                "Elasticsearch domain does not encrypt data at rest",
                d.encrypt_at_rest if d.encrypt_at_rest.explicit else d.anchor(),
                d.address,
            )


@_check("AVD-AWS-0043", "Elasticsearch domains should encrypt node-to-node traffic",
        "HIGH", "elastic-search")
def es_node_to_node(st: AWSState):
    for d in st.elasticsearch_domains:
        if not d.node_to_node_encryption.bool():
            yield CloudFailure(
                "Elasticsearch domain does not encrypt node-to-node traffic",
                d.node_to_node_encryption
                if d.node_to_node_encryption.explicit
                else d.anchor(),
                d.address,
            )


@_check("AVD-AWS-0046", "Elasticsearch domains should enforce HTTPS",
        "HIGH", "elastic-search")
def es_enforce_https(st: AWSState):
    for d in st.elasticsearch_domains:
        if not d.enforce_https.bool():
            yield CloudFailure(
                "Elasticsearch domain does not enforce HTTPS",
                d.enforce_https if d.enforce_https.explicit else d.anchor(),
                d.address,
            )


@_check("AVD-AWS-0042", "Elasticsearch domains should use a modern TLS policy",
        "HIGH", "elastic-search")
def es_tls_policy(st: AWSState):
    for d in st.elasticsearch_domains:
        if d.tls_policy.str() == "Policy-Min-TLS-1-0-2019-07":
            yield CloudFailure(
                "Elasticsearch domain allows TLS 1.0",
                d.tls_policy if d.tls_policy.explicit else d.anchor(),
                d.address,
            )


@_check("AVD-AWS-0049", "Elasticsearch domains should enable audit logging",
        "MEDIUM", "elastic-search")
def es_audit_logging(st: AWSState):
    for d in st.elasticsearch_domains:
        if not d.audit_logging.bool():
            yield CloudFailure(
                "Elasticsearch domain does not enable audit logging",
                d.audit_logging if d.audit_logging.explicit else d.anchor(),
                d.address,
            )


@_check("AVD-AWS-0064", "Kinesis streams should be encrypted with KMS",
        "HIGH", "kinesis")
def kinesis_encryption(st: AWSState):
    for k in st.kinesis_streams:
        if k.encryption_type.str().upper() != "KMS":
            yield CloudFailure(
                "Kinesis stream is not encrypted with KMS",
                k.encryption_type if k.encryption_type.explicit else k.anchor(),
                k.address,
            )


@_check("AVD-AWS-0072", "MQ brokers should not be publicly accessible",
        "HIGH", "mq")
def mq_no_public(st: AWSState):
    for b in st.mq_brokers:
        if b.publicly_accessible.bool():
            yield CloudFailure(
                "MQ broker is publicly accessible", b.publicly_accessible, b.address
            )


@_check("AVD-AWS-0070", "MQ brokers should enable general logging",
        "LOW", "mq")
def mq_general_logging(st: AWSState):
    for b in st.mq_brokers:
        if not b.general_logging.bool():
            yield CloudFailure(
                "MQ broker does not enable general logging",
                b.general_logging if b.general_logging.explicit else b.anchor(),
                b.address,
            )


@_check("AVD-AWS-0071", "MQ brokers should enable audit logging",
        "MEDIUM", "mq")
def mq_audit_logging(st: AWSState):
    for b in st.mq_brokers:
        if not b.audit_logging.bool():
            yield CloudFailure(
                "MQ broker does not enable audit logging",
                b.audit_logging if b.audit_logging.explicit else b.anchor(),
                b.address,
            )


@_check("AVD-AWS-0073", "MSK clusters should encrypt client-broker traffic",
        "HIGH", "msk")
def msk_encryption_in_transit(st: AWSState):
    for c in st.msk_clusters:
        if c.client_broker_encryption.str().upper() not in ("TLS",):
            yield CloudFailure(
                "MSK cluster allows plaintext client-broker traffic",
                c.client_broker_encryption
                if c.client_broker_encryption.explicit
                else c.anchor(),
                c.address,
            )


@_check("AVD-AWS-0074", "MSK clusters should enable broker logging",
        "MEDIUM", "msk")
def msk_logging(st: AWSState):
    for c in st.msk_clusters:
        if not c.logging_enabled.bool():
            yield CloudFailure(
                "MSK cluster does not enable broker logging",
                c.logging_enabled if c.logging_enabled.explicit else c.anchor(),
                c.address,
            )


@_check("AVD-AWS-0076", "Neptune clusters should encrypt storage",
        "HIGH", "neptune")
def neptune_storage_encrypted(st: AWSState):
    for n in st.neptune_clusters:
        if not n.storage_encrypted.bool():
            yield CloudFailure(
                "Neptune cluster does not encrypt storage",
                n.storage_encrypted if n.storage_encrypted.explicit else n.anchor(),
                n.address,
            )


@_check("AVD-AWS-0075", "Neptune clusters should export audit logs",
        "MEDIUM", "neptune")
def neptune_log_exports(st: AWSState):
    for n in st.neptune_clusters:
        kinds = {str(v.value) for v in n.log_exports}
        if "audit" not in kinds:
            yield CloudFailure(
                "Neptune cluster does not export audit logs",
                n.log_exports[0] if n.log_exports else n.anchor(),
                n.address,
            )


@_check("AVD-AWS-0128", "Neptune clusters should encrypt with a customer KMS key",
        "LOW", "neptune")
def neptune_kms(st: AWSState):
    for n in st.neptune_clusters:
        if not n.kms_key_id.str():
            yield CloudFailure(
                "Neptune cluster does not use a customer-managed KMS key",
                n.kms_key_id if n.kms_key_id.explicit else n.anchor(),
                n.address,
            )


@_check("AVD-AWS-0109", "WorkSpaces root volumes should be encrypted",
        "HIGH", "workspaces")
def workspaces_root_volume(st: AWSState):
    for w in st.aws_workspaces:
        if not w.root_volume_encrypted.bool():
            yield CloudFailure(
                "WorkSpace root volume is not encrypted",
                w.root_volume_encrypted
                if w.root_volume_encrypted.explicit
                else w.anchor(),
                w.address,
            )


@_check("AVD-AWS-0112", "WorkSpaces user volumes should be encrypted",
        "HIGH", "workspaces")
def workspaces_user_volume(st: AWSState):
    for w in st.aws_workspaces:
        if not w.user_volume_encrypted.bool():
            yield CloudFailure(
                "WorkSpace user volume is not encrypted",
                w.user_volume_encrypted
                if w.user_volume_encrypted.explicit
                else w.anchor(),
                w.address,
            )


@_check("AVD-AWS-0129", "Launch templates should require IMDSv2 tokens",
        "HIGH", "ec2", targets="launch_templates")
def launch_template_imdsv2(st: AWSState):
    for lt in st.launch_templates:
        if lt.http_tokens.str() != "required":
            yield CloudFailure(
                "Launch template does not require IMDSv2 session tokens",
                lt.http_tokens if lt.http_tokens.explicit else lt.anchor(),
                lt.address,
            )


_SERVICE_TARGETS.update({
    "cloudwatch": "log_groups",
    "secretsmanager": "secretsmanager_secrets",
    "dax": "dax_clusters",
})


@_check("AVD-AWS-0017", "CloudWatch log groups should be encrypted with customer KMS keys",
        "LOW", "cloudwatch")
def log_group_cmk(st: AWSState):
    for lg in st.log_groups:
        if not lg.kms_key_id.str():
            yield CloudFailure(
                "Log group is not encrypted with a customer-managed KMS key",
                lg.kms_key_id if lg.kms_key_id.explicit else lg.anchor(),
                lg.address,
            )


@_check("AVD-AWS-0005", "API Gateway domains should use a modern TLS policy",
        "HIGH", "api-gateway", targets="api_gateway_domains")
def apigw_domain_tls(st: AWSState):
    for d in st.api_gateway_domains:
        if d.security_policy.str() != "TLS_1_2":
            yield CloudFailure(
                "API Gateway domain allows TLS versions older than 1.2",
                d.security_policy if d.security_policy.explicit else d.anchor(),
                d.address,
            )


@_check("AVD-AWS-0079", "RDS clusters should encrypt storage", "HIGH", "rds",
        targets="rds_clusters")
def rds_cluster_encrypted(st: AWSState):
    for c in st.rds_clusters:
        if not c.storage_encrypted.bool():
            yield CloudFailure(
                "RDS cluster does not encrypt storage",
                c.storage_encrypted if c.storage_encrypted.explicit else c.anchor(),
                c.address,
            )


@_check("AVD-AWS-0078", "RDS clusters should retain backups beyond one day",
        "MEDIUM", "rds", targets="rds_clusters")
def rds_cluster_backup(st: AWSState):
    for c in st.rds_clusters:
        if c.backup_retention.int(1) <= 1:
            yield CloudFailure(
                "RDS cluster keeps the default 1-day backup retention",
                c.backup_retention if c.backup_retention.explicit else c.anchor(),
                c.address,
            )


@_check("AVD-AWS-0098", "Secrets Manager secrets should use customer KMS keys",
        "LOW", "secretsmanager")
def secretsmanager_cmk(st: AWSState):
    for s in st.secretsmanager_secrets:
        if not s.kms_key_id.str():
            yield CloudFailure(
                "Secret is not encrypted with a customer-managed KMS key",
                s.kms_key_id if s.kms_key_id.explicit else s.anchor(),
                s.address,
            )


@_check("AVD-AWS-0023", "DAX clusters should enable server-side encryption",
        "HIGH", "dax")
def dax_sse(st: AWSState):
    for d in st.dax_clusters:
        if not d.sse_enabled.bool():
            yield CloudFailure(
                "DAX cluster does not enable server-side encryption",
                d.sse_enabled if d.sse_enabled.explicit else d.anchor(),
                d.address,
            )


@_check("AVD-AWS-0134", "EBS default encryption should be enabled", "HIGH",
        "ec2", targets="ebs_default_encryption")
def ebs_default_encryption(st: AWSState):
    for e in st.ebs_default_encryption:
        if not e.enabled.bool(True):
            yield CloudFailure(
                "EBS encryption-by-default is explicitly disabled",
                e.enabled, e.address,
            )


@_check("AVD-AWS-0132", "S3 buckets should be encrypted with customer KMS keys",
        "LOW", "s3")
def s3_cmk(st: AWSState):
    for b in st.s3_buckets:
        if b.encryption_enabled.bool() and not b.kms_key_id.str():
            yield CloudFailure(
                "Bucket encryption does not use a customer-managed KMS key",
                b.kms_key_id if b.kms_key_id.explicit else b.anchor(),
                b.address,
            )


@_check("AVD-AWS-0099", "Security groups should have descriptions", "LOW",
        "ec2", targets="security_groups")
def sg_description(st: AWSState):
    for sg in st.security_groups:
        if not sg.description.str():
            yield CloudFailure(
                "Security group has no description",
                sg.description if sg.description.explicit else sg.anchor(),
                sg.address,
            )


@_check("AVD-AWS-0135", "ECS containers should not run privileged", "HIGH",
        "ecs")
def ecs_no_privileged(st: AWSState):
    for td in st.ecs_task_definitions:
        defs = td.container_definitions.value
        if not isinstance(defs, list):
            continue
        for cd in defs:
            if isinstance(cd, dict) and cd.get("privileged") is True:
                yield CloudFailure(
                    f"Container {cd.get('name', '?')!r} runs privileged",
                    td.container_definitions, td.address,
                )


@_check("AVD-AWS-0176", "RDS instances should enable IAM database authentication",
        "MEDIUM", "rds")
def rds_iam_auth(st: AWSState):
    for db in st.rds_instances:
        if not db.iam_auth.bool():
            yield CloudFailure(
                "RDS instance does not enable IAM database authentication",
                db.iam_auth if db.iam_auth.explicit else db.anchor(),
                db.address,
            )


@_check("AVD-AWS-0177", "RDS instances should enable deletion protection",
        "MEDIUM", "rds")
def rds_deletion_protection(st: AWSState):
    for db in st.rds_instances:
        if not db.deletion_protection.bool():
            yield CloudFailure(
                "RDS instance does not enable deletion protection",
                db.deletion_protection
                if db.deletion_protection.explicit
                else db.anchor(),
                db.address,
            )


@_check("AVD-AWS-0178", "CloudWatch log groups should define a retention period",
        "LOW", "cloudwatch")
def log_group_retention(st: AWSState):
    for lg in st.log_groups:
        if lg.retention_days.int() == 0:
            yield CloudFailure(
                "Log group retains logs forever (no retention period)",
                lg.retention_days if lg.retention_days.explicit else lg.anchor(),
                lg.address,
            )
