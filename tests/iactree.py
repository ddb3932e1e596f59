"""Seeded infrastructure-as-code trees of the types a CloudFormation and
Helm scan reads: CloudFormation templates in YAML (short tags) and JSON
(``Fn::`` forms) with parameters, mappings, conditions and every intrinsic
the engine resolves; Helm charts with ``_helpers.tpl``, ``values.yaml``,
nested ``include``, ``tpl``, ``range`` over maps, ``with``, ``toYaml`` and
``nindent``; a Dockerfile inside a chart and one beside it, a manifest
inside a chart root, standalone manifests, a Terraform root and an ARM
template. ``write_iac_tree`` plants credentials in given files.

Used by the port's tests (``tests/test_torch_cloudformation.py``,
``tests/test_torch_helm.py``) and by ``chip_smoke.py`` phase ``misconf``.
The module imports neither package, so the card's tests and the smoke load
it by path.
"""

from __future__ import annotations

import json
import random
from pathlib import Path

# an ARM template with a failing storage account (tests/test_iac.py's)
ARM_TEMPLATE = """\
{
  "$schema": "https://schema.management.azure.com/schemas/2019-04-01/deploymentTemplate.json#",
  "parameters": {"prefix": {"type": "string", "defaultValue": "corp"}},
  "variables": {"name": "[toLower(concat(parameters('prefix'), 'Store'))]"},
  "resources": [
    {
      "type": "Microsoft.Storage/storageAccounts",
      "name": "[variables('name')]",
      "properties": {
        "supportsHttpsTrafficOnly": false,
        "minimumTlsVersion": "TLS1_2"
      }
    }
  ]
}
"""
# the ids the seeded tree reports as failures, whatever the seed
CFN_IDS = {"AVD-AWS-0014", "AVD-AWS-0088", "AVD-AWS-0107", "AVD-AWS-0177"}
HELM_IDS = {"KSV017"}


def cfn_yaml(rng: random.Random, i: int) -> str:
    """A stack in YAML with short-form intrinsics."""
    env = rng.choice(["prod", "dev"])
    acl = rng.choice(["PublicRead", "Private", "PublicReadWrite"])
    port = rng.choice([22, 3389, 443])
    ami = "".join(rng.choice("0123456789abcdef") for _ in range(8))
    return f"""AWSTemplateFormatVersion: "2010-09-09"
Description: stack {i}
Parameters:
  Env:
    Type: String
    Default: {env}
  KeyArn:
    Type: String
  Subnets:
    Type: CommaDelimitedList
    Default: "subnet-a,subnet-b"
Mappings:
  RegionMap:
    us-east-1:
      Ami: ami-{ami}
    eu-west-1:
      Ami: ami-0000
Conditions:
  IsProd: !Equals [!Ref Env, prod]
  HasKey: !Not [!Equals [!Ref KeyArn, ""]]
  ProdWithKey: !And [!Condition IsProd, !Condition HasKey]
  AnyProd: !Or [!Condition IsProd, !Equals [!Ref "AWS::Region", eu-west-1]]
  Never: !Equals [a, b]
Resources:
  Data{i}:
    Type: AWS::S3::Bucket
    Properties:
      BucketName: !Sub "${{Env}}-data-${{AWS::Region}}-{i}"
      AccessControl: {acl}
      VersioningConfiguration:
        Status: !If [IsProd, Enabled, Suspended]
      BucketEncryption:
        ServerSideEncryptionConfiguration:
          - ServerSideEncryptionByDefault:
              SSEAlgorithm: !If [HasKey, "aws:kms", AES256]
              KMSMasterKeyID: !If [HasKey, !Ref KeyArn, !Ref "AWS::NoValue"]
      LoggingConfiguration:
        DestinationBucketName: !Sub "logs-${{AWS::AccountId}}"
      Tags:
        - Key: name
          Value: !Join ["-", [!Ref Env, !Select [0, !Split [",", "a,b"]]]]
        - Key: stack
          Value: !Sub ["${{Name}}-{i}", {{Name: !Ref "AWS::StackName"}}]
  Sg{i}:
    Type: AWS::EC2::SecurityGroup
    Properties:
      GroupDescription: !Sub "sg of ${{AWS::StackName}}"
      SecurityGroupIngress:
        - IpProtocol: tcp
          FromPort: {port}
          ToPort: {port}
          CidrIp: 0.0.0.0/0
        - IpProtocol: tcp
          FromPort: 443
          ToPort: 443
          CidrIp: !If [AnyProd, 10.0.0.0/8, 0.0.0.0/0]
      SecurityGroupEgress:
        - IpProtocol: "-1"
          CidrIp: 0.0.0.0/0
  Vm{i}:
    Type: AWS::EC2::Instance
    Properties:
      ImageId: !FindInMap [RegionMap, !Ref "AWS::Region", Ami]
      UserData:
        Fn::Base64: !Sub "echo ${{Env}} > /etc/env"
      SecurityGroupIds: [!GetAtt Sg{i}.GroupId]
      SubnetId: !Select [1, !Ref Subnets]
      MetadataOptions:
        HttpTokens: !If [ProdWithKey, required, optional]
  Skipped{i}:
    Type: AWS::S3::Bucket
    Condition: Never
    Properties:
      AccessControl: PublicRead
  Trail{i}:
    Type: AWS::CloudTrail::Trail
    Properties:
      IsLogging: true
      S3BucketName: !Ref Data{i}
      IsMultiRegionTrail: !If [IsProd, true, false]
      KMSKeyId: !ImportValue shared-key
      CloudWatchLogsLogGroupArn: !GetAtt "Logs{i}.Arn"
  Logs{i}:
    Type: AWS::Logs::LogGroup
    Properties:
      RetentionInDays: {rng.choice([7, 30, 365])}
  Queue{i}:
    Type: AWS::SQS::Queue
    Properties:
      QueueName: !Sub "q-${{Env}}"
Outputs:
  Bucket:
    Value: !Ref Data{i}
"""


def cfn_json(rng: random.Random, i: int) -> str:
    """A stack in JSON with the ``Fn::`` forms."""
    public = rng.random() < 0.5
    doc = {
        "AWSTemplateFormatVersion": "2010-09-09",
        "Parameters": {"Env": {"Type": "String", "Default": rng.choice(["prod", "stage"])},
                       "DbPassword": {"Type": "String", "NoEcho": True}},
        "Conditions": {"IsProd": {"Fn::Equals": [{"Ref": "Env"}, "prod"]},
                       "Unknown": {"Fn::Equals": [{"Ref": "DbPassword"}, "x"]}},
        "Resources": {
            f"Db{i}": {
                "Type": "AWS::RDS::DBInstance",
                "Properties": {
                    "Engine": "postgres",
                    "DBInstanceClass": "db.t3.micro",
                    "PubliclyAccessible": public,
                    "StorageEncrypted": {"Fn::If": ["IsProd", True, False]},
                    "BackupRetentionPeriod": {"Fn::If": ["Unknown", 7, 0]},
                    "MasterUserPassword": {"Ref": "DbPassword"},
                    "DBName": {"Fn::Join": ["_", [{"Ref": "Env"}, "app"]]},
                },
            },
            f"Topic{i}": {
                "Type": "AWS::SNS::Topic",
                "Properties": {"TopicName": {"Fn::Sub": "alerts-${AWS::Region}-${Env}"}},
            },
            f"Key{i}": {
                "Type": "AWS::KMS::Key",
                "Properties": {"EnableKeyRotation": {"Fn::If": ["IsProd", True, False]}},
            },
            f"Bucket{i}": {
                "Type": "AWS::S3::Bucket",
                "Properties": {
                    "AccessControl": "PublicRead" if public else "Private",
                    "PublicAccessBlockConfiguration": {
                        "BlockPublicAcls": not public, "BlockPublicPolicy": not public,
                        "IgnorePublicAcls": False, "RestrictPublicBuckets": False},
                    "Tags": [{"Key": "arn", "Value": {"Fn::GetAtt": [f"Key{i}", "Arn"]}}],
                },
            },
        },
    }
    return json.dumps(doc, indent=2) + "\n"


CHART_YAML = """apiVersion: v2
name: {name}
description: A chart of the {name} service
version: 0.{i}.0
appVersion: "1.{i}"
"""

HELPERS_TPL = """{{{{/*
Names and labels of the {name} chart.
*/}}}}
{{{{- define "{name}.name" -}}}}
{{{{- default .Chart.Name .Values.nameOverride | trunc 63 | trimSuffix "-" }}}}
{{{{- end }}}}

{{{{- define "{name}.fullname" -}}}}
{{{{- if .Values.fullnameOverride }}}}
{{{{- .Values.fullnameOverride | trunc 63 | trimSuffix "-" }}}}
{{{{- else }}}}
{{{{- printf "%s-%s" .Release.Name (include "{name}.name" .) | trunc 63 | trimSuffix "-" }}}}
{{{{- end }}}}
{{{{- end }}}}

{{{{- define "{name}.selector" -}}}}
app.kubernetes.io/name: {{{{ include "{name}.name" . }}}}
app.kubernetes.io/instance: {{{{ .Release.Name }}}}
{{{{- end }}}}

{{{{- define "{name}.labels" -}}}}
{{{{ include "{name}.selector" . }}}}
app.kubernetes.io/version: {{{{ .Chart.AppVersion | quote }}}}
helm.sh/chart: {{{{ printf "%s-%s" .Chart.Name .Chart.Version }}}}
{{{{- with .Values.commonLabels }}}}
{{{{ tpl . $ }}}}
{{{{- end }}}}
{{{{- end }}}}
"""

DEPLOYMENT_YAML = """apiVersion: apps/v1
kind: Deployment
metadata:
  name: {{{{ include "{name}.fullname" . }}}}
  labels:
    {{{{- include "{name}.labels" . | nindent 4 }}}}
spec:
  replicas: {{{{ .Values.replicaCount }}}}
  selector:
    matchLabels:
      {{{{- include "{name}.selector" . | nindent 6 }}}}
  template:
    metadata:
      labels:
        {{{{- include "{name}.selector" . | nindent 8 }}}}
      {{{{- with .Values.podAnnotations }}}}
      annotations:
        {{{{- toYaml . | nindent 8 }}}}
      {{{{- end }}}}
    spec:
      {{{{- if .Values.hostNetwork }}}}
      hostNetwork: true
      {{{{- end }}}}
      containers:
        - name: {{{{ .Chart.Name }}}}
          image: "{{{{ .Values.image.repository }}}}:{{{{ .Values.image.tag | default .Chart.AppVersion }}}}"
          imagePullPolicy: {{{{ .Values.image.pullPolicy }}}}
          securityContext:
            {{{{- toYaml .Values.securityContext | nindent 12 }}}}
          env:
            {{{{- range $key, $val := .Values.env }}}}
            - name: {{{{ $key | upper }}}}
              value: {{{{ $val | quote }}}}
            {{{{- end }}}}
          ports:
            {{{{- range .Values.ports }}}}
            - containerPort: {{{{ . }}}}
            {{{{- end }}}}
          {{{{- with .Values.resources }}}}
          resources:
            {{{{- toYaml . | nindent 12 }}}}
          {{{{- end }}}}
"""

SERVICE_YAML = """apiVersion: v1
kind: Service
metadata:
  name: {{{{ include "{name}.fullname" . }}}}
  labels:
    {{{{- include "{name}.labels" . | nindent 4 }}}}
spec:
  type: {{{{ .Values.service.type | default "ClusterIP" }}}}
  ports:
    - port: {{{{ .Values.service.port }}}}
      targetPort: {{{{ .Values.service.port }}}}
      name: {{{{ printf "http-%d" .Values.service.port }}}}
  selector:
    {{{{- include "{name}.selector" . | nindent 4 }}}}
"""

CONFIGMAP_YAML = """apiVersion: v1
kind: ConfigMap
metadata:
  name: {{{{ include "{name}.fullname" . }}}}-config
data:
  {{{{- range $k, $v := .Values.config }}}}
  {{{{ $k }}}}: {{{{ $v | quote }}}}
  {{{{- end }}}}
  checksum: {{{{ .Values.config | toJson | sha256sum | trunc 12 | quote }}}}
"""

JOB_YAML = """{{{{- if .Values.migrate.enabled }}}}
apiVersion: batch/v1
kind: Job
metadata:
  name: {{{{ include "{name}.fullname" . }}}}-migrate
spec:
  template:
    spec:
      restartPolicy: Never
      containers:
        - name: migrate
          image: {{{{ .Values.migrate.image | default "busybox:1.36" }}}}
          command: [{{{{ .Values.migrate.command | join ", " }}}}]
          securityContext:
            runAsUser: {{{{ .Values.migrate.uid }}}}
{{{{- end }}}}
"""


def chart_values(rng: random.Random, i: int, secret: str | None = None) -> str:
    privileged = "true" if i == 0 or rng.random() < 0.5 else "false"
    env_keys = rng.sample(["log_level", "mode", "region", "tier", "feature_x"], 3)
    env = "\n".join(f"  {k}: {rng.choice(['debug', 'prod', 'eu', 'on', '1'])}"
                    for k in sorted(env_keys))
    ports = ", ".join(str(p) for p in rng.sample([80, 8080, 8443, 9090, 22], 2))
    token = f"  apiToken: {secret}\n" if secret else ""
    return f"""replicaCount: {rng.randint(1, 5)}
nameOverride: ""
fullnameOverride: ""
image:
  repository: registry.example.com/app{i}
  tag: "{rng.choice(['', 'latest', '2.1.0'])}"
  pullPolicy: {rng.choice(['IfNotPresent', 'Always'])}
hostNetwork: {'true' if rng.random() < 0.3 else 'false'}
service:
  type: {rng.choice(['ClusterIP', 'NodePort', ''])}
  port: {rng.choice([80, 8080])}
podAnnotations:
  prometheus.io/scrape: "true"
  prometheus.io/port: "9113"
securityContext:
  privileged: {privileged}
  runAsNonRoot: {rng.choice(['true', 'false'])}
env:
{env}
ports: [{ports}]
resources:
  limits:
    memory: {rng.choice(['128Mi', '1Gi'])}
config:
  timeout: "{rng.randint(1, 60)}s"
  retries: "{rng.randint(0, 5)}"
{token}commonLabels: 'team: "t{i}"'
migrate:
  enabled: {'true' if rng.random() < 0.7 else 'false'}
  command: ["/bin/sh", "-c", "migrate up"]
  uid: {rng.choice([0, 1000])}
"""


def write_chart(root: Path, name: str, rng: random.Random, i: int,
                secret: str | None = None) -> None:
    """A chart under ``root/name``: its templates, values and helpers, a
    manifest and a Dockerfile beside them."""
    d = root / name
    files = {
        "Chart.yaml": CHART_YAML.format(name=name, i=i),
        "values.yaml": chart_values(rng, i, secret),
        "templates/_helpers.tpl": HELPERS_TPL.format(name=name),
        "templates/deployment.yaml": DEPLOYMENT_YAML.format(name=name),
        "templates/service.yaml": SERVICE_YAML.format(name=name),
        "templates/configmap.yaml": CONFIGMAP_YAML.format(name=name),
        "templates/job.yaml": JOB_YAML.format(name=name),
        "templates/NOTES.txt": f"Thanks for installing {name}.\n",
        # chart yaml outside templates/ installs verbatim
        "crds/pod.yaml": ("apiVersion: v1\nkind: Pod\nmetadata:\n  name: probe\nspec:\n"
                          "  containers:\n    - name: c\n      image: busybox\n"
                          "      securityContext:\n        privileged: true\n"),
        # a Dockerfile inside the chart keeps its own pass
        "Dockerfile": "FROM alpine:latest\nRUN apk add curl\nUSER root\n",
    }
    for rel, text in files.items():
        (d / rel).parent.mkdir(parents=True, exist_ok=True)
        (d / rel).write_text(text)


def write_iac_tree(root: Path, seed: int, stacks: int = 2, charts: int = 2,
                   secrets: dict[str, str] | None = None) -> dict:
    """A tree of ``stacks`` CloudFormation stacks in YAML and as many in
    JSON, ``charts`` Helm charts, a Dockerfile beside the charts, manifests,
    a Terraform root and an ARM template. ``secrets`` maps a rule to the
    credential planted for it: ``aws`` in a stack's parameter default,
    ``github`` in the first chart's values, any other in ``.env``. Returns
    the counts of each kind of file."""
    rng = random.Random(seed)
    secrets = dict(secrets or {})
    root.mkdir(parents=True, exist_ok=True)
    for i in range(stacks):
        text = cfn_yaml(rng, i)
        if i == 0 and "aws" in secrets:
            text = text.replace("  KeyArn:\n    Type: String\n",
                                f"  KeyArn:\n    Type: String\n  LegacyKey:\n    Type: String\n"
                                f"    Default: {secrets.pop('aws')}\n")
        (root / "cfn").mkdir(exist_ok=True)
        (root / "cfn" / f"stack{i}.yaml").write_text(text)
        (root / "cfn" / f"stack{i}.json").write_text(cfn_json(rng, i))
    for i in range(charts):
        write_chart(root / "charts", f"svc{i}", rng, i,
                    secrets.pop("github", None) if i == 0 else None)
    (root / "charts" / "Dockerfile").write_text(
        "FROM golang:1.22 AS build\nRUN go build -o /app ./cmd\nFROM alpine:3.19\n"
        "COPY --from=build /app /app\nENTRYPOINT [\"/app\"]\n")
    (root / "deploy").mkdir(exist_ok=True)
    (root / "deploy" / "web.yaml").write_text(
        "apiVersion: apps/v1\nkind: Deployment\nmetadata:\n  name: web\nspec:\n"
        "  template:\n    spec:\n      hostPID: true\n      containers:\n"
        "      - name: app\n        image: nginx:latest\n")
    (root / "infra").mkdir(exist_ok=True)
    (root / "infra" / "main.tf").write_text(
        'resource "aws_s3_bucket" "logs" {\n  bucket = "acme-logs"\n  acl    = "public-read"\n}\n')
    (root / "arm").mkdir(exist_ok=True)
    (root / "arm" / "template.json").write_text(ARM_TEMPLATE)
    for rule, value in secrets.items():
        with open(root / ".env", "a", encoding="utf-8") as f:
            f.write(f"{rule.upper()}_TOKEN={value}\n")
    return {"stacks": 2 * stacks, "charts": charts}
