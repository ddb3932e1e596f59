"""A seeded Terraform monorepo, the shape of a real infrastructure
repository: module directories under ``modules/`` and environment roots
under ``envs/`` that call them, with ``count``, ``for_each``, ``dynamic``
blocks, cross-resource references, ``terraform.tfvars``, ``.tf.json``,
resources of aws, google, azurerm, github and the five smaller providers,
a ``terraform show -json`` plan and two ARM templates.

    write_tf_monorepo(root, seed, modules=48, envs=12, blocks=32, secrets={...})

``modules=48, envs=12, blocks=32`` writes 360 ``.tf`` files and 2 MiB
of HCL. ``secrets`` maps a place (``aws``, ``github``, ``gitlab``,
``slack``) to a token planted in a provider block or a ``.tfvars`` file.
The module imports neither package, so the CPU tests import it and
``chip_smoke.py`` loads it by path.
"""

from __future__ import annotations

import json
import random
from pathlib import Path

# a resource block per template; @N@ is the block's name, @V@ picks a
# seeded variant: "a|b" -> a or b
AWS = [
    '''resource "aws_s3_bucket" "@N@" {
  bucket        = "${var.name}-@N@"
  acl           = "@V:public-read|private|private@"
  force_destroy = false
  tags          = merge(local.tags, { Component = "@N@" })

  versioning {
    enabled = @V:true|false@
  }

  logging {
    target_bucket = "${var.name}-logs"
    target_prefix = "s3/@N@/"
  }
}

resource "aws_s3_bucket_public_access_block" "@N@" {
  bucket                  = aws_s3_bucket.@N@.id
  block_public_acls       = @V:true|false@
  block_public_policy     = true
  ignore_public_acls      = @V:true|false@
  restrict_public_buckets = true
}
''',
    '''resource "aws_security_group" "@N@" {
  name        = "${var.name}-@N@"
  description = "Ingress for the @N@ tier"
  vpc_id      = var.vpc_id

  dynamic "ingress" {
    for_each = var.ports
    content {
      description = "port ${ingress.value}"
      from_port   = ingress.value
      to_port     = ingress.value
      protocol    = "tcp"
      cidr_blocks = ["@V:0.0.0.0/0|10.0.0.0/8|172.16.0.0/12@"]
    }
  }

  egress {
    description = "all egress"
    from_port   = 0
    to_port     = 0
    protocol    = "-1"
    cidr_blocks = ["0.0.0.0/0"]
  }

  tags = local.tags
}
''',
    '''resource "aws_instance" "@N@" {
  count         = var.replicas
  ami           = var.ami
  instance_type = "t3.@V:micro|small|large@"
  subnet_id     = element(var.subnets, count.index)

  metadata_options {
    http_tokens   = "@V:optional|required@"
    http_endpoint = "enabled"
  }

  root_block_device {
    encrypted   = @V:true|false@
    volume_size = 40
  }

  tags = merge(local.tags, { Name = "${var.name}-@N@-${count.index}" })
}
''',
    '''resource "aws_db_instance" "@N@" {
  identifier              = "${var.name}-@N@"
  engine                  = "postgres"
  instance_class          = "db.t3.medium"
  allocated_storage       = 50
  storage_encrypted       = @V:true|false@
  publicly_accessible     = @V:false|true@
  backup_retention_period = @V:0|7|14@
  iam_database_authentication_enabled = @V:true|false@
  performance_insights_enabled        = true
  tags                    = local.tags
}
''',
    '''resource "aws_ebs_volume" "@N@" {
  availability_zone = var.zone
  size              = 100
  encrypted         = @V:true|false@
  tags              = local.tags
}

resource "aws_kms_key" "@N@" {
  description         = "key for @N@"
  enable_key_rotation = @V:true|false@
}
''',
    '''resource "aws_sqs_queue" "@N@" {
  for_each                  = var.queues
  name                      = "${var.name}-${each.key}"
  message_retention_seconds = each.value
  kms_master_key_id         = @V:"alias/aws/sqs"|null@
}

resource "aws_sns_topic" "@N@" {
  name              = "${var.name}-@N@"
  kms_master_key_id = @V:"alias/aws/sns"|null@
}
''',
    '''resource "aws_cloudtrail" "@N@" {
  name                       = "${var.name}-@N@"
  s3_bucket_name             = "${var.name}-trail"
  is_multi_region_trail      = @V:true|false@
  enable_log_file_validation = @V:true|false@
  kms_key_id                 = var.kms_key
}

resource "aws_cloudwatch_log_group" "@N@" {
  name              = "/aws/${var.name}/@N@"
  retention_in_days = 30
}
''',
    '''resource "aws_lambda_function" "@N@" {
  function_name = "${var.name}-@N@"
  role          = var.role_arn
  handler       = "index.handler"
  runtime       = "python3.12"

  tracing_config {
    mode = "@V:Active|PassThrough@"
  }

  environment {
    variables = {
      STAGE = var.name
    }
  }
}

resource "aws_iam_policy" "@N@" {
  name   = "${var.name}-@N@"
  policy = jsonencode({
    Version = "2012-10-17"
    Statement = [{
      Effect   = "Allow"
      Action   = ["@V:s3:*|s3:GetObject@"]
      Resource = ["@V:*|arn:aws:s3:::bucket/*@"]
    }]
  })
}
''',
]
GOOGLE = [
    '''resource "google_storage_bucket" "@N@" {
  name                        = "${var.name}-@N@"
  location                    = "EU"
  uniform_bucket_level_access = @V:false|true@
  labels                      = local.labels
}

resource "google_storage_bucket_iam_member" "@N@" {
  bucket = google_storage_bucket.@N@.name
  role   = "roles/storage.objectViewer"
  member = "@V:allUsers|domain:example.com@"
}
''',
    '''resource "google_compute_instance" "@N@" {
  count        = var.replicas
  name         = "${var.name}-@N@-${count.index}"
  machine_type = "e2-medium"
  zone         = var.zone
  can_ip_forward = @V:true|false@

  boot_disk {
    initialize_params {
      image = "debian-cloud/debian-12"
    }
  }

  network_interface {
    network = "default"
  }

  shielded_instance_config {
    enable_secure_boot          = @V:true|false@
    enable_integrity_monitoring = true
  }

  metadata = {
    enable-oslogin         = "@V:TRUE|FALSE@"
    block-project-ssh-keys = "@V:true|false@"
  }
}
''',
    '''resource "google_compute_firewall" "@N@" {
  name          = "${var.name}-@N@"
  network       = "default"
  source_ranges = ["@V:0.0.0.0/0|10.10.0.0/16@"]

  allow {
    protocol = "tcp"
    ports    = var.ports
  }
}
''',
    '''resource "google_container_cluster" "@N@" {
  name               = "${var.name}-@N@"
  location           = var.zone
  enable_legacy_abac = @V:true|false@
  resource_labels    = local.labels

  master_authorized_networks_config {
    cidr_blocks {
      cidr_block = "10.0.0.0/8"
    }
  }
}
''',
    '''resource "google_sql_database_instance" "@N@" {
  name             = "${var.name}-@N@"
  database_version = "POSTGRES_15"

  settings {
    tier = "db-custom-2-7680"
    ip_configuration {
      ipv4_enabled = @V:true|false@
      require_ssl  = @V:false|true@
    }
    database_flags {
      name  = "log_connections"
      value = "@V:off|on@"
    }
  }
}

resource "google_project_iam_member" "@N@" {
  project = var.project
  role    = "@V:roles/owner|roles/viewer@"
  member  = "serviceAccount:@N@@${var.project}.iam.gserviceaccount.com"
}
''',
]
AZURE = [
    '''resource "azurerm_storage_account" "@N@" {
  name                      = "${var.name}@N@"
  resource_group_name       = var.resource_group
  location                  = var.location
  account_tier              = "Standard"
  account_replication_type  = "GRS"
  enable_https_traffic_only = @V:false|true@
  min_tls_version           = "@V:TLS1_0|TLS1_2@"
  tags                      = local.tags

  network_rules {
    default_action = "@V:Allow|Deny@"
  }
}
''',
    '''resource "azurerm_key_vault" "@N@" {
  name                       = "${var.name}-@N@"
  location                   = var.location
  resource_group_name        = var.resource_group
  tenant_id                  = var.tenant_id
  sku_name                   = "standard"
  purge_protection_enabled   = @V:false|true@
  soft_delete_retention_days = 7

  network_acls {
    default_action = "@V:Allow|Deny@"
    bypass         = "AzureServices"
  }
}
''',
    '''resource "azurerm_kubernetes_cluster" "@N@" {
  name                = "${var.name}-@N@"
  location            = var.location
  resource_group_name = var.resource_group
  dns_prefix          = "@N@"
  private_cluster_enabled = @V:false|true@

  default_node_pool {
    name       = "default"
    node_count = var.replicas
    vm_size    = "Standard_D2_v2"
  }

  network_profile {
    network_plugin = "azure"
    network_policy = "@V:calico|azure@"
  }
}
''',
    '''resource "azurerm_network_security_rule" "@N@" {
  name                        = "${var.name}-@N@"
  priority                    = 100
  direction                   = "Inbound"
  access                      = "Allow"
  protocol                    = "Tcp"
  source_port_range           = "*"
  destination_port_range      = "@V:22|3389|443@"
  source_address_prefix       = "@V:*|10.0.0.0/8@"
  destination_address_prefix  = "*"
  resource_group_name         = var.resource_group
  network_security_group_name = "${var.name}-nsg"
}
''',
    '''resource "azurerm_mssql_server" "@N@" {
  name                          = "${var.name}-@N@"
  resource_group_name           = var.resource_group
  location                      = var.location
  version                       = "12.0"
  minimum_tls_version           = "@V:1.0|1.2@"
  public_network_access_enabled = @V:true|false@
}
''',
]
GITHUB = [
    '''resource "github_repository" "@N@" {
  name                 = "${var.name}-@N@"
  description          = "service @N@"
  visibility           = "@V:public|private|internal@"
  vulnerability_alerts = @V:true|false@
  has_issues           = true
}

resource "github_branch_protection" "@N@" {
  repository_id          = github_repository.@N@.node_id
  pattern                = "main"
  require_signed_commits = @V:true|false@
}
''',
    '''resource "github_actions_environment_secret" "@N@" {
  repository      = "${var.name}-@N@"
  environment     = "production"
  secret_name     = "DEPLOY_KEY"
  plaintext_value = @V:"plain-@N@"|null@
}
''',
]
DIGITALOCEAN = [
    '''resource "digitalocean_droplet" "@N@" {
  count    = var.replicas
  name     = "${var.name}-@N@-${count.index}"
  image    = "ubuntu-22-04-x64"
  size     = "s-1vcpu-1gb"
  ssh_keys = @V:[]|["ab:cd:ef"]@
}

resource "digitalocean_firewall" "@N@" {
  name = "${var.name}-@N@"

  inbound_rule {
    protocol         = "tcp"
    port_range       = "22"
    source_addresses = ["@V:0.0.0.0/0|10.0.0.0/8@"]
  }
}
''',
    '''resource "digitalocean_spaces_bucket" "@N@" {
  name   = "${var.name}-@N@"
  region = "fra1"
  acl    = "@V:public-read|private@"

  versioning {
    enabled = @V:true|false@
  }
}

resource "digitalocean_loadbalancer" "@N@" {
  name   = "${var.name}-@N@"
  region = "fra1"

  forwarding_rule {
    entry_protocol  = "@V:http|https@"
    entry_port      = 443
    target_protocol = "http"
    target_port     = 80
  }
}
''',
]
OPENSTACK = [
    '''resource "openstack_compute_instance_v2" "@N@" {
  name       = "${var.name}-@N@"
  flavor_id  = "3"
  admin_pass = @V:"changeme-@N@"|null@
}

resource "openstack_networking_secgroup_rule_v2" "@N@" {
  direction         = "ingress"
  ethertype         = "IPv4"
  protocol          = "tcp"
  port_range_min    = 22
  port_range_max    = 22
  remote_ip_prefix  = "@V:0.0.0.0/0|10.0.0.0/8@"
  security_group_id = var.secgroup
}
''',
]
ORACLE = [
    '''resource "opc_compute_ip_address_reservation" "@N@" {
  name            = "${var.name}-@N@"
  ip_address_pool = "@V:public-ippool|cloud-ippool@"
}
''',
]
CLOUDSTACK = [
    '''resource "cloudstack_instance" "@N@" {
  name             = "${var.name}-@N@"
  service_offering = "small"
  template         = "debian-12"
  zone             = var.zone
  user_data        = "@V:export DATABASE_PASSWORD=changeme|echo hello@"
}
''',
]
NIFCLOUD = [
    '''resource "nifcloud_security_group" "@N@" {
  group_name  = "${var.name}@N@"
  description = @V:""|"frontend"@
}

resource "nifcloud_security_group_rule" "@N@" {
  security_group_names = [nifcloud_security_group.@N@.group_name]
  type                 = "IN"
  from_port            = 443
  to_port              = 443
  protocol             = "TCP"
  cidr_ip              = "@V:0.0.0.0/0|10.0.0.0/8@"
}
''',
    '''resource "nifcloud_db_instance" "@N@" {
  identifier          = "${var.name}-@N@"
  instance_class      = "db.large8"
  publicly_accessible = @V:true|false@
}

resource "nifcloud_elb" "@N@" {
  elb_name = "${var.name}@N@"
  protocol = "@V:HTTP|HTTPS@"
  lb_port  = 443
}
''',
]
# (module kind, its resource templates, its provider block)
KINDS = [
    ("aws", AWS, 'provider "aws" {\n  region = var.region\n}\n'),
    ("google", GOOGLE, 'provider "google" {\n  project = var.project\n  region  = var.region\n}\n'),
    ("azurerm", AZURE, 'provider "azurerm" {\n  features {}\n}\n'),
    ("aws", AWS, 'provider "aws" {\n  region = var.region\n}\n'),
    ("github", GITHUB, 'provider "github" {\n  owner = var.name\n}\n'),
    ("digitalocean", DIGITALOCEAN, 'provider "digitalocean" {}\n'),
    ("openstack", OPENSTACK, 'provider "openstack" {}\n'),
    ("oracle", ORACLE, 'provider "opc" {}\n'),
    ("cloudstack", CLOUDSTACK, 'provider "cloudstack" {}\n'),
    ("nifcloud", NIFCLOUD, 'provider "nifcloud" {\n  region = "jp-east-1"\n}\n'),
    ("google", GOOGLE, 'provider "google" {\n  project = var.project\n  region  = var.region\n}\n'),
    ("azurerm", AZURE, 'provider "azurerm" {\n  features {}\n}\n'),
]
VARIABLES = '''variable "name" {
  description = "Name prefix of every resource in this module"
  type        = string
}

variable "replicas" {
  description = "Instances of each replicated resource"
  type        = number
  default     = 1
}

variable "ports" {
  description = "Ports opened by the ingress rules"
  type        = list(number)
  default     = [443]
}

variable "queues" {
  description = "Queue name to retention seconds"
  type        = map(number)
  default     = {}
}

variable "tags" {
  type    = map(string)
  default = {}
}

variable "region" {
  type    = string
  default = "eu-west-1"
}

variable "zone" {
  type    = string
  default = "eu-west-1a"
}

variable "project" {
  type    = string
  default = "acme-prod"
}

variable "location" {
  type    = string
  default = "westeurope"
}

variable "resource_group" {
  type    = string
  default = "rg-platform"
}

variable "tenant_id" {
  type    = string
  default = "00000000-0000-0000-0000-000000000000"
}

variable "vpc_id" {
  type    = string
  default = "vpc-0123456789"
}

variable "subnets" {
  type    = list(string)
  default = ["subnet-a", "subnet-b", "subnet-c"]
}

variable "ami" {
  type    = string
  default = "ami-0abcdef1234567890"
}

variable "kms_key" {
  type    = string
  default = null
}

variable "role_arn" {
  type    = string
  default = "arn:aws:iam::123456789012:role/lambda"
}

variable "secgroup" {
  type    = string
  default = "default"
}
'''
LOCALS = '''locals {
  tags = merge(var.tags, {
    Module    = "@M@"
    ManagedBy = "terraform"
  })
  labels = { for k, v in local.tags : lower(k) => lower(replace(v, "/[^a-z0-9-]/", "-")) }
}
'''
HEADER = "# Module @M@ ({kind}): {what}.\n# Generated layout of a platform team's shared modules.\n\n"


def _variant(rng: random.Random, text: str) -> str:
    out, i = [], 0
    while True:
        j = text.find("@V:", i)
        if j < 0:
            out.append(text[i:])
            return "".join(out)
        k = text.index("@", j + 3)
        out.append(text[i:j])
        out.append(rng.choice(text[j + 3:k].split("|")))
        i = k + 1


def _blocks(rng: random.Random, pool: list, n: int, prefix: str) -> str:
    parts = []
    for b in range(n):
        tpl = pool[rng.randrange(len(pool))]
        owner = rng.choice(("platform", "payments", "search", "data", "identity"))
        parts.append(f"# {prefix}{b}: owned by the {owner} team, change ticket "
                     f"INFRA-{rng.randrange(1000, 9999)}; review before widening access.\n"
                     + _variant(rng, tpl.replace("@N@", f"{prefix}{b}")))
    return "\n".join(parts)


def write_tf_monorepo(root: Path, seed: int, modules: int = 48, envs: int = 12,
                      blocks: int = 32, secrets: dict | None = None,
                      plan_bytes: int = 1000 << 10) -> dict:
    """Write the monorepo under ``root``; returns its file and byte counts
    (``tf_files`` and ``tf_bytes`` of the ``.tf`` files alone).
    Every module has six ``.tf`` files and every environment root six, a
    ``terraform.tfvars`` and, in every third root, a ``.tf.json`` file; the
    roots call the modules round robin. ``plan_bytes`` sizes ``plan/
    tfplan.json`` (kept under the config analyzer's 1 MiB cap)."""
    rng = random.Random(seed * 7919 + 24)
    secrets = secrets or {}
    counts = {"tf_files": 0, "tf_bytes": 0, "files": 0, "bytes": 0}

    def put(rel: str, text: str) -> None:
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        data = text.encode()
        p.write_bytes(data)
        counts["files"] += 1
        counts["bytes"] += len(data)
        if rel.endswith(".tf"):
            counts["tf_files"] += 1
            counts["tf_bytes"] += len(data)

    kinds = [KINDS[m % len(KINDS)] for m in range(modules)]
    for m, (kind, pool, _) in enumerate(kinds):
        d = f"modules/m{m:02d}-{kind}"
        head = lambda what: HEADER.format(kind=kind, what=what).replace("@M@", f"m{m:02d}")  # noqa: E731
        put(f"{d}/variables.tf", head("inputs") + VARIABLES)
        put(f"{d}/locals.tf", head("locals") + 'terraform {\n  required_version = ">= 1.5"\n}\n\n'
            + LOCALS.replace("@M@", f"m{m:02d}"))
        for part in ("main", "network", "storage"):
            put(f"{d}/{part}.tf", head(part) + _blocks(rng, pool, blocks, f"{part}_"))
        put(f"{d}/outputs.tf", head("outputs") + 'output "name" {\n  value = var.name\n}\n\n'
            + 'output "tags" {\n  value = local.tags\n}\n')
    per_env = max(1, -(-modules // max(envs, 1)))
    slot = {"aws": 0, "gitlab": 1 % envs, "github": 2 % envs, "slack": 3 % envs}
    for e in range(envs):
        d = f"envs/e{e:02d}"
        calls, providers = [], {}
        for k in range(per_env):
            m = (e * per_env + k) % modules
            kind = kinds[m][0]
            providers[kind] = kinds[m][2]
            calls.append(
                f'module "m{m:02d}" {{\n  source   = "../../modules/m{m:02d}-{kind}"\n'
                f'  name     = "${{var.env}}-m{m:02d}"\n  replicas = var.replicas\n'
                f'  ports    = var.ports\n  queues   = var.queues\n  tags     = local.tags\n}}\n')
        put(f"{d}/main.tf", f"# Environment e{e:02d}: the modules it deploys.\n\n"
            + "\n".join(calls))
        prov = "\n".join(providers.values())
        if e == slot["aws"] and "aws" in secrets:
            prov += (f'\nprovider "aws" {{\n  alias      = "legacy"\n  region     = "us-east-1"\n'
                     f'  access_key = "{secrets["aws"]}"\n}}\n')
        if e == slot["gitlab"] and "gitlab" in secrets:
            prov += f'\nprovider "gitlab" {{\n  token = "{secrets["gitlab"]}"\n}}\n'
        put(f"{d}/providers.tf", f"# Environment e{e:02d}: providers.\n\n" + prov)
        put(f"{d}/variables.tf", VARIABLES.split('variable "tags"')[0].replace(
            'variable "name"', 'variable "env"') + 'variable "region" {\n  default = "eu-west-1"\n}\n'
            'variable "project" {\n  default = "acme"\n}\n')
        put(f"{d}/locals.tf", 'locals {\n  tags = {\n    Environment = var.env\n'
            f'    CostCenter  = "cc-{e:03d}"\n  }}\n}}\n')
        put(f"{d}/backend.tf", 'terraform {\n  backend "s3" {\n'
            f'    bucket = "acme-tfstate"\n    key    = "envs/e{e:02d}.tfstate"\n'
            '    region = "eu-west-1"\n  }\n}\n')
        put(f"{d}/outputs.tf", "".join(
            f'output "m{(e * per_env + k) % modules:02d}" {{\n'
            f'  value = module.m{(e * per_env + k) % modules:02d}.name\n}}\n'
            for k in range(per_env)))
        tfvars = (f'env      = "e{e:02d}"\nreplicas = {1 + e % 3}\nports    = [22, 443]\n'
                  f'queues   = {{ jobs = 86400, events = 3600 }}\n')
        if e == slot["github"] and "github" in secrets:
            tfvars += f'github_token = "{secrets["github"]}"\n'
        if e == slot["slack"] and "slack" in secrets:
            tfvars += f'slack_webhook_token = "{secrets["slack"]}"\n'
        put(f"{d}/terraform.tfvars", tfvars)
        if e % 3 == 0:
            doc = {"resource": {"aws_s3_bucket": {f"json_{e}": {
                "bucket": f"acme-e{e:02d}-json", "acl": "public-read"}}}}
            put(f"{d}/extra.tf.json", json.dumps(doc, indent=2) + "\n")
    put("plan/tfplan.json", _plan(rng, plan_bytes))
    for a in range(2):
        put(f"arm/template{a}.json", _arm(rng, a))
    return counts


def _plan(rng: random.Random, nbytes: int) -> str:
    """A ``terraform show -json`` plan of about ``nbytes`` bytes."""
    resources, child, size, i = [], [], 400, 0
    while size < nbytes:
        kind = i % 4
        if kind == 0:
            res = {"type": "aws_s3_bucket", "values": {
                "bucket": f"plan-{i}", "acl": rng.choice(["public-read", "private"]),
                "versioning": [{"enabled": rng.choice([True, False])}],
                "tags": {"Team": f"t{i % 7}"}}}
        elif kind == 1:
            res = {"type": "aws_security_group", "values": {
                "name": f"sg-{i}", "description": "plan",
                "ingress": [{"from_port": 22, "to_port": 22, "protocol": "tcp",
                             "cidr_blocks": [rng.choice(["0.0.0.0/0", "10.0.0.0/8"])],
                             "description": "ssh"}]}}
        elif kind == 2:
            res = {"type": "google_storage_bucket", "values": {
                "name": f"gcs-{i}", "location": "EU",
                "uniform_bucket_level_access": rng.choice([True, False])}}
        else:
            res = {"type": "github_repository", "values": {
                "name": f"repo-{i}", "visibility": rng.choice(["public", "private"])}}
        res.update({"address": f"{res['type']}.r{i}", "mode": "managed", "name": f"r{i}",
                    "provider_name": "registry.terraform.io/hashicorp/x"})
        (child if i % 5 == 0 else resources).append(res)
        size += len(json.dumps(res)) + 2
        i += 1
    doc = {"format_version": "1.2", "terraform_version": "1.7.5", "planned_values": {
        "root_module": {"resources": resources, "child_modules": [
            {"address": "module.legacy", "resources": child}]}}}
    return json.dumps(doc) + "\n"


def _arm(rng: random.Random, a: int) -> str:
    """An ARM template with storage accounts, a VM and parameters."""
    resources = []
    for s in range(6):
        resources.append({
            "type": "Microsoft.Storage/storageAccounts", "apiVersion": "2022-09-01",
            "name": f"[concat(parameters('prefix'), 'st{s}')]",
            "location": "[parameters('location')]",
            "properties": {"supportsHttpsTrafficOnly": rng.choice([True, False]),
                           "minimumTlsVersion": rng.choice(["TLS1_0", "TLS1_2"])},
            "resources": [{"type": "Microsoft.Storage/storageAccounts/blobServices/containers",
                           "name": f"c{s}", "properties": {
                               "publicAccess": rng.choice(["None", "Blob"])}}]})
    doc = {"$schema": "https://schema.management.azure.com/schemas/2019-04-01/"
                      "deploymentTemplate.json#",
           "contentVersion": "1.0.0.0",
           "parameters": {"prefix": {"type": "string", "defaultValue": f"acme{a}"},
                          "location": {"type": "string", "defaultValue": "westeurope"}},
           "variables": {"vmName": "[toLower(concat(parameters('prefix'), 'vm'))]"},
           "resources": resources}
    return json.dumps(doc, indent=2) + "\n"
