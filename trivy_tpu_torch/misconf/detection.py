"""File-type detection for IaC routing (ref: pkg/iac/detection/detect.go),
the port of ``trivy_tpu/misconf/detection.py``: every type is detected as
there, the ones the port does not scan yet included (the scanner refuses
those, ``misconf/scanner.py``).

Type names match the reference's FileType constants so suppression configs
and report consumers see the same strings ("dockerfile", "kubernetes",
"terraform", "cloudformation", "yaml", "json", "helm", "azure-arm").
"""

from __future__ import annotations

import json
import os.path

FILE_TYPE_CLOUDFORMATION = "cloudformation"
FILE_TYPE_TERRAFORM = "terraform"
FILE_TYPE_DOCKERFILE = "dockerfile"
FILE_TYPE_KUBERNETES = "kubernetes"
FILE_TYPE_YAML = "yaml"
FILE_TYPE_JSON = "json"
FILE_TYPE_HELM = "helm"
FILE_TYPE_AZURE_ARM = "azure-arm"
FILE_TYPE_TERRAFORM_PLAN = "terraformplan-json"

# types with builtin check sets — detection order matters: most specific
# first (a k8s manifest is also valid yaml; a CFN template is also json)
_ORDERED_TYPES = [
    FILE_TYPE_DOCKERFILE,
    FILE_TYPE_TERRAFORM,
    FILE_TYPE_CLOUDFORMATION,
    FILE_TYPE_AZURE_ARM,
    FILE_TYPE_KUBERNETES,
    FILE_TYPE_HELM,
    FILE_TYPE_JSON,
    FILE_TYPE_YAML,
]

_YAML_EXTS = (".yaml", ".yml")


def _basename_stem_ext(path: str) -> tuple[str, str]:
    base = os.path.basename(path)
    stem, ext = os.path.splitext(base)
    return stem, ext.lower()


def is_dockerfile(path: str) -> bool:
    """Dockerfile / Containerfile, bare or as prefix/suffix
    (ref: detect.go:161-174)."""
    stem, ext = _basename_stem_ext(path)
    for req in ("Dockerfile", "Containerfile"):
        if stem == req or ext == f".{req.lower()}":
            return True
    return False


def is_terraform(path: str) -> bool:
    return path.endswith((".tf", ".tf.json", ".tfvars"))


def is_helm(path: str, content: bytes) -> bool:
    base = os.path.basename(path)
    if base in ("Chart.yaml", ".helmignore", "values.schema.json", "NOTES.txt"):
        return True
    # template files using Go template actions under a templates/ dir
    if "/templates/" in f"/{path}" and path.endswith((".yaml", ".yml", ".tpl")):
        return b"{{" in content
    return False


def _load_yaml_docs(content: bytes):
    """Tag-tolerant load (CFN ``!Ref``/``!Sub`` short forms, vendor tags) —
    shares the loader with parse.yamljson so detection and parsing agree."""
    import yaml

    from trivy_tpu_torch.misconf.parse.yamljson import tolerant_loader_cls

    try:
        return list(
            yaml.load_all(content.decode("utf-8", "replace"), Loader=tolerant_loader_cls())
        )
    except Exception:
        return None


def is_kubernetes(path: str, content: bytes) -> bool:
    """YAML/JSON docs with apiVersion+kind+metadata (ref: detect.go:193+)."""
    if path.endswith(_YAML_EXTS):
        docs = _load_yaml_docs(content)
        if docs is None:
            return False
        found = False
        for d in docs:
            if d is None:
                continue
            if not isinstance(d, dict):
                return False
            if all(k in d for k in ("apiVersion", "kind", "metadata")):
                found = True
        return found
    if path.endswith(".json"):
        try:
            d = json.loads(content)
        except Exception:
            return False
        return isinstance(d, dict) and all(
            k in d for k in ("apiVersion", "kind", "metadata")
        )
    return False


def _looks_cloudformation(d) -> bool:
    if not isinstance(d, dict):
        return False
    res = d.get("Resources")
    if not isinstance(res, dict):
        return False
    return "AWSTemplateFormatVersion" in d or any(
        isinstance(r, dict) and str(r.get("Type", "")).startswith("AWS::")
        for r in res.values()
    )


def is_cloudformation(path: str, content: bytes) -> bool:
    """Template with a Resources top-level section (ref: detect.go:110-135
    sniffs for the Resources key in yaml/json)."""
    if path.endswith(_YAML_EXTS):
        docs = _load_yaml_docs(content)
        if not docs:
            return False
        return _looks_cloudformation(docs[0])
    if path.endswith(".json"):
        try:
            d = json.loads(content)
        except Exception:
            return False
        return _looks_cloudformation(d)
    return False


def is_azure_arm(path: str, content: bytes) -> bool:
    if not path.endswith(".json"):
        return False
    try:
        d = json.loads(content)
    except Exception:
        return False
    return isinstance(d, dict) and "schema.management.azure.com" in str(
        d.get("$schema", "")
    )


def is_json(path: str, content: bytes) -> bool:
    if not path.endswith(".json"):
        return False
    try:
        json.loads(content)
        return True
    except Exception:
        return False


def is_yaml(path: str, content: bytes) -> bool:
    if not path.endswith(_YAML_EXTS):
        return False
    return _load_yaml_docs(content) is not None


def is_terraform_plan(path: str, content: bytes) -> bool:
    """tfplan JSON (`terraform show -json plan`): format_version +
    planned_values markers (ref: pkg/iac/detection detect for
    terraformplan-json)."""
    if not path.endswith(".json"):
        return False
    if b"planned_values" not in content or b"format_version" not in content:
        return False
    try:
        doc = json.loads(content)
    except Exception:
        return False
    return isinstance(doc, dict) and "planned_values" in doc


def detect_type(path: str, content: bytes) -> str | None:
    """Most-specific IaC file type for routing, or None."""
    if is_dockerfile(path):
        return FILE_TYPE_DOCKERFILE
    if is_terraform(path):
        return FILE_TYPE_TERRAFORM
    if is_terraform_plan(path, content):
        return FILE_TYPE_TERRAFORM_PLAN
    if is_cloudformation(path, content):
        return FILE_TYPE_CLOUDFORMATION
    if is_azure_arm(path, content):
        return FILE_TYPE_AZURE_ARM
    if is_kubernetes(path, content):
        return FILE_TYPE_KUBERNETES
    if is_helm(path, content):
        return FILE_TYPE_HELM
    if is_json(path, content):
        return FILE_TYPE_JSON
    if is_yaml(path, content):
        return FILE_TYPE_YAML
    return None


def relevant(path: str) -> bool:
    """Cheap name-only prefilter for the CONFIG analyzer's required()."""
    if is_dockerfile(path) or is_terraform(path):
        return True
    return path.endswith((".yaml", ".yml", ".json", ".tpl"))
