"""Misconfiguration scanner facade (ref: pkg/misconf/scanner.go:101-141),
the port of ``trivy_tpu/misconf/scanner.py``.

Routes files by detected type to the matching engine:

- dockerfile / kubernetes  → per-file structural checks (DS*/KSV*)
- terraform                → whole-file-set HCL evaluation → AWS state →
                             cloud checks (AVD-AWS-*)
- cloudformation           → per-file template resolution → same cloud checks
- helm                     → template render → kubernetes checks
- azure-arm                → template resolution → ARM checks
- yaml / json              → user-supplied custom checks only (matching the
                             reference's generic scanners, which evaluate
                             nothing without custom policies)

and produces ``types.Misconfiguration`` records with the reference's
successes/failures/CauseMetadata shape (ref: scanner.go:443-499).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from trivy_tpu_torch import faults, log
from trivy_tpu_torch.misconf import detection
from trivy_tpu_torch.misconf.checks import evaluate, evaluate_cloud
from trivy_tpu_torch.types import Misconfiguration

logger = log.logger("misconf")

# scanner display names per file type (ref: scanner.go NewScanner per type)
_SCANNER_NAMES = {
    detection.FILE_TYPE_DOCKERFILE: "Dockerfile",
    detection.FILE_TYPE_KUBERNETES: "Kubernetes",
    detection.FILE_TYPE_YAML: "YAML",
    detection.FILE_TYPE_JSON: "JSON",
    detection.FILE_TYPE_TERRAFORM: "Terraform",
    detection.FILE_TYPE_CLOUDFORMATION: "CloudFormation",
    detection.FILE_TYPE_HELM: "Helm",
    detection.FILE_TYPE_AZURE_ARM: "Azure ARM",
    detection.FILE_TYPE_TERRAFORM_PLAN: "Terraform Plan",
}


@dataclass
class ScannerOption:
    """Subset of the reference's ScannerOption relevant here."""

    namespaces: list[str] = field(default_factory=list)
    include_non_failures: bool = False
    check_ids_disabled: list[str] = field(default_factory=list)
    check_paths: list[str] = field(default_factory=list)  # custom check files/dirs
    file_types: list[str] = field(default_factory=list)  # limit scanned types


class MisconfScanner:
    def __init__(self, option: ScannerOption | None = None):
        self.option = option or ScannerOption()
        self._disabled = set(self.option.check_ids_disabled)
        if self.option.check_paths:
            from trivy_tpu_torch.misconf.custom import load_custom_checks

            load_custom_checks(self.option.check_paths)

    def _enabled(self, c) -> bool:
        return c.id not in self._disabled and c.avd_id not in self._disabled

    def scan_files(self, files: list[tuple[str, bytes]]) -> list[Misconfiguration]:
        from trivy_tpu_torch import obs

        with obs.span("misconf.scan_files"):
            return self._scan_files(files)

    def _scan_files(self, files: list[tuple[str, bytes]]) -> list[Misconfiguration]:
        from trivy_tpu_torch import obs

        ctx = obs.current()
        tf_files: dict[str, bytes] = {}
        helm_files: dict[str, bytes] = {}
        per_file: list[tuple[str, str, bytes]] = []
        with ctx.span("misconf.parse"):
            for path, content in files:
                try:
                    ftype = detection.detect_type(path, content)
                except Exception as e:  # one bad file must not kill the batch
                    logger.debug(
                        "misconf type detection failed for %s: %s", path, e
                    )
                    continue
                if ftype is None:
                    continue
                if self.option.file_types and ftype not in self.option.file_types:
                    continue
                if ftype == detection.FILE_TYPE_TERRAFORM:
                    tf_files[path] = content
                elif ftype == detection.FILE_TYPE_HELM:
                    helm_files[path] = content
                else:
                    per_file.append((path, ftype, content))

        out: list[Misconfiguration] = []
        if tf_files:
            with ctx.span("misconf.terraform"):
                out.extend(self._scan_terraform(tf_files))
        if helm_files:
            # charts are more than their templates: Chart.yaml/values.yaml
            # carry no {{ }} so they type as plain yaml — hand every
            # yaml-ish sibling to the renderer, which groups files by
            # chart root and ignores the rest (the reference feeds the
            # whole chart directory to the helm SDK the same way)
            import os.path as _p

            for path, ftype, content in per_file:
                if ftype in (
                    detection.FILE_TYPE_YAML, detection.FILE_TYPE_JSON,
                    detection.FILE_TYPE_KUBERNETES,
                ) and path not in helm_files:
                    helm_files[path] = content
            roots = {
                _p.dirname(p) for p in helm_files
                if _p.basename(p) == "Chart.yaml"
            }

            # yaml-ish files under a detected chart root belong to the
            # chart: templates render through helm, and chart-root files
            # (values.yaml, Chart.yaml) plus chart-adjacent manifests feed
            # the render — scanning those standalone as well would
            # double-count the same configuration (the reference hands the
            # whole chart directory to the helm scanner). Other types
            # (Dockerfile, CloudFormation, ARM) never enter the helm lane
            # and keep their standalone pass even inside a chart dir.
            _HELM_LANE = (
                detection.FILE_TYPE_YAML, detection.FILE_TYPE_JSON,
                detection.FILE_TYPE_KUBERNETES,
            )

            def _chart_owned(path: str, ftype: str) -> bool:
                return ftype in _HELM_LANE and any(
                    path.startswith(r + "/") if r else True for r in roots
                )

            per_file = [
                (path, ftype, content)
                for path, ftype, content in per_file
                if not _chart_owned(path, ftype)
            ]
            with ctx.span("misconf.helm"):
                out.extend(self._scan_helm(helm_files))
        with ctx.span("misconf.eval"):
            for path, ftype, content in per_file:
                try:
                    faults.check("misconf.eval", key=path)
                    mc = self.scan_file(path, content, ftype)
                except Exception as e:
                    # per-file failure domain: one crashing engine or check
                    # must not kill the whole misconfig pass — count it,
                    # log it, and keep scanning the rest
                    logger.warning(
                        "misconf evaluation failed for %s (skipped): %s",
                        path, e,
                    )
                    ctx.count("misconf.skipped")
                    ctx.health_count("misconf.skipped")
                    continue
                if mc is not None:
                    out.append(mc)
        out = [mc for mc in out if mc.failures or mc.successes]
        out.sort(key=lambda m: m.file_path)
        return out

    # -- single-file types ---------------------------------------------------

    def scan_file(self, path: str, content: bytes, ftype: str | None = None) -> Misconfiguration | None:
        if ftype is None:
            try:
                ftype = detection.detect_type(path, content)
            except Exception as e:
                logger.debug("misconf type detection failed for %s: %s", path, e)
                return None
        if ftype is None:
            return None
        if ftype == detection.FILE_TYPE_CLOUDFORMATION:
            return self._scan_cloudformation(path, content)
        if ftype == detection.FILE_TYPE_TERRAFORM_PLAN:
            return self._scan_tfplan(path, content)
        if ftype == detection.FILE_TYPE_AZURE_ARM:
            return self._scan_arm(path, content)
        try:
            parsed = self._parse(ftype, content)
        except Exception as e:
            logger.debug("misconf parse failed for %s (%s): %s", path, ftype, e)
            return None
        if parsed is None:
            return None
        return evaluate(
            ftype,
            path,
            parsed,
            _SCANNER_NAMES.get(ftype, ftype),
            enabled=self._enabled,
        )

    # -- engines -------------------------------------------------------------

    def _scan_terraform(self, tf_files: dict[str, bytes]) -> list[Misconfiguration]:
        from trivy_tpu_torch.misconf import terraform

        try:
            texts = {
                p: c.decode("utf-8", "replace") for p, c in tf_files.items()
            }
            resources = terraform.load(texts)
        except Exception as e:
            logger.warning("terraform evaluation failed: %s", e)
            return []
        return self._evaluate_tf_resources(
            resources, sorted(tf_files), detection.FILE_TYPE_TERRAFORM
        )

    def _evaluate_tf_resources(
        self, resources, files: list[str], ftype: str
    ) -> list[Misconfiguration]:
        """Adapt parsed terraform resources into every provider's typed
        state and evaluate the provider check sets, merging per file (ref:
        pkg/iac/adapters/terraform/* each adapting one provider)."""
        from trivy_tpu_torch.misconf.adapters import (
            aws_tf,
            azure_tf,
            extra_providers,
            github_state,
            google_tf,
        )

        merged: dict[str, Misconfiguration] = {}
        for adapt in (
            aws_tf.adapt,
            azure_tf.adapt,
            google_tf.adapt,
            github_state.adapt,
            extra_providers.adapt_digitalocean,
            extra_providers.adapt_openstack,
            extra_providers.adapt_oracle,
            extra_providers.adapt_cloudstack,
            extra_providers.adapt_nifcloud,
        ):
            try:
                state = adapt(resources)
            except Exception as e:
                logger.warning("%s adapter failed: %s", adapt.__module__, e)
                continue
            by_file = evaluate_cloud(
                state,
                files,
                ftype,
                _SCANNER_NAMES.get(ftype, ftype),
                enabled=self._enabled,
            )
            for path, mc in by_file.items():
                if path not in merged:
                    merged[path] = mc
                else:
                    merged[path].failures.extend(mc.failures)
                    merged[path].successes.extend(mc.successes)
        for mc in merged.values():
            mc.successes.sort(key=lambda r: r.id)
            mc.failures.sort(key=lambda r: (r.id, r.start_line, r.message))
        return list(merged.values())

    def _scan_tfplan(self, path: str, content: bytes) -> Misconfiguration | None:
        from trivy_tpu_torch.misconf import tfplan

        try:
            resources = tfplan.load(path, content)
        except Exception as e:
            logger.debug("tfplan parse failed for %s: %s", path, e)
            return None
        out = self._evaluate_tf_resources(
            resources, [path], detection.FILE_TYPE_TERRAFORM_PLAN
        )
        return out[0] if out else None

    def _scan_cloudformation(self, path: str, content: bytes) -> Misconfiguration | None:
        from trivy_tpu_torch.misconf import cloudformation
        from trivy_tpu_torch.misconf.adapters import aws_cfn

        try:
            resources = cloudformation.load(path, content)
            state = aws_cfn.adapt(resources)
        except Exception as e:
            logger.debug("cloudformation evaluation failed for %s: %s", path, e)
            return None
        by_file = evaluate_cloud(
            state,
            [path],
            detection.FILE_TYPE_CLOUDFORMATION,
            _SCANNER_NAMES[detection.FILE_TYPE_CLOUDFORMATION],
            enabled=self._enabled,
        )
        return by_file.get(path)

    def _scan_helm(self, helm_files: dict[str, bytes]) -> list[Misconfiguration]:
        from trivy_tpu_torch.misconf import helm
        from trivy_tpu_torch.misconf.parse import kubernetes

        out: list[Misconfiguration] = []
        try:
            rendered = helm.render_charts(helm_files)
        except Exception as e:
            logger.warning("helm render failed: %s", e)
            return []
        for path, text in rendered.items():
            try:
                workloads = kubernetes.parse(text.encode())
            except Exception as e:
                logger.debug("helm-rendered manifest parse failed for %s: %s", path, e)
                continue
            mc = evaluate(
                detection.FILE_TYPE_KUBERNETES,
                path,
                workloads,
                _SCANNER_NAMES[detection.FILE_TYPE_HELM],
                enabled=self._enabled,
            )
            if mc is not None:
                mc.file_type = detection.FILE_TYPE_HELM
                out.append(mc)
        return out

    def _scan_arm(self, path: str, content: bytes) -> Misconfiguration | None:
        from trivy_tpu_torch.misconf import arm

        try:
            return arm.scan(path, content, enabled=self._enabled)
        except Exception as e:
            logger.debug("ARM evaluation failed for %s: %s", path, e)
            return None

    @staticmethod
    def _parse(ftype: str, content: bytes):
        if ftype == detection.FILE_TYPE_DOCKERFILE:
            from trivy_tpu_torch.misconf.parse import dockerfile

            return dockerfile.parse(content)
        if ftype == detection.FILE_TYPE_KUBERNETES:
            from trivy_tpu_torch.misconf.parse import kubernetes

            return kubernetes.parse(content)
        if ftype in (detection.FILE_TYPE_YAML, detection.FILE_TYPE_JSON):
            # generic types evaluate only user-supplied custom checks
            # (ref: pkg/iac/scanners/generic — no builtin bundle)
            from trivy_tpu_torch.misconf.checks import checks_for
            from trivy_tpu_torch.misconf.parse import yamljson

            if not checks_for(ftype):
                return None
            return yamljson.load_all(content)
        return None
