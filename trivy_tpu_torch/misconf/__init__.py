"""Misconfiguration (IaC) scanning, the port of ``trivy_tpu/misconf/``:
the ``dockerfile``, ``kubernetes``, ``terraform``, ``terraformplan-json``,
``cloudformation``, ``helm``, ``azure-arm``, ``yaml`` and ``json`` types.

Host-only work, as in the JAX package: a registry of structured Python
checks over typed inputs replaces the reference's rego engine (ref:
pkg/misconf/scanner.go, pkg/iac/**), with the same check IDs, severities
and CauseMetadata lines in the output.

Layout:
- detection:  file-type sniffing/routing (ref: pkg/iac/detection/detect.go)
- parse:      dockerfile / yaml-json (line-tracking) / kubernetes views
- hcl:        HCL2 lexer, parser, evaluator and function library
- terraform:  module-aware evaluation of a terraform file set → BlockVals
              (``state``); ``tfplan``: plan JSON → the same BlockVals;
              ``cloudformation``: templates and their intrinsics → the same
- helm:       chart rendering (Go-template subset) → kubernetes manifests
- adapters:   BlockVals → each provider's typed state
- arm:        ARM templates (expressions, the Azure state, its checks)
- checks:     check registry + builtin Docker (DS*) and Kubernetes (KSV*)
              check sets, and the cloud check sets over typed state
- custom:     ``--config-check`` Python and Rego check files
- scanner:    facade mapping files -> [types.Misconfiguration]
              (ref: pkg/misconf/scanner.go:141, ResultsToMisconf :443-499)
"""

from trivy_tpu_torch.misconf.scanner import MisconfScanner, ScannerOption

__all__ = ["MisconfScanner", "ScannerOption"]
