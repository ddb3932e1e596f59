"""Terraform plan (JSON) scanner
(ref: pkg/iac/scanners/terraformplan — the reference parses
``terraform show -json`` output and snapshot files; this build converts the
plan's ``planned_values`` resources into the same evaluated-block form the
HCL evaluator produces, so every terraform cloud check and adapter runs
unchanged over plans).

The port of ``trivy_tpu/misconf/tfplan.py``.
"""

from __future__ import annotations

import json

from trivy_tpu_torch.misconf.state import BlockVal, Val


def load(path: str, content: bytes) -> list[BlockVal]:
    """tfplan JSON -> resource BlockVals (the adapter input contract)."""
    doc = json.loads(content)
    resources: list[BlockVal] = []

    def walk_module(mod: dict) -> None:
        for res in mod.get("resources", []) or []:
            if res.get("mode", "managed") != "managed":
                continue
            rtype = res.get("type", "")
            name = res.get("name", "")
            bv = BlockVal(
                type="resource",
                labels=[rtype, name],
                file=path,
                line=0,
            )
            _fill(bv, res.get("values") or {}, path)
            resources.append(bv)
        for child in mod.get("child_modules", []) or []:
            walk_module(child)

    planned = doc.get("planned_values") or {}
    root = planned.get("root_module") or {}
    walk_module(root)
    return resources


def _fill(bv: BlockVal, values: dict, path: str) -> None:
    """Plan values -> attrs + nested blocks: a list of dicts (or a dict) is
    a nested block set; everything else is an attribute."""
    for key, val in values.items():
        if isinstance(val, dict):
            child = BlockVal(type=key, file=path)
            _fill(child, val, path)
            bv.children.append(child)
        elif isinstance(val, list) and val and all(
            isinstance(x, dict) for x in val
        ):
            for item in val:
                child = BlockVal(type=key, file=path)
                _fill(child, item, path)
                bv.children.append(child)
        else:
            bv.attrs[key] = Val(val, path, 0, 0)
