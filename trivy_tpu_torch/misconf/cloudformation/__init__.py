"""CloudFormation template evaluation
(ref: pkg/iac/scanners/cloudformation/parser/ — independent implementation).

Parses YAML (with short-form intrinsic tags) and JSON templates, resolves
parameters/conditions/mappings and the Fn::* intrinsics, and emits each
resource as a :class:`BlockVal` whose children mirror nested property
structure — the same shape terraform evaluation produces, so one adapter
layer serves both.

The port of ``trivy_tpu/misconf/cloudformation/__init__.py``.
"""

from __future__ import annotations

import base64 as _b64
import json

import yaml

from trivy_tpu_torch import log
from trivy_tpu_torch.misconf.hcl.functions import UNKNOWN
from trivy_tpu_torch.misconf.parse.yamljson import LMap, LSeq, _construct
from trivy_tpu_torch.misconf.state import BlockVal, Val

logger = log.logger("misconf:cloudformation")

_SHORT_TAGS = [
    "Ref", "Sub", "GetAtt", "Join", "Select", "Split", "FindInMap", "Base64",
    "If", "And", "Or", "Not", "Equals", "ImportValue", "GetAZs", "Cidr",
    "Condition", "Transform",
]


class _CfnLoader(yaml.SafeLoader):
    pass


def _make_tag_constructor(name: str):
    key = "Ref" if name == "Ref" else ("Condition" if name == "Condition" else f"Fn::{name}")

    def construct(loader, node):
        if isinstance(node, yaml.ScalarNode):
            val = loader.construct_scalar(node)
            if name == "GetAtt" and isinstance(val, str):
                val = val.split(".", 1)
        elif isinstance(node, yaml.SequenceNode):
            val = [_construct(v, loader) for v in node.value]
        else:
            val = _construct_map_plain(loader, node)
        out = LMap()
        out.span = (node.start_mark.line + 1, node.end_mark.line + 1)
        out[key] = val
        out.key_spans[key] = out.span
        return out

    return construct


def _construct_map_plain(loader, node):
    out = LMap()
    out.span = (node.start_mark.line + 1, node.end_mark.line + 1)
    for knode, vnode in node.value:
        k = loader.construct_object(knode, deep=True)
        out[k] = _construct(vnode, loader)
        out.key_spans[k] = (knode.start_mark.line + 1, vnode.end_mark.line + 1)
    return out


for _t in _SHORT_TAGS:
    _CfnLoader.add_constructor(f"!{_t}", _make_tag_constructor(_t))


class CfnRef(str):
    """Reference to another resource; string-usable, identity-preserving."""

    logical_id: str = ""
    attr: str = ""

    def __new__(cls, text: str, logical_id: str = "", attr: str = ""):
        s = super().__new__(cls, text)
        s.logical_id = logical_id
        s.attr = attr
        return s


_NO_VALUE = object()

_PSEUDO = {
    "AWS::Region": "us-east-1",
    "AWS::Partition": "aws",
    "AWS::AccountId": UNKNOWN,
    "AWS::StackName": UNKNOWN,
    "AWS::StackId": UNKNOWN,
    "AWS::URLSuffix": "amazonaws.com",
    "AWS::NoValue": _NO_VALUE,
    "AWS::NotificationARNs": UNKNOWN,
}


class Template:
    def __init__(self, doc: LMap, file: str):
        self.doc = doc
        self.file = file
        self.parameters: dict[str, object] = {}
        self.mappings = doc.get("Mappings", {}) or {}
        self.resources: LMap = doc.get("Resources", LMap()) or LMap()
        self._conditions_raw = doc.get("Conditions", {}) or {}
        self._conditions: dict[str, bool | None] = {}
        for name, p in (doc.get("Parameters", {}) or {}).items():
            if isinstance(p, dict) and "Default" in p:
                self.parameters[name] = p["Default"]
            else:
                self.parameters[name] = UNKNOWN

    # -- intrinsic resolution ------------------------------------------------

    def condition(self, name: str):
        if name in self._conditions:
            return self._conditions[name]
        self._conditions[name] = None  # cycle guard
        raw = self._conditions_raw.get(name)
        v = self.resolve(raw) if raw is not None else UNKNOWN
        out = v if isinstance(v, bool) else None
        self._conditions[name] = out
        return out

    def resolve(self, node):
        if isinstance(node, dict):
            if len(node) == 1:
                key = next(iter(node))
                if key == "Ref" or key.startswith("Fn::") or key == "Condition":
                    return self._intrinsic(key, node[key])
            out = {}
            for k, v in node.items():
                rv = self.resolve(v)
                if rv is _NO_VALUE:
                    continue
                out[k] = rv
            if isinstance(node, LMap):
                lm = LMap()
                lm.update(out)
                lm.span = node.span
                lm.key_spans = dict(node.key_spans)
                return lm
            return out
        if isinstance(node, list):
            vals = [self.resolve(v) for v in node]
            vals = [v for v in vals if v is not _NO_VALUE]
            if isinstance(node, LSeq):
                ls = LSeq()
                ls.extend(vals)
                ls.span = node.span
                return ls
            return vals
        return node

    def _intrinsic(self, key: str, arg):
        try:
            return self._intrinsic_inner(key, arg)
        except Exception:
            return UNKNOWN

    def _intrinsic_inner(self, key: str, arg):
        if key == "Ref":
            return self._ref(arg)
        if key == "Condition":
            c = self.condition(arg)
            return UNKNOWN if c is None else c
        fn = key[4:]
        if fn == "Sub":
            return self._sub(arg)
        if fn == "GetAtt":
            arg = self.resolve(arg)
            if isinstance(arg, str):
                arg = arg.split(".", 1)
            lid, attr = arg[0], arg[1] if len(arg) > 1 else ""
            return CfnRef(f"{lid}.{attr}", logical_id=lid, attr=attr)
        if fn == "Join":
            sep, items = self.resolve(arg[0]), self.resolve(arg[1])
            parts = []
            for it in items:
                if it is UNKNOWN:
                    return UNKNOWN
                parts.append(str(it))
            return str(sep).join(parts)
        if fn == "Select":
            idx, items = self.resolve(arg[0]), self.resolve(arg[1])
            return items[int(idx)]
        if fn == "Split":
            sep, s = self.resolve(arg[0]), self.resolve(arg[1])
            if s is UNKNOWN:
                return UNKNOWN
            return str(s).split(str(sep))
        if fn == "FindInMap":
            m, k1, k2 = (self.resolve(a) for a in arg)
            return self.mappings.get(m, {}).get(k1, {}).get(k2, UNKNOWN)
        if fn == "Base64":
            v = self.resolve(arg)
            return UNKNOWN if v is UNKNOWN else _b64.b64encode(str(v).encode()).decode()
        if fn == "If":
            cname, t, f = arg[0], arg[1], arg[2]
            c = self.condition(cname)
            if c is None:
                tv = self.resolve(t)
                return tv if tv is not UNKNOWN else self.resolve(f)
            return self.resolve(t) if c else self.resolve(f)
        if fn == "Equals":
            a, b = self.resolve(arg[0]), self.resolve(arg[1])
            if a is UNKNOWN or b is UNKNOWN:
                return UNKNOWN
            return str(a) == str(b)
        if fn == "And":
            vals = [self.resolve(a) for a in arg]
            if any(v is False for v in vals):
                return False
            if any(v is UNKNOWN for v in vals):
                return UNKNOWN
            return all(bool(v) for v in vals)
        if fn == "Or":
            vals = [self.resolve(a) for a in arg]
            if any(v is True for v in vals):
                return True
            if any(v is UNKNOWN for v in vals):
                return UNKNOWN
            return any(bool(v) for v in vals)
        if fn == "Not":
            v = self.resolve(arg[0])
            return UNKNOWN if v is UNKNOWN else not bool(v)
        if fn == "GetAZs":
            return ["us-east-1a", "us-east-1b", "us-east-1c"]
        if fn in ("ImportValue", "Cidr", "Transform"):
            return UNKNOWN
        return UNKNOWN

    def _ref(self, name):
        name = self.resolve(name) if isinstance(name, (dict, list)) else name
        if name in _PSEUDO:
            return _PSEUDO[name]
        if name in self.parameters:
            return self.parameters[name]
        if name in self.resources:
            return CfnRef(str(name), logical_id=str(name))
        return UNKNOWN

    def _sub(self, arg):
        if isinstance(arg, list):
            template, extra = self.resolve(arg[0]), self.resolve(arg[1]) or {}
        else:
            template, extra = arg, {}
        if not isinstance(template, str):
            return UNKNOWN
        out = []
        i, n = 0, len(template)
        while i < n:
            if template.startswith("${!", i):
                end = template.find("}", i)
                out.append("$" + template[i + 3 : end] + "")
                i = end + 1
                continue
            if template.startswith("${", i):
                end = template.find("}", i)
                if end < 0:
                    out.append(template[i:])
                    break
                name = template[i + 2 : end]
                if name in extra:
                    v = extra[name]
                elif "." in name:
                    lid, attr = name.split(".", 1)
                    v = CfnRef(name, logical_id=lid, attr=attr)
                else:
                    v = self._ref(name)
                if v is UNKNOWN or v is _NO_VALUE:
                    return UNKNOWN
                out.append(str(v))
                i = end + 1
                continue
            out.append(template[i])
            i += 1
        return "".join(out)


def _to_block_val(name: str, props, file: str, span) -> BlockVal:
    bv = BlockVal(type=name, file=file, line=span[0], end_line=span[1])
    if not isinstance(props, dict):
        return bv
    for k, v in props.items():
        kspan = props.key_spans.get(k, span) if isinstance(props, LMap) else span
        if isinstance(v, dict) and not isinstance(v, CfnRef):
            child = _to_block_val(k, v, file, getattr(v, "span", kspan))
            bv.children.append(child)
        elif isinstance(v, list) and any(isinstance(x, dict) for x in v):
            for x in v:
                if isinstance(x, dict):
                    bv.children.append(
                        _to_block_val(k, x, file, getattr(x, "span", kspan))
                    )
                # scalar list entries alongside dicts are rare; keep as attr too
            bv.attrs[k] = Val(
                [x for x in v if not isinstance(x, dict)] or v,
                file, kspan[0], kspan[1],
            )
        else:
            bv.attrs[k] = Val(v, file, kspan[0], kspan[1])
    return bv


def load(path: str, content: bytes) -> list[BlockVal]:
    """Parse + resolve one template → resource BlockVals.

    Resource shape: ``type`` = CFN resource type (``AWS::S3::Bucket``),
    ``labels`` = [logical id], children = nested property blocks.
    """
    text = content.decode("utf-8", "replace")
    doc = None
    if path.endswith(".json"):
        try:
            doc = json.loads(text)
        except Exception:
            doc = None
    if doc is None:
        loader = _CfnLoader(text)
        try:
            node = loader.get_single_node()
            if node is None:
                return []
            doc = _construct(node, loader)
        finally:
            loader.dispose()
    if not isinstance(doc, dict) or not isinstance(doc.get("Resources"), dict):
        return []
    tpl = Template(doc if isinstance(doc, LMap) else _wrap_plain(doc), path)
    out: list[BlockVal] = []
    for lid, res in tpl.resources.items():
        if not isinstance(res, dict):
            continue
        rtype = res.get("Type")
        if not isinstance(rtype, str):
            continue
        cond_name = res.get("Condition")
        if isinstance(cond_name, str) and tpl.condition(cond_name) is False:
            continue
        props = tpl.resolve(res.get("Properties", LMap()) or LMap())
        span = getattr(res, "span", (0, 0))
        if isinstance(tpl.resources, LMap):
            span = tpl.resources.key_spans.get(lid, span)
        bv = _to_block_val(rtype, props, path, span)
        bv.labels = [str(lid)]
        bv.line, bv.end_line = span
        out.append(bv)
    return out


def _wrap_plain(doc: dict) -> LMap:
    lm = LMap()
    lm.update(doc)
    return lm
