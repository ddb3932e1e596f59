"""Terraform configuration evaluation: variables, locals, count/for_each
expansion, dynamic blocks, cross-resource references, local modules
(ref: pkg/iac/scanners/terraform/parser/evaluator.go semantics,
independently implemented on the Python HCL engine).

Entry point :func:`load` takes ``{path: text}`` of ``.tf``/``.tfvars``/
``.tf.json`` sources (any number of directories) and returns evaluated
resource/data :class:`BlockVal` instances for the adapters.

The port of ``trivy_tpu/misconf/terraform/__init__.py``.
"""

from __future__ import annotations

import json
import os.path

from trivy_tpu_torch import log
from trivy_tpu_torch.misconf.hcl import Evaluator, parse
from trivy_tpu_torch.misconf.hcl import parser as P
from trivy_tpu_torch.misconf.hcl.functions import UNKNOWN
from trivy_tpu_torch.misconf.state import BlockVal, Val

logger = log.logger("misconf:terraform")

_META_ARGS = {"count", "for_each", "depends_on", "lifecycle", "provider", "provisioner", "connection"}
_MAX_INSTANCES = 64  # cap count/for_each expansion; scanning needs shapes, not scale


class RefValue(str):
    """A synthetic reference value (e.g. ``aws_s3_bucket.b.id``): usable as a
    string, but carrying the target instance so adapters can link blocks."""

    target: "ResourceInstance | None" = None
    path: tuple = ()

    def __new__(cls, text: str, target=None, path=()):
        s = super().__new__(cls, text)
        s.target = target
        s.path = path
        return s


class ResourceInstance:
    """One expanded instance of a resource/data/module block."""

    def __init__(self, module: "ModuleEval", block: P.Block, file: str,
                 key=None, each_value=None):
        self.module = module
        self.block = block
        self.file = file
        self.key = key  # None | int (count) | str (for_each)
        self.each_value = each_value
        self.mode = block.type  # resource | data
        self.type = block.labels[0] if block.labels else ""
        self.name = block.labels[1] if len(block.labels) > 1 else ""
        self._values: dict[str, object] = {}
        self._evaluating: set[str] = set()
        self._block_val: BlockVal | None = None

    @property
    def address(self) -> str:
        base = f"{self.type}.{self.name}"
        if self.mode == "data":
            base = "data." + base
        if self.key is not None:
            base += f"[{self.key!r}]"
        return base

    def scope_extra(self) -> dict:
        extra: dict = {}
        if isinstance(self.key, int):
            extra["count"] = {"index": self.key}
        elif self.key is not None:
            extra["each"] = {"key": self.key, "value": self.each_value}
        return extra

    # -- reference protocol --------------------------------------------------

    def hcl_get_attr(self, name: str):
        if name in self._evaluating:
            return UNKNOWN  # reference cycle
        attr = self.block.body.attrs.get(name)
        if attr is not None:
            self._evaluating.add(name)
            try:
                if name not in self._values:
                    ev = self.module.evaluator().child(self.scope_extra())
                    self._values[name] = ev.eval(attr.expr)
                return self._values[name]
            finally:
                self._evaluating.discard(name)
        blocks = self.block.body.blocks_of(name)
        if blocks:
            # nested blocks read as objects (single block) / list of objects
            objs = [self._block_obj(b) for b in blocks]
            return objs if len(objs) > 1 else objs[0]
        # computed attribute (id/arn/...): keep identity via RefValue
        return RefValue(f"{self.address}.{name}", target=self, path=(name,))

    def _block_obj(self, b: P.Block):
        ev = self.module.evaluator().child(self.scope_extra())
        out = {}
        for aname, attr in b.body.attrs.items():
            out[aname] = ev.eval(attr.expr)
        for child in b.body.blocks:
            out.setdefault(child.type, self._block_obj(child))
        return out

    def hcl_index(self, key):
        return UNKNOWN

    # -- evaluated BlockVal for adapters --------------------------------------

    def to_block_val(self) -> BlockVal:
        if self._block_val is None:
            ev = self.module.evaluator().child(self.scope_extra())
            self._block_val = _eval_block(
                self.block, self.file, ev, skip_attrs=_META_ARGS
            )
            self._block_val.instance_key = self.key
        return self._block_val


class ModuleEval:
    """One module directory under evaluation."""

    def __init__(self, loader: "Loader", dirname: str, files: dict[str, P.Body],
                 inputs: dict | None = None):
        self.loader = loader
        self.dir = dirname
        self.files = files  # path -> parsed Body
        self.inputs = inputs or {}
        self.variables: dict[str, object] = {}
        self.locals_lazy = _LazyLocals(self)
        self.instances: list[ResourceInstance] = []
        self._by_type: dict[tuple[str, str], dict[str, list[ResourceInstance]]] = {}
        self._modules: dict[str, "ModuleEval"] = {}
        self._outputs_cache: dict[str, object] = {}
        self._ev: Evaluator | None = None

    # -- setup ---------------------------------------------------------------

    def prepare(self, tfvars: dict):
        for path, body in self.files.items():
            for vb in body.blocks_of("variable"):
                if not vb.labels:
                    continue
                name = vb.labels[0]
                if name in self.inputs:
                    self.variables[name] = self.inputs[name]
                elif name in tfvars:
                    self.variables[name] = tfvars[name]
                elif "default" in vb.body.attrs:
                    self.variables[name] = self.evaluator().eval(
                        vb.body.attrs["default"].expr
                    )
                else:
                    self.variables[name] = UNKNOWN
        # instantiate resources/data
        for path, body in self.files.items():
            for block in body.blocks:
                if block.type in ("resource", "data") and len(block.labels) >= 2:
                    self._expand(block, path)
        # child modules
        for path, body in self.files.items():
            for block in body.blocks_of("module"):
                if block.labels:
                    self._load_child_module(block, path)

    def _expand(self, block: P.Block, path: str):
        ev = self.evaluator()
        instances: list[ResourceInstance] = []
        if "count" in block.body.attrs:
            n = ev.eval(block.body.attrs["count"].expr)
            if n is UNKNOWN:
                n = 1
            try:
                n = min(int(n), _MAX_INSTANCES)
            except (TypeError, ValueError):
                n = 1
            for i in range(max(n, 0)):
                instances.append(ResourceInstance(self, block, path, key=i))
        elif "for_each" in block.body.attrs:
            coll = ev.eval(block.body.attrs["for_each"].expr)
            if isinstance(coll, dict):
                pairs = list(coll.items())[:_MAX_INSTANCES]
            elif isinstance(coll, list):
                pairs = [(str(x), x) for x in coll[:_MAX_INSTANCES]]
            else:
                pairs = []
            for k, v in pairs:
                instances.append(
                    ResourceInstance(self, block, path, key=k, each_value=v)
                )
            if not pairs:
                # keep one un-keyed instance so the config is still scanned
                instances.append(ResourceInstance(self, block, path))
        else:
            instances.append(ResourceInstance(self, block, path))
        self.instances.extend(instances)
        typ, name = block.labels[0], block.labels[1]
        self._by_type.setdefault((block.type, typ), {}).setdefault(name, []).extend(
            instances
        )

    def _load_child_module(self, block: P.Block, path: str):
        name = block.labels[0]
        ev = self.evaluator()
        src_attr = block.body.attrs.get("source")
        if src_attr is None:
            return
        src = ev.eval(src_attr.expr)
        if not isinstance(src, str) or not src.startswith("."):
            return  # registry/remote modules are not fetchable in the sandbox
        child_dir = os.path.normpath(os.path.join(self.dir, src))
        child_files = self.loader.dir_bodies(child_dir)
        if not child_files:
            return
        inputs = {}
        for aname, attr in block.body.attrs.items():
            if aname in ("source", "version", "providers", "count", "for_each",
                         "depends_on"):
                continue
            inputs[aname] = ev.eval(attr.expr)
        child = ModuleEval(self.loader, child_dir, child_files, inputs)
        self.loader.mark_child(child_dir)
        child.prepare(self.loader.tfvars_for(child_dir))
        self._modules[name] = child
        self.loader.all_modules.append(child)

    # -- scope ---------------------------------------------------------------

    def evaluator(self) -> Evaluator:
        if self._ev is None:
            self._ev = Evaluator(
                {
                    "var": self.variables,
                    "local": self.locals_lazy,
                    "path": {"module": self.dir or ".", "root": ".", "cwd": "."},
                    "terraform": {"workspace": "default"},
                },
                resolver=self._resolve_root,
            )
        return self._ev

    def _resolve_root(self, name: str):
        if name == "data":
            return _DataRoot(self)
        if name == "module":
            return _ModuleRoot(self)
        if name == "self":
            return UNKNOWN
        refs = self._refs_for(("resource", name))
        if refs is not None:
            return refs
        return UNKNOWN

    def _refs_for(self, key: tuple[str, str]):
        by_name = self._by_type.get(key)
        if by_name is None:
            return None
        out = {}
        for rname, insts in by_name.items():
            if len(insts) == 1 and insts[0].key is None:
                out[rname] = insts[0]
            elif insts and isinstance(insts[0].key, int):
                out[rname] = insts
            else:
                out[rname] = {i.key: i for i in insts}
        return out

    def outputs(self) -> dict:
        if not self._outputs_cache:
            for path, body in self.files.items():
                for ob in body.blocks_of("output"):
                    if not ob.labels or "value" not in ob.body.attrs:
                        continue
                    self._outputs_cache[ob.labels[0]] = self.evaluator().eval(
                        ob.body.attrs["value"].expr
                    )
        return self._outputs_cache


class _LazyLocals:
    """dict-like lazy evaluation of locals with cycle detection."""

    def __init__(self, module: ModuleEval):
        self.module = module
        self._cache: dict[str, object] = {}
        self._stack: set[str] = set()
        self._exprs: dict[str, P.Node] | None = None

    def _load_exprs(self):
        if self._exprs is None:
            self._exprs = {}
            for body in self.module.files.values():
                for lb in body.blocks_of("locals"):
                    for name, attr in lb.body.attrs.items():
                        self._exprs[name] = attr.expr

    def hcl_get_attr(self, name: str):
        self._load_exprs()
        if name in self._cache:
            return self._cache[name]
        expr = self._exprs.get(name)
        if expr is None or name in self._stack:
            return UNKNOWN
        self._stack.add(name)
        try:
            v = self.module.evaluator().eval(expr)
        finally:
            self._stack.discard(name)
        self._cache[name] = v
        return v

    # allow dict-style use by functions like merge(local.x, ...)
    def get(self, name, default=None):
        v = self.hcl_get_attr(name)
        return default if v is UNKNOWN else v


class _DataRoot:
    def __init__(self, module: ModuleEval):
        self.module = module

    def hcl_get_attr(self, name: str):
        refs = self.module._refs_for(("data", name))
        return refs if refs is not None else UNKNOWN


class _ModuleRoot:
    def __init__(self, module: ModuleEval):
        self.module = module

    def hcl_get_attr(self, name: str):
        child = self.module._modules.get(name)
        if child is None:
            return UNKNOWN
        return child.outputs()


class Loader:
    """Groups input files into module directories and drives evaluation."""

    def __init__(self, files: dict[str, str]):
        self.bodies: dict[str, P.Body] = {}
        self.tfvars_raw: dict[str, dict[str, P.Node]] = {}  # dir -> name -> expr
        self.child_dirs: set[str] = set()
        self.all_modules: list[ModuleEval] = []
        for path, text in files.items():
            try:
                if path.endswith(".tf.json"):
                    self.bodies[path] = _json_body(text)
                elif path.endswith(".tfvars"):
                    self._load_tfvars(path, text)
                elif path.endswith(".tf"):
                    self.bodies[path] = parse(text)
            except Exception as e:
                logger.debug("terraform parse failed for %s: %s", path, e)

    def _load_tfvars(self, path: str, text: str):
        base = os.path.basename(path)
        if base != "terraform.tfvars" and not base.endswith(".auto.tfvars"):
            return
        try:
            body = parse(text)
        except Exception as e:
            logger.debug("tfvars parse failed for %s: %s", path, e)
            return
        d = self.tfvars_raw.setdefault(os.path.dirname(path), {})
        for name, attr in body.attrs.items():
            d[name] = attr.expr

    def dir_bodies(self, dirname: str) -> dict[str, P.Body]:
        return {
            p: b for p, b in self.bodies.items() if os.path.dirname(p) == dirname
        }

    def tfvars_for(self, dirname: str) -> dict:
        exprs = self.tfvars_raw.get(dirname, {})
        ev = Evaluator({})
        return {k: ev.eval(e) for k, e in exprs.items()}

    def mark_child(self, dirname: str):
        self.child_dirs.add(dirname)

    def load(self) -> list[ModuleEval]:
        dirs = sorted({os.path.dirname(p) for p in self.bodies})
        # evaluate shallower dirs first so parents claim children before the
        # children are evaluated standalone
        for d in sorted(dirs, key=lambda x: x.count("/")):
            if d in self.child_dirs:
                continue
            mod = ModuleEval(self, d, self.dir_bodies(d))
            mod.prepare(self.tfvars_for(d))
            self.all_modules.append(mod)
        return [m for m in self.all_modules if m.dir not in self.child_dirs or m.inputs]


def _eval_block(block: P.Block, file: str, ev: Evaluator,
                skip_attrs: set | frozenset = frozenset()) -> BlockVal:
    bv = BlockVal(
        type=block.type,
        labels=list(block.labels),
        file=file,
        line=block.line,
        end_line=block.end_line,
    )
    for name, attr in block.body.attrs.items():
        if name in skip_attrs:
            continue
        bv.attrs[name] = Val(ev.eval(attr.expr), file, attr.line, attr.end_line)
    for child in block.body.blocks:
        if child.type == "dynamic" and child.labels:
            bv.children.extend(_expand_dynamic(child, file, ev))
        elif child.type in ("lifecycle", "provisioner", "connection"):
            continue
        else:
            bv.children.append(_eval_block(child, file, ev))
    return bv


def _expand_dynamic(block: P.Block, file: str, ev: Evaluator) -> list[BlockVal]:
    """dynamic "x" { for_each = ...; iterator = it?; content { ... } }"""
    name = block.labels[0]
    fe = block.body.attrs.get("for_each")
    content = None
    for c in block.body.blocks:
        if c.type == "content":
            content = c
    if fe is None or content is None:
        return []
    coll = ev.eval(fe.expr)
    iterator = name
    it_attr = block.body.attrs.get("iterator")
    if it_attr is not None:
        itv = ev.eval(it_attr.expr)
        if isinstance(itv, str):
            iterator = itv
        elif isinstance(it_attr.expr, P.Var):
            iterator = it_attr.expr.name
    if isinstance(coll, dict):
        pairs = list(coll.items())
    elif isinstance(coll, list):
        pairs = list(enumerate(coll))
    else:
        return []
    out = []
    for k, v in pairs[:_MAX_INSTANCES]:
        child_ev = ev.child({iterator: {"key": k, "value": v}})
        synthetic = P.Block(name, [], content.body, content.line, content.end_line)
        out.append(_eval_block(synthetic, file, child_ev))
    return out


def _json_body(text: str) -> P.Body:
    """Convert JSON-syntax terraform (.tf.json) into a synthetic Body."""
    doc = json.loads(text)
    return _json_to_body(doc)


_JSON_BLOCK_TYPES = {
    "resource": 2, "data": 2, "variable": 1, "output": 1, "module": 1,
    "provider": 1, "locals": 0, "terraform": 0,
}


def _json_to_body(doc: dict, line: int = 1) -> P.Body:
    body = P.Body()
    for key, val in doc.items():
        depth = _JSON_BLOCK_TYPES.get(key)
        if depth is None:
            body.attrs[key] = P.Attribute(key, _json_expr(val), line, line)
            continue
        for labels, inner in _json_label_walk(val, depth):
            if not isinstance(inner, dict):
                continue
            inner_body = _json_to_body(inner, line)
            body.blocks.append(P.Block(key, labels, inner_body, line, line))
    return body


def _json_label_walk(val, depth: int, labels: tuple = ()):
    if depth == 0:
        if isinstance(val, list):
            for v in val:
                yield list(labels), v
        else:
            yield list(labels), val
        return
    if isinstance(val, dict):
        for k, v in val.items():
            yield from _json_label_walk(v, depth - 1, labels + (k,))


def _json_expr(val) -> P.Node:
    if isinstance(val, str) and "${" in val:
        return P._heredoc_node(  # reuse template splitter
            __import__("trivy_tpu_torch.misconf.hcl.lexer", fromlist=["Token"]).Token(
                "HEREDOC", val, 1
            )
        )
    if isinstance(val, list):
        return P.TupleExpr(1, [_json_expr(v) for v in val])
    if isinstance(val, dict):
        return P.ObjectExpr(
            1, [(P.Literal(1, k), _json_expr(v)) for k, v in val.items()]
        )
    return P.Literal(1, val)


def load(files: dict[str, str]) -> list[BlockVal]:
    """Evaluate terraform sources → expanded resource/data BlockVals
    (child-module resources included, evaluated with their parents' inputs)."""
    loader = Loader(files)
    loader.load()
    out: list[BlockVal] = []
    for mod in loader.all_modules:
        for inst in mod.instances:
            try:
                out.append(inst.to_block_val())
            except Exception as e:
                logger.debug("terraform eval failed for %s: %s", inst.address, e)
    return out
