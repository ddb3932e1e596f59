"""User-supplied custom checks — the rego-custom-check replacement (the
port of ``trivy_tpu/misconf/custom.py``; one check file loads into either
package unchanged).

The reference loads user rego policies from ``--config-check`` paths and
evaluates them beside the builtin bundle (ref: pkg/iac/rego/scanner.go
custom-check loading; pkg/misconf/scanner.go check_paths plumbing). Here a
custom check is a Python file declaring checks with the :func:`check` /
:func:`cloud_check` decorators; loaded checks join the same registries the
builtins live in, so disable-lists, namespaces and report rendering treat
them identically.

A check file looks like::

    @check(id="USR-001", severity="HIGH", types=("yaml",),
           title="deny latest tags")
    def no_latest(docs):
        for doc in docs:
            tag = str((doc or {}).get("image", ""))
            if tag.endswith(":latest"):
                yield Failure("image uses :latest", start_line=doc.line("image"))

``types`` routes the check: dockerfile/kubernetes checks receive the same
parsed inputs the builtins do; yaml/json checks receive the line-tracking
document list. ``cloud_check(targets=...)`` registers a typed-state check
(terraform + cloudformation + azure-arm states).
"""

from __future__ import annotations

import os
import threading

from trivy_tpu_torch import log
from trivy_tpu_torch.misconf.checks import (
    Check,
    CloudFailure,
    Failure,
    register,
    register_cloud,
    unregister,
)

logger = log.logger("misconf:custom")

# (realpath, content-hash) of loaded files: re-loading an unchanged file is
# a no-op; a rewritten file re-registers its checks
_loaded_files: set[tuple[str, str]] = set()
# id → source path for custom checks: same-file reload replaces silently,
# a second file claiming an existing id replaces with a warning; colliding
# with a builtin still errors
_custom_ids: dict[str, str] = {}


class CustomCheckError(ValueError):
    pass


def _replace_existing(check_id: str, source_path: str) -> None:
    prev = _custom_ids.get(check_id)
    if prev is None:
        return  # not custom: builtin collision errors inside register()
    if os.path.realpath(prev) != os.path.realpath(source_path):
        logger.warning(
            "custom check %s from %s replaces the one from %s",
            check_id, source_path, prev,
        )
    unregister(check_id)


def _make_namespace(source_path: str) -> dict:
    registered: list[str] = []

    def check(
        id: str,
        severity: str,
        title: str,
        types=("yaml", "json"),
        description: str = "",
        resolution: str = "",
        url: str = "",
        service: str = "custom",
        provider: str = "",
    ):
        def wrap(fn):
            _replace_existing(id, source_path)
            register(
                Check(
                    id=id,
                    avd_id=id,
                    title=title,
                    severity=severity.upper(),
                    file_types=tuple(types),
                    fn=fn,
                    description=description,
                    resolution=resolution,
                    url=url,
                    service=service,
                    provider=provider,
                )
            )
            _custom_ids[id] = source_path
            registered.append(id)
            return fn

        return wrap

    def cloud_check(
        id: str,
        severity: str,
        title: str,
        targets: str,
        types=("terraform", "cloudformation"),
        description: str = "",
        resolution: str = "",
        url: str = "",
        service: str = "custom",
        provider: str = "",
    ):
        def wrap(fn):
            _replace_existing(id, source_path)
            register_cloud(
                Check(
                    id=id,
                    avd_id=id,
                    title=title,
                    severity=severity.upper(),
                    file_types=tuple(types),
                    fn=fn,
                    description=description,
                    resolution=resolution,
                    url=url,
                    service=service,
                    provider=provider,
                    targets=targets,
                )
            )
            _custom_ids[id] = source_path
            registered.append(id)
            return fn

        return wrap

    return {
        "check": check,
        "cloud_check": cloud_check,
        "Failure": Failure,
        "CloudFailure": CloudFailure,
        "__file__": source_path,
        "__name__": f"trivy_custom_check:{os.path.basename(source_path)}",
        "_registered": registered,
    }


def _load_file(path: str) -> int:
    import hashlib

    with open(path, "r", encoding="utf-8") as f:
        source = f.read()
    key = (os.path.realpath(path), hashlib.sha256(source.encode()).hexdigest())
    if key in _loaded_files:
        return 0
    ns = _make_namespace(path)
    try:
        code = compile(source, path, "exec")
        exec(code, ns)  # noqa: S102 — explicit user-supplied check file
    except CustomCheckError:
        raise
    except Exception as e:
        raise CustomCheckError(f"custom check file {path} failed to load: {e}") from e
    _loaded_files.add(key)
    n = len(ns["_registered"])
    logger.debug("loaded %d custom checks from %s", n, path)
    return n


# -- rego custom checks -------------------------------------------------------


def _rego_comment_metadata(source: str) -> dict:
    """``# METADATA`` yaml comment block (the modern check annotation
    format, ref: pkg/iac/rego metadata parsing)."""
    import yaml

    lines = source.splitlines()
    for i, line in enumerate(lines):
        if line.strip() == "# METADATA":
            block = []
            for cont in lines[i + 1 :]:
                s = cont.strip()
                if not s.startswith("#"):
                    break
                block.append(s[1:].removeprefix(" "))
            try:
                doc = yaml.safe_load("\n".join(block)) or {}
                return doc if isinstance(doc, dict) else {}
            except yaml.YAMLError:
                return {}
    return {}


def _rego_input_types(meta: dict, legacy_input: dict) -> tuple:
    sel = (
        ((meta.get("custom") or {}).get("input") or {}).get("selector")
        or (legacy_input or {}).get("selector")
        or []
    )
    types = []
    for s in sel:
        t = (s or {}).get("type", "")
        if t in ("kubernetes", "rbac"):
            types.append("kubernetes")
        elif t == "dockerfile":
            types.append("dockerfile")
        elif t in ("yaml", "json", "toml", "cloud"):
            types.extend(["yaml", "json"])
    return tuple(dict.fromkeys(types)) or ("kubernetes", "yaml", "json")


def _dockerfile_input(df) -> dict:
    """The reference's dockerfile rego input shape (Stages/Commands)."""
    stages = []
    for st in df.stages:
        cmds = []
        for ins in st.instructions:
            cmds.append({
                "Cmd": ins.cmd.lower(),
                "Value": ins.args,
                "Original": f"{ins.cmd} {ins.value}",
                "StartLine": ins.start_line,
                "EndLine": ins.end_line,
                "Flags": [f"--{k}={v}" if v else f"--{k}" for k, v in ins.flags.items()],
                "JSON": ins.json_form,
                "Stage": len(stages),
            })
        stages.append({"Name": st.base + (f" as {st.name}" if st.name else ""),
                       "Commands": cmds})
    return {"Stages": stages}


def _rego_check_fn(mod, types: tuple):
    """Adapt the scanner's per-type parsed input to rego ``input`` docs and
    evaluate every deny/violation/warn rule."""
    from trivy_tpu_torch import rego as _rego

    rule_names = [
        n for n in mod.rule_names()
        if n == "deny" or n.startswith(("deny_", "violation", "warn"))
    ]

    def to_inputs(parsed):
        docs = []
        if hasattr(parsed, "stages"):  # Dockerfile
            docs.append((_dockerfile_input(parsed), 0))
        elif isinstance(parsed, list):
            for item in parsed:
                raw = getattr(item, "raw", item)  # kubernetes Workload
                if isinstance(raw, dict):
                    docs.append((raw, getattr(raw, "span", (0, 0))[0]))
        elif isinstance(parsed, dict):
            docs.append((parsed, getattr(parsed, "span", (0, 0))[0]))
        return docs

    def fn(parsed):
        for doc, line in to_inputs(parsed):
            for rname in rule_names:
                try:
                    members = mod.eval_rule(rname, input=doc) or []
                except _rego.RegoError as e:
                    raise CustomCheckError(
                        f"rego check rule {rname!r}: {e}"
                    ) from e
                if members is True:  # complete `deny { ... }` style
                    members = ["policy failed"]
                if not isinstance(members, (list, set, tuple)):
                    continue
                for m in members:
                    if isinstance(m, dict):
                        yield Failure(
                            str(m.get("msg", m)),
                            start_line=int(m.get("startline", 0) or line),
                            end_line=int(m.get("endline", 0) or 0),
                        )
                    else:
                        yield Failure(str(m), start_line=line)

    return fn


def _load_rego_file(path: str) -> int:
    """Register one ``.rego`` check file (ref: pkg/iac/rego/scanner.go
    custom-check loading). Metadata comes from the ``# METADATA`` comment
    block or the legacy ``__rego_metadata__`` rule; unsupported rego
    constructs surface as CustomCheckError naming the construct."""
    import hashlib

    from trivy_tpu_torch import rego as _rego

    with open(path, "r", encoding="utf-8") as f:
        source = f.read()
    key = (os.path.realpath(path), hashlib.sha256(source.encode()).hexdigest())
    if key in _loaded_files:
        return 0
    try:
        mod = _rego.parse_module(source)
    except _rego.RegoError as e:
        raise CustomCheckError(f"rego check {path}: {e}") from e
    comment_meta = _rego_comment_metadata(source)
    legacy_meta = mod.metadata()
    legacy_meta = legacy_meta if isinstance(legacy_meta, dict) else {}
    try:
        legacy_input = mod.eval_rule("__rego_input__") or {}
    except _rego.RegoError:
        legacy_input = {}
    custom = comment_meta.get("custom") or {}
    check_id = str(
        custom.get("id")
        or legacy_meta.get("id")
        or "-".join(p.upper() for p in mod.package[-2:])
    )
    severity = str(
        custom.get("severity") or legacy_meta.get("severity") or "MEDIUM"
    ).upper()
    title = str(
        comment_meta.get("title") or legacy_meta.get("title") or check_id
    )
    types = _rego_input_types(comment_meta, legacy_input)
    _replace_existing(check_id, path)
    register(
        Check(
            id=check_id,
            avd_id=str(custom.get("avd_id") or check_id),
            title=title,
            severity=severity,
            file_types=types,
            fn=_rego_check_fn(mod, types),
            description=str(
                comment_meta.get("description")
                or legacy_meta.get("description") or ""
            ),
            url=str(legacy_meta.get("url") or ""),
            service=str(custom.get("service") or "custom"),
        )
    )
    _custom_ids[check_id] = path
    _loaded_files.add(key)
    logger.debug("loaded rego check %s from %s", check_id, path)
    return 1


_load_lock = threading.Lock()


def load_custom_checks(paths: list[str]) -> int:
    """Load all ``*.py`` and ``*.rego`` check files from the given
    files/dirs; returns the number of newly registered checks. One load at
    a time: the layers of an image finalize at once, each loading the same
    files."""
    with _load_lock:
        return _load_paths(paths)


def _load_paths(paths: list[str]) -> int:
    # builtins first so collisions with builtin ids fail loudly here
    from trivy_tpu_torch.misconf import checks as _checks

    _checks.all_checks()
    total = 0
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, names in os.walk(p):
                for name in sorted(names):
                    if name.endswith(".py"):
                        total += _load_file(os.path.join(root, name))
                    elif name.endswith(".rego") and not name.endswith("_test.rego"):
                        total += _load_rego_file(os.path.join(root, name))
        elif p.endswith(".py"):
            total += _load_file(p)
        elif p.endswith(".rego"):
            total += _load_rego_file(p)
        else:
            raise CustomCheckError(
                f"custom check path {p} is neither a directory nor a "
                ".py/.rego file"
            )
    return total
