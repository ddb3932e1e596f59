"""Azure ARM template scanning.

Independent equivalent of the reference's ARM scanner
(ref: pkg/iac/scanners/azure/arm/parser/parser.go — template + parameter
resolution; pkg/iac/scanners/azure/expressions — the ``[...]`` expression
language; pkg/iac/adapters/arm — typed state adaption). Templates are
loaded through the line-tracking YAML path so causes carry line spans, ARM
expressions (``parameters()``, ``variables()``, ``concat()``, ...) are
evaluated with a small recursive-descent evaluator, resources become
:class:`BlockVal` trees, and azure cloud checks run over a typed
:class:`AzureState` via the shared cloud-check engine.

AVD-AZU ids follow the public avd.aquasec.com metadata (best effort — the
ids are the reporting/suppression interface; the check logic is this
repo's own).

The port of ``trivy_tpu/misconf/arm.py``.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

from trivy_tpu_torch import log
from trivy_tpu_torch.misconf.checks import Check, CloudFailure, evaluate_cloud, register_cloud
from trivy_tpu_torch.misconf.hcl.functions import UNKNOWN
from trivy_tpu_torch.misconf.parse import yamljson
from trivy_tpu_torch.misconf.state import BlockVal, Val

logger = log.logger("misconf:arm")

FILE_TYPE = "azure-arm"


# ---------------------------------------------------------------------------
# expression language: [func('lit', nested(...)).prop] inside string values
# ---------------------------------------------------------------------------


class _ExprError(ValueError):
    pass


class _Parser:
    def __init__(self, text: str, ctx: "_Ctx"):
        self.text = text
        self.pos = 0
        self.ctx = ctx

    def _peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def _skip_ws(self) -> None:
        while self._peek() and self._peek() in " \t\r\n":
            self.pos += 1

    def parse(self):
        val = self._expr()
        self._skip_ws()
        if self.pos != len(self.text):
            raise _ExprError(f"trailing input at {self.pos}: {self.text!r}")
        return val

    def _expr(self):
        self._skip_ws()
        ch = self._peek()
        if ch == "'":
            val = self._string()
        elif ch.isdigit() or ch == "-":
            val = self._number()
        elif ch.isalpha() or ch == "_":
            val = self._call_or_ident()
        else:
            raise _ExprError(f"unexpected char {ch!r} at {self.pos}")
        return self._postfix(val)

    def _string(self) -> str:
        # single quotes; '' escapes a quote
        assert self._peek() == "'"
        self.pos += 1
        out = []
        while True:
            if self.pos >= len(self.text):
                raise _ExprError("unterminated string")
            c = self.text[self.pos]
            if c == "'":
                if self.text[self.pos + 1 : self.pos + 2] == "'":
                    out.append("'")
                    self.pos += 2
                    continue
                self.pos += 1
                return "".join(out)
            out.append(c)
            self.pos += 1

    def _number(self):
        start = self.pos
        if self._peek() == "-":
            self.pos += 1
        while self._peek().isdigit():
            self.pos += 1
        if self._peek() == ".":
            self.pos += 1
            while self._peek().isdigit():
                self.pos += 1
            return float(self.text[start : self.pos])
        return int(self.text[start : self.pos])

    def _ident(self) -> str:
        start = self.pos
        while self._peek().isalnum() or self._peek() == "_":
            self.pos += 1
        return self.text[start : self.pos]

    def _call_or_ident(self):
        name = self._ident()
        self._skip_ws()
        if self._peek() != "(":
            if name == "true":
                return True
            if name == "false":
                return False
            if name == "null":
                return None
            raise _ExprError(f"bare identifier {name!r}")
        self.pos += 1  # (
        args = []
        self._skip_ws()
        if self._peek() == ")":
            self.pos += 1
        else:
            while True:
                args.append(self._expr())
                self._skip_ws()
                c = self._peek()
                if c == ",":
                    self.pos += 1
                    continue
                if c == ")":
                    self.pos += 1
                    break
                raise _ExprError(f"expected , or ) at {self.pos}")
        return self.ctx.call(name, args)

    def _postfix(self, val):
        while True:
            self._skip_ws()
            c = self._peek()
            if c == ".":
                self.pos += 1
                key = self._ident()
                val = _get_member(val, key)
            elif c == "[":
                self.pos += 1
                idx = self._expr()
                self._skip_ws()
                if self._peek() != "]":
                    raise _ExprError("expected ]")
                self.pos += 1
                val = _get_member(val, idx)
            else:
                return val


def _get_member(val, key):
    if val is UNKNOWN:
        return UNKNOWN
    try:
        if isinstance(val, dict):
            return val.get(key, UNKNOWN)
        if isinstance(val, (list, str)) and isinstance(key, int):
            return val[key]
    except Exception:
        return UNKNOWN
    return UNKNOWN


def _as_str(v) -> str:
    if v is UNKNOWN or v is None:
        return ""
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


class _Ctx:
    """Deployment-scope context: parameters, variables, builtin functions
    (ref: pkg/iac/scanners/azure/functions)."""

    def __init__(self, parameters: dict, variables: dict):
        self.parameters = parameters
        self._raw_variables = variables
        self.variables: dict = {}
        self._resolving: set[str] = set()

    def variable(self, name: str):
        if name in self.variables:
            return self.variables[name]
        if name in self._resolving or name not in self._raw_variables:
            return UNKNOWN
        self._resolving.add(name)
        try:
            val = eval_value(self._raw_variables[name], self)
        finally:
            self._resolving.discard(name)
        self.variables[name] = val
        return val

    def call(self, name: str, args: list):
        fn = getattr(self, f"_fn_{name.lower()}", None)
        if fn is None:
            return UNKNOWN
        try:
            return fn(*args)
        except Exception:
            return UNKNOWN

    # -- template access -----------------------------------------------------

    def _fn_parameters(self, name):
        return self.parameters.get(name, UNKNOWN)

    def _fn_variables(self, name):
        return self.variable(name)

    # -- strings -------------------------------------------------------------

    def _fn_concat(self, *args):
        if any(a is UNKNOWN for a in args):
            return UNKNOWN
        if args and isinstance(args[0], list):
            out = []
            for a in args:
                out.extend(a if isinstance(a, list) else [a])
            return out
        return "".join(_as_str(a) for a in args)

    def _fn_format(self, fmt, *args):
        if fmt is UNKNOWN or any(a is UNKNOWN for a in args):
            return UNKNOWN
        out = str(fmt)
        for i, a in enumerate(args):
            out = out.replace("{%d}" % i, _as_str(a))
        return out

    def _fn_tolower(self, s):
        return s.lower() if isinstance(s, str) else UNKNOWN

    def _fn_toupper(self, s):
        return s.upper() if isinstance(s, str) else UNKNOWN

    def _fn_substring(self, s, start, length=None):
        if not isinstance(s, str):
            return UNKNOWN
        return s[start : start + length] if length is not None else s[start:]

    def _fn_replace(self, s, old, new):
        return s.replace(old, new) if isinstance(s, str) else UNKNOWN

    def _fn_split(self, s, sep):
        if not isinstance(s, str):
            return UNKNOWN
        seps = sep if isinstance(sep, list) else [sep]
        out = [s]
        for sp in seps:
            out = [piece for part in out for piece in part.split(sp)]
        return out

    def _fn_trim(self, s):
        return s.strip() if isinstance(s, str) else UNKNOWN

    def _fn_startswith(self, s, pre):
        return s.startswith(pre) if isinstance(s, str) else UNKNOWN

    def _fn_endswith(self, s, suf):
        return s.endswith(suf) if isinstance(s, str) else UNKNOWN

    def _fn_string(self, v):
        return _as_str(v) if v is not UNKNOWN else UNKNOWN

    def _fn_uniquestring(self, *args):
        if any(a is UNKNOWN for a in args):
            return UNKNOWN
        h = hashlib.sha256("|".join(_as_str(a) for a in args).encode()).hexdigest()
        return h[:13]

    def _fn_guid(self, *args):
        return self._fn_uniquestring(*args)

    # -- logic ---------------------------------------------------------------

    def _fn_if(self, cond, a, b):
        if cond is UNKNOWN:
            return UNKNOWN
        return a if cond else b

    def _fn_equals(self, a, b):
        if a is UNKNOWN or b is UNKNOWN:
            return UNKNOWN
        return a == b

    def _fn_not(self, a):
        return UNKNOWN if a is UNKNOWN else not a

    def _fn_and(self, *args):
        return all(bool(a) and a is not UNKNOWN for a in args)

    def _fn_or(self, *args):
        return any(a is not UNKNOWN and bool(a) for a in args)

    def _fn_coalesce(self, *args):
        for a in args:
            if a is not None and a is not UNKNOWN:
                return a
        return None

    def _fn_empty(self, v):
        if v is UNKNOWN:
            return UNKNOWN
        return v is None or v == "" or v == [] or v == {}

    def _fn_contains(self, container, item):
        if container is UNKNOWN or item is UNKNOWN:
            return UNKNOWN
        try:
            if isinstance(container, dict):
                return item in container
            return item in container
        except Exception:
            return UNKNOWN

    # -- collections / numbers ----------------------------------------------

    def _fn_length(self, v):
        return len(v) if v is not UNKNOWN and v is not None else UNKNOWN

    def _fn_first(self, v):
        return v[0] if isinstance(v, (list, str)) and v else UNKNOWN

    def _fn_last(self, v):
        return v[-1] if isinstance(v, (list, str)) and v else UNKNOWN

    def _fn_union(self, *args):
        if any(a is UNKNOWN for a in args):
            return UNKNOWN
        if args and isinstance(args[0], dict):
            out: dict = {}
            for a in args:
                out.update(a)
            return out
        out_l: list = []
        for a in args:
            for item in a:
                if item not in out_l:
                    out_l.append(item)
        return out_l

    def _fn_createarray(self, *args):
        return list(args)

    def _fn_createobject(self, *args):
        return {args[i]: args[i + 1] for i in range(0, len(args) - 1, 2)}

    def _fn_min(self, *args):
        return min(args[0] if len(args) == 1 else args)

    def _fn_max(self, *args):
        return max(args[0] if len(args) == 1 else args)

    def _fn_add(self, a, b):
        return a + b

    def _fn_sub(self, a, b):
        return a - b

    def _fn_mul(self, a, b):
        return a * b

    def _fn_div(self, a, b):
        return a // b

    def _fn_mod(self, a, b):
        return a % b

    def _fn_int(self, v):
        return int(v)

    def _fn_bool(self, v):
        if isinstance(v, str):
            return v.lower() == "true"
        return bool(v)

    # -- environment placeholders (unresolvable statically) -------------------

    def _fn_resourcegroup(self):
        return {"name": "resource-group", "location": "eastus", "id": "/resource-group"}

    def _fn_subscription(self):
        return {"subscriptionId": "subscription-id", "tenantId": "tenant-id"}

    def _fn_deployment(self):
        return {"name": "deployment"}

    def _fn_resourceid(self, *args):
        return "/".join(_as_str(a) for a in args if a is not UNKNOWN)

    def _fn_reference(self, *args):
        return UNKNOWN

    def _fn_copyindex(self, *args):
        return 0

    def _fn_utcnow(self, *args):
        return "2024-01-01T00:00:00Z"

    def _fn_newguid(self):
        return "00000000-0000-0000-0000-000000000000"


def eval_value(v, ctx: _Ctx):
    """Evaluate a template value: descend containers, eval ``[...]`` strings."""
    if isinstance(v, str):
        if v.startswith("[[") :
            return v[1:]  # escaped literal bracket
        if v.startswith("[") and v.endswith("]"):
            try:
                return _Parser(v[1:-1], ctx).parse()
            except Exception as e:  # malformed expression → unknown, not fatal
                logger.debug("ARM expression failed %r: %s", v, e)
                return UNKNOWN
        return v
    if isinstance(v, dict):
        return {k: eval_value(val, ctx) for k, val in v.items()}
    if isinstance(v, list):
        return [eval_value(item, ctx) for item in v]
    return v


# ---------------------------------------------------------------------------
# template → BlockVal resources
# ---------------------------------------------------------------------------


def load(path: str, content: bytes) -> list[BlockVal]:
    """Parse + resolve an ARM template into evaluated resource blocks."""
    docs = yamljson.load_all(content)
    if not docs or not isinstance(docs[0], dict):
        return []
    tpl = docs[0]
    params: dict = {}
    for name, spec in (tpl.get("parameters") or {}).items():
        if isinstance(spec, dict) and "defaultValue" in spec:
            params[name] = spec["defaultValue"]
    ctx = _Ctx(params, tpl.get("variables") or {})
    # parameter defaults may themselves contain expressions
    ctx.parameters = {k: eval_value(v, ctx) for k, v in params.items()}
    out = []
    for res in tpl.get("resources") or []:
        if isinstance(res, dict):
            out.append(_to_block(res, path, ctx))
    return out


def _val(value, path: str, span) -> Val:
    return Val(value, path, span[0], span[1])


def _to_block(res: dict, path: str, ctx: _Ctx) -> BlockVal:
    span = getattr(res, "span", (0, 0))
    rtype = _as_str(eval_value(res.get("type", ""), ctx))
    name = _as_str(eval_value(res.get("name", ""), ctx))
    block = BlockVal(
        type=rtype, labels=[name], file=path, line=span[0], end_line=span[1]
    )
    for key, raw in res.items():
        if key == "resources":
            continue
        kspan = res.key_spans.get(key, span) if hasattr(res, "key_spans") else span
        evaluated = eval_value(raw, ctx)
        block.attrs[key] = _val(evaluated, path, kspan)
        if isinstance(raw, dict):
            block.children.append(_dict_block(key, raw, path, ctx))
        elif isinstance(raw, list) and any(isinstance(i, dict) for i in raw):
            for item in raw:
                if isinstance(item, dict):
                    block.children.append(_dict_block(key, item, path, ctx))
    for sub in res.get("resources") or []:
        if isinstance(sub, dict):
            block.children.append(_to_block(sub, path, ctx))
    return block


def _dict_block(btype: str, d: dict, path: str, ctx: _Ctx) -> BlockVal:
    span = getattr(d, "span", (0, 0))
    block = BlockVal(type=btype, file=path, line=span[0], end_line=span[1])
    for key, raw in d.items():
        kspan = d.key_spans.get(key, span) if hasattr(d, "key_spans") else span
        block.attrs[key] = _val(eval_value(raw, ctx), path, kspan)
        if isinstance(raw, dict):
            block.children.append(_dict_block(key, raw, path, ctx))
        elif isinstance(raw, list) and any(isinstance(i, dict) for i in raw):
            for item in raw:
                if isinstance(item, dict):
                    block.children.append(_dict_block(key, item, path, ctx))
    return block


# ---------------------------------------------------------------------------
# typed azure state + adapters (ref: pkg/iac/adapters/arm)
# ---------------------------------------------------------------------------


def _v(value=None) -> Val:
    return Val(value, explicit=False)


@dataclass
class AzRes:
    resource: BlockVal = field(default_factory=BlockVal)

    @property
    def address(self) -> str:
        return f"{self.resource.type}/{self.resource.name}"

    def anchor(self) -> Val:
        return Val(None, self.resource.file, self.resource.line, self.resource.line)


@dataclass
class AzContainer(AzRes):
    public_access: Val = field(default_factory=_v)


@dataclass
class AzStorageAccount(AzRes):
    enforce_https: Val = field(default_factory=_v)
    min_tls_version: Val = field(default_factory=_v)
    network_default_allow: Val = field(default_factory=_v)
    containers: list[AzContainer] = field(default_factory=list)


@dataclass
class AzNSGRule(AzRes):
    allow: Val = field(default_factory=_v)
    outbound: Val = field(default_factory=_v)
    source_addresses: Val = field(default_factory=_v)  # list[str]
    dest_ports: Val = field(default_factory=_v)  # list[str] ranges


@dataclass
class AzVM(AzRes):
    password_auth_disabled: Val = field(default_factory=_v)


@dataclass
class AzKeyVault(AzRes):
    purge_protection: Val = field(default_factory=_v)
    network_default_allow: Val = field(default_factory=_v)


@dataclass
class AzAKSCluster(AzRes):
    rbac_enabled: Val = field(default_factory=_v)
    network_policy: Val = field(default_factory=_v)
    private_cluster: Val = field(default_factory=_v)
    authorized_ip_ranges: Val = field(default_factory=_v)  # list
    logging_enabled: Val = field(default_factory=_v)


@dataclass
class AzSQLServer(AzRes):
    auditing_enabled: Val = field(default_factory=_v)
    audit_retention_days: Val = field(default_factory=_v)
    public_network_access: Val = field(default_factory=_v)
    min_tls: Val = field(default_factory=_v)
    firewall_open_to_internet: list[Val] = field(default_factory=list)
    ssl_enforce: Val = field(default_factory=_v)  # postgres/mysql flavors
    flavor: str = "mssql"  # mssql | postgresql | mysql


@dataclass
class AzAppService(AzRes):
    https_only: Val = field(default_factory=_v)
    min_tls: Val = field(default_factory=_v)
    client_cert: Val = field(default_factory=_v)
    http2: Val = field(default_factory=_v)
    identity: Val = field(default_factory=_v)


@dataclass
class AzKeyVaultObject(AzRes):
    kind: str = "secret"  # secret | key
    expiry_set: Val = field(default_factory=_v)
    content_type: Val = field(default_factory=_v)


@dataclass
class AzureState:
    provider = "azure"

    az_storage_accounts: list[AzStorageAccount] = field(default_factory=list)
    az_nsg_rules: list[AzNSGRule] = field(default_factory=list)
    az_virtual_machines: list[AzVM] = field(default_factory=list)
    az_key_vaults: list[AzKeyVault] = field(default_factory=list)
    az_aks_clusters: list[AzAKSCluster] = field(default_factory=list)
    az_sql_servers: list[AzSQLServer] = field(default_factory=list)
    az_app_services: list[AzAppService] = field(default_factory=list)
    az_key_vault_objects: list[AzKeyVaultObject] = field(default_factory=list)


def _props(block: BlockVal) -> BlockVal:
    return block.block("properties") or BlockVal(
        file=block.file, line=block.line, end_line=block.end_line
    )


def adapt(resources: list[BlockVal]) -> AzureState:
    state = AzureState()
    consumed_containers: set[int] = set()
    for block in _walk(resources):
        t = block.type.lower()
        if t == "microsoft.storage/storageaccounts":
            acct = _adapt_storage(block)
            consumed_containers.update(id(c.resource) for c in acct.containers)
            state.az_storage_accounts.append(acct)
        elif t.endswith("blobservices/containers") and "storage" in t:
            # standalone container resource (unless already consumed as a
            # nested child by its account): attach to last account if any
            if id(block) in consumed_containers:
                continue
            cont = _adapt_container(block)
            if state.az_storage_accounts:
                state.az_storage_accounts[-1].containers.append(cont)
            else:
                acct = AzStorageAccount(resource=block)
                acct.containers.append(cont)
                state.az_storage_accounts.append(acct)
        elif t == "microsoft.network/networksecuritygroups":
            state.az_nsg_rules.extend(_adapt_nsg(block))
        elif t.endswith("/securityrules") and "networksecuritygroups" in t:
            state.az_nsg_rules.append(_adapt_nsg_rule(block, _props(block)))
        elif t in (
            "microsoft.compute/virtualmachines",
            "microsoft.compute/virtualmachinescalesets",
        ):
            state.az_virtual_machines.append(_adapt_vm(block))
        elif t == "microsoft.keyvault/vaults":
            state.az_key_vaults.append(_adapt_keyvault(block))
    return state


def _walk(blocks: list[BlockVal]):
    for b in blocks:
        yield b
        # nested resource declarations keep full or relative types
        for c in b.children:
            if c.type and ("/" in c.type or c.type[:1].isupper()):
                yield from _walk([c])


def _adapt_storage(block: BlockVal) -> AzStorageAccount:
    p = _props(block)
    acct = AzStorageAccount(
        resource=block,
        enforce_https=p.get("supportsHttpsTrafficOnly", False),
        min_tls_version=p.get("minimumTlsVersion", ""),
    )
    acls = p.block("networkAcls")
    if acls is not None:
        default_action = acls.get("defaultAction", "Allow")
        acct.network_default_allow = default_action.with_value(
            str(default_action.value).lower() == "allow"
        )
    for child in block.children:
        if child.type.lower().endswith("containers"):
            acct.containers.append(_adapt_container(child))
    return acct


def _adapt_container(block: BlockVal) -> AzContainer:
    p = _props(block)
    return AzContainer(resource=block, public_access=p.get("publicAccess", "None"))


def _adapt_nsg(block: BlockVal) -> list[AzNSGRule]:
    p = _props(block)
    out = []
    for rule in p.blocks("securityRules"):
        rp = rule.block("properties") or rule
        out.append(_adapt_nsg_rule(rule, rp))
    return out


def _adapt_nsg_rule(anchor: BlockVal, rp: BlockVal) -> AzNSGRule:
    sources = []
    sa = rp.get("sourceAddressPrefix", None)
    if sa.value is not None:
        sources.append(_as_str(sa.value))
    for extra in rp.get("sourceAddressPrefixes", []).list():
        sources.append(_as_str(extra))
    ports = []
    dp = rp.get("destinationPortRange", None)
    if dp.value is not None:
        ports.append(_as_str(dp.value))
    for extra in rp.get("destinationPortRanges", []).list():
        ports.append(_as_str(extra))
    return AzNSGRule(
        resource=anchor,
        allow=rp.get("access", "Deny").with_value(
            str(rp.get("access", "Deny").value).lower() == "allow"
        ),
        outbound=rp.get("direction", "Inbound").with_value(
            str(rp.get("direction", "Inbound").value).lower() == "outbound"
        ),
        source_addresses=rp.get("sourceAddressPrefix", None).with_value(sources),
        dest_ports=rp.get("destinationPortRange", None).with_value(ports),
    )


def _adapt_vm(block: BlockVal) -> AzVM:
    p = _props(block)
    vm = AzVM(resource=block)
    os_profile = p.block("osProfile")
    if os_profile is None:
        vp = p.block("virtualMachineProfile")
        os_profile = vp.block("osProfile") if vp is not None else None
    if os_profile is not None:
        linux = os_profile.block("linuxConfiguration")
        if linux is not None:
            vm.password_auth_disabled = linux.get("disablePasswordAuthentication", False)
    return vm


def _adapt_keyvault(block: BlockVal) -> AzKeyVault:
    p = _props(block)
    kv = AzKeyVault(
        resource=block, purge_protection=p.get("enablePurgeProtection", False)
    )
    acls = p.block("networkAcls")
    if acls is not None:
        default_action = acls.get("defaultAction", "Allow")
        kv.network_default_allow = default_action.with_value(
            str(default_action.value).lower() == "allow"
        )
    return kv


# ---------------------------------------------------------------------------
# azure checks
# ---------------------------------------------------------------------------

_URL = "https://avd.aquasec.com/misconfig/{}"


def _check(id_, title, severity, service, targets, desc="", res=""):
    def wrap(fn):
        register_cloud(
            Check(
                id=id_,
                avd_id=id_,
                title=title,
                severity=severity,
                file_types=(FILE_TYPE, "terraform"),
                fn=fn,
                description=desc,
                resolution=res,
                url=_URL.format(id_.lower()),
                service=service,
                provider="azure",
                targets=targets,
            )
        )
        return fn

    return wrap


@_check(
    "AVD-AZU-0008",
    "Storage accounts should enforce HTTPS",
    "HIGH",
    "storage",
    "az_storage_accounts",
    desc="Requiring secure transfer ensures data in flight is encrypted.",
    res="Set supportsHttpsTrafficOnly to true.",
)
def _storage_https(state: AzureState):
    for acct in state.az_storage_accounts:
        if not acct.enforce_https.bool(False):
            yield CloudFailure(
                "Account does not enforce HTTPS.",
                val=acct.enforce_https if acct.enforce_https.is_set() else acct.anchor(),
                resource=acct.address,
            )


@_check(
    "AVD-AZU-0011",
    "Storage accounts should use a secure TLS policy",
    "CRITICAL",
    "storage",
    "az_storage_accounts",
    desc="TLS versions below 1.2 have known vulnerabilities.",
    res="Set minimumTlsVersion to TLS1_2.",
)
def _storage_tls(state: AzureState):
    for acct in state.az_storage_accounts:
        tls = acct.min_tls_version.str()
        if tls != "TLS1_2":
            yield CloudFailure(
                f"Account uses an insecure minimum TLS version {tls or '(unset)'}.",
                val=acct.min_tls_version if acct.min_tls_version.is_set() else acct.anchor(),
                resource=acct.address,
            )


@_check(
    "AVD-AZU-0007",
    "Storage containers should not allow public access",
    "HIGH",
    "storage",
    "az_storage_accounts",
    desc="Anonymous public read access exposes container contents.",
    res="Set publicAccess to None.",
)
def _container_public(state: AzureState):
    for acct in state.az_storage_accounts:
        for cont in acct.containers:
            access = cont.public_access.str("None")
            if access.lower() not in ("", "none"):
                yield CloudFailure(
                    f"Container allows public access ({access}).",
                    val=cont.public_access if cont.public_access.is_set() else cont.anchor(),
                    resource=cont.address,
                )


@_check(
    "AVD-AZU-0012",
    "Storage account network rules should deny by default",
    "MEDIUM",
    "storage",
    "az_storage_accounts",
    desc="A default-allow network ACL exposes the account to all networks.",
    res="Set networkAcls.defaultAction to Deny.",
)
def _storage_default_action(state: AzureState):
    for acct in state.az_storage_accounts:
        if acct.network_default_allow.is_set() and acct.network_default_allow.bool(False):
            yield CloudFailure(
                "Account network ACL default action is Allow.",
                val=acct.network_default_allow,
                resource=acct.address,
            )


_PUBLIC_SOURCES = ("*", "0.0.0.0/0", "::/0", "internet", "any")


@_check(
    "AVD-AZU-0047",
    "An inbound network security rule allows traffic from the public internet",
    "CRITICAL",
    "network",
    "az_nsg_rules",
    desc="Inbound rules open to * or 0.0.0.0/0 expose services publicly.",
    res="Restrict sourceAddressPrefix to known networks.",
)
def _nsg_public_inbound(state: AzureState):
    for rule in state.az_nsg_rules:
        if not rule.allow.bool(False) or rule.outbound.bool(False):
            continue
        for src in rule.source_addresses.list():
            if str(src).lower() in _PUBLIC_SOURCES:
                yield CloudFailure(
                    f"Security rule allows inbound traffic from {src}.",
                    val=rule.source_addresses if rule.source_addresses.is_set() else rule.anchor(),
                    resource=rule.address,
                )
                break


@_check(
    "AVD-AZU-0039",
    "Virtual machines should disable password authentication",
    "HIGH",
    "compute",
    "az_virtual_machines",
    desc="SSH keys are resistant to brute-force unlike passwords.",
    res="Set linuxConfiguration.disablePasswordAuthentication to true.",
)
def _vm_password_auth(state: AzureState):
    for vm in state.az_virtual_machines:
        if not vm.password_auth_disabled.bool(False):
            yield CloudFailure(
                "Virtual machine allows password authentication.",
                val=vm.password_auth_disabled
                if vm.password_auth_disabled.is_set()
                else vm.anchor(),
                resource=vm.address,
            )


@_check(
    "AVD-AZU-0016",
    "Key vault should have purge protection enabled",
    "MEDIUM",
    "keyvault",
    "az_key_vaults",
    desc="Purge protection prevents immediate permanent deletion of vaults.",
    res="Set enablePurgeProtection to true.",
)
def _kv_purge_protection(state: AzureState):
    for kv in state.az_key_vaults:
        if not kv.purge_protection.bool(False):
            yield CloudFailure(
                "Vault does not have purge protection enabled.",
                val=kv.purge_protection if kv.purge_protection.is_set() else kv.anchor(),
                resource=kv.address,
            )


@_check(
    "AVD-AZU-0013",
    "Key vault should restrict default network access",
    "MEDIUM",
    "keyvault",
    "az_key_vaults",
    desc="A default-allow network ACL exposes the vault to all networks.",
    res="Set networkAcls.defaultAction to Deny.",
)
def _kv_network_acl(state: AzureState):
    for kv in state.az_key_vaults:
        if kv.network_default_allow.is_set() and kv.network_default_allow.bool(False):
            yield CloudFailure(
                "Vault network ACL default action is Allow.",
                val=kv.network_default_allow,
                resource=kv.address,
            )


# ---------------------------------------------------------------------------
# entry
# ---------------------------------------------------------------------------


def scan(path: str, content: bytes, enabled=lambda c: True):
    """Scan one ARM template file → Misconfiguration or None."""
    resources = load(path, content)
    if not resources:
        return None
    state = adapt(resources)
    by_file = evaluate_cloud(state, [path], FILE_TYPE, "Azure ARM", enabled=enabled)
    return by_file.get(path)
