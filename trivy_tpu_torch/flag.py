"""Typed flag system (ref: pkg/flag/options.go:31-60 Flag[T]), the port's
copy of ``trivy_tpu/flag.py``.

Each flag unifies: CLI option, environment variable (``TRIVY_TPU_*``), and
config-file key (``trivy-tpu.yaml``), resolved in that priority order with
defaults and allowed-value validation — the same layering as the
reference's Flag[T]+viper stack, built on argparse.

The port lacks some of the JAX package's flags. On the command line
argparse refuses them; :data:`JAX_FLAGS` lists every JAX flag of the
port's commands so that :func:`resolve_all` refuses them from the
environment and the config file too, instead of dropping a setting the JAX
package would honour. Names that belong to neither package stay ignored,
as the JAX package ignores them.
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass, field
from typing import Any

ENV_PREFIX = "TRIVY_TPU_"


@dataclass
class Flag:
    name: str  # CLI name without leading dashes, e.g. "format"
    default: Any = None
    help: str = ""
    choices: list[str] | None = None
    config_name: str = ""  # dotted key in trivy-tpu.yaml, e.g. "scan.scanners"
    value_type: type = str
    is_list: bool = False
    short: str | None = None
    # post-coercion validator: called with the coerced value, raises
    # ValueError to reject — bad input (negative intervals, NaN cadences)
    # fails AT FLAG RESOLUTION with a usage error instead of reaching the
    # subsystem that would silently misbehave on it
    validator: Any = None

    @property
    def env_name(self) -> str:
        return ENV_PREFIX + self.name.upper().replace("-", "_")

    def add_to_parser(self, parser: argparse.ArgumentParser) -> None:
        names = [f"--{self.name}"]
        if self.short:
            names.insert(0, f"-{self.short}")
        # argparse %-formats help strings; a literal % (e.g. "progress %")
        # must be escaped or --help dies with a ValueError
        kw: dict = {
            "help": self.help.replace("%", "%%"),
            "default": None,
            "dest": self.dest,
        }
        if self.value_type is bool:
            kw["action"] = "store_true"
            kw["default"] = None
        else:
            if self.choices and not self.is_list:
                kw["choices"] = self.choices
            kw["type"] = str
        parser.add_argument(*names, **kw)

    @property
    def dest(self) -> str:
        return self.name.replace("-", "_")

    def resolve(self, cli_value, config: dict) -> Any:
        """CLI > env > config file > default."""
        raw = None
        if cli_value is not None:
            raw = cli_value
        elif self.env_name in os.environ:
            raw = os.environ[self.env_name]
        elif self.config_name:
            raw = config_value(config, self.config_name)
        if raw is None:
            return self.default
        value = self._coerce(raw)
        if self.validator is not None:
            try:
                normalized = self.validator(value)
            except ValueError as e:
                raise ValueError(f"--{self.name}: {e}") from None
            if normalized is not None:
                value = normalized
        return value

    def _coerce(self, raw: Any) -> Any:
        if self.is_list:
            if isinstance(raw, str):
                items = [x.strip() for x in raw.split(",") if x.strip()]
            elif isinstance(raw, list):
                items = [str(x) for x in raw]
            else:
                items = [str(raw)]
            if self.choices:
                bad = [x for x in items if x not in self.choices]
                if bad:
                    raise ValueError(
                        f"--{self.name}: invalid value(s) {bad}; allowed: {self.choices}"
                    )
            return items
        if self.value_type is bool:
            if isinstance(raw, bool):
                return raw
            return str(raw).lower() in ("1", "true", "yes", "on")
        if self.value_type is int:
            try:
                return int(raw)
            except (TypeError, ValueError):
                raise ValueError(
                    f"--{self.name}: not an integer: {raw!r}"
                ) from None
        if self.value_type is float:
            try:
                return float(raw)
            except (TypeError, ValueError):
                raise ValueError(
                    f"--{self.name}: not a number: {raw!r}"
                ) from None
        value = str(raw)
        if self.choices and value not in self.choices:
            raise ValueError(
                f"--{self.name}: invalid value {value!r}; allowed: {self.choices}"
            )
        return value


@dataclass
class FlagGroup:
    name: str
    flags: list[Flag] = field(default_factory=list)

    def add_to_parser(self, parser: argparse.ArgumentParser) -> None:
        group = parser.add_argument_group(self.name)
        for f in self.flags:
            f.add_to_parser(group)


def load_config_file(path: str | None) -> dict:
    """trivy-tpu.yaml, if present (ref: trivy.yaml via viper).

    An explicitly passed path that does not exist is an error — silently
    running with defaults would drop the user's policy settings."""
    if path:
        if not os.path.exists(path):
            raise FileNotFoundError(f"config file not found: {path}")
        candidates = [path]
    else:
        candidates = ["trivy-tpu.yaml", "trivy_tpu.yaml"]
    for cand in candidates:
        if os.path.exists(cand):
            import yaml

            with open(cand) as f:
                return yaml.safe_load(f) or {}
    return {}


def config_value(config: dict, dotted: str) -> Any:
    """The value under the dotted key ``dotted`` of a loaded config file,
    None when absent."""
    node: Any = config
    for part in dotted.split("."):
        if not isinstance(node, dict) or part not in node:
            return None
        node = node[part]
    return node


def resolve_all(groups: list[FlagGroup], ns: argparse.Namespace, config: dict,
                command: str | None = None) -> dict:
    """Every flag of ``groups`` resolved. With ``command``, an environment
    variable or config key of a JAX flag of that command that ``groups``
    lack raises :class:`ValueError` naming both."""
    out = {}
    for g in groups:
        for f in g.flags:
            out[f.dest] = f.resolve(getattr(ns, f.dest, None), config)
    if command is not None:
        ported = {f.name for g in groups for f in g.flags}
        for name, config_name in JAX_FLAGS[command]:
            if name in ported:
                continue
            env = ENV_PREFIX + name.upper().replace("-", "_")
            if env in os.environ:
                raise ValueError(f"{env} sets --{name}, a flag of the JAX package that "
                                 f"this port does not have; unset it")
            # a section (``debug:`` holding ``dir:``) sets keys below it,
            # not the flag named like it
            value = config_value(config, config_name) if config_name else None
            if value is not None and not isinstance(value, dict):
                raise ValueError(f"config key {config_name!r} sets --{name}, a flag of the "
                                 f"JAX package that this port does not have; remove it")
    return out


# -- the JAX package's flags (trivy_tpu/cli.py), as data --------------------

# group -> (flag name, config key) of every Flag(...) in the group; the
# environment name is TRIVY_TPU_ + the name upper-cased, dashes to "_"
_JAX_GROUPS = {
    "global": (
        ("debug", "debug"), ("quiet", "quiet"), ("cache-dir", "cache.dir"),
        ("cache-backend", "cache.backend"), ("cache-ttl", "cache.ttl"),
        ("redis-ca", "cache.redis.ca"), ("redis-cert", "cache.redis.cert"),
        ("redis-key", "cache.redis.key"), ("redis-insecure", "cache.redis.insecure"),
        ("config", ""), ("timeout", "timeout"), ("trace", "trace"),
        ("trace-out", "trace.out"), ("metrics-out", "trace.metrics-out"),
        ("profile-out", "trace.profile-out"), ("telemetry-interval", "telemetry.interval"),
        ("timeseries-out", "telemetry.timeseries-out"), ("live", "telemetry.live"),
        ("log-format", "log.format"), ("fault-inject", "fault-inject"),
        ("debug-dir", "debug.dir"),
    ),
    "scan": (
        ("scanners", "scan.scanners"), ("skip-dirs", "scan.skip-dirs"),
        ("skip-files", "scan.skip-files"), ("backend", "scan.backend"),
        ("parallel", "scan.parallel"), ("no-host-fallback", "scan.no-host-fallback"),
    ),
    "report": (
        ("format", "format"), ("output", "output"), ("severity", "severity"),
        ("exit-code", "exit-code"), ("ignorefile", "ignorefile"),
        ("ignore-policy", "ignore-policy"), ("vex", "vex"),
        ("show-suppressed", "show-suppressed"), ("template", "template"),
        ("list-all-pkgs", "list-all-pkgs"), ("dependency-tree", "dependency-tree"),
        ("compliance", "compliance"),
    ),
    "secret": (
        ("secret-config", "secret.config"), ("no-secret-dedup", "secret.no-dedup"),
        ("no-secret-pack", "secret.no-pack"), ("secret-hit-cache", "secret.hit-cache"),
        ("secret-streams", "secret.streams"), ("secret-inflight", "secret.inflight"),
        ("no-secret-prefilter", "secret.no-prefilter"),
        ("no-shared-arena", "secret.no-shared-arena"),
        ("secret-arena-slabs", "secret.arena-slabs"),
        ("secret-bucket-rungs", "secret.bucket-rungs"),
        ("secret-dedup-mb", "secret.dedup-mb"), ("secret-compress", "secret.compress"),
        ("no-secret-compress", "secret.no-compress"),
        ("secret-compress-min-ratio", "secret.compress-min-ratio"),
    ),
    "license": (("license-full", "license.full"),),
    "misconfiguration": (
        ("config-check", "misconfiguration.config-check"),
        ("misconfig-scanners", "misconfiguration.scanners"),
    ),
    "db": (
        ("skip-db-update", "db.skip-update"), ("db-repository", "db.repository"),
        ("java-db", "db.java-repository"), ("offline-scan", "offline-scan"),
    ),
    "client/server": (("server", "server.addr"), ("token", "server.token")),
    "fleet": (
        ("fleet", "fleet.replicas"), ("fleet-inflight", "fleet.inflight"),
        ("fleet-shards-per-replica", "fleet.shards-per-replica"),
        ("fleet-speculate", "fleet.speculate"),
        ("fleet-telemetry-interval", "fleet.telemetry-interval"),
        ("fleet-split-threshold", "fleet.split-threshold"),
        ("fleet-register-token", "fleet.register-token"),
    ),
    "admission": (
        ("max-concurrent-scans", "admission.max-concurrent-scans"),
        ("admission-queue-depth", "admission.queue-depth"),
        ("admission-queued-mb", "admission.queued-mb"), ("tenants", "admission.tenants"),
        ("tenant-max-inflight", "admission.tenant-max-inflight"),
        ("tenant-queued-mb", "admission.tenant-queued-mb"),
        ("job-retention", "admission.job-retention"), ("job-deadline", "admission.job-deadline"),
    ),
    "tuning": (
        ("tuning-file", "tuning.file"), ("tune", "tuning.controller"),
        ("tuning-interval", "tuning.interval"),
    ),
    "incremental": (
        ("incremental", "incremental.enabled"), ("diff-base", "incremental.diff-base"),
        ("since-last", "incremental.since-last"),
    ),
    "image": (
        ("insecure", "image.insecure"), ("username", "image.username"),
        ("password", "image.password"), ("platform", "image.platform"),
        ("image-src", "image.source"), ("docker-host", "image.docker.host"),
        ("podman-host", "image.podman.host"), ("containerd-host", "image.containerd.host"),
    ),
}
_FS_LIKE = ("global", "scan", "report", "secret", "license", "misconfiguration", "db",
            "client/server", "fleet", "tuning", "incremental")
# command -> the JAX flags of that command (trivy_tpu/cli.py _TARGET_GROUPS)
JAX_FLAGS = {
    cmd: tuple(flag for g in groups for flag in _JAX_GROUPS[g])
    for cmd, groups in {
        "fs": _FS_LIKE,
        "rootfs": _FS_LIKE,
        "repo": _FS_LIKE,
        "watch": _FS_LIKE[:7] + ("tuning",),
        "image": _FS_LIKE[:7] + ("client/server", "image", "fleet", "tuning", "incremental"),
        "vm": _FS_LIKE[:8] + ("tuning",),
        "sbom": ("global", "scan", "report", "db", "client/server"),
        "convert": ("global", "report"),
        "server": ("global", "db", "admission"),
        "clean": ("global",),
    }.items()
}
