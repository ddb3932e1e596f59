"""Typed flag system (ref: pkg/flag/options.go:31-60 Flag[T]), the port's
copy of ``trivy_tpu/flag.py``.

Each flag unifies: CLI option, environment variable (``TRIVY_TPU_*``), and
config-file key (``trivy-tpu.yaml``), resolved in that priority order with
defaults and allowed-value validation — the same layering as the
reference's Flag[T]+viper stack, built on argparse. Every command has
the JAX package's flags; names that belong to no flag stay ignored, as the
JAX package ignores them.
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


def resolve_all(groups: list[FlagGroup], ns: argparse.Namespace, config: dict) -> dict:
    """Every flag of ``groups`` resolved."""
    out = {}
    for g in groups:
        for f in g.flags:
            out[f.dest] = f.resolve(getattr(ns, f.dest, None), config)
    return out
