"""Tracked values and evaluated config blocks for IaC scanning.

The reference models provider state as ~8.7k LoC of typed Go structs whose
leaves are ``defsec`` tracked types carrying source ranges
(ref: pkg/iac/providers, pkg/iac/types). Here one generic :class:`Val`
carries (value, file, line span, explicitness) and :class:`BlockVal` is the
evaluated form of any HCL/CFN block; adapters build light service-state
objects from these so one check set serves terraform and CloudFormation.

The port of ``trivy_tpu/misconf/state.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Val:
    """A config leaf with source attribution."""

    value: object = None
    file: str = ""
    line: int = 0
    end_line: int = 0
    explicit: bool = True  # False when synthesized from a default

    # -- typed accessors -----------------------------------------------------

    def is_true(self) -> bool:
        return self.value is True or self.value == "true"

    def is_false(self) -> bool:
        return self.value is False or self.value == "false"

    def bool(self, default: bool = False) -> bool:
        if isinstance(self.value, bool):
            return self.value
        if self.value == "true":
            return True
        if self.value == "false":
            return False
        return default

    def str(self, default: str = "") -> str:
        if isinstance(self.value, str):
            return self.value
        if isinstance(self.value, bool):
            return "true" if self.value else "false"
        if isinstance(self.value, (int, float)):
            return str(self.value)
        return default

    def int(self, default: int = 0) -> int:
        if isinstance(self.value, bool):
            return default
        if isinstance(self.value, (int, float)):
            return int(self.value)
        if isinstance(self.value, str):
            try:
                return int(self.value)
            except ValueError:
                return default
        return default

    def list(self) -> list:
        if isinstance(self.value, list):
            return self.value
        return []

    def is_set(self) -> bool:
        from trivy_tpu_torch.misconf.hcl.functions import UNKNOWN

        return self.explicit and self.value is not None and self.value is not UNKNOWN

    def with_value(self, value) -> "Val":
        return Val(value, self.file, self.line, self.end_line, self.explicit)


def default_val(value, anchor: "BlockVal | Val | None" = None) -> Val:
    """A synthetic value anchored at a block (for unset attributes)."""
    if anchor is None:
        return Val(value, explicit=False)
    return Val(
        value,
        anchor.file,
        anchor.line,
        anchor.line,
        explicit=False,
    )


@dataclass
class BlockVal:
    """An evaluated config block: attributes + nested blocks + source span."""

    type: str = ""
    labels: list[str] = field(default_factory=list)
    file: str = ""
    line: int = 0
    end_line: int = 0
    attrs: dict[str, Val] = field(default_factory=dict)
    children: list["BlockVal"] = field(default_factory=list)
    # instance key for count/for_each expansion (int index or string key)
    instance_key: object = None

    @property
    def name(self) -> str:
        return self.labels[1] if len(self.labels) > 1 else (
            self.labels[0] if self.labels else ""
        )

    def blocks(self, btype: str) -> list["BlockVal"]:
        return [c for c in self.children if c.type == btype]

    def block(self, btype: str) -> "BlockVal | None":
        bs = self.blocks(btype)
        return bs[0] if bs else None

    def attr(self, name: str) -> Val | None:
        return self.attrs.get(name)

    def get(self, name: str, default=None) -> Val:
        """Attribute value, or a synthetic default anchored at this block."""
        v = self.attrs.get(name)
        if v is not None:
            from trivy_tpu_torch.misconf.hcl.functions import UNKNOWN

            if v.value is UNKNOWN:
                return default_val(default, self)
            return v
        return default_val(default, self)

    def walk_blocks(self, btype: str):
        for c in self.children:
            if c.type == btype:
                yield c
            yield from c.walk_blocks(btype)
