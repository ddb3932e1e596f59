"""Dockerfile parser (behavioral equivalent of the reference's
dockerfile scanner input, ref: pkg/iac/scanners/dockerfile/), the port of
``trivy_tpu/misconf/parse/dockerfile.py``.

Produces a typed instruction stream with line spans and multi-stage
structure — what the Docker (DS*) checks consume.
"""

from __future__ import annotations

import json
import re
import shlex
from dataclasses import dataclass, field

_INSTR_RE = re.compile(r"^\s*([A-Za-z]+)\s+(.*)$", re.S)
_CONT_RE = re.compile(r"\\\s*$")


@dataclass
class Instruction:
    cmd: str  # upper-cased instruction name (FROM, RUN, ...)
    value: str  # raw argument text (continuations joined)
    start_line: int  # 1-based
    end_line: int
    flags: dict[str, str] = field(default_factory=dict)  # --key=value flags
    json_form: bool = False  # exec/JSON array form

    @property
    def args(self) -> list[str]:
        """Argument words; JSON form decoded, shell form shlex-split."""
        if self.json_form:
            try:
                return [str(x) for x in json.loads(self.value)]
            except Exception:
                return []
        try:
            return shlex.split(self.value)
        except ValueError:
            return self.value.split()


@dataclass
class Stage:
    """One build stage: FROM ... [AS name]."""

    base: str  # base image reference ("" for malformed FROM)
    name: str  # stage alias, lowercased ("" if unnamed)
    start_line: int
    instructions: list[Instruction] = field(default_factory=list)


@dataclass
class Dockerfile:
    stages: list[Stage] = field(default_factory=list)
    instructions: list[Instruction] = field(default_factory=list)  # all, in order

    @property
    def final_stage(self) -> Stage | None:
        return self.stages[-1] if self.stages else None


def _split_flags(text: str) -> tuple[dict[str, str], str]:
    """Leading --key[=value] flags before the instruction payload."""
    flags: dict[str, str] = {}
    rest = text
    while True:
        m = re.match(r"^\s*--([A-Za-z][\w-]*)(?:=(\S+))?\s+(.*)$", rest, re.S)
        if not m:
            break
        flags[m.group(1)] = m.group(2) or ""
        rest = m.group(3)
    return flags, rest


def parse(content: bytes) -> Dockerfile:
    text = content.decode("utf-8", "replace")
    lines = text.split("\n")
    df = Dockerfile()
    i = 0
    n = len(lines)
    while i < n:
        raw = lines[i]
        stripped = raw.strip()
        if not stripped or stripped.startswith("#"):
            i += 1
            continue
        start = i + 1
        # join continuation lines (dropping interleaved comments, which
        # Docker permits inside continued instructions)
        parts = []
        while i < n:
            line = lines[i]
            body = line.strip()
            if parts and body.startswith("#"):
                i += 1
                continue
            if _CONT_RE.search(line):
                parts.append(_CONT_RE.sub("", line))
                i += 1
                continue
            parts.append(line)
            i += 1
            break
        end = i
        joined = "\n".join(parts)
        m = _INSTR_RE.match(joined)
        if not m:
            continue
        cmd = m.group(1).upper()
        value = m.group(2).strip()
        flags, value = _split_flags(value)
        json_form = value.startswith("[")
        instr = Instruction(
            cmd=cmd,
            value=value,
            start_line=start,
            end_line=end,
            flags=flags,
            json_form=json_form,
        )
        df.instructions.append(instr)
        if cmd == "FROM":
            words = value.split()
            base = words[0] if words else ""
            name = ""
            if len(words) >= 3 and words[1].upper() == "AS":
                name = words[2].lower()
            df.stages.append(Stage(base=base, name=name, start_line=start))
        if df.stages:
            df.stages[-1].instructions.append(instr)
    return df
