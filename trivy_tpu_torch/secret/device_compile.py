"""Compile secret rules into device-executable match programs.

The device secret path is a two-stage design (the reference itself stages a
keyword prefilter before the regex, ref: pkg/fanal/secret/scanner.go:174-186,
377-463): the device evaluates every rule against every chunk and returns a
per-(chunk, rule) *hit boolean*; the host then runs the exact regex engine
(`SecretScanner`) on just the flagged (file, rule) pairs. Device hits may
contain false positives (they only cost a cheap host confirmation) but must
never contain false negatives — that invariant is what makes the final
findings byte-identical to the CPU backend.

Each rule compiles into one of three lanes:

- **anchored lane**: the regex lowers to one or more *variants*, each an
  anchor literal (>= 3 bytes at a fixed offset from the match start) plus
  character-class window checks at fixed offsets. Constructs that won't
  lower (lookarounds, backrefs, optional/variable mid-pattern runs, anchors)
  are *truncated*: dropping a required suffix condition only weakens the
  predicate, which can only add false positives — soundness is preserved.
- **keyword lane**: rules that don't lower use their keyword prefilter
  (lowercased substring search, exactly the reference's `MatchKeywords`
  semantics) on device.
- **host lane**: rules with neither an anchored program nor keywords are
  evaluated host-side on every file (the reference also regex-scans every
  file for keyword-less rules).

The compiled output is a set of flat tables consumed by
`trivy_tpu_torch.ops.match.match_plain` and packed for the CUDA kernel by
`trivy_tpu_torch.ops.match_cuda`.
"""

from __future__ import annotations

import re

try:  # 3.11+ spelling
    import re._constants as sre_c
    import re._parser as sre_parse
except ImportError:  # 3.10 and earlier expose the same modules top-level
    import sre_constants as sre_c
    import sre_parse
from dataclasses import dataclass, field

import numpy as np

from trivy_tpu_torch.secret.rules import Rule

# Minimum anchor literal length: shorter literals are too common to be useful
# hash anchors and would flood the host-confirm stage.
MIN_ANCHOR = 3
# Cap on variants per rule (branch fan-out) before falling back to keywords.
MAX_VARIANTS = 48
# Cap on expanding fixed repeats into per-byte classes.
MAX_EXPAND = 64

_ALL_BYTES = frozenset(range(256))
_NL = ord("\n")
# Content is scanned as latin-1 text (1:1 byte<->char), so \d/\w/\s must use
# Python's *unicode* semantics restricted to the first 256 codepoints — the
# ASCII-only sets would silently drop matches like \xa0 for \s (a device
# false negative, breaking the no-FN contract for custom rules).
_DIGITS = frozenset(b for b in range(256) if re.match(r"\d", chr(b)))
_WORD = frozenset(b for b in range(256) if re.match(r"\w", chr(b)))
_SPACES = frozenset(b for b in range(256) if re.match(r"\s", chr(b)))
_ALNUM = frozenset(range(48, 58)) | frozenset(range(65, 91)) | frozenset(range(97, 123))


class _Truncate(Exception):
    """Lowering stopped at an un-lowerable construct; tokens accumulated so
    far (mutated in place) remain valid as a weaker predicate."""


@dataclass(frozen=True)
class Token:
    """A run of ``count`` mandatory chars drawn from ``chars``."""

    chars: frozenset
    count: int


@dataclass
class Check:
    """Window check: positions [anchor+delta, anchor+delta+count) all in class."""

    chars: frozenset
    count: int
    delta: int  # offset from the anchor's first byte (may be negative)
    class_id: int = -1


@dataclass
class Variant:
    anchor: bytes
    checks: list[Check] = field(default_factory=list)
    pre_len: int = 0  # fixed bytes between match start and anchor start
    boundary: bool = False  # require non-alnum (or pos 0) before match start

    @property
    def window(self) -> tuple[int, int]:
        """[lo, hi) byte range the program inspects, relative to the anchor."""
        lo = min(
            [0]
            + [c.delta for c in self.checks]
            + ([-self.pre_len - 1] if self.boundary else [])
        )
        hi = max([len(self.anchor)] + [c.delta + c.count for c in self.checks])
        return lo, hi


@dataclass
class CompiledRules:
    """Device tables for one effective ruleset.

    ``rule_ids`` indexes the output axis of the match kernel; a hit for rule
    ``i`` means "run exact rule ``rule_ids[i]`` on this file host-side".
    ``host_rule_ids`` must be evaluated host-side on every file.
    """

    rule_ids: list[str]
    classes: np.ndarray  # [n_classes, 256] bool
    variants: list[tuple[int, Variant]]  # (rule_index, variant)
    keywords: list[tuple[int, bytes]]  # (rule_index, lowercased keyword)
    host_rule_ids: list[str]
    margin: int  # max bytes a program inspects beyond/behind a position
    span: int = 8  # required chunk overlap (max device-window extent)
    anchored_rule_ids: list[str] = field(default_factory=list)
    # keyword-prefilter table: (rule_index, ascii-lowered keyword) for EVERY
    # device rule that declares keywords — the keyword lane's own entries
    # plus anchored-lane rules that also declare keywords. The on-device
    # prefilter (ops/prefilter.py) runs this table over every arena slab
    # first; rows with zero candidate rules skip the anchored/NFA dispatch
    # entirely and candidates gate host confirms at file level (the
    # reference's MatchKeywords is a whole-file test, scanner.go:174-186).
    prefilter_keywords: list[tuple[int, bytes]] = field(default_factory=list)

    @property
    def num_rules(self) -> int:
        return len(self.rule_ids)

    @property
    def guarded(self) -> np.ndarray:
        """[R] bool: rules whose keywords are in the prefilter table — a
        prefilter miss across a whole file means the rule cannot match it
        (keywords are a whole-file predicate in the exact engine)."""
        g = np.zeros(self.num_rules, dtype=bool)
        for ridx, _ in self.prefilter_keywords:
            g[ridx] = True
        return g

    def prefilter_fingerprint(self) -> bytes:
        """Digest of the prefilter table: any keyword add/remove/edit (or a
        rule-index renumbering) flips it. Mixed into the dedup-cache key so
        cached hit/candidate vectors can never survive a ruleset keyword
        edit."""
        import hashlib

        h = hashlib.blake2b(digest_size=16)
        for ridx, kw in sorted(self.prefilter_keywords):
            h.update(ridx.to_bytes(4, "little"))
            h.update(len(kw).to_bytes(4, "little"))
            h.update(kw)
        return h.digest()


def _category_chars(cat) -> frozenset:
    if cat == sre_c.CATEGORY_DIGIT:
        return _DIGITS
    if cat == sre_c.CATEGORY_NOT_DIGIT:
        return _ALL_BYTES - _DIGITS
    if cat == sre_c.CATEGORY_WORD:
        return _WORD
    if cat == sre_c.CATEGORY_NOT_WORD:
        return _ALL_BYTES - _WORD
    if cat == sre_c.CATEGORY_SPACE:
        return _SPACES
    if cat == sre_c.CATEGORY_NOT_SPACE:
        return _ALL_BYTES - _SPACES
    raise _Truncate


def _in_chars(items) -> frozenset:
    negate = False
    chars: set[int] = set()
    for op, av in items:
        if op == sre_c.NEGATE:
            negate = True
        elif op == sre_c.LITERAL:
            if av < 256:
                chars.add(av)
        elif op == sre_c.RANGE:
            lo, hi = av
            chars.update(range(lo, min(hi, 255) + 1))
        elif op == sre_c.CATEGORY:
            chars.update(_category_chars(av))
        else:
            raise _Truncate
    return frozenset(_ALL_BYTES - chars) if negate else frozenset(chars)


def _single_chars(op, av, dotall: bool = False) -> frozenset:
    """Character set of a single-position node."""
    if op == sre_c.LITERAL:
        if av >= 256:
            raise _Truncate
        return frozenset({av})
    if op == sre_c.NOT_LITERAL:
        return _ALL_BYTES - {av}
    if op == sre_c.IN:
        return _in_chars(av)
    if op == sre_c.ANY:
        return _ALL_BYTES if dotall else _ALL_BYTES - {_NL}
    raise _Truncate


def _is_word_prefix_branch(op, av) -> frozenset | None:
    """Detect the leading ``(?:^|[^...])`` word-boundary idiom
    (ref: builtin-rules.go:81 startWord) and return its boundary class."""
    if op != sre_c.BRANCH:
        return None
    _, alts = av
    if len(alts) != 2:
        return None
    for a, b in ((list(alts[0]), list(alts[1])), (list(alts[1]), list(alts[0]))):
        if len(a) == 1 and a[0][0] == sre_c.AT and len(b) == 1:
            try:
                return _single_chars(*b[0])
            except _Truncate:
                return None
    return None


def _walk(nodes, streams: list[list[Token]], dotall: bool = False) -> None:
    """Lower an AST node sequence onto every open token stream, mutating
    ``streams`` in place so partial progress survives :class:`_Truncate`.
    """
    for op, av in nodes:
        if op in (sre_c.LITERAL, sre_c.NOT_LITERAL, sre_c.IN, sre_c.ANY):
            tok = Token(_single_chars(op, av, dotall), 1)
            for s in streams:
                s.append(tok)
        elif op in (sre_c.MAX_REPEAT, sre_c.MIN_REPEAT):
            lo, hi, sub = av
            sub = list(sub)
            if len(sub) == 1 and sub[0][0] in (
                sre_c.LITERAL,
                sre_c.NOT_LITERAL,
                sre_c.IN,
                sre_c.ANY,
            ):
                chars = _single_chars(*sub[0], dotall)
                if lo > 0:
                    for s in streams:
                        s.append(Token(chars, lo))
                if hi != lo:
                    # variable run: offsets beyond it are unknown
                    raise _Truncate
            else:
                if lo == 0:
                    raise _Truncate
                if lo * max(1, len(sub)) > MAX_EXPAND:
                    # check the first mandatory copy, then stop
                    _walk(sub, streams, dotall)
                    raise _Truncate
                for _ in range(lo):
                    _walk(sub, streams, dotall)
                if hi != lo:
                    raise _Truncate
        elif op == sre_c.SUBPATTERN:
            _g, add_f, _del_f, sub = av
            if add_f & re.IGNORECASE:
                raise _Truncate
            _walk(list(sub), streams, dotall or bool(add_f & re.DOTALL))
        elif op == sre_c.BRANCH:
            _, alts = av
            if len(streams) * len(alts) > MAX_VARIANTS:
                raise _Truncate
            forked: list[list[Token]] = []
            truncated = False
            for alt in alts:
                alt_streams = [list(s) for s in streams]
                try:
                    _walk(list(alt), alt_streams, dotall)
                except _Truncate:
                    truncated = True
                forked.extend(alt_streams)
            streams[:] = forked
            if truncated:
                raise _Truncate
        else:
            # AT, ASSERT, ASSERT_NOT, GROUPREF, ...: cannot lower
            raise _Truncate


def _compile_variant(tokens: list[Token], boundary: bool) -> Variant | None:
    # expand fixed tokens into per-byte classes (long runs keep run form)
    seq: list[frozenset] = []
    tail_runs: list[Token] = []  # runs too long to expand, kept as checks
    for t in tokens:
        if t.count > MAX_EXPAND:
            tail_runs.append(t)
            break  # positions after it are known, but keep it simple
        seq.extend([t.chars] * t.count)

    # anchor = longest run of singleton classes
    best: tuple[int, int] | None = None
    i = 0
    while i < len(seq):
        if len(seq[i]) == 1:
            j = i
            while j < len(seq) and len(seq[j]) == 1:
                j += 1
            if best is None or (j - i) > best[1]:
                best = (i, j - i)
            i = j
        else:
            i += 1
    if best is None or best[1] < MIN_ANCHOR:
        return None
    a_start, a_len = best
    anchor = bytes(next(iter(seq[k])) for k in range(a_start, a_start + a_len))
    v = Variant(anchor=anchor, pre_len=a_start, boundary=boundary)

    checks: list[Check] = []
    k = 0
    while k < len(seq):
        if a_start <= k < a_start + a_len:
            k += 1
            continue
        chars = seq[k]
        j = k
        while j < len(seq) and not (a_start <= j < a_start + a_len) and seq[j] == chars:
            j += 1
        if chars != _ALL_BYTES:
            checks.append(Check(chars=chars, count=j - k, delta=k - a_start))
        k = j
    for t in tail_runs:
        if t.chars != _ALL_BYTES:
            checks.append(Check(chars=t.chars, count=t.count, delta=len(seq) - a_start))
    v.checks = checks
    return v


def compile_rule(rule: Rule) -> list[Variant] | None:
    """Lower one rule to anchored variants, or None for keyword/host lane."""
    try:
        tree = sre_parse.parse(rule.regex)
    except Exception:
        return None
    if tree.state.flags & re.IGNORECASE:
        return None
    nodes = list(tree)
    boundary = False
    if nodes:
        bc = _is_word_prefix_branch(*nodes[0])
        if bc is not None:
            # only the standard non-alnum boundary is modeled; any other
            # boundary class is skipped (sound: weaker predicate)
            boundary = bc == (_ALL_BYTES - _ALNUM)
            nodes = nodes[1:]
    streams: list[list[Token]] = [[]]
    try:
        _walk(nodes, streams, dotall=bool(tree.state.flags & re.DOTALL))
    except _Truncate:
        pass
    variants = []
    for s in streams:
        v = _compile_variant(s, boundary)
        if v is None:
            return None  # every variant must be detectable, else no-FN breaks
        variants.append(v)
    return variants or None


def compile_rules(rules: list[Rule]) -> CompiledRules:
    """Compile an effective ruleset to device tables."""
    rule_ids: list[str] = []
    variants: list[tuple[int, Variant]] = []
    keywords: list[tuple[int, bytes]] = []
    host_rule_ids: list[str] = []
    anchored_rule_ids: list[str] = []
    class_index: dict[frozenset, int] = {}

    prefilter_keywords: list[tuple[int, bytes]] = []

    def kw_bytes(rule: Rule) -> list[bytes]:
        # a keyword with chars >255 can never be a substring of latin-1
        # scan content, so dropping it keeps the device keyword test
        # EXACTLY equal to the host's match_keywords, not merely sound
        out = []
        for kw in rule.lower_keywords:
            try:
                out.append(kw.encode("latin-1"))
            except UnicodeEncodeError:
                continue
        return out

    for rule in rules:
        prog = compile_rule(rule)
        if prog is not None:
            ridx = len(rule_ids)
            rule_ids.append(rule.id)
            anchored_rule_ids.append(rule.id)
            for v in prog:
                for c in v.checks:
                    if c.chars not in class_index:
                        class_index[c.chars] = len(class_index)
                    c.class_id = class_index[c.chars]
                variants.append((ridx, v))
            # anchored rules that also declare keywords join the prefilter
            # table: their confirms gate on a whole-file keyword candidate
            kb = kw_bytes(rule)
            if kb:
                prefilter_keywords.extend((ridx, k) for k in kb)
        elif rule.lower_keywords:
            kb = kw_bytes(rule)
            if not kb:
                # no representable keyword: nothing for the device to find
                host_rule_ids.append(rule.id)
                continue
            ridx = len(rule_ids)
            rule_ids.append(rule.id)
            for k in kb:
                keywords.append((ridx, k))
            prefilter_keywords.extend((ridx, k) for k in kb)
        else:
            host_rule_ids.append(rule.id)

    classes = np.zeros((max(1, len(class_index)), 256), dtype=bool)
    for chars, idx in class_index.items():
        classes[idx, list(chars)] = True

    # margin: array padding for shifted reads; span: required chunk overlap
    # so every device window lies fully inside at least one chunk's real data
    margin = 8
    span = 8
    for _, v in variants:
        lo, hi = v.window
        margin = max(margin, hi, -lo)
        span = max(span, hi - lo)
    for _, kw in keywords:
        margin = max(margin, len(kw))
        span = max(span, len(kw))
    for _, kw in prefilter_keywords:
        # anchored-lane keywords run only in the prefilter kernel, which
        # shares the padded-row layout — the overlap must cover them too
        margin = max(margin, len(kw))
        span = max(span, len(kw))

    return CompiledRules(
        rule_ids=rule_ids,
        classes=classes,
        variants=variants,
        keywords=keywords,
        host_rule_ids=host_rule_ids,
        margin=margin,
        span=span,
        anchored_rule_ids=anchored_rule_ids,
        prefilter_keywords=prefilter_keywords,
    )


def load_compiled(d: dict) -> CompiledRules:
    """Rebuild :class:`CompiledRules` from plain data: numpy arrays and
    Python tuples, with no objects of any other package. ``d`` holds
    ``rule_ids``, ``classes`` ([n_classes, 256] bool), ``variants`` as
    ``(rule_idx, anchor, pre_len, boundary, [(class_id, count, delta)])``,
    ``keywords`` and ``prefilter_keywords`` as ``(rule_idx, bytes)``,
    ``host_rule_ids``, ``margin`` and ``span``. This is how rule tables
    compiled elsewhere (for example by the JAX package) are carried into
    the port."""
    classes = np.asarray(d["classes"], dtype=bool)
    char_sets = [frozenset(np.nonzero(row)[0].tolist()) for row in classes]
    rule_ids = list(d["rule_ids"])
    variants = []
    for ridx, anchor, pre_len, boundary, checks in d["variants"]:
        v = Variant(anchor=bytes(anchor), pre_len=int(pre_len), boundary=bool(boundary))
        v.checks = [
            Check(chars=char_sets[cid], count=int(n), delta=int(delta), class_id=int(cid))
            for cid, n, delta in checks
        ]
        variants.append((int(ridx), v))
    return CompiledRules(
        rule_ids=rule_ids,
        classes=classes,
        variants=variants,
        keywords=[(int(r), bytes(k)) for r, k in d["keywords"]],
        host_rule_ids=list(d["host_rule_ids"]),
        margin=int(d["margin"]),
        span=int(d["span"]),
        anchored_rule_ids=[rule_ids[r] for r in sorted({r for r, _ in variants})],
        prefilter_keywords=[(int(r), bytes(k)) for r, k in d["prefilter_keywords"]],
    )
