"""The secret matcher as a hand-written CUDA kernel.

Replaces the JAX package's Pallas kernel
(``trivy_tpu/ops/match_pallas.py::build_match_fn_pallas``) with
``csrc/match.cu``, a table-driven kernel for Hopper. This module packs the
tables the kernel reads into one word image, keeps it resident on the card
for the life of the matcher, sizes the kernel's shared memory, and launches
it. The function computed is that of
:func:`trivy_tpu_torch.ops.match.match_plain`.

The kernel screens every position with bucket masks (the multi-literal
"Teddy" screen of Hyperscan): each literal sits in one of
``SCREEN_BUCKETS`` buckets, and table ``T_j[256]`` holds, for each byte
value, the buckets that have some literal whose byte ``j`` may be that
value. Bucket ``b`` is a candidate at ``p`` when its bit is set in
``T_0[s[p]] & ... & T_{k-1}[s[p+k-1]]``; only candidates are verified.

A matcher called with a CUDA tensor launches the kernel (or raises); with a
CPU tensor it runs ``match_plain``; any other device raises. There is no
fallback from one to the other.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from dataclasses import dataclass

import numpy as np
import torch

from trivy_tpu_torch.device import resolve
from trivy_tpu_torch.ops import _build
from trivy_tpu_torch.ops.match import MatchTables, _reach, match_plain, match_tables
from trivy_tpu_torch.secret.device_compile import CompiledRules

# kernel launches per matcher name ("anchored", "prefilter"), counted where
# the kernel is launched and nowhere else; callers may clear it
LAUNCHES: Counter = Counter()
# launches of the license classifier's kernels per (name, rows, width),
# counted beside LAUNCHES; callers may clear it
LAUNCH_SHAPES: Counter = Counter()

# the image layout, as csrc/match.cu reads it
SCREEN_BYTES = 4  # k: tables T_0..T_{k-1}, bytes s[p..p+k) screened
SCREEN_BUCKETS = 64  # bits of one screen mask
# header: word offsets of the sections, in this order
(H_SCREEN, H_BUCKET, H_LITS, H_WORDS, H_CHECKS, H_CLASSES) = range(6)
HEADER_WORDS = 6
LIT_FIELDS = 6  # word_off, n_words, rule, chk_begin, chk_end, back

SEG_MAX = 8192  # positions a block stages at once
SMEM_LIMIT = 232448  # shared memory one block may use on Hopper (227 KB)


@dataclass(frozen=True)
class Literal:
    """One screened literal: an anchored variant (case-sensitive, with its
    class windows and boundary) or a keyword (compared on A-Z-folded
    bytes)."""

    rule: int
    lit: bytes
    fold: bool
    back: int = 0  # boundary byte at p - back must not be alphanumeric; 0: none
    checks: tuple[tuple[int, int, int], ...] = ()  # (class_id, count, delta)


def literals(tables: MatchTables) -> list[Literal]:
    """The tables' variants and keywords as screened literals, variants
    first."""
    return [
        Literal(ridx, anchor, False, pre_len + 1 if boundary else 0, checks)
        for ridx, anchor, pre_len, boundary, checks in tables.variants
    ] + [Literal(ridx, kw, True) for ridx, kw in tables.keywords]


def screen_sets(lit: Literal) -> np.ndarray:
    """``[SCREEN_BYTES, 256]`` bool: the byte values row byte ``p+j`` may
    hold where ``lit`` starts at ``p``. A keyword admits both cases of a
    letter; past the literal's end every value is admitted, so a literal
    shorter than the screen is never rejected."""
    sets = np.ones((SCREEN_BYTES, 256), dtype=bool)
    for j, c in enumerate(lit.lit[:SCREEN_BYTES]):
        sets[j] = False
        sets[j, c] = True
        if lit.fold and 97 <= c <= 122:
            sets[j, c - 32] = True
    return sets


def assign_buckets(sets: np.ndarray, n_buckets: int) -> np.ndarray:
    """Bucket of each literal, from its screen sets ``[n, k, 256]``.

    Literals with the same screen sets form one group. The groups, in the
    sorted order of their sets (which puts shared prefixes side by side),
    are cut into ``n_buckets`` runs of nearly equal length (fewer when
    there are fewer groups)."""
    n = len(sets)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    _, group = np.unique(sets.reshape(n, -1), axis=0, return_inverse=True)
    n_groups = int(group.max()) + 1
    run = np.arange(n_groups) * min(n_groups, n_buckets) // n_groups
    return run[group.ravel()]


def _words(lit: Literal) -> np.ndarray:
    """``[ceil(len/4), 3]`` uint32: the literal packed little-endian four
    bytes to a word, the A-Z fold mask (0x20 on each a-z byte of a keyword)
    and the mask of the word's live bytes. A row word ``w`` matches when
    ``((w | fold) ^ lit) & live == 0``."""
    out = []
    for i in range(0, len(lit.lit), 4):
        part = lit.lit[i : i + 4]
        fold = bytes(0x20 if lit.fold and 97 <= c <= 122 else 0 for c in part)
        out.append([
            int.from_bytes(part.ljust(4, b"\0"), "little"),
            int.from_bytes(fold.ljust(4, b"\0"), "little"),
            int.from_bytes(b"\xff" * len(part) + b"\0" * (4 - len(part)), "little"),
        ])
    return np.asarray(out, dtype=np.uint32).reshape(-1, 3)


def pack_tables(tables: MatchTables) -> dict[str, np.ndarray]:
    """Everything ``csrc/match.cu`` reads, as named arrays and as the one
    word ``image`` the kernel copies into shared memory:

    - ``screen`` ``[SCREEN_BYTES, 256]`` uint64 bucket masks;
    - ``bucket`` ``[SCREEN_BUCKETS + 1]``: literals of bucket ``b`` are
      ``lits[bucket[b]:bucket[b+1]]``;
    - ``lits`` ``[n, 6]``: word offset, word count, rule, check range, and
      the distance back to the boundary byte (0: no boundary test);
    - ``words`` ``[n_words, 3]``: literal word, fold mask, live mask;
    - ``checks`` ``[n_chk, 3]``: class, count, delta;
    - ``class_bits`` ``[n_classes, 8]`` uint32 bitsets over byte values.

    The image is a header of section offsets (in words), then the sections
    in that order, padded to a multiple of 16 bytes."""
    lits = literals(tables)
    sets = np.stack([screen_sets(l) for l in lits]) if lits else np.zeros((0, SCREEN_BYTES, 256), bool)
    bucket_of = assign_buckets(sets, SCREEN_BUCKETS)
    order = sorted(range(len(lits)), key=lambda i: (bucket_of[i], i))

    screen = np.zeros((SCREEN_BYTES, 256), dtype=np.uint64)
    for i in order:
        screen[sets[i]] |= np.uint64(1) << np.uint64(bucket_of[i])
    bucket = np.zeros(SCREEN_BUCKETS + 1, dtype=np.int32)
    np.cumsum(np.bincount(bucket_of, minlength=SCREEN_BUCKETS), out=bucket[1:])

    rec = np.zeros((len(lits), LIT_FIELDS), dtype=np.int32)
    words: list[np.ndarray] = []
    checks: list[tuple[int, int, int]] = []
    n_words = 0
    for k, i in enumerate(order):
        lit = lits[i]
        w = _words(lit)
        rec[k] = (n_words, len(w), lit.rule, len(checks), len(checks) + len(lit.checks), lit.back)
        words.append(w)
        n_words += len(w)
        checks.extend(lit.checks)

    bits = np.packbits(tables.classes, axis=1, bitorder="little")  # [n, 32] u8
    flat = {
        "screen": screen,
        "bucket": bucket,
        "lits": rec,
        "words": np.concatenate(words) if words else np.zeros((0, 3), np.uint32),
        "checks": np.asarray(checks, dtype=np.int32).reshape(-1, 3),
        "class_bits": np.ascontiguousarray(bits).view("<u4").astype(np.uint32),
    }
    # each mask as a low and a high 32-bit table, [k][2][256]
    split = screen.view(np.uint32).reshape(SCREEN_BYTES, 256, 2).transpose(0, 2, 1)
    sections = [split.ravel()] + [flat[k].view(np.uint32).ravel() for k in
                                  ("bucket", "lits", "words", "checks", "class_bits")]
    header = np.zeros(HEADER_WORDS, dtype=np.uint32)
    off = HEADER_WORDS
    for h, s in enumerate(sections):
        header[h] = off
        off += len(s)
    image = np.zeros(-(-off // 4) * 4, dtype=np.uint32)
    image[:off] = np.concatenate([header, *sections])
    flat["image"] = image
    return flat


@dataclass(frozen=True)
class LaunchPlan:
    """How one row is cut and staged: ``seg`` positions at a time, each
    segment with ``halo`` bytes on either side, in ``smem`` bytes of shared
    memory (the table image, the staged tile and one flag per rule)."""

    seg: int
    halo: int
    smem: int


def launch_plan(tables: MatchTables, image: np.ndarray, chunk_len: int) -> LaunchPlan:
    """The kernel's shape for rows of ``chunk_len`` bytes. The halo covers
    the tables' widest read before or after a position (``_reach``), plus
    the screen's look-ahead and the word reads' slack, rounded up to 16
    bytes so the copy stays in 16-byte pieces. Raises ``ValueError`` when
    the block's shared memory would exceed the card's."""
    seg = min(-(-chunk_len // 16) * 16, SEG_MAX)
    halo = -(-(_reach(tables) + 8) // 16) * 16
    smem = image.nbytes + seg + 2 * halo + -(-tables.num_rules // 16) * 16
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"the matcher needs {smem} bytes of shared memory per block "
            f"(tables {image.nbytes}, tile {seg + 2 * halo}, {tables.num_rules} "
            f"rule flags); the card has {SMEM_LIMIT}"
        )
    return LaunchPlan(seg, halo, smem)


class CudaMatcher:
    """``chunks [B, chunk_len] uint8 -> [B, R] bool``, the CUDA kernel on
    the card and :func:`match_plain` on the CPU."""

    def __init__(self, tables: MatchTables, chunk_len: int, device, name: str):
        self.tables = tables
        self.chunk_len = chunk_len
        self.device = resolve(device)
        if self.device.type == "cuda":
            _build.preload("match")  # a kernel that cannot load fails here
        self.name = name
        self._image: torch.Tensor | None = None
        self._grid = 0  # resident blocks on the card, found at the first launch
        if self.device.type == "cuda" and not tables.empty:
            image = pack_tables(tables)["image"]
            self.plan = launch_plan(tables, image, chunk_len)
            # the words travel as int32 (same bits): torch's uint32 support
            # is limited and the kernel only sees a pointer
            self._image = torch.from_numpy(image.view(np.int32)).to(self.device)

    def __call__(self, chunks: torch.Tensor) -> torch.Tensor:
        if chunks.dtype != torch.uint8 or chunks.dim() != 2:
            raise ValueError(f"chunks must be 2-D uint8, got {chunks.dtype} {tuple(chunks.shape)}")
        if chunks.shape[1] != self.chunk_len:
            raise ValueError(f"chunks have {chunks.shape[1]} columns, matcher built for {self.chunk_len}")
        if chunks.device.type == "cpu":
            return match_plain(self.tables, chunks)
        if chunks.device.type != "cuda":
            raise ValueError(f"unsupported device {chunks.device}")
        if chunks.device != self.device:
            raise ValueError(f"chunks on {chunks.device}, matcher tables on {self.device}")
        if not chunks.is_contiguous():
            raise ValueError("chunks must be contiguous")
        B, C = chunks.shape
        R = self.tables.num_rules
        out = torch.zeros((B, R), dtype=torch.uint8, device=chunks.device)  # the kernel sets hits
        if self.tables.empty or B == 0:
            return out.view(torch.bool)  # no device program: nothing to launch
        lib = _build.load("match")
        p = self.plan
        with torch.cuda.device(chunks.device):  # the kernel runs on the current device
            if not self._grid:
                grid = ctypes.c_int(0)
                rc = lib.trivy_match_grid(SMEM_LIMIT, p.smem, ctypes.byref(grid))
                self._check(lib, rc, "setup")
                if grid.value < 1:
                    raise _build.KernelError(
                        f"no block of {p.smem} bytes of shared memory fits on {self.device}")
                self._grid = grid.value
            rc = lib.trivy_match_launch(
                chunks.data_ptr(), B, C, R, self._image.data_ptr(), self._image.numel(),
                p.seg, p.halo, p.smem, self._grid, out.data_ptr(),
                torch.cuda.current_stream(chunks.device).cuda_stream,
            )
        self._check(lib, rc, "launch")
        LAUNCHES[self.name] += 1
        return out.view(torch.bool)

    @staticmethod
    def _check(lib, rc: int, what: str) -> None:
        if rc != 0:
            msg = lib.trivy_cuda_error_string(rc).decode()
            raise _build.KernelError(f"match kernel {what} failed: {msg} ({rc})")


def build_match_fn_cuda(compiled: CompiledRules, chunk_len: int,
                        include_keywords: bool = True, device="cuda",
                        name: str = "anchored") -> CudaMatcher:
    """The matcher for ``compiled`` over rows of ``chunk_len`` bytes, its
    tables resident on ``device``. ``include_keywords=False`` omits the
    keyword lane (the prefilter computes those columns)."""
    return CudaMatcher(match_tables(compiled, include_keywords), chunk_len, device, name)
