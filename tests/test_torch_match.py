"""The port's matcher against the JAX package's.

Both sides get the same seeded numpy rows. ``match_plain`` (the plain
PyTorch version of the CUDA kernel) must equal
``trivy_tpu.ops.match.build_match_fn`` and the XLA prefilter exactly: the
outputs are booleans, so the tolerance is zero. The CUDA kernel itself runs
only on the card (``tests/test_torch_card.py``); here a numpy model that
follows ``csrc/match.cu`` step by step, reading only the packed table image
(the bucket-mask screen, then the verify of the candidates), must equal
``match_plain``, and a property test holds the screen to never dropping a
true hit.
"""

import logging

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tests.secret_samples import SAMPLES
from tests.test_torch_rulesets import RULESETS
from trivy_tpu.ops.match import build_match_fn
from trivy_tpu.ops.prefilter import build_prefilter_fn as jax_prefilter
from trivy_tpu.secret.device_compile import compile_rules as jax_compile
from trivy_tpu.secret.engine import ScannerConfig as JaxConfig
from trivy_tpu.secret.engine import SecretScanner as JaxEngine
from trivy_tpu_torch.ops import match_cuda
from trivy_tpu_torch.ops.match import MatchTables, match_plain, match_tables
from trivy_tpu_torch.ops.match_cuda import (
    SCREEN_BUCKETS, SCREEN_BYTES, LaunchPlan, build_match_fn_cuda, launch_plan, pack_tables,
)
from trivy_tpu_torch.ops.prefilter import _keyword_only, build_prefilter_fn
from trivy_tpu_torch.secret.device_compile import compile_rules
from trivy_tpu_torch.secret.engine import ScannerConfig, SecretScanner

C = 1024
B = 16
LOWER = bytes.maketrans(bytes(range(65, 91)), bytes(range(97, 123)))

@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """The plain matcher on two threads: the suite runs in parallel workers,
    and the JAX package's streaming tests are sensitive to a starved CPU.
    A module that runs the JAX CLI leaves its logger configured (a handler
    of its own, no propagation, the ``-q`` level); that state is put back
    afterwards, as later modules in the worker read log records through
    pytest's ``caplog``."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    jax_root = logging.getLogger("trivy_tpu")
    saved = (list(jax_root.handlers), jax_root.propagate, jax_root.level)
    yield
    torch.set_num_threads(n)
    for h in list(jax_root.handlers):
        jax_root.removeHandler(h)
    for h in saved[0]:
        jax_root.addHandler(h)
    jax_root.propagate = saved[1]
    jax_root.setLevel(saved[2])


def make_rows(seed: int, samples: list[str], rows: int = B, width: int = C) -> np.ndarray:
    """Seeded rows: random printable, random 0-255 and sparse text bases,
    with samples planted at offset 0, mid-row, across the row middle and
    ending at the last byte."""
    rng = np.random.default_rng(seed)
    out = np.empty((rows, width), dtype=np.uint8)
    for i in range(rows):
        kind = i % 3
        if kind == 0:
            out[i] = rng.integers(32, 127, width)
        elif kind == 1:
            out[i] = rng.integers(0, 256, width)
        else:
            out[i] = rng.choice(np.frombuffer(b"ab \n=:", dtype=np.uint8), width)
        for k in range(1 + i % 3):
            enc = np.frombuffer(samples[(i + 7 * k) % len(samples)].encode("latin-1"),
                                dtype=np.uint8)[:width]
            n = len(enc)
            pos = [0, width // 3, width // 2 - n // 2, width - n][(i + k) % 4]
            out[i, pos : pos + n] = enc
    return out


def port_compile(rules=None):
    cfg = ScannerConfig.from_dict({"enable-builtin-rules": [], "rules": rules}) if rules else None
    return compile_rules(SecretScanner(cfg).rules)


def jax_compile_rules(rules=None):
    cfg = JaxConfig.from_dict({"enable-builtin-rules": [], "rules": rules}) if rules else None
    return jax_compile(JaxEngine(cfg).rules)


def plain(tables, rows: np.ndarray) -> np.ndarray:
    return match_plain(tables, torch.from_numpy(rows)).numpy()


@pytest.fixture(scope="module")
def builtin():
    return port_compile(), jax_compile_rules(), make_rows(1, sorted(SAMPLES.values()))


@pytest.mark.parametrize("include_keywords", [True, False])
def test_match_plain_equals_jax_builtin(builtin, include_keywords):
    port, ref, rows = builtin
    want = np.asarray(build_match_fn(ref, C, include_keywords=include_keywords)(rows))
    got = plain(match_tables(port, include_keywords), rows)
    assert got.shape == (B, 113)
    assert np.array_equal(got, want)
    assert got.any(axis=1).sum() >= B // 2  # the planted samples hit


def test_prefilter_equals_jax_builtin(builtin):
    port, ref, rows = builtin
    want = np.asarray(jax_prefilter(ref, C, backend="xla")(rows))
    got = build_prefilter_fn(port, C, device="cpu")(torch.from_numpy(rows)).numpy()
    assert np.array_equal(got, want)
    assert got.any()


@pytest.mark.parametrize("name", sorted(RULESETS))
def test_match_plain_equals_jax_custom(name):
    rules, samples = RULESETS[name]
    port, ref = port_compile(rules), jax_compile_rules(rules)
    rows = make_rows(2, samples)
    for inc in (True, False):
        want = np.asarray(build_match_fn(ref, C, include_keywords=inc)(rows))
        assert np.array_equal(plain(match_tables(port, inc), rows), want), inc
    pf = build_prefilter_fn(port, C, device="cpu")
    if ref.prefilter_keywords:
        want = np.asarray(jax_prefilter(ref, C, backend="xla")(rows))
        assert np.array_equal(pf(torch.from_numpy(rows)).numpy(), want)
    else:
        assert pf is None and jax_prefilter(ref, C, backend="xla") is None


def test_offset_zero_passes_boundary_test():
    """Bytes before the row read as 0, which is not alphanumeric: a secret
    first in a row passes the word-boundary test."""
    rules, samples = RULESETS["edges"]
    tables = match_tables(port_compile(rules), include_keywords=False)
    rows = np.zeros((2, C), dtype=np.uint8)
    enc = np.frombuffer(samples[1].encode(), dtype=np.uint8)
    rows[0, : len(enc)] = enc
    rows[1, 1 : 1 + len(enc)] = enc
    rows[1, 0] = ord("q")  # alphanumeric byte before the match
    hit = plain(tables, rows)[:, 1]
    assert hit.tolist() == [True, False]


def test_noop_tables_give_zero_columns():
    port = port_compile(RULESETS["host_only"][0])
    tables = match_tables(port)
    assert tables.empty
    out = build_match_fn_cuda(port, C, device="cpu")(torch.zeros((8, C), dtype=torch.uint8))
    assert out.shape == (8, port.num_rules) and out.dtype == torch.bool and not out.any()


def kernel_model(image: np.ndarray, rows: np.ndarray, num_rules: int,
                 plan: LaunchPlan, blocks: int) -> np.ndarray:
    """``csrc/match.cu::match_kernel`` in numpy, step by step, reading only
    the packed image: each of ``blocks`` blocks takes its 16-aligned slice
    of the flattened positions and walks it in segments that never cross a
    row; each segment is staged into a tile with its halo (zeros outside
    the row) and every read asserts that it stays inside the tile; every
    position is screened with the four bucket-mask tables, and only the
    candidate buckets' literals are verified, word by word, then class
    windows, then the boundary byte; hits set per-block rule flags, which
    are ORed into the row's output when the block leaves the row."""
    img = image

    def section(h: int, end: int) -> np.ndarray:
        return img[int(img[h]) : end]

    screen = section(match_cuda.H_SCREEN, int(img[match_cuda.H_BUCKET]))
    screen = screen.reshape(SCREEN_BYTES, 2, 256).astype(np.uint64)
    bucket = section(match_cuda.H_BUCKET, int(img[match_cuda.H_LITS])).view(np.int32)
    lits = section(match_cuda.H_LITS, int(img[match_cuda.H_WORDS])).view(np.int32).reshape(-1, 6)
    words = section(match_cuda.H_WORDS, int(img[match_cuda.H_CHECKS])).reshape(-1, 3)
    checks = section(match_cuda.H_CHECKS, int(img[match_cuda.H_CLASSES])).view(np.int32).reshape(-1, 3)
    classes = section(match_cuda.H_CLASSES, len(img))
    classes = classes[: len(classes) // 8 * 8].reshape(-1, 8)
    assert len(bucket) == SCREEN_BUCKETS + 1 and len(lits) == bucket[-1]

    Bn, Cn = rows.shape
    seg, halo = plan.seg, plan.halo
    out = np.zeros((Bn, num_rules), dtype=bool)
    total = Bn * Cn
    per = -(-total // blocks)
    per = -(-per // 16) * 16

    def alnum(b):
        return 48 <= b <= 57 or 65 <= b <= 90 or 97 <= b <= 122

    for blk in range(blocks):
        s, e = per * blk, min(total, per * blk + per)
        flags = np.zeros(num_rules, dtype=bool)
        cur = -1
        while s < e:
            r, col = divmod(s, Cn)
            ln = min(Cn - col, e - s, seg)
            if r != cur:
                if cur >= 0:
                    out[cur] |= flags
                flags[:] = False
                cur = r
            n = -(-ln // 16) * 16 + 2 * halo
            assert n <= seg + 2 * halo
            g = np.arange(col - halo, col - halo + n)
            inside = (g >= 0) & (g < Cn)
            tile = np.zeros(n, dtype=np.uint8)
            tile[inside] = rows[r, g[inside]]

            def byte(i):
                assert 0 <= i < n, (i, n)
                return int(tile[i])

            def ld4(i):
                a = i & ~3
                assert 0 <= a and a + 8 <= n, (i, n)
                return (int.from_bytes(tile[a : a + 8].tobytes(), "little") >> (8 * (i & 3))) & 0xFFFFFFFF

            def literal_hit(i, lit):
                w0, nw, _, cb, ce, back = (int(v) for v in lit)
                for k in range(nw):
                    lw, fold, live = (int(v) for v in words[w0 + k])
                    if ((ld4(i + 4 * k) | fold) ^ lw) & live:
                        return False
                for cid, cnt, d in checks[cb:ce]:
                    for q in range(i + d, i + d + cnt):
                        b = byte(q)
                        if not (int(classes[cid, b >> 5]) >> (b & 31)) & 1:
                            return False
                return not back or not alnum(byte(i - back))

            # a thread's run: 16 bytes and the next word
            assert halo + (ln - 1) // 16 * 16 + 20 <= n
            pos = halo + np.arange(ln)
            lo = np.full(ln, 0xFFFFFFFF, dtype=np.uint64)
            hi = lo.copy()
            for j in range(SCREEN_BYTES):
                lo &= screen[j, 0][tile[pos + j]]
                hi &= screen[j, 1][tile[pos + j]]
            cand = lo | (hi << np.uint64(32))
            for q in np.nonzero(cand)[0]:
                c = int(cand[q])
                for b in range(SCREEN_BUCKETS):
                    if not (c >> b) & 1:
                        continue
                    for lit in lits[bucket[b] : bucket[b + 1]]:
                        if not flags[lit[2]] and literal_hit(int(pos[q]), lit):
                            flags[lit[2]] = True
            s += ln
        if cur >= 0:
            out[cur] |= flags
    return out


def view_tables(port, view: str) -> tuple:
    """The tables and seeded rows of one view of a ruleset."""
    if view == "anchored":
        return match_tables(port, include_keywords=False), None
    if view == "prefilter":
        return match_tables(_keyword_only(port)), None
    if view == "full":
        return match_tables(port), None
    rules, samples = RULESETS[view]
    return match_tables(port_compile(rules)), make_rows(3, samples, rows=6)


@pytest.mark.parametrize("view", ["anchored", "prefilter", "full", "edges", "short"])
def test_packed_table_walk_equals_match_plain(builtin, view):
    """The numpy model of the kernel equals match_plain, with one block per
    row at the launch plan's segment and with odd block slices and short
    segments that start segments mid-row."""
    port, _, rows = builtin
    tables, own_rows = view_tables(port, view)
    rows = rows[:6] if own_rows is None else own_rows
    image = pack_tables(tables)["image"]
    want = plain(tables, rows)
    assert want.any()
    plan = launch_plan(tables, image, C)
    assert plan.seg == C
    assert np.array_equal(kernel_model(image, rows, tables.num_rules, plan, len(rows)), want)
    short = LaunchPlan(seg=160, halo=plan.halo, smem=plan.smem)
    assert np.array_equal(kernel_model(image, rows, tables.num_rules, short, 7), want)


def test_packed_tables_layout(builtin):
    port, _, _ = builtin
    for tables, n in ((match_tables(port, include_keywords=False), 81),
                      (match_tables(_keyword_only(port)), 153)):
        flat = pack_tables(tables)
        img = flat["image"]
        assert img.dtype == np.uint32 and len(img) % 4 == 0
        offs = [int(img[h]) for h in range(match_cuda.HEADER_WORDS)]
        sizes = [SCREEN_BYTES * 512, SCREEN_BUCKETS + 1, 6 * n, 3 * len(flat["words"]),
                 3 * len(flat["checks"]), 8 * 25]
        assert offs[0] == match_cuda.HEADER_WORDS
        assert [b - a for a, b in zip(offs, offs[1:])] == sizes[:-1]
        assert len(img) - offs[-1] - sizes[-1] in range(4)
        assert flat["screen"].shape == (SCREEN_BYTES, 256) and flat["screen"].dtype == np.uint64
        lo = img[offs[0] : offs[0] + 256]  # T_0's low words
        assert np.array_equal(lo, (flat["screen"][0] & np.uint64(0xFFFFFFFF)).astype(np.uint32))
        bucket = flat["bucket"]
        assert bucket[0] == 0 and bucket[-1] == n and (np.diff(bucket) > 0).all()
        assert flat["class_bits"].shape == (25, 8) and flat["class_bits"].dtype == np.uint32
        lits = flat["lits"]
        assert lits.shape == (n, 6) and lits[-1, 0] + lits[-1, 1] == len(flat["words"])
        assert lits[:, 4].max(initial=0) == len(flat["checks"])
        # each literal's bucket bit is set in T_j for its byte j (both cases
        # of a letter for a keyword) and its words cover its bytes
        is_kw = not tables.variants
        for b in range(SCREEN_BUCKETS):
            for rec in lits[bucket[b] : bucket[b + 1]]:
                w = flat["words"][rec[0] : rec[0] + rec[1]]
                raw = b"".join(int(x).to_bytes(4, "little") for x in w[:, 0])
                live = b"".join(int(x).to_bytes(4, "little") for x in w[:, 2]).rstrip(b"\0")
                lit = raw[: len(live)]
                for j, c in enumerate(lit[:SCREEN_BYTES]):
                    assert (int(flat["screen"][j, c]) >> b) & 1
                    if is_kw and 97 <= c <= 122:
                        assert (int(flat["screen"][j, c - 32]) >> b) & 1
                fold = b"".join(int(x).to_bytes(4, "little") for x in w[:, 1])[: len(lit)]
                assert fold == bytes(0x20 if is_kw and 97 <= c <= 122 else 0 for c in lit)


def test_launch_plan_sizes_shared_memory(builtin):
    port, _, _ = builtin
    tables = match_tables(_keyword_only(port))
    image = pack_tables(tables)["image"]
    plan = launch_plan(tables, image, 16384)
    # reach 134, plus 8 bytes of look-ahead and word slack, to 16 bytes
    assert (plan.seg, plan.halo) == (match_cuda.SEG_MAX, 144)
    assert plan.smem == image.nbytes + plan.seg + 2 * 144 + 128
    assert launch_plan(tables, image, 1000).seg == 1008
    # a ruleset whose tile does not fit in shared memory is refused
    wide = MatchTables(num_rules=1, margin=8, classes=np.zeros((1, 256), bool),
                       variants=(), keywords=((0, b"k" * 120_000),))
    with pytest.raises(ValueError, match="shared memory"):
        launch_plan(wide, pack_tables(wide)["image"], 16384)


def test_many_literals_fill_every_bucket():
    """With many more distinct literal heads than buckets, the sorted
    groups are cut into runs: every bucket is used, every literal lands in
    exactly one bucket whose screen bits admit it, and literals with the
    same first byte share a few neighbouring buckets."""
    rng = np.random.default_rng(5)
    heads = {bytes(rng.integers(97, 123, rng.integers(1, 9)).astype(np.uint8)) for _ in range(900)}
    kws = tuple(enumerate(sorted(heads)))
    assert len(kws) > 4 * SCREEN_BUCKETS
    sets = np.stack([match_cuda.screen_sets(match_cuda.Literal(r, k, True)) for r, k in kws])
    bucket_of = match_cuda.assign_buckets(sets, SCREEN_BUCKETS)
    for c in range(97, 123):
        first = bucket_of[[k[0] == c for _, k in kws]]
        assert first.max() - first.min() <= 2 + len(first) * SCREEN_BUCKETS // len(kws)
    tables = MatchTables(num_rules=len(kws), margin=8, classes=np.zeros((1, 256), bool),
                         variants=(), keywords=kws)
    flat = pack_tables(tables)
    bucket = flat["bucket"]
    assert bucket[-1] == len(kws) and (np.diff(bucket) > 0).all()
    assert sorted(flat["lits"][:, 2].tolist()) == list(range(len(kws)))
    for b in range(SCREEN_BUCKETS):
        for rule in flat["lits"][bucket[b] : bucket[b + 1], 2]:
            sets = match_cuda.screen_sets(match_cuda.Literal(int(rule), kws[rule][1], True))
            for j in range(SCREEN_BYTES):
                bits = (flat["screen"][j][sets[j]] >> np.uint64(b)) & np.uint64(1)
                assert bits.all()


def literal_sets():
    """Random literal sets: lengths 1-24 over bytes that include A-Z, a-z,
    0 and 0xFF; each is a case-sensitive variant or a lowered keyword."""
    alphabet = st.sampled_from(b"AZaqxz09_-\x00\xff" + bytes(range(65, 91)))
    lit = st.tuples(st.binary(min_size=1, max_size=24).map(bytes) | st.lists(
        alphabet, min_size=1, max_size=24).map(bytes), st.booleans())
    return st.lists(lit, min_size=1, max_size=100)


@settings(derandomize=True, deadline=None, max_examples=60)
@given(lits=literal_sets(), seed=st.integers(0, 2**16))
def test_screen_covers_every_true_hit(lits, seed):
    """No position where a literal truly starts is screened out: its bucket
    bit is set in the screen mask there, including literals shorter than
    the screen and hits that run into the zero padding past the row."""
    variants, keywords = [], []
    for i, (lit, fold) in enumerate(lits):
        if fold:
            keywords.append((i, lit.translate(LOWER)))
        else:
            variants.append((i, lit, 0, False, ()))
    tables = MatchTables(num_rules=len(lits), margin=24, classes=np.zeros((1, 256), bool),
                         variants=tuple(variants), keywords=tuple(keywords))
    flat = pack_tables(tables)
    rng = np.random.default_rng(seed)
    width = 96
    row = rng.choice(np.frombuffer(b"AZaqxz09_-\x00\xff", dtype=np.uint8), width)
    # plants near both edges, keywords in random case; the last two (at
    # offset 0 and ending at the last byte) stay whole
    for k in range(6):
        lit, fold = lits[rng.integers(len(lits))]
        b = np.frombuffer(lit, dtype=np.uint8).copy()
        if fold:
            b = np.where(rng.random(len(b)) < 0.5, np.frombuffer(lit.upper(), np.uint8), b)
        at = [1, 2, width - len(b) + 1, width - 1, 0, width - len(b)][k]
        n = min(len(b), width - at)
        row[at : at + n] = b[:n]
    padded = np.concatenate([row, np.zeros(32, np.uint8)])
    folded = np.where((padded >= 65) & (padded <= 90), padded + 32, padded)
    cand = np.full(width, ~np.uint64(0))
    for j in range(SCREEN_BYTES):
        cand &= flat["screen"][j][padded[j : j + width]]
    bucket_of = np.repeat(np.arange(SCREEN_BUCKETS), np.diff(flat["bucket"]))
    rule_bucket = dict(zip(flat["lits"][:, 2].tolist(), bucket_of.tolist()))
    hits = 0
    for i, (lit, fold) in enumerate(lits):
        data = folded if fold else padded
        want = np.frombuffer(lit.translate(LOWER) if fold else lit, dtype=np.uint8)
        for p in range(width):
            if np.array_equal(data[p : p + len(want)], want):
                hits += 1
                assert (int(cand[p]) >> rule_bucket[i]) & 1, (lit, fold, p)
    assert hits >= 2


def test_wrapper_checks_its_input(builtin):
    port, _, rows = builtin
    fn = build_match_fn_cuda(port, C, include_keywords=False, device="cpu")
    x = torch.from_numpy(rows)
    before = dict(match_cuda.LAUNCHES)
    assert torch.equal(fn(x), match_plain(fn.tables, x))
    assert dict(match_cuda.LAUNCHES) == before  # the CPU path launches nothing
    for bad in (x.to(torch.int16), x[:, :512], x[0], x.to("meta")):
        with pytest.raises(ValueError):
            fn(bad)
