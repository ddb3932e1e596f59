"""The CUDA kernels on the card: the matcher held against ``match_plain``,
the decompressor against ``decompress_plain``, the license gram gate,
shingle gate and scorer against their plain versions, the version-constraint
check against its plain versions, a compressed scan, a fused secret+license
scan, the classifier, an SBOM scan, an fs vuln scan and an image scan, a
registry image scan and a ``vm`` scan on the card, a kernel failing in one
layer of an image scan, the scan ladder (a retried and a split batch, a
dead device degrading to the host), several devices: rows and tables on
different devices refused, and round-robin over one card twice; and
client/server mode: a client scan through a server on the card equal to
the local card scan, and concurrent scans of one DB each equal to its
serial scan; the fleet: shards, the coordinator and its telemetry plane
on the card, each equal to the CPU; and a misconfiguration scan beside the
secret feed on the card, equal to the CPU.

Every test here needs an NVIDIA card and skips without one. The file
imports neither ``jax`` nor ``trivy_tpu``, so on a machine with a card and
no JAX it runs without the suite's conftest:

    python -m pytest --noconftest -q tests/test_torch_card.py
"""

import gzip
import importlib.util
import json
import runpy
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from trivy_tpu_torch import cli
from trivy_tpu_torch.db import VulnDB
from trivy_tpu_torch.licensing.classify import LicenseClassifier
from trivy_tpu_torch.licensing.corpus_texts import FULL_TEXTS
from trivy_tpu_torch.licensing.fused import FusedLicenseGate, get_gate_fn
from trivy_tpu_torch.ops import match_cuda, verscmp_cuda
from trivy_tpu_torch.ops.bytes_score import effective_cap
from trivy_tpu_torch.ops.decompress import build_decompress_fn, decompress_plain
from trivy_tpu_torch.ops.gram_gate import LANE_ANCHOR, LANE_GRAM, LANE_NONASCII
from trivy_tpu_torch.ops.match import MatchTables, match_plain, match_tables
from trivy_tpu_torch.ops.match_cuda import CudaMatcher
from trivy_tpu_torch.ops.prefilter import _keyword_only
from trivy_tpu_torch.ops.verscmp import (
    DispatchStage, check_ops_gather_bucketed, check_ops_gather_plain, check_ops_plain, lexcmp_plain,
)
from trivy_tpu_torch.ops.verscmp_cuda import check_ops, check_ops_gather, lexcmp
from trivy_tpu_torch.secret.compress import MODE_PACK7, MODE_RAW, MODE_TOKEN, SlabCodec
from trivy_tpu_torch.secret.device_compile import compile_rules
from trivy_tpu_torch.secret.engine import ScannerConfig, SecretScanner
from trivy_tpu_torch.secret.scanner import TorchSecretScanner

# the fixtures are loaded by path, as chip_smoke.py loads them: a package
# named ``tests`` installed on the machine would shadow this directory
HERE = Path(__file__).resolve().parent
SAMPLES = runpy.run_path(str(HERE / "secret_samples.py"))["SAMPLES"]
BUILD_DB = runpy.run_path(str(HERE / "dbtest.py"))["build_db"]
CUSTOM = runpy.run_path(str(HERE / "test_torch_rulesets.py"))
TFTREE = runpy.run_path(str(HERE / "tftree.py"))
IACTREE = runpy.run_path(str(HERE / "iactree.py"))
# samples of the built-in rules and of the custom rulesets that widen the
# tables (edges) and go below the screen's width (short)
SAMPLES_OF = {"builtin": sorted(SAMPLES.values()), "edges": CUSTOM["RULESETS"]["edges"][1],
              "short": CUSTOM["RULESETS"]["short"][1]}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def rows_with(samples: list[str], rows: int, width: int, seed: int) -> np.ndarray:
    """Seeded rows of printable, random and sparse bytes with the samples
    planted at offset 0, mid-row and ending at the last byte, in the case
    they have and in upper case."""
    rng = np.random.default_rng(seed)
    out = rng.integers(32, 127, (rows, width), dtype=np.uint8)
    out[1::3] = rng.integers(0, 256, (len(out[1::3]), width), dtype=np.uint8)
    out[2::3] = rng.choice(np.frombuffer(b"ab \n=:", dtype=np.uint8), (len(out[2::3]), width))
    for i in range(rows):
        s = samples[i % len(samples)]
        enc = np.frombuffer((s.upper() if i % 2 else s).encode("latin-1"), dtype=np.uint8)[:width]
        pos = [0, width // 2, width - len(enc)][i % 3]
        out[i, pos : pos + len(enc)] = enc
    return out


def views(name: str) -> dict[str, MatchTables]:
    cfg = None if name == "builtin" else ScannerConfig.from_dict(CUSTOM["config"](name))
    compiled = compile_rules(SecretScanner(cfg).rules)
    return {
        "anchored": match_tables(compiled, include_keywords=False),
        "prefilter": match_tables(_keyword_only(compiled)),
        "full": match_tables(compiled),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("ruleset", sorted(SAMPLES_OF))
def test_kernel_equals_match_plain_on_card(card, ruleset):
    """Every view of every ruleset at row lengths that take the 16-byte
    copy, a row length that is no multiple of 16 and a misaligned batch
    (both take the byte copy), and at 1, 8 and 64 rows."""
    samples = SAMPLES_OF[ruleset]
    for width in (16384, 1000, 20000):
        x = torch.from_numpy(rows_with(samples, 64, width, width)).to(card)
        buf = torch.zeros(x.numel() + 1, dtype=torch.uint8, device=card)
        buf[1:] = x.ravel()
        misaligned = buf[1:].view(x.shape)
        for view, tables in views(ruleset).items():
            if tables.empty:
                continue
            fn = CudaMatcher(tables, width, card, "test")
            want = match_plain(tables, x)
            for n in (64, 8, 1):
                got = fn(x[:n])
                torch.cuda.synchronize()
                assert torch.equal(got, want[:n]), (view, width, n)
            assert torch.equal(fn(misaligned), want), (view, width, "misaligned")
            assert want.any(), (view, width)


@pytest.mark.cuda
def test_launches_counted_once_per_launch(card):
    tables = views("builtin")["prefilter"]
    fn = CudaMatcher(tables, 4096, card, "counted")
    x = torch.zeros((4, 4096), dtype=torch.uint8, device=card)
    before = match_cuda.LAUNCHES["counted"]
    fn(x)
    fn(x)
    assert match_cuda.LAUNCHES["counted"] == before + 2
    fn(x[:0])  # an empty batch launches nothing
    assert match_cuda.LAUNCHES["counted"] == before + 2


@pytest.mark.cuda
def test_oversized_tile_raises_on_card(card):
    wide = MatchTables(num_rules=1, margin=8, classes=np.zeros((1, 256), bool),
                       variants=(), keywords=((0, b"k" * 120_000),))
    with pytest.raises(ValueError, match="shared memory"):
        CudaMatcher(wide, 16384, card, "wide")


def codec_frame(codec: SlabCodec, seed: int, rows: int = 64, pad: int = 8) -> tuple:
    """A frame the codec encodes from seeded text, printable, zero and
    random-byte rows (TOKEN, PACK7 and RAW rows), with ``pad`` padding rows,
    and the rows it came from."""
    C = codec.chunk_len
    rng = np.random.default_rng(seed)
    text = (b"the secret token rate stands on the line; // == -- ##\n" * (rows * C // 50 + 1))
    x = np.frombuffer(text[: rows * C], np.uint8).reshape(rows, C).copy()
    x[1::4] = rng.integers(32, 127, (len(x[1::4]), C))
    x[2::4] = 0
    x[3::8] = rng.integers(0, 256, (len(x[3::8]), C))
    plan = codec.plan(x)
    out = np.zeros(plan.total() + 256, np.uint8)
    return codec.emit(plan, rows + pad, out.size, out).arrays(), x


def edge_frame(C: int) -> tuple:
    """Streams at the buffer's edges: a short RAW stream, one ending at the
    last byte, one starting before the buffer, one running past its end, a
    TOKEN stream crossing C, a mode byte of 3, clen 0 and clen > C."""
    rng = np.random.default_rng(C)
    W = 3 * C
    buf = rng.integers(0, 256, W, dtype=np.uint8)
    buf[:C] = 0x81  # runs of 8 spaces: a TOKEN stream of C bytes expands past C
    offs = np.array([C, W - 40, -5, W - 3, 0, C, 0, C], np.int32)
    clen = np.array([5, 40, C, 10, C, C, 0, 2 * C], np.int32)
    mode = np.array([MODE_RAW, MODE_RAW, MODE_RAW, MODE_PACK7, MODE_TOKEN, 3, MODE_TOKEN,
                     MODE_RAW], np.uint8)
    return buf, offs, clen, mode


@pytest.mark.cuda
@pytest.mark.parametrize("C", [16384, 2048, 1000])
def test_decompress_kernel_equals_plain_on_card(card, C):
    """Codec frames (also from a misaligned buffer) and edge frames, at a
    row length with 16-byte stores and one (1000) with 8-byte stores."""
    codec = SlabCodec(C)
    fn = build_decompress_fn(C, codec.tab_bytes, codec.tab_len, card)
    frame, rows = codec_frame(codec, C)
    for f in (frame, edge_frame(C)):
        parts = [torch.from_numpy(a) for a in f]
        want = decompress_plain(fn.tab_bytes.cpu(), fn.tab_len.cpu(), *parts, C)
        dev = [t.to(card) for t in parts]
        assert torch.equal(fn(*dev).cpu(), want), C
        buf = torch.zeros(dev[0].numel() + 1, dtype=torch.uint8, device=card)
        buf[1:] = dev[0]
        assert torch.equal(fn(buf[1:], *dev[1:]).cpu(), want), (C, "misaligned")
    got = fn(*[torch.from_numpy(a).to(card) for a in frame]).cpu().numpy()
    assert (got[: len(rows)] == rows).all() and not got[len(rows):].any()


def odd_frame(C: int, seed: int) -> tuple:
    """A wire buffer whose length is no multiple of 16 and 64 streams at
    seeded offsets (every shift mod 16), in every mode, with streams that
    start before the buffer, end past it, lie wholly past it, clen 0 and
    clen > C."""
    rng = np.random.default_rng(seed)
    W = 5 * C + 13
    buf = rng.choice(np.array([0x80, 0x81, 0x88, 0x20, ord("a"), 0, 0xFF], np.uint8), W)
    offs = np.r_[rng.integers(0, W - C, 58), [-9, -C - 3, W - 5, W + 7, 3, W - C]]
    clen = np.r_[rng.integers(1, C + 1, 58), [C, C, 40, 12, 0, 2 * C]]
    return (buf, offs.astype(np.int32), clen.astype(np.int32), (np.arange(64) % 4).astype(np.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("C", [16384, 1000])
def test_decompress_unaligned_streams_and_odd_wire_on_card(card, C):
    """Streams at every offset mod 16 in a wire buffer of odd length, from
    a buffer at each of the 16 alignments: the vector staging's scalar
    edges read exactly what the clamp reads."""
    codec = SlabCodec(C)
    fn = build_decompress_fn(C, codec.tab_bytes, codec.tab_len, card)
    f = odd_frame(C, C)
    parts = [torch.from_numpy(a) for a in f]
    want = decompress_plain(fn.tab_bytes.cpu(), fn.tab_len.cpu(), *parts, C)
    dev = [t.to(card) for t in parts]
    for shift in range(16):
        buf = torch.zeros(dev[0].numel() + shift, dtype=torch.uint8, device=card)
        buf[shift:] = dev[0]
        assert torch.equal(fn(buf[shift:], *dev[1:]).cpu(), want), (C, shift)


@pytest.mark.cuda
def test_decompress_launches_counted_once_per_launch(card):
    codec = SlabCodec(1024)
    fn = build_decompress_fn(1024, codec.tab_bytes, codec.tab_len, card)
    parts = [torch.from_numpy(a).to(card) for a in codec_frame(codec, 1, rows=4, pad=0)[0]]
    before = match_cuda.LAUNCHES["decompress"]
    fn(*parts)
    fn(*parts)
    assert match_cuda.LAUNCHES["decompress"] == before + 2
    fn(parts[0], *(t[:0] for t in parts[1:]))  # no rows: nothing launched
    assert match_cuda.LAUNCHES["decompress"] == before + 2


@pytest.mark.cuda
def test_compressed_scan_on_card(card):
    """The default feed on the card: compression resolves on, every batch
    goes through the decompress kernel, zero rows are gated, and findings
    equal the exact engine's."""
    rng = np.random.default_rng(3)
    files = []
    for i in range(24):
        body = (b"the rate that the land sent was on and in their line\n" * 60
                + SAMPLES["github-pat"].encode() + b"\n" if i % 3 == 0
                else rng.integers(32, 127, 5000, dtype=np.uint8).tobytes() if i % 3 == 1
                else b"text head\n" + b"\0" * 6000)
        files.append((f"f{i}.txt", body))
    sc = TorchSecretScanner(chunk_len=2048, batch_size=8, device=card)
    assert sc.compress_on
    before = match_cuda.LAUNCHES["decompress"]
    got = list(sc.scan_files(files))
    exact = SecretScanner()
    assert [g.to_dict() for g in got] == [exact.scan_bytes(p, d).to_dict() for p, d in files]
    s = sc.stats.snapshot()
    assert s["batches_compressed"] > 0 and s["chunks_gated_zero"] > 0
    assert match_cuda.LAUNCHES["decompress"] - before == s["batches_compressed"]


def license_rows(C: int, n: int, seed: int) -> np.ndarray:
    """Rows of license text (raw, re-wrapped, CRLF, upper case), source
    text, non-ASCII bytes, repeated short words (more grams than distinct
    ones), a word running to the row's last byte and random bytes."""
    rng = np.random.default_rng(seed)
    keys = sorted(FULL_TEXTS)
    out = np.zeros((n, C), np.uint8)
    for i in range(n):
        t = FULL_TEXTS[keys[i % len(keys)]]
        t = [t, t.replace(". ", ".\r\n"), t.upper().replace(" ", "\n  "),
             "def f(x):\n    return x + 1  # caf\xe9\n" * 40, " a b" * 500 + "\n" + t][i % 5]
        b = (t * (C // len(t) + 2)).encode("latin-1")
        s = int(rng.integers(0, 100))
        cut = int(rng.integers(C // 2, C))  # zero tail: a text packed below its rung
        out[i, :cut] = np.frombuffer(b[s : s + cut], np.uint8)
    out[-2, -10:] = ord("w")  # a word to the row's last byte
    out[-1] = rng.integers(0, 256, C, dtype=np.uint8)
    return out


def full_text_rows(C: int, n: int) -> np.ndarray:
    """Rows of license texts only, each repeated to the row's end: the
    prescreen passes their grams and the exact search finds them."""
    keys = sorted(FULL_TEXTS)
    out = np.zeros((n, C), np.uint8)
    for i in range(n):
        b = (FULL_TEXTS[keys[i % len(keys)]] + "\n") * (C // 200 + 1)
        out[i] = np.frombuffer(b.encode("latin-1", "replace")[:C], np.uint8)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("C", [16384, 2048, 1000])
def test_gram_gate_kernel_equals_plain_on_card(card, C):
    """Mixed rows (every lane fires) and rows of license text only (most
    grams pass the prescreen and are found)."""
    fn = get_gate_fn(C, card)
    for i, rows in enumerate((license_rows(C, 40, C), full_text_rows(C, 40))):
        x = torch.from_numpy(rows)
        want = fn(x)
        got = fn(x.to(card))
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)
        assert (want & LANE_GRAM).any()
        if i == 0:
            assert want.any() and not want.all()
            assert all((want & bit).any() for bit in (LANE_GRAM, LANE_ANCHOR, LANE_NONASCII))


def scorer_rows(width: int, n: int) -> np.ndarray:
    """``license_rows`` with a row without words, one word over the whole
    row, a word across every 16-byte boundary, and one gram key repeated
    ~2,000 times (its bucket spills to the device scratch)."""
    x = license_rows(width, n, width)
    edge = bytearray(b" " * width)
    for e in range(16, width - 2, 16):
        edge[e - 2 : e + 2] = b"abcd"
    for i, body in enumerate((b"", b"w" * (width - 1), bytes(edge[:-1]),
                              (b" a" * 2000)[: width - 1]), start=1):
        x[i] = 0
        x[i, : len(body)] = np.frombuffer(body, np.uint8)
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1024, 2048, 4096, 8192, 16384, 32768, 49152])
def test_bytes_gate_and_score_kernels_equal_plain_on_card(card, width):
    """The shingle gate exactly; the scorer's n_uniq and phrase exactly and
    full_w to rtol 1e-5 (float32 sums; both add in ascending key order), at
    every cluster size whose slices hold at most twice the launch policy's
    bound (and at the policy's own), on 12 rows and on batches of 8, 16 and
    64 gathered as the classifier gathers flagged rows."""
    from trivy_tpu_torch.ops.bytes_score_cuda import CLUSTER_SIZES, SLICE_MAX

    scorer = LicenseClassifier(device=card)._device_scorer()
    x = torch.from_numpy(scorer_rows(width, 12))
    for got, want in zip(scorer._gate(x.to(card)), scorer._gate(x)):
        assert torch.equal(got.cpu(), want)
    cap = width // 4
    for n in (12, 8, 16, 64):
        rows = x if n == 12 else scorer.take_rows(x, np.arange(min(n - 2, 12)), n)
        want = scorer._score(rows, cap)
        for S in [s for s in CLUSTER_SIZES if -(-width // s) <= 2 * SLICE_MAX] + [None]:
            got = scorer._score(rows.to(card), cap, cluster=S)
            torch.cuda.synchronize()
            assert torch.equal(got[2].cpu(), want[2]) and torch.equal(got[1].cpu(), want[1]), S
            assert torch.allclose(got[0].cpu(), want[0], rtol=1e-5, atol=0), S
        assert want[0].max() > 1.0 and (want[2] <= effective_cap(cap, width)).any()


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1024, 2048, 4096, 8192, 16384, 32768, 49152])
def test_bytes_gate_full_dispatch_twice_on_card(card, width):
    """The gate at the classifier's dispatch shape of every rung, called
    twice on one gate: both calls equal the plain version (the last block
    leaves its ticket at 0 for the next launch)."""
    scorer = LicenseClassifier(device=card)._device_scorer()
    R = scorer.rows_per_dispatch(width)
    x = torch.from_numpy(license_rows(width, R, width + 1))
    want = scorer._gate(x)
    xd = x.to(card)
    first, again = scorer._gate(xd), scorer._gate(xd)
    for a, b, w in zip(first, again, want):
        assert torch.equal(a.cpu(), w) and torch.equal(b.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("rows, width, offset", [
    (2, 1024, 0), (3, 49152, 0), (5, 1536, 0), (9, 5120, 0), (40, 8192, 1), (17, 2048, 3),
    (2048, 1024, 0), (64, 49152, 0),
])
def test_bytes_gate_uneven_shapes_on_card(card, rows, width, offset):
    """Rows inside one tile, rows straddling and spanning tiles, more tiles
    than the card has SMs (256 and 384), and rows off 16-byte alignment
    (the byte staging); each called twice on one gate."""
    scorer = LicenseClassifier(device=card)._device_scorer()
    x = torch.from_numpy(license_rows(width, rows, rows))
    flat = torch.zeros(rows * width + offset, dtype=torch.uint8, device=card)
    flat[offset:] = x.reshape(-1).to(card)
    xd = flat[offset:].view(rows, width)
    first, again = scorer._gate(xd), scorer._gate(xd)
    for a, b, w in zip(first, again, scorer._gate(x)):
        assert torch.equal(a.cpu(), w) and torch.equal(b.cpu(), w)


@pytest.mark.cuda
def test_scorer_cluster_that_cannot_be_scheduled_raises(card):
    """One block for a 49,152-byte row needs more shared memory than a
    block may have: the launch raises, it does not fall back to another
    cluster size or to the plain version; a size that is not a power of two
    is refused."""
    scorer = LicenseClassifier(device=card)._device_scorer()
    x = torch.zeros((4, 49152), dtype=torch.uint8, device=card)
    before = match_cuda.LAUNCHES["bytes_score"]
    with pytest.raises(RuntimeError):
        scorer._score(x, 12288, cluster=1)
    with pytest.raises(ValueError):
        scorer._score(x, 12288, cluster=3)
    assert match_cuda.LAUNCHES["bytes_score"] == before
    assert scorer._score(x, 12288, cluster=8)[2].tolist() == [0, 0, 0, 0]


@pytest.mark.cuda
def test_license_launches_counted_once_per_launch(card):
    scorer = LicenseClassifier(device=card)._device_scorer()
    gate = get_gate_fn(2048, card)
    x = torch.zeros((4, 2048), dtype=torch.uint8, device=card)
    before = dict(match_cuda.LAUNCHES)
    gate(x)
    scorer._gate(x)
    scorer._score(x, 512)
    scorer._score(x[:0], 512)  # no rows: nothing launched
    for name in ("gram_gate", "bytes_gate", "bytes_score"):
        assert match_cuda.LAUNCHES[name] == before.get(name, 0) + 1, name
    assert match_cuda.LAUNCH_SHAPES["bytes_score", 4, 2048] >= 1


@pytest.mark.cuda
def test_classifier_on_card_equals_cpu(card):
    texts = [FULL_TEXTS[k] for k in sorted(FULL_TEXTS)]
    texts += [" a b" * 500 + "\n" + FULL_TEXTS["MIT"], "x = 1\n" * 300, ""]
    before = dict(match_cuda.LAUNCHES)
    got = LicenseClassifier(device=card).classify_batch(texts)
    want = LicenseClassifier(device="cpu").classify_batch(texts)
    assert [[f.to_dict() for f in g] for g in got] == [[f.to_dict() for f in w] for w in want]
    assert got[-3][0].name == "MIT" and got[-3][0].confidence == 1.0
    for name in ("bytes_gate", "bytes_score"):
        assert match_cuda.LAUNCHES[name] > before.get(name, 0), name


@pytest.mark.cuda
def test_fused_scan_on_card_equals_cpu(card):
    files = [(f"d{i}/LICENSE", FULL_TEXTS[k].encode()) for i, k in enumerate(sorted(FULL_TEXTS))]
    files += [(f"s/n{i}.py", (f"# n{i}\n" + "plain code\n" * 30).encode()) for i in range(30)]
    files += [("s/tok.py", f"key = '{SAMPLES['github-pat']}'\n".encode())]
    verdicts = []
    for dev in (card, "cpu"):
        gate = FusedLicenseGate(license_full=True)
        sc = TorchSecretScanner(chunk_len=2048, batch_size=8, device=dev, compress="off")
        before = match_cuda.LAUNCHES["gram_gate"]
        found = [s.to_dict() for s in sc.scan_files(files, license_gate=gate)]
        verdicts.append((found, [gate.should_classify(p) for p, _ in files],
                         sc.stats.snapshot()["license_rows_flagged"]))
        if dev is card:
            assert match_cuda.LAUNCHES["gram_gate"] > before
    assert verdicts[0] == verdicts[1]
    assert any(verdicts[0][1]) and not all(verdicts[0][1])


def version_pairs(L: int, n: int, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Seeded [n, L] int32 row pairs on the card: a third equal, a third
    differing only in the last column, a third anywhere."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 3, (n, L), dtype=np.int32)
    b = a.copy()
    k = n // 3
    b[k : 2 * k, -1] = (a[k : 2 * k, -1] + 1 + (np.arange(k) % 2)) % 3
    b[2 * k :] = rng.integers(0, 3, (n - 2 * k, L), dtype=np.int32)
    return torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("L", [1, 8, 24, 40, 72])
def test_verscmp_kernel_equals_plain_on_card(card, L):
    a, b = version_pairs(L, 999, L)
    rng = np.random.default_rng(L + 1)
    R = 5000
    a_idx = torch.from_numpy(rng.integers(0, 999, R, dtype=np.int32)).cuda()
    b_idx = torch.from_numpy(rng.integers(0, 999, R, dtype=np.int32)).cuda()
    ops = torch.arange(R, dtype=torch.int32, device=card) % 6
    assert torch.equal(check_ops_gather(a, b, a_idx, b_idx, ops),
                       check_ops_gather_plain(a, b, a_idx, b_idx, ops))
    assert torch.equal(check_ops_gather(a, b, a_idx, a_idx, ops),
                       check_ops_gather_plain(a, b, a_idx, a_idx, ops))
    # the null-index entries
    assert torch.equal(lexcmp(a, b), lexcmp_plain(a, b))
    assert torch.equal(check_ops(a, b, ops[:999]), check_ops_plain(a, b, ops[:999]))
    assert set(lexcmp(a, b).tolist()) == {-1, 0, 1}


def dispatch_inputs(n_bounds: int, seed: int, R: int = 536_800, L: int = 16) -> tuple:
    """A seeded dispatch at the ``cve`` phase's shape: 1,867 installed rows,
    ``n_bounds`` bound rows (500 as the cve DB shares them, 212,000 when
    every advisory has its own two), index rows in runs of two, ``>=``
    then ``<``, on the card."""
    rng = np.random.default_rng(seed)
    inst = rng.integers(0, 6, (1867, L), dtype=np.int32)
    bounds = rng.integers(0, 6, (n_bounds, L), dtype=np.int32)
    bounds[: n_bounds // 2, : L // 2] = inst[rng.integers(0, 1867, n_bounds // 2), : L // 2]
    a_idx = np.repeat(rng.integers(0, 1867, R // 2, dtype=np.int32), 2)
    b_idx = (2 * rng.integers(0, n_bounds // 2, R // 2)[:, None] + np.arange(2)).ravel()
    ops = np.tile(np.array([3, 0], np.int32), R // 2)
    return tuple(torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).cuda()
                 for x in (inst, bounds, a_idx, b_idx, ops))


@pytest.mark.cuda
@pytest.mark.parametrize("n_bounds", [500, 212_000])
def test_verscmp_kernel_equals_plain_at_dispatch_shape_on_card(card, n_bounds):
    inst, bounds, a_idx, b_idx, ops = dispatch_inputs(n_bounds, n_bounds)
    got = check_ops_gather(inst, bounds, a_idx, b_idx, ops)
    want = check_ops_gather_plain(inst, bounds, a_idx, b_idx, ops)
    assert torch.equal(got, want) and 0 < int(want.sum()) < len(want)
    a, b = inst[a_idx.long()].contiguous(), bounds[b_idx.long()].contiguous()
    assert torch.equal(lexcmp(a, b), lexcmp_plain(a, b))
    plan = verscmp_cuda.plan(inst, bounds, len(ops))
    assert plan["group"] == 4 and plan["vector"] and plan["grid"] >= 132


@pytest.mark.cuda
@pytest.mark.parametrize("L", [1, 16, 72, 200])
def test_verscmp_every_row_count_on_card(card, L):
    """R = 1..33: one warp's step at L = 16 is 32 rows, so every ragged
    tail of the verdict words and of the signs."""
    a, b = version_pairs(L, 40, L)
    rng = np.random.default_rng(L)
    for R in range(1, 34):
        a_idx = torch.from_numpy(rng.integers(0, 40, R, dtype=np.int32)).cuda()
        b_idx = torch.from_numpy(rng.integers(0, 40, R, dtype=np.int32)).cuda()
        ops = torch.arange(R, dtype=torch.int32, device=card) % 6
        assert torch.equal(check_ops_gather(a, b, a_idx, b_idx, ops),
                           check_ops_gather_plain(a, b, a_idx, b_idx, ops)), R
        assert torch.equal(lexcmp(a[:R], b[:R]), lexcmp_plain(a[:R], b[:R])), R
        assert torch.equal(check_ops(a[:R], b[:R], ops), check_ops_plain(a[:R], b[:R], ops)), R


@pytest.mark.cuda
@pytest.mark.parametrize("L", [8, 16, 24])
def test_verscmp_unaligned_view_takes_the_scalar_path_on_card(card, L):
    """A contiguous view one int32 past a 16-byte boundary: the scalar path,
    the plain version's verdicts; the same rows aligned take the vector
    path."""
    a, b = version_pairs(L, 999, L + 7)
    buf = torch.empty(999 * L + 1, dtype=torch.int32, device=card)
    shifted = buf[1:].view(999, L)
    shifted.copy_(a)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    assert not verscmp_cuda.plan(shifted, b, 999)["vector"]
    assert verscmp_cuda.plan(a, b, 999)["vector"]
    rng = np.random.default_rng(L)
    a_idx = torch.from_numpy(rng.integers(0, 999, 5000, dtype=np.int32)).cuda()
    b_idx = torch.from_numpy(rng.integers(0, 999, 5000, dtype=np.int32)).cuda()
    ops = torch.arange(5000, dtype=torch.int32, device=card) % 6
    want = check_ops_gather_plain(a, b, a_idx, b_idx, ops)
    assert torch.equal(check_ops_gather(shifted, b, a_idx, b_idx, ops), want)
    assert torch.equal(check_ops_gather(b, shifted, b_idx, a_idx, ops),
                       check_ops_gather_plain(b, a, b_idx, a_idx, ops))
    assert torch.equal(lexcmp(shifted, b), lexcmp_plain(a, b))


@pytest.mark.cuda
def test_verscmp_two_calls_in_a_row_equal_on_card(card):
    inst, bounds, a_idx, b_idx, ops = dispatch_inputs(500, 1)
    first = check_ops_gather(inst, bounds, a_idx, b_idx, ops)
    second = check_ops_gather(inst, bounds, a_idx, b_idx, ops)
    assert torch.equal(first, second)
    assert torch.equal(first, check_ops_gather_plain(inst, bounds, a_idx, b_idx, ops))


@pytest.mark.cuda
def test_verscmp_dispatch_one_copy_each_way_on_card(card):
    """The detector's dispatch through a :class:`DispatchStage`: one
    host-to-card copy of the pinned buffer, the kernel and one copy back
    (the nodes of a CUDA graph captured around it; a pageable upload could
    not be captured), and the verdicts of the plain version."""
    work_per_call = runpy.run_path(str(HERE.parent / "chip_smoke.py"))["work_per_call"]
    inst, bounds, a_idx, b_idx, ops = dispatch_inputs(500, 2, R=100_000)
    stage = DispatchStage(card)
    host = [x.cpu().numpy() for x in (inst, a_idx, b_idx, ops)]
    views = stage.views(len(ops), *inst.shape)
    assert stage.host.is_pinned()
    for src, dst in zip(host, views):
        dst[:] = src

    def enqueue(_):
        inst_d, a_d, b_d, ops_d = stage.upload()
        stage.copy_back(check_ops_gather(inst_d, bounds, a_d, b_d, ops_d))

    work = work_per_call(enqueue, [None])
    assert work["by_type"] == {"memcpy": 2, "kernel": 1}, work
    assert stage.verdict.is_pinned()
    want = check_ops_gather_plain(inst, bounds, a_idx, b_idx, ops).cpu().numpy()
    got = check_ops_gather_bucketed(*views[:1], bounds, *views[1:], stage=stage)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(check_ops_gather_bucketed(*host[:1], bounds, *host[1:]), want)


@pytest.mark.cuda
def test_verscmp_launches_counted_once_per_launch(card):
    a, b = version_pairs(8, 30, 0)
    idx = torch.arange(30, dtype=torch.int32, device=card)
    before = match_cuda.LAUNCHES["verscmp"]
    check_ops_gather(a, b, idx, idx, idx % 6)
    check_ops(a, b, idx % 6)
    lexcmp(a, b)
    lexcmp(a[:0], b[:0])  # no rows: nothing launched
    torch.cuda.synchronize()
    assert match_cuda.LAUNCHES["verscmp"] == before + 3


@pytest.mark.cuda
def test_sbom_scan_on_card_equals_cpu(card, tmp_path):
    rng = np.random.default_rng(3)
    comps = [{"type": "library", "name": name, "version": v, "purl": f"pkg:npm/{name}@{v}"}
             for name, v in ((["lodash", "minimist", "other"][i % 3],
                              f"{rng.integers(0, 5)}.{rng.integers(0, 21)}.{rng.integers(0, 26)}")
                             for i in range(1000))]
    comps.append({"type": "library", "name": "musl", "version": "1.2.3-r0",
                  "purl": "pkg:apk/alpine/musl@1.2.3-r0?distro=alpine-3.18"})
    comps.append({"type": "operating-system", "name": "alpine", "version": "3.18"})
    bom = tmp_path / "bom.json"
    bom.write_text(json.dumps({"bomFormat": "CycloneDX", "components": comps}))
    db = VulnDB.load(BUILD_DB(tmp_path))
    before = match_cuda.LAUNCHES["verscmp"]
    on_card, stats = cli.scan_sbom(str(bom), db=db, device=card)
    assert match_cuda.LAUNCHES["verscmp"] == before + 1 and stats["cve.dispatch_count"] == 1
    on_cpu, _ = cli.scan_sbom(str(bom), db=VulnDB.load(BUILD_DB(tmp_path / "b")), device="cpu")
    assert on_card.to_dict()["Results"] == on_cpu.to_dict()["Results"]
    assert sum(len(r.vulnerabilities) for r in on_card.results) > 100


@pytest.mark.cuda
def test_fs_vuln_scan_on_card_equals_cpu(card, tmp_path):
    """``scan_fs`` with vuln and secret over a tree of 1,000 npm packages
    and a secret: one ``verscmp`` launch, the report the CPU gives."""
    rng = np.random.default_rng(4)
    pkgs = {f"node_modules/p{i}/node_modules/{['lodash', 'minimist', 'other'][i % 3]}": {
        "version": f"{rng.integers(0, 5)}.{rng.integers(0, 21)}.{rng.integers(0, 26)}"}
        for i in range(1000)}
    (tmp_path / "tree" / "web").mkdir(parents=True)
    (tmp_path / "tree" / "web" / "package-lock.json").write_text(
        json.dumps({"lockfileVersion": 3, "packages": pkgs}))
    (tmp_path / "tree" / "key.py").write_text(f"k = '{SAMPLES['github-pat']}'\n")
    db = VulnDB.load(BUILD_DB(tmp_path))
    before = match_cuda.LAUNCHES["verscmp"]
    on_card, stats = cli.scan_fs(str(tmp_path / "tree"), scanners=("vuln", "secret"), db=db,
                                 device=card)
    assert match_cuda.LAUNCHES["verscmp"] == before + 1 and stats["cve.dispatch_count"] == 1
    on_cpu, _ = cli.scan_fs(str(tmp_path / "tree"), scanners=("vuln", "secret"),
                            db=VulnDB.load(BUILD_DB(tmp_path / "b")), device="cpu")
    assert on_card.to_dict()["Results"] == on_cpu.to_dict()["Results"]
    assert {r.cls for r in on_card.results} == {"lang-pkgs", "secret"}
    assert sum(len(r.vulnerabilities) for r in on_card.results) > 100


@pytest.mark.cuda
def test_cyclonedx_of_a_card_scan_scans_as_sbom_on_card(card, tmp_path):
    """``fs --format cyclonedx`` on the card over 1,000 npm packages and an
    alpine root, then ``sbom`` of that file on the card: the fs scan's
    vulnerabilities, and one ``verscmp`` launch for each scan."""
    rng = np.random.default_rng(5)
    pkgs = {f"node_modules/p{i}/node_modules/{['lodash', 'minimist', 'other'][i % 3]}": {
        "version": f"{rng.integers(0, 5)}.{rng.integers(0, 21)}.{rng.integers(0, 26)}"}
        for i in range(1000)}
    tree = tmp_path / "tree"
    for rel, text in {"web/package-lock.json": json.dumps({"lockfileVersion": 3,
                                                           "packages": pkgs}),
                      "etc/alpine-release": "3.18.4\n",
                      "lib/apk/db/installed": "P:musl\nV:1.2.3-r0\nL:MIT\n"}.items():
        (tree / rel).parent.mkdir(parents=True, exist_ok=True)
        (tree / rel).write_text(text)
    head = ["--db-repository", BUILD_DB(tmp_path), "--device", "cuda", "-q",
            "--cache-dir", str(tmp_path / "c")]

    def run(*args: str) -> int:
        before = match_cuda.LAUNCHES["verscmp"]
        assert cli.main([*args[:1], *head, *args[1:]]) == 0
        return match_cuda.LAUNCHES["verscmp"] - before

    assert run("fs", "--scanners", "vuln", "--format", "cyclonedx",
               "-o", str(tmp_path / "bom.json"), str(tree)) == 1
    assert run("fs", "--scanners", "vuln", "--format", "json",
               "-o", str(tmp_path / "fs.json"), str(tree)) == 1
    assert run("sbom", "--format", "json", "-o", str(tmp_path / "sbom.json"),
               str(tmp_path / "bom.json")) == 1
    bom = json.loads((tmp_path / "bom.json").read_text())
    assert len(bom["components"]) > 100 and bom["vulnerabilities"]

    def vulns(name: str) -> set:
        return {(v["VulnerabilityID"], v["PkgName"], v["InstalledVersion"])
                for r in json.loads((tmp_path / name).read_text())["Results"]
                for v in r.get("Vulnerabilities", [])}

    assert vulns("sbom.json") == vulns("fs.json")
    assert len(vulns("fs.json")) > 10


IMAGES = runpy.run_path(str(HERE / "imagetest.py"))


def card_files() -> tuple[dict, dict]:
    """1,000 npm packages and two secrets; the 22 full license texts, source
    files with license headers and 1 MiB of text."""
    rng = np.random.default_rng(5)
    pkgs = {f"node_modules/p{i}/node_modules/{['lodash', 'minimist', 'other'][i % 3]}": {
        "version": f"{rng.integers(0, 5)}.{rng.integers(0, 21)}.{rng.integers(0, 26)}"}
        for i in range(1000)}
    tar = IMAGES["tar_bytes"]
    apps = {"web/package-lock.json": json.dumps({"lockfileVersion": 3, "packages": pkgs}).encode(),
            "app/key.py": f"k = '{SAMPLES['github-pat']}'\n".encode(),
            "app/old.env": f"AWS={SAMPLES['aws-access-key-id']}\n".encode()}
    words = " ".join(f"word{i % 97} value{i % 13}" for i in range(60_000)).encode()
    content = {f"lic/{k}/LICENSE": FULL_TEXTS[k].encode() for k in sorted(FULL_TEXTS)}
    content.update({f"src/m{i}.py": b"# SPDX-License-Identifier: MIT\n# Copyright 2024\n"
                    + words[i * 4096:(i + 1) * 4096] for i in range(16)})
    content["doc/notes.txt"] = words[: 1 << 20]
    return apps, content


def card_image(tmp_path: Path) -> str:
    """A docker-save image of four layers: :func:`card_files`' two, a
    whiteout of the second secret, a small top layer."""
    tar = IMAGES["tar_bytes"]
    apps, content = card_files()
    layers = [tar(apps), tar(content), tar({"app/.wh.old.env": b""}),
              tar({"etc/motd": b"card image\n"})]
    return IMAGES["docker_save_tar"](str(tmp_path / "img.tar"), layers,
                                     env=["PATH=/usr/bin", f"TOKEN={SAMPLES['github-pat']}"])


@pytest.mark.cuda
def test_image_scan_on_card_equals_cpu(card, tmp_path):
    """``scan_image`` with ``vuln,secret,license --license-full``: the
    report the CPU gives, with every kernel launched on the card."""
    path = card_image(tmp_path)
    db = VulnDB.load(BUILD_DB(tmp_path))
    kw = dict(scanners=("vuln", "secret", "license"), license_full=True, db=db)
    before = dict(match_cuda.LAUNCHES)
    on_card, stats = cli.scan_image(path, device=card, cache_dir=str(tmp_path / "c1"), **kw)
    launched = {k: match_cuda.LAUNCHES[k] - before.get(k, 0) for k in (
        "prefilter", "anchored", "decompress", "gram_gate", "bytes_gate", "bytes_score",
        "verscmp")}
    assert all(launched.values()) and launched["verscmp"] == 1, launched
    assert stats["layers_analyzed"] == 4
    on_cpu, _ = cli.scan_image(path, device="cpu", cache_dir=str(tmp_path / "c2"), **kw)
    mine, ref = on_card.to_dict(), on_cpu.to_dict()
    assert mine["Results"] == ref["Results"] and mine["Metadata"] == ref["Metadata"]
    targets = {r.target for r in on_card.results}
    assert {"/app/key.py", "container image config (env)"} <= targets
    assert "/app/old.env" not in targets


def load_fake(name: str):
    """``tests/<name>.py`` as the module ``tests.<name>``, loaded by path
    (the registry fake imports ``tests.imagetest``)."""
    spec = importlib.util.spec_from_file_location(f"tests.{name}", HERE / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def kernel_launches(before: dict) -> dict:
    return {k: match_cuda.LAUNCHES[k] - before.get(k, 0) for k in (
        "prefilter", "anchored", "decompress", "gram_gate", "bytes_gate", "bytes_score",
        "verscmp")}


@pytest.mark.cuda
def test_registry_scan_on_card_equals_cpu(card, tmp_path, monkeypatch):
    """The card image pushed to the in-process registry and scanned with
    ``--image-src remote``: the CPU's report, every kernel launched."""
    from trivy_tpu_torch.artifact.image import ImageSourceOption, _ImageArchive

    load_fake("imagetest")
    registrytest = load_fake("registrytest")
    archive = _ImageArchive(card_image(tmp_path))
    reg = registrytest.MemoryRegistry(token="card-token")
    descs = []
    for i in range(len(archive.diff_ids)):
        with archive.layer_stream(i) as f:
            blob = gzip.compress(f.read(), compresslevel=1)
        descs.append({"mediaType": "application/vnd.oci.image.layer.v1.tar+gzip",
                      "digest": reg.put_blob("app", blob), "size": len(blob)})
    reg.put_manifest("app", "1", {
        "schemaVersion": 2, "mediaType": "application/vnd.oci.image.manifest.v1+json",
        "config": {"mediaType": "application/vnd.oci.image.config.v1+json",
                   "digest": reg.put_blob("app", archive.config_bytes),
                   "size": len(archive.config_bytes)},
        "layers": descs}, "application/vnd.oci.image.manifest.v1+json")
    archive.close()
    server, host = registrytest.start_registry(reg)
    try:
        db = VulnDB.load(BUILD_DB(tmp_path))
        kw = dict(scanners=("vuln", "secret", "license"), license_full=True, db=db,
                  image_source=ImageSourceOption(image_src=["remote"], insecure_registry=True))
        before = dict(match_cuda.LAUNCHES)
        on_card, stats = cli.scan_image(f"{host}/app:1", device=card,
                                        cache_dir=str(tmp_path / "c1"), **kw)
        launched = kernel_launches(before)
        on_cpu, _ = cli.scan_image(f"{host}/app:1", device="cpu",
                                   cache_dir=str(tmp_path / "c2"), **kw)
    finally:
        server.shutdown()
    assert all(launched.values()) and launched["verscmp"] == 1, launched
    assert stats["layers_analyzed"] == 4
    mine, ref = on_card.to_dict(), on_cpu.to_dict()
    assert mine["Results"] == ref["Results"] and mine["Metadata"] == ref["Metadata"]
    assert "/app/key.py" in {r.target for r in on_card.results}


@pytest.mark.cuda
def test_vm_scan_on_card_equals_cpu(card, tmp_path):
    """:func:`card_files` on an ext4 disk made by ``mkfs.ext4 -d``: the CPU's
    report, every kernel launched; a rescan is a cache hit with no launch."""
    mkfs = shutil.which("mkfs.ext4")
    if mkfs is None:
        pytest.skip("mkfs.ext4 not available")
    root = tmp_path / "root"
    for files in card_files():
        for rel, data in files.items():
            (root / rel).parent.mkdir(parents=True, exist_ok=True)
            (root / rel).write_bytes(data)
    disk = tmp_path / "disk.img"
    with open(disk, "wb") as f:
        f.truncate(32 << 20)
    subprocess.run([mkfs, "-q", "-d", str(root), str(disk)], check=True)
    db = VulnDB.load(BUILD_DB(tmp_path))
    kw = dict(scanners=("vuln", "secret", "license"), license_full=True, db=db,
              cache_dir=str(tmp_path / "c1"))
    before = dict(match_cuda.LAUNCHES)
    on_card, stats = cli.scan_vm(str(disk), device=card, **kw)
    launched = kernel_launches(before)
    before = dict(match_cuda.LAUNCHES)
    again, stats2 = cli.scan_vm(str(disk), device=card, **kw)
    relaunched = kernel_launches(before)
    on_cpu, _ = cli.scan_vm(str(disk), device="cpu", **{**kw, "cache_dir": str(tmp_path / "c2")})
    assert all(launched.values()) and launched["verscmp"] == 1, launched
    assert stats2["files_walked"] == 0 and relaunched["verscmp"] == 1
    assert not any(v for k, v in relaunched.items() if k != "verscmp"), relaunched
    mine, ref = on_card.to_dict(), on_cpu.to_dict()
    assert mine["Results"] == ref["Results"] == again.to_dict()["Results"]
    assert mine["Metadata"] == ref["Metadata"]
    assert {"/app/key.py", "/app/old.env"} <= {r.target for r in on_card.results}


@pytest.mark.cuda
@pytest.mark.parametrize("parallel,host_fallback", [(1, False), (0, False), (1, True), (0, True)],
                         ids=["serial", "parallel", "serial-fallback", "parallel-fallback"])
def test_device_error_in_one_layer_fails_image_scan_on_card(card, tmp_path, monkeypatch,
                                                           parallel, host_fallback):
    """A matcher that fails from its second call on with a CUDA error, as an
    illegal address surfaces: a kernel fault, which no rung absorbs, so the
    image scan fails with the fallback on or off (no layer is reported
    without its secret scan)."""
    path = card_image(tmp_path)
    calls = {"n": 0}
    real = CudaMatcher.__call__

    def failing(self, chunks):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
        return real(self, chunks)

    monkeypatch.setattr(CudaMatcher, "__call__", failing)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        cli.scan_image(path, device=card, scanners=("secret",), parallel=parallel,
                       cache_dir=str(tmp_path / "c"), host_fallback=host_fallback)


def ladder_tree(root: Path) -> Path:
    """96 files of 64 KiB with secrets planted: with the 64-row batches of
    :func:`small_batches`, several batches."""
    rng = np.random.default_rng(14)
    secrets = sorted(SAMPLES.values())
    for i in range(96):
        body = rng.integers(97, 123, 1 << 16, dtype=np.uint8).tobytes()
        p = root / f"d{i % 7}" / f"f{i}.txt"
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(body[:4096] + f"\nkey = {secrets[i % len(secrets)]}\n".encode()
                      + body[4096:])
    return root


def ladder_scan(tree: Path, out_dir: Path, tag: str, device: str, *extra: str) -> tuple:
    """``fs --scanners secret`` of ``tree`` through ``cli.main``, with a
    fresh cache: (exit code, report, counters)."""
    out, st = out_dir / f"{tag}.json", out_dir / f"{tag}.stats.json"
    rc = cli.main(["fs", "--scanners", "secret", "--device", device, "--format", "json",
                   "-o", str(out), "--stats-out", str(st), "--cache-dir", str(out_dir / tag),
                   "-q", *extra, str(tree)])
    doc = json.loads(out.read_text()) if out.exists() else None
    stats = json.loads(st.read_text()) if st.exists() else None
    return rc, doc, stats


@pytest.fixture
def small_batches(monkeypatch):
    """64-row batches, so the ladder tree makes several."""
    from trivy_tpu_torch.secret import scanner as secret_scanner

    monkeypatch.setattr(secret_scanner, "BATCH", 64)


@pytest.mark.cuda
@pytest.mark.parametrize("spec,counter", [("device.dispatch@d0:at=2", "batch_retries"),
                                          ("device.dispatch@d0:at=1:error=oom", "batch_splits")],
                         ids=["retry", "oom-split"])
def test_ladder_recovers_on_card(card, tmp_path, small_batches, spec, counter):
    """Runs (a) and (c) of the smoke's ``ladder`` phase: a faulted dispatch
    is retried, an OOM-shaped one splits the batch; the report equals the
    unfaulted card scan's and is not degraded."""
    tree = ladder_tree(tmp_path / "tree")
    rc0, base, s0 = ladder_scan(tree, tmp_path, "base", "cuda")
    before = dict(match_cuda.LAUNCHES)
    rc, doc, st = ladder_scan(tree, tmp_path, "faulted", "cuda", "--fault-inject", spec)
    assert rc0 == rc == 0 and s0["batches"] >= 3
    assert s0["batch_retries"] == s0["batch_splits"] == s0["degraded"] == 0
    assert st[counter] >= 1 and st["degraded"] == 0 and "Degraded" not in doc
    assert doc["Results"] == base["Results"]
    assert match_cuda.LAUNCHES["anchored"] + match_cuda.LAUNCHES["prefilter"] > sum(
        before.get(k, 0) for k in ("anchored", "prefilter"))


@pytest.mark.cuda
def test_dead_device_degrades_on_card(card, tmp_path, small_batches):
    """Run (e): every dispatch fails. On the CPU the scan degrades to the
    host engine (its unfaulted findings, ``Degraded``); on the card the
    exhausted ladder fails the scan whatever ``--no-host-fallback`` says,
    after the retries, and leaves a terminal bundle that ``debug``
    renders."""
    from trivy_tpu_torch import faults
    from trivy_tpu_torch.obs import recorder

    tree = ladder_tree(tmp_path / "tree")
    rc0, want, _ = ladder_scan(tree, tmp_path, "cpu", "cpu")
    rc, doc, st = ladder_scan(tree, tmp_path, "cpu-dead", "cpu", "--fault-inject",
                              "device.dispatch:times=-1")
    assert rc0 == rc == 0 and doc["Degraded"] is True and st["degraded"] == 1
    assert doc["Results"] == want["Results"]
    for tag, extra in (("dead", ()), ("loud", ("--no-host-fallback",))):
        dbg = tmp_path / f"bundles-{tag}"
        old_dir = recorder._STATE.debug_dir
        try:
            with pytest.raises(faults.InjectedFault):
                ladder_scan(tree, tmp_path, tag, "cuda", "--fault-inject",
                            "device.dispatch:times=-1", "--debug-dir", str(dbg), *extra)
        finally:
            recorder._STATE.debug_dir = old_dir
        (bundle,) = dbg.glob("bundle-*-terminal-failure.json.gz")
        doc = recorder.read_bundle(str(bundle))
        assert doc["error"] == "injected fault at device.dispatch[d0] hit 3"
        assert "fault device.dispatch" in doc["verdict"]
        assert cli.main(["debug", str(bundle)]) == 0


# -- the feed's transfer streams ----------------------------------------------


def stream_corpus(seed: int, n: int = 160) -> list:
    """Seeded files of text, random bytes and zero pages, some with planted
    samples: with 2 KiB rows and 8-row batches, many short batches."""
    rng = np.random.default_rng(seed)
    samples = sorted(SAMPLES.values())
    files = []
    for i in range(n):
        kind = i % 4
        if kind == 0:
            body = rng.integers(32, 127, int(rng.integers(100, 9000)), dtype=np.uint8).tobytes()
        elif kind == 1:
            body = (b"the rate that the land sent was on and in their line\n" * 40
                    + samples[i % len(samples)].encode() + b"\n")
        elif kind == 2:
            body = b"head\n" + b"\0" * int(rng.integers(3000, 7000))
        else:
            body = rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()
        files.append((f"d{i % 7}/f{i}.txt", body))
    return files


@pytest.mark.cuda
@pytest.mark.parametrize("streams,inflight,slabs", [(4, 3, 0), (4, 3, 2), (2, 2, 0)],
                         ids=["4x3", "race-4x3-2-slabs", "2x2"])
def test_streams_and_windows_equal_one_by_one_on_card(card, streams, inflight, slabs):
    """Several transfer streams, each on its own CUDA stream with batches in
    flight (and the smallest arena, the race probe), find what one stream
    with one batch in flight finds, and what the exact engine finds; every
    slab returns to the arena."""
    files = stream_corpus(5)
    exact = SecretScanner()
    want = [exact.scan_bytes(p, d).to_dict() for p, d in files]
    one = TorchSecretScanner(chunk_len=2048, batch_size=8, device=card, feed_streams=1,
                             inflight=1)
    many = TorchSecretScanner(chunk_len=2048, batch_size=8, device=card,
                              feed_streams=streams, inflight=inflight, arena_slabs=slabs)
    assert [s.to_dict() for s in one.scan_files(files)] == want
    assert [s.to_dict() for s in many.scan_files(files)] == want
    feed = many._last_feed_stats
    assert feed["streams"] == streams and feed["arena_free"] == feed["arena_slabs"]
    assert many.stats.snapshot()["batches"] > 2 * streams


@pytest.mark.cuda
def test_launch_counts_add_up_after_a_multi_stream_scan(card):
    """Four streams launch at once: the launch counts lose no increment.
    One prefilter per batch, one anchored matcher per batch that did not
    skip it, one decompress per compressed batch."""
    files = stream_corpus(6, 240)
    sc = TorchSecretScanner(chunk_len=2048, batch_size=8, device=card, feed_streams=4,
                            inflight=3)
    before = dict(match_cuda.LAUNCHES)
    list(sc.scan_files(files))
    s = sc.stats.snapshot()
    delta = {k: match_cuda.LAUNCHES[k] - before.get(k, 0)
             for k in ("prefilter", "anchored", "decompress")}
    assert delta == {"prefilter": s["batches"],
                     "anchored": s["batches"] - s["batches_nfa_skipped"],
                     "decompress": s["batches_compressed"]}
    assert s["batches"] > 12


@pytest.mark.cuda
def test_tuned_cli_scan_on_card_equals_cpu(card, tmp_path):
    """``fs --tune --tuning-interval 0.01`` with four streams on the card:
    the CPU's ``Results`` and a tuning block with the controller's log."""
    tree = tmp_path / "tree"
    for path, data in stream_corpus(7, 120):
        (tree / path).parent.mkdir(parents=True, exist_ok=True)
        (tree / path).write_bytes(data)
    docs = {}
    for device, extra in (("cpu", ()), ("cuda", ("--tune", "--tuning-interval", "0.01",
                                                 "--secret-streams", "4"))):
        out, m = tmp_path / f"{device}.json", tmp_path / f"{device}.metrics.json"
        assert cli.main(["fs", "--scanners", "secret", "--device", device, "--format", "json",
                         "-o", str(out), "--metrics-out", str(m), "-q", *extra,
                         str(tree)]) == 0
        docs[device] = json.loads(out.read_text()), json.loads(m.read_text())
    assert docs["cuda"][0]["Results"] == docs["cpu"][0]["Results"]
    tuning = docs["cuda"][1]["tuning"]
    assert tuning["config"]["source"]["feed_streams"] == "cli"
    assert tuning["controller"]["ticks"] >= 0 and "decision_log" in tuning["controller"]


# -- several devices ------------------------------------------------------------------


@pytest.mark.cuda
def test_rows_on_another_device_than_the_tables_raise_on_card(card):
    """A launch whose rows and tables sit on different devices raises
    ``KernelError`` in every wrapper, so a machine with several cards fails
    loudly instead of reading another card's memory. With one card, each
    wrapper is told its tables are on ``cuda:1``."""
    from trivy_tpu_torch.ops._build import KernelError
    from trivy_tpu_torch.ops.bytes_gate_cuda import CudaBytesGate
    from trivy_tpu_torch.ops.bytes_score_cuda import CudaBytesScorer
    from trivy_tpu_torch.ops.gram_gate import build_gram_gate_fn

    t = LicenseClassifier(device=card)._device_scorer().table
    clf = LicenseClassifier(device="cpu")
    clf._build_scoring()
    codec = SlabCodec(1024)
    rows = torch.zeros((8, 1024), dtype=torch.uint8, device=card)
    frame = (torch.zeros(16, dtype=torch.uint8, device=card),
             torch.zeros(8, dtype=torch.int32, device=card),
             torch.zeros(8, dtype=torch.int32, device=card),
             torch.zeros(8, dtype=torch.uint8, device=card))
    calls = [
        (CudaMatcher(match_tables(compile_rules(SecretScanner().rules), True), 1024, card,
                     "anchored"), (rows,)),
        (build_gram_gate_fn(1024, clf._LUT, clf._gate_keys, clf._anchor_sorted, int(clf._P1),
                            int(clf._P2), int(clf._HASH_P), ngram=clf._NGRAM, device=card),
         (rows,)),
        (CudaBytesGate(t.lut, t.gate.bloom8, t.gate.bloom4, card), (rows,)),
        (CudaBytesScorer(t.lut, t.keys, t.credit, t.p1, t.p2, t.hash_p, t.ngram, card),
         (rows, 256)),
        (build_decompress_fn(1024, codec.tab_bytes, codec.tab_len, card), frame),
    ]
    before = dict(match_cuda.LAUNCHES)
    for fn, args in calls:
        fn.device = torch.device("cuda", 1)
        with pytest.raises(KernelError, match="cuda:1"):
            fn(*args)
    assert dict(match_cuda.LAUNCHES) == before  # nothing launched


def rr_files() -> list:
    """A small tree's files: planted samples, text and zero pages, in enough
    64-row batches of 2 KiB rows to go round both devices many times."""
    return stream_corpus(7, 200)


@pytest.mark.cuda
def test_round_robin_over_one_card_twice_equals_cpu_on_card(card):
    """``[cuda:0, cuda:0]`` round-robin: the findings equal the one-device
    card scan's and the exact engine's, both dispatch indices take batches
    (``mesh.d<i>.batches``), and with ``d1`` dead the breaker opens on it
    alone while the findings stay equal and nothing degrades."""
    from trivy_tpu_torch import faults, obs
    from trivy_tpu_torch.obs import metrics

    files = rr_files()
    exact = SecretScanner()
    want = [exact.scan_bytes(p, d).to_dict() for p, d in files]
    two = ["cuda:0", "cuda:0"]
    rr = TorchSecretScanner(chunk_len=2048, batch_size=8, device=card, dispatch="round_robin",
                            devices=two)
    assert rr.dispatch == "round_robin" and rr.feed_streams == 2
    ctx = obs.TraceContext(enabled=True)
    with obs.activate(ctx):
        assert [s.to_dict() for s in rr.scan_files(files)] == want
    assert ctx.counters.get("mesh.d0.batches", 0) > 0 and ctx.counters.get("mesh.d1.batches", 0) > 0
    single = TorchSecretScanner(chunk_len=2048, batch_size=8, device=card, dedup=False)
    assert [s.to_dict() for s in single.scan_files(files)] == want
    dead = TorchSecretScanner(chunk_len=2048, batch_size=8, device=card, dispatch="round_robin",
                              devices=two, dedup=False)
    faults.configure("device.dispatch@d1:times=-1")
    try:
        assert [s.to_dict() for s in dead.scan_files(files)] == want
    finally:
        faults.clear()
    assert dead._staged.breaker.open_devices() == [1]
    assert dead.stats.snapshot()["degraded"] == 0
    assert 'trivy_tpu_device_breaker_open{device="d1"} 1' in metrics.REGISTRY.render()


def npm_lock(seed: int, n: int) -> str:
    rng = np.random.default_rng(seed)
    return json.dumps({"lockfileVersion": 3, "packages": {
        f"node_modules/p{i}/node_modules/{['lodash', 'minimist', 'other'][i % 3]}": {
            "version": f"{rng.integers(0, 5)}.{rng.integers(0, 21)}.{rng.integers(0, 26)}"}
        for i in range(n)}})


@pytest.mark.cuda
def test_client_server_scan_on_card_equals_local_card_scan(card, tmp_path):
    """``fs --server`` against an in-process server on the card: the
    client's secret feed and the server's constraint kernel launch, and
    the ``Results`` equal a local card scan's."""
    from trivy_tpu_torch.cache import new_cache
    from trivy_tpu_torch.rpc.server import start_server

    (tmp_path / "tree" / "web").mkdir(parents=True)
    (tmp_path / "tree" / "web" / "package-lock.json").write_text(npm_lock(4, 1000))
    (tmp_path / "tree" / "key.py").write_text(f"k = '{SAMPLES['github-pat']}'\n")
    db = VulnDB.load(BUILD_DB(tmp_path))
    local, _ = cli.scan_fs(str(tmp_path / "tree"), scanners=("vuln", "secret"), db=db,
                           device=card)
    httpd, port = start_server(cache=new_cache("memory"), vuln_client=VulnDB.load(
        BUILD_DB(tmp_path / "srv")), device=card)
    try:
        before = dict(match_cuda.LAUNCHES)
        remote, stats = cli.scan_fs(str(tmp_path / "tree"), scanners=("vuln", "secret"),
                                    device=card, server=f"http://127.0.0.1:{port}")
        launched = {k: v - before.get(k, 0) for k, v in match_cuda.LAUNCHES.items()}
    finally:
        httpd.shutdown()
    assert remote.to_dict()["Results"] == local.to_dict()["Results"]
    assert launched["verscmp"] == 1 and launched["prefilter"] >= 1
    assert stats["remote.blobs_sent"] == 1
    assert sum(len(r.vulnerabilities) for r in remote.results) > 100


@pytest.mark.cuda
def test_concurrent_dispatches_on_card_equal_serial(card, tmp_path):
    """Four threads scan their own lockfile sets against one DB on the card
    at once, round after round: each equals its serial scan (the DB's
    constraint dispatch buffers serve one dispatch at a time)."""
    import threading

    db = VulnDB.load(BUILD_DB(tmp_path))
    trees = []
    for t in range(4):
        (tmp_path / f"t{t}" / "web").mkdir(parents=True)
        (tmp_path / f"t{t}" / "web" / "package-lock.json").write_text(npm_lock(10 + t, 700 + 50 * t))
        trees.append(str(tmp_path / f"t{t}"))

    def scan(t):
        return cli.scan_fs(trees[t], scanners=("vuln",), db=db, device=card)[0].to_dict()["Results"]

    serial = [scan(t) for t in range(4)]
    assert len({json.dumps(s) for s in serial}) == 4
    bad = []

    def client(t):
        for _ in range(5):
            if scan(t) != serial[t]:
                bad.append(t)

    threads = [threading.Thread(target=client, args=(t,)) for t in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert bad == []


FEED_KERNELS = ("prefilter", "anchored", "decompress", "gram_gate", "bytes_gate", "bytes_score")


@pytest.mark.cuda
def test_unchanged_incremental_rescan_launches_no_feed_kernel_on_card(card, tmp_path):
    """``fs --incremental`` of a tree with secrets and license texts on the
    card, then ``--since-last`` over the unchanged tree: the cold scan
    launches the matcher, the fused gate and the classifier's kernels, the
    rescan analyzes no unit and launches none of the feed's or the license
    kernels, with the cold scan's ``Results``; ``verscmp`` launches in both."""
    rng = np.random.default_rng(6)
    tree = tmp_path / "tree"
    texts = sorted(FULL_TEXTS)
    files = {"web/package-lock.json": json.dumps({"lockfileVersion": 3, "packages": {
        f"node_modules/p{i}/node_modules/{['lodash', 'minimist'][i % 2]}": {
            "version": f"{rng.integers(0, 5)}.{rng.integers(0, 21)}.{rng.integers(0, 26)}"}
        for i in range(1000)}})}
    for i in range(12):
        files[f"mod{i:02d}/LICENSE"] = FULL_TEXTS[texts[int(rng.integers(len(texts)))]]
        files[f"mod{i:02d}/key.py"] = f"k = '{SAMPLES['github-pat']}'\n"
    for rel, text in files.items():
        (tree / rel).parent.mkdir(parents=True, exist_ok=True)
        (tree / rel).write_text(text)
    head = ["fs", "--scanners", "vuln,secret,license", "--db-repository", BUILD_DB(tmp_path),
            "--device", "cuda", "-q", "--format", "json", "--cache-dir", str(tmp_path / "c")]
    runs = []
    for flag in ("--incremental", "--since-last"):
        out, stats = tmp_path / f"{flag[2:]}.json", tmp_path / f"{flag[2:]}.stats.json"
        match_cuda.LAUNCHES.clear()
        assert cli.main([*head, "-o", str(out), "--stats-out", str(stats), flag,
                         str(tree)]) == 0
        runs.append((json.loads(out.read_text()), json.loads(stats.read_text()),
                     dict(match_cuda.LAUNCHES)))
    (cold, cold_st, cold_l), (warm, warm_st, warm_l) = runs
    assert cold["Results"] == warm["Results"]
    assert cold_st["units_analyzed"] == cold_st["units_total"] == 13
    assert (warm_st["units_analyzed"], warm_st["files_stat_reused"]) == (0, 25)
    # twelve license texts: the fused gate and the classifier's device path
    assert all(cold_l.get(k, 0) > 0 for k in ("prefilter", "anchored", "gram_gate",
                                               "bytes_gate", "bytes_score", "verscmp")), cold_l
    assert not any(warm_l.get(k, 0) for k in FEED_KERNELS), warm_l
    assert warm_l.get("verscmp", 0) == cold_l["verscmp"]


@pytest.mark.cuda
def test_fleet_shards_on_card_equal_cpu(card, tmp_path):
    """A fleet replica's work on the card: an fs shard of ``secret,license
    --license-full`` over :func:`card_files`' texts and every layer shard of
    :func:`card_image` through ``execute_shard`` on ``cuda``, each blob and
    key equal to the same shard's on the CPU, with the feed's and the
    license kernels launched."""
    from trivy_tpu_torch.artifact.image import ImageArchiveArtifact
    from trivy_tpu_torch.cache import new_cache
    from trivy_tpu_torch.fanal.scan import ScanAnalyzers
    from trivy_tpu_torch.fleet import plan

    tree = tmp_path / "tree"
    apps, content = card_files()
    for rel, data in {**apps, **content}.items():
        (tree / rel).parent.mkdir(parents=True, exist_ok=True)
        (tree / rel).write_bytes(data)
    settings = plan.ShardSettings(scanners=["secret", "license"], license_full=True,
                                  device="cuda")
    (shard,) = plan.plan_fs_shards(str(tree), settings, 1)[0]
    path = card_image(tmp_path)
    scanners = ["vuln", "secret", "license"]
    art = ImageArchiveArtifact(path, new_cache("memory"),
                               ScanAnalyzers(scanners, "cpu", license_full=True, packages=True))
    layers = plan.plan_image_shards(art, new_cache("memory"), plan.ShardSettings(
        scanners=scanners, license_full=True, device="cuda")).shards
    assert shard.wire["Backend"] == "auto" and len(layers) == 4
    before = dict(match_cuda.LAUNCHES)
    on_card = [plan.execute_shard(s.wire, new_cache("memory"), device=card)
               for s in (shard, *layers)]
    launched = kernel_launches(before)
    on_cpu = [plan.execute_shard(s.wire, new_cache("memory"), device="cpu")
              for s in (shard, *layers)]
    assert json.dumps(on_card, sort_keys=True) == json.dumps(on_cpu, sort_keys=True)
    assert all(launched[k] > 0 for k in FEED_KERNELS) and launched["verscmp"] == 0, launched
    info = on_card[0][0]["BlobInfo"]
    assert info["Secrets"] and len(info["Licenses"]) >= len(FULL_TEXTS)


@pytest.mark.cuda
def test_fleet_coordinator_on_card_equals_cpu(card, tmp_path):
    """``scan_fleet`` of :func:`card_files`' tree with ``vuln,secret,license
    --license-full`` over two in-process port replicas, the replicas and
    the coordinator on the card, then on the CPU: equal ``Results``. On the
    card the replicas launch the feed's and the license kernels and the
    coordinator's fold one ``verscmp``. With every replica dead the local
    fallback launches the feed's and the license kernels in the
    coordinator, and the report is ``Degraded`` with the same ``Results``."""
    from trivy_tpu_torch.cache import new_cache
    from trivy_tpu_torch.fleet.coordinator import FleetConfig
    from trivy_tpu_torch.rpc.admission import resolve_admission
    from trivy_tpu_torch.rpc.server import start_server

    tree = tmp_path / "tree"
    apps, content = card_files()
    for rel, data in {**apps, **content}.items():
        (tree / rel).parent.mkdir(parents=True, exist_ok=True)
        (tree / rel).write_bytes(data)
    db = VulnDB.load(BUILD_DB(tmp_path))
    kw = dict(scanners=("vuln", "secret", "license"), license_full=True, db=db)
    got = {}
    for dev in ("cuda", "cpu"):
        servers = [start_server(cache=new_cache("memory"), device=dev,
                                admission=resolve_admission({"max_concurrent_scans": 2}))
                   for _ in range(2)]
        cfg = FleetConfig(hosts=[f"127.0.0.1:{port}" for _, port in servers],
                          telemetry_interval=0.0, speculate=0.0)
        try:
            before = dict(match_cuda.LAUNCHES)
            report, counters = cli.scan_fleet("fs", str(tree), cfg, device=dev, **kw)
            got[dev] = (report.to_dict(), kernel_launches(before), counters)
        finally:
            for httpd, _ in servers:
                httpd.shutdown()
    doc, launched, counters = got["cuda"]
    assert doc["Results"] == got["cpu"][0]["Results"] and "Degraded" not in doc
    assert all(launched[k] > 0 for k in FEED_KERNELS) and launched["verscmp"] == 1, launched
    assert counters["fleet.local_fallback"] == 0 and counters["fleet.shards"] >= 2
    before = dict(match_cuda.LAUNCHES)
    report, counters = cli.scan_fleet(
        "fs", str(tree), FleetConfig(hosts=["127.0.0.1:9"], telemetry_interval=0.0,
                                     rpc_retries=0, rpc_deadline=2.0), device="cuda", **kw)
    launched = kernel_launches(before)
    dead = report.to_dict()
    assert dead["Degraded"] is True and dead["Results"] == doc["Results"]
    assert counters["fleet.local_fallback"] == counters["fleet.shards"]
    assert all(launched[k] > 0 for k in FEED_KERNELS) and launched["verscmp"] == 1, launched


@pytest.mark.cuda
def test_fleet_telemetry_on_card_equals_cpu(card, tmp_path):
    """``chip_smoke.py``'s leg (g1) at a small size: ``scan_fleet`` of
    :func:`card_files`' tree over two in-process port replicas with the
    telemetry plane at its default interval (1.0 s), the replicas and the
    coordinator on the card, then on the CPU: equal ``Results``, the
    replicas launching the feed's and the license kernels, and a ``fleet``
    doc naming both replicas, each scraped with a headroom in [0, 1]; no
    poller thread and no ``trivy_tpu_fleet_*`` row outlives either scan."""
    import threading

    from trivy_tpu_torch import obs
    from trivy_tpu_torch.cache import new_cache
    from trivy_tpu_torch.fleet.coordinator import FleetConfig
    from trivy_tpu_torch.obs import metrics as obs_metrics
    from trivy_tpu_torch.rpc.admission import resolve_admission
    from trivy_tpu_torch.rpc.server import start_server

    tree = tmp_path / "tree"
    apps, content = card_files()
    for rel, data in {**apps, **content}.items():
        (tree / rel).parent.mkdir(parents=True, exist_ok=True)
        (tree / rel).write_bytes(data)
    db = VulnDB.load(BUILD_DB(tmp_path))
    got = {}
    for dev in ("cuda", "cpu"):
        servers = [start_server(cache=new_cache("memory"), device=dev,
                                admission=resolve_admission({"max_concurrent_scans": 2}))
                   for _ in range(2)]
        hosts = [f"127.0.0.1:{port}" for _, port in servers]
        cfg = FleetConfig(hosts=list(hosts), speculate=0.0)
        assert cfg.telemetry_interval == 1.0
        try:
            before = dict(match_cuda.LAUNCHES)
            with obs.scan_context(name="fleet-telemetry-card", enabled=True) as ctx:
                report, _ = cli.scan_fleet(
                    "fs", str(tree), cfg, device=dev, scanners=("vuln", "secret", "license"),
                    license_full=True, db=db)
            got[dev] = (report.to_dict(), kernel_launches(before))
        finally:
            for httpd, _ in servers:
                httpd.shutdown()
        assert sorted(ctx.fleet["replicas"]) == sorted(hosts) and ctx.fleet["interval_s"] == 1.0
        for rep in ctx.fleet["replicas"].values():
            assert rep["scrapes"] >= 2 and 0.0 <= rep["headroom"] <= 1.0, rep
        assert not [t for t in threading.enumerate() if t.name.startswith("fleet-telemetry")]
        assert not [line for line in obs_metrics.REGISTRY.render().splitlines()
                    if line.startswith("trivy_tpu_fleet_")]
    doc, launched = got["cuda"]
    assert doc["Results"] == got["cpu"][0]["Results"] and "Degraded" not in doc
    assert all(launched[k] > 0 for k in FEED_KERNELS) and launched["verscmp"] == 1, launched


@pytest.mark.cuda
def test_terraform_scan_on_card_equals_cpu(card, tmp_path):
    """``fs --scanners misconfig,secret`` of a seeded Terraform monorepo
    (modules called by environment roots, ``.tfvars``, ``.tf.json``, every
    provider, a plan and two ARM templates) with planted credentials on the
    card: the ``Results`` and ``Metadata`` of the same scan on the CPU, the
    cloud failures and every secret reported, the feed's kernels launched."""
    tree = tmp_path / "tree"
    TFTREE["write_tf_monorepo"](tree, 1, modules=8, envs=4, blocks=4, plan_bytes=64 << 10,
                                secrets={"aws": SAMPLES["aws-access-key-id"],
                                         "github": SAMPLES["github-pat"]})
    docs = {}
    for device in ("cuda", "cpu"):
        out = tmp_path / f"{device}.json"
        match_cuda.LAUNCHES.clear()
        assert cli.main(["fs", "--scanners", "misconfig,secret", "--device", device, "-q",
                         "--format", "json", "-o", str(out), str(tree)]) == 0
        docs[device] = (json.loads(out.read_text()), dict(match_cuda.LAUNCHES))
    (card_doc, launches), (cpu_doc, _) = docs["cuda"], docs["cpu"]
    assert card_doc["Results"] == cpu_doc["Results"]
    assert card_doc["Metadata"] == cpu_doc["Metadata"]
    fails = {m["ID"] for r in card_doc["Results"] for m in r.get("Misconfigurations", [])
             if m["Status"] == "FAIL"}
    assert {"AVD-AWS-0107", "AVD-AZU-0008", "AVD-GCP-0002"} <= fails
    assert sorted(s["RuleID"] for r in card_doc["Results"] for s in r.get("Secrets", [])) == [
        "aws-access-key-id", "github-pat"]
    assert launches.get("prefilter", 0) > 0, launches


@pytest.mark.cuda
def test_cloudformation_and_chart_scan_on_card_equals_cpu(card, tmp_path):
    """``fs --scanners misconfig,secret`` of a seeded tree of CloudFormation
    stacks (YAML and JSON, with intrinsics), Helm charts, a Dockerfile
    beside them and planted credentials on the card: the ``Results`` and
    ``Metadata`` of the same scan on the CPU, the stacks' and the charts'
    failures, every secret, the feed's kernels launched."""
    tree = tmp_path / "tree"
    IACTREE["write_iac_tree"](tree, 2, stacks=3, charts=3,
                              secrets={"aws": SAMPLES["aws-access-key-id"],
                                       "github": SAMPLES["github-pat"]})
    docs = {}
    for device in ("cuda", "cpu"):
        out = tmp_path / f"{device}.json"
        match_cuda.LAUNCHES.clear()
        assert cli.main(["fs", "--scanners", "misconfig,secret", "--device", device, "-q",
                         "--format", "json", "-o", str(out), str(tree)]) == 0
        docs[device] = (json.loads(out.read_text()), dict(match_cuda.LAUNCHES))
    (card_doc, launches), (cpu_doc, _) = docs["cuda"], docs["cpu"]
    assert card_doc["Results"] == cpu_doc["Results"]
    assert card_doc["Metadata"] == cpu_doc["Metadata"]
    fails = {(r["Type"], m["ID"]) for r in card_doc["Results"]
             for m in r.get("Misconfigurations", []) if m["Status"] == "FAIL"}
    assert {("cloudformation", i) for i in IACTREE["CFN_IDS"]} <= fails
    assert {("helm", i) for i in IACTREE["HELM_IDS"]} <= fails
    assert sorted(s["RuleID"] for r in card_doc["Results"] for s in r.get("Secrets", [])) == [
        "aws-access-key-id", "github-pat"]
    assert launches.get("prefilter", 0) > 0, launches


@pytest.mark.cuda
def test_misconfig_scan_on_card_equals_cpu(card, tmp_path):
    """``fs --scanners misconfig,secret`` of Dockerfiles, manifests, a YAML
    and a JSON file and planted secrets on the card: the ``Results`` and
    ``Metadata`` of the same scan on the CPU, the DS and KSV failures
    reported, the matcher launched."""
    files = {
        "svc/Dockerfile": "FROM golang:1.22 AS build\nRUN apt-get update && \\\n"
                          "    apt-get install -y git\nFROM alpine:latest\nUSER root\n"
                          "CMD [\"/app\"]\n",
        "deploy/app.yaml": "apiVersion: apps/v1\nkind: Deployment\nmetadata:\n  name: web\n"
                           "spec:\n  template:\n    spec:\n      hostPID: true\n"
                           "      containers:\n      - name: app\n        image: nginx:latest\n"
                           "---\napiVersion: v1\nkind: Pod\nmetadata:\n  name: p\nspec:\n"
                           "  containers:\n  - name: c\n    image: i:1\n    securityContext:\n"
                           "      privileged: true\n",
        "config/values.yaml": "replicas: 3\n",
        "config/settings.json": "{\"port\": 8080}\n",
    }
    for i in range(8):
        files[f"src/key{i}.py"] = f"k = '{SAMPLES['github-pat']}'\n"
    tree = tmp_path / "tree"
    for rel, text in files.items():
        (tree / rel).parent.mkdir(parents=True, exist_ok=True)
        (tree / rel).write_text(text)
    docs = {}
    for device in ("cuda", "cpu"):
        out = tmp_path / f"{device}.json"
        match_cuda.LAUNCHES.clear()
        assert cli.main(["fs", "--scanners", "misconfig,secret", "--device", device, "-q",
                         "--format", "json", "-o", str(out), str(tree)]) == 0
        docs[device] = (json.loads(out.read_text()), dict(match_cuda.LAUNCHES))
    (card_doc, launches), (cpu_doc, _) = docs["cuda"], docs["cpu"]
    assert card_doc["Results"] == cpu_doc["Results"]
    assert card_doc["Metadata"] == cpu_doc["Metadata"]
    fails = {m["ID"] for r in card_doc["Results"] for m in r.get("Misconfigurations", [])
             if m["Status"] == "FAIL"}
    assert {"DS001", "DS002", "KSV017", "KSV010"} <= fails
    assert sum(1 for r in card_doc["Results"] if r["Class"] == "secret") == 8
    assert launches.get("prefilter", 0) > 0, launches
