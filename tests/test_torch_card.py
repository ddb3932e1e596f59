"""The CUDA kernels on the card: the matcher held against ``match_plain``,
the decompressor against ``decompress_plain``, and a compressed scan.

Every test here needs an NVIDIA card and skips without one. The file
imports neither ``jax`` nor ``trivy_tpu``, so on a machine with a card and
no JAX it runs without the suite's conftest:

    python -m pytest --noconftest -q tests/test_torch_card.py
"""

import runpy
from pathlib import Path

import numpy as np
import pytest
import torch

from trivy_tpu_torch.ops import match_cuda
from trivy_tpu_torch.ops.decompress import build_decompress_fn, decompress_plain
from trivy_tpu_torch.ops.match import MatchTables, match_plain, match_tables
from trivy_tpu_torch.ops.match_cuda import CudaMatcher
from trivy_tpu_torch.ops.prefilter import _keyword_only
from trivy_tpu_torch.secret.compress import MODE_PACK7, MODE_RAW, MODE_TOKEN, SlabCodec
from trivy_tpu_torch.secret.device_compile import compile_rules
from trivy_tpu_torch.secret.engine import ScannerConfig, SecretScanner
from trivy_tpu_torch.secret.scanner import TorchSecretScanner

# the fixtures are loaded by path, as chip_smoke.py loads them: a package
# named ``tests`` installed on the machine would shadow this directory
HERE = Path(__file__).resolve().parent
SAMPLES = runpy.run_path(str(HERE / "secret_samples.py"))["SAMPLES"]
CUSTOM = runpy.run_path(str(HERE / "test_torch_rulesets.py"))
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
