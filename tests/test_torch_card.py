"""The CUDA matcher kernel on the card, held against ``match_plain``.

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
from trivy_tpu_torch.ops.match import MatchTables, match_plain, match_tables
from trivy_tpu_torch.ops.match_cuda import CudaMatcher
from trivy_tpu_torch.ops.prefilter import _keyword_only
from trivy_tpu_torch.secret.device_compile import compile_rules
from trivy_tpu_torch.secret.engine import ScannerConfig, SecretScanner

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
