"""The step-split tool (``tools/kernel_study.py``) rewrites copies of the
license kernels' sources; these tests keep its rewrites in step with the
sources as they stand (the builds and timings themselves need a card)."""

from __future__ import annotations

import pytest

from tools import kernel_study as ks
from trivy_tpu_torch.ops import _build


def gate_source() -> str:
    return (_build.CSRC / "gram_gate.cu").read_text()


@pytest.mark.parametrize("kernel, source, barrier, after, steps", [
    ("gram_gate_kernel", "gram_gate.cu", "__syncthreads();", r"compact_starts<[^;]*;",
     ks.GATE_STEPS),
    ("bytes_score_kernel", "bytes_score.cu", "cluster.sync();", r"radix_sort<T>\([^;]*;",
     ks.SCORE_STEPS),
])
def test_stamped_marks_every_step(kernel, source, barrier, after, steps):
    src = (_build.CSRC / source).read_text()
    out = ks.stamped(src, kernel, barrier, after)
    # a stamp at the start and one after each step
    assert out.count("clock64()") >= len(steps) + 1
    assert out.count("trivy_clk[") == out.count("clock64()") + 1  # and its declaration
    assert 'extern "C" int trivy_clocks' in out
    # the text before the kernel is kept (beside the stamps' declaration)
    head = src[:src.index(kernel + "(")]
    assert out.replace(f"__device__ long long trivy_clk[{ks.MAX_BLOCKS * ks.MAX_STAMPS}];\n",
                       "").startswith(head)


def test_gate_stamps_one_per_step():
    out = ks.stamped(gate_source(), "gram_gate_kernel", "__syncthreads();",
                     r"compact_starts<[^;]*;")
    assert out.count("clock64()") == len(ks.GATE_STEPS) + 1


def test_screen_in_shared_reads_the_copy():
    src = gate_source()
    out = ks.screen_in_shared(src)
    body = out[out.index("gram_gate_kernel("):]
    assert "screened(screen, k)" not in body and "screened_s(screen_s, k)" in body
    assert "screen_s[k] = screen[k]" in body
    assert "align16(smem_bytes(C)) + 4 * ((1 << (32 - kScreenShift)) / 32)" in out
    # the variant's stamped copy still marks every step
    stamped = ks.stamped(out, "gram_gate_kernel", "__syncthreads();", r"compact_starts<[^;]*;")
    assert stamped.count("clock64()") == len(ks.GATE_STEPS) + 1


def test_screen_in_shared_refuses_a_source_without_the_screen():
    old = gate_source().replace("screened(screen, k) && ", "")
    with pytest.raises(ValueError, match="screened"):
        ks.screen_in_shared(old)


def test_gate_launcher_signature_drops_screen_and_dir():
    _, argtypes = _build.SIGNATURES["gram_gate"]["trivy_gram_gate_launch"]

    class Lib:
        class trivy_gram_gate_launch:  # noqa: N801 - stands in for a ctypes function
            pass

    class Gate:
        _k = (None,) * 5

    for with_screen, n in ((True, len(argtypes)), (False, len(argtypes) - 2)):
        ks.gate_launcher(Lib, with_screen, Gate, None)
        assert len(Lib.trivy_gram_gate_launch.argtypes) == n
