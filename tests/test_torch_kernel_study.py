"""The step-split tool (``tools/kernel_study.py``) rewrites copies of the
license kernels' sources; these tests keep its rewrites in step with the
sources as they stand (the builds and timings themselves need a card)."""

from __future__ import annotations

import pytest

from tools import kernel_study as ks
from trivy_tpu_torch.ops import _build


def gate_source() -> str:
    return (_build.CSRC / "gram_gate.cu").read_text()


@pytest.mark.parametrize("kernel, source, marks, steps", [
    ("gram_gate_kernel", "gram_gate.cu", ks.GATE_MARKS, ks.GATE_STEPS),
    ("bytes_score_kernel", "bytes_score.cu", ks.SCORE_MARKS, ks.SCORE_STEPS),
])
def test_stamped_marks_every_step(kernel, source, marks, steps):
    src = (_build.CSRC / source).read_text()
    out = ks.marked(src, kernel, marks)
    # a mark for each step, each adding to its own sum, and the prelude's stamp
    assert [m[1] for m in marks] == list(steps)
    assert out.count("+= trivy_t - trivy_last") == len(steps)
    assert out.count("clock64()") == len(steps) + 1
    assert 'extern "C" int trivy_clocks' in out
    # the text before the kernel is kept (beside the stamps' declaration)
    head = src[:src.index(kernel + "(")]
    assert out.replace(f"__device__ long long trivy_clk[{ks.MAX_BLOCKS * ks.MAX_STAMPS}];\n",
                       "").startswith(head)


def test_gate_stamps_one_per_step():
    """The gram gate's marks land after each of its six barriers and
    compactions and at its body's end."""
    out = ks.marked(gate_source(), "gram_gate_kernel", ks.GATE_MARKS)
    assert out.count("clock64()") == len(ks.GATE_STEPS) + 1
    body = out[ks.kernel_body(out, "gram_gate_kernel")[0] :]
    assert body.index(f"trivy_acc[{len(ks.GATE_STEPS) - 1}] +=") > body.rindex("__syncthreads(); {")


def test_screen_in_shared_reads_the_copy():
    src = gate_source()
    out = ks.screen_in_shared(src)
    body = out[out.index("gram_gate_kernel("):]
    assert "screened(screen, k)" not in body and "screened_s(screen_s, k)" in body
    assert "screen_s[k] = screen[k]" in body
    assert "align16(smem_bytes(C)) + 4 * ((1 << (32 - kScreenShift)) / 32)" in out
    # the variant's marked copy still marks every step
    marked = ks.marked(out, "gram_gate_kernel", ks.GATE_MARKS)
    assert marked.count("clock64()") == len(ks.GATE_STEPS) + 1


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


@pytest.mark.parametrize("kernel, marks", [
    ("bytes_gate", ks.BYTES_GATE_MARKS["new"]),
    ("decompress", ks.DECOMPRESS_MARKS["new"]),
    ("verscmp", ks.VERSCMP_MARKS["new"]),
])
def test_marked_marks_every_step_of_the_redesigns(kernel, marks):
    src = (_build.CSRC / f"{kernel}.cu").read_text()
    assert ks.version(src, kernel) == "new"
    out = ks.marked(src, f"{kernel}_kernel", marks)
    start, end = ks.kernel_body(src, f"{kernel}_kernel")
    src = src[start:end]  # the body's returns flush the sums
    # one mark per step, each adding to its own sum, the prelude's stamp,
    # and the sums written out at the body's end
    assert out.count("+= trivy_t - trivy_last") == len(marks)
    for k in range(len(marks)):
        assert f"trivy_acc[{k}] +=" in out
    assert out.count("clock64()") == len(marks) + 1
    assert out.count("trivy_clk[trivy_id * ") == 2 * (1 + src.count("return;"))
    assert 'extern "C" int trivy_clocks(' in out and 'extern "C" int trivy_clocks_reset()' in out
    # the kernel's text is kept, with the marks inserted
    full = (_build.CSRC / f"{kernel}.cu").read_text()
    assert out.startswith(full[: full.index("#include <cuda_runtime.h>")])
    assert full[ks.kernel_body(full, f"{kernel}_kernel")[1] :] in out


def test_marks_stay_in_order_in_the_decompressor():
    """The mode steps land in their own branches: zero before PACK7, PACK7
    before RAW, RAW before TOKEN."""
    src = (_build.CSRC / "decompress.cu").read_text()
    out = ks.marked(src, "decompress_kernel", ks.DECOMPRESS_MARKS["new"])
    steps = [step for _, step, _ in ks.DECOMPRESS_MARKS["new"]]
    at = [out.index(f"trivy_acc[{steps.index(s)}] +=") for s in ("zero", "pack7", "raw", "token_sum")]
    assert at == sorted(at)
    assert out.index("kModePack7) {") < at[1] < out.index("m != kModeToken) {  // RAW")


def test_screens_via_ldg_reads_device_memory():
    src = (_build.CSRC / "bytes_gate.cu").read_text()
    out = ks.screens_via_ldg(src)
    assert "stage_words(sm.s4" not in out and "stage_words(sm.s8" not in out
    assert "const uint32_t* s4 = screen4;" in out and "__ldg(s + (b >> 5))" in out
    assert "*smem = smem_bytes(0, 0);" in out
    # its marked copy still marks every step
    marked = ks.marked(out, "bytes_gate_kernel", ks.BYTES_GATE_MARKS["new"])
    assert marked.count("+= trivy_t - trivy_last") == len(ks.BYTES_GATE_MARKS["new"])


def test_marked_refuses_a_source_without_a_step():
    src = (_build.CSRC / "decompress.cu").read_text().replace("if (nx < B) stage_row", "stage_row")
    with pytest.raises(ValueError, match="issue"):
        ks.marked(src, "decompress_kernel", ks.DECOMPRESS_MARKS["new"])
    with pytest.raises(ValueError, match="no longer has one"):
        ks.screens_via_ldg(ks.screens_via_ldg((_build.CSRC / "bytes_gate.cu").read_text()))


def test_version_tells_a_parent_source_apart():
    for kernel in ("bytes_gate", "decompress", "verscmp"):
        src = (_build.CSRC / f"{kernel}.cu").read_text()
        assert ks.version(src, kernel) == "new"
        assert ks.version(src.replace(ks.VERSION_MARKERS[kernel], "gone"), kernel) == "old"


def test_no_screen8_reads_every_bloom8_word():
    """The variant without bloom8's screen neither stages nor reads it and
    sizes its shared memory without it; bloom4's screen stays."""
    src = (_build.CSRC / "bytes_gate.cu").read_text()
    out = ks.no_screen8(src)
    assert "screened(s8," not in out and "need8 |= 1u << j;" in out
    assert "stage_words(sm.s8" not in out and "stage_words(sm.s4, screen4, s4_words);" in out
    assert "screened(s4, h4[j], s4_bits)" in out
    assert "*smem = smem_bytes((1 << s4_bits) / 32, 0);" in out
    marked = ks.marked(out, "bytes_gate_kernel", ks.BYTES_GATE_MARKS["new"])
    assert marked.count("+= trivy_t - trivy_last") == len(ks.BYTES_GATE_MARKS["new"])
    with pytest.raises(ValueError, match="no longer has one"):
        ks.no_screen8(out)


def test_narrow_blocks_halves_the_block():
    src = (_build.CSRC / "bytes_gate.cu").read_text()
    out = ks.narrow_blocks(src)
    assert "constexpr int kThreads = 256;" in out and "kThreads = 512" not in out
    marked = ks.marked(out, "bytes_gate_kernel", ks.BYTES_GATE_MARKS["new"])
    assert marked.count("+= trivy_t - trivy_last") == len(ks.BYTES_GATE_MARKS["new"])
    with pytest.raises(ValueError, match="kThreads"):
        ks.narrow_blocks(out)


def verscmp_source() -> str:
    return (_build.CSRC / "verscmp.cu").read_text()


def test_verscmp_marks_hold_each_step_before_its_barrier():
    """Each mark of the redesign lands after its step's call, inside the
    persistent loop, with a use of the step's registers (declared in the
    kernel's body) ahead of its barrier."""
    src = verscmp_source()
    start, end = ks.kernel_body(src, "verscmp_kernel")
    body = src[start:end]
    for decl in ("int ai[U], bi[U], op[U];", "int4 ra[U], rb[U];", "int s[U];",
                 "constexpr int U = kRowsPerGroup;"):
        assert decl in body
    out = ks.marked(src, "verscmp_kernel", ks.VERSCMP_MARKS["new"])
    body = out[ks.kernel_body(out, "verscmp_kernel")[0] :]
    loop = body.index("for (long long step = blockIdx.x;")
    for k, (_, step, hold) in enumerate(ks.VERSCMP_MARKS["new"]):
        at = body.index(f"trivy_acc[{k}] +=")
        assert at > loop
        call = {"index": "fetch_index<", "rows": "fetch_rows<", "compare": "compare_rows<",
                "store": "store_rows<"}[step]
        assert body.index(call) < at
        if hold:
            assert body.index(hold) < at and "R < 0 &&" in hold


def test_verscmp_old_marks_fit_the_one_warp_per_row_kernel():
    """The earlier kernel's marks: after its index clamps and ahead of its
    lane-0 tail (no barrier runs after lanes have left)."""
    old = """#include <cuda_runtime.h>
__global__ void __launch_bounds__(kWarps * 32)
verscmp_kernel(const int32_t* __restrict__ inst, int n_inst, int R) {
  if (r >= R) return;
  ai = min(max(ai, 0), n_inst - 1);
  bi = min(max(bi, 0), n_bounds - 1);
  int s = 0;
  for (int c = 0; c < L; c += 32) {
    if (diff) { s = 1; break; }
  }
  if (lane != 0) return;
  verdict[r] = 1;
}
"""
    out = ks.marked(old, "verscmp_kernel", ks.VERSCMP_MARKS["old"])
    assert out.count("+= trivy_t - trivy_last") == 2
    assert out.index("trivy_acc[0] +=") > out.index("bi = min(max(bi, 0), n_bounds - 1);")
    assert out.index("(ai ^ bi) == 1") < out.index("trivy_acc[0] +=")
    assert out.index("trivy_acc[1] +=") < out.index("if (lane != 0)")
    assert out.rindex("__syncthreads()") < out.index("if (lane != 0)")
    assert ks.version(old, "verscmp") == "old"
    # a bare "if (...) return;" keeps its condition: the sums flush inside it
    assert "if (r >= R) { { if (threadIdx.x == 0" in out
    assert "if (lane != 0) { { if (threadIdx.x == 0" in out


def test_bounds_in_shared_reads_its_copy():
    src = verscmp_source()
    out = ks.bounds_in_shared(src)
    assert "load_cols<kVec>(bounds +" not in out
    assert out.count("load_cols_generic<kVec>(bounds +") == 2
    assert out.count("load_cols<kVec>(inst +") == 2  # the inst rows stay on __ldg
    assert out.count("load_cols_generic<kVec>(") == 2
    assert "trivy_sb[k] = __ldg(reinterpret_cast<const int4*>(bounds) + k);" in out
    assert "bounds = reinterpret_cast<const int32_t*>(trivy_sb);" in out
    assert f"trivy_bytes <= {ks.SHARED_BOUND_BYTES} ? trivy_bytes : 0" in out
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in out
    # the staging runs before the loop, its marked copy still marks every step
    body = out[ks.kernel_body(out, "verscmp_kernel")[0] :]
    assert body.index("__syncthreads();") < body.index("for (long long step")
    marked = ks.marked(out, "verscmp_kernel", ks.VERSCMP_MARKS["new"])
    assert marked.count("+= trivy_t - trivy_last") == len(ks.VERSCMP_MARKS["new"])
    with pytest.raises(ValueError, match="no longer has"):
        ks.bounds_in_shared(out)


@pytest.mark.parametrize("U", [1, 2, 8])
def test_rows_per_group_sets_u(U):
    out = ks.rows_per_group(verscmp_source(), U)
    assert f"constexpr int kRowsPerGroup = {U};" in out and "kRowsPerGroup = 4;" not in out
    assert ks.marked(out, "verscmp_kernel", ks.VERSCMP_MARKS["new"]).count("clock64()") == 5


def test_max_group_sets_the_cap():
    out = ks.max_group(verscmp_source(), 32)
    assert "constexpr int kMaxGroup = 32;" in out and "kMaxGroup = 8;" not in out
    assert ks.marked(out, "verscmp_kernel", ks.VERSCMP_MARKS["new"]).count("clock64()") == 5
    with pytest.raises(ValueError, match="no longer has one"):
        ks.max_group(out, 16)
