"""Where the port's kernels spend their time, step by step, on the card.

    python -m tools.kernel_study gate [--source PATH] [--batches 4] [--seed 0]
    python -m tools.kernel_study score [--seed 0]
    python -m tools.kernel_study bytes-gate [--source PATH ...] [--seed 0]
    python -m tools.kernel_study decompress [--source PATH ...] [--seed 0]
    python -m tools.kernel_study verscmp [--source PATH ...] [--seed 0]

(from the repository root). A development tool: nothing in the package
imports it.

Builds copies of a kernel's source with step marks (``marked``): at each,
a barrier, then thread 0 adds the ``clock64()`` cycles since the last mark
to its block's sum for the step, so a step that runs once per tile or row
(a persistent grid) is summed over them. Prints one JSON line per case: the
mean cycles of each step over the blocks that ran (``cycles``, ``share``),
beside the case's time per launch from an unmarked copy (CUDA events behind
a device spin, median of three rounds) and whether its output equals the
plain version's.

``gate``: ``csrc/gram_gate.cu`` (or ``--source``, for example the kernel of
an earlier commit, compiled with the ``license_words.cuh`` beside it) on
[1024, 16384] batches of ``chip_smoke.py``'s seeded source text with
planted licenses. Steps: ``lut`` (the LUT into shared memory), ``stage``
(the row's LUT image), ``compact`` (word starts), ``hash`` (word hashes),
``lanes`` (zero the flags, copy the anchor table), ``search`` (gram keys and
anchor words against the tables), ``merge`` (flags out). Variants of a
source whose launch takes the prescreen bitset and the key directory:
``ldg`` (the kernel as it is: the bitset read through the read-only path),
``shared`` (a copy of the source that stages the bitset in shared memory
and reads it there, see ``screen_in_shared``), ``no_screen`` (a bitset with every bit set:
every gram key runs the search). A source without them runs as it is.

``score``: ``csrc/bytes_score.cu`` on ``chip_smoke.py``'s license rows at
every rung's dispatch shape and on gathered batches of 8 and 64 rows at
1024, 16384 and 49152, at the launch policy's cluster size. Steps (marked
after each cluster barrier and after the sort): ``scan`` (LUT, slice image,
the stretch scan), ``sums`` (word sums by start and end), ``hash``,
``keys`` (gram keys, bucket counts), ``push`` (keys into buckets), ``sort``,
``distinct``, ``find`` (lookups, the compacted list), ``sum`` (the credit
columns).

``bytes-gate`` and ``decompress``: ``csrc/bytes_gate.cu`` and
``csrc/decompress.cu``, or each ``--source`` given (the kernel of an earlier
commit, whose launch has the earlier signature, is recognised by the
missing set-up function, ``VERSION_MARKERS``), all in one process on the
same inputs. ``bytes-gate`` runs the license rows of every rung of
the classifier's ladder and, at 16384, rows of source text, and reports
the work one dispatch puts on the stream (``chip_smoke.py``'s
``work_per_call``). Steps of the
earlier kernel: ``tables`` (the LUT), ``stage`` (the block's LUT image),
``hash`` (windows, bitset reads, warp sums), ``partials`` (block count and
row atomics); its time per dispatch includes the two fills its wrapper
launched before it. Steps of the redesign: ``tables`` (the LUT and screens,
waited for apart in the marked copy), ``stage`` (the tile's copies landing),
``hash`` (LUT image, windows, screens, bitset reads, warp sums), ``rows``
(row counts and partials), ``ticket`` (the last block's sums of split
rows). Variants of the redesign: bloom4's screen at 2^15 and 2^17 bits and
bloom8's at 2^18 and 2^19 bits (launch arguments); and, with the package's
screens, copies of the source: ``no_screen8`` reads bloom8's bitset for
every window (``no_screen8``), ``ldg`` reads the screens from device
memory with ``__ldg`` instead of staging them (``screens_via_ldg``),
``narrow`` has blocks of 256 threads (``narrow_blocks``). ``decompress`` runs frames
the codec encodes from seeded text (PACK7 rows), the checkout's source
(RAW and TOKEN), zero rows (TOKEN), random bytes (RAW) and a mix; its
steps are split by mode: ``zero``, ``pack7``, ``raw`` and the TOKEN steps
``token_sum``, ``token_scan``, ``token_expand``, ``token_write``, beside
``stage`` (the earlier kernel's byte staging) or ``tables``, ``issue`` and
``wait`` (the redesign's).

``verscmp``: ``csrc/verscmp.cu``, or each ``--source`` given (an earlier
commit's kernel, one warp per row, is recognised by its missing
``trivy_verscmp_plan``), all in one process on three inputs of
``chip_smoke.py``'s: ``cve`` (the dispatch of a ``scan_sbom`` of the cve
SBOM against its DB, [536800, 16] with 500 bound rows, captured on the
CPU), ``distinct`` (the same inst rows, indices and ops against 212,000
distinct bound rows, ``distinct_bounds``) and ``wide`` (the same inst
indices and ops over seeded rows of 72 columns, each row against one of
four bound rows made from its inst row, which first differ from it at a
seeded column, uniform over the row, or not at all). Each is timed warm
(``time_ms``) and with a cold L2 (``chip_smoke.py``'s ``time_cold``).
Steps of the redesign, once per step of its persistent loop: ``index``
(indices and ops loaded), ``rows`` (the row loads landed), ``compare``,
``store``; of the earlier kernel: ``index`` and ``rows`` (its chunk loop,
loads and ballots interleaved; its one-byte store runs on lane 0 alone and
is no step). The marked copies hold each step's registers in a use before
the mark's barrier, so that the barrier waits for their loads. Variants of
the redesign: ``as_is`` (U = 4 rows a group, groups of up to 8 lanes),
``u2`` (``rows_per_group``), ``g32`` (groups of up to 32 lanes: a row of
up to 128 columns in one chunk, ``max_group``) and ``shared``: the bound
matrix staged in shared memory when it fits in 200 KB (``bounds_in_shared``;
on the distinct input it does not, and the launch takes no shared
memory).

Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import random
import re
import runpy
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from trivy_tpu_torch import cli
from trivy_tpu_torch.db import VulnDB
from trivy_tpu_torch.licensing.classify import LicenseClassifier
from trivy_tpu_torch.licensing.fused import get_gate_fn
from trivy_tpu_torch.ops import _build
from trivy_tpu_torch.ops.bytes_gate import bytes_gate_plain
from trivy_tpu_torch.ops.bytes_gate_cuda import SCREEN4_BITS, SCREEN8_BITS, fold
from trivy_tpu_torch.ops.bytes_score import bytes_score_plain, effective_cap
from trivy_tpu_torch.ops.bytes_score_cuda import cluster_size
from trivy_tpu_torch.ops.decompress import decompress_plain
from trivy_tpu_torch.ops.gram_gate import gram_gate_plain
from trivy_tpu_torch.ops.ngram_score import BYTES_WIDTHS, DeviceBytesScorer
from trivy_tpu_torch.ops.verscmp import check_ops_gather_plain
from trivy_tpu_torch.secret.compress import SlabCodec

REPO = Path(__file__).resolve().parents[1]
GATE_STEPS = ("lut", "stage", "compact", "hash", "lanes", "search", "merge")
SCORE_STEPS = ("scan", "sums", "hash", "keys", "push", "sort", "distinct", "find", "sum")
MAX_STAMPS = 16
MAX_BLOCKS = 4096
SPIN_CYCLES = 200_000_000  # about 0.1 s of the card's clock ahead of each round
# a mark of ``marked``: the step's cycles since the last mark, summed per
# block in thread 0's registers, and the kernel's prelude and flush
MARK = ("{ __syncthreads(); if (threadIdx.x == 0) { const long long trivy_t = clock64(); "
        "trivy_acc[%d] += trivy_t - trivy_last; trivy_last = trivy_t; } }")
MARK_PRELUDE = ("\n  const long long trivy_id = blockIdx.x + static_cast<long long>(gridDim.x) * "
                "blockIdx.y;\n  long long trivy_acc[%d] = {};\n  long long trivy_last = clock64();"
                "\n" % (MAX_STAMPS - 1))
FLUSH = ("{ if (threadIdx.x == 0 && trivy_id < %d) { for (int trivy_k = 0; trivy_k < %d; ++trivy_k) "
         "trivy_clk[trivy_id * %d + trivy_k] = trivy_acc[trivy_k]; trivy_clk[trivy_id * %d + %d] = "
         "1; } }" % (MAX_BLOCKS, MAX_STAMPS - 1, MAX_STAMPS, MAX_STAMPS, MAX_STAMPS - 1))
WAIT_ALL = ('asm volatile("cp.async.commit_group;\\n" ::: "memory"); '
            'asm volatile("cp.async.wait_group 0;\\n" ::: "memory");')
# (regex, step, code run before the mark's barrier): each regex is searched
# after the previous mark; an END step closes the kernel's body
END = "END"
# the gram gate: a mark after each barrier and after the word-start
# compaction, the last step closed by the body's end; the scorer: after each
# cluster barrier and after the radix sort (its tail is not a step)
GATE_MARKS = [(r"__syncthreads\(\);|compact_starts<[^;]*;", step, "") for step in GATE_STEPS[:-1]]
GATE_MARKS.append((END, GATE_STEPS[-1], ""))
SCORE_MARKS = [(r"cluster\.sync\(\);|radix_sort<T>\([^;]*;", step, "") for step in SCORE_STEPS]
BYTES_GATE_MARKS = {
    "old": [(r"__syncthreads\(\);", "tables", ""), (r"__syncthreads\(\);", "stage", ""),
            (r"__syncthreads\(\);", "hash", ""), (END, "partials", "")],
    "new": [(r"stage_words\(sm\.lut, lut, 256\);(\s*stage_words\([^;]*;)*", "tables", WAIT_ALL),
            (r"__syncthreads\(\);", "stage", ""), (r"__syncthreads\(\);", "hash", ""),
            (r"__syncthreads\(\);", "rows", ""), (END, "ticket", "")],
}
DECOMPRESS_MARKS = {
    "old": [(r"(?=return;)", "zero", ""), (r"__syncthreads\(\);", "stage", ""),
            (r"(?=return;)", "pack7", ""), (r"(?=return;)", "raw", ""),
            (r"__syncthreads\(\);", "token_sum", ""), (r"__syncthreads\(\);", "token_scan", ""),
            (r"__syncthreads\(\);", "token_expand", ""), (END, "token_write", "")],
    "new": [(r"cp_async16\(tb \+ 16 \* k, tab_bytes \+ 16 \* k\);\n  \}", "tables", WAIT_ALL),
            (r"if \(nx < B\) stage_row\([^;]*;", "issue", ""),
            (r"__syncthreads\(\);", "wait", ""),
            (r"(?=\} else if \(m == kModePack7\))", "zero", ""),
            (r"(?=\} else if \(m != kModeToken\))", "pack7", ""),
            (r"(?=\} else \{)", "raw", ""),
            (r"__syncthreads\(\);", "token_sum", ""), (r"__syncthreads\(\);", "token_scan", ""),
            (r"__syncthreads\(\);", "token_expand", ""),
            (r"(?=\}\n    __syncthreads\(\);  // this row)", "token_write", "")],
}
# the version-constraint kernel: the redesign's marks after each step's call,
# each holding the step's registers first; the earlier kernel's after its
# index clamps and after its chunk loop
HOLD = ("{ int trivy_z = 0; for (int trivy_u = 0; trivy_u < U; ++trivy_u) trivy_z |= %s; "
        "if (R < 0 && trivy_z == 1) trivy_clk[0] = 0; }")
VERSCMP_MARKS = {
    "old": [(r"bi = min\(max\(bi, 0\), n_bounds - 1\);", "index",
             "if (R < 0 && (ai ^ bi) == 1) trivy_clk[0] = 0;"),
            (r"(?=if \(lane != 0\) return;)", "rows", "if (R < 0 && s == 1) trivy_clk[0] = 0;")],
    "new": [(r"fetch_index<[^;]*;", "index", HOLD % "ai[trivy_u] ^ bi[trivy_u] ^ op[trivy_u]"),
            (r"fetch_rows<[^;]*;", "rows", HOLD % " ^ ".join(
                f"{side}[trivy_u].{c}" for side in ("ra", "rb") for c in "xyzw")),
            (r"compare_rows<[^;]*;", "compare", HOLD % "s[trivy_u]"),
            (r"store_rows<[^;]*;", "store", "")],
}
SHARED_BOUND_BYTES = 200 * 1024  # the bound matrix staged in shared memory up to this size
# a function only the redesigned source of each kernel exports
VERSION_MARKERS = {"bytes_gate": "trivy_bytes_gate_smem", "decompress": "trivy_decompress_grid",
                   "verscmp": "trivy_verscmp_plan"}
# the launch signatures of the kernels before their redesign
_P, _I = ctypes.c_void_p, ctypes.c_int
OLD_SIGNATURES = {
    # x, B, C, lut, bloom8, bloom4, blk, ah, nb, stream
    "trivy_bytes_gate_launch": (_I, [_P, _I, _I, _P, _P, _P, _P, _P, _P, _P]),
    # buf, W, offs, clen, mode, B, C, tab_bytes, tab_len, out, stream
    "trivy_decompress_launch": (_I, [_P, ctypes.c_longlong, _P, _P, _P, _I, _I, _P, _P, _P, _P]),
    # unchanged by the redesign
    "trivy_verscmp_launch": _build.SIGNATURES["verscmp"]["trivy_verscmp_launch"],
}


def kernel_body(src: str, kernel: str) -> tuple[int, int]:
    """Offsets of the opening and closing brace of ``kernel``'s body."""
    head = src.index(f"{kernel}(", src.index("__global__"))
    start = src.index("{", head)
    depth = 0
    for end in range(start, len(src)):
        depth += {"{": 1, "}": -1}.get(src[end], 0)
        if depth == 0:
            return start, end
    raise ValueError(f"{kernel}'s body does not close")


def marked(src: str, kernel: str, marks: list) -> str:
    """``src`` with step marks in the body of ``kernel``, for kernels whose
    steps run many times (a persistent grid): each mark, inserted after the
    first match of its regex past the previous mark (or at the body's end
    for ``END``), runs its code, a barrier, and has thread 0 add the cycles
    since the last mark to its step's sum in registers; the sums go to the
    device array at every ``return`` and at the body's end, with slot
    ``MAX_STAMPS - 1`` flagging the blocks that ran. Adds
    ``trivy_clocks(out, n)`` and ``trivy_clocks_reset()``. Raises when a
    regex is not found in order."""
    start, end = kernel_body(src, kernel)
    body = src[start + 1 : end]
    pos = 0
    tail = ""
    for k, (pattern, step, code) in enumerate(marks):
        stamp = f"{code} {MARK % k}"
        if pattern == END:
            tail = f"  {stamp}"
            continue
        m = re.compile(pattern).search(body, pos)
        if m is None:
            raise ValueError(f"{kernel} has no {pattern!r} for step {step!r} where expected")
        body = body[: m.end()] + stamp + body[m.end() :]
        pos = m.end() + len(stamp)
    body = re.sub(r"\breturn;", "{ " + FLUSH + " return; }", body)
    tail += f"  {FLUSH}\n"
    inc = src.index("#include <cuda_runtime.h>\n") + len("#include <cuda_runtime.h>\n")
    prelude = f"__device__ long long trivy_clk[{MAX_BLOCKS * MAX_STAMPS}];\n"
    getter = ('\nextern "C" int trivy_clocks(long long* out, int n) {\n'
              "  return static_cast<int>(cudaMemcpyFromSymbol(out, trivy_clk, n * 8));\n}\n"
              'extern "C" int trivy_clocks_reset() {\n  void* p = nullptr;\n'
              "  cudaError_t err = cudaGetSymbolAddress(&p, trivy_clk);\n"
              "  if (err == cudaSuccess) err = cudaMemset(p, 0, sizeof(trivy_clk));\n"
              "  return static_cast<int>(err);\n}\n")
    return (src[:inc] + prelude + src[inc : start + 1] + MARK_PRELUDE + body + tail
            + src[end:] + getter)


def screens_via_ldg(src: str) -> str:
    """The shingle gate's source reading its screens in device memory with
    ``__ldg`` in place of staging them in shared memory (which then holds
    no screen)."""
    edits = [
        ("  stage_words(sm.s4, screen4, s4_words);\n  stage_words(sm.s8, screen8, s8_words);\n",
         ""),
        ("const uint32_t* s4 = sm.s4;", "const uint32_t* s4 = screen4;"),
        ("const uint32_t* s8 = sm.s8;", "const uint32_t* s8 = screen8;"),
        ("return (s[b >> 5] >> (b & 31)) & 1u;", "return (__ldg(s + (b >> 5)) >> (b & 31)) & 1u;"),
        ("carve(reinterpret_cast<uint8_t*>(smem_raw), s4_words, s8_words)",
         "carve(reinterpret_cast<uint8_t*>(smem_raw), 0, 0)"),
        ("*smem = smem_bytes((1 << s4_bits) / 32, (1 << s8_bits) / 32);",
         "*smem = smem_bytes(0, 0);"),
    ]
    return edited(src, edits)


def no_screen8(src: str) -> str:
    """The shingle gate's source without bloom8's screen: every window
    that starts on a word byte reads bloom8's bitset (bloom4's screen
    stays)."""
    edits = [
        ("need8 |= static_cast<uint32_t>(screened(s8, h8[j], s8_bits)) << j;",
         "need8 |= 1u << j;"),
        ("  stage_words(sm.s8, screen8, s8_words);\n", ""),
        ("const int s8_words = (1 << s8_bits) / 32;", "const int s8_words = 0;"),
        ("*smem = smem_bytes((1 << s4_bits) / 32, (1 << s8_bits) / 32);",
         "*smem = smem_bytes((1 << s4_bits) / 32, 0);"),
    ]
    return edited(src, edits)


def edited(src: str, edits: list) -> str:
    """``src`` with each (old, new) replaced; raises unless each ``old``
    occurs exactly once."""
    for old, new in edits:
        if src.count(old) != 1:
            raise ValueError(f"the kernel's source no longer has one {old!r}")
        src = src.replace(old, new)
    return src


def narrow_blocks(src: str) -> str:
    """The shingle gate's source with blocks of 256 threads (4 KiB tiles):
    twice the blocks, so twice the tables staged per dispatch."""
    old = "constexpr int kThreads = 512;"
    if src.count(old) != 1:
        raise ValueError(f"the shingle gate's source no longer has one {old!r}")
    return src.replace(old, "constexpr int kThreads = 256;")


def screen_in_shared(src: str) -> str:
    """The gate's source with its prescreen bitset copied into shared memory
    after the LUT (one more 32 KiB region past the block's own) and read
    there, in place of the read-only path."""
    words = "(1 << (32 - kScreenShift)) / 32"
    edits = [
        ("__global__ void __launch_bounds__",
         "__device__ __forceinline__ bool screened_s(const uint32_t* s, uint32_t k) {\n"
         "  const uint32_t a = k >> kScreenShift, b = (k * kScreenMul) >> kScreenShift;\n"
         "  return (s[a >> 5] >> (a & 31)) & (s[b >> 5] >> (b & 31)) & 1u;\n}\n\n"
         "__global__ void __launch_bounds__"),
        ("H[k] = lut[k];\n",
         "H[k] = lut[k];\n  uint32_t* screen_s = reinterpret_cast<uint32_t*>("
         "base + align16(smem_bytes(C)));\n"
         f"  for (int k = threadIdx.x; k < {words}; k += kThreads) screen_s[k] = screen[k];\n"),
        ("screened(screen, k)", "screened_s(screen_s, k)"),
        ("const int smem = smem_bytes(C);", f"const int smem = align16(smem_bytes(C)) + 4 * ({words});"),
    ]
    for old, new in edits:
        if src.count(old) != 1:
            raise ValueError(f"the gate's source no longer has one {old!r}")
        src = src.replace(old, new)
    return src


def rows_per_group(src: str, U: int) -> str:
    """The version-constraint kernel's source with lane groups taking ``U``
    rows a step."""
    return edited(src, [("constexpr int kRowsPerGroup = 4;", f"constexpr int kRowsPerGroup = {U};")])


def max_group(src: str, G: int) -> str:
    """The version-constraint kernel's source with lane groups of up to
    ``G`` lanes (chunks of 4 G columns)."""
    return edited(src, [("constexpr int kMaxGroup = 8;", f"constexpr int kMaxGroup = {G};")])


def bounds_in_shared(src: str) -> str:
    """The version-constraint kernel's source staging the bound matrix in
    shared memory when the vector path runs and it fits in
    ``SHARED_BOUND_BYTES`` (each block copies it once, then reads bound rows
    there with generic loads); otherwise it launches as before, with none."""
    generic = (
        "// Columns col..col+3 of a row in shared or global memory (generic loads).\n"
        "template <bool kVec>\n"
        "__device__ __forceinline__ int4 load_cols_generic(const int32_t* row, int col, int L) {\n"
        "  if (kVec) {\n"
        "    return col < L ? *reinterpret_cast<const int4*>(row + col) : make_int4(0, 0, 0, 0);\n"
        "  }\n"
        "  int4 v;\n"
        "  v.x = col < L ? row[col] : 0;\n  v.y = col + 1 < L ? row[col + 1] : 0;\n"
        "  v.z = col + 2 < L ? row[col + 2] : 0;\n  v.w = col + 3 < L ? row[col + 3] : 0;\n"
        "  return v;\n}\n\n")
    stage = (
        "  extern __shared__ int4 trivy_sb[];  // the bound matrix, when the launch gave it room\n"
        "  uint32_t trivy_dyn;\n"
        '  asm volatile("mov.u32 %0, %%dynamic_smem_size;" : "=r"(trivy_dyn));\n'
        "  if (trivy_dyn) {\n"
        "    for (int k = threadIdx.x; k < n_bounds * L / 4; k += kThreads) {\n"
        "      trivy_sb[k] = __ldg(reinterpret_cast<const int4*>(bounds) + k);\n"
        "    }\n"
        "    __syncthreads();\n"
        "    bounds = reinterpret_cast<const int32_t*>(trivy_sb);\n"
        "  }\n")
    launch = (
        "const size_t trivy_bytes = static_cast<size_t>(n_bounds) * L * 4;\n"
        f"    const size_t smem = kVec && trivy_bytes <= {SHARED_BOUND_BYTES} ? trivy_bytes : 0;\n"
        "    if (smem > 48 * 1024 && cudaFuncSetAttribute(\n"
        "            verscmp_kernel<G, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,\n"
        "            static_cast<int>(smem)) != cudaSuccess) {\n"
        "      return static_cast<int>(cudaGetLastError());\n"
        "    }")
    loads = "rb[u] = load_cols<kVec>(bounds +"  # the first chunk's and the later chunks'
    if src.count(loads) != 2:
        raise ValueError(f"the kernel's source no longer has two {loads!r}")
    src = src.replace(loads, "rb[u] = load_cols_generic<kVec>(bounds +")
    return edited(src, [
        ("// The sign of the first of a lane's four columns", generic
         + "// The sign of the first of a lane's four columns"),
        ("  const int col = 4 * (lane % G);  // the lane's first column in each chunk\n",
         "  const int col = 4 * (lane % G);  // the lane's first column in each chunk\n" + stage),
        ("const size_t smem = 0;  // dynamic shared memory: none, the rows come through L1 and L2",
         launch),
    ])


def build(src: str, source: Path, out: Path) -> ctypes.CDLL:
    """Compile ``src`` (the text of a copy of ``source``) into ``out``."""
    cu = out.with_suffix(".cu")
    cu.write_text(src)
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I",
                           str(source.parent), "-o", str(out), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {cu}:\n{proc.stderr}")
    return ctypes.CDLL(str(out))


def marked_cycles(lib: ctypes.CDLL, steps: tuple) -> tuple[np.ndarray, int]:
    """Mean cycles of each step over the blocks that ran since the last
    ``trivy_clocks_reset()``, and how many ran."""
    clk = (ctypes.c_longlong * (MAX_BLOCKS * MAX_STAMPS))()
    if lib.trivy_clocks(clk, MAX_BLOCKS * MAX_STAMPS) != 0:
        raise RuntimeError("could not read the stamps")
    stamps = np.asarray(clk, np.int64).reshape(MAX_BLOCKS, MAX_STAMPS)
    ran = stamps[:, MAX_STAMPS - 1] == 1  # a block's flag, written with its sums
    return stamps[ran, : len(steps)].mean(axis=0), int(ran.sum())


def time_ms(run, args: list, reps: int = 8) -> float:
    """Device ms per ``run(a)`` over ``args`` behind a spin, median of three
    rounds."""
    run(args[0])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(3):
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(reps):
            for a in args:
                run(a)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / (reps * len(args)))
    return float(np.median(times))


def report(case: dict, steps: tuple, mean: np.ndarray) -> None:
    print(json.dumps({**case, "cycles": {s: float(c) for s, c in zip(steps, mean)},
                      "share": {s: float(c / mean.sum()) for s, c in zip(steps, mean)},
                      "card": torch.cuda.get_device_name(0)}), flush=True)


def gate_launcher(lib: ctypes.CDLL, with_screen: bool, gate, screen: torch.Tensor):
    """``fn((x, out))``: one launch of the library's gate on the card (a
    source without the prescreen takes neither ``screen`` nor ``dir``)."""
    fn = lib.trivy_gram_gate_launch
    fn.restype, argtypes = _build.SIGNATURES["gram_gate"]["trivy_gram_gate_launch"]
    fn.argtypes = argtypes if with_screen else argtypes[:9] + argtypes[11:]
    lut, g32, a32 = gate._k[:3]

    def run(xo) -> None:
        x, out = xo
        args = [x.data_ptr(), x.shape[0], x.shape[1], gate.block, lut.data_ptr(),
                g32.data_ptr(), g32.numel(), a32.data_ptr(), a32.numel()]
        args += [screen.data_ptr(), gate._k[4].data_ptr()] if with_screen else []
        args += [gate.p1, gate.p2, gate.hash_p, gate.ngram, out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream]
        if fn(*args) != 0:
            raise RuntimeError("gram gate launch failed")

    return run


def study_gate(smoke: dict, source: Path, batches: int, seed: int) -> None:
    C, B = smoke["CHUNK_LEN"], smoke["BATCH"]
    base = np.frombuffer(smoke["text_base"](random.Random(seed), 1 << 20), np.uint8)
    rng = random.Random(seed + 4)
    xs = [torch.from_numpy(smoke["gate_rows"](rng, base, B)).cuda() for _ in range(batches)]
    gate = get_gate_fn(C, "cuda")
    src = source.read_text()
    with_screen = "screen" in src[src.index("trivy_gram_gate_launch("):]
    variants = {"ldg": (src, gate._k[3]), "shared": (screen_in_shared(src), gate._k[3]),
                "no_screen": (src, torch.full_like(gate._k[3], -1))} if with_screen else {
        "as_is": (src, None)}
    want = [gram_gate_plain(x, gate.lut, gate.gate, gate.anchor, gate.p1, gate.p2, gate.hash_p,
                            gate.block, gate.ngram) for x in xs]
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(2 * len(variants)) as pool:
        jobs = {(name, kind): pool.submit(
                    build, marked(text, "gram_gate_kernel", GATE_MARKS) if kind == "marked"
                    else text, source, Path(tmp) / f"{name}_{kind}.so")
                for name, (text, _) in variants.items() for kind in ("marked", "plain")}
        for name, (_, screen) in variants.items():
            run = gate_launcher(jobs[name, "plain"].result(), with_screen, gate, screen)
            pairs = [(x, torch.zeros_like(w)) for x, w in zip(xs, want)]
            for xo in pairs:
                run(xo)
            torch.cuda.synchronize()
            equal = all(torch.equal(o, w) for (_, o), w in zip(pairs, want))
            ms = time_ms(run, pairs)
            lib = jobs[name, "marked"].result()
            mean, _ = run_marked(lib, gate_launcher(lib, with_screen, gate, screen),
                                 [(x, torch.zeros_like(want[0])) for x in xs], GATE_STEPS)
            report({"kernel": "gram_gate", "source": str(source), "variant": name, "ms": ms,
                    "equal_plain": equal}, GATE_STEPS, mean)


def study_score(smoke: dict, seed: int) -> None:
    source = _build.CSRC / "bytes_score.cu"
    src = source.read_text()
    stamps = marked(src, "bytes_score_kernel", SCORE_MARKS)
    base = smoke["text_base"](random.Random(seed), 1 << 20)
    rng = random.Random(seed + 5)
    scorer = LicenseClassifier(device="cuda")._device_scorer()
    sc = scorer._score
    lut, keys, kdir = sc._k
    ls = sc.credit.shape[1] // 2
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(2) as pool:
        libs = dict(zip(("marked", "plain"), pool.map(
            lambda kv: build(kv[1], source, Path(tmp) / f"{kv[0]}.so"),
            (("marked", stamps), ("plain", src)))))
        for lib in libs.values():
            for fn, (restype, argtypes) in _build.SIGNATURES["bytes_score"].items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
        for width in BYTES_WIDTHS:
            R = scorer.rows_per_dispatch(width)
            x = torch.from_numpy(smoke["license_rows"](rng, base, width, R)).cuda()
            cap = effective_cap(scorer.gram_cap(width), width)
            S = cluster_size(width)
            for B in (R, 8, 64) if width in smoke["GATHER_WIDTHS"] else (R,):
                rows = x if B == R else scorer.take_rows(x, np.arange(min(B, R)), B)
                out = (torch.empty((B, ls), device="cuda"), torch.empty((B, ls), device="cuda"),
                       torch.empty(B, dtype=torch.int32, device="cuda"))
                scratch = torch.empty(B * 2 * (width // 2 + 1), dtype=torch.int32, device="cuda")

                def run(lib, rows=rows, out=out, scratch=scratch, B=B, S=S, width=width, cap=cap):
                    plan = (ctypes.c_int * 4)()
                    rc = lib.trivy_bytes_score_plan(width, S, plan) or lib.trivy_bytes_score_launch(
                        rows.data_ptr(), B, width, S, lut.data_ptr(), keys.data_ptr(),
                        kdir.data_ptr(), sc.credit.data_ptr(), ls, cap, sc.p1, sc.p2, sc.hash_p,
                        sc.ngram, *(t.data_ptr() for t in out), scratch.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
                    if rc != 0:
                        raise RuntimeError(f"bytes score launch failed ({rc})")

                mean, _ = run_marked(libs["marked"], run, [libs["marked"]], SCORE_STEPS)
                want = bytes_score_plain(rows, sc.lut, sc.keys, sc.credit, sc.p1, sc.p2,
                                         sc.hash_p, cap, sc.ngram)
                run(libs["plain"])
                torch.cuda.synchronize()
                equal = (torch.equal(out[2], want[2]) and torch.equal(out[1], want[1])
                         and torch.allclose(out[0], want[0], rtol=1e-5, atol=0))
                ms = time_ms(lambda _: run(libs["plain"]), [None])
                report({"kernel": "bytes_score", "shape": [B, width], "cluster": S, "ms": ms,
                        "within_tol_plain": equal}, SCORE_STEPS, mean)


def version(src: str, kernel: str) -> str:
    """``new`` for a redesigned source (it exports its
    ``VERSION_MARKERS`` function), else ``old``."""
    return "new" if VERSION_MARKERS[kernel] in src else "old"


def load(src: str, source: Path, out: Path, kernel: str) -> ctypes.CDLL:
    """``build``, with the C signatures of the source's version declared."""
    lib = build(src, source, out)
    sigs = (_build.SIGNATURES[kernel] if version(src, kernel) == "new" else
            {f"trivy_{kernel}_launch": OLD_SIGNATURES[f"trivy_{kernel}_launch"]})
    for fn, (restype, argtypes) in sigs.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


def bytes_gate_runner(lib: ctypes.CDLL, src: str, gate, s4_bits: int = SCREEN4_BITS,
                      s8_bits: int = SCREEN8_BITS):
    """``fn(rows) -> (blk, ah, nb)``: one dispatch of the library's shingle
    gate as its wrapper makes it (the earlier kernel: two fills and the
    launch), with ``gate``'s tables and, for a redesign, screens of
    2^s4_bits bits for bloom4 and 2^s8_bits for bloom8."""
    lut, b8, b4 = gate._k[:3]
    if version(src, "bytes_gate") == "old":
        def run(x):
            B, C = x.shape
            blk = torch.empty((B, C // 512), dtype=torch.int32, device=x.device)
            ah = torch.zeros(B, dtype=torch.int32, device=x.device)
            nb = torch.zeros(B, dtype=torch.int32, device=x.device)
            if lib.trivy_bytes_gate_launch(x.data_ptr(), B, C, lut.data_ptr(), b8.data_ptr(),
                                           b4.data_ptr(), blk.data_ptr(), ah.data_ptr(),
                                           nb.data_ptr(), torch.cuda.current_stream().cuda_stream):
                raise RuntimeError("bytes gate launch failed")
            return blk, ah, nb
        return run
    s4, s8 = (torch.from_numpy(fold(bloom.cpu().numpy(), bits).view(np.int32)).cuda()
              for bloom, bits in ((gate.bloom4, s4_bits), (gate.bloom8, s8_bits)))
    smem = ctypes.c_int()
    if lib.trivy_bytes_gate_smem(s4_bits, s8_bits, smem) != 0:
        raise RuntimeError("bytes gate set-up failed")
    scratch = {}

    def run(x):
        B, C = x.shape
        blk = torch.empty((B, C // 512), dtype=torch.int32, device=x.device)
        ah = torch.empty(B, dtype=torch.int32, device=x.device)
        nb = torch.empty(B, dtype=torch.int32, device=x.device)
        if not scratch or scratch["part"].numel() < 2 * blk.numel():
            scratch["part"] = torch.empty(2 * blk.numel(), dtype=torch.int32, device=x.device)
            scratch.setdefault("ticket", torch.zeros(1, dtype=torch.int32, device=x.device))
        if lib.trivy_bytes_gate_launch(
                x.data_ptr(), B, C, lut.data_ptr(), b8.data_ptr(), b4.data_ptr(), s4.data_ptr(),
                s4_bits, s8.data_ptr(), s8_bits, blk.data_ptr(), ah.data_ptr(), nb.data_ptr(),
                scratch["part"].data_ptr(), scratch["ticket"].data_ptr(), smem.value,
                torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("bytes gate launch failed")
        return blk, ah, nb
    return run


def decompress_runner(lib: ctypes.CDLL, src: str, fn):
    """``run(frame) -> [B, C]``: one launch of the library's decompressor
    with the tables of ``fn`` (a ``CudaDecompressor``)."""
    C = fn.chunk_len
    new = version(src, "decompress") == "new"
    grid, smem = ctypes.c_int(), ctypes.c_int()
    if new and lib.trivy_decompress_grid(C, grid, smem) != 0:
        raise RuntimeError("decompress grid query failed")

    def run(frame):
        buf, offs, clen, mode = frame
        B = offs.shape[0]
        out = torch.empty((B, C), dtype=torch.uint8, device=buf.device)
        args = [buf.data_ptr(), buf.numel(), offs.data_ptr(), clen.data_ptr(), mode.data_ptr(), B,
                C, fn.tab_bytes.data_ptr(), fn.tab_len.data_ptr(), out.data_ptr()]
        args += [grid.value, smem.value] if new else []
        if lib.trivy_decompress_launch(*args, torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("decompress launch failed")
        return out
    return run


def run_marked(lib: ctypes.CDLL, run, inputs: list, steps: tuple) -> tuple[np.ndarray, int]:
    """Step cycles of ``run`` over ``inputs`` with a marked library: the
    mean over inputs of the per-block means."""
    cycles, blocks = [], 0
    for a in inputs:
        torch.cuda.synchronize()
        if lib.trivy_clocks_reset() != 0:
            raise RuntimeError("could not reset the stamps")
        run(a)
        torch.cuda.synchronize()
        mean, blocks = marked_cycles(lib, steps)
        cycles.append(mean)
    return np.mean(cycles, axis=0), blocks


def study_bytes_gate(smoke: dict, sources: list, seed: int) -> None:
    rng = random.Random(seed + 6)
    base = smoke["text_base"](random.Random(seed), 1 << 20)
    gate = LicenseClassifier(device="cuda")._device_scorer()._gate
    cases = []
    for width in BYTES_WIDTHS:
        R = DeviceBytesScorer.rows_per_dispatch(width)
        cases.append((f"license_{width}", [torch.from_numpy(smoke["license_rows"](
            rng, base, width, R)).cuda() for _ in range(4)]))
    base_np = np.frombuffer(base, np.uint8)
    R = DeviceBytesScorer.rows_per_dispatch(16384)
    cases.append(("source_16384", [torch.from_numpy(base_np[np.asarray(
        [rng.randrange(0, len(base_np) - 16384) for _ in range(R)])[:, None]
        + np.arange(16384)]).cuda() for _ in range(4)]))
    want = {name: [bytes_gate_plain(x, gate.lut, gate.bloom8, gate.bloom4) for x in xs]
            for name, xs in cases}
    jobs = []
    for source in sources:
        src = source.read_text()
        ver = version(src, "bytes_gate")
        texts = ({"shared": src, "no_screen8": no_screen8(src), "ldg": screens_via_ldg(src),
                  "narrow": narrow_blocks(src)} if ver == "new" else {"as_is": src})
        bits = {"shared": ((15, 18), (17, 18), (15, 19))}
        for name, text in texts.items():
            default = (SCREEN4_BITS, SCREEN8_BITS) if ver == "new" else (None, None)
            for pair in bits.get(name, (default,)):
                jobs.append((source, ver, name, text, pair))
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(8) as pool:
        libs = {}
        for i, (source, ver, name, text, _) in enumerate(jobs):
            key = (str(source), name)
            if key not in libs:
                libs[key] = (pool.submit(load, text, source, Path(tmp) / f"g{i}.so", "bytes_gate"),
                             pool.submit(load, marked(text, "bytes_gate_kernel",
                                                      BYTES_GATE_MARKS[ver]),
                                         source, Path(tmp) / f"g{i}m.so", "bytes_gate"))
        for source, ver, name, text, (s4, s8) in jobs:
            plain_lib, marked_lib = (f.result() for f in libs[str(source), name])
            run = bytes_gate_runner(plain_lib, text, gate, s4, s8)
            mrun = bytes_gate_runner(marked_lib, text, gate, s4, s8)
            steps = tuple(step for _, step, _ in BYTES_GATE_MARKS[ver])
            for case, xs in cases:
                equal = all(all(torch.equal(a, b) for a, b in zip(run(x), w))
                            for x, w in zip(xs, want[case]))
                ms = time_ms(run, xs)
                mean, blocks = run_marked(marked_lib, mrun, xs, steps)
                report({"kernel": "bytes_gate", "source": str(source), "version": ver,
                        "variant": name, "screen4_bits": s4, "screen8_bits": s8, "case": case,
                        "shape": list(xs[0].shape), "ms": ms,
                        "work_per_call": smoke["work_per_call"](run, xs[:2]),
                        "blocks": blocks, "equal_plain": equal}, steps, mean)


def study_decompress(smoke: dict, sources: list, seed: int) -> None:
    rng = np.random.default_rng(seed + 7)
    C, B = smoke["CHUNK_LEN"], smoke["BATCH"]
    base = np.frombuffer(smoke["text_base"](random.Random(seed), 1 << 20), np.uint8)
    source_text = smoke["repo_source"]()
    codec = SlabCodec(C)
    fn = smoke["build_decompress_fn"](C, codec.tab_bytes, codec.tab_len, "cuda")
    cases = []
    for kind in ("text", "source", "zero", "random", "mix"):
        frames = []
        for _ in range(2):
            rows = smoke["kind_rows"](kind, rng, source_text if kind == "source" else base, B)
            cs = smoke["encode"](codec, rows, B)[0]
            frames.append(tuple(torch.from_numpy(a).cuda() for a in cs.arrays()))
        cases.append((kind, frames))
    want = {kind: [decompress_plain(fn.tab_bytes, fn.tab_len, *f, C) for f in frames]
            for kind, frames in cases}
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(8) as pool:
        texts = [(source, source.read_text()) for source in sources]
        libs = [(pool.submit(load, text, source, Path(tmp) / f"d{i}.so", "decompress"),
                 pool.submit(load, marked(text, "decompress_kernel",
                                          DECOMPRESS_MARKS[version(text, "decompress")]),
                             source, Path(tmp) / f"d{i}m.so", "decompress"))
                for i, (source, text) in enumerate(texts)]
        for (source, text), (plain_f, marked_f) in zip(texts, libs):
            ver = version(text, "decompress")
            run = decompress_runner(plain_f.result(), text, fn)
            mrun = decompress_runner(marked_f.result(), text, fn)
            steps = tuple(step for _, step, _ in DECOMPRESS_MARKS[ver])
            for kind, frames in cases:
                equal = all(torch.equal(run(f), w) for f, w in zip(frames, want[kind]))
                ms = time_ms(run, frames)
                mean, blocks = run_marked(marked_f.result(), mrun, frames, steps)
                report({"kernel": "decompress", "source": str(source), "version": ver,
                        "input": kind, "shape": [B, C], "ms": ms, "blocks": blocks,
                        "modes": np.bincount(frames[0][3].cpu().numpy(), minlength=3).tolist(),
                        "equal_plain": equal}, steps, mean)


def verscmp_cases(smoke: dict, seed: int) -> list:
    """(name, (inst, bounds, a_idx, b_idx, ops) on the card) of the three
    inputs: the cve dispatch (captured from a CPU scan of the cve SBOM),
    the same against distinct bounds, and the same indices over 72-column
    rows."""
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        smoke["write_cve_db"](root / "db")
        smoke["write_cve_sbom"](root / "bom.json", seed)
        with smoke["captured_dispatches"]() as captured:
            cli.scan_sbom(str(root / "bom.json"), db=VulnDB.load(str(root / "db")), device="cpu")
    inst, bounds, a_idx, b_idx, ops = captured[0]
    R, L = len(ops), inst.shape[1]
    if R % 8:  # the earlier kernel's marked copy: no warp may leave its block early
        raise ValueError(f"the cve dispatch has {R} rows, not a multiple of 8")
    # wide: four bound rows per inst row, each equal to it up to a seeded
    # column (uniform over 0..79: past the row's end, equal), row r against
    # one of its inst row's four
    rng = np.random.default_rng(seed)
    wide_inst = rng.integers(0, 3, (len(inst), 72), dtype=np.int32)
    wide_bounds = np.repeat(wide_inst, 4, axis=0)
    first = rng.integers(0, 80, len(wide_bounds))
    k = np.nonzero(first < 72)[0]
    wide_bounds[k, first[k]] = (wide_bounds[k, first[k]] + rng.integers(1, 3, len(k))) % 3
    wide_idx = (4 * a_idx + np.arange(R) % 4).astype(np.int32)
    cases = [("cve", (inst, bounds.numpy(), a_idx, b_idx, ops)),
             ("distinct", (inst, smoke["distinct_bounds"](seed, L), a_idx,
                           smoke["distinct_index"](R, seed), ops)),
             ("wide", (wide_inst, wide_bounds, a_idx, wide_idx, ops))]
    return [(name, tuple(torch.from_numpy(np.ascontiguousarray(x)).cuda() for x in arrays))
            for name, arrays in cases]


def verscmp_runner(lib: ctypes.CDLL):
    """``run((inst, bounds, a_idx, b_idx, ops)) -> verdicts``: one launch of
    the library's kernel."""
    def run(args):
        inst, bounds, a_idx, b_idx, ops = args
        out = torch.empty(len(ops), dtype=torch.bool, device=inst.device)
        if lib.trivy_verscmp_launch(inst.data_ptr(), inst.shape[0], bounds.data_ptr(),
                                    bounds.shape[0], inst.shape[1], a_idx.data_ptr(),
                                    b_idx.data_ptr(), ops.data_ptr(), len(ops), out.data_ptr(),
                                    None, torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("verscmp launch failed")
        return out
    return run


def study_verscmp(smoke: dict, sources: list, seed: int) -> None:
    cases = verscmp_cases(smoke, seed)
    want = {name: check_ops_gather_plain(*args) for name, args in cases}
    jobs = []
    for source in sources:
        src = source.read_text()
        ver = version(src, "verscmp")
        texts = ({"as_is": src, "u2": rows_per_group(src, 2), "g32": max_group(src, 32),
                  "shared": bounds_in_shared(src)} if ver == "new" else {"as_is": src})
        jobs += [(source, ver, name, text) for name, text in texts.items()]
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(8) as pool:
        libs = [(pool.submit(load, text, source, Path(tmp) / f"v{i}.so", "verscmp"),
                 pool.submit(load, marked(text, "verscmp_kernel", VERSCMP_MARKS[ver]), source,
                             Path(tmp) / f"v{i}m.so", "verscmp"))
                for i, (source, ver, _, text) in enumerate(jobs)]
        for (source, ver, name, _), (plain_f, marked_f) in zip(jobs, libs):
            run, mrun = verscmp_runner(plain_f.result()), verscmp_runner(marked_f.result())
            steps = tuple(step for _, step, _ in VERSCMP_MARKS[ver])
            for case, args in cases:
                equal = torch.equal(run(args), want[case])
                ms = time_ms(run, [args])
                ms_cold = smoke["time_cold"](run, [args])[0]
                mean, blocks = run_marked(marked_f.result(), mrun, [args], steps)
                inst, bounds, a_idx, b_idx, ops = args
                report({"kernel": "verscmp", "source": str(source), "version": ver,
                        "variant": name, "case": case, "shape": [len(ops), inst.shape[1]],
                        "bound_rows": bounds.shape[0], "ms": ms, "ms_cold": ms_cold,
                        "bound_ms": smoke["verscmp_bound_ms"](
                            len(ops), inst.shape[1], a_idx.cpu().numpy(), b_idx.cpu().numpy()),
                        "blocks": blocks, "equal_plain": equal}, steps, mean)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", choices=("gate", "score", "bytes-gate", "decompress", "verscmp"))
    ap.add_argument("--source", type=Path, action="append",
                    help="the kernel's source (gate, bytes-gate, decompress, verscmp; all but "
                         "gate take several); default: the package's")
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_study needs a CUDA card")
    smoke = runpy.run_path(str(REPO / "chip_smoke.py"))
    name = {"gate": "gram_gate", "bytes-gate": "bytes_gate"}.get(args.kernel, args.kernel)
    sources = args.source or [_build.CSRC / f"{name}.cu"]
    if args.kernel == "gate":
        study_gate(smoke, sources[-1], args.batches, args.seed)
    elif args.kernel == "score":
        study_score(smoke, args.seed)
    elif args.kernel == "bytes-gate":
        study_bytes_gate(smoke, sources, args.seed)
    elif args.kernel == "verscmp":
        study_verscmp(smoke, sources, args.seed)
    else:
        study_decompress(smoke, sources, args.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
