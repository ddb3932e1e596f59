"""Where the license kernels spend their time, step by step, on the card.

    python -m tools.kernel_study gate [--source PATH] [--batches 4] [--seed 0]
    python -m tools.kernel_study score [--seed 0]

(from the repository root). A development tool: nothing in the package
imports it.

Builds copies of a kernel's source with a ``clock64()`` stamp taken by
thread 0 of each block at the kernel's start, after each of its top-level
barriers and at its end, and prints one JSON line per case: the mean cycles
of each step over the blocks (``cycles``, ``share``), beside the case's time
per launch from an unstamped copy (CUDA events behind a device spin, median
of three rounds) and whether its output equals the plain version's.

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
1024, 16384 and 49152, at the launch policy's cluster size. Steps (stamped
after each cluster barrier and after the sort): ``scan`` (LUT, slice image,
the stretch scan), ``sums`` (word sums by start and end), ``hash``,
``keys`` (gram keys, bucket counts), ``push`` (keys into buckets), ``sort``,
``distinct``, ``find`` (lookups, the compacted list), ``sum`` (the credit
columns).

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

from trivy_tpu_torch.licensing.classify import LicenseClassifier
from trivy_tpu_torch.licensing.fused import get_gate_fn
from trivy_tpu_torch.ops import _build
from trivy_tpu_torch.ops.bytes_score import bytes_score_plain, effective_cap
from trivy_tpu_torch.ops.bytes_score_cuda import cluster_size
from trivy_tpu_torch.ops.gram_gate import gram_gate_plain
from trivy_tpu_torch.ops.ngram_score import BYTES_WIDTHS

REPO = Path(__file__).resolve().parents[1]
GATE_STEPS = ("lut", "stage", "compact", "hash", "lanes", "search", "merge")
SCORE_STEPS = ("scan", "sums", "hash", "keys", "push", "sort", "distinct", "find", "sum")
MAX_STAMPS = 16
MAX_BLOCKS = 4096
SPIN_CYCLES = 200_000_000  # about 0.1 s of the card's clock ahead of each round
STAMP = ("{ if (threadIdx.x == 0) trivy_clk[blockIdx.x * %d + trivy_step] = clock64(); "
         "++trivy_step; }" % MAX_STAMPS)


def stamped(src: str, kernel: str, barrier: str, after: str) -> str:
    """``src`` with clock stamps in the body of ``kernel``: at its start,
    after each ``barrier`` statement and each statement matching the regex
    ``after``, and at its end; plus ``trivy_clocks(out, n)``, which copies
    the first ``n`` stamps to the host."""
    head = src.index(f"{kernel}(", src.index("__global__"))
    start = src.index("{", head)
    depth, end = 0, start
    for end in range(start, len(src)):
        depth += {"{": 1, "}": -1}.get(src[end], 0)
        if depth == 0:
            break
    body = src[start + 1 : end].replace(barrier, f"{barrier} {STAMP}")
    body = re.sub(f"({after})", r"\1 __syncthreads(); " + STAMP, body)
    body = f"\n  int trivy_step = 0; {STAMP}{body}  __syncthreads(); {STAMP}\n"
    prelude = f"__device__ long long trivy_clk[{MAX_BLOCKS * MAX_STAMPS}];\n"
    inc = src.index('#include "license_words.cuh"')
    getter = ('\nextern "C" int trivy_clocks(long long* out, int n) {\n'
              "  return static_cast<int>(cudaMemcpyFromSymbol(out, trivy_clk, n * 8));\n}\n")
    return src[:inc] + prelude + src[inc : start + 1] + body + src[end:] + getter


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


def step_cycles(lib: ctypes.CDLL, blocks: int, steps: tuple) -> np.ndarray:
    """Mean cycles of each step over the first ``blocks`` blocks of the
    last stamped launch."""
    clk = (ctypes.c_longlong * (MAX_BLOCKS * MAX_STAMPS))()
    if lib.trivy_clocks(clk, MAX_BLOCKS * MAX_STAMPS) != 0:
        raise RuntimeError("could not read the stamps")
    stamps = np.asarray(clk, np.int64).reshape(MAX_BLOCKS, MAX_STAMPS)
    return np.diff(stamps[:blocks, : len(steps) + 1], axis=1).mean(axis=0)


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
                    build, stamped(text, "gram_gate_kernel", "__syncthreads();",
                                   r"compact_starts<[^;]*;") if kind == "stamped" else text,
                    source, Path(tmp) / f"{name}_{kind}.so")
                for name, (text, _) in variants.items() for kind in ("stamped", "plain")}
        for name, (_, screen) in variants.items():
            run = gate_launcher(jobs[name, "plain"].result(), with_screen, gate, screen)
            pairs = [(x, torch.zeros_like(w)) for x, w in zip(xs, want)]
            for xo in pairs:
                run(xo)
            torch.cuda.synchronize()
            equal = all(torch.equal(o, w) for (_, o), w in zip(pairs, want))
            ms = time_ms(run, pairs)
            lib = jobs[name, "stamped"].result()
            srun = gate_launcher(lib, with_screen, gate, screen)
            cycles = []
            for x in xs:
                srun((x, torch.zeros_like(want[0])))
                torch.cuda.synchronize()
                cycles.append(step_cycles(lib, B, GATE_STEPS))
            report({"kernel": "gram_gate", "source": str(source), "variant": name, "ms": ms,
                    "equal_plain": equal}, GATE_STEPS, np.mean(cycles, axis=0))


def study_score(smoke: dict, seed: int) -> None:
    source = _build.CSRC / "bytes_score.cu"
    src = source.read_text()
    marked = stamped(src, "bytes_score_kernel", "cluster.sync();", r"radix_sort<T>\([^;]*;")
    base = smoke["text_base"](random.Random(seed), 1 << 20)
    rng = random.Random(seed + 5)
    scorer = LicenseClassifier(device="cuda")._device_scorer()
    sc = scorer._score
    lut, keys, kdir = sc._k
    ls = sc.credit.shape[1] // 2
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(2) as pool:
        libs = dict(zip(("stamped", "plain"), pool.map(
            lambda kv: build(kv[1], source, Path(tmp) / f"{kv[0]}.so"),
            (("stamped", marked), ("plain", src)))))
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

                run(libs["stamped"])
                torch.cuda.synchronize()
                mean = step_cycles(libs["stamped"], B * S, SCORE_STEPS)
                want = bytes_score_plain(rows, sc.lut, sc.keys, sc.credit, sc.p1, sc.p2,
                                         sc.hash_p, cap, sc.ngram)
                run(libs["plain"])
                torch.cuda.synchronize()
                equal = (torch.equal(out[2], want[2]) and torch.equal(out[1], want[1])
                         and torch.allclose(out[0], want[0], rtol=1e-5, atol=0))
                ms = time_ms(lambda _: run(libs["plain"]), [None])
                report({"kernel": "bytes_score", "shape": [B, width], "cluster": S, "ms": ms,
                        "within_tol_plain": equal}, SCORE_STEPS, mean)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", choices=("gate", "score"))
    ap.add_argument("--source", type=Path, default=_build.CSRC / "gram_gate.cu",
                    help="the gram gate's source (gate only)")
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_study needs a CUDA card")
    smoke = runpy.run_path(str(REPO / "chip_smoke.py"))
    if args.kernel == "gate":
        study_gate(smoke, args.source, args.batches, args.seed)
    else:
        study_score(smoke, args.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
