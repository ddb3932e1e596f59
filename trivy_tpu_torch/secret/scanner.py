"""CUDA-backed secret scanner: device prefilter and matcher, exact host
confirmation.

Pipeline (the port of ``trivy_tpu/secret/tpu_scanner.py``):

  files → overlapping fixed-size rows (small files packed several to a
  row) → content-hash dedup (rows seen before resolve from the hit store,
  identical rows in flight coalesce, all-zero rows are gated) → ``[B, C]``
  batches in a pinned chunk arena → optionally compressed into a wire frame
  (``secret/compress.py``) → one asynchronous copy to the card → the
  decompress kernel (compressed frames only) → keyword prefilter kernel →
  anchored matcher kernel when the prefilter found a candidate for it →
  per-(file, rule) candidates → exact :class:`SecretScanner` restricted to
  those rules → findings identical to the CPU engine, emitted in input
  order.

With a :class:`~trivy_tpu_torch.licensing.fused.FusedLicenseGate` (``fs
--scanners secret,license``), the license gram gate runs on the same
resident rows as a fourth kernel, for batches that carry a file the license
analyzers want, and its per-block verdicts flag those files in the gate
(``_apply_lic``); each scanned byte crosses to the card once for both
scanners. Row verdicts of such scans carry the gate's verdict and live
under their own digest namespace (the ruleset fingerprint + ``:lic``), the
JAX package's.

Row overlap covers the compiled ruleset's widest device window, so every
device-checkable window lies inside some row. Host confirmation is
restricted to the flagged row windows only where a flagged row provably
bounds the match start (anchored lane, and keyword-lane rules whose keyword
sits inside every bounded match — ``_windowed_ids``); other rules rescan
the whole file on flag.

Dedup is sound because a row's verdict is a pure function of (row bytes,
compiled tables): every row digest is keyed with the ruleset fingerprint,
and path-dependent filtering happens later, on the host. Compression is
framing only: rows hash and resolve against their uncompressed bytes.

Threads, all scoped to one ``scan_files`` call: a feeder that consumes the
input, chunks, hashes and packs rows into arena slabs and compresses them;
``feed_streams`` transfer streams (the JAX package's ``_worker``), each on
its own CUDA stream on the card, that copy slabs to the device, queue the
kernels and keep up to ``inflight`` batches in flight before they fetch
the oldest and resolve its hits; a confirm pool; and, with ``--tune``, the
online :class:`~trivy_tpu_torch.tuning.TuningController`.

A failed batch walks the JAX package's ladder (``trivy_tpu/secret/
tpu_scanner.py``): an OOM-shaped error (``_is_oom``, PyTorch's "CUDA out of
memory" included) halves the batch, any other error re-dispatches it whole
up to ``BATCH_RETRIES`` times, a compressed batch being decoded to raw rows
on the host first; each retry owns a fresh bucket-padded copy, and the
source slab returns to the arena once. When a batch's retries run out the
scan degrades (``obs.degrade_or_raise``): every file with device work
outstanding, and the rest of the input, is scanned by the exact host engine
from the bytes the host holds, in input order, and the degrade is logged,
counted in ``ScanStats`` (``degraded``), in the trace (``secret.degraded``)
and in the health channel that sets the report's ``Degraded``
(``obs.note_scan_degraded``). The host rung is taken only on the CPU, and
only with ``host_fallback`` on: on ``cuda`` the exhausted ladder raises its
cause, so the card's work never ends on the host. A kernel fault
(``ops._build.kernel_fault``: a kernel that cannot build, load or launch, or
a CUDA error surfacing at a fetch) is never retried or degraded: it fails
the scan. An encoder exception ships the batch raw, with a warning. A retry
or a split stays on the stream whose batch failed; a degrade or a failure
drops every stream's window and returns its slabs.

Each thread re-enters the scan's trace context (``obs.activate``) and
records the JAX package's spans: the feeder ``secret.assemble``,
``secret.arena_wait``, ``secret.warm_hit`` and ``secret.compress``; the
streams ``secret.feed_wait``, ``secret.dispatch`` (the copy and the kernel
launches, which only enqueue), ``secret.decompress``, and the blocking
fetches ``secret.prefilter`` and ``secret.device_wait``, where the card's
time lands; the confirm pool ``secret.confirm``. With tracing on, the
per-rule and per-bucket profile fills too.
"""

from __future__ import annotations

import hashlib
import queue
import threading
import time
from collections import deque
from collections.abc import Iterable, Iterator
from concurrent.futures import Future, ThreadPoolExecutor
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field

import numpy as np
import torch

from trivy_tpu_torch import faults, log, obs
from trivy_tpu_torch.device import resolve
from trivy_tpu_torch.obs import recorder as flight
from trivy_tpu_torch.ops.decompress import build_decompress_fn
from trivy_tpu_torch.ops.gram_gate import LANE_ANCHOR, LANE_GRAM, LANE_NONASCII
from trivy_tpu_torch.ops._build import kernel_fault
from trivy_tpu_torch.ops.match_cuda import build_match_fn_cuda
from trivy_tpu_torch.ops.prefilter import build_prefilter_fn
from trivy_tpu_torch.parallel.mesh import DevicesUnavailable, StagedDispatch, local_devices
from trivy_tpu_torch.secret.compress import COMPRESS_MIN_RATIO, CompressedSlab, SlabCodec
from trivy_tpu_torch.secret.device_compile import CompiledRules, compile_rules
from trivy_tpu_torch.secret.engine import ScannerConfig, SecretScanner
from trivy_tpu_torch.secret.feed import ChunkArena, row_windows
from trivy_tpu_torch.secret.hitstore import DEFAULT_STORE_MB, HitStore
from trivy_tpu_torch.secret.rules import ascii_lower
from trivy_tpu_torch.tuning import (
    TuningConfig,
    TuningController,
    inflight_limit,
    resolve_tuning,
    stream_limit,
)
from trivy_tpu_torch.types import Secret

logger = log.logger("secret:device")

# Row length and rows per batch on an H100. At 16 MiB per batch the
# kernel's time on the card does not depend on the row length between 4 and
# 32 KiB (chip_smoke.py's shape phase; PERF.md has the numbers), so the row
# length is chosen for the host: 16 KiB rows keep the row overlap (widest
# device window + 1: 135 bytes for the built-in rules) under 1% of each row,
# and files of up to 16 KiB pack several to a row instead of padding one
# row each. 1024 rows make a 16 MiB batch, whose pinned host-to-device copy
# and two kernel launches take about a millisecond together: small beside
# the per-batch host work of packing and resolving 1024 rows, and the kernel
# grid of (16384 / 2048) x 1024 = 8192 blocks fills the 132 SMs many times.
CHUNK_LEN = 16384
BATCH = 1024
# dispatch-shape bucket ladder depth: B, B/2, B/4 (--secret-bucket-rungs)
BUCKET_RUNGS = 3
# transfer streams, and batches in flight per stream (--secret-streams,
# --secret-inflight), on the card and the CPU alike. chip_smoke.py's feed
# phase swept streams {1, 2, 4} x windows {1, 2, 3} on a 32 MiB cut of its
# e2e tree on an NVIDIA H100 80GB HBM3 at 700 W: every setting ran at 4.9 to
# 5.8 MB/s, a spread no wider than the spread between repeated runs, with
# the card busy 0.003% of each scan and its streams waiting on the feeder
# 60-82% of the time (PERF.md §6). The scan is the host's, so the default is
# the cheapest setting in that spread: one stream, double-buffered (the JAX
# package's window), the fewest pinned slabs
FEED_STREAMS = 1
FEED_INFLIGHT = 2
# assembled slabs queued between the feeder and the transfer streams
FEED_QUEUE_DEPTH = 2
# arena slack beyond the queue and the streams' windows: the slab being
# assembled, and the wire slab a compressed batch is encoded into while its
# source slab is still held
ARENA_MARGIN = 2
# workers for exact host confirmation
CONFIRM_WORKERS = 4
# entry-count backstop of the dedup LRU (the real bound is its byte budget)
HIT_CACHE_ENTRIES = 1 << 16
# version folded into the ruleset fingerprint that keys every row digest;
# the JAX package's value, so both packages' persisted verdicts share one
# namespace (v4: rows may reach the kernels through the decompressor, whose
# output is byte-identical to a raw upload; keys hash UNCOMPRESSED rows)
HIT_CACHE_VERSION = 4
# the license gate's lanes, each counted in ScanStats as license_rows_<name>
LIC_LANES = (("gram", LANE_GRAM), ("anchor", LANE_ANCHOR), ("nonascii", LANE_NONASCII))
# re-dispatches allowed per failed batch before the scan degrades (OOM-shaped
# splits don't consume this budget: halving shrinks the batch, so it ends on
# its own); the JAX package's value
BATCH_RETRIES = 2

# error shapes that mean "the batch was too big", answered by halving the
# batch instead of retrying it whole: the JAX package's spellings, which
# cover PyTorch's "CUDA out of memory" and the injected kind
_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "resource_exhausted", "out of memory",
                "Out of memory", "OOM")


def _is_oom(err: BaseException) -> bool:
    s = f"{type(err).__name__}: {err}"
    return any(m in s for m in _OOM_MARKERS)


class _DeviceFailed(Exception):
    """The device worker's retry ladder is exhausted; ``cause`` is the
    original device error."""

    def __init__(self, cause: BaseException):
        super().__init__(str(cause))
        self.cause = cause


def chunk_spans(n: int, chunk_len: int, overlap: int) -> list[int]:
    """Chunk start offsets covering ``n`` bytes with the given overlap."""
    if n <= chunk_len:
        return [0]
    step = chunk_len - overlap
    return list(range(0, n - overlap, step))


@dataclass
class _FileState:
    path: str
    data: bytes
    pending: int  # rows not yet resolved
    # candidate rule index -> row windows (byte spans) where it hit
    rules: dict[int, list[tuple[int, int]]] = field(default_factory=dict)
    # prefilter candidate rules over EVERY row of the file (None when the
    # ruleset has no prefilter keywords): guarded rules are confirmed only
    # when present here — the reference's whole-file MatchKeywords gate
    cand: set[int] | None = None
    # guarded anchored rules whose matcher was SKIPPED for >=1 row of this
    # file (its batch had no candidate): their windows may be incomplete,
    # so a candidate among them confirms by a full scan instead
    unchecked: set[int] = field(default_factory=set)


class ScanStats:
    """Cumulative feed and device counters (thread-safe). The link-traffic
    and dedup fields carry the names and meaning of the JAX package's
    ``ScanStats``: ``bytes_uploaded`` counts the bytes actually shipped to
    the card (padded raw slabs, or wire + framing of compressed batches);
    ``bytes_dedup_hit`` counts corpus bytes whose rows were served from the
    hit store or coalesced onto an identical in-flight row."""

    FIELDS = (
        "bytes_in",             # corpus bytes fed to the device path
        "rows",                 # rows dispatched (live, not bucket padding)
        "batches",              # batches dispatched
        "rows_packed",          # dispatched rows carrying >1 file
        "rows_prefilter_hit",   # rows with >=1 prefilter candidate
        "rows_nfa_skipped",     # rows whose batch skipped the anchored matcher
        "batches_nfa_skipped",  # batches resolved by the prefilter alone
        "batch_retries",        # failed batches re-dispatched whole
        "batch_splits",         # OOM-shaped failures answered by halving
        "degraded",             # scan runs that fell back to the exact host path
        "bytes_uploaded",       # bytes shipped to the card (see above)
        "bytes_dedup_hit",      # corpus bytes resolved without an upload
        "bytes_packed",         # corpus bytes sharing a row with another file
        "chunks",               # rows the corpus decomposed into
        "chunks_uploaded",      # rows actually dispatched
        "chunks_dedup_hit",     # rows served from the hit store / coalesced
        "files_packed",         # files that rode a shared row
        "chunks_warm_hit",      # rows served from the PERSISTENT store
        "bytes_warm_hit",       # corpus bytes those rows covered
        "bytes_compressed",     # wire + framing bytes of compressed batches
        "bytes_raw_equiv",      # padded raw bytes those batches replaced
        "bytes_raw_fallback",   # padded bytes shipped raw with the codec on
        "bytes_gated",          # corpus bytes the zero gate kept off the link
        "bytes_gated_binary",   # raw bytes of binary rows inside compressed frames
        "chunks_gated_zero",    # all-zero rows the zero gate resolved
        "batches_compressed",   # batches that shipped compressed
        "batches_raw_fallback",  # batches shipped raw with the codec on
        "license_rows_gated",    # rows the license gram gate read
        "license_rows_flagged",  # rows with a license candidate block
    )
    # the port's own counters, which the JAX package does not keep: the rows
    # each lane of the license gate flagged
    PORT_FIELDS = tuple(f"license_rows_{name}" for name, _ in LIC_LANES)

    def __init__(self, parent: "ScanStats | None" = None):
        self._lock = threading.Lock()
        self._v = dict.fromkeys(self.FIELDS + self.PORT_FIELDS, 0)
        # a scan run's own tallies also add to its scanner's totals
        self._parent = parent

    def add(self, **kw: int) -> None:
        with self._lock:
            for k, n in kw.items():
                self._v[k] += n
        if self._parent is not None:
            self._parent.add(**kw)

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self._v)


class TorchSecretScanner:
    """Equivalent of :class:`SecretScanner` batched over the card.

    ``scan_files`` consumes an iterable of (path, bytes) and yields one
    :class:`Secret` per input file, in input order, with findings identical
    to ``SecretScanner.scan_bytes``. ``device`` is ``cuda`` (the default;
    raises without CUDA) or ``cpu``, where every kernel runs its plain
    PyTorch version.

    ``dedup`` turns the row-digest hit store on (rows seen before resolve
    without an upload); ``hit_cache`` is a :mod:`trivy_tpu_torch.cache`
    backend that persists its verdicts across scans, and
    ``hit_cache_bytes`` bounds its in-process LRU (0: ``DEFAULT_STORE_MB``).
    ``compress`` is ``auto`` (the default: on for ``cuda``, off for
    ``cpu``), ``on`` or ``off``; with it on, batches cross to the card as
    compressed wire frames whenever they fit ``compress_min_ratio`` of the
    raw slab (0: ``COMPRESS_MIN_RATIO``), and all-zero rows are gated.
    ``host_fallback`` (default on) lets a scan on the CPU whose batch
    exhausted its ``BATCH_RETRIES`` finish on the exact host engine; off,
    or on ``cuda``, the device error is raised.

    The feed's knobs (0: from ``tuning``, a :class:`TuningConfig`, else
    the default): ``feed_streams`` transfer streams (``FEED_STREAMS``),
    each keeping up to ``inflight`` (``FEED_INFLIGHT``)
    batches in flight; ``arena_slabs`` slabs (derived from both);
    ``bucket_rungs`` rungs of the dispatch ladder; ``confirm_workers``
    threads of exact confirmation. ``pack_small`` off gives every small
    file a row of its own; ``prefilter`` off sends every batch through the
    anchored matcher with the keyword lane. With ``tuning.controller`` on
    and a ``tuning_interval`` above 0, each scan run starts the online
    :class:`~trivy_tpu_torch.tuning.TuningController`.

    Dispatch (``parallel/mesh.py::StagedDispatch``, the JAX package's
    meanings): ``dispatch`` ``auto`` (the default) sends whole batches
    round-robin over every CUDA device when the scan is on ``cuda`` and
    there is more than one, and never fans out on the CPU; ``round_robin``
    does so over ``devices`` (a list of devices, which may repeat one) on
    either; ``single`` keeps one device. Round-robin puts a per-device
    circuit breaker in the ladder (a retry lands on the next healthy device;
    with every device open the batch's files take the last rung) and
    defaults the transfer streams to one per device. ``mesh`` (a
    ``parallel.mesh.Mesh``) splits every batch's rows over its ``data`` axis
    instead and turns compression off (a warning when it was asked for).
    """

    def __init__(
        self,
        config: ScannerConfig | None = None,
        chunk_len: int | None = None,
        batch_size: int | None = None,
        device="cuda",
        dedup: bool = True,
        hit_cache=None,
        hit_cache_bytes: int = 0,
        compress: str = "",
        compress_min_ratio: float = 0.0,
        host_fallback: bool = True,
        pack_small: bool = True,
        prefilter: bool = True,
        feed_streams: int = 0,
        inflight: int = 0,
        arena_slabs: int = 0,
        bucket_rungs: int = 0,
        confirm_workers: int = 0,
        tuning: TuningConfig | None = None,
        dispatch: str = "auto",
        devices=None,
        mesh=None,
    ):
        self.device = mesh.first if mesh is not None else resolve(device)
        if dispatch not in ("auto", "single", "round_robin"):
            raise ValueError(f"dispatch={dispatch!r}: use 'auto', 'single', or 'round_robin'")
        rr_devices = None
        if mesh is None and dispatch != "single":
            if devices is not None:
                local = [resolve(d) for d in devices]
            else:
                local = local_devices() if self.device.type == "cuda" else [self.device]
            # 'auto' fans out only over several cards; the CPU's logical
            # devices share one memory bus, so only an explicit
            # 'round_robin' spreads over them
            if len(local) > 1 and (dispatch == "round_robin" or self.device.type == "cuda"):
                rr_devices = local
        self._staged = StagedDispatch(mesh=mesh, devices=rr_devices, device=self.device)
        self.dispatch = "mesh" if mesh is not None else (
            "round_robin" if rr_devices is not None else "single")
        # the knobs: an explicit argument, else the TuningConfig (the CLI
        # resolves one per run: flags, env, autotune record), else the
        # default; a library caller without one gets the environment's
        if tuning is None:
            tuning = resolve_tuning(autotune_path="")
        self.tuning = tuning
        self.feed_streams = max(1, feed_streams or tuning.feed_streams
                                or (len(rr_devices) if rr_devices else FEED_STREAMS))
        self.inflight = max(1, inflight or tuning.inflight or FEED_INFLIGHT)
        # 0: the run derives it from the streams and windows
        self.arena_slabs = max(0, arena_slabs or tuning.arena_slabs)
        self.bucket_rungs = max(1, bucket_rungs or tuning.bucket_rungs or BUCKET_RUNGS)
        self.confirm_workers = confirm_workers or CONFIRM_WORKERS
        self._pack_small = pack_small
        self._host_fallback = host_fallback
        self.exact = SecretScanner(config)
        self.compiled: CompiledRules = compile_rules(self.exact.rules)
        self.chunk_len = chunk_len or CHUNK_LEN
        self.batch_size = batch_size or BATCH
        self.overlap = max(64, self.compiled.span + 1)
        if self.overlap > self.chunk_len // 2:
            raise ValueError(
                f"chunk_len={self.chunk_len} too small for ruleset: the widest "
                f"device window needs overlap {self.overlap}; use chunk_len "
                f">= {2 * self.overlap}"
            )
        # the prefilter runs whenever some rule declares keywords, unless it
        # is turned off; the anchored matcher then drops its keyword lane
        self._prefilter = (build_prefilter_fn(self.compiled, self.chunk_len, self.device)
                           if prefilter else None)
        self._match = build_match_fn_cuda(
            self.compiled, self.chunk_len,
            include_keywords=self._prefilter is None, device=self.device,
            name="anchored",
        )
        # every device a batch may land on gets its own copy of the tables
        compiled, chunk, kw_lane = self.compiled, self.chunk_len, self._prefilter is None
        self._staged.add_stage("match", lambda d: build_match_fn_cuda(
            compiled, chunk, include_keywords=kw_lane, device=d, name="anchored"), self._match)
        if self._prefilter is not None:
            self._staged.add_stage("prefilter", lambda d: build_prefilter_fn(compiled, chunk, d),
                                   self._prefilter)
        # rule-axis index tables the batch gate and resolution read
        g = self.compiled.guarded
        anchored_idx = {i for i, _ in self.compiled.variants}
        self._kw_lane_cols = np.asarray(
            sorted({i for i, _ in self.compiled.keywords}), dtype=np.int64
        )
        self._guarded_anchored = frozenset(i for i in anchored_idx if g[i])
        self._guarded_anchored_cols = np.asarray(
            sorted(self._guarded_anchored), dtype=np.int64
        )
        # anchored rules with no keywords are never prefilter-gated: their
        # presence forces the anchored matcher on every batch
        self._has_unguarded_anchored = any(not g[i] for i in anchored_idx)
        self._guarded_ids = frozenset(
            self.compiled.rule_ids[i] for i in np.nonzero(g)[0]
        )
        # windowed confirmation is sound only when flagged rows bound the
        # match START: always on the anchored lane; on the keyword lane
        # only for bounded-width rules whose keyword provably sits inside
        # every match. Everything else full-scans on flag.
        anchored = set(self.compiled.anchored_rule_ids)
        self._windowed_ids = anchored | {
            r.id
            for r in self.exact.rules
            if r.id not in anchored
            and r.keywords
            and r.keyword_in_match
            and r.max_match_width is not None
            and r.max_match_width <= 8192
        }
        # dispatch-shape bucket ladder: a short trailing batch pads up to
        # the smallest rung that holds it
        min_bucket = max(8, self._staged.pad_to, self.batch_size // (1 << (self.bucket_rungs - 1)))
        buckets = [self.batch_size]
        while buckets[-1] // 2 >= min_bucket:
            buckets.append(buckets[-1] // 2)
        self._buckets = sorted(buckets)
        self.stats = ScanStats()
        # each dispatch target is busy from a batch's copy until its results
        # are fetched, whichever run (image layer) the batch belongs to
        self._busy = self._staged.busy
        # trace context -> scan runs in flight under it, for the probe
        self._runs_lock = threading.Lock()
        self._runs: dict = {}

        # -- dedup hit store ------------------------------------------------
        # ruleset fingerprint: the hit vector is a pure function of (row
        # bytes, compiled tables); keying the row hash with it makes any
        # rule add/remove/regex/keyword change, and any reordering (which
        # renumbers rule indices), flip every key. It folds the
        # --secret-config file's content digest (allow rules and disables
        # change findings, not hit vectors) and the prefilter table (cached
        # values carry its candidate masks). The recipe is the JAX
        # package's, byte for byte.
        fp = hashlib.blake2b(digest_size=16)
        fp.update(f"v{HIT_CACHE_VERSION}:{self.chunk_len}:".encode())
        for r in self.exact.rules:
            fp.update(repr((r.id, r.regex, r.keywords, r.path)).encode())
            fp.update(b"\x00")
        fp.update(b"cfg:")
        fp.update(getattr(config, "source_digest", "").encode() or b"-")
        if self._prefilter is not None:
            fp.update(b"pf:")
            fp.update(self.compiled.prefilter_fingerprint())
        else:
            fp.update(b"pf-off")
        self.ruleset_fingerprint = fp.digest()
        # the store maps a row digest to the row's verdict, the JAX
        # package's 4-tuple (hit_rules, cand_rules, nfa_ran, lic):
        # - hit_rules: device hit vector (anchored + keyword-lane hits)
        # - cand_rules: prefilter candidate rules; () without a prefilter
        # - nfa_ran: False when the row's batch skipped the anchored
        #   matcher; replaying it marks every guarded anchored rule
        #   unchecked for the row's file, so a candidate there confirms by
        #   a full scan
        # - lic: the fused license gate's verdict, a tuple of flagged
        #   block indices, or None when the row's batch did not run the
        #   gate (plain scans, or a batch with no file the gate wants)
        self._dedup = dedup
        self._hit_store = HitStore(
            self.ruleset_fingerprint,
            backend=hit_cache,
            max_entries=HIT_CACHE_ENTRIES,
            max_bytes=hit_cache_bytes or (tuning.dedup_store_mb or DEFAULT_STORE_MB) << 20,
        )

        # -- compressed slab wire format ------------------------------------
        # 'auto' is on where the rows cross a link to the card and off on
        # the CPU, where compressing only burns host cycles. An 'off'
        # scanner builds no codec tables and no decompressor.
        mode = compress or tuning.compress or "auto"
        if mode not in ("auto", "on", "off"):
            raise ValueError(f"compress={mode!r}: use 'auto', 'on', or 'off'")
        comp_on = mode == "on" or (mode == "auto" and self.device.type == "cuda")
        if comp_on and mesh is not None:
            if mode == "on":
                logger.warning("--secret-compress is unsupported under a sharded mesh (a flat "
                               "wire buffer has no row axis to shard); shipping raw slabs")
            comp_on = False
        if comp_on and self.chunk_len % 8:
            logger.warning(
                "compression needs chunk_len %% 8 == 0 (7-bit packing), got "
                "%d; shipping raw slabs", self.chunk_len,
            )
            comp_on = False
        self.compress_min_ratio = float(compress_min_ratio or tuning.compress_min_ratio
                                        or COMPRESS_MIN_RATIO)
        if not 0.0 < self.compress_min_ratio <= 1.0:
            raise ValueError(f"compress_min_ratio={self.compress_min_ratio} out of (0, 1]")
        self._codec: SlabCodec | None = None
        self._decompress = None
        # per rows-bucket wire-size ladder {top, top/2, top/4, top/8}: a
        # very compressible batch (zero pages, config trees) ships a small
        # rung instead of padding to the top
        self._wire_rungs: dict[int, list[int]] = {}
        if comp_on:
            self._codec = SlabCodec(self.chunk_len)
            tabs = (self._codec.tab_bytes, self._codec.tab_len)
            self._decompress = build_decompress_fn(self.chunk_len, *tabs, self.device)
            self._staged.add_stage("decompress",
                                   lambda d: build_decompress_fn(chunk, *tabs, d), self._decompress)
            for b in self._buckets:
                top = -(-int(b * self.chunk_len * self.compress_min_ratio) // 128) * 128
                rungs = [top]
                while len(rungs) < 4 and rungs[-1] // 2 >= 1024:
                    rungs.append(rungs[-1] // 2)
                self._wire_rungs[b] = sorted(rungs)
        self.compress_on = comp_on
        # the license gram gate, built by the first fused scan
        self._lic_lock = threading.Lock()
        self._lic_gate_fn = None
        self._lic_block = 0

    def _ensure_license_stage(self) -> None:
        """Build the license gram gate for this scanner's rows (once; the
        gate and its tables are process-cached per row shape and device, and
        a batch on another device of the dispatch gets that device's)."""
        with self._lic_lock:
            if self._lic_gate_fn is None:
                from trivy_tpu_torch.licensing.fused import get_gate_fn

                fn = get_gate_fn(self.chunk_len, self.device)
                self._lic_block = fn.block
                self._lic_gate_fn = fn
                self._staged.add_stage(
                    "license", lambda d: get_gate_fn(self.chunk_len, d), fn)

    def seed_hit_entries(self, entries: list) -> int:
        """Pre-warm the dedup store from a peer's export (a fleet shard's
        ``WarmHits``); returns the entries accepted. Entries of another
        fingerprint namespace are dropped with a warning by the store."""
        return self._hit_store.seed(entries)

    def export_warm_hits(self) -> list:
        """Warm dedup entries (``[[persist_key, doc], ...]``, at most the
        store's export limit) for a peer to seed from."""
        return self._hit_store.export_warm()

    def _alloc_slab(self, rows: int, row_len: int) -> np.ndarray:
        """Arena slab: pinned host memory on the card (one asynchronous
        copy per batch), plain memory on the CPU."""
        pin = self.device.type == "cuda"
        return torch.zeros((rows, row_len), dtype=torch.uint8, pin_memory=pin).numpy()

    def scan_files(self, files: Iterable[tuple[str, bytes]],
                   license_gate=None) -> Iterator[Secret]:
        """Scan many files; yields per-file results in input order.
        ``license_gate`` (a ``FusedLicenseGate``) runs the license gram gate
        on the same rows and collects its verdicts."""
        if license_gate is not None:
            self._ensure_license_stage()
        run = _ScanRun(self, files, obs.current(), license_gate)
        run.start()
        try:
            next_emit = 0
            while True:
                with run.cond:
                    while True:
                        if run.error is not None:
                            raise run.error
                        if next_emit in run.results:
                            r = run.results.pop(next_emit)
                            break
                        if run.total is not None and next_emit >= run.total:
                            return
                        run.cond.wait(0.2)
                yield r.result() if isinstance(r, Future) else r
                next_emit += 1
        finally:
            run.close()

    def scan_bytes(self, path: str, data: bytes) -> Secret:
        """Single-file convenience (still device-prefiltered)."""
        return next(iter(self.scan_files([(path, data)])))

    # -- device pass --------------------------------------------------------

    def _telemetry_probe(self) -> dict[str, float]:
        """The scanner's part of the telemetry (called only from the
        sampler's thread): its cumulative link bytes and the card's busy
        seconds, shared by every run in flight."""
        vals = {"secret.bytes_uploaded_total": float(self.stats.snapshot()["bytes_uploaded"])}
        vals.update(self._busy.probe())
        return vals

    def run_batch(self, rows: torch.Tensor, n_live: int) -> "_Fetch":
        """Launch the first kernel use on one resident batch and queue the
        copy of its output to the host: the prefilter, or without one the
        anchored matcher (``secret.dispatch``: the launch only enqueues on
        the current stream). Returns the batch's :class:`_Fetch`; its
        ``result()`` blocks on the copy and launches the matcher when the
        prefilter asks for it."""
        run = self._staged.run
        with obs.current().span("secret.dispatch"):
            if self._prefilter is None:
                return _Fetch(self, rows, n_live, None, _to_host(run("match", rows)))
            return _Fetch(self, rows, n_live, _to_host(run("prefilter", rows)), None)

    # -- host confirmation --------------------------------------------------

    def _confirm_inner(self, st: _FileState, prof=None) -> Secret:
        """The exact confirm of one file's flagged rules; ``prof`` (the
        scan's profile, tracing on) gains each rule's confirm time."""
        windows_by_id = {
            self.compiled.rule_ids[i]: w for i, w in st.rules.items()
        }
        host_ids = set(self.compiled.host_rule_ids)
        cand_ids: set[str] | None = None
        unchecked_ids: set[str] = set()
        extra_ids: set[str] = set()
        if st.cand is not None:
            rid = self.compiled.rule_ids
            cand_ids = {rid[i] for i in st.cand}
            unchecked_ids = {rid[i] for i in st.unchecked}
            # guarded anchored rules that are file-level candidates but
            # whose matcher was skipped for some row may have recorded no
            # window at all — they still need a (full-scan) confirmation
            extra_ids = (unchecked_ids & cand_ids) - set(windows_by_id)
        if not windows_by_id and not host_ids and not extra_ids:
            return Secret(file_path=st.path)
        content = st.data.decode("latin-1")
        lower = ascii_lower(content)
        global_blocks = self.exact.global_block_spans(content)
        hits = []
        for rule in self.exact.rules_for_path(st.path):
            if (
                cand_ids is not None
                and rule.id in self._guarded_ids
                and rule.id not in cand_ids
            ):
                # no keyword of this rule occurs anywhere in the file: the
                # exact engine's match_keywords would reject it
                continue
            t0 = time.perf_counter() if prof is not None else 0.0
            if rule.id in windows_by_id:
                if rule.id in unchecked_ids:
                    # some row of this file never ran the rule's anchored
                    # matcher: windows may be incomplete, so scan it all
                    locs = self.exact.find_rule_locations_fullscan(
                        rule, content, lower, global_blocks
                    )
                elif rule.id in self._windowed_ids:
                    locs = self.exact.find_rule_locations_in_windows(
                        rule, content, lower, windows_by_id[rule.id], global_blocks
                    )
                else:
                    # keyword lane without a start bound: the flagged row
                    # locates the keyword, not the match
                    locs = self.exact.find_rule_locations_fullscan(
                        rule, content, lower, global_blocks
                    )
            elif rule.id in extra_ids:
                locs = self.exact.find_rule_locations_fullscan(
                    rule, content, lower, global_blocks
                )
            elif rule.id in host_ids:
                locs = self.exact.find_rule_locations(
                    rule, content, lower, global_blocks
                )
            else:
                continue
            if prof is not None:
                prof.confirm(rule.id, time.perf_counter() - t0, len(locs))
            hits.extend((rule, loc) for loc in locs)
        return self.exact.build_findings(st.path, content, hits)


@contextmanager
def _device_stream(dev: torch.device, stream) -> Iterator[None]:
    """``dev`` current and ``stream`` the current stream on it, together."""
    with torch.cuda.device(dev), torch.cuda.stream(stream):
        yield


def _to_host(t: torch.Tensor) -> tuple:
    """Queue the copy of a kernel's output to the host: on the card into
    pinned memory behind an event on the current stream, so the caller
    waits for this batch alone; a CPU output is there already."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


def _wait(pending: tuple) -> np.ndarray:
    """The host array of a :func:`_to_host` copy, once it has landed."""
    host, ev = pending
    if ev is not None:
        ev.synchronize()
    return host.numpy()


class _Fetch:
    """One batch's kernel outputs on their way to the host
    (:meth:`TorchSecretScanner.run_batch`)."""

    __slots__ = ("sc", "rows", "n_live", "pre", "hits", "didx")

    def __init__(self, sc: TorchSecretScanner, rows, n_live: int, pre, hits):
        self.sc = sc
        self.rows = rows
        self.n_live = n_live
        self.pre = pre
        self.hits = hits
        self.didx = None  # the dispatch index the batch went to

    def result(self):
        """``(hits, pre, nfa_ran)``: the anchored matcher's ``[B, R]`` hits
        (None when the prefilter gate skipped it), the prefilter's
        candidate mask (None without a prefilter), and whether the matcher
        ran. Blocks on the prefilter's copy (``secret.prefilter``), launches
        the matcher on the same stream when a live row may hold an anchored
        match, and blocks on its copy (``secret.device_wait``)."""
        sc = self.sc
        ctx = obs.current()
        # the first blocking fetch: where a copy or kernel fault surfaces
        faults.check("device.fetch", key=f"d{self.didx or 0}")
        if self.pre is None:
            with ctx.span("secret.device_wait"):
                return _wait(self.hits), None, True
        with ctx.span("secret.prefilter"):
            pre = _wait(self.pre)
        live = pre[: self.n_live]
        need = sc._has_unguarded_anchored or bool(
            len(sc._guarded_anchored_cols) and live[:, sc._guarded_anchored_cols].any())
        if not need:
            return None, pre, False
        with ctx.span("secret.dispatch"):
            hits = _to_host(sc._staged.run("match", self.rows))
        with ctx.span("secret.device_wait"):
            return _wait(hits), pre, True


@dataclass
class _Flight:
    """A dispatched batch in a transfer stream's window: the work item
    (``slab_id`` None for a retry, which owns its rows), its resident rows
    and its pending outputs."""

    slab_id: int | None
    batch: object
    meta: list
    retries: int
    rows: torch.Tensor | None
    fetch: _Fetch | None
    lic: tuple | None
    didx: int | None  # dispatch index (None: the single or mesh placement)


# a transfer stream's poll of the feed found nothing while its window holds
# batches: it fetches the oldest instead of holding it
_EMPTY = object()


class _ScanRun:
    """One ``scan_files`` call: a feeder thread, ``feed_streams`` transfer
    streams, a confirm pool and the reorder buffer the generator emits
    from, all recording into the scan's trace context ``ctx``.

    A transfer stream (thread ``secret-xfer-<i>``; on the card with its own
    ``torch.cuda.Stream``, under which all its copies, launches and fetches
    run) takes slabs from the feed queue and keeps up to ``inflight`` of
    them in flight: a batch's copy, license gate and prefilter are enqueued
    at dispatch, and the oldest batch is fetched first. When the feed has
    nothing for it, a stream fetches its oldest batch instead of holding
    it, so a small arena never stalls the feeder. The online controller,
    when on, moves the active stream count, the window and the arena
    (:meth:`knobs`, :meth:`limits`, :meth:`raw_gauges`,
    :meth:`set_streams`, :meth:`set_inflight`, :meth:`grow_arena`)."""

    def __init__(self, sc: TorchSecretScanner, files, ctx, license_gate=None):
        self.sc = sc
        self.files = files
        self.ctx = ctx
        self.enabled = ctx.enabled
        self.prof = ctx.profile() if ctx.enabled else None
        # this run's tallies (they add to the scanner's as they come): the
        # trace's counters and wire block sum every run's at its close
        self.stats = ScanStats(parent=sc.stats)
        # fused license pass: the scan's gate, and input index -> path of
        # the files it wants verdicts for
        self.lic_gate = license_gate
        self.lic_paths: dict[int, str] = {}
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        self.states: dict[int, _FileState] = {}
        # reorder buffer: input index -> Secret | in-flight Future
        self.results: dict[int, Secret | Future] = {}
        # row digest -> waiting segment lists: identical rows already
        # dispatched but not yet resolved coalesce here instead of being
        # uploaded again (zero pages recur within a single batch)
        self.row_waiters: dict[bytes, list] = {}
        self.total: int | None = None  # set once the input is exhausted
        self.error: BaseException | None = None
        # set once by _degrade: the rest of the scan runs on the host engine
        self.degraded = False
        self.stop = threading.Event()
        self.feed_done = threading.Event()  # the feeder has finished
        self.in_q: queue.Queue = queue.Queue(maxsize=FEED_QUEUE_DEPTH)
        streams = sc.feed_streams
        # the controller may grow the streams and windows up to its limits;
        # with it off nothing extra is allocated: exactly `streams` workers
        # and the derived arena
        tuning = sc.tuning
        self._controller_on = bool(tuning.controller) and tuning.tuning_interval > 0
        self.controller = None
        if self._controller_on:
            n_alloc = stream_limit(streams)
            self._max_inflight = inflight_limit(sc.inflight)
        else:
            n_alloc = streams
            self._max_inflight = sc.inflight
        self.active_streams = streams
        self.inflight = sc.inflight
        # every batch in flight holds its slab; a 1-slab arena could not
        # cycle at all
        slabs = max(2, sc.arena_slabs or FEED_QUEUE_DEPTH + streams * sc.inflight + ARENA_MARGIN)
        self._max_arena_slabs = max(
            slabs, FEED_QUEUE_DEPTH + n_alloc * self._max_inflight + ARENA_MARGIN)
        self.arena = ChunkArena(slabs, sc.batch_size, sc.chunk_len, alloc=sc._alloc_slab)
        # HBM ledger: every slab's rows may be on the card at once
        flight.note_resident("arena", self._arena_bytes())
        self._stream_inflight = [0] * n_alloc
        self._confirm_inflight = 0
        self.pool = ThreadPoolExecutor(max_workers=sc.confirm_workers)
        # bounds queued + running confirms, so retained file bytes stay
        # flat on a large scan
        self.confirm_slots = threading.Semaphore(sc.confirm_workers * 4)
        self.workers = [
            threading.Thread(target=self._worker, args=(i,), daemon=True,
                             name=f"secret-xfer-{i}")
            for i in range(n_alloc)
        ]
        self.feeder = threading.Thread(
            target=self._feed_guarded, daemon=True, name="secret-feeder"
        )
        # each transfer stream's per-device CUDA streams (see _on)
        self._tls = threading.local()

    def _arena_bytes(self) -> int:
        return self.arena.n_slabs * self.arena.rows * self.arena.row_len

    def start(self) -> None:
        sc, ctx = self.sc, self.ctx
        with sc._runs_lock:
            sc._runs[ctx] = sc._runs.get(ctx, 0) + 1
            ctx.add_probe(sc._telemetry_probe)
        ctx.add_probe(self._telemetry_probe)
        for w in self.workers:
            w.start()
        self.feeder.start()
        if self._controller_on:
            self.controller = TuningController(
                self, ctx=ctx, interval=sc.tuning.tuning_interval).start()

    # -- the online controller's adapter ------------------------------------

    def knobs(self) -> dict:
        return {"feed_streams": self.active_streams, "inflight": self.inflight,
                "arena_slabs": self.arena.n_slabs}

    def limits(self) -> dict:
        return {"max_streams": len(self.workers), "max_inflight": self._max_inflight,
                "max_arena_slabs": self._max_arena_slabs}

    def raw_gauges(self) -> dict:
        s = self.sc.stats.snapshot()
        busy = self.sc._busy.busy_seconds()
        return {
            "queue_depth": float(self.in_q.qsize()),
            "arena_free": float(self.arena.free_slabs),
            "bytes_uploaded_total": float(s["bytes_uploaded"]),
            "batch_splits_total": float(s["batch_splits"]),
            "busy_seconds_total": sum(busy) / max(1, len(busy)),
        }

    def set_streams(self, n: int) -> None:
        # a stream above the count parks once its window is drained; one
        # below it takes work again
        self.active_streams = max(1, min(len(self.workers), int(n)))

    def set_inflight(self, n: int) -> None:
        self.inflight = max(1, min(self._max_inflight, int(n)))

    def grow_arena(self, k: int) -> int:
        before = self.arena.n_slabs
        n = self.arena.grow(int(k), self._max_arena_slabs)
        if n > before:
            flight.note_resident("arena", (n - before) * self.arena.rows * self.arena.row_len)
        return n

    def _telemetry_probe(self) -> dict[str, float]:
        """This run's in-flight state for the telemetry sampler (called only
        from its thread): arena occupancy, queue depths, files pending,
        confirms in flight, the active streams, the window and each
        stream's batches in flight. Runs in flight at once sum."""
        vals = {
            "secret.arena_free_slabs": float(self.arena.free_slabs),
            "secret.arena_slabs": float(self.arena.n_slabs),
            "secret.feed_queue_depth": float(self.in_q.qsize()),
            "secret.files_pending": float(len(self.states)),
            "secret.results_buffered": float(len(self.results)),
            "secret.confirm_inflight": float(self._confirm_inflight),
            "secret.active_streams": float(self.active_streams),
            "secret.inflight_window": float(self.inflight),
        }
        for i, n in enumerate(self._stream_inflight):
            vals[f"secret.stream{i}.inflight"] = float(n)
        return vals

    def _publish(self) -> None:
        """This run's byte tallies into the trace: the ``secret.*``
        counters, and with the codec on the ``wire`` block, each a sum over
        the scan's runs."""
        d = self.stats.snapshot()
        for name, n in (
            ("secret.bytes_uploaded", d["bytes_uploaded"]),
            ("secret.bytes_compressed", d["bytes_compressed"]),
            ("secret.bytes_gated_binary", d["bytes_gated_binary"]),
            ("secret.bytes_raw_fallback", d["bytes_raw_fallback"]),
            # warm-store hits are dedup hits too, as in the JAX feed
            ("secret.bytes_dedup_hit", d["bytes_dedup_hit"]),
            ("secret.bytes_warm_hit", d["bytes_warm_hit"]),
            ("secret.bytes_gated", d["bytes_gated"]),
            ("secret.bytes_packed", d["bytes_packed"]),
            ("secret.rows_nfa_skipped", d["rows_nfa_skipped"]),
        ):
            if n:
                self.ctx.count(name, n)
        if self.sc._codec is not None and self.enabled:
            self.ctx.merge_wire({k: d[k] for k in (
                "bytes_compressed", "bytes_raw_equiv", "bytes_raw_fallback", "bytes_gated",
                "bytes_gated_binary", "chunks_gated_zero", "batches_compressed",
                "batches_raw_fallback")})

    def close(self) -> None:
        sc, ctx = self.sc, self.ctx
        # the controller stops first: it moves the streams, the window and
        # the arena, and its final knobs freeze before the counts below
        if self.controller is not None:
            self.controller.stop()
        ctx.remove_probe(self._telemetry_probe)
        with sc._runs_lock:
            sc._runs[ctx] -= 1
            if not sc._runs[ctx]:
                del sc._runs[ctx]
                ctx.remove_probe(sc._telemetry_probe)
        self.stop.set()
        self.feeder.join(timeout=10.0)
        for w in self.workers:
            w.join(timeout=10.0)
        # batches no stream took (the scan degraded or failed while they
        # were queued) return their slabs, once
        while True:
            try:
                item = self.in_q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                self.arena.release(item[0])
        self.pool.shutdown(wait=False, cancel_futures=True)
        # push the dedup store's write-behind tail so the next scan, possibly
        # in another process, starts warm
        self.sc._hit_store.flush_writes(force=True)
        flight.release_resident("arena", self._arena_bytes())
        # the arena after the run, for tests: on a clean scan every slab is
        # back, and acquires above the slab count show reuse
        sc._last_feed_stats = {"arena_slabs": self.arena.n_slabs,
                               "arena_free": self.arena.free_slabs,
                               "arena_acquires": self.arena.acquires,
                               "streams": len(self.workers)}
        self._publish()

    def _closing(self) -> bool:
        """The scan stopped or failed: nobody waits on further results."""
        return self.stop.is_set() or self.error is not None

    def _aborted(self) -> bool:
        """No more device work: the scan is closing or degraded."""
        return self._closing() or self.degraded

    def _fail(self, err: BaseException) -> None:
        with self.cond:
            if self.error is None:
                self.error = err
            self.cond.notify_all()
        self.stop.set()
        if self.lic_gate is not None:
            # the gate's verdicts are incomplete: the license analyzers
            # classify every file they collected
            self.lic_gate.degrade()

    def _degrade(self, cause: BaseException) -> None:
        """The ladder's last rung, once, where ``obs.degrade_or_raise``
        allows it (else ``cause`` is raised): every file with unresolved
        device work moves to the exact host engine (partial device results
        are dropped), and the feeder routes the rest of the input there."""
        with self.lock:
            if self.degraded or self.error is not None:
                return
        obs.degrade_or_raise(
            cause, device=self.sc.device, host_fallback=self.sc._host_fallback,
            counter="secret.degraded", health=False, logger=logger,
            message="device pipeline failed (%s); completing the scan on the exact host "
                    "confirm path — slower, findings identical")
        with self.lock:
            self.degraded = True
            moved = [(i, self.states.pop(i)) for i in sorted(self.states)]
            self.row_waiters.clear()
        if self.lic_gate is not None:
            self.lic_gate.degrade()
        self.stats.add(degraded=1)
        for fidx, st in moved:
            self._submit_host(fidx, st.path, st.data)
        with self.cond:
            self.cond.notify_all()

    # -- result plumbing ----------------------------------------------------

    def _set_result(self, fidx: int, value) -> None:
        with self.cond:
            self.results[fidx] = value
            self.cond.notify_all()

    def _acquire_slot(self) -> bool:
        while not self._closing():
            if self.confirm_slots.acquire(timeout=0.2):
                with self.lock:
                    self._confirm_inflight += 1
                return True
        return False

    def _release_slot(self) -> None:
        with self.lock:
            self._confirm_inflight -= 1
        self.confirm_slots.release()

    def _confirm_task(self, st: _FileState) -> Secret:
        try:
            with obs.activate(self.ctx), self.ctx.span("secret.confirm"):
                return self.sc._confirm_inner(st, self.prof)
        finally:
            self._release_slot()

    def _host_task(self, path: str, data: bytes) -> Secret:
        # the degraded rung: the exact host engine is the parity oracle
        try:
            with obs.activate(self.ctx), self.ctx.span("secret.host_fallback"):
                return self.sc.exact.scan_bytes(path, data)
        finally:
            self._release_slot()

    def _submit_confirm(self, fidx: int, st: _FileState) -> None:
        if self._acquire_slot():
            self._set_result(fidx, self.pool.submit(self._confirm_task, st))

    def _submit_host(self, fidx: int, path: str, data: bytes) -> None:
        if self._acquire_slot():
            self._set_result(fidx, self.pool.submit(self._host_task, path, data))

    def _apply_hits(self, batch: list) -> None:
        """Credit resolved rows to their file segments; ``batch`` is
        ``[(segs, hit_rules, cand_rules, nfa_ran, lic)]`` (the row-verdict
        schema of the dedup store). Every row hit applies to every segment
        of the row — cross-segment false candidates are discarded by the
        exact confirm. Files whose last pending row resolved here go to the
        confirm pool."""
        prof = self.prof
        if prof is not None:
            # one logical device hit per (row, rule): rows served by the
            # store or coalesced count too, they cost a confirm all the same
            rule_ids = self.sc.compiled.rule_ids
            for _, hit_rules, cand_rules, _, _ in batch:
                for r in hit_rules:
                    prof.gate_hit(rule_ids[r])
                for r in cand_rules:
                    prof.prefilter_hit(rule_ids[r])
        guarded_anchored = self.sc._guarded_anchored
        ready: list[tuple[int, _FileState]] = []
        with self.lock:
            for segs, hit_rules, cand_rules, nfa_ran, _ in batch:
                for fidx, ws, we in segs:
                    st = self.states.get(fidx)
                    if st is None:
                        continue  # swept onto the host path by _degrade
                    for r in hit_rules:
                        st.rules.setdefault(r, []).append((ws, we))
                    if st.cand is not None:
                        st.cand.update(cand_rules)
                        if not nfa_ran:
                            st.unchecked.update(guarded_anchored)
                for fidx, _, _ in segs:
                    st = self.states.get(fidx)
                    if st is None:
                        continue
                    st.pending -= 1
                    if st.pending == 0:
                        del self.states[fidx]
                        ready.append((fidx, st))
        if self.lic_gate is not None:
            for segs, _, _, _, lic in batch:
                self._apply_lic(segs, lic)
        for fidx, st in ready:
            self._submit_confirm(fidx, st)

    def _apply_lic(self, segs, lic) -> None:
        """Fold one row's license verdict into the gate. ``lic`` holds the
        row's flagged block indices, or is None when the row's batch never
        ran the gate: a wanted file then goes to the classifier (``skip``),
        never to a silent miss. Segment offsets are rebuilt from the packing
        layout (``len + gap`` apart, as ``emit_pack`` lays them out), so a
        block flags only the files it overlaps; a block across a boundary
        flags both."""
        gate = self.lic_gate
        if lic is None:
            for fidx, _, _ in segs:
                path = self.lic_paths.get(fidx)
                if path is not None:
                    gate.skip(path)
            return
        if not lic:
            return
        blk = self.sc._lic_block
        gap = self.sc.overlap
        off = 0
        for fidx, ws, we in segs:
            if len(segs) == 1:
                lo, hi = 0, self.sc.chunk_len  # a big file's row: the whole row
            else:
                lo, hi = off, off + (we - ws)
                off = hi + gap
            path = self.lic_paths.get(fidx)
            if path is not None and any(b * blk < hi and (b + 1) * blk > lo for b in lic):
                gate.flag(path)

    def _resolve(self, hits, meta: list, pre, nfa_ran: bool, lic=None) -> None:
        """Fold one fetched batch into file state. ``hits`` is the anchored
        matcher's output (None when the batch skipped it), ``pre`` the
        prefilter mask and ``lic`` the license gate's block flags (None when
        the batch did not run it); all are sliced to the live rows here
        (rows past ``len(meta)`` are bucket padding). Each keyed row's
        verdict goes into the hit store and to the rows coalesced onto
        it."""
        sc = self.sc
        n = len(meta)
        cand_by_row: dict[int, list[int]] = {}
        if pre is not None:
            pre = pre[:n]
            for row, r in zip(*(a.tolist() for a in np.nonzero(pre))):
                cand_by_row.setdefault(row, []).append(r)
            # keyword-lane hits come straight from the prefilter mask; the
            # anchored hits from the matcher when it ran
            full = (
                np.array(hits[:n], dtype=bool, copy=True)
                if hits is not None
                else np.zeros((n, sc.compiled.num_rules), dtype=bool)
            )
            if len(sc._kw_lane_cols):
                full[:, sc._kw_lane_cols] |= pre[:, sc._kw_lane_cols]
            hit_rows = int(pre.any(axis=1).sum())
            self.stats.add(rows_prefilter_hit=hit_rows)
            if self.prof is not None:
                self.prof.prefilter_rows(n, 0 if nfa_ran else n, hit_rows)
        else:
            full = hits[:n]
        by_row: dict[int, list[int]] = {}
        for row, r in zip(*(a.tolist() for a in np.nonzero(full))):
            by_row.setdefault(row, []).append(r)
        lic_by_row: dict[int, list[int]] = {}
        if lic is not None:
            lic = lic[:n]
            for row, b in zip(*(a.tolist() for a in np.nonzero(lic))):
                lic_by_row.setdefault(row, []).append(b)
            self.stats.add(license_rows_gated=n, license_rows_flagged=int(lic.any(axis=1).sum()),
                         **{f"license_rows_{name}": int((lic & bit).any(axis=1).sum())
                            for name, bit in LIC_LANES})
        store = sc._hit_store
        apply: list = []
        for row, (key, segs, _) in enumerate(meta):
            verdict = (tuple(by_row.get(row, ())), tuple(cand_by_row.get(row, ())), nfa_ran,
                       None if lic is None else tuple(lic_by_row.get(row, ())))
            apply.append((segs,) + verdict)
            if key is not None:
                store.put(key, verdict)
                with self.lock:
                    waiting = self.row_waiters.pop(key, ())
                apply.extend((w,) + verdict for w in waiting)
        # write-behind flush: one backend call per batch (a no-op without a
        # persistent backend or below the write batch)
        store.flush_writes()
        self._apply_hits(apply)

    # -- transfer streams ---------------------------------------------------

    def _worker(self, wid: int) -> None:
        """Transfer stream ``wid``: each slab crosses to the device as one
        (pinned, non-blocking) copy, or as a compressed wire frame that the
        decompress kernel expands into the same ``[n, C]`` rows; the license
        gram gate (of a fused scan's batches that carry a file it wants) and
        the prefilter are queued on the resident rows at once, and up to
        ``inflight`` batches stay in flight. The oldest is fetched first;
        its slab returns to the arena only after the copies behind the last
        kernel reading its rows have landed. A failed batch walks the ladder
        (:meth:`_recover`) on this stream; a degrade or a failure drops the
        stream's window, slabs and busy intervals."""
        pending: deque[_Flight] = deque()
        # this stream's torch.cuda.Stream on each device it touches
        self._tls.streams = {}
        # the degrade and the failure below count into the scan's context
        with obs.activate(self.ctx):
            try:
                try:
                    with self._on(None):
                        self._stream_loop(wid, pending)
                except _DeviceFailed as e:
                    self._drop(pending)
                    self._degrade(e.cause)  # or raises the cause
            except BaseException as e:
                self._drop(pending)
                self._fail(e)
            finally:
                self._drop(pending)
                self._stream_inflight[wid] = 0

    def _on(self, didx: int | None):
        """This transfer stream on the device of dispatch index ``didx``
        (None: the scanner's device): the device made current (the kernels
        launch through ctypes on this thread's device) and the stream's own
        ``torch.cuda.Stream`` there, made once, under which every copy,
        launch and fetch of the batch runs and its tensors are allocated.
        A no-op on the CPU."""
        dev = self.sc._staged.device_of(didx)
        if dev.type != "cuda":
            return nullcontext()
        stream = self._tls.streams.get(dev)
        if stream is None:
            stream = self._tls.streams[dev] = torch.cuda.Stream(device=dev)
        return _device_stream(dev, stream)

    def _stream_loop(self, wid: int, pending: deque) -> None:
        while not self._aborted():
            if wid >= self.active_streams:
                # parked by the controller: drain the window, then idle until
                # woken, the end of the input or the end of the scan
                while pending and not self._aborted():
                    self._fetch_oldest(pending, wid)
                if self._aborted() or self.feed_done.is_set():
                    return
                self.stop.wait(0.1)
                continue
            item = self._get_work(pending)
            if item is None:
                break
            if item is _EMPTY:
                self._fetch_oldest(pending, wid)
                continue
            slab_id, batch, meta = item
            self._dispatch(pending, wid, slab_id, batch, meta, 0)
            self._stream_inflight[wid] = len(pending)
            while len(pending) >= self.inflight:
                self._fetch_oldest(pending, wid)
        # the input ended: retire the window
        while pending and not self._aborted():
            self._fetch_oldest(pending, wid)

    def _get_work(self, pending: deque):
        """The next slab from the feed, :data:`_EMPTY` when the feed has
        none while this stream's window holds batches, or None at the end
        of the input (the sentinel is put back for the other streams) or of
        the scan."""
        if pending:
            try:
                item = self.in_q.get_nowait()
            except queue.Empty:
                return _EMPTY
        else:
            with self.ctx.span("secret.feed_wait"):
                while True:
                    if self._aborted():
                        return None
                    try:
                        item = self.in_q.get(timeout=0.2)
                        break
                    except queue.Empty:
                        continue
        if item is None:
            self._put_sentinel()
        return item

    def _put_sentinel(self) -> None:
        while not self._aborted():
            try:
                self.in_q.put(None, timeout=0.2)
                return
            except queue.Full:
                continue

    def _dispatch(self, pending: deque, wid: int, slab_id, batch, meta, retries: int,
                  narrow: bool = False) -> None:
        """Dispatch one work item into the window, walking the ladder on a
        dispatch failure; a retry or a split stays on this stream. After an
        OOM-shaped failure (``narrow``) the window holds one batch until the
        split's work is done: the stream fetches every batch in flight
        before each half goes out, so the halves do not meet the memory the
        window held."""
        work = [(slab_id, batch, meta, retries)]
        while work:
            sid, b, m, r = work.pop()
            if narrow:
                while pending:
                    self._fetch_oldest(pending, wid)
            try:
                pending.append(self._launch(sid, b, m, r))
            except Exception as e:
                narrow = narrow or _is_oom(e)
                work.extend(self._recover(b, m, sid, r, e))
        if narrow:
            while pending:
                self._fetch_oldest(pending, wid)

    def _launch(self, slab_id, batch, meta, retries: int) -> _Flight:
        """One batch's copy (or wire frame and decompress kernel), license
        gate when the batch carries a file the gate wants, and first matcher
        use, all queued on this stream on the batch's device (the next the
        breaker allows under round-robin); raises whatever the card raised,
        or :class:`DevicesUnavailable`."""
        staged = self.sc._staged
        ctx = self.ctx
        didx = staged.pick()
        with self._on(didx):
            if isinstance(batch, CompressedSlab):
                # the frame crosses (its wire from the pinned arena slab)
                # and the decompress kernel expands it
                with ctx.span("secret.dispatch"):
                    parts, didx = staged.put_parts(batch.arrays(), didx)
                try:
                    with ctx.span("secret.decompress"):
                        rows = staged.run("decompress", parts, didx)
                except BaseException:
                    staged.busy.end(didx)
                    raise
            else:
                with ctx.span("secret.dispatch"):
                    host = batch if slab_id is None else self.arena.slab(slab_id)[:batch]
                    rows, didx = staged.put(host, didx)
            try:
                # the gate is queued ahead of the matcher on one stream
                lic = None
                if self._want_lic(meta):
                    with ctx.span("secret.dispatch"):
                        lic = _to_host(staged.run("license", rows, didx))
                fetch = self.sc.run_batch(rows, len(meta))
                fetch.didx = didx
            except BaseException:
                # placed but not launched: no fetch will close its interval
                staged.busy.end(didx)
                raise
        return _Flight(slab_id, batch, meta, retries, rows, fetch, lic, didx)

    def _fetch_oldest(self, pending: deque, wid: int) -> None:
        """Fetch the window's oldest batch and resolve it; a fetch failure
        walks the ladder and its work items join this stream's window."""
        f = pending.popleft()
        sc = self.sc
        prof = self.prof
        t0 = time.perf_counter() if prof is not None else 0.0
        redo = None
        try:
            with self._on(f.didx):
                hits, pre, nfa_ran = f.fetch.result()
                lic = _wait(f.lic) if f.lic is not None else None
        except Exception as e:
            sc._staged.record_result(f.didx, False)
            work = (f.batch, f.meta, f.slab_id, f.retries)
            # the failed attempt's device tensors go before any retry
            f = None
            redo = self._recover(*work, e)
            narrow = _is_oom(e)
        if redo is not None:
            for sid, batch, meta, retries in redo:
                self._dispatch(pending, wid, sid, batch, meta, retries, narrow)
            self._stream_inflight[wid] = len(pending)
            return
        sc._staged.record_result(f.didx, True)
        # every kernel reading the batch's rows has finished: its slab (the
        # rows themselves on the CPU) may be refilled
        if f.slab_id is not None:
            self.arena.release(f.slab_id)
        self._stream_inflight[wid] = len(pending)
        if prof is not None:
            # the batch's rung, its live rows and the blocking fetches
            prof.bucket_dispatch(int(f.rows.shape[0]), len(f.meta), time.perf_counter() - t0)
        meta = f.meta
        self.stats.add(rows=len(meta), batches=1)
        if not nfa_ran:
            self.stats.add(rows_nfa_skipped=len(meta), batches_nfa_skipped=1)
        if not self.degraded:
            self._resolve(hits, meta, pre, nfa_ran, lic)

    def _drop(self, pending: deque) -> None:
        """Give up a window (a degrade, a failure, the scan closing): its
        slabs go back and its busy intervals close."""
        while pending:
            f = pending.popleft()
            if f.slab_id is not None:
                self.arena.release(f.slab_id)
            self.sc._busy.end(f.didx)

    def _rebatch(self, rows: np.ndarray, meta: list) -> np.ndarray:
        """A fresh bucket-padded copy of a failed batch's live rows: the
        source slab is released right after, so a retry never reads arena
        memory the feeder may refill."""
        n = next(b for b in self.sc._buckets if b >= len(meta))
        out = np.zeros((n, self.sc.chunk_len), dtype=np.uint8)
        out[: len(meta)] = rows[: len(meta)]
        return out

    def _recover(self, batch, meta: list, slab_id, retries: int, err: BaseException) -> list:
        """The ladder's decision for one failed batch: the work items to
        dispatch again, :class:`_DeviceFailed` when the ladder is
        exhausted, or ``err`` itself when it is a kernel fault, which no
        rung may absorb. Always ends the source slab's ownership, once.

        A compressed batch is decoded to raw rows on the host first (the
        reference decoder, byte-equal to the kernel), so every rung runs on
        plain rows and a decoder fault cannot loop through the codec."""
        sc = self.sc
        ctx = self.ctx

        def release() -> None:
            if slab_id is not None:
                self.arena.release(slab_id)

        if kernel_fault(err):
            release()
            raise err
        if isinstance(err, DevicesUnavailable):
            # every device is circuit-broken: no retry can land anywhere
            release()
            raise _DeviceFailed(err)
        if self._aborted():
            # the scan is closing, or degraded by another stream: the
            # batch's files are on the host path already
            release()
            return []
        if isinstance(batch, CompressedSlab):
            try:
                rows = sc._codec.decode_slab(batch)
            except Exception as dec_err:
                # an undecodable frame is an encoder fault, not a device
                # fault: no retry can fix it
                logger.warning("compressed batch unrecoverable after device error (%s); "
                               "decode failed: %s", err, dec_err)
                release()
                raise _DeviceFailed(err)
        elif slab_id is not None:
            rows = self.arena.slab(slab_id)[:batch]
        else:
            rows = batch
        if _is_oom(err) and len(meta) > 1:
            self.stats.add(batch_splits=1)
            ctx.count("secret.batch_splits")
            flight.record("oom", "secret.batch_split", {"rows": len(meta), "error": str(err)})
            logger.warning("device OOM on a %d-row batch (%s); splitting and re-dispatching "
                           "the halves", len(meta), err)
            mid = (len(meta) + 1) // 2
            halves = [(None, self._rebatch(rows[:mid], meta[:mid]), meta[:mid], retries),
                      (None, self._rebatch(rows[mid:], meta[mid:]), meta[mid:], retries)]
            release()
            return halves
        if retries < BATCH_RETRIES:
            self.stats.add(batch_retries=1)
            ctx.count("secret.batch_retries")
            flight.record("retry", "secret.batch_retry",
                          {"rows": len(meta), "attempt": retries + 1, "error": str(err)})
            logger.warning("device error on a %d-row batch (retry %d/%d): %s",
                           len(meta), retries + 1, BATCH_RETRIES, err)
            fresh = self._rebatch(rows, meta)
            release()
            return [(None, fresh, meta, retries + 1)]
        release()
        raise _DeviceFailed(err)

    def _want_lic(self, meta) -> bool:
        """Whether a batch carries a file the license gate wants: batches
        that do not skip the gate, so secret-only traffic pays nothing."""
        lp = self.lic_paths
        return self.lic_gate is not None and any(
            fidx in lp for _, segs, _ in meta for fidx, _, _ in segs)

    # -- feeder -------------------------------------------------------------

    def _feed_guarded(self) -> None:
        with obs.activate(self.ctx):
            try:
                self._feed()
            except BaseException as e:
                self._fail(e)

    def _feed(self) -> None:
        sc = self.sc
        ctx = self.ctx
        stats = self.stats
        chunk_len = sc.chunk_len
        B = sc.batch_size
        use_pf = sc._prefilter is not None
        dedup = sc._dedup
        lic_gate = self.lic_gate
        # fused scans key rows in their own digest namespace: their verdicts
        # carry the license gate's, which plain scans never set
        fp_key = sc.ruleset_fingerprint + (b":lic" if lic_gate is not None else b"")
        # the widest gram or anchor window the gate surely sees inside some
        # row; the gate's host patch checks wider ones
        lic_span_bound = sc.overlap - 2
        store = sc._hit_store
        persist_on = dedup and store.backend is not None
        # compressed feed on -> the zero gate is on (all-zero rows resolve
        # through a forced dedup key instead of crossing the link again)
        zero_gate = sc._codec is not None
        gap = sc.overlap
        pack_max = chunk_len - gap
        blake2b = hashlib.blake2b
        slab_id: int | None = None
        slab: np.ndarray | None = None
        used = 0
        # per-row metadata:
        # (digest | None, [(fidx, win_start, win_end)], corpus_bytes)
        meta: list[tuple[bytes | None, list[tuple[int, int, int]], int]] = []
        # slab rows awaiting the bulk strided gather from the current file
        copy_rows: list[int] = []
        copy_starts: list[int] = []
        copy_win = None  # row_windows view over the current file's bytes
        pack_pending: list[tuple[int, bytes]] = []
        pack_len = 0

        class _FeedAbort(Exception):
            pass

        def lic_register(fidx: int, path: str, data: bytes) -> None:
            """A file entering the device feed: coverage and the host
            wide-window patch, and the index its rows' verdicts flag by."""
            if lic_gate is not None and lic_gate.wants(path):
                self.lic_paths[fidx] = path
                lic_gate.feed_file(path, data, lic_span_bound)

        def lic_skip(path: str) -> None:
            """This file's bytes will not ride the device pass: the license
            analyzers must classify it themselves."""
            if lic_gate is not None and lic_gate.wants(path):
                lic_gate.skip(path)

        def register(fidx: int, path: str, data: bytes, pending: int) -> bool:
            """Enter a file's state; False when the scan degraded meanwhile
            (the file then goes to the host engine: a state entered after
            ``_degrade`` swept the table would never resolve)."""
            st = _FileState(path=path, data=data, pending=pending,
                            cand=set() if use_pf else None)
            with self.lock:
                if self.degraded:
                    return False
                self.states[fidx] = st
                return True

        def to_host(fidx: int, path: str, data: bytes) -> None:
            lic_skip(path)
            self._submit_host(fidx, path, data)

        def flush_copies() -> None:
            nonlocal copy_rows, copy_starts
            if copy_rows:
                # ONE vectorized gather for every full row the current
                # file placed in this slab
                slab[np.asarray(copy_rows)] = copy_win[np.asarray(copy_starts)]
                copy_rows = []
                copy_starts = []

        def acquire() -> tuple[int, np.ndarray]:
            got = self.arena.acquire(self._aborted)
            if got is None:
                raise _FeedAbort
            return got

        def ensure_slab() -> None:
            nonlocal slab_id, slab, used
            if slab is None:
                with ctx.span("secret.arena_wait"):
                    slab_id, slab = acquire()
                used = 0

        def route_row(key, segs, nbytes) -> bool:
            """True when the row resolved without an upload: served from
            the hit store or coalesced onto an identical in-flight row."""
            if key is None:
                return False
            cached = store.get(key)
            if cached is not None:
                stats.add(chunks_dedup_hit=1, bytes_dedup_hit=nbytes)
                self._apply_hits([(segs,) + cached])
                return True
            with self.lock:
                waiting = self.row_waiters.get(key)
                if waiting is not None:
                    waiting.append(segs)
                else:
                    self.row_waiters[key] = []
            if waiting is not None:
                stats.add(chunks_dedup_hit=1, bytes_dedup_hit=nbytes)
            return waiting is not None

        def warm_filter() -> None:
            """Persistent-store lookup for the assembled slab's rows, in one
            batched call. Rows whose verdict is already persisted resolve
            here (no upload, no kernel) and the slab compacts over the
            survivors with one vectorized gather."""
            nonlocal meta
            keys = [k for k, _, _ in meta if k is not None]
            if not keys:
                return
            with ctx.span("secret.warm_hit"):
                found = store.lookup_batch(keys)
            if not found:
                return
            live: list[int] = []
            warm_apply: list = []
            warm_rows = warm_bytes = 0
            for i, (k, segs, nbytes) in enumerate(meta):
                v = found.get(k) if k is not None else None
                if v is None:
                    live.append(i)
                    continue
                warm_rows += 1
                warm_bytes += nbytes
                warm_apply.append((segs,) + v)
                with self.lock:
                    waiting = self.row_waiters.pop(k, ())
                warm_apply.extend((w,) + v for w in waiting)
            if not warm_apply:
                return
            # chunks_uploaded was counted at assembly; correct it so the
            # dedup-hit-rate denominators stay exact
            stats.add(
                chunks_dedup_hit=warm_rows, bytes_dedup_hit=warm_bytes,
                chunks_warm_hit=warm_rows, bytes_warm_hit=warm_bytes,
                chunks_uploaded=-warm_rows,
            )
            self._apply_hits(warm_apply)
            if live:
                slab[: len(live)] = slab[np.asarray(live)]
            meta = [meta[i] for i in live]

        def compress_slab(n: int):
            """The assembled slab's live rows as a wire frame in a SECOND
            arena slab (the wire stays in pinned, reused memory and takes
            part in the arena's backpressure): the dispatch item
            ``(wire_slab_id, CompressedSlab, meta)``, or None when the batch
            ships raw: it can't beat the min-ratio wire budget, or the
            encoder raised (logged; a raw batch is the codec's failure
            contract, never a failed scan)."""
            dst_id = None
            try:
                with ctx.span("secret.compress"):
                    plan = sc._codec.plan(slab[: len(meta)])
                    total = plan.total()
                    rung = next((r for r in sc._wire_rungs[n] if r >= total), None)
                    if rung is None:
                        return None
                    dst_id, dst = acquire()
                    cs = sc._codec.emit(plan, n, rung, dst.reshape(-1))
            except _FeedAbort:
                raise
            except Exception as e:
                logger.warning("slab compression failed (%s: %s); shipping raw",
                               type(e).__name__, e)
                if dst_id is not None:
                    self.arena.release(dst_id)
                return None
            wire = rung + cs.frame_bytes()
            stats.add(
                bytes_uploaded=wire,
                bytes_compressed=wire,
                bytes_raw_equiv=n * chunk_len,
                bytes_gated_binary=int(plan.binary.sum()) * chunk_len,
                batches_compressed=1,
            )
            return (dst_id, cs, meta)

        def flush() -> None:
            nonlocal slab_id, slab, used, meta
            flush_copies()
            if persist_on and meta:
                warm_filter()
            if not meta:
                # padding-only batches are never sent (and a fully-warm
                # slab resolved above with no upload at all)
                if slab is not None:
                    self.arena.release(slab_id)
                    slab_id, slab, used = None, None, 0
                # a fully-warm flush is still a batch boundary for the pack
                # staleness bound below
                if pack_pending:
                    emit_pack()
                return
            n = next(b for b in sc._buckets if b >= len(meta))
            item = compress_slab(n) if sc._codec is not None else None
            if item is None:
                # raw slab (codec off, or a batch that doesn't pay)
                slab[len(meta) : n] = 0  # bucket padding rows are zero rows
                stats.add(bytes_uploaded=n * chunk_len)
                if sc._codec is not None:
                    stats.add(bytes_raw_fallback=n * chunk_len, batches_raw_fallback=1)
                item = (slab_id, n, meta)
            else:
                # the wire rides its own slab; the source slab is done the
                # moment the encoder copied out of it
                self.arena.release(slab_id)
            slab_id, slab, used, meta = None, None, 0, []
            ctx.sample("secret.queue_depth", self.in_q.qsize())
            while True:
                if self._aborted():
                    self.arena.release(item[0])
                    raise _FeedAbort
                try:
                    self.in_q.put(item, timeout=0.2)
                    break
                except queue.Full:
                    continue
            # bound pack-row staleness to one batch: a lone small file must
            # not sit in pack_pending while big files stream past it, or its
            # unresolved state would stall in-order emission
            if pack_pending:
                emit_pack()

        def emit_pack() -> None:
            nonlocal pack_len, used
            if not pack_pending:
                return
            items = list(pack_pending)
            pack_pending.clear()
            pack_len = 0
            key = None
            # the zero gate extends to single-file pack rows (a tree of
            # zero-filled placeholder files), in the chunk rows' digest domain
            single_zero = zero_gate and len(items) == 1 and not any(items[0][1])
            if dedup or single_zero:
                if len(items) == 1:
                    # a single-segment row has the chunk-row layout: share
                    # the chunk digest domain so it dedups across both paths
                    key = blake2b(items[0][1], digest_size=16, key=fp_key).digest()
                else:
                    h = blake2b(digest_size=16, key=fp_key, person=b"packed-row")
                    for _, d in items:
                        h.update(len(d).to_bytes(4, "little"))
                        h.update(d)
                    key = h.digest()
            segs = [(fidx, 0, len(d)) for fidx, d in items]
            nbytes = sum(len(d) for _, d in items)
            stats.add(chunks=1)
            if route_row(key, segs, nbytes):
                if single_zero:
                    stats.add(bytes_gated=nbytes, chunks_gated_zero=1)
                return
            ensure_slab()
            row = slab[used]
            row[:] = 0  # zero guard gaps + stale tail (slabs are reused)
            off = 0
            for _, d in items:
                row[off : off + len(d)] = np.frombuffer(d, dtype=np.uint8)
                off += len(d) + gap
            meta.append((key, segs, nbytes))
            used += 1
            stats.add(chunks_uploaded=1)
            if len(segs) > 1:
                stats.add(rows_packed=1, files_packed=len(segs), bytes_packed=nbytes)
            if used == B:
                flush()

        def add_small(fidx: int, data: bytes) -> None:
            # files below a row's size share one row, separated by zero
            # gaps of at least the widest device window: a real match's
            # program reads only match bytes (+1 boundary byte), so packing
            # never suppresses a hit; cross-file windows only add false
            # candidates that the exact confirm discards
            nonlocal pack_len
            if pack_len and pack_len + gap + len(data) > chunk_len:
                emit_pack()
            pack_pending.append((fidx, data))
            pack_len += (gap if pack_len else 0) + len(data)

        def feed_big(fidx: int, path: str, data: bytes) -> None:
            nonlocal used, copy_win
            starts = chunk_spans(len(data), chunk_len, sc.overlap)
            if not register(fidx, path, data, len(starts)):
                to_host(fidx, path, data)
                return
            lic_register(fidx, path, data)
            arr = np.frombuffer(data, dtype=np.uint8)
            n = arr.size
            stats.add(bytes_in=len(data), chunks=len(starts))
            copy_win = row_windows(arr, chunk_len)
            uploaded = 0
            for s in starts:
                end = min(s + chunk_len, n)
                # zero gate: all-zero rows (sparse files, zero pages) get a
                # forced dedup key even with dedup off, so the first one
                # ships and every other resolves through the dedup and
                # coalesce machinery; the row still rides the real verdict
                # path once, so a ruleset that matches NUL runs keeps its
                # findings
                is_zero = zero_gate and not arr[s:end].any()
                key = (
                    blake2b(arr[s:end], digest_size=16, key=fp_key).digest()
                    if dedup or is_zero
                    else None
                )
                segs = [(fidx, s, s + chunk_len)]
                if route_row(key, segs, end - s):
                    if is_zero:
                        stats.add(bytes_gated=end - s, chunks_gated_zero=1)
                    continue
                ensure_slab()
                if end - s == chunk_len:
                    copy_rows.append(used)
                    copy_starts.append(s)
                else:
                    # short tail row: copy, then zero the stale remainder
                    slab[used, : end - s] = arr[s:end]
                    slab[used, end - s :] = 0
                meta.append((key, segs, end - s))
                used += 1
                uploaded += 1
                if used == B:
                    flush()
            flush_copies()  # the view dies with this file's scope
            copy_win = None
            if uploaded:
                stats.add(chunks_uploaded=uploaded)

        total = 0
        feed_ok = True
        try:
            for fidx, (path, data) in enumerate(self.files):
                if self._closing():
                    break
                total = fidx + 1
                if self.degraded:
                    # the device path is gone: straight to the exact host
                    # engine (files _degrade swept keep their host results)
                    pack_pending.clear()
                    to_host(fidx, path, data)
                    continue
                try:
                    with ctx.span("secret.assemble"):
                        if sc.exact.allow_path(path):
                            # path-level global allowlist: skip the whole
                            # file (ref: scanner.go:388-392) — no device work
                            lic_skip(path)
                            self._set_result(fidx, Secret(file_path=path))
                        elif not data:
                            # empty file: nothing for the device to match;
                            # host-lane rules still run in the confirm, and
                            # the license gate misses nothing in zero bytes
                            if lic_gate is not None and lic_gate.wants(path):
                                lic_gate.cover(path)
                            self._submit_confirm(fidx, _FileState(
                                path=path, data=data, pending=0,
                                cand=set() if use_pf else None))
                        elif sc._pack_small and len(data) <= pack_max:
                            stats.add(bytes_in=len(data))
                            if register(fidx, path, data, 1):
                                lic_register(fidx, path, data)
                                add_small(fidx, data)
                            else:
                                to_host(fidx, path, data)
                        else:
                            feed_big(fidx, path, data)
                except _FeedAbort:
                    # mid-file: a degrade swept this file's state onto the
                    # host path; otherwise the scan is closing
                    if not self.degraded:
                        break
            if not self._aborted():
                emit_pack()  # the partial pack row
                flush()  # the final partial slab
        except _FeedAbort:
            pass
        except BaseException:
            # never publish `total` on a failed feed: emission must see the
            # error, not a truncated-but-"complete" input count
            feed_ok = False
            raise
        finally:
            if slab is not None:
                self.arena.release(slab_id)
            with self.cond:
                if feed_ok and not self._closing():
                    self.total = total
                self.cond.notify_all()
            # end of input: parked streams see feed_done; one sentinel
            # passes from stream to stream (each puts it back)
            self.feed_done.set()
            self._put_sentinel()
