"""The port's version schemes and version-constraint check against the JAX
package: the plain versions of ``csrc/verscmp.cu`` against ``_lexcmp``,
``_check_ops`` and ``_check_ops_gather``, a numpy model of the kernel's
lane-group walk against the plain version, and the encoders,
comparers and constraint parser of every scheme. Tolerance zero
everywhere."""

import importlib
import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tests.test_verscmp import _random_versions
from trivy_tpu.ops import verscmp as jax_verscmp
from trivy_tpu.version import encode as jax_encode
from trivy_tpu_torch.ops import verscmp, verscmp_cuda
from trivy_tpu_torch.version import encode as port_encode

# the modules (each package re-exports a function named ``compare``)
jax_compare = importlib.import_module("trivy_tpu.version.compare")
port_compare = importlib.import_module("trivy_tpu_torch.version.compare")

WIDTHS = (1, 8, 24, 40, 72)
SCHEMES = ("apk", "deb", "gem", "maven", "npm", "pep440", "rpm", "rubygems", "semver")


def rows_pair(L: int, n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """``n`` row pairs of width ``L`` and small values: a quarter equal, a
    quarter differing only at the first column and a quarter only at the
    last (each in both directions), the rest in a few random cells."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 3, (n, L), dtype=np.int32)
    b = a.copy()
    k = n // 4
    step = 1 + np.arange(k) % 2  # +1 or +2 mod 3: b above or below a
    b[k : 2 * k, 0] = (a[k : 2 * k, 0] + step) % 3
    b[2 * k : 3 * k, -1] = (a[2 * k : 3 * k, -1] + step) % 3
    mix = rng.random((n - 3 * k, L)) < 0.15
    b[3 * k :][mix] = rng.integers(0, 3, int(mix.sum()), dtype=np.int32)
    return a, b


def all_ops(n: int) -> np.ndarray:
    return (np.arange(n) % 6).astype(np.int32)


@pytest.mark.parametrize("L", WIDTHS)
def test_lexcmp_plain_equals_jax(L):
    a, b = rows_pair(L, 600, L)
    want = np.asarray(jax_verscmp._lexcmp(a, b))
    got = verscmp.lexcmp_plain(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert {-1, 0, 1} <= set(want.tolist())


@pytest.mark.parametrize("L", WIDTHS)
def test_check_ops_plain_equals_jax(L):
    a, b = rows_pair(L, 600, 100 + L)
    ops = all_ops(len(a))
    want = np.asarray(jax_verscmp._check_ops(a, b, ops))
    got = verscmp.check_ops_plain(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(ops))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("L", WIDTHS)
def test_check_ops_gather_plain_equals_jax(L):
    inst, bounds = rows_pair(L, 300, 200 + L)
    rng = np.random.default_rng(L)
    R = 1000
    a_idx = rng.integers(0, len(inst), R, dtype=np.int32)
    b_idx = np.where(rng.random(R) < 0.5, a_idx, rng.integers(0, len(bounds), R)).astype(np.int32)
    ops = all_ops(R)
    want = np.asarray(jax_verscmp._check_ops_gather(inst, bounds, a_idx, b_idx, ops))
    t = torch.from_numpy
    got = verscmp.check_ops_gather_plain(t(inst), t(bounds), t(a_idx), t(b_idx), t(ops))
    np.testing.assert_array_equal(got.numpy(), want)
    # the bucketed host wrapper: no padding, R verdicts, from the CPU wrapper
    got_b = verscmp.check_ops_gather_bucketed(inst, t(bounds), a_idx, b_idx, ops)
    assert got_b.shape == (R,) and got_b.dtype == np.bool_
    np.testing.assert_array_equal(got_b, want)
    np.testing.assert_array_equal(
        jax_verscmp.check_ops_gather_bucketed(inst, bounds, a_idx, b_idx, ops), want)


# the kernel's constants, read from its source so that the model follows it
KERNEL_SOURCE = (Path(verscmp_cuda.__file__).parent / "csrc" / "verscmp.cu").read_text()
MAX_GROUP = int(re.search(r"constexpr int kMaxGroup = (\d+);", KERNEL_SOURCE).group(1))
ROWS_PER_GROUP = int(re.search(r"constexpr int kRowsPerGroup = (\d+);", KERNEL_SOURCE).group(1))


def group_lanes(L: int, max_group: int = MAX_GROUP) -> int:
    """The kernel's lanes per row: the smallest power of two >= ceil(L / 4),
    at most ``max_group``."""
    g = 1
    while g < max_group and 4 * g < L:
        g *= 2
    return g


def kernel_model(inst, bounds, a_idx, b_idx, ops, U=ROWS_PER_GROUP, aligned=True, out_offset=0,
                 max_group=MAX_GROUP):
    """numpy model of ``csrc/verscmp.cu``'s walk: lane groups of G lanes
    (``group_lanes``), a warp's step of 32 / G * U contiguous rows with group
    g taking rows g U .. g U + U - 1, each lane loading 4 columns of each
    side (one int4 on the vector path, which needs L % 4 == 0 and
    ``aligned`` matrices; else 4 scalars, columns past L read as 0), the
    first differing lane from the group's segment of the ballot, rows wider
    than a chunk (4 G columns, G = ``max_group``) walking chunks in order
    while they are equal; verdicts and signs read out of per-u ballots, four
    verdicts to a word store where the output (``out_offset`` bytes past a
    4-byte boundary) is aligned and the rows are there, bytes otherwise.
    Indices and ops clamped; a null index (None) means row r itself.
    Returns (verdicts uint8, signs int32, {"word": n, "byte": n} verdict
    stores)."""
    R = len(ops)
    L = inst.shape[1]
    G = group_lanes(L, max_group)
    vec = L % 4 == 0 and aligned
    warp_rows = 32 // G * U
    lanes = np.arange(32)
    base = lanes & ~(G - 1)  # the lane's group's first lane
    verdict = np.zeros(R, np.uint8)
    sign = np.zeros(R, np.int32)
    stores = {"word": 0, "byte": 0}

    def cols(m, row, c):  # [32, 4]: the columns each lane loads from chunk c of its row
        j = c + 4 * (lanes % G)[:, None] + np.arange(4)
        live = (j[:, :1] < L) if vec else (j < L)
        live = live & (row >= 0)[:, None]
        return np.where(live, m[np.maximum(row, 0)[:, None], np.minimum(j, L - 1)], 0)

    def lane_sign(a, b):  # the sign at each lane's first differing column of its 4
        ne = a != b
        first = ne.argmax(axis=1)
        lt = a[lanes, first] < b[lanes, first]
        return np.where(ne.any(axis=1), np.where(lt, -1, 1), 0)

    def ballot(pred):
        return int((pred.astype(np.int64) << lanes).sum())

    def group_sign(ls):
        seg = (ballot(ls != 0) >> base) & ((1 << G) - 1)
        first = np.array([(int(x) & -int(x)).bit_length() - 1 if x else 0 for x in seg])
        return np.where(seg != 0, ls[base + first], 0)  # __shfl_sync(width G)

    def row_bit(m, k):  # row k of the step: group k // U's row k % U
        return (m[k % U] >> (G * (k // U))) & 1

    for w0 in range(0, R, warp_rows):  # each warp step (the grid only orders them)
        s = np.zeros((U, 32), np.int64)
        op = np.zeros((U, 32), np.int64)
        for u in range(U):
            r = w0 + lanes // G * U + u  # each lane's row
            live = r < R
            rc = np.minimum(r, R - 1)
            ai = r if a_idx is None else np.clip(a_idx[rc], 0, len(inst) - 1)
            bi = r if b_idx is None else np.clip(b_idx[rc], 0, len(bounds) - 1)
            ai, bi = np.where(live, ai, -1), np.where(live, bi, -1)
            op[u] = np.clip(ops[rc], 0, 5)
            s[u] = group_sign(lane_sign(cols(inst, ai, 0), cols(bounds, bi, 0)))
            for c in range(4 * G, L, 4 * G):  # G == max_group: the rows still equal
                open_ = (s[u] == 0) & (ai >= 0)
                if not open_.any():
                    break
                t = group_sign(lane_sign(cols(inst, np.where(open_, ai, -1), c),
                                         cols(bounds, np.where(open_, bi, -1), c)))
                s[u] = np.where(s[u] != 0, s[u], t)
        table = np.stack([s < 0, s <= 0, s > 0, s >= 0, s == 0, s != 0])
        v = [ballot(table[op[u], u, lanes]) for u in range(U)]
        neg = [ballot(s[u] < 0) for u in range(U)]
        pos = [ballot(s[u] > 0) for u in range(U)]
        for lane in range(32):
            k0, r = 4 * lane, w0 + 4 * lane
            if k0 < warp_rows and r < R:
                if warp_rows % 4 == 0 and r + 4 <= R and (out_offset + r) % 4 == 0:
                    stores["word"] += 1
                    verdict[r : r + 4] = [row_bit(v, k0 + j) for j in range(4)]
                else:
                    for j in range(4):
                        if k0 + j < warp_rows and r + j < R:
                            stores["byte"] += 1
                            verdict[r + j] = row_bit(v, k0 + j)
            for k in range(lane, warp_rows, 32):
                if w0 + k < R:
                    sign[w0 + k] = 1 if row_bit(pos, k) else (-1 if row_bit(neg, k) else 0)
    return verdict, sign, stores


@pytest.mark.parametrize("L", WIDTHS)
def test_kernel_model_equals_plain(L):
    inst, bounds = rows_pair(L, 120, 300 + L)
    rng = np.random.default_rng(7 + L)
    a_idx = rng.integers(0, len(inst), 240, dtype=np.int32)
    b_idx = rng.integers(0, len(bounds), 240, dtype=np.int32)
    ops = all_ops(240)
    t = torch.from_numpy
    v, _, _ = kernel_model(inst, bounds, a_idx, b_idx, ops)
    want = verscmp.check_ops_gather_plain(t(inst), t(bounds), t(a_idx), t(b_idx), t(ops))
    np.testing.assert_array_equal(v.astype(bool), want.numpy())
    # the null-index entry: lexcmp and check_ops
    v, s, _ = kernel_model(inst, bounds, None, None, all_ops(len(inst)))
    np.testing.assert_array_equal(s, verscmp.lexcmp_plain(t(inst), t(bounds)).numpy())
    np.testing.assert_array_equal(
        v.astype(bool), verscmp.check_ops_plain(t(inst), t(bounds), t(all_ops(len(inst)))).numpy())


EDGE_WIDTHS = (1, 3, 4, 5, 15, 16, 17, 128, 129, 200)


@pytest.mark.parametrize("L", EDGE_WIDTHS)
def test_kernel_model_edges_equal_plain(L):
    """Every lane-group width, chunked rows past 128 columns, row counts
    around one warp's step at L = 16 (8 U), one row, and the scalar path
    (a matrix off 16 bytes) beside the vector one; the verdict stores are
    words except in the ragged tail."""
    U = ROWS_PER_GROUP
    inst, bounds = rows_pair(L, 40, 400 + L)
    rng = np.random.default_rng(L)
    t = torch.from_numpy
    assert group_lanes(L) == min(MAX_GROUP, 1 << max(0, (-(-L // 4) - 1).bit_length()))
    for R in (1, 7, 8 * U - 1, 8 * U, 8 * U + 1):
        a_idx = rng.integers(0, len(inst), R, dtype=np.int32)
        b_idx = np.where(rng.random(R) < 0.3, a_idx, rng.integers(0, len(bounds), R))
        b_idx = b_idx.astype(np.int32)
        ops = all_ops(R)
        want = verscmp.check_ops_gather_plain(t(inst), t(bounds), t(a_idx), t(b_idx), t(ops))
        want_s = verscmp.lexcmp_plain(t(inst[a_idx]), t(bounds[b_idx])).numpy()
        for aligned in (True, False):
            v, s, stores = kernel_model(inst, bounds, a_idx, b_idx, ops, U, aligned)
            np.testing.assert_array_equal(v.astype(bool), want.numpy(), err_msg=f"R={R}")
            np.testing.assert_array_equal(s, want_s, err_msg=f"R={R}")
            warp_rows = 32 // group_lanes(L) * U
            full = (R // warp_rows) * warp_rows if warp_rows % 4 == 0 else 0
            tail = R - full
            assert stores == {"word": full // 4 + tail // 4, "byte": tail % 4}, (R, stores)
    # an output pointer off 4 bytes stores bytes only
    _, _, stores = kernel_model(inst, bounds, a_idx, b_idx, ops, U, True, out_offset=1)
    assert stores["byte"] == len(ops)


@settings(max_examples=60, deadline=None, derandomize=True)
@given(L=st.integers(1, 100), n=st.integers(1, 12), U=st.sampled_from([1, 2, 4]),
       aligned=st.booleans(), out_offset=st.integers(0, 3),
       max_group=st.sampled_from([8, 16, 32]), data=st.data())
def test_kernel_model_property(L, n, U, aligned, out_offset, max_group, data):
    vals = st.integers(0, 3)
    inst = np.array(data.draw(st.lists(st.lists(vals, min_size=L, max_size=L), min_size=n,
                                       max_size=n)), np.int32)
    bounds = inst.copy()
    for i in range(n):  # change a few cells, anywhere in the row
        for _ in range(data.draw(st.integers(0, 2))):
            bounds[i, data.draw(st.integers(0, L - 1))] = data.draw(vals)
    R = data.draw(st.integers(1, 40))
    a_idx = np.array(data.draw(st.lists(st.integers(0, n - 1), min_size=R, max_size=R)), np.int32)
    b_idx = np.array(data.draw(st.lists(st.integers(0, n - 1), min_size=R, max_size=R)), np.int32)
    ops = np.array(data.draw(st.lists(st.integers(0, 5), min_size=R, max_size=R)), np.int32)
    t = torch.from_numpy
    v, s, _ = kernel_model(inst, bounds, a_idx, b_idx, ops, U, aligned, out_offset, max_group)
    want = verscmp.check_ops_gather_plain(t(inst), t(bounds), t(a_idx), t(b_idx), t(ops))
    np.testing.assert_array_equal(v.astype(bool), want.numpy())
    np.testing.assert_array_equal(s, verscmp.lexcmp_plain(t(inst[a_idx]), t(bounds[b_idx])).numpy())


def test_dispatch_stage_views_fill_one_buffer_reused_across_dispatches():
    """The dispatch's arrays are views of one buffer (each part on 128
    bytes), built into in place and dispatched without a copy; a smaller
    dispatch reuses the buffer, a larger one grows it; arrays from
    elsewhere go through the same views. On the CPU nothing is pinned."""
    inst, bounds = rows_pair(16, 50, 11)
    rng = np.random.default_rng(11)
    t = torch.from_numpy
    stage = verscmp.DispatchStage(torch.device("cpu"))
    assert not stage.host.is_pinned()
    for R, n_inst, grows in ((300, 50, True), (70, 20, False), (1000, 50, True)):
        before = stage.host.data_ptr()
        views = stage.views(R, n_inst, 16)
        inst_v, a_v, b_v, ops_v = views
        assert [v.shape for v in views] == [(n_inst, 16), (R,), (R,), (R,)]
        host = stage.host.numpy()
        assert all(v.dtype == np.int32 and np.shares_memory(v, host) for v in views)
        assert all((v.ctypes.data - host.ctypes.data) % 128 == 0 for v in views)
        assert (stage.host.data_ptr() != before) == grows  # grows only when needed
        inst_v[:] = inst[:n_inst]
        a_v[:] = rng.integers(0, n_inst, R)
        b_v[:] = rng.integers(0, len(bounds), R)
        ops_v[:] = all_ops(R)
        want = jax_verscmp._check_ops_gather(inst[:n_inst], bounds, a_v, b_v, ops_v)
        got = verscmp.check_ops_gather_bucketed(inst_v, t(bounds), a_v, b_v, ops_v, stage=stage)
        np.testing.assert_array_equal(got, np.asarray(want))
        # the same arrays from outside the stage, in another integer type
        copies = [x.astype(np.int64) for x in (inst_v, a_v, b_v, ops_v)]
        np.testing.assert_array_equal(
            verscmp.check_ops_gather_bucketed(copies[0], t(bounds), *copies[1:]), got)


def test_wrappers_run_the_plain_version_on_the_cpu_and_check_their_inputs():
    inst, bounds = rows_pair(24, 60, 5)
    t = torch.from_numpy
    idx = t(np.arange(60, dtype=np.int32))
    ops = t(all_ops(60))
    before = dict(verscmp_cuda.LAUNCHES)
    assert torch.equal(verscmp_cuda.check_ops_gather(t(inst), t(bounds), idx, idx, ops),
                       verscmp.check_ops_plain(t(inst), t(bounds), ops))
    assert torch.equal(verscmp_cuda.check_ops(t(inst), t(bounds), ops),
                       verscmp.check_ops_plain(t(inst), t(bounds), ops))
    assert torch.equal(verscmp_cuda.lexcmp(t(inst), t(bounds)),
                       verscmp.lexcmp_plain(t(inst), t(bounds)))
    assert dict(verscmp_cuda.LAUNCHES) == before  # the CPU launches nothing
    with pytest.raises(ValueError, match="int32"):
        verscmp_cuda.check_ops_gather(t(inst).long(), t(bounds), idx, idx, ops)
    with pytest.raises(ValueError, match="int32"):
        verscmp_cuda.check_ops_gather(t(inst), t(bounds), idx.long(), idx, ops)
    with pytest.raises(ValueError, match="widths"):
        verscmp_cuda.check_ops(t(inst), t(bounds[:, :8].copy()), ops)
    with pytest.raises(ValueError, match="rows"):
        verscmp_cuda.check_ops_gather(t(inst), t(bounds), idx, idx[:5], ops)
    with pytest.raises(ValueError, match="device"):
        verscmp_cuda.lexcmp(t(inst).to("meta"), t(bounds).to("meta"))


@pytest.mark.parametrize("scheme", sorted(jax_encode.ENCODABLE))
def test_batch_compare_equals_jax(scheme):
    rng = random.Random(len(scheme) * 7919)
    versions = _random_versions(scheme, rng, 80)
    pairs = [(rng.choice(versions), rng.choice(versions)) for _ in range(300)]
    pairs += [(v, v) for v in versions[:10]]
    want = jax_verscmp.batch_compare(scheme, pairs)
    got = verscmp.batch_compare(scheme, pairs, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert verscmp.batch_compare("maven", pairs[:3], device="cpu") is None


def scheme_versions(scheme: str, rng: random.Random, n: int) -> list[str]:
    """Seeded versions for ``scheme``: the JAX tests' generator for the
    encodable schemes, and PEP 440, Maven and RubyGems forms for the
    others (with a few strings no scheme parses)."""
    if scheme in jax_encode.ENCODABLE:
        return _random_versions(scheme, rng, n)
    out = []
    for _ in range(n):
        v = ".".join(str(rng.randint(0, 12)) for _ in range(rng.randint(1, 4)))
        if scheme == "pep440":
            v += rng.choice(["", "", "a1", "b2", "rc1", ".post1", ".dev3", "+local.1"])
        elif scheme == "maven":
            v += rng.choice(["", "", "-SNAPSHOT", "-alpha-1", "-RC2", ".Final", "-sp1", "-beta"])
        else:
            v += rng.choice(["", "", ".pre", ".rc1", ".beta.2", "a"])
        out.append(v)
    return out + ["", "not a version", "1..2", "v1.2"]


@pytest.mark.parametrize("scheme", SCHEMES)
def test_version_schemes_equal_jax(scheme):
    rng = random.Random(sum(map(ord, scheme)))
    versions = scheme_versions(scheme, rng, 100)
    pairs = [(rng.choice(versions), rng.choice(versions)) for _ in range(400)]
    for a, b in pairs:
        assert port_compare.compare(scheme, a, b) == jax_compare.compare(scheme, a, b), (a, b)
    for v in versions:
        assert port_encode.encode(scheme, v) == jax_encode.encode(scheme, v), v
    exprs = [f"{op}{v}" for op in ("<", "<=", ">", ">=", "=", "!=", "^", "~", "~>", "")
             for v in versions[:12]]
    exprs += [f">={a}, <{b}" for a, b in pairs[:40]] + [f"<{a} || >{b}" for a, b in pairs[40:60]]
    exprs += ["*", "", ">= , <", "garbage ~~ 1"]
    for e in exprs:
        assert (port_compare.parse_constraints(e)
                == [[port_compare.Constraint(c.op, c.version) for c in g]
                    for g in jax_compare.parse_constraints(e)]), e
        for v in versions[:25]:
            assert port_compare.satisfies(scheme, v, e) == jax_compare.satisfies(scheme, v, e)
    assert port_encode.pad_value(scheme) == jax_encode.pad_value(scheme)
    assert port_encode.ENCODABLE == jax_encode.ENCODABLE


def test_encode_batch_equals_jax():
    rng = random.Random(4)
    for scheme in sorted(jax_encode.ENCODABLE):
        versions = _random_versions(scheme, rng, 50)
        np.testing.assert_array_equal(port_encode.encode_batch(scheme, versions),
                                      jax_encode.encode_batch(scheme, versions))
        assert port_encode.encode_batch(scheme, versions, length=2) is None
