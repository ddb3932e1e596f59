"""The port's version schemes and version-constraint check against the JAX
package: the plain versions of ``csrc/verscmp.cu`` against ``_lexcmp``,
``_check_ops`` and ``_check_ops_gather``, a numpy model of the kernel's
warp-ballot formulation against the plain version, and the encoders,
comparers and constraint parser of every scheme. Tolerance zero
everywhere."""

import importlib
import random

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


def kernel_model(inst, bounds, a_idx, b_idx, ops):
    """numpy model of ``csrc/verscmp.cu``: one warp per row, lanes reading
    32-column chunks, ``__ballot_sync(a != b)`` and ``__ffs`` for the first
    differing lane, the chunks walked in order until one differs; indices
    and ops clamped. Returns (verdicts uint8, signs int32); a null index
    (None) means row r itself."""
    R = len(ops)
    L = inst.shape[1]
    lanes = np.arange(32)
    verdict = np.zeros(R, np.uint8)
    sign = np.zeros(R, np.int32)
    for r in range(R):
        ai = r if a_idx is None else int(np.clip(a_idx[r], 0, len(inst) - 1))
        bi = r if b_idx is None else int(np.clip(b_idx[r], 0, len(bounds) - 1))
        s = 0
        for c in range(0, L, 32):
            j = c + lanes
            live = j < L
            av = np.where(live, inst[ai, np.minimum(j, L - 1)], 0)
            bv = np.where(live, bounds[bi, np.minimum(j, L - 1)], 0)
            ballot = int(((av != bv).astype(np.int64) << lanes).sum())
            if ballot:
                first = (ballot & -ballot).bit_length() - 1  # __ffs(ballot) - 1
                s = -1 if av[first] < bv[first] else 1
                break
        sign[r] = s
        op = min(max(int(ops[r]), 0), 5)
        verdict[r] = (s < 0, s <= 0, s > 0, s >= 0, s == 0, s != 0)[op]
    return verdict, sign


@pytest.mark.parametrize("L", WIDTHS)
def test_kernel_model_equals_plain(L):
    inst, bounds = rows_pair(L, 120, 300 + L)
    rng = np.random.default_rng(7 + L)
    a_idx = rng.integers(0, len(inst), 240, dtype=np.int32)
    b_idx = rng.integers(0, len(bounds), 240, dtype=np.int32)
    ops = all_ops(240)
    t = torch.from_numpy
    v, _ = kernel_model(inst, bounds, a_idx, b_idx, ops)
    want = verscmp.check_ops_gather_plain(t(inst), t(bounds), t(a_idx), t(b_idx), t(ops))
    np.testing.assert_array_equal(v.astype(bool), want.numpy())
    # the null-index entry: lexcmp and check_ops
    v, s = kernel_model(inst, bounds, None, None, all_ops(len(inst)))
    np.testing.assert_array_equal(s, verscmp.lexcmp_plain(t(inst), t(bounds)).numpy())
    np.testing.assert_array_equal(
        v.astype(bool), verscmp.check_ops_plain(t(inst), t(bounds), t(all_ops(len(inst)))).numpy())


@settings(max_examples=60, deadline=None, derandomize=True)
@given(L=st.integers(1, 100), n=st.integers(1, 12), data=st.data())
def test_kernel_model_property(L, n, data):
    vals = st.integers(0, 3)
    inst = np.array(data.draw(st.lists(st.lists(vals, min_size=L, max_size=L), min_size=n,
                                       max_size=n)), np.int32)
    bounds = inst.copy()
    for i in range(n):  # change a few cells, anywhere in the row
        for _ in range(data.draw(st.integers(0, 2))):
            bounds[i, data.draw(st.integers(0, L - 1))] = data.draw(vals)
    R = data.draw(st.integers(1, 24))
    a_idx = np.array(data.draw(st.lists(st.integers(0, n - 1), min_size=R, max_size=R)), np.int32)
    b_idx = np.array(data.draw(st.lists(st.integers(0, n - 1), min_size=R, max_size=R)), np.int32)
    ops = np.array(data.draw(st.lists(st.integers(0, 5), min_size=R, max_size=R)), np.int32)
    t = torch.from_numpy
    v, _ = kernel_model(inst, bounds, a_idx, b_idx, ops)
    want = verscmp.check_ops_gather_plain(t(inst), t(bounds), t(a_idx), t(b_idx), t(ops))
    np.testing.assert_array_equal(v.astype(bool), want.numpy())


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
