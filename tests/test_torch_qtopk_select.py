"""The CPU model of the card's qtopk selection (``ref.qtopk_select_ref``:
composite keys, 8-bit radix thresholds per tile, compaction, the per-row
second selection, the closed-form pad columns) against the reference
kernel's blocked selection (``ref.qtopk_blocked``, the CPU path of
``ops.qtopk``) and, at k <= 64, the JAX package's ``ops.qtopk``, bit for
bit. ``tile`` is the kernel's phase-1 width (4096); smaller tiles reach
the second selection on short rows."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import repro  # noqa: E402,F401
from repro.kernels.qtopk import ops as jqtopk  # noqa: E402
from repro_torch.kernels.qtopk import ops as tqtopk  # noqa: E402
from repro_torch.kernels.qtopk import ref  # noqa: E402

from _torch_parity import np_  # noqa: E402
from test_torch_kernels import QTOPK_CASES  # noqa: E402

I64_MIN, I64_MAX, INF = -(1 << 63), (1 << 63) - 1, 1 << 62


def _check(s, keys, k, tile=ref.TILE, jax_too=False):
    """The model equals the blocked selection (and JAX's ops.qtopk)."""
    st_, kt_ = torch.from_numpy(s), torch.from_numpy(keys)
    bn = tqtopk.block_n(s.shape[1])
    got = ref.qtopk_select_ref(st_, kt_, k, bn, tile=tile)
    want = ref.qtopk_blocked(st_, kt_, k, bn)
    assert got[0].shape == want[0].shape == (s.shape[0], ref.qtopk_width(
        s.shape[1], k, bn))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if jax_too:
        for g, w in zip(got, jqtopk.qtopk(jnp.asarray(s), jnp.asarray(keys), k)):
            assert np.array_equal(np_(g), np.asarray(w))


@pytest.mark.parametrize("tile", [ref.TILE, 64])
@pytest.mark.parametrize("nq,n,k", QTOPK_CASES)
def test_select_model_matches_on_the_kernel_cases(nq, n, k, tile):
    rng = np.random.default_rng(nq * 7 + n + k)
    s = rng.integers(-2**45, 2**45, size=(nq, n)).astype(np.int64)
    s[:, ::5] = 0  # ties
    _check(s, rng.permutation(n).astype(np.int32), k, tile,
           jax_too=tile == ref.TILE)


@pytest.mark.parametrize("nq,n,k", [(2, 1030, 1040), (2, 2100, 3000),
                                    (1, 1500, 1501), (3, 1025, 2100)])
def test_select_model_writes_the_reference_pad_columns(nq, n, k):
    """k > n >= 1024, n % 1024 != 0: the reference's width exceeds n, and
    its last columns are (INT64_MAX, smallest key of the last block)."""
    rng = np.random.default_rng(n + k)
    s = rng.integers(-2**40, 2**40, size=(nq, n)).astype(np.int64)
    keys = rng.permutation(n).astype(np.int32) - 500  # negative keys too
    _check(s, keys, k)
    bn = tqtopk.block_n(n)
    w = ref.qtopk_width(n, k, bn)
    assert w > n
    got_s, got_k = ref.qtopk_select_ref(torch.from_numpy(s),
                                        torch.from_numpy(keys), k, bn)
    assert (got_s[:, n:] == I64_MAX).all()
    assert (got_k[:, n:] == int(keys[(-(-n // bn) - 1) * bn:].min())).all()


@pytest.mark.parametrize("tile,n,k", [
    (64, 300, 1), (64, 300, 300), (64, 300, 63), (64, 300, 64), (64, 300, 65),
    (ref.TILE, 4200, 1), (ref.TILE, 4200, 4095), (ref.TILE, 4200, 4096),
    (ref.TILE, 4200, 4097), (ref.TILE, 4096, 4096), (ref.TILE, 4097, 10)])
def test_select_model_at_k_one_n_and_the_tile_width(tile, n, k):
    rng = np.random.default_rng(n * 3 + k)
    s = rng.integers(0, 2**35, size=(2, n)).astype(np.int64)
    _check(s, rng.permutation(n).astype(np.int32), k, tile)


@pytest.mark.parametrize("tile", [ref.TILE, 64])
def test_select_model_on_rows_that_stress_the_digits(tile):
    rng = np.random.default_rng(5)
    n = 5000
    rev = np.arange(n, dtype=np.int32)[::-1].copy()
    # all-equal scores, reversed keys: the keys decide
    for k in (5, 300):
        _check(np.zeros((2, n), np.int64), rev, k, tile)
    keys = rng.permutation(n).astype(np.int32)
    # every score INF but a few live ones
    s = np.full((3, n), INF, np.int64)
    for r in range(3):
        s[r, rng.choice(n, 7, replace=False)] = rng.integers(0, 2**40, 7)
    for k in (1, 16, 300):
        _check(s, keys, k, tile)
    # the extremes, INT64_MIN + 1 and 2^62 among them
    s = rng.choice(np.array([I64_MIN + 1, I64_MIN + 2, -1, 0, 1, INF,
                             I64_MAX - 1]), size=(3, n))
    for k in (1, 16, 300):
        _check(s, keys, k, tile)
    # scores that share their top 40 bits
    s = (0x5A5A5A5A5A << 24) + rng.integers(0, 2**24, size=(3, n))
    for k in (1, 16, 300):
        _check(s, keys, k, tile)


def test_select_model_matches_jax_on_stressed_rows():
    rng = np.random.default_rng(6)
    n = 1500
    keys = rng.permutation(n).astype(np.int32)
    s = np.full((2, n), INF, np.int64)
    s[:, rng.choice(n, 40, replace=False)] = rng.integers(-2**40, 2**40, 40)
    s[1, ::3] = I64_MIN + 1
    _check(s, keys, 64, jax_too=True)
    _check(np.zeros((2, n), np.int64), keys, 33, tile=64, jax_too=True)


@settings(max_examples=40, deadline=None)
@given(nq=st.integers(1, 3), n=st.integers(1, 300), extra=st.integers(-300, 40),
       bits=st.sampled_from([0, 3, 20, 45, 62]), signed=st.booleans(),
       tile=st.sampled_from([16, 64, ref.TILE]), seed=st.integers(0, 2**32 - 1))
def test_select_model_property(nq, n, extra, bits, signed, tile, seed):
    """Any row length, k (below, at and above n), score range and tile."""
    rng = np.random.default_rng(seed)
    k = max(1, n + extra)
    lo = -(1 << bits) if signed else 0
    s = rng.integers(lo, (1 << bits) + 1, size=(nq, n), dtype=np.int64)
    keys = rng.choice(np.arange(-(1 << 31), (1 << 31) - 1, 9973), n,
                      replace=False).astype(np.int32)
    _check(s, keys, k, tile)


def test_select_helpers_match_integer_arithmetic():
    """The composite-key helpers (each the twin of a device function of
    csrc/qtopk.cu) against Python's integers, at every shift."""
    rng = np.random.default_rng(7)
    s = np.concatenate([rng.integers(I64_MIN, I64_MAX, 200, dtype=np.int64),
                        [I64_MIN, I64_MAX, 0, -1]])
    k = rng.integers(-(1 << 31), (1 << 31) - 1, s.size).astype(np.int32)
    xh = torch.from_numpy(s) ^ I64_MIN
    xl = (torch.from_numpy(k).to(torch.int64) ^ 0x80000000) & ref.M32
    full = [((int(a) + (1 << 63)) << 32) | ((int(b) + (1 << 31)))
            for a, b in zip(s, k)]  # unsigned order == (score, key) order
    assert sorted(range(s.size), key=lambda i: full[i]) == \
        sorted(range(s.size), key=lambda i: (int(s[i]), int(k[i])))
    for sh in range(89):
        sv = torch.full((s.size,), sh, dtype=torch.int64)
        assert ref.digit(xh, xl, sv).tolist() == [(f >> sh) & 0xFF
                                                  for f in full]
        b = torch.arange(s.size, dtype=torch.int64) % 256
        h, lo_ = ref.shl_digit(b, sv)
        assert [((int(a) & ((1 << 64) - 1)) << 32) | int(c)
                for a, c in zip(h, lo_)] == [int(v) << sh for v in b]
    for m in range(97):
        h, lo_ = ref.ones(torch.tensor([m]))
        assert ((int(h) & ((1 << 64) - 1)) << 32) | int(lo_) == (1 << m) - 1
    tops = ref.top_bit(xh, xl).tolist()
    assert tops == [f.bit_length() - 1 for f in full]
    assert ref.top_bit(torch.tensor([0]), torch.tensor([0])).tolist() == [-1]
    le = ref.key_le(xh[:-1], xl[:-1], xh[1:], xl[1:]).tolist()
    assert le == [a <= b for a, b in zip(full[:-1], full[1:])]
