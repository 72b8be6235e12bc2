"""The port's 128-bit limbs and fixed-point arithmetic == the reference's,
bit for bit, on random and edge values (±2^63, saturation bounds), and the
properties ``tests/test_limbs.py`` / ``tests/test_fixedpoint.py`` check on
the reference hold in the port."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402,F401
from repro.core import contracts as jcontracts  # noqa: E402
from repro.core import fixedpoint as jfp  # noqa: E402
from repro.core import limbs as jl  # noqa: E402
from repro_torch.core import contracts as tcontracts  # noqa: E402
from repro_torch.core import fixedpoint as tfp  # noqa: E402
from repro_torch.core import limbs as tl  # noqa: E402

from _torch_parity import np_  # noqa: E402

I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1
EDGES = [0, 1, -1, 2, -2, 1 << 31, -(1 << 31), (1 << 32) - 1, 1 << 32,
         -(1 << 32), (1 << 33), -(1 << 33), (1 << 62) - 1, -(1 << 62),
         I64_MAX, I64_MIN, I64_MAX - 1, I64_MIN + 1]


def _i64(seed, n, scale=63):
    """n int64 values: uniform over ±2^scale, with the edges first."""
    rng = np.random.default_rng(seed)
    lo = max(-(1 << scale), I64_MIN)
    hi = min(1 << scale, I64_MAX)
    x = rng.integers(lo, hi, size=n, dtype=np.int64, endpoint=True)
    edges = np.asarray([e for e in EDGES if lo <= e <= hi], np.int64)
    x[:min(n, len(edges))] = edges[:n]
    return x


def _wide_eq(jw, tw):
    for j, t in zip(jw, tw):
        assert np.array_equal(np.asarray(j).astype(np.int64), np_(t))


# --------------------------------------------------------------------------- #
# limbs
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("seed", range(3))
def test_limb_primitives_bitwise(seed):
    a, b = _i64(seed, 64), _i64(seed + 10, 64)[::-1].copy()
    ja, jb_ = jnp.asarray(a), jnp.asarray(b)
    ta, tb_ = torch.from_numpy(a), torch.from_numpy(b)
    _wide_eq(jl.from_int64(ja), tl.from_int64(ta))
    _wide_eq(jl.mul_i64_i64(ja, jb_), tl.mul_i64_i64(ta, tb_))
    jw, tw = jl.from_int64(ja), tl.from_int64(ta)
    _wide_eq(jl.wide_neg(jw), tl.wide_neg(tw))
    _wide_eq(jl.wide_add(jw, jl.from_int64(jb_)),
             tl.wide_add(tw, tl.from_int64(tb_)))
    prods_j, prods_t = jl.mul_i64_i64(ja, jb_), tl.mul_i64_i64(ta, tb_)
    assert np.array_equal(np.asarray(jl.to_float(prods_j)),
                          np_(tl.to_float(prods_t)))
    for i in range(len(a)):
        assert tl.to_python_int(tuple(x[i] for x in prods_t)) == \
            int(a[i]) * int(b[i])
    _wide_eq(jl.zeros_like_wide(ja), tl.zeros_like_wide(ta))


@pytest.mark.parametrize("scale,n", [(33, 64), (33, 1), (62, 4), (63, 2)])
def test_qdot_q32_wide_and_renormalize_bitwise(scale, n):
    """Contract-realistic Q32.32 raws (|raw| <= 2^33) over many elements,
    and the full int64 range where the exact sum still fits 128 bits."""
    for seed in range(4):
        a, b = _i64(seed, n, scale), _i64(seed + 7, n, scale)
        ja, jb_ = jnp.asarray(a), jnp.asarray(b)
        ta, tb_ = torch.from_numpy(a), torch.from_numpy(b)
        tw = tl.qdot_q32_wide(ta, tb_)
        _wide_eq(jl.qdot_q32_wide(ja, jb_), tw)
        assert tl.to_python_int(tw) == sum(int(x) * int(y)
                                           for x, y in zip(a, b))
        assert int(tl.q32_dot_to_q32(ta, tb_)) == \
            int(jl.q32_dot_to_q32(ja, jb_))


def test_limbs_2d_sum_axis_and_order_invariance():
    a = _i64(5, 6 * 16, 33).reshape(6, 16)
    ta = torch.from_numpy(a)
    for axis in (0, 1, -1):
        _wide_eq(jl.qdot_q32_wide(jnp.asarray(a), jnp.asarray(a), axis),
                 tl.qdot_q32_wide(ta, ta, axis))
    perm = torch.from_numpy(np.random.default_rng(0).permutation(16))
    _wide_eq(tl.qdot_q32_wide(ta, ta), tl.qdot_q32_wide(ta[:, perm],
                                                        ta[:, perm]))


def test_q32_renormalize_and_saturate():
    one = 1 << 32
    a = torch.tensor([one, one // 2], dtype=torch.int64)
    assert int(tl.q32_dot_to_q32(a, a)) == (one * one + (one // 2) ** 2) >> 32
    big = torch.full((4,), (1 << 62) - 1, dtype=torch.int64)
    neg = torch.full((4,), -(1 << 62), dtype=torch.int64)
    assert int(tl.q32_dot_to_q32(big, big)) == I64_MAX
    assert int(tl.q32_dot_to_q32(neg, big)) == I64_MIN
    z = tl.wide_add(tl.from_int64(a), tl.wide_neg(tl.from_int64(a)))
    assert tl.to_python_int(tuple(x[0] for x in z)) == 0


# --------------------------------------------------------------------------- #
# fixed-point arithmetic
# --------------------------------------------------------------------------- #

NARROW = ["Q8.8", "Q16.16", "Q2.13"]
ALL = sorted(jcontracts.CONTRACTS)


def _raws(name, seed, n=96):
    """Storage-dtype raws of a contract: random, then the saturation
    bounds, zero, ±1 and the storage type's own extremes."""
    c = tcontracts.CONTRACTS[name]
    dt = c.np_storage_dtype
    info = np.iinfo(dt)
    rng = np.random.default_rng(seed)
    x = rng.integers(info.min, info.max, size=n, dtype=dt, endpoint=True)
    edges = [c.min_raw, c.max_raw, 0, 1, -1, info.min, info.max,
             c.one, -c.one, c.one // 2]
    x[:len(edges)] = np.asarray(edges).astype(dt)
    return x


def _pair(name, seed):
    a, b = _raws(name, seed), _raws(name, seed + 100)[::-1].copy()
    b[:3] = 0  # division by zero saturates
    return a, b


@pytest.mark.parametrize("name", ALL)
def test_elementwise_ops_bitwise(name):
    jc, tc = jcontracts.CONTRACTS[name], tcontracts.CONTRACTS[name]
    for seed in range(3):
        a, b = _pair(name, seed)
        ja, jb_ = jnp.asarray(a), jnp.asarray(b)
        ta, tb_ = torch.from_numpy(a), torch.from_numpy(b)
        cases = [("qadd", (ja, jb_), (ta, tb_)), ("qsub", (ja, jb_), (ta, tb_)),
                 ("qneg", (ja,), (ta,)), ("qdiv", (ja, jb_), (ta, tb_))]
        if name != "Q32.32":
            cases.append(("qmul", (ja, jb_), (ta, tb_)))
        for fn, jargs, targs in cases:
            want = np.asarray(getattr(jfp, fn)(*jargs, contract=jc))
            got = np_(getattr(tfp, fn)(*targs, contract=tc))
            assert got.dtype == want.dtype, fn
            assert np.array_equal(got, want), (fn, seed)
        assert np.array_equal(np_(tfp.decode_f32(ta, tc)),
                              np.asarray(jfp.decode_f32(ja, jc)))
        assert np.array_equal(np_(tfp.decode(ta, tc)),
                              np.asarray(jfp.decode(ja, jc)))


@pytest.mark.parametrize("name", ALL)
def test_reductions_bitwise(name):
    jc, tc = jcontracts.CONTRACTS[name], tcontracts.CONTRACTS[name]
    a = _raws(name, 3, 96).reshape(8, 12)
    b = _raws(name, 4, 96).reshape(8, 12)
    ja, jb_ = jnp.asarray(a), jnp.asarray(b)
    ta, tb_ = torch.from_numpy(a), torch.from_numpy(b)
    for axis in (None, 0, 1):
        for fn in ("qsum", "qmean"):
            want = np.asarray(getattr(jfp, fn)(ja, axis=axis, contract=jc))
            got = np_(getattr(tfp, fn)(ta, axis=axis, contract=tc))
            assert got.dtype == want.dtype and np.array_equal(got, want), \
                (fn, axis)
    for axis in (0, 1, -1):
        want = np.asarray(jfp.ql2sq_wide(ja, jb_, axis, contract=jc))
        got = np_(tfp.ql2sq_wide(ta, tb_, axis, contract=tc))
        assert got.dtype == want.dtype and np.array_equal(got, want)
        if name == "Q32.32":
            with pytest.raises(NotImplementedError):
                tfp.qdot(ta, tb_, axis, contract=tc)
            with pytest.raises(NotImplementedError):
                tfp.qdot_wide(ta, tb_, axis, contract=tc)
            continue
        for fn in ("qdot", "qdot_wide"):
            want = np.asarray(getattr(jfp, fn)(ja, jb_, axis, contract=jc))
            got = np_(getattr(tfp, fn)(ta, tb_, axis, contract=tc))
            assert got.dtype == want.dtype and np.array_equal(got, want), fn


def test_q32_limb_paths_bitwise():
    a = _i64(8, 60, 40).reshape(5, 12)
    b = _i64(9, 60, 40).reshape(5, 12)
    a[0, :4] = [I64_MAX, I64_MIN, I64_MAX, I64_MIN]
    b[0, :4] = [I64_MAX, I64_MAX, I64_MIN, I64_MIN]
    ja, jb_ = jnp.asarray(a), jnp.asarray(b)
    ta, tb_ = torch.from_numpy(a), torch.from_numpy(b)
    assert np.array_equal(np_(tfp.qmul_q32(ta, tb_)),
                          np.asarray(jfp.qmul_q32(ja, jb_)))
    for axis in (0, 1, -1):
        assert np.array_equal(np_(tfp.qdot_q32(ta, tb_, axis)),
                              np.asarray(jfp.qdot_q32(ja, jb_, axis)))


def test_q32_generic_path_refuses_but_limb_path_works():
    q32 = tcontracts.Q32_32
    raw = tfp.encode(np.float64(0.5), q32)
    with pytest.raises(NotImplementedError):
        tfp.qmul(raw, raw, q32)
    assert int(tfp.qadd(raw, raw, q32)) == 2 * int(raw)
    assert int(tfp.qmul_q32(raw, raw)) == 1 << 30
    v = tfp.encode(np.asarray([0.5, -0.25, 0.125]), q32)
    want = int(round((0.25 + 0.0625 + 0.015625) * (1 << 32)))
    assert abs(int(tfp.qdot_q32(v, v)) - want) <= 1


@pytest.mark.parametrize("name", NARROW)
def test_properties_hold_in_the_port(name):
    """The reference's §5.1 properties, on the port: order-invariant sums
    and dot products, saturation inside the range, exact isqrt, unit
    length after qnorm, bounded encode/decode error."""
    c = tcontracts.CONTRACTS[name]
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, 64)
    raw = tfp.encode(x, c)
    assert int(tfp.qdot_wide(raw, raw, contract=c)) == \
        int(tfp.qdot_wide(raw.flip(0), raw.flip(0), contract=c))
    s = tfp.qadd(tfp.encode(np.float64(200), c), tfp.encode(np.float64(150),
                                                            c), c)
    assert c.min_raw <= int(s) <= c.max_raw
    back = np_(tfp.decode(tfp.encode(x * 3, c), c))
    assert np.all(np.abs(back - np.clip(x * 3, c.min_value, c.max_value))
                  <= c.resolution)
    n = rng.integers(0, (1 << 62) - 1, size=200, dtype=np.int64)
    r = np_(tfp.isqrt(torch.from_numpy(n)))
    assert all(int(ri) == math.isqrt(int(ni)) for ri, ni in zip(r, n))
    if name == "Q16.16":
        u = tfp.decode(tfp.qnorm(tfp.encode(x * 5, c), contract=c), c)
        assert abs(float(u @ u) - 1.0) < 1e-3
