"""The CPU models of the card kernels' limb arithmetic
(``qgemm_limbs_ref``, ``qcoarse_limbs_ref``: the same splits, shift
groups, per-stage decisions and int32 group sums as ``csrc/qgemm.cu`` and
``csrc/qcoarse.cu``; qgemm's stages with a value beyond +-2^23 are exact
int64 sums there and here) against the int64 product and against the reference
package's kernels (Pallas in interpret mode, as tests/test_kernels.py runs
them, within their range contract; its int64 oracle beyond it)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402,F401
from repro.kernels.qcoarse import ops as jqcoarse  # noqa: E402
from repro.kernels.qcoarse import ref as jqcoarse_ref  # noqa: E402
from repro.kernels.qgemm import ops as jqgemm  # noqa: E402
from repro.kernels.qgemm import ref as jqgemm_ref  # noqa: E402
from repro_torch.kernels.qcoarse import ref as tqcoarse_ref  # noqa: E402
from repro_torch.kernels.qgemm import ref as tqgemm_ref  # noqa: E402

from _pbt import given, settings  # noqa: E402
from _pbt import strategies as st  # noqa: E402
from _torch_parity import np_  # noqa: E402

RAW = 1 << 16
I32 = np.iinfo(np.int32)


def _int64(q, db):
    return q.astype(np.int64) @ db.astype(np.int64).T  # wraps as int64 does


def _qgemm_model(q, db):
    return np_(tqgemm_ref.qgemm_limbs_ref(torch.from_numpy(q),
                                          torch.from_numpy(db)))


@pytest.mark.parametrize("nq,nn,d", [(1, 1, 8), (4, 16, 32), (7, 100, 130),
                                     (70, 130, 200), (3, 33, 8192)])
def test_qgemm_model_random_rows(nq, nn, d):
    """Normalized rows (|raw| <= 2^16): the reference kernel's contract."""
    rng = np.random.default_rng(nq * 1000 + d)
    q = rng.integers(-RAW, RAW + 1, (nq, d)).astype(np.int32)
    db = rng.integers(-RAW, RAW + 1, (nn, d)).astype(np.int32)
    got = _qgemm_model(q, db)
    assert np.array_equal(got, _int64(q, db))
    assert np.array_equal(got, np.asarray(jqgemm.qgemm(jnp.asarray(q),
                                                       jnp.asarray(db))))


EXTREMES = [RAW, -RAW, (1 << 23) - 1, -(1 << 23) + 1, 1 << 23, -(1 << 23),
            I32.max, I32.min]


@pytest.mark.parametrize("value", EXTREMES)
def test_qgemm_model_extreme_rows_in_some_tiles(value):
    """One extreme value in some (64-row tile, 64-deep stage) pairs and
    not others, so that limb products and exact int64 stage sums meet in
    one product."""
    rng = np.random.default_rng(abs(value) % 9973)
    q = rng.integers(-RAW, RAW + 1, (70, 200)).astype(np.int32)
    db = rng.integers(-RAW, RAW + 1, (130, 200)).astype(np.int32)
    q[3, 70] = value           # query tile 0, stage 1
    db[129, 150] = value       # row tile 2, stage 2
    db[7, 5] = -value if value != I32.min else I32.max  # row tile 0, stage 0
    got = _qgemm_model(q, db)
    assert np.array_equal(got, _int64(q, db))
    assert np.array_equal(got, np.asarray(jqgemm_ref.qgemm_ref(
        jnp.asarray(q), jnp.asarray(db))))


@pytest.mark.parametrize("qv,dv", [(0xFFFF, 0xFFFF), (0xFFFF, -1),
                                   ((1 << 23) - 1, (1 << 23) - 1),
                                   (-1, -(1 << 23)), (I32.max, I32.min),
                                   (0x7FFFFFFF, 0x00FFFFFF)])
def test_qgemm_model_worst_groups_at_full_depth(qv, dv):
    """All-255 low limbs at d = 8192: the largest group sums the int32
    accumulators must hold (asserted inside the model)."""
    d = 8192
    q = np.full((2, d), qv, np.int64).astype(np.int32)
    q[1] = -q[0] if qv != I32.min else I32.max
    db = np.full((3, d), dv, np.int64).astype(np.int32)
    db[1] = qv
    got = _qgemm_model(q, db)
    assert np.array_equal(got, _int64(q, db))
    if max(abs(qv), abs(dv)) <= RAW:
        want = jqgemm.qgemm(jnp.asarray(q), jnp.asarray(db))
    else:
        want = jqgemm_ref.qgemm_ref(jnp.asarray(q), jnp.asarray(db))
    assert np.array_equal(got, np.asarray(want))


@pytest.mark.parametrize("nq,nn,d", [(5, 77, 101), (66, 70, 130)])
def test_qgemm_model_int16_rows(nq, nn, d):
    rng = np.random.default_rng(d)
    q = rng.integers(-2**15, 2**15, (nq, d)).astype(np.int16)
    db = rng.integers(-2**15, 2**15, (nn, d)).astype(np.int16)
    q[0, 0], db[0, 0] = -2**15, -2**15
    got = _qgemm_model(q, db)
    assert np.array_equal(got, _int64(q, db))
    assert np.array_equal(got, np.asarray(jqgemm.qgemm(jnp.asarray(q),
                                                       jnp.asarray(db))))


def test_qgemm_model_catches_a_group_leaving_int32():
    """Past the 8192-deep bound a group can overflow, and the model says
    so: t = -128, l = 255 puts -65280 a value into group 16."""
    v = -128 * 65536 + 255
    q = np.full((1, 33000), v, np.int32)
    with pytest.raises(AssertionError, match="int32"):
        tqgemm_ref.qgemm_limbs_ref(torch.from_numpy(q), torch.from_numpy(q))


@given(st.integers(1, 70), st.integers(1, 140), st.integers(1, 200),
       st.integers(0, 3), st.integers(0, 2**31 - 1))
@settings(max_examples=25, deadline=None)
def test_qgemm_model_property(nq, nn, d, scale, seed):
    """Any shape, values from normalized up to the full int32 range."""
    rng = np.random.default_rng(seed)
    bound = [RAW, 1 << 23, 1 << 24, 1 << 31][scale]
    q = rng.integers(-bound, bound, (nq, d)).astype(np.int32)
    db = rng.integers(-bound, bound, (nn, d)).astype(np.int32)
    assert np.array_equal(_qgemm_model(q, db), _int64(q, db))


W = 1 << 28


def _qcoarse_model(w, c):
    return np_(tqcoarse_ref.qcoarse_limbs_ref(torch.from_numpy(w),
                                              torch.from_numpy(c)))


@pytest.mark.parametrize("nq,nn,d", [(1, 1, 8), (5, 77, 7), (7, 100, 384),
                                     (70, 130, 300), (3, 33, 8192)])
def test_qcoarse_model_random_rows(nq, nn, d):
    rng = np.random.default_rng(nq + nn + d)
    w = rng.integers(-W, W + 1, (nq, d)).astype(np.int32)
    c = rng.integers(-127, 128, (nn, d)).astype(np.int8)
    got = _qcoarse_model(w, c)
    assert np.array_equal(got, _int64(w, c))
    assert np.array_equal(got, np.asarray(jqcoarse.qcoarse(jnp.asarray(w),
                                                           jnp.asarray(c))))


@pytest.mark.parametrize("wv,cv", [(W, 127), (-W, -128), (0x00FFFFFF, -128),
                                   (-1, 127), (I32.max, -128),
                                   (I32.min, -128)])
def test_qcoarse_model_worst_planes_at_full_depth(wv, cv):
    d = 8192
    w = np.full((2, d), wv, np.int64).astype(np.int32)
    w[1] = 0x00FFFFFF
    c = np.full((3, d), cv, np.int8)
    c[1] = 127
    got = _qcoarse_model(w, c)
    assert np.array_equal(got, _int64(w, c))
    want = jqcoarse_ref.qcoarse_ref(jnp.asarray(w), jnp.asarray(c))
    assert np.array_equal(got, np.asarray(want))
    if abs(wv) <= W:
        assert np.array_equal(got, np.asarray(jqcoarse.qcoarse(
            jnp.asarray(w), jnp.asarray(c))))


@given(st.integers(1, 70), st.integers(1, 140), st.integers(1, 300),
       st.integers(0, 2**31 - 1))
@settings(max_examples=20, deadline=None)
def test_qcoarse_model_property(nq, nn, d, seed):
    rng = np.random.default_rng(seed)
    w = rng.integers(I32.min, I32.max, (nq, d), endpoint=True).astype(np.int32)
    c = rng.integers(-128, 128, (nn, d)).astype(np.int8)
    assert np.array_equal(_qcoarse_model(w, c), _int64(w, c))
