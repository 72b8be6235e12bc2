"""Port qgemm / qtopk (plain versions on the CPU, CUDA kernels on the card)
against the reference ops, bit for bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402,F401
from repro.kernels.qgemm import ops as jqgemm  # noqa: E402
from repro.kernels.qgemm import ref as jqgemm_ref  # noqa: E402
from repro.kernels.qtopk import ops as jqtopk  # noqa: E402
from repro.kernels.qtopk import ref as jqtopk_ref  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.qcoarse import ops as tqcoarse  # noqa: E402
from repro_torch.kernels.qgemm import ops as tqgemm  # noqa: E402
from repro_torch.kernels.qgemm import ref as tqgemm_ref  # noqa: E402
from repro_torch.kernels.qtopk import ops as tqtopk  # noqa: E402
from repro_torch.kernels.qtopk import ref as tqtopk_ref  # noqa: E402

from _torch_parity import cuda_or_skip, np_  # noqa: E402

QGEMM_SHAPES = [(1, 1, 8), (4, 16, 32), (8, 128, 64), (128, 256, 512),
                (7, 100, 384), (130, 257, 640), (16, 1000, 768), (3, 33, 8192)]


def _qgemm_inputs(nq, nn, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-65536, 65537, size=(nq, d)).astype(np.int32),
            rng.integers(-65536, 65537, size=(nn, d)).astype(np.int32))


@pytest.mark.parametrize("nq,nn,d", QGEMM_SHAPES)
def test_qgemm_plain_matches_reference(nq, nn, d):
    q, db = _qgemm_inputs(nq, nn, d, seed=nq + nn + d)
    want = np.asarray(jqgemm_ref.qgemm_ref(jnp.asarray(q), jnp.asarray(db)))
    got = np_(tqgemm.qgemm(torch.from_numpy(q), torch.from_numpy(db)))
    assert got.dtype == np.int64 and np.array_equal(got, want)


def test_qgemm_planes_match_reference():
    q, db = _qgemm_inputs(7, 100, 384, seed=1)
    want = np.asarray(jqgemm.qgemm_planes(jnp.asarray(q), jnp.asarray(db)))
    got = np_(tqgemm.qgemm_planes(torch.from_numpy(q), torch.from_numpy(db)))
    assert np.array_equal(got, want)
    assert np.array_equal(
        np_(tqgemm_ref.combine_planes_ref(torch.from_numpy(got))),
        np.asarray(jqgemm_ref.combine_planes_ref(jnp.asarray(want))))


def test_qgemm_extreme_values():
    d = 8192
    q = np.full((2, d), 65536, np.int32)
    q[1] = -65536
    db = np.concatenate([np.full((1, d), 65536, np.int32),
                         np.full((1, d), -65536, np.int32)])
    got = np_(tqgemm.qgemm(torch.from_numpy(q), torch.from_numpy(db)))
    want = np.asarray(jqgemm.qgemm(jnp.asarray(q), jnp.asarray(db)))
    assert np.array_equal(got, want)
    assert int(got[0, 0]) == d * 65536 * 65536


def test_qgemm_rejects_oversized_dim():
    q = torch.zeros((2, 16384), dtype=torch.int32)
    with pytest.raises(ValueError, match="dim"):
        tqgemm.qgemm(q, q)


QTOPK_CASES = [(1, 4, 1), (3, 17, 5), (6, 200, 16), (2, 127, 16), (5, 128, 9),
               (4, 1000, 12), (4, 1024, 16), (4, 1030, 10), (4, 5000, 16),
               (2, 3000, 1)]


@pytest.mark.parametrize("nq,n,k", QTOPK_CASES)
def test_qtopk_plain_matches_reference(nq, n, k):
    rng = np.random.default_rng(nq * 7 + n + k)
    s = rng.integers(-2**45, 2**45, size=(nq, n)).astype(np.int64)
    keys = rng.permutation(n).astype(np.int32)
    want = jqtopk.qtopk(jnp.asarray(s), jnp.asarray(keys), k)
    got = tqtopk.qtopk(torch.from_numpy(s), torch.from_numpy(keys), k)
    for g, w in zip(got, want):
        assert np.array_equal(np_(g), np.asarray(w))
    full = tqtopk_ref.qtopk_sorted(torch.from_numpy(s), torch.from_numpy(keys), k)
    fullj = jqtopk_ref.qtopk_ref(jnp.asarray(s), jnp.asarray(keys), k)
    for g, w in zip(full, fullj):
        assert np.array_equal(np_(g), np.asarray(w))


def test_qtopk_ties_pads_and_k_beyond_row():
    # all ties with reversed keys: the key order decides
    s = np.zeros((1, 64), np.int64)
    keys = np.arange(64, dtype=np.int32)[::-1].copy()
    _, got_k = tqtopk.qtopk(torch.from_numpy(s), torch.from_numpy(keys), 5)
    assert np_(got_k)[0].tolist() == [0, 1, 2, 3, 4]
    # k larger than a padded last block, and larger than a short row:
    # the blocked selection's pad/retired lanes must match the reference's
    rng = np.random.default_rng(9)
    for nq, n, k in [(2, 1030, 20), (3, 20, 30)]:
        sc = rng.integers(-2**40, 2**40, size=(nq, n)).astype(np.int64)
        sc[:, ::7] = 0  # ties
        ky = rng.permutation(n).astype(np.int32)
        want = jqtopk.qtopk(jnp.asarray(sc), jnp.asarray(ky), k)
        got = tqtopk.qtopk(torch.from_numpy(sc), torch.from_numpy(ky), k)
        for g, w in zip(got, want):
            assert np.array_equal(np_(g), np.asarray(w)), (nq, n, k)


def test_launch_counts_stay_zero_on_cpu():
    kernels.reset_launch_counts()
    q, db = _qgemm_inputs(2, 5, 8, seed=0)
    tqgemm.qgemm(torch.from_numpy(q), torch.from_numpy(db))
    tqtopk.qtopk(torch.zeros((1, 8), dtype=torch.int64),
                 torch.arange(8, dtype=torch.int32), 3)
    tqcoarse.qcoarse(torch.ones((1, 8), dtype=torch.int32),
                     torch.ones((3, 8), dtype=torch.int8))
    assert kernels.launch_counts() == {"qboundary": 0, "qgemm": 0, "qtopk": 0,
                                       "qcoarse": 0}


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card():
    dev = cuda_or_skip()
    for nq, nn, d in QGEMM_SHAPES + [(64, 4099, 2304)]:
        q, db = _qgemm_inputs(nq, nn, d, seed=d)
        qt, dbt = torch.from_numpy(q).to(dev), torch.from_numpy(db).to(dev)
        assert torch.equal(tqgemm.qgemm(qt, dbt).cpu(),
                           tqgemm_ref.qgemm_ref(qt.cpu(), dbt.cpu()))
    for nq, n, k in QTOPK_CASES + [(64, 131072, 10), (64, 131072, 256),
                                   (2, 1030, 1040), (2, 9000, 4096),
                                   (2, 9000, 4095)]:
        rng = np.random.default_rng(n)
        s = torch.from_numpy(rng.integers(-2**45, 2**45, size=(nq, n)))
        keys = torch.from_numpy(rng.permutation(n).astype(np.int32))
        got = tqtopk.qtopk(s.to(dev), keys.to(dev), k)
        want = tqtopk.qtopk(s, keys, k)
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
