"""Port boundary == reference boundary, bit for bit, for every contract."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402,F401
from repro.core import boundary as jb  # noqa: E402
from repro.core import contracts as jcontracts  # noqa: E402
from repro.core import fixedpoint as jfp  # noqa: E402
from repro.kernels.qboundary import ops as jqb  # noqa: E402
from repro_torch import kernels as tkernels  # noqa: E402
from repro_torch.core import boundary as tb  # noqa: E402
from repro_torch.core import contracts as tcontracts  # noqa: E402
from repro_torch.core import fixedpoint as tfp  # noqa: E402
from repro_torch.kernels.qboundary import ops as tqb  # noqa: E402
from repro_torch.kernels.qboundary import ref as tqb_ref  # noqa: E402

from _torch_parity import cuda_or_skip, np_  # noqa: E402

CONTRACTS = sorted(jcontracts.CONTRACTS)


def _inputs(n, d, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, d)) * 2).astype(np.float32)
    if n >= 4:
        x[1] = 0.0                                        # zero row
        x[2] = rng.normal(size=d).astype(np.float32) * 1e-7   # tiny row
        x[3, ::2] = 40000.0                               # saturating
        x[3, 1::2] = -40000.0
    return x


def test_contract_table_matches():
    for name in CONTRACTS:
        j, t = jcontracts.CONTRACTS[name], tcontracts.CONTRACTS[name]
        assert (j.int_bits, j.frac_bits, j.one, j.min_raw, j.max_raw) == \
            (t.int_bits, t.frac_bits, t.one, t.min_raw, t.max_raw)
        assert j.np_storage_dtype == t.np_storage_dtype
        assert j.describe() == t.describe()


@pytest.mark.parametrize("name", CONTRACTS)
@pytest.mark.parametrize("unit_norm", [True, False])
@pytest.mark.parametrize("n,d", [(1, 8), (4, 16), (128, 384), (257, 768),
                                 (100, 64)])
def test_normalize_embedding_bitwise(name, unit_norm, n, d):
    x = _inputs(n, d, seed=n * 1000 + d)
    jc, tc = jcontracts.CONTRACTS[name], tcontracts.CONTRACTS[name]
    want = np.asarray(jb.normalize_embedding(jnp.asarray(x), jc, unit_norm))
    got = np_(tb.normalize_embedding(torch.from_numpy(x), tc, unit_norm))
    assert got.dtype == want.dtype
    assert np.array_equal(got, want)
    # the reference kernel wrapper (interpret mode) agrees too
    kern = np.asarray(jqb.qboundary(jnp.asarray(x), jc, unit_norm=unit_norm))
    assert np.array_equal(got, kern)


def test_encode_special_values():
    x = np.asarray([0.5, -1.0, 40000.0, -40000.0, 32767.999, 32768.0, 1e30,
                    np.inf, -np.inf, np.nan, -0.0, 1e-40], np.float32)
    for name in CONTRACTS:
        jc, tc = jcontracts.CONTRACTS[name], tcontracts.CONTRACTS[name]
        want = np.asarray(jfp.encode(jnp.asarray(x), jc))
        got = np_(tfp.encode(torch.from_numpy(x), tc))
        assert np.array_equal(got, want), name


def test_isqrt_and_division_match():
    rng = np.random.default_rng(3)
    v = rng.integers(0, 2**62, size=200, dtype=np.int64)
    v[:4] = [0, 1, 2**62 - 1, -5]
    assert np.array_equal(np_(tfp.isqrt(torch.from_numpy(v))),
                          np.asarray(jfp.isqrt(jnp.asarray(v))))
    a = rng.integers(-2**40, 2**40, size=300, dtype=np.int64)
    b = rng.integers(1, 2**20, size=300, dtype=np.int64) * \
        rng.choice([-1, 1], size=300)
    want = np.asarray(jfp._int_div_round_to_nearest(jnp.asarray(a),
                                                    jnp.asarray(b)))
    got = np_(tfp._int_div_round_to_nearest(torch.from_numpy(a),
                                            torch.from_numpy(b)))
    assert np.array_equal(got, want)


def test_wrapper_takes_plain_version_on_cpu():
    x = torch.from_numpy(_inputs(8, 16))
    tkernels.reset_launch_counts()
    got = tqb.qboundary(x, tcontracts.Q16_16)
    assert tkernels.launch_counts()["qboundary"] == 0
    assert torch.equal(got, tqb_ref.qboundary_ref(x, tcontracts.Q16_16))


@pytest.mark.cuda
@pytest.mark.parametrize("unit_norm", [True, False])
def test_qboundary_kernel_matches_plain_on_card(unit_norm):
    dev = cuda_or_skip()
    for n, d in [(1, 8), (4, 16), (257, 768), (512, 2304), (3, 8192)]:
        x = torch.from_numpy(_inputs(n, d, seed=d)).to(dev)
        got = tqb.qboundary(x, tcontracts.Q16_16, unit_norm=unit_norm)
        want = tqb_ref.qboundary_ref(x.cpu(), tcontracts.Q16_16, unit_norm)
        assert torch.equal(got.cpu(), want)
