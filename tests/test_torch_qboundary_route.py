"""The boundary under contracts beyond the qboundary kernel's reciprocal
division bound (int_bits + 2 * frac_bits > 51: Q4.27, Q1.30), where the
kernel divides each element exactly in 64 bits: the wrapper's static
route rule, the CPU model of the wide division and the CPU's bits against
the JAX package's ``normalize_embedding`` and ``_int_div_round_to_nearest``,
and on a card (``cuda`` marker) the kernel's bits against the CPU's, one
launch per call, on every load path.

The JAX package is imported inside the tests that compare with it, so the
card's test also runs where JAX is not installed
(``python -m pytest --noconftest -m cuda tests/test_torch_qboundary_route.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels as tkernels  # noqa: E402
from repro_torch.core import boundary as tb  # noqa: E402
from repro_torch.core import contracts as tcontracts  # noqa: E402
from repro_torch.kernels.qboundary import kernel as tqb_kernel  # noqa: E402
from repro_torch.kernels.qboundary import ops as tqb  # noqa: E402
from repro_torch.kernels.qboundary import ref as tqb_ref  # noqa: E402

from _torch_parity import cuda_or_skip, np_  # noqa: E402

WIDE_FRAC = [("Q4.27", 4, 27), ("Q1.30", 1, 30)]
NORM_MAX = 3037000499       # isqrt(2^63 - 1): the largest norm a row has
A_WIDE = 1 << 62            # |raw << frac_bits| of Q0.31, the widest int32


def _rows(seed, n, d):
    x = (np.random.default_rng(seed).normal(size=(n, d)) * 2
         ).astype(np.float32)
    x[1] = 0.0
    x[2, ::2], x[2, 1::2] = 40.0, -40.0  # saturating row
    x[3, :4] = [np.nan, np.inf, -np.inf, -0.0]
    x[4] *= 1e-7                        # tiny row
    return x


@pytest.mark.parametrize("name,ib,fb", WIDE_FRAC)
@pytest.mark.parametrize("unit_norm", [True, False])
def test_normalize_embedding_beyond_division_bound(name, ib, fb, unit_norm):
    """The port's boundary and the kernel's CPU model (the wide instance's
    exact divide) give JAX's bits, at an aligned and an odd width."""
    import jax.numpy as jnp

    import repro  # noqa: F401
    from repro.core import boundary as jb
    from repro.core import contracts as jcontracts
    jc = jcontracts.PrecisionContract(name, int_bits=ib, frac_bits=fb)
    tc = tcontracts.PrecisionContract(name, int_bits=ib, frac_bits=fb)
    for d in (24, 77):
        x = _rows(ib + d, 16, d)
        want = np.asarray(jb.normalize_embedding(jnp.asarray(x), jc,
                                                 unit_norm))
        got = np_(tb.normalize_embedding(torch.from_numpy(x), tc, unit_norm))
        assert got.dtype == want.dtype == np.int32
        assert np.array_equal(got, want)
        model = np_(tqb_ref.qboundary_model(torch.from_numpy(x), tc,
                                            unit_norm))
        assert np.array_equal(model, want)


def test_divide_wide_model_matches_exact_division():
    """Numerators over the wide instance's whole domain (|a| <= 2^62),
    exact multiples, their neighbours and the half points, at random and
    edge norms, against the exact division of both packages."""
    import jax.numpy as jnp

    import repro  # noqa: F401
    from repro.core import fixedpoint as jfp
    rng = np.random.default_rng(13)
    m = 50000
    norm = np.clip(np.exp(rng.uniform(0, np.log(NORM_MAX), size=m)),
                   1, NORM_MAX).astype(np.int64)
    k = (rng.uniform(size=m) * (A_WIDE // norm)).astype(np.int64)
    base = k * norm
    a = np.concatenate([rng.integers(-A_WIDE, A_WIDE + 1, size=m,
                                     dtype=np.int64),
                        base, -base, (base - 1).clip(0), base + 1,
                        base + norm // 2, -(base + (norm + 1) // 2)])
    norm = np.tile(norm, 7)
    for b in (1, 2, 3, (1 << 31) - 1, NORM_MAX):
        edge = np.array([A_WIDE, A_WIDE - 1, (A_WIDE // b) * b,
                         (A_WIDE // b) * b - 1, b // 2, (b + 1) // 2],
                        dtype=np.int64)
        a = np.concatenate([a, edge, -edge])
        norm = np.concatenate([norm, np.full(2 * edge.size, b, np.int64)])
    got = np_(tqb_ref.divide_wide_model(torch.from_numpy(a),
                                        torch.from_numpy(norm)))
    assert np.array_equal(got, np.asarray(jfp._int_div_round_to_nearest(
        jnp.asarray(a), jnp.asarray(norm))))


def test_qboundary_route_rule():
    """Static, keyed on the contract's storage: every int32 contract takes
    the kernel on the card, other storage the plain version. Within int32
    the launch constants pick the division: the reciprocal up to DIV_BITS,
    the exact divide beyond; a unit-norm contract whose numerator does not
    fit in 64 bits is refused."""
    C = tcontracts.PrecisionContract
    assert tqb.uses_kernel(tcontracts.Q16_16)
    assert not tqb.uses_kernel(tcontracts.Q8_8)
    assert not tqb.uses_kernel(tcontracts.Q2_13)
    assert not tqb.uses_kernel(tcontracts.Q32_32)
    assert tqb_kernel.params(tcontracts.Q16_16, True)[0].wide == 0
    for name, ib, fb in WIDE_FRAC:
        c = C(name, int_bits=ib, frac_bits=fb)
        assert ib + 2 * fb > tqb_kernel.DIV_BITS
        assert tqb.uses_kernel(c)
        assert tqb_kernel.params(c, True)[0].wide == 1
        assert tqb_kernel.params(c, False)[0].wide == 0  # encode only
    edge = C("edge", int_bits=1, frac_bits=25)  # 51: the reciprocal's last
    assert tqb.uses_kernel(edge)
    assert tqb_kernel.params(edge, True)[0].wide == 0
    assert tqb_kernel.params(C("Q0.31", int_bits=0, frac_bits=31),
                             True)[0].wide == 1  # 62: the widest int32
    assert tqb_kernel.QbParams.wide.offset == 40
    with pytest.raises(ValueError, match="64 bits"):
        tqb_kernel.params(tcontracts.Q32_32, True)


@pytest.mark.cuda
@pytest.mark.parametrize("name,ib,fb", WIDE_FRAC)
def test_normalize_embedding_beyond_division_bound_on_card(name, ib, fb):
    """On the card these contracts answer with the CPU's bits through the
    kernel, one launch per call, unit norm on (the wide instance) and off,
    on the 16-byte, scalar and looped paths."""
    dev = cuda_or_skip()
    tc = tcontracts.PrecisionContract(name, int_bits=ib, frac_bits=fb)
    for n, d, path in [(64, 2304, "16-byte"), (16, 77, "scalar"),
                       (6, 40000, "looped")]:
        x = _rows(fb + d, n, d)
        xt = torch.from_numpy(x).to(dev)
        assert tqb_kernel.path(xt).startswith(path), tqb_kernel.path(xt)
        for unit_norm in (True, False):
            before = tkernels.launch_counts()["qboundary"]
            got = tb.normalize_embedding(xt, tc, unit_norm)
            assert tkernels.launch_counts()["qboundary"] - before == 1
            want = tb.normalize_embedding(torch.from_numpy(x), tc, unit_norm)
            assert np.array_equal(np_(got), np_(want)), (d, unit_norm)
