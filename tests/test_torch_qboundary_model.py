"""The CPU model of the card's qboundary arithmetic (``ref.qboundary_model``:
the unchanged encode, the floor square root as a float64 sqrt with one
exact correction step, the rounded division as one reciprocal per row and
one exact correction step per element) against the port's plain version
and fixed-point pieces and against the JAX package's
``normalize_embedding``, ``isqrt`` and ``_int_div_round_to_nearest``, bit
for bit: every contract, unit norm on and off, odd and unaligned widths,
an input one float past 16-byte alignment, zero / tiny / NaN / inf / -0.0
rows and rows whose int64 sum of squares wraps. On a card (``cuda``
marker) the kernel meets the plain version on the same cases.

The JAX package is imported inside the tests that compare with it, so the
card's test also runs where JAX is not installed
(``python -m pytest --noconftest -m cuda tests/test_torch_qboundary_model.py``)."""
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro_torch import kernels as tkernels  # noqa: E402
from repro_torch.core import boundary as tb  # noqa: E402
from repro_torch.core import contracts as tcontracts  # noqa: E402
from repro_torch.core import fixedpoint as tfp  # noqa: E402
from repro_torch.kernels.qboundary import kernel, ops, ref  # noqa: E402

from _torch_parity import cuda_or_skip, np_  # noqa: E402

CONTRACTS = sorted(tcontracts.CONTRACTS)
WIDTHS = [1, 3, 7, 77, 101, 2303, 2305, 4097]
A_MAX = 1 << 47             # |raw << 16| of Q16.16
NORM_MAX = 3037000499       # isqrt(2^63 - 1): the largest norm a row has
EDGE_NORMS = [1, 2, 3, (1 << 31) - 1, NORM_MAX]


def _jax():
    """The JAX package's boundary and fixed-point modules."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.core import boundary as jb
    from repro.core import contracts as jc
    from repro.core import fixedpoint as jfp
    return jnp, jb, jc, jfp


def _rows(n, d, seed):
    """Seeded rows with the hard cases first: NaN, +-inf and -0.0 in row 0,
    a zero row, a tiny row (1e-7), a saturating row whose int64 sum of
    squares wraps negative, and a row whose four -2^31 squares wrap to 0
    so that the small rest sets the norm (quotients clamped)."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, d)) * 2).astype(np.float32)
    x[0, :4] = [np.nan, np.inf, -np.inf, -0.0][:min(4, d)]
    x[1] = 0.0
    x[2] *= 1e-7
    x[3, ::2], x[3, 1::2] = 40000.0, -40000.0
    if d >= 5:
        x[4, :4] = -40000.0
        x[4, 4:] *= 1e-3
    return x


def _check(x, name, unit_norm):
    """The model equals the port's plain version and the JAX package's
    normalize_embedding on ``x`` (a torch tensor on the CPU); beyond the
    64-bit division's bound (Q32.32 with unit norm) it refuses, as the
    kernel's launch constants do."""
    jnp, jb, jc, _ = _jax()
    tc = tcontracts.CONTRACTS[name]
    if unit_norm and tc.int_bits + 2 * tc.frac_bits > ref.WIDE_BITS:
        with pytest.raises(ValueError):
            ref.qboundary_model(x, tc, unit_norm)
        return
    got = ref.qboundary_model(x, tc, unit_norm)
    want = ref.qboundary_ref(x, tc, unit_norm)
    assert got.dtype == want.dtype == tc.storage_dtype
    assert torch.equal(got, want)
    assert torch.equal(tb.normalize_embedding(x, tc, unit_norm), got)
    jwant = np.asarray(jb.normalize_embedding(
        jnp.asarray(x.contiguous().numpy()), jc.CONTRACTS[name], unit_norm))
    assert np.array_equal(np_(got), jwant)


def _divide_cases(norm, k):
    """Numerators at k * norm, k * norm +- 1 and the half points, in
    [0, A_MAX], with both signs."""
    base = k * norm
    a = np.array([base, base + 1, base - 1, base + norm // 2,
                  base + (norm + 1) // 2, base + norm // 2 - 1,
                  base + norm - 1, A_MAX], dtype=np.int64)
    a = np.clip(a, 0, A_MAX)
    return np.concatenate([a, -a])


@pytest.mark.parametrize("name", CONTRACTS)
@pytest.mark.parametrize("unit_norm", [True, False])
@pytest.mark.parametrize("d", WIDTHS)
def test_model_matches_reference_at_odd_widths(name, unit_norm, d):
    _check(torch.from_numpy(_rows(6, d, seed=d)), name, unit_norm)


@pytest.mark.parametrize("name", CONTRACTS)
@pytest.mark.parametrize("unit_norm", [True, False])
def test_model_matches_reference_one_float_past_alignment(name, unit_norm):
    """A [1:] view of a contiguous buffer: its base is 4 bytes past 16-byte
    alignment (the card kernel's scalar path)."""
    n, d = 6, 768
    buf = torch.from_numpy(np.concatenate(
        [[0.0], _rows(n, d, seed=5).ravel()]).astype(np.float32))
    x = buf[1:].view(n, d)
    assert x.storage_offset() == 1 and x.is_contiguous()
    _check(x, name, unit_norm)


def test_isqrt_model_matches_the_recurrence():
    jnp, _, _, jfp = _jax()
    rng = np.random.default_rng(7)
    ks = np.array([1, 2, 3, 1 << 16, (1 << 31) - 1, 1 << 31, NORM_MAX - 1,
                   NORM_MAX], dtype=np.int64)
    s = np.concatenate([
        rng.integers(0, 2**63 - 1, size=20000, dtype=np.int64),
        rng.integers(0, 2**40, size=5000, dtype=np.int64),
        ks * ks, ks * ks - 1, ks * ks + 1, ks * ks + 2 * ks,
        [0, 1, 2, 3, 2**62, 2**63 - 1, -1, -5, -(2**63)]]).astype(np.int64)
    got = np_(ref.isqrt_model(torch.from_numpy(s)))
    assert np.array_equal(got, np_(tfp.isqrt(torch.from_numpy(s))))
    assert np.array_equal(got, np.asarray(jfp.isqrt(jnp.asarray(s))))


def test_divide_model_matches_exact_division():
    """Random pairs over the stated domain (|a| <= 2^47, 1 <= norm <=
    isqrt(2^63 - 1)), exact multiples k * norm and their neighbours (for
    some norms RN(k * norm * RN(1 / norm)) falls below k, so the first
    remainder is norm itself) and the edge norms, against the exact
    division of both packages."""
    jnp, _, _, jfp = _jax()
    rng = np.random.default_rng(11)
    m = 200000
    norm = np.exp(rng.uniform(0, np.log(NORM_MAX), size=m)).astype(np.int64)
    norm = np.clip(norm, 1, NORM_MAX)
    k = (rng.uniform(size=m) * (A_MAX // norm)).astype(np.int64)
    a = np.concatenate([rng.integers(-A_MAX, A_MAX + 1, size=m,
                                     dtype=np.int64),
                        k * norm, -k * norm, norm, (k * norm - 1).clip(0),
                        (k * norm + 1).clip(0, A_MAX)])
    norm = np.tile(norm, 6)
    for b in EDGE_NORMS:
        for k in (0, 1, 2, 12345, A_MAX // b - 1, A_MAX // b):
            c = _divide_cases(b, k)
            a = np.concatenate([a, c])
            norm = np.concatenate([norm, np.full(c.shape, b, np.int64)])
    got = np_(ref.divide_model(torch.from_numpy(a), torch.from_numpy(norm)))
    assert np.array_equal(got, np_(tfp._int_div_round_to_nearest(
        torch.from_numpy(a), torch.from_numpy(norm))))
    assert np.array_equal(got, np.asarray(jfp._int_div_round_to_nearest(
        jnp.asarray(a), jnp.asarray(norm))))


@settings(max_examples=300, deadline=None)
@given(norm=st.one_of(st.sampled_from(EDGE_NORMS),
                      st.integers(1, NORM_MAX)),
       k=st.integers(0, A_MAX))
def test_divide_model_hypothesis(norm, k):
    a = torch.from_numpy(_divide_cases(norm, k // norm))
    b = torch.full_like(a, norm)
    assert torch.equal(ref.divide_model(a, b),
                       tfp._int_div_round_to_nearest(a, b))


def test_launch_constants_are_built_once_and_bounded():
    """The wrapper's per-contract constants (no build needed): one object
    per (contract, unit_norm), the encode's bounds, the C struct's layout,
    and the refusal of a contract beyond the division's bound."""
    q = tcontracts.Q16_16
    p, addr = kernel.params(q, True)
    assert kernel.params(q, True)[0] is p
    assert (p.one, (p.lo, p.hi), p.frac_bits, p.min_raw, p.max_raw,
            p.unit_norm, p.per_thread) == (
        q.one, tfp._f32_safe_bounds(q), 16, q.min_raw, q.max_raw, 1, 0)
    assert kernel.QbParams.min_raw.offset == 16
    assert kernel.QbParams.per_thread.offset == 36
    assert addr == ctypes.addressof(p)
    with pytest.raises(ValueError):
        kernel.params(tcontracts.Q32_32, True)
    assert kernel.params(tcontracts.Q32_32, False)[0].unit_norm == 0


def test_wrapper_on_cpu_takes_the_plain_version_at_odd_widths():
    tkernels.reset_launch_counts()
    for d in (1, 77, 2305):
        x = torch.from_numpy(_rows(6, d, seed=d + 1))
        assert torch.equal(ops.qboundary(x, tcontracts.Q16_16),
                           ref.qboundary_model(x, tcontracts.Q16_16))
    assert tkernels.launch_counts()["qboundary"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("unit_norm", [True, False])
def test_kernel_matches_plain_version_on_card(unit_norm):
    """Every width above, the main path's shapes, a looped row (d = 40000)
    and the one-float offset, kernel against the plain version, with the
    path each must take."""
    dev = cuda_or_skip()
    q = tcontracts.Q16_16
    cases = [(6, d) for d in WIDTHS] + [(64, 2304), (512, 2304), (6, 40000)]
    for n, d in cases:
        x = torch.from_numpy(_rows(n, d, seed=d)).to(dev)
        want_path = ("looped" if d > 32768 else
                     "16-byte" if d % 4 == 0 else "scalar")
        assert kernel.path(x).startswith(want_path), (d, kernel.path(x))
        got = ops.qboundary(x, q, unit_norm=unit_norm)
        assert torch.equal(got.cpu(), ref.qboundary_ref(x.cpu(), q, unit_norm))
    buf = torch.from_numpy(np.concatenate(
        [[0.0], _rows(64, 2304, seed=5).ravel()]).astype(np.float32)).to(dev)
    x = buf[1:].view(64, 2304)
    assert kernel.path(x).startswith("scalar")
    assert torch.equal(ops.qboundary(x, q, unit_norm=unit_norm).cpu(),
                       ref.qboundary_ref(x.cpu(), q, unit_norm))
