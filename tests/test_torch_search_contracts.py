"""The port's exact scan answers for every storage type the contracts
give, as the reference's default route (the plain int64 matmul,
``use_kernel=False``) does: Q8.8 and Q2.13 (int16), Q16.16 with and
without unit norm (int32), Q32.32 (int64, wrapping) and a width past the
8192-deep kernel bound. On the CPU the port's kernel route
(``use_kernel=True``: depth chunks, dtype dispatch, qtopk's plain
version) must agree too."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402,F401
from repro.core import search as js  # noqa: E402
from repro.core.contracts import get_contract as j_contract  # noqa: E402
from repro.core.state import init_state as j_init  # noqa: E402
from repro_torch.core import search as ts  # noqa: E402
from repro_torch.core.contracts import get_contract as t_contract  # noqa: E402
from repro_torch.core.state import init_state as t_init  # noqa: E402

from _torch_parity import cuda_or_skip, np_  # noqa: E402
from _torch_search_cases import CASES, make_case  # noqa: E402

CAP, DIM, NQ, K = 96, 40, 5, 7


def _states(case, device="cpu", cap=CAP):
    c = make_case(case, cap, DIM, NQ)
    cap, dim = c["vectors"].shape
    jstate = dataclasses.replace(
        j_init(cap, dim, contract=j_contract(c["contract"])),
        vectors=jnp.asarray(c["vectors"]), ids=jnp.asarray(c["ids"]),
        valid=jnp.asarray(c["valid"]))
    tstate = dataclasses.replace(
        t_init(cap, dim, contract=t_contract(c["contract"]), device=device),
        vectors=torch.from_numpy(c["vectors"]).to(device),
        ids=torch.from_numpy(c["ids"]).to(device),
        valid=torch.from_numpy(c["valid"]).to(device))
    return c, jstate, tstate


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("metric", [ts.METRIC_L2, ts.METRIC_DOT])
@pytest.mark.parametrize("case", CASES)
def test_exact_search_matches_reference(case, metric, use_kernel):
    c, jstate, tstate = _states(case)
    want = js.exact_search(jstate, jnp.asarray(c["queries"]), K, metric=metric)
    got = ts.exact_search(tstate, torch.from_numpy(c["queries"]), K,
                          metric=metric, use_kernel=use_kernel)
    assert np.array_equal(np_(got[0]), np.asarray(want[0]))
    assert np.array_equal(np_(got[1]), np.asarray(want[1]))


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("metric", [ts.METRIC_L2, ts.METRIC_DOT])
@pytest.mark.parametrize("cap,k", [(1030, 1040), (2100, 3000)])
def test_exact_search_k_beyond_capacity_matches_reference(cap, k, metric,
                                                          use_kernel):
    """k > capacity (the planner sends it to the exact route): the
    reference's default route returns min(k, capacity) columns, and so
    must the port's, on the kernel route too. qtopk's own width (the
    reference kernel's) exceeds n at these shapes, with pad columns."""
    c, jstate, tstate = _states("Q16.16-unit", cap=cap)
    want = js.exact_search(jstate, jnp.asarray(c["queries"]), k, metric=metric)
    got = ts.exact_search(tstate, torch.from_numpy(c["queries"]), k,
                          metric=metric, use_kernel=use_kernel)
    assert np.asarray(want[0]).shape == (NQ, cap)
    assert np.array_equal(np_(got[0]), np.asarray(want[0]))
    assert np.array_equal(np_(got[1]), np.asarray(want[1]))


@pytest.mark.parametrize("case", CASES)
def test_score_block_matches_reference(case):
    c, jstate, tstate = _states(case)
    for metric in (ts.METRIC_L2, ts.METRIC_DOT):
        want = np.asarray(js.score_block(jnp.asarray(c["queries"]),
                                         jstate.vectors, metric))
        for use_kernel in (False, True):
            got = np_(ts.score_block(torch.from_numpy(c["queries"]),
                                     tstate.vectors, metric, use_kernel))
            assert got.dtype == np.int64 and np.array_equal(got, want)


def test_wide_dot_chunks_past_the_kernel_bound():
    """d = 8200 goes through two qgemm calls (8192 + 8) whose int64 sums
    equal the one-shot product, wrapping included."""
    c = make_case("Q16.16-d8200", 8, DIM, 3)
    q, db = torch.from_numpy(c["queries"]), torch.from_numpy(c["vectors"])
    want = torch.matmul(q.to(torch.int64), db.to(torch.int64).T)
    assert torch.equal(ts._wide_dot_kernel(q, db), want)
    big = torch.full((2, 9000), np.iinfo(np.int64).max, dtype=torch.int64)
    assert torch.equal(ts._wide_dot_kernel(big, big), big @ big.T)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_exact_search_on_card_matches_cpu(case):
    dev = cuda_or_skip()
    c, _, cpu_state = _states(case)
    _, _, card_state = _states(case, device=dev)
    q = torch.from_numpy(c["queries"])
    for metric in (ts.METRIC_L2, ts.METRIC_DOT):
        want = ts.exact_search(cpu_state, q, K, metric=metric)
        got = ts.exact_search(card_state, q.to(dev), K, metric=metric)
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])
