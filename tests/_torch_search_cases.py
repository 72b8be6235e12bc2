"""Seeded exact-search states over every storage type the contracts give
(numpy only, so the parity tests and ``chip_smoke.py`` share them).

Each case is a dict of numpy arrays: ``vectors`` in the contract's
storage type, ``ids``, ``valid`` (some rows dead, some rows duplicated so
that ties occur) and ``queries``. The values span the storage type:
Q8.8 and Q2.13 rows are int16, Q16.16 rows int32 (boundary-normalized,
|raw| <= 2^16, or full range), Q32.32 rows int64 (full range, so the
int64 products wrap as the reference's do); one case is 8200 wide, past
qgemm's 8192-deep exactness bound.
"""
import numpy as np

CASES = ("Q8.8", "Q2.13", "Q16.16-unit", "Q16.16-full", "Q32.32",
         "Q16.16-d8200")
WIDE_DIM = 8200

_STORAGE = {"Q8.8": np.int16, "Q2.13": np.int16, "Q16.16": np.int32,
            "Q32.32": np.int64}


def contract_of(case: str) -> str:
    return case.split("-")[0]


def make_case(case: str, capacity: int, dim: int, nq: int, seed: int = 0):
    """The case's arrays; ``dim`` is replaced by ``WIDE_DIM`` for the wide
    case."""
    rng = np.random.default_rng([seed, CASES.index(case)])
    dtype = _STORAGE[contract_of(case)]
    if case == "Q16.16-d8200":
        dim = WIDE_DIM
    if case in ("Q16.16-unit", "Q16.16-d8200"):
        lo, hi = -(1 << 16), (1 << 16) + 1
    else:
        info = np.iinfo(dtype)
        lo, hi = int(info.min), int(info.max)
    vectors = rng.integers(lo, hi, (capacity, dim), dtype=np.int64,
                           endpoint=False).astype(dtype)
    queries = rng.integers(lo, hi, (nq, dim), dtype=np.int64,
                           endpoint=False).astype(dtype)
    if case == "Q16.16-full":  # the extremes, in some rows only
        vectors[1, :3] = [np.iinfo(dtype).max, np.iinfo(dtype).min, 1 << 23]
        queries[0, :2] = [np.iinfo(dtype).min, np.iinfo(dtype).max]
    vectors[5] = vectors[0]          # ties: equal rows under other ids
    vectors[capacity - 1] = vectors[2]
    queries[-1] = vectors[3]         # an exact hit
    ids = rng.permutation(capacity).astype(np.int64) * 3 + 1
    valid = rng.random(capacity) < 0.85
    valid[[0, 5, 2]] = True
    return dict(contract=contract_of(case), vectors=vectors, ids=ids,
                valid=valid, queries=queries)
