"""Shared helpers of the port's parity tests: hand a reference (JAX)
state or log to the port as numpy, and compare the two bit for bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers at once; keep each one's torch threads few
torch.set_num_threads(min(2, torch.get_num_threads()))

from repro_torch.core import commands as tc  # noqa: E402
from repro_torch.core import state as ts  # noqa: E402

STATE_FIELDS = ts.FIELDS


def state_np(state) -> dict:
    """A state of either package as a dict of numpy arrays."""
    return {f: (getattr(state, f).cpu().numpy()
                if isinstance(getattr(state, f), torch.Tensor)
                else np.asarray(getattr(state, f))) for f in STATE_FIELDS}


def to_port_state(jstate):
    return ts.state_from_numpy(state_np(jstate), jstate.contract_name,
                               device="cpu")


def to_port_log(jlog, contract=None):
    arrays = {f: np.asarray(getattr(jlog, f)) for f in tc.FIELDS}
    kw = {} if contract is None else {"contract": contract}
    return tc.log_from_numpy(arrays, device="cpu", **kw)


def assert_states_equal(a, b):
    na, nb = state_np(a), state_np(b)
    for f in STATE_FIELDS:
        assert na[f].dtype == nb[f].dtype, (f, na[f].dtype, nb[f].dtype)
        assert np.array_equal(na[f], nb[f]), f"field {f} differs"


def np_(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def cuda_or_skip():
    """Skip unless a CUDA device is present (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
