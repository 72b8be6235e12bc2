"""The port on the CPU reproduces the reference's golden fixtures, written
at the real width (d = 2304) by scripts/gen_golden_torch_port.py (flat)
and scripts/gen_golden_torch_sharded.py (the same recipe on 4 shards)."""
import pytest

torch = pytest.importorskip("torch")

import _torch_golden as golden  # noqa: E402

from _torch_parity import cuda_or_skip  # noqa: E402


def test_port_reproduces_reference_golden_on_cpu():
    golden.check("cpu")


@pytest.mark.cuda
def test_port_reproduces_reference_golden_on_card():
    golden.check(cuda_or_skip())


def test_port_reproduces_reference_sharded_golden_on_cpu():
    got = golden.check_sharded("cpu")
    # the layout-invariant hashes equal the flat recipe's
    flat = golden.load_spec()
    assert got["content_hash"] == flat["content_hash"]
    assert got["retrieval_hash"]["exact"] == flat["retrieval_hash"]["exact"]


@pytest.mark.cuda
def test_port_reproduces_reference_sharded_golden_on_card():
    golden.check_sharded(cuda_or_skip())
