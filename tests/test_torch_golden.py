"""The port on the CPU reproduces the reference's golden fixture, written
at the real width (d = 2304) by scripts/gen_golden_torch_port.py."""
import pytest

torch = pytest.importorskip("torch")

import _torch_golden as golden  # noqa: E402

from _torch_parity import cuda_or_skip  # noqa: E402


def test_port_reproduces_reference_golden_on_cpu():
    golden.check("cpu")


@pytest.mark.cuda
def test_port_reproduces_reference_golden_on_card():
    golden.check(cuda_or_skip())
