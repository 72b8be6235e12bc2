"""The shard host's history of ``test_torch_net.py`` under the other
storage types: Q32.32 (int64 rows, 8-byte query items) and Q8.8 (int16
rows): the same response frames and store bytes in both packages."""
import pytest

pytest.importorskip("torch")

from test_torch_net import run_history  # noqa: E402


@pytest.mark.parametrize("contract", ["Q32.32", "Q8.8"])
def test_same_history_same_frames_and_store_bytes(tmp_path, contract):
    run_history(tmp_path, contract)
