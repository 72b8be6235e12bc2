"""``loss_fn``, its gradients and ``make_train_step`` of the dense REDUCED
configs in f32 against the reference (``tests/_torch_train.py``): loss,
ce and aux within 1e-5 relative, every gradient leaf within 1e-4
relative Frobenius error (labels partly -1), remat block == none bit for
bit in the port, and the losses of 3 AdamW steps within 1e-4. gemma2 also
runs at seq 64, its REDUCED flash_threshold: the flash paths' backward
(the sliding-window chunks and the zigzag pairs)."""
import pytest

from _torch_train import check_loss_and_grads, check_train_steps


@pytest.mark.parametrize("arch,seq", [
    ("gemma2_2b", 16), ("gemma2_2b", 64), ("granite_34b", 16),
    ("h2o_danube_1_8b", 16), ("codeqwen1_5_7b", 16)])
def test_loss_and_grads_match_reference(arch, seq):
    print(f"{arch} seq {seq}: worst gradient leaf "
          f"{check_loss_and_grads(arch, seq):.3g}")


@pytest.mark.parametrize("arch", ["gemma2_2b", "granite_34b",
                                  "h2o_danube_1_8b", "codeqwen1_5_7b"])
def test_train_steps_match_reference(arch):
    print(arch, check_train_steps(arch))
