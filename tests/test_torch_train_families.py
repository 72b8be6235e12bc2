"""``loss_fn``, its gradients and ``make_train_step`` of the moe, ssm and
hybrid REDUCED configs in f32 against the reference, as
``test_torch_train_step.py`` holds the dense ones; the MoE balance loss
enters the total at 0.01 and its gradient flows through the router."""
import pytest

from _torch_train import check_loss_and_grads, check_train_steps


@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m",
                                  "phi3_5_moe_42b_a6_6b", "mamba2_130m",
                                  "zamba2_2_7b"])
def test_loss_and_grads_match_reference(arch):
    print(f"{arch}: worst gradient leaf "
          f"{check_loss_and_grads(arch, 16):.3g}")


@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m",
                                  "phi3_5_moe_42b_a6_6b", "mamba2_130m",
                                  "zamba2_2_7b"])
def test_train_steps_match_reference(arch):
    print(arch, check_train_steps(arch))
