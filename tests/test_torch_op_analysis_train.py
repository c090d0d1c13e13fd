"""The train step's FLOPs against the JAX package's
``hlo_analysis.analyze`` for each family's smoke config: the
differences held exact and xLSTM's tolerance are
``test_torch_op_analysis.py``'s (its docstring)."""
import pytest
import torch

from test_torch_op_analysis import FAMILIES, check_flops


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_flops_match_jax(arch):
    check_flops(arch, "train")
