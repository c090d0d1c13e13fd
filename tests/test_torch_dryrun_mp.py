"""The dry run's smoke cells on a fake (2, 2, 2) multi-pod mesh: the
checks of ``test_torch_dryrun.py`` (its docstring), in a file of their
own so each stays under a minute."""
import pytest
import torch

from test_torch_dryrun import SMOKE_ARCHS, check_smoke_cells, trace_in_child


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def traced():
    return trace_in_child({"pod": 2, "data": 2, "model": 2}, full=False)


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_smoke_cells_trace_multi_pod(traced, arch):
    check_smoke_cells(traced, arch, "2x2x2")
