"""The dry run's smoke cells of the encdec (Whisper) and vlm (InternVL2)
families on a fake (2, 4) mesh: the checks of ``test_torch_dryrun.py``
(its docstring), in a file of their own so each stays under a minute."""
import pytest
import torch

from test_torch_dryrun import FRONTEND_ARCHS, check_smoke_cells, \
    trace_in_child


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def traced():
    return trace_in_child({"data": 2, "model": 4}, full=False, archs=FRONTEND_ARCHS)


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_frontend_smoke_cells_trace(traced, arch):
    check_smoke_cells(traced, arch, "2x4")
