"""The benchmark's own tests: CPU tests at tiny sizes, and tests marked
`card`, which need a CUDA device and skip without one."""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture(autouse=True)
def _card(request):
    if request.node.get_closest_marker("card") is not None:
        import torch

        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
