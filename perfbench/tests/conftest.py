"""The benchmark's tests.  Those that need a CUDA card carry the ``card``
marker and take the ``card`` fixture, which skips them where there is
none (decided when the test runs, never at import or collection);
``PYTHONPATH=src python -m pytest perfbench/tests -m card`` runs them
on the chip."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips elsewhere); run with "
                   "-m card on the chip")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _few_threads():
    """Two intra-op threads while a test of this folder runs: parallel test
    workers share the machine's cores, and the CPU runs of the engine
    slow down many times over when each worker's thread pool claims
    all of them."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
