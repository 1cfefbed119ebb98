"""The ``chip`` marker for tests that need the card (they are
skipped, decided inside the ``cuda`` fixture, where there is none)."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card (skipped without one)")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def own_tmpdir(tmp_path, monkeypatch):
    """Each test writes its asset root under a directory of its own (the
    workers of one test run share ``TMPDIR``)."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
