"""The on-device suite runs only where PyTorch sees a CUDA device.

Without one every case is collected and skips, so a run on a machine
without a GPU still shows the suite whole.  ``chip_smoke.py`` (phase 4g)
runs the suite on the card and counts a skip there as a failure.  The
check is made in a fixture, when a case runs, never at import or
collection.
"""
import pytest
import torch


@pytest.fixture(autouse=True)
def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the suite runs the port's kernels")
