import pytest
import torch


@pytest.fixture
def card():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
    return torch.device("cuda", 0)
