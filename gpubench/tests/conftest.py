import pytest


@pytest.fixture
def cuda_device():
    """The first CUDA card; skips the test where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
