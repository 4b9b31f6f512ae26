"""On the card, at each configuration's own size: the program as the
configuration states it comes out correct, and the control, the
program's own float8_e5m2 path in place of bfloat16, does not (one seed
each; ``readings.py`` takes the dozen). Skips without an NVIDIA GPU.

    python -m pytest portbench/tests/test_control.py -q -m cuda
"""

import pytest
import torch

import readings


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["p41-awgn.pool", "rate09-bsc.pool"])
def test_the_control_is_not_correct(cuda_device, workload):
    out = readings.readings(workload, [2**31 + 17], [2**31 + 18],
                            device=cuda_device, log=lambda s: None)
    assert out["program"][0]["correct"], out["program"]
    assert not out["control"][0]["correct"], out["control"]
