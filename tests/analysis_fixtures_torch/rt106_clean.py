"""Must NOT trigger RT106: torch, numpy, the port, triton in a function."""
import numpy as np
import torch

from repro_torch.core import state

from . import rt105_clean


def launch(x):
    import triton

    return triton, np.asarray(x), torch.as_tensor(x), state, rt105_clean
