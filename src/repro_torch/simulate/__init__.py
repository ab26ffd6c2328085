"""Simulation tier: hardware book (the TPUs and the H100) + calibrated
step-time model."""
from repro_torch.simulate.hardware import (  # noqa: F401
    H100, HW_BY_NAME, HardwareGen, V5E, V5P, V6E)
from repro_torch.simulate.step_time import StepTimeModel  # noqa: F401
