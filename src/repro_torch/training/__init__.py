"""Training substrate: optimizers, the train step, data, checkpoints."""
from repro_torch.training.checkpoint import CheckpointManager  # noqa: F401
from repro_torch.training.compression import (  # noqa: F401
    compress_int8, decompress_int8, error_feedback_update)
from repro_torch.training.data import SyntheticDataLoader  # noqa: F401
from repro_torch.training.optimizer import adamw, adamw8bit  # noqa: F401
from repro_torch.training.train_step import build_train_step  # noqa: F401
