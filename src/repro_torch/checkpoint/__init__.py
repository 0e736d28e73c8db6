"""Checkpoints in the JAX package's format (``checkpoint/ckpt.py``)."""
from repro_torch.checkpoint.ckpt import (SEP, CheckpointCorruptError,
                                         all_steps, latest_step, load,
                                         restore, save)

__all__ = ["SEP", "CheckpointCorruptError", "all_steps", "latest_step",
           "load", "restore", "save"]
