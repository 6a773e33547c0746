"""Numpy-archive checkpoints of nested dicts, lists and tuples of tensors or
arrays (the port's counterpart of ``repro.checkpoint``)."""
from repro_torch.checkpoint.ckpt import (latest_step, load_checkpoint,
                                         read_checkpoint, save_checkpoint)

__all__ = ["latest_step", "load_checkpoint", "read_checkpoint", "save_checkpoint"]
