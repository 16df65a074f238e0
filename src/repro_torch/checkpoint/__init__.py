"""Atomic checkpoints of pytrees (training state included) and
``QuantileService`` snapshots, in the JAX package's on-disk format."""
from .checkpoint import (latest_step, restore_checkpoint,
                         restore_checkpoint_flat, restore_service_snapshot,
                         save_checkpoint, save_service_snapshot)

__all__ = ["save_checkpoint", "restore_checkpoint",
           "restore_checkpoint_flat", "latest_step",
           "save_service_snapshot", "restore_service_snapshot"]
