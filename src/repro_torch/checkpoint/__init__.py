"""Checkpoints of flat leaf lists and ``QuantileService`` snapshots, in the
JAX package's on-disk format."""
from .checkpoint import (save_checkpoint, restore_checkpoint_flat,
                         latest_step, save_service_snapshot,
                         restore_service_snapshot)

__all__ = ["save_checkpoint", "restore_checkpoint_flat", "latest_step",
           "save_service_snapshot", "restore_service_snapshot"]
