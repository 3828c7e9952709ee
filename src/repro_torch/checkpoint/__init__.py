"""Checkpoint and restore of solves (counterpart of
``repro.checkpoint``): ``CheckpointConfig(every=k)`` arms a segmented
drive that snapshots the solver state at drained-ring interrupt
boundaries, in the JAX package's content-hashed, versioned file format,
and resumes bitwise on the same device (certified by one true-residual
recompute on restore).  ``every=0`` leaves the solvers' path untouched.
Over ranks (``MultiprocessBackend``) the vector leaves are gathered at each
boundary and rank 0 writes the same file, which a restore on any rank
count of the same row order, or on one device, reads back
(``parallel.distributed.distributed_checkpointed_solve``)."""

from repro_torch.checkpoint.format import (CKPT_VERSION,
                                           CheckpointCertificationError,
                                           CheckpointCorruptError,
                                           CheckpointError,
                                           CheckpointMismatchError,
                                           CheckpointVersionError,
                                           content_hash, load_checkpoint,
                                           save_checkpoint)
from repro_torch.checkpoint.solve import (LAST_RESTORE, SNAPSHOTS,
                                          CheckpointConfig, checkpoint_path,
                                          checkpointed_solve, effective_kw,
                                          latest_checkpoint,
                                          list_checkpoints,
                                          load_slab_checkpoint, make_rel_fn,
                                          run_segmented,
                                          save_slab_checkpoint,
                                          state_payload, state_restore,
                                          vector_leaves)

__all__ = [
    "CKPT_VERSION",
    "CheckpointError",
    "CheckpointCorruptError",
    "CheckpointVersionError",
    "CheckpointMismatchError",
    "CheckpointCertificationError",
    "CheckpointConfig",
    "content_hash",
    "save_checkpoint",
    "load_checkpoint",
    "checkpoint_path",
    "list_checkpoints",
    "latest_checkpoint",
    "checkpointed_solve",
    "effective_kw",
    "make_rel_fn",
    "run_segmented",
    "state_payload",
    "state_restore",
    "save_slab_checkpoint",
    "load_slab_checkpoint",
    "vector_leaves",
    "LAST_RESTORE",
    "SNAPSHOTS",
]
