"""Checkpoint save/restore through collective I/O, and the host layer
under it: the in-process host executor and the multi-process transport
behind :class:`HostCollectiveIO`."""
from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    CheckpointManager, PendingCheckpoint, build_manifest,
    manifest_fingerprint, restore_checkpoint, save_checkpoint,
    snapshot_tree,
)
from repro_torch.checkpoint.host_io import (  # noqa: F401
    HostCollectiveIO, IOTimings, resolve_knobs,
)
