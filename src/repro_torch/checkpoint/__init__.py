"""``repro_torch.checkpoint``: full federation-state checkpoints and resume
(port of ``repro.checkpoint.state`` and ``repro.checkpoint.manager``)."""
from repro_torch.checkpoint.manager import (CheckpointManager, CheckpointPolicy,
                                            latest_checkpoint, list_steps, load_checkpoint,
                                            resume_key)
from repro_torch.checkpoint.state import (load_state, pack_tree, save_state, snapshot,
                                          unpack_tree, write_snapshot)

__all__ = ["CheckpointManager", "CheckpointPolicy", "latest_checkpoint", "list_steps",
           "load_checkpoint", "load_state", "pack_tree", "resume_key", "save_state",
           "snapshot", "unpack_tree", "write_snapshot"]
