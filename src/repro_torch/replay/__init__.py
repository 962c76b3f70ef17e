"""Device-resident prioritized replay (port of ``repro/replay``): the
circular ``store`` with its n-step ring, and the PER ``device`` replay on
the sum-tree kernels of ``kernels.replay_tree``. The reference's mesh-
sharded replay (``replay/sharded.py``) is not ported yet."""
from repro_torch.replay.device import (DeviceReplay, DeviceReplayConfig,
                                       ReplayState, replay_add, replay_init,
                                       replay_sample, replay_update)
from repro_torch.replay.store import (nstep_emit_flat, nstep_init,
                                      nstep_push, nstep_push_seq, store_add,
                                      store_gather, store_init)

__all__ = [
    "DeviceReplay", "DeviceReplayConfig", "ReplayState",
    "replay_add", "replay_init", "replay_sample", "replay_update",
    "nstep_emit_flat", "nstep_init", "nstep_push", "nstep_push_seq",
    "store_add", "store_gather", "store_init",
]
