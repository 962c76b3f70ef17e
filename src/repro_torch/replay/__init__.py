"""Device-resident prioritized replay (port of ``repro/replay``): the
circular ``store`` with its n-step ring, the PER ``device`` replay on the
sum-tree kernels of ``kernels.replay_tree``, and its ``sharded`` form (n
logical shards of one run on a leading axis of one device, each shard's
add, sample and refresh one member-axis kernel launch for all shards)."""
from repro_torch.replay.device import (DeviceReplay, DeviceReplayConfig,
                                       ReplayState, replay_add, replay_init,
                                       replay_sample, replay_update)
from repro_torch.replay.sharded import (collect_and_add_sharded,
                                        sharded_nstep_init,
                                        sharded_replay_add,
                                        sharded_replay_init,
                                        sharded_replay_sample,
                                        sharded_replay_update)
from repro_torch.replay.store import (nstep_emit_flat, nstep_init,
                                      nstep_push, nstep_push_seq, store_add,
                                      store_gather, store_init)

__all__ = [
    "DeviceReplay", "DeviceReplayConfig", "ReplayState",
    "replay_add", "replay_init", "replay_sample", "replay_update",
    "collect_and_add_sharded", "sharded_nstep_init", "sharded_replay_add",
    "sharded_replay_init", "sharded_replay_sample", "sharded_replay_update",
    "nstep_emit_flat", "nstep_init", "nstep_push", "nstep_push_seq",
    "store_add", "store_gather", "store_init",
]
