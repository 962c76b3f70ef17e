"""``collect_ms`` in the host-replay cell, where it moves
``updates_per_s.host_replay``: the device time of segment A (the draws,
the collect, the n-step ring and their copy-back), the most that
overlapping the host replay with the next segment A could save."""
from bench import registry

_BASE = registry.reader("layer_metrics", "collect_ms")
UNIT, LAYER, read = _BASE.UNIT, _BASE.LAYER, _BASE.read
MOVES = "updates_per_s.host_replay"
