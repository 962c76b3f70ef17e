"""``device_idle`` in the host-paced cells, where it moves
``updates_per_s.host_replay``: the share of the traced sub-window in
which the card waits on the host."""
from bench import registry

_BASE = registry.reader("layer_metrics", "device_idle")
UNIT, LAYER, read = _BASE.UNIT, _BASE.LAYER, _BASE.read
MOVES = "updates_per_s.host_replay"
