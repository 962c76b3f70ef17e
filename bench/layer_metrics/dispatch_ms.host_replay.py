"""``dispatch_ms`` in the host-paced cells, where it moves
``updates_per_s.host_replay``: there the span holds the host's waits on
the card between the two graphs, which overlapping the host's work with
the card's would shorten."""
from bench import registry

_BASE = registry.reader("layer_metrics", "dispatch_ms")
UNIT, LAYER, read = _BASE.UNIT, _BASE.LAYER, _BASE.read
MOVES = "updates_per_s.host_replay"
