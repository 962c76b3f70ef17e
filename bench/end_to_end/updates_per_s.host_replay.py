"""``updates_per_s`` in the cells whose step the host paces (the host
replay between two graphs): the same count over the same wall, held to a
bound of its own, so that the host's noise there does not set the bound
of the cells that the card paces."""
from bench import registry

UNIT = "updates/s"
read = registry.reader("end_to_end", "updates_per_s").read
