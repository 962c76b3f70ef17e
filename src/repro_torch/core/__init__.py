"""Network building blocks: the connectivity zoo (``blocks``) and OFENet
feature extractors (``ofenet``)."""
