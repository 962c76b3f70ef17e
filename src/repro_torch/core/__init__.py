"""Network building blocks: the connectivity zoo (``blocks``), OFENet
feature extractors (``ofenet``), the effective rank of features
(``effective_rank``) and loss-landscape slices (``loss_landscape``)."""
