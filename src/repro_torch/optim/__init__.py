"""Optimizers (port of ``repro/optim``): AdamW with grad clipping."""
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     adamw_update_ref,
                                     clip_by_global_norm, global_norm,
                                     warmup_cosine)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "adamw_update_ref",
           "clip_by_global_norm", "global_norm", "warmup_cosine"]
