"""Paper-scenario preset registry (port of ``repro/rl/presets.py``).

The same named ``ExperimentSpec``s as the reference, as data: every preset
carries the CPU-quick budget, and drivers derive variants with
``.override(...)``. ``presets.get(n).to_dict()`` equals the reference's for
every name (held by the tests).
"""
from __future__ import annotations

from typing import Callable, Dict, Union

from repro_torch.rl.experiment import ExperimentSpec, SpecError

_QUICK_BUDGET = dict(total_steps=500, warmup_steps=250, eval_every=125,
                     eval_episodes=3, replay_capacity=50_000,
                     batch_size=128, n_core=1, n_env=16, ofenet_units=16,
                     ofenet_layers=2)

_BASE = ExperimentSpec().override(**_QUICK_BUDGET)

_PRESETS: Dict[str, ExperimentSpec] = {
    "fig1-depth": _BASE.override(
        algo="sac", num_units=32, num_layers=2, connectivity="mlp",
        use_ofenet=False, distributed=False, srank_every=150),
    "fig3-width": _BASE.override(
        algo="sac", num_units=64, num_layers=2, connectivity="mlp",
        use_ofenet=False, distributed=False, srank_every=150),
    "fig4-grid": _BASE.override(
        algo="sac", num_units=32, num_layers=1, connectivity="mlp",
        use_ofenet=False, distributed=False),
    "fig5-connectivity": _BASE.override(
        algo="sac", num_units=32, num_layers=2, connectivity="densenet",
        use_ofenet=False, distributed=False, srank_every=150),
    "fig6-ofenet": _BASE.override(
        algo="sac", num_units=32, num_layers=2, connectivity="densenet",
        use_ofenet=True, distributed=False, srank_every=150),
    "fig8-distributed": _BASE.override(
        algo="sac", num_units=32, num_layers=2, connectivity="densenet",
        use_ofenet=True, distributed=True, n_core=2, n_env=16),
    "fig10-ablation": _BASE.override(
        algo="sac", num_units=128, num_layers=2, connectivity="densenet",
        use_ofenet=True, distributed=True, n_core=2, n_env=16),
    "fig13-activation": _BASE.override(
        algo="sac", num_units=64, num_layers=2, connectivity="densenet",
        activation="swish", use_ofenet=True, distributed=False),
    "table1-ours": _BASE.override(
        num_units=128, num_layers=2, connectivity="densenet",
        use_ofenet=True, distributed=True, n_core=2, n_env=16),
    "table1-orig": _BASE.override(
        num_units=32, num_layers=2, connectivity="mlp", activation="relu",
        use_ofenet=False, distributed=False, n_env=1),
    "quickstart": _BASE.override(
        algo="sac", num_units=128, num_layers=2, connectivity="densenet",
        use_ofenet=True, ofenet_units=32, ofenet_layers=4,
        distributed=True, n_core=2, n_env=16, total_steps=1000,
        warmup_steps=300, eval_every=125, srank_every=125),
    "rl-distributed": _BASE.override(
        algo="sac", num_units=128, num_layers=2, connectivity="densenet",
        use_ofenet=True, ofenet_units=32, ofenet_layers=2,
        distributed=True, n_core=2, n_env=16, total_steps=800,
        warmup_steps=300, eval_every=400,
        replay_backend="device", loop="scan"),
    "smoke": _BASE.override(
        num_units=16, num_layers=1, use_ofenet=False, n_core=1, n_env=4,
        total_steps=12, warmup_steps=8, eval_every=6, eval_episodes=1,
        replay_capacity=256, batch_size=16),
    "fleet-smoke": _BASE.override(
        num_units=16, num_layers=1, use_ofenet=False, n_core=1, n_env=4,
        total_steps=64, warmup_steps=16, eval_every=32, eval_episodes=1,
        replay_capacity=256, batch_size=8, prioritized=False,
        replay_backend="device", loop="scan"),
}


def names() -> tuple:
    return tuple(sorted(_PRESETS))


def get(name: str) -> ExperimentSpec:
    """The named scenario's base spec (immutable; derive with .override)."""
    if name not in _PRESETS:
        raise SpecError(f"unknown preset {name!r}; have {sorted(_PRESETS)}")
    return _PRESETS[name]


def register(name: str,
             spec: Union[ExperimentSpec,
                         Callable[[], ExperimentSpec]]) -> None:
    """Add a project-local scenario (callables are resolved immediately)."""
    if name in _PRESETS:
        raise SpecError(f"preset {name!r} already registered")
    if callable(spec):
        spec = spec()
    if not isinstance(spec, ExperimentSpec):
        raise SpecError(f"preset {name!r} must be an ExperimentSpec, got "
                        f"{type(spec).__name__}")
    _PRESETS[name] = spec
