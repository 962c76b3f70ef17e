"""RL algorithms, specs and the inference surface: ``sac``/``td3`` (acting
and updates), ``experiment`` (the spec tree and the ``Experiment`` run
handle), ``runner`` (the superstep), ``sweep`` (``Fleet``, ``Sweep`` and
``MemberResult``: member-batched fleets of runs, exported here),
``presets``, ``envs`` and ``policy`` (the ``Policy`` handle)."""

__all__ = ["Fleet", "MemberResult", "Sweep"]


def __getattr__(name):
    # imported on first use: importing the package stays cheap
    if name in __all__:
        from repro_torch.rl import sweep
        return getattr(sweep, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
