"""RL algorithms, specs and the inference surface: ``sac``/``td3`` (acting
path), ``experiment`` (the spec tree), ``presets``, ``envs`` (dims) and
``policy`` (the ``Policy`` handle)."""
