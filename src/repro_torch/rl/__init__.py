"""RL algorithms, specs and the inference surface: ``sac``/``td3`` (acting
and updates), ``experiment`` (the spec tree and the ``Experiment`` run
handle), ``runner`` (the superstep), ``presets``, ``envs`` and ``policy``
(the ``Policy`` handle)."""
