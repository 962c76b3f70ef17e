"""The paper's figure and table drivers on the port (counterparts of the
reference's ``benchmarks/`` drivers, one module each under the same name,
and of ``examples/width_study.py`` and ``examples/rl_distributed.py``).

    python -m repro_torch.figures.run [--scale quick|paper] [--only fig3]
        [--smoke] [--device cpu]

Each driver's ``run(scale, *, device=None)`` returns rows of
``common.bench_run``'s schema; the card is the default device. See
``common`` for the budget and ``run`` for the harness.
"""
