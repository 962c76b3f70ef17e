"""Table 1: the highest average return, ours against the original, SAC
and TD3, across environments (port of ``benchmarks/table1_final.py``).

Paper: 5 MuJoCo locomotion tasks. Here: the port's device environments,
3 at quick and 5 at paper (the orderings are the claim; absolute returns
depend on the environment).

    python -m repro_torch.figures.table1_final [--scale quick]
        [--device cpu]
"""
from __future__ import annotations

from repro_torch.figures import common


def run(scale: str = "quick", *, device=None):
    envs = (["pendulum", "cartpole_swingup", "pointmass"] if scale == "quick"
            else ["pendulum", "cartpole_swingup", "pointmass", "reacher2",
                  "acrobot"])
    rows = []
    for env in envs:
        for algo in ("sac", "td3"):
            ours = common.make_spec(scale, "table1-ours", env=env, algo=algo)
            rows.append(common.bench_run(
                f"table1_{env}_{algo}_ours", ours,
                {"env": env, "algo": algo, "kind": "ours"}, device=device))
            orig = common.make_spec(scale, "table1-orig", env=env, algo=algo)
            rows.append(common.bench_run(
                f"table1_{env}_{algo}_orig", orig,
                {"env": env, "algo": algo, "kind": "orig"}, device=device))
    return rows


if __name__ == "__main__":
    common.main(run)
