"""The operation and byte counts against hand-worked small blocks, and
the counted nets against the blocks the system builds from the same
configuration."""
import pytest

from bench import count, registry

# densenet, input 3, 2 layers of 4, out 2: products (K, N, input columns)
DENSE = count.Net("d", 3, 4, 2, "densenet", 2)
# mlp, input 3, 2 layers of 4, out 2
MLP = count.Net("m", 3, 4, 2, "mlp", 2)


def test_products_by_hand():
    assert DENSE.products() == [(3, 4, 3), (7, 4, 3), (11, 2, 3)]
    assert MLP.products() == [(3, 4, 3), (4, 4, 0), (4, 2, 0)]
    assert DENSE.feature_dim == 11 and MLP.feature_dim == 4
    assert DENSE.params() == 3 * 4 + 4 + 7 * 4 + 4 + 11 * 2 + 2


def test_flops_by_hand():
    m = 5
    assert DENSE.fwd_flops(m) == 2 * m * (12 + 28 + 22)
    # dW of every product; dx without the input's 3 columns
    assert DENSE.bwd_flops(m, dw=True, dx_input=False) == \
        2 * m * (12 + 28 + 22) + 2 * m * (4 * 0 + 4 * 4 + 2 * 8)
    assert DENSE.bwd_flops(m, dw=False, dx_input=True) == 2 * m * 62
    assert MLP.bwd_flops(m, dw=False, dx_input=False) == \
        2 * m * (0 + 16 + 8)


def test_bytes_by_hand():
    m = 5
    assert DENSE.fwd_bytes(m) == 4 * (m * 3 + DENSE.params() + m * 11
                                      + m * 2)
    assert DENSE.fwd_bwd_bytes(m) == DENSE.fwd_bytes(m) + 4 * (
        m * 2 + m * 3 + DENSE.params())
    assert count.adamw_bytes(10) == 280
    assert count.least_seconds(495e12, 0) == pytest.approx(1.0)
    assert count.least_seconds(0, 3.35e12) == pytest.approx(1.0)


def test_update_flops_of_the_paper_agents():
    dense = count.update_flops(registry.config("sac-densenet2048"))
    mlp = count.update_flops(registry.config("sac-mlp2048"))
    # about 4 actor and 13 critic forward-equivalents at 256 rows
    assert 50e9 < dense < 60e9
    assert 33e9 < mlp < 40e9


@pytest.mark.parametrize("name", ["sac-densenet2048", "sac-mlp2048"])
def test_counted_nets_are_the_systems_blocks(name):
    from repro_torch.rl.experiment import ExperimentSpec
    from repro_torch.rl.policy import algo_config
    from repro_torch.rl.envs import make_env
    config = registry.config(name)
    spec = ExperimentSpec.from_dict(config["spec"])
    env = make_env(spec.env)
    assert (env.obs_dim, env.act_dim, env.max_episode_steps) == (
        config["constants"]["obs_dim"], config["constants"]["act_dim"],
        config["constants"]["max_episode_steps"])
    acfg = algo_config(spec, env)
    nets = count.nets(config)
    blocks = {"actor": acfg.actor_block(), "critic": acfg.critic_block()}
    if acfg.ofenet is not None:
        blocks.update(phi_s=acfg.ofenet.state_block,
                      phi_sa=acfg.ofenet.sa_block)
    for k, b in blocks.items():
        n = nets[k]
        assert (n.in_dim, n.units, n.layers, n.connectivity, n.out_dim) == \
            (b.in_dim, b.num_units, b.num_layers, b.connectivity,
             b.out_dim), k
        assert n.feature_dim == b.feature_dim
    assert set(nets) == set(blocks) | ({"pred"} if acfg.ofenet else set())


@pytest.mark.parametrize("name", ["sac-densenet2048", "sac-mlp2048"])
def test_optimized_params_are_the_systems(name):
    import torch
    from repro_torch.rl.experiment import ExperimentSpec
    from repro_torch.rl.policy import algo_config
    from repro_torch.rl.envs import make_env
    from repro_torch.common import tree_leaves
    from repro_torch.rl.sac import sac_init
    spec = ExperimentSpec.from_dict(registry.config(name)["spec"]).override(
        num_units=16)
    config = {**registry.config(name), "spec": spec.to_dict()}
    acfg = algo_config(spec, make_env(spec.env))
    state = sac_init(acfg, torch.Generator().manual_seed(0), "cpu")
    mu = [t for g in state["opt"].values() for t in tree_leaves(g["mu"])]
    assert count.optimized_params(config) == sum(t.numel() for t in mu)

