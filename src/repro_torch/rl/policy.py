"""One way to turn params into actions (port of ``repro/rl/policy.py``).

* ``policy_fns(algo, acfg)`` -> ``(act(params, obs, eps), det(params,
  obs))``: the stochastic collection policy, with its Gaussian noise
  ``eps`` (shape of the action batch) passed in, and the deterministic
  eval/serving policy (SAC mean action / TD3 policy).
* ``Policy`` binds those functions to ``params`` on one device. Calls run
  under ``torch.inference_mode()``; ``with_params`` rebinds cheaply (the
  serving hot-swap) and ``to(device)`` moves the params.
* ``load_params`` / ``save_params`` read and write the ``agent/params``
  subtree of a checkpoint in the reference's format, with the spec in its
  metadata; ``Policy.from_checkpoint`` serves one.
"""
from __future__ import annotations

import collections
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.common import tree_map
from repro_torch.core.ofenet import OFENetConfig
from repro_torch.rl import sac as sac_mod, td3 as td3_mod
from repro_torch.rl.envs import make_env

# the checkpoint flattens the training state with attribute paths
# (`loop/.agent/...`): a namedtuple renders the same leaf keys
_LoopTemplate = collections.namedtuple("_LoopTemplate", ["agent"])


def algo_config(spec, env):
    """``SACConfig``/``TD3Config`` for an ``ExperimentSpec`` and env dims."""
    ofe_cfg: Optional[OFENetConfig] = None
    if spec.ofenet.enabled:
        ofe_cfg = spec.ofenet_config(env.obs_dim, env.act_dim)
    n = spec.network
    common = dict(obs_dim=env.obs_dim, act_dim=env.act_dim,
                  num_units=n.num_units, num_layers=n.num_layers,
                  connectivity=n.connectivity, activation=n.activation,
                  block_backend=n.block_backend, ofenet=ofe_cfg,
                  grad_norms=spec.obs.enabled and spec.obs.grad_norms)
    cls = sac_mod.SACConfig if spec.algo == "sac" else td3_mod.TD3Config
    return cls(**common)


def policy_fns(algo: str, acfg) -> Tuple[Callable, Callable]:
    """``(act(params, obs, eps), det(params, obs))`` for one algorithm,
    both on a BATCH of observations."""
    if algo == "sac":
        def act(params, obs, eps):
            a, _ = sac_mod.sample_action(params, acfg, obs, eps)
            return a

        def det(params, obs):
            return sac_mod.mean_action(params, acfg, obs)
        return act, det
    if algo == "td3":
        def act(params, obs, eps):
            a = td3_mod.policy(params, acfg, obs)
            return torch.clamp(a + acfg.expl_noise * eps, -1, 1)

        def det(params, obs):
            return td3_mod.policy(params, acfg, obs)
        return act, det
    raise ValueError(f"unknown algo {algo!r}")


class _PolicyCore:
    """The params-independent half of a ``Policy``, shared by every
    ``with_params`` copy."""

    def __init__(self, algo: str, acfg, env_name: str = ""):
        self.algo = algo
        self.acfg = acfg
        self.env_name = env_name
        self.obs_dim = acfg.obs_dim
        self.act_dim = acfg.act_dim
        self.act, self.det = policy_fns(algo, acfg)


class Policy:
    """``params`` on ``device`` bound to one algorithm's act/det functions.

    >>> pol = Policy.from_checkpoint("run.npz")            # on the card
    >>> a = pol.act_deterministic(obs)                     # one obs or a batch
    >>> a = pol.act(obs, torch.Generator("cuda"))          # stochastic

    A single observation ``(obs_dim,)`` goes through the network as a batch
    of one (``obs[None] -> action[0]``); batches pass unchanged.
    """

    def __init__(self, core: _PolicyCore, params: Any,
                 device: torch.device):
        self._core = core
        self.params = params
        self.device = device

    # -------------------------------------------------------- constructors
    @classmethod
    def from_spec(cls, spec, params=None, *, env=None,
                  device: DeviceLike = None) -> "Policy":
        """A handle for ``spec``'s algorithm/network, optionally bound to
        ``params`` (bind later with ``with_params``)."""
        env = env if env is not None else make_env(spec.env)
        core = _PolicyCore(spec.algo, algo_config(spec, env), spec.env)
        return cls(core, params, resolve_device(device))

    @classmethod
    def from_checkpoint(cls, path: str,
                        device: DeviceLike = None) -> "Policy":
        """A serving handle from a checkpoint of either package: spec from
        its metadata, only the ``agent/params`` subtree restored."""
        dev = resolve_device(device)
        spec, params = load_params(path, device=dev)
        return cls.from_spec(spec, params, device=dev)

    def with_params(self, params) -> "Policy":
        """Same functions and device, new parameters."""
        return Policy(self._core, params, self.device)

    def to(self, device: DeviceLike) -> "Policy":
        """This policy with its params moved to ``device``."""
        dev = resolve_device(device)
        params = None if self.params is None else tree_map(
            lambda t: t.to(dev), self.params)
        return Policy(self._core, params, dev)

    # ------------------------------------------------------------- acting
    def _batched(self, obs) -> Tuple[torch.Tensor, bool]:
        if isinstance(obs, np.ndarray):
            obs = torch.from_numpy(np.asarray(obs, dtype=np.float32))
        ob = torch.as_tensor(obs, dtype=torch.float32).to(self.device)
        if ob.ndim == 1:
            return ob[None], True
        return ob, False

    def _require_params(self):
        if self.params is None:
            raise ValueError(
                "Policy has no params bound — build it with "
                "from_checkpoint or call with_params()")

    def act(self, obs, generator: torch.Generator) -> torch.Tensor:
        """Stochastic action(s) for collection: SAC tanh-Gaussian sample /
        TD3 policy + clipped exploration noise, noise drawn from
        ``generator`` (on this policy's device)."""
        self._require_params()
        with torch.inference_mode():
            ob, single = self._batched(obs)
            eps = torch.randn((ob.shape[0], self.act_dim), generator=generator,
                              device=self.device)
            a = self._core.act(self.params, ob, eps)
        return a[0] if single else a

    def act_deterministic(self, obs) -> torch.Tensor:
        """Deterministic action(s) for evaluation and serving."""
        self._require_params()
        with torch.inference_mode():
            ob, single = self._batched(obs)
            a = self._core.det(self.params, ob)
        return a[0] if single else a

    # ------------------------------------------------------- introspection
    @property
    def act_fn(self) -> Callable:
        """The raw ``act(params, obs_batch, eps)`` function."""
        return self._core.act

    @property
    def algo(self) -> str:
        return self._core.algo

    @property
    def acfg(self):
        return self._core.acfg

    @property
    def obs_dim(self) -> int:
        return self._core.obs_dim

    @property
    def act_dim(self) -> int:
        return self._core.act_dim


def load_params(path: str, spec=None, *,
                device: DeviceLike = None) -> Tuple[Any, Any]:
    """``(spec, agent_params)`` from a checkpoint written by either
    package's ``Experiment.save`` or by ``save_params``.

    Restores ONLY the ``loop/.agent/params`` leaves, against a template
    built on the ``meta`` device (shapes only, nothing materialized). Pass
    ``spec`` to skip re-parsing the checkpoint metadata."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.rl.experiment import ExperimentSpec

    dev = resolve_device(device)
    if spec is None:
        meta = ckpt.load_metadata(path)
        if meta is None or "spec" not in meta:
            raise FileNotFoundError(
                f"{path}: no spec-bearing checkpoint metadata — was this "
                f"saved by Experiment.save or save_params?")
        spec = ExperimentSpec.from_dict(meta["spec"])
    acfg = algo_config(spec, make_env(spec.env))
    init = sac_mod.sac_init if spec.algo == "sac" else td3_mod.td3_init
    template = init(acfg, torch.Generator(), device="meta")["params"]
    tree = ckpt.restore(path, {"loop": _LoopTemplate(
        agent={"params": template})}, dev)
    return spec, tree["loop"].agent["params"]


def save_params(path: str, spec, params: Any) -> None:
    """Write ``params`` as a checkpoint ``load_params`` (either package's)
    reads: the ``loop/.agent/params`` leaves, the spec in the metadata."""
    from repro_torch.checkpoint import ckpt
    ckpt.save(path, {"loop": _LoopTemplate(agent={"params": params})},
              metadata={"spec": spec.to_dict()})
