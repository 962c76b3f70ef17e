"""Plain float32 reference of the superstep that the benchmark's cells
train, written from the paper (arXiv:2102.07920, A.1-A.4) and the
configuration file's constants, in plain torch.

One superstep: every actor takes one pendulum step with the tanh-Gaussian
policy's noisy action; the rows go into the prioritized replay at the
highest priority seen; a stratified proportional sample of ``batch`` rows
with importance weights; the OFENet auxiliary step (next-state
prediction), the SAC critic (Huber, twin critics, targets from the old
target critics and temperature), actor and temperature steps, each with
AdamW; the target critics' and OFENet target's EMA; the sampled rows'
priorities refreshed from the new critic's TD errors.

State is held as dicts keyed by leaf path (``params/actor/layers/0/dense/w``
and ``opt/actor/mu/layers/0/dense/w``), the names a checkpoint of the
system under test uses. ``init_starts`` makes a run's start from its seed
alone (fan-in uniform weights, zero biases, targets equal to their nets,
AdamW at zero, a uniform-action warm-up of the replay), and the benchmark
hands that one start to both sides.
The replay's priorities live in float64: the reference's sample is exact
where the system's float32 sum-tree rounds. Random draws come from one
``torch.Generator`` per run in the order the configuration's superstep
takes them (collect noise, reset draws, the device replay's stratum
uniforms, then the update's two Gaussian draws); the host replay's
stratum targets come from a NumPy generator. Both generators start where
``init_starts`` leaves them.

``Variant`` switches the deliberate departures that the correctness check
is shown to catch: TF32 products (the control), half of the batch left
out, a state left unchanged, a collected reward altered, a sampled row
shifted by one.

Nothing here imports the system under test.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch

Tree = Dict[str, torch.Tensor]


# ----------------------------------------------------------------- config
@dataclasses.dataclass(frozen=True)
class RefConfig:
    """What one superstep needs, read from a configuration file."""
    obs_dim: int
    act_dim: int
    units: int
    layers: int
    connectivity: str
    ofenet_units: int          # 0: no OFENet
    ofenet_layers: int
    ofenet_connectivity: str
    batch: int
    n_actors: int
    capacity: int
    host: bool                 # the NumPy replay's sampler
    gamma: float
    tau: float
    ofenet_tau: float
    lr: float
    b1: float
    b2: float
    adam_eps: float
    per_alpha: float
    per_beta: float
    per_eps: float
    log_std_min: float
    log_std_max: float
    huber_delta: float
    max_episode_steps: int
    init_alpha: float
    warmup_steps: int

    @property
    def ofenet(self) -> bool:
        return self.ofenet_units > 0

    @classmethod
    def from_files(cls, config: dict, traffic: dict) -> "RefConfig":
        spec, c = config["spec"], config["constants"]
        net, ofe, rep, ex = (spec["network"], spec["ofenet"], spec["replay"],
                             spec["execution"])
        if spec["env"] != "pendulum":
            raise ValueError(f"the reference has no env {spec['env']!r}")
        if spec["algo"] != "sac":
            raise ValueError(f"the reference has no algo {spec['algo']!r}")
        if rep["n_step"] != 1 or not rep["prioritized"]:
            raise ValueError("the reference replays 1-step prioritized rows")
        if net["activation"] != "swish" or (
                ofe["enabled"] and (ofe["activation"] != "swish"
                                    or ofe["batch_norm"])):
            raise ValueError("the reference's nets are swish without BN")
        n_actors = ex["n_core"] * ex["n_env"] if ex["distributed"] else 1
        backend = traffic.get("overrides", {}).get("replay.backend",
                                                   rep["backend"])
        return cls(
            obs_dim=c["obs_dim"], act_dim=c["act_dim"],
            units=net["num_units"], layers=net["num_layers"],
            connectivity=net["connectivity"],
            ofenet_units=ofe["num_units"] if ofe["enabled"] else 0,
            ofenet_layers=ofe["num_layers"],
            ofenet_connectivity=ofe["connectivity"],
            batch=ex["batch_size"], n_actors=n_actors,
            capacity=rep["capacity"], host=backend == "host",
            gamma=c["gamma"], tau=c["tau"], ofenet_tau=c["ofenet_tau"],
            lr=c["lr"], b1=c["adam_b1"],
            b2=c["adam_b2"], adam_eps=c["adam_eps"],
            per_alpha=c["per_alpha"], per_beta=c["per_beta"],
            per_eps=c["per_eps"], log_std_min=c["log_std_min"],
            log_std_max=c["log_std_max"], huber_delta=c["huber_delta"],
            max_episode_steps=c["max_episode_steps"],
            init_alpha=c["init_alpha"], warmup_steps=ex["warmup_steps"])


@dataclasses.dataclass(frozen=True)
class Variant:
    """A departure from the configuration (all off: the reference)."""
    tf32: bool = False          # products on TF32-rounded inputs
    half_batch: bool = False    # losses over the batch's first half only
    frozen: bool = False        # the update returns the state unchanged
    reward_shift: float = 0.0   # added to actor 0's reward where produced
    sample_shift: int = 0       # every sampled row moved by this many rows


SOUND = Variant()


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32's 10-bit mantissa (to nearest, ties away)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """``a @ b`` with every product's inputs rounded to TF32, the
    backward's too, as TF32 tensor cores take them."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return round_tf32(a) @ round_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return g @ round_tf32(b).T, round_tf32(a).T @ g


def _mm(var: Variant):
    if var.tf32:
        return _TF32MatMul.apply
    return lambda a, b: a @ b


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


# ------------------------------------------------------------- pendulum
G, M, L, DT, MAX_SPEED, MAX_TORQUE = 10.0, 1.0, 1.0, 0.05, 8.0, 2.0


def _obs(th: torch.Tensor, thd: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.cos(th), torch.sin(th), thd / MAX_SPEED],
                       dim=-1)


def pendulum_obs(q: torch.Tensor, qd: torch.Tensor) -> torch.Tensor:
    return _obs(q[:, 0], qd[:, 0])


def _uniform(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    lo32 = np.float32(lo)
    span = np.float32(np.float32(hi) - lo32)
    return torch.clamp(u * float(span) + float(lo32), min=float(lo32))


def pendulum_reset(draws: torch.Tensor):
    th = _uniform(draws[:, 0], -math.pi, math.pi)
    thd = _uniform(draws[:, 1], -1.0, 1.0)
    return th[:, None], thd[:, None]


def _cost(th, thd, u):
    norm_th = torch.remainder(th + math.pi, 2 * math.pi) - math.pi
    return norm_th ** 2 + 0.1 * thd ** 2 + 0.001 * u ** 2


def _advance(th, thd, u):
    thd = torch.clamp(thd + (3 * G / (2 * L) * torch.sin(th)
                             + 3.0 / (M * L ** 2) * u) * DT,
                      -MAX_SPEED, MAX_SPEED)
    return th + thd * DT, thd


def pendulum_step(q, qd, a):
    """``(q', qd', reward)`` of one step; the pendulum never terminates."""
    u = torch.clamp(a[:, 0], -1, 1) * MAX_TORQUE
    th, thd = q[:, 0], qd[:, 0]
    cost = _cost(th, thd, u)
    th, thd = _advance(th, thd, u)
    return th[:, None], thd[:, None], -cost


# ------------------------------------------------------------------ nets
def net_apply(P: Tree, prefix: str, x: torch.Tensor, connectivity: str,
              mm) -> tuple:
    """``(output, feature)`` of the block under ``prefix``: dense layers
    with swish, densenet (each layer reads every earlier output beside the
    input) or mlp, then the linear ``out`` layer when it has one."""
    if connectivity not in ("densenet", "mlp"):
        raise ValueError(f"the reference has no {connectivity!r} block")
    stream = h = x
    i = 0
    while f"{prefix}/layers/{i}/dense/w" in P:
        inp = stream if connectivity == "densenet" else h
        h = swish(mm(inp, P[f"{prefix}/layers/{i}/dense/w"])
                  + P[f"{prefix}/layers/{i}/dense/b"])
        if connectivity == "densenet":
            stream = torch.cat([stream, h], dim=-1)
        i += 1
    feat = stream if connectivity == "densenet" else h
    if f"{prefix}/out/w" in P:
        return mm(feat, P[f"{prefix}/out/w"]) + P[f"{prefix}/out/b"], feat
    return feat, feat


def features(P: Tree, cfg: RefConfig, s, a, mm):
    """``(z_s, z_sa)``: OFENet's online features, or the raw inputs."""
    if not cfg.ofenet:
        return s, None if a is None else torch.cat([s, a], dim=-1)
    conn = cfg.ofenet_connectivity
    z_s, _ = net_apply(P, "params/ofenet/online/phi_s", s, conn, mm)
    if a is None:
        return z_s, None
    z_sa, _ = net_apply(P, "params/ofenet/online/phi_sa",
                        torch.cat([z_s, a], dim=-1), conn, mm)
    return z_s, z_sa


def sample_action(P: Tree, cfg: RefConfig, s, eps, mm):
    """Tanh-squashed Gaussian action and its log-probability."""
    z_s, _ = features(P, cfg, s, None, mm)
    out, _ = net_apply(P, "params/actor", z_s, cfg.connectivity, mm)
    mu, log_std = torch.chunk(out, 2, dim=-1)
    log_std = torch.clamp(log_std, cfg.log_std_min, cfg.log_std_max)
    pre = mu + torch.exp(log_std) * eps
    a = torch.tanh(pre)
    logp = torch.sum(-0.5 * (eps ** 2 + 2 * log_std + math.log(2 * math.pi))
                     - torch.log(torch.clamp(1 - a ** 2, min=1e-6)), dim=-1)
    return a, logp


def q_pair(P: Tree, critics: str, cfg: RefConfig, s, a, mm):
    _, z_sa = features(P, cfg, s, a, mm)
    q1, _ = net_apply(P, f"{critics}/q1", z_sa, cfg.connectivity, mm)
    q2, _ = net_apply(P, f"{critics}/q2", z_sa, cfg.connectivity, mm)
    return q1[:, 0], q2[:, 0]


def huber(x: torch.Tensor, delta: float) -> torch.Tensor:
    a = torch.abs(x)
    return torch.where(a <= delta, 0.5 * x * x, delta * (a - 0.5 * delta))


# ---------------------------------------------------------------- state
# optimizer group -> the parameter subtree it steps
OPT_GROUPS = {"actor": "params/actor", "critics": "params/critics",
              "alpha": "params/log_alpha", "ofenet": "params/ofenet/online"}


def opt_param_path(opt_path: str) -> Optional[str]:
    """``opt/<group>/mu/<rest>`` -> the parameter path it belongs to."""
    parts = opt_path.split("/")
    if len(parts) < 3 or parts[0] != "opt" or parts[2] != "mu":
        return None
    return "/".join([OPT_GROUPS[parts[1]], *parts[3:]])


@dataclasses.dataclass
class RefState:
    """One run's state: params and AdamW leaves by path, the actors'
    pendulums, the replay (rows, float64 priorities, cursor), the
    generator(s)."""
    P: Tree
    O: Tree
    q: torch.Tensor
    qd: torch.Tensor
    t: torch.Tensor
    data: Tree
    prio: torch.Tensor
    ptr: int
    count: int
    max_priority: float
    gen: torch.Generator
    rng: Optional[np.random.Generator]


def start_state(S0: Dict[str, Any], cfg: RefConfig,
                device: torch.device) -> RefState:
    """The reference's state from a start (``init_starts``), copied: the
    replay's rows at their cursor and every row's priority the initial
    highest one, as the warm-up added them."""
    to = lambda t: t.to(device).clone()
    count = int(S0["count"])
    prio = torch.zeros(cfg.capacity, dtype=torch.float64, device=device)
    prio[:count] = (1.0 + cfg.per_eps) ** cfg.per_alpha
    data = {}
    for k, v in S0["store"].items():
        data[k] = torch.zeros((cfg.capacity,) + tuple(v.shape[1:]),
                              dtype=v.dtype, device=device)
        data[k][:count] = v
    gen = torch.Generator(device=device)
    gen.set_state(S0["gen_state"])
    rng = None
    if cfg.host:
        rng = np.random.default_rng()
        rng.bit_generator.state = S0["rng_state"]
    return RefState(
        P={k: to(v) for k, v in S0["params"].items()},
        O={k: to(v) for k, v in S0["opt"].items()},
        q=to(S0["env"]["q"]), qd=to(S0["env"]["qd"]), t=to(S0["env"]["t"]),
        data=data, prio=prio, ptr=int(S0["ptr"]), count=count,
        max_priority=1.0, gen=gen, rng=rng)


# ------------------------------------------------------------------ start
def dense_layers(cfg: RefConfig) -> List[tuple]:
    """``(path, fan_in, fan_out)`` of every online dense layer, in the
    order their weights are drawn."""
    def block(prefix, d, units, layers, conn, out):
        rows = []
        for i in range(layers):
            rows.append((f"{prefix}/layers/{i}/dense", d, units))
            d = d + units if conn == "densenet" else units
        if out:
            rows.append((f"{prefix}/out", d, out))
        return rows, d
    rows: List[tuple] = []
    z_s, z_sa = cfg.obs_dim, cfg.obs_dim + cfg.act_dim
    if cfg.ofenet:
        net = (cfg.ofenet_units, cfg.ofenet_layers, cfg.ofenet_connectivity)
        r, z_s = block("params/ofenet/online/phi_s", cfg.obs_dim, *net, 0)
        rows += r
        r, z_sa = block("params/ofenet/online/phi_sa", z_s + cfg.act_dim,
                        *net, 0)
        rows += r + [("params/ofenet/online/pred", z_sa, cfg.obs_dim)]
    net = (cfg.units, cfg.layers, cfg.connectivity)
    rows += block("params/actor", z_s, *net, 2 * cfg.act_dim)[0]
    for q in ("q1", "q2"):
        rows += block(f"params/critics/{q}", z_sa, *net, 1)[0]
    return rows


def _params(cfg: RefConfig, g: torch.Generator, device) -> Tree:
    """Every weight U(-1/sqrt(fan_in), 1/sqrt(fan_in)) from one draw,
    biases zero, the targets copies of their nets, the temperature at its
    initial value."""
    layers = dense_layers(cfg)
    u = torch.rand((sum(i * o for _, i, o in layers),), generator=g,
                   device=device)
    P: Tree = {}
    at = 0
    for path, fan_in, fan_out in layers:
        bound = 1.0 / math.sqrt(fan_in)
        w = u[at:at + fan_in * fan_out].view(fan_in, fan_out)
        P[f"{path}/w"] = w * (2.0 * bound) - bound
        P[f"{path}/b"] = torch.zeros((fan_out,), device=device)
        at += fan_in * fan_out
    for online, target in (("params/critics/", "params/target_critics/"),
                           ("params/ofenet/online/", "params/ofenet/target/")):
        for p in [p for p in P if p.startswith(online)]:
            P[target + p[len(online):]] = P[p].clone()
    P["params/log_alpha"] = torch.tensor(math.log(cfg.init_alpha),
                                         dtype=torch.float32, device=device)
    return P


def _opt(cfg: RefConfig, P: Tree) -> Tree:
    """AdamW's state at zero: both moments of every stepped leaf, and
    each group's step count."""
    O: Tree = {}
    for group, prefix in OPT_GROUPS.items():
        paths = [p for p in P if p == prefix or p.startswith(prefix + "/")]
        if not paths:
            continue
        for p in paths:
            for moment in ("mu", "nu"):
                O[f"opt/{group}/{moment}{p[len(prefix):]}"] = \
                    torch.zeros_like(P[p])
        O[f"opt/{group}/count"] = torch.zeros(
            (), dtype=torch.int32, device=P[paths[0]].device)
    return O


def init_starts(cfg: RefConfig, seeds: List[int], device) -> List[Dict]:
    """Each seed's start, made from the seed alone on ``device``: params
    and AdamW state; the replay's warm-up, ``max(warmup_steps // n_actors,
    1)`` steps of every actor under uniform actions on [-1, 1), with a
    fresh episode every ``max_episode_steps``; the actors where it leaves
    them; the state of the generator that drew all of it, which the run's
    supersteps go on drawing from (and, for the host replay, the NumPy
    sampler seeded with the seed). The seeds' actors step together."""
    device = torch.device(device)
    n, T = cfg.n_actors, cfg.max_episode_steps
    steps = max(cfg.warmup_steps // n, 1)
    if steps * n > cfg.capacity:
        raise ValueError("the warm-up outgrows the replay")
    starts, acts, resets = [], [], []
    for seed in seeds:
        g = torch.Generator(device=device)
        g.manual_seed(int(seed))
        P = _params(cfg, g, device)
        starts.append({"params": P, "opt": _opt(cfg, P), "gen": g})
        acts.append(torch.rand((steps, n), generator=g, device=device))
        resets.append(torch.rand((steps // T + 1, n, 2), generator=g,
                                 device=device))
    act = torch.clamp(torch.cat(acts, 1) * 2.0 + (-1.0), min=-1.0)
    reset = torch.cat(resets, 1)
    u = act * MAX_TORQUE
    th, thd = (x[:, 0] for x in pendulum_reset(reset[0]))
    ths, thds, th2s, thd2s = [], [], [], []
    for k in range(steps):
        ths.append(th)
        thds.append(thd)
        th, thd = _advance(th, thd, u[k])
        th2s.append(th)
        thd2s.append(thd)
        if (k + 1) % T == 0:
            th, thd = (x[:, 0] for x in pendulum_reset(reset[(k + 1) // T]))
    th0, thd0 = torch.stack(ths), torch.stack(thds)
    rows = {"obs": _obs(th0, thd0), "act": act[..., None],
            "rew": -_cost(th0, thd0, u),
            "next_obs": _obs(torch.stack(th2s), torch.stack(thd2s))}
    rows["done"] = torch.zeros_like(rows["rew"])
    for m, (seed, st) in enumerate(zip(seeds, starts)):
        own = slice(m * n, (m + 1) * n)
        st["store"] = {k: v[:, own].reshape((steps * n,) + v.shape[2:])
                       for k, v in rows.items()}
        st["env"] = {"q": th[own, None].clone(), "qd": thd[own, None].clone(),
                     "t": torch.full((n,), steps % T, dtype=torch.int32,
                                     device=device)}
        st["ptr"], st["count"] = steps * n % cfg.capacity, steps * n
        st["gen_state"] = st.pop("gen").get_state()
        st["rng_state"] = (np.random.default_rng(int(seed)).bit_generator
                           .state if cfg.host else None)
    return starts


# ------------------------------------------------------------------ AdamW
def adamw(st: RefState, group: str, grads: Tree, cfg: RefConfig) -> None:
    """One AdamW step of ``group`` (no weight decay, no clipping), in
    place on ``st``."""
    prefix = OPT_GROUPS[group]
    count = st.O[f"opt/{group}/count"] + 1
    c = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, device=c.device), c)
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, device=c.device), c)
    for path, g in grads.items():
        rest = path[len(prefix):]
        mk, vk = f"opt/{group}/mu{rest}", f"opt/{group}/nu{rest}"
        m = cfg.b1 * st.O[mk] + (1 - cfg.b1) * g
        v = cfg.b2 * st.O[vk] + (1 - cfg.b2) * g * g
        st.P[path] = st.P[path] - cfg.lr * (m / bc1) / (
            torch.sqrt(v / bc2) + cfg.adam_eps)
        st.O[mk], st.O[vk] = m, v
    st.O[f"opt/{group}/count"] = count


def _grad(loss_fn, st: RefState, paths: List[str]):
    """``(loss, aux, {path: grad})`` of ``loss_fn(P)`` w.r.t. ``paths``."""
    leaves = {p: st.P[p].detach().clone().requires_grad_(True)
              for p in paths}
    loss, aux = loss_fn({**st.P, **leaves})
    grads = torch.autograd.grad(loss, [leaves[p] for p in paths])
    return loss.detach(), aux, {p: g for p, g in zip(paths, grads)}


def _under(st: RefState, prefix: str) -> List[str]:
    return sorted(p for p in st.P if p == prefix or
                  p.startswith(prefix + "/"))


def sac_update(st: RefState, cfg: RefConfig, batch: Tree, eps1, eps2,
               var: Variant = SOUND) -> Dict[str, Any]:
    """One SAC step with the OFENet auxiliary step, in place on ``st``;
    returns the losses, the magnitude of each (the actor's: the mean
    magnitude of its per-row terms), the sampled rows' priorities (|TD
    error| of the new critic) and the step's gradients by parameter
    path."""
    mm = _mm(var)
    if var.half_batch:
        h = cfg.batch // 2
        batch = {k: v[:h] for k, v in batch.items()}
        eps1, eps2 = eps1[:h], eps2[:h]
    old = dict(st.P), dict(st.O)
    s, a, r, s2, d, w = (batch[k] for k in
                         ("obs", "act", "rew", "next_obs", "done", "weight"))
    losses: Dict[str, float] = {}
    grads: Tree = {}
    if cfg.ofenet:
        def aux(P):
            _, z_sa = features(P, cfg, s, a, mm)
            pred = mm(z_sa, P["params/ofenet/online/pred/w"]) \
                + P["params/ofenet/online/pred/b"]
            return torch.mean(torch.sum(torch.square(pred - s2), -1)), None
        l_aux, _, g = _grad(aux, st, _under(st, "params/ofenet/online"))
        adamw(st, "ofenet", g, cfg)
        for p in g:
            tp = p.replace("/online/", "/target/", 1)
            st.P[tp] = (1.0 - cfg.ofenet_tau) * st.P[tp] \
                + cfg.ofenet_tau * st.P[p]
        losses["aux_loss"] = float(l_aux)
        grads.update(g)
    with torch.no_grad():
        alpha = torch.exp(st.P["params/log_alpha"])
        a2, logp2 = sample_action(st.P, cfg, s2, eps1, mm)
        q1_t, q2_t = q_pair(st.P, "params/target_critics", cfg, s2, a2, mm)
        q_target = r + cfg.gamma * (1.0 - d) * (torch.minimum(q1_t, q2_t)
                                                - alpha * logp2)

    def critic(P):
        q1, q2 = q_pair(P, "params/critics", cfg, s, a, mm)
        l1 = huber(q1 - q_target, cfg.huber_delta)
        l2 = huber(q2 - q_target, cfg.huber_delta)
        return torch.mean(w * l1) + torch.mean(w * l2), None
    l_q, _, g = _grad(critic, st, _under(st, "params/critics"))
    adamw(st, "critics", g, cfg)
    losses["critic_loss"] = float(l_q)
    grads.update(g)

    def actor(P):
        ai, logp = sample_action(P, cfg, s, eps2, mm)
        q1, q2 = q_pair(P, "params/critics", cfg, s, ai, mm)
        rows = alpha * logp - torch.minimum(q1, q2)
        return torch.mean(rows), (logp, rows)
    l_pi, (logp, rows), g = _grad(actor, st, _under(st, "params/actor"))
    adamw(st, "actor", g, cfg)
    losses["actor_loss"] = float(l_pi)
    # the actor's rows have either sign, and their mean can cancel to
    # near 0: its rounding scales with the rows' magnitude, not the mean's
    scales = {k: abs(v) for k, v in losses.items()}
    scales["actor_loss"] = float(torch.mean(torch.abs(rows.detach())))
    grads.update(g)

    logp = logp.detach()

    def temperature(P):
        return -torch.mean(torch.exp(P["params/log_alpha"])
                           * (logp - float(cfg.act_dim))), None
    _, _, g = _grad(temperature, st, ["params/log_alpha"])
    adamw(st, "alpha", g, cfg)
    grads.update(g)

    for p in _under(st, "params/critics"):
        tp = p.replace("params/critics", "params/target_critics", 1)
        st.P[tp] = (1.0 - cfg.tau) * st.P[tp] + cfg.tau * st.P[p]
    with torch.no_grad():
        q1, _ = q_pair(st.P, "params/critics", cfg, s, a, mm)
    td = torch.abs(q1 - q_target)
    if var.half_batch:
        td = torch.cat([td, td])
    if var.frozen:
        st.P, st.O = old
    return {"losses": losses, "scales": scales, "priorities": td,
            "grads": grads}


# ---------------------------------------------------------------- replay
def replay_add(st: RefState, cfg: RefConfig, rows: Tree) -> None:
    n = rows["obs"].shape[0]
    idx = (st.ptr + torch.arange(n, device=st.prio.device)) % cfg.capacity
    for k, v in st.data.items():
        v[idx] = rows[k].to(v.dtype)
    st.prio[idx] = (st.max_priority + cfg.per_eps) ** cfg.per_alpha
    st.ptr = (st.ptr + n) % cfg.capacity
    st.count = min(st.count + n, cfg.capacity)


ROW_FIELDS = ("obs", "act", "rew", "next_obs", "done")
# rows the reference and the system both collected agree to rounding;
# two different rows of the pendulum differ by far more
MATCH_TOL = 1e-3
# a draw this close to a row boundary (as a share of the total priority)
# may fall on either side in the system's float32 sum-tree
TIE_TOL = 1e-6


def _rows_match(data: Tree, idx: torch.Tensor, rows: Tree) -> torch.Tensor:
    ok = torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
    for k in ROW_FIELDS:
        a, b = data[k][idx], rows[k].to(data[k].dtype)
        diff = torch.abs(a - b).reshape(a.shape[0], -1).amax(-1)
        ok &= diff <= MATCH_TOL
    return ok


def replay_sample(st: RefState, cfg: RefConfig, u: Optional[torch.Tensor],
                  sys_batch: Optional[Tree], var: Variant = SOUND):
    """``(rows, weights, sample_gap)``: the stratified proportional sample
    over the float64 priorities. With the system's batch, each of its rows
    is found among the rows next to the reference's; ``sample_gap`` is the
    largest distance, as a share of the total priority, by which a draw
    lies outside the row the system took (1 where that row is none of
    them). A system row within ``TIE_TOL`` of its draw is taken in the
    reference's batch too: a float32 rounding tie."""
    dev = st.prio.device
    B, count = cfg.batch, st.count
    p = st.prio[:count]
    cum = torch.cumsum(p, 0)
    total = float(cum[-1])
    if cfg.host:
        bounds = np.linspace(0.0, total, B + 1)
        targets = torch.as_tensor(st.rng.uniform(bounds[:-1], bounds[1:]),
                                  device=dev)
    else:
        targets = (torch.arange(B, device=dev, dtype=torch.float64)
                   + u.to(torch.float64)) * (total / B)
    idx = torch.clamp(torch.searchsorted(cum, targets, right=True),
                      max=count - 1)
    if var.sample_shift:
        idx = torch.clamp(idx + var.sample_shift, 0, count - 1)
    gap = 0.0
    if sys_batch is not None:
        best = torch.full((B,), float("inf"), dtype=torch.float64,
                          device=dev)
        pick = idx.clone()
        for off in (0, -1, 1, -2, 2):
            c = torch.clamp(idx + off, 0, count - 1)
            lo, hi = cum[c] - p[c], cum[c]
            dist = torch.clamp(torch.maximum(lo - targets, targets - hi),
                               min=0.0) / total
            dist = torch.where(_rows_match(st.data, c, sys_batch), dist,
                               torch.full_like(dist, float("inf")))
            better = dist < best
            best = torch.where(better, dist, best)
            pick = torch.where(better, c, pick)
        gap = float(torch.clamp(best, max=1.0).max())
        idx = torch.where(best <= TIE_TOL, pick, idx)
    rows = {k: st.data[k][idx] for k in ROW_FIELDS}
    pw = st.prio[idx] / total
    w = (count * torch.clamp(pw, min=1e-12)) ** (-cfg.per_beta)
    rows["weight"] = (w / w.max()).to(torch.float32)
    return rows, idx, gap


def replay_refresh(st: RefState, cfg: RefConfig, idx: torch.Tensor,
                   td: torch.Tensor) -> None:
    """The sampled rows' priorities from |TD| (a row sampled twice keeps
    the later value)."""
    pr = torch.abs(td.to(torch.float64)) + cfg.per_eps
    st.max_priority = max(st.max_priority, float(pr.max()))
    order = torch.arange(idx.shape[0], device=idx.device)
    last = torch.zeros(cfg.capacity, dtype=torch.long, device=idx.device)
    last.scatter_reduce_(0, idx, order, reduce="amax")
    keep = last[idx] == order
    st.prio[idx[keep]] = pr[keep] ** cfg.per_alpha


# ------------------------------------------------------------ superstep
def draw(st: RefState, cfg: RefConfig) -> Tree:
    """One superstep's draws, in the superstep's order."""
    g, dev = st.gen, st.gen.device
    n, a = cfg.n_actors, cfg.act_dim
    d = {"noise": torch.randn((1, n, a), generator=g, device=dev)}
    d["reset"] = torch.stack([torch.rand((n,), generator=g, device=dev),
                              torch.rand((n,), generator=g, device=dev)],
                             dim=-1)
    if not cfg.host:
        d["u"] = torch.rand((cfg.batch,), generator=g, device=dev)
    d["eps1"] = torch.randn((cfg.batch, a), generator=g, device=dev)
    d["eps2"] = torch.randn((cfg.batch, a), generator=g, device=dev)
    return d


def collect(st: RefState, cfg: RefConfig, d: Tree, var: Variant) -> Tree:
    """One step of every actor with the current policy; returns the
    rows."""
    with torch.no_grad():
        obs = pendulum_obs(st.q, st.qd)
        act, _ = sample_action(st.P, cfg, obs, d["noise"][0], _mm(var))
        q, qd, rew = pendulum_step(st.q, st.qd, act)
        if var.reward_shift:
            rew = rew.clone()
            rew[0] += var.reward_shift
        t = st.t + 1
        obs2 = pendulum_obs(q, qd)
        reset = (t >= cfg.max_episode_steps)[:, None]
        q0, qd0 = pendulum_reset(d["reset"])
        st.q = torch.where(reset, q0, q)
        st.qd = torch.where(reset, qd0, qd)
        st.t = torch.where(reset[:, 0], torch.zeros_like(t), t)
    return {"obs": obs, "act": act, "rew": rew, "next_obs": obs2,
            "done": torch.zeros_like(rew)}


def superstep(st: RefState, cfg: RefConfig, var: Variant = SOUND,
              sys_batch: Optional[Tree] = None) -> Dict[str, Any]:
    """collect -> add -> sample -> update -> refresh, in place on ``st``;
    returns the step's losses, batch, priorities, gradients and
    ``sample_gap``."""
    d = draw(st, cfg)
    replay_add(st, cfg, collect(st, cfg, d, var))
    rows, idx, gap = replay_sample(st, cfg, d.get("u"), sys_batch, var)
    out = sac_update(st, cfg, rows, d["eps1"], d["eps2"], var)
    replay_refresh(st, cfg, idx, out["priorities"])
    out.update(batch=rows, sample_gap=gap)
    return out
