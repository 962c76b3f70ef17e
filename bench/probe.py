"""Calls of the system made alone on the card after the window, for the
roofline readers: each reader's ``probes`` names its calls with their
least time (``bench.count``), the harness times them on the device trace
(``harness.profiled``: the device's busy time a call, so neither the
host's dispatch nor the gaps between launches are in it), and ``share``
sets one against the other."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from bench import count


def share(probed: Dict[str, dict]) -> Optional[float]:
    """The share (%) of the least time in the device's time, summed over
    the probes by their calls a member-update; ``None`` without probes or
    where the trace saw no operation of one."""
    if not probed or any(p["device_s"] is None for p in probed.values()):
        return None
    least = sum(p["calls"] * p["least_s"] for p in probed.values())
    spent = sum(p["calls"] * p["device_s"] for p in probed.values())
    return 100.0 * least / spent


def blocks(driver) -> Dict[str, Tuple[object, object]]:
    """``{net: (MLPBlockConfig, params)}`` of the agent's blocks as the
    run holds them (a fleet's params member-stacked)."""
    acfg = driver.trainer.acfg
    p = driver.state().agent["params"]
    out = {"actor": (acfg.actor_block(), p["actor"]),
           "critic": (acfg.critic_block(), p["critics"]["q1"])}
    if acfg.ofenet is not None:
        online = p["ofenet"]["online"]
        out["phi_s"] = (acfg.ofenet.state_block, online["phi_s"])
        out["phi_sa"] = (acfg.ofenet.sa_block, online["phi_sa"])
    return out


def _vjp_fn(apply, params, x, g, members: bool):
    """The backward as the update takes it: ``torch.autograd`` for one
    member, ``torch.func.vjp`` under ``vmap`` for a fleet."""
    from repro_torch.common import tree_leaves, tree_map
    if members:
        def vjp(p, x, g):
            return torch.func.vjp(apply, p, x)[1](g)
        return lambda: torch.func.vmap(vjp)(params, x, g)
    p = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    x = x.detach().clone().requires_grad_(True)
    wrt = [*tree_leaves(p), x]
    return lambda: torch.autograd.grad(apply(p, x), wrt, g)


def stack_probes(ctx, backward: bool) -> Optional[Dict[str, dict]]:
    """The block calls one member-update makes, each at its shape through
    the public block entry (forward under ``no_grad``, or forward and
    backward through autograd), with their least time; ``None`` where the
    blocks are not the fused stack or no card."""
    from repro_torch.core.blocks import mlp_block_apply
    drv = ctx.driver
    if drv.device.type != "cuda" or \
            drv.spec.network.block_backend != "fused":
        return None
    nets, cases = count.nets(ctx.config), blocks(drv)
    e = drv.members
    fwd, bwd = count.stack_calls(ctx.config)
    gen = torch.Generator(device=drv.device).manual_seed(0)
    out = {}
    for name, rows, calls in (bwd if backward else fwd):
        cfg, params = cases[name]
        net = nets[name]
        shape = ((e,) if drv._stacked else ()) + (rows, cfg.in_dim)
        x = torch.randn(shape, generator=gen, device=drv.device)

        def apply(p, x, cfg=cfg):
            return mlp_block_apply(p, cfg, x, train=False)[0]
        if not backward:
            f = torch.func.vmap(apply) if drv._stacked else apply

            def fn(f=f, params=params, x=x):
                with torch.no_grad():
                    return f(params, x)
            flops, nbytes = net.fwd_flops(rows), net.fwd_bytes(rows)
        else:
            g = torch.randn(shape[:-1] + (net.out_dim or net.feature_dim,),
                            generator=gen, device=drv.device)
            fn = _vjp_fn(apply, params, x, g, drv._stacked)
            flops = net.fwd_flops(rows) + net.bwd_flops(rows, dw=True,
                                                        dx_input=True)
            nbytes = net.fwd_bwd_bytes(rows)
        key = f"{name}.m{rows}"
        if key in out:
            out[key]["calls"] += calls
            continue
        out[key] = {
            "fn": fn, "calls": calls,
            "least_s": count.least_seconds(e * flops, e * nbytes)}
    return out
