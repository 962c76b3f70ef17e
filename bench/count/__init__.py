"""Operations and bytes of the benchmark's work, counted from a
configuration file's shapes alone (no kernel names, no program code).

``nets(cfg)`` lists the dense blocks of one agent; ``update_flops`` is one
member-update's matrix-product operations (2 * M * K * N a product),
forward and backward, with dx and dW only where the SAC update needs them
and nothing recomputed; ``adamw_bytes`` is one AdamW step's least traffic.
Elementwise work is not counted: it is small beside the products, and a
roofline or ``mfu`` share that leaves it out can only read low.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

F32 = 4                       # bytes of a float32
TF32_FLOPS_PER_S = 495e12     # H100 SXM data sheet, dense TF32 on the tensor cores
FP32_FLOPS_PER_S = 67e12      # H100 SXM data sheet, float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet


@dataclasses.dataclass(frozen=True)
class Net:
    """A dense block: ``layers`` hidden layers of ``units`` (swish) over an
    ``in_dim`` input, densenet or mlp, and an optional linear ``out``."""
    name: str
    in_dim: int
    units: int
    layers: int
    connectivity: str
    out_dim: Optional[int] = None

    def products(self) -> List[Tuple[int, int, int]]:
        """``(K, N, x_cols)`` of each product in order, ``x_cols`` the
        columns of K that are the block's own input (dx of those is needed
        only for a gradient with respect to the input)."""
        out, k = [], self.in_dim
        for i in range(self.layers):
            x_cols = self.in_dim if (i == 0 or
                                     self.connectivity == "densenet") else 0
            out.append((k, self.units, x_cols))
            k = k + self.units if self.connectivity == "densenet" \
                else self.units
        if self.out_dim is not None:
            x_cols = self.in_dim if (self.connectivity == "densenet"
                                     or self.layers == 0) else 0
            out.append((k, self.out_dim, x_cols))
        return out

    @property
    def feature_dim(self) -> int:
        if self.connectivity == "densenet":
            return self.in_dim + self.layers * self.units
        return self.units if self.layers else self.in_dim

    def params(self) -> int:
        return sum(k * n + n for k, n, _ in self.products())

    def fwd_flops(self, m: int) -> int:
        return sum(2 * m * k * n for k, n, _ in self.products())

    def bwd_flops(self, m: int, *, dw: bool, dx_input: bool) -> int:
        """dW of every product (``dw``) and the dx the chain needs, the
        input's columns too with ``dx_input``."""
        total = 0
        for i, (k, n, x_cols) in enumerate(self.products()):
            if dw:
                total += 2 * m * k * n
            cols = k if dx_input else k - x_cols
            total += 2 * m * n * cols
        return total

    def fwd_bytes(self, m: int) -> int:
        """Input, weights and biases read once; feature and output
        written once."""
        out = self.out_dim or 0
        return F32 * (m * self.in_dim + self.params() + m * self.feature_dim
                      + m * out)

    def fwd_bwd_bytes(self, m: int) -> int:
        """The forward's, plus the output's gradient read and dx, dW and db
        written once."""
        rows_out = m * (self.out_dim or self.feature_dim)
        return self.fwd_bytes(m) + F32 * (rows_out + m * self.in_dim
                                          + self.params())


def _dims(config: dict) -> Dict[str, int]:
    spec, c = config["spec"], config["constants"]
    return {"obs": c["obs_dim"], "act": c["act_dim"],
            "n_actors": (spec["execution"]["n_core"]
                         * spec["execution"]["n_env"]
                         if spec["execution"]["distributed"] else 1),
            "batch": spec["execution"]["batch_size"]}


def nets(config: dict) -> Dict[str, Net]:
    """The agent's blocks: ``actor``, ``critic`` (one of the twins) and,
    with OFENet, ``phi_s``, ``phi_sa`` and ``pred``."""
    spec, d = config["spec"], _dims(config)
    net, ofe = spec["network"], spec["ofenet"]
    out: Dict[str, Net] = {}
    z_s, z_sa = d["obs"], d["obs"] + d["act"]
    if ofe["enabled"]:
        u, l, c = ofe["num_units"], ofe["num_layers"], ofe["connectivity"]
        out["phi_s"] = Net("phi_s", d["obs"], u, l, c)
        z_s = out["phi_s"].feature_dim
        out["phi_sa"] = Net("phi_sa", z_s + d["act"], u, l, c)
        z_sa = out["phi_sa"].feature_dim
        out["pred"] = Net("pred", z_sa, 0, 0, "mlp", d["obs"])
    u, l, c = net["num_units"], net["num_layers"], net["connectivity"]
    out["actor"] = Net("actor", z_s, u, l, c, 2 * d["act"])
    out["critic"] = Net("critic", z_sa, u, l, c, 1)
    return out


def stack_calls(config: dict) -> Tuple[List[Tuple[str, int, int]],
                                       List[Tuple[str, int, int]]]:
    """``(forward, backward)``: ``(net, rows, calls)`` of the block calls
    one member-update makes, forward-only calls and calls that are also
    differentiated (OFENet's ``pred`` is a plain product, not a block)."""
    ofe = config["spec"]["ofenet"]["enabled"]
    d = _dims(config)
    a, b = d["n_actors"], d["batch"]
    fwd = [("actor", a, 1), ("actor", b, 1), ("critic", b, 3)]
    bwd = [("actor", b, 1), ("critic", b, 4)]
    if ofe:
        fwd += [("phi_s", a, 1), ("phi_s", b, 2), ("phi_sa", b, 2)]
        bwd += [("phi_s", b, 1), ("phi_sa", b, 2)]
    return fwd, bwd


def update_flops(config: dict) -> int:
    """One member-update's product operations: the collect's policy
    forward, then the SAC update (OFENet aux step, critic target, critic,
    actor, priorities), each product once."""
    n, d = nets(config), _dims(config)
    a, b = d["n_actors"], d["batch"]
    ofe = "phi_s" in n
    total = n["actor"].fwd_flops(a)                           # collect
    total += 2 * n["critic"].fwd_flops(b) + n["actor"].fwd_flops(b)  # target
    total += 2 * (n["critic"].fwd_flops(b)                    # critic loss
                  + n["critic"].bwd_flops(b, dw=True, dx_input=False))
    total += n["actor"].fwd_flops(b) \
        + n["actor"].bwd_flops(b, dw=True, dx_input=False)    # actor loss
    total += 2 * (n["critic"].fwd_flops(b)
                  + n["critic"].bwd_flops(b, dw=False, dx_input=True))
    total += n["critic"].fwd_flops(b)                         # priorities
    if ofe:
        s, sa, pred = n["phi_s"], n["phi_sa"], n["pred"]
        total += s.fwd_flops(a)                               # collect
        # aux step: forward and backward of phi_s, phi_sa and pred
        total += s.fwd_flops(b) + s.bwd_flops(b, dw=True, dx_input=False)
        total += sa.fwd_flops(b) + sa.bwd_flops(b, dw=True, dx_input=True)
        total += pred.fwd_flops(b) + pred.bwd_flops(b, dw=True,
                                                    dx_input=True)
        # features of s2 (target) and of (s, a) with the stepped OFENet
        total += 2 * s.fwd_flops(b) + 2 * sa.fwd_flops(b)
        # actor loss: phi_sa on the actor's action, dx back to the action
        total += sa.fwd_flops(b) + sa.bwd_flops(b, dw=False, dx_input=True)
    return total


def optimized_params(config: dict) -> int:
    """Elements AdamW steps each update: actor, both critics, the
    temperature and OFENet's online nets."""
    n = nets(config)
    total = n["actor"].params() + 2 * n["critic"].params() + 1
    for k in ("phi_s", "phi_sa", "pred"):
        if k in n:
            total += n[k].params()
    return total


def adamw_bytes(elements: int) -> int:
    """Parameter, gradient and both moments read; parameter and moments
    written: 7 float32 an element."""
    return 7 * F32 * elements


def adamw_flops(elements: int) -> int:
    """The arithmetic of one element's step (moments, bias corrections,
    square root, division, update): about 12 operations."""
    return 12 * elements


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the operations
    at the TF32 tensor-core peak and the bytes at the HBM rate."""
    return max(flops / TF32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)
