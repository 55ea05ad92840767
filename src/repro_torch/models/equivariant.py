"""E(n)/E(3)-equivariant GNNs (``repro.models.equivariant``): EGNN and
MACE-lite, as plain functions over the reference's nested param dict.

EGNN (Satorras et al., arXiv:2102.09844): scalar messages from invariant
distances, coordinate updates along relative vectors. MACE-lite (Batatia
et al., arXiv:2206.07697): the l_max = 2 equivariant message A_i = sum_j
R(r_ij) Y(r_hat_ij) h_j from explicit real spherical harmonics, and the
invariant product basis {A0^3, A0 |A1|^2, A0 |A2|^2, |A1|^2 |A2|^2} per
channel for the energy readout; the reference's docstring gives the
reasoning. Unlike ``models.gnn``, edge endpoints are clamped to the last
node, N - 1, and padding is carried by ``edge_mask`` alone. The bases'
constants keep the reference's dtypes under its x64 mode: pi, r_cut and
sqrt(2 / r_cut) are float32 whatever the coordinates' dtype, while the
1e-6 and 1e-12 floors are Python floats, which take the coordinates'
dtype as the reference's weakly typed scalars do (float32 at the
configs' dtype).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import rng
from repro_torch.models.embedding import segment_sum
from repro_torch.models.layers import dense_init

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class EquivariantConfig:
    name: str
    kind: str  # "egnn" | "mace"
    n_layers: int
    d_hidden: int
    n_rbf: int = 8
    l_max: int = 2
    correlation_order: int = 3
    r_cut: float = 5.0
    dtype: Any = torch.float32


def _mlp_init(key: Tensor, dims, dt) -> dict:
    ks = rng.split(key, len(dims) - 1)
    p = {}
    for i in range(len(dims) - 1):
        p[f"w{i}"] = dense_init(ks[i], dims[i], dims[i + 1], dt)
        p[f"b{i}"] = torch.zeros((dims[i + 1],), dtype=dt, device=key.device)
    return p


def _mlp(p: dict, x: Tensor, n: int, act=F.silu) -> Tensor:
    for i in range(n):
        x = x @ p[f"w{i}"] + p[f"b{i}"]
        if i < n - 1:
            x = act(x.float()).to(x.dtype)
    return x


def _f32(x: float, device) -> Tensor:
    return torch.tensor(np.float32(x), dtype=torch.float32, device=device)


# --------------------------------------------------------------------------
# shared radial/angular bases
# --------------------------------------------------------------------------
def bessel_rbf(r: Tensor, n_rbf: int, r_cut: float) -> Tensor:
    """sin(n pi r / rc) / r radial basis with a smooth cosine cutoff."""
    dev = r.device
    r = torch.clamp(r, min=1e-6)
    rc = _f32(r_cut, dev)
    pi = _f32(math.pi, dev)
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=dev)
    basis = torch.sqrt(_f32(2.0 / r_cut, dev)) * torch.sin(
        n * pi * r[..., None] / rc) / r[..., None]
    env = 0.5 * (torch.cos(pi * torch.clamp(r / rc, max=1.0)) + 1.0)
    return basis * env[..., None]


def real_sph_harm_l2(unit: Tensor) -> Tensor:
    """Real spherical harmonics Y_lm for l = 0, 1, 2 of unit vectors (..., 3):
    (..., 9) as [Y00, Y1(-1, 0, 1), Y2(-2..2)], constant factors folded into
    the learned radial weights."""
    x, y, z = unit[..., 0], unit[..., 1], unit[..., 2]
    one = torch.ones_like(x)
    return torch.stack([one, y, z, x, x * y, y * z, 3 * z * z - 1, x * z, x * x - y * y],
                       dim=-1)


def _endpoints(edge_index: Tensor, n: int) -> tuple[Tensor, Tensor]:
    return (torch.clamp(edge_index[0].long(), max=n - 1),
            torch.clamp(edge_index[1].long(), max=n - 1))


# --------------------------------------------------------------------------
# EGNN
# --------------------------------------------------------------------------
def init_egnn(key: Tensor, cfg: EquivariantConfig) -> dict:
    d, dt = cfg.d_hidden, cfg.dtype
    keys = rng.split(key, cfg.n_layers + 2)
    p: dict[str, Any] = {"embed": _mlp_init(keys[0], (cfg.d_hidden, d), dt)}
    for i in range(cfg.n_layers):
        k = keys[i + 1]
        p[f"layer{i}"] = {
            "edge": _mlp_init(rng.fold_in(k, 0), (2 * d + 1, d, d), dt),
            "coord": _mlp_init(rng.fold_in(k, 1), (d, d, 1), dt),
            "node": _mlp_init(rng.fold_in(k, 2), (2 * d, d, d), dt),
        }
    p["readout"] = _mlp_init(keys[-1], (d, d, 1), dt)
    return p


def egnn_forward(params: dict, cfg: EquivariantConfig, h: Tensor, x: Tensor,
                 edge_index: Tensor, edge_mask: Tensor) -> tuple[Tensor, Tensor]:
    """h: (N, d) invariant features; x: (N, 3) coordinates -> (energy, x')."""
    n = h.shape[0]
    src, dst = _endpoints(edge_index, n)
    h = _mlp(params["embed"], h.to(cfg.dtype), 1)
    zero = torch.zeros((), dtype=h.dtype, device=h.device)
    for i in range(cfg.n_layers):
        lp = params[f"layer{i}"]
        rel = x[src] - x[dst]
        d2 = torch.sum(torch.square(rel), dim=-1, keepdim=True)
        m = _mlp(lp["edge"], torch.cat([h[src], h[dst], d2], -1), 2)
        m = torch.where(edge_mask[:, None], m, zero)
        w = _mlp(lp["coord"], m, 2)  # (E, 1)
        upd = segment_sum(rel * w, dst, n)
        cnt = segment_sum(edge_mask.float(), dst, n)
        x = x + upd / torch.clamp(cnt[:, None], min=1.0)
        agg = segment_sum(m, dst, n)
        h = h + _mlp(lp["node"], torch.cat([h, agg], -1), 2)
    energy = torch.sum(_mlp(params["readout"], h, 2))
    return energy, x


# --------------------------------------------------------------------------
# MACE-lite
# --------------------------------------------------------------------------
def init_mace(key: Tensor, cfg: EquivariantConfig) -> dict:
    d, dt = cfg.d_hidden, cfg.dtype
    keys = rng.split(key, cfg.n_layers + 2)
    p: dict[str, Any] = {"embed": _mlp_init(keys[0], (cfg.d_hidden, d), dt)}
    for i in range(cfg.n_layers):
        k = rng.fold_in(keys[1], i)
        p[f"layer{i}"] = {
            # radial MLP: rbf -> per-(l, channel) weights (9 lm components)
            "radial": _mlp_init(rng.fold_in(k, 0), (cfg.n_rbf, d, 9 * d), dt),
            # product-basis mixing: 4 invariant contractions -> d
            "mix": dense_init(rng.fold_in(k, 1), 4 * d, d, dt),
            "node": _mlp_init(rng.fold_in(k, 2), (2 * d, d, d), dt),
        }
    p["readout"] = _mlp_init(keys[-1], (d, d, 1), dt)
    return p


def mace_forward(params: dict, cfg: EquivariantConfig, h: Tensor, x: Tensor,
                 edge_index: Tensor, edge_mask: Tensor) -> Tensor:
    """Higher-order equivariant message passing; returns the total energy."""
    n = h.shape[0]
    src, dst = _endpoints(edge_index, n)
    h = _mlp(params["embed"], h.to(cfg.dtype), 1)
    d = cfg.d_hidden
    for i in range(cfg.n_layers):
        lp = params[f"layer{i}"]
        rel = x[src] - x[dst]
        r = torch.sqrt(torch.sum(torch.square(rel), -1) + 1e-12)
        unit = rel / r[:, None]
        R = _mlp(lp["radial"], bessel_rbf(r, cfg.n_rbf, cfg.r_cut), 2)  # (E, 9d)
        Y = real_sph_harm_l2(unit)  # (E, 9)
        # A_i = sum_j R(r_ij) * Y_lm(r_ij) * h_j -> (N, 9, d)
        msg = R.reshape(-1, 9, d) * Y[:, :, None] * h[src][:, None, :]
        msg = torch.where(edge_mask[:, None, None], msg,
                          torch.zeros((), dtype=msg.dtype, device=msg.device))
        A = segment_sum(msg, dst, n)  # (N, 9, d)
        a0, a1, a2 = A[:, 0, :], A[:, 1:4, :], A[:, 4:9, :]
        n1 = torch.sum(torch.square(a1), dim=1)
        n2 = torch.sum(torch.square(a2), dim=1)
        B = torch.cat([a0 * a0 * a0, a0 * n1, a0 * n2, n1 * n2], dim=-1)  # (N, 4d)
        h = h + B @ lp["mix"] + _mlp(lp["node"], torch.cat([h, a0], -1), 2)
    return torch.sum(_mlp(params["readout"], h, 2))


def init_params(key: Tensor, cfg: EquivariantConfig) -> dict:
    return init_egnn(key, cfg) if cfg.kind == "egnn" else init_mace(key, cfg)


def energy_loss(params: dict, cfg: EquivariantConfig, h: Tensor, x: Tensor,
                edge_index: Tensor, edge_mask: Tensor, target: Tensor) -> Tensor:
    if cfg.kind == "egnn":
        e, _ = egnn_forward(params, cfg, h, x, edge_index, edge_mask)
    else:
        e = mace_forward(params, cfg, h, x, edge_index, edge_mask)
    return torch.mean(torch.square(e.float() - target.float()))
