"""NequIP (arXiv:2101.03164): an E(3)-equivariant interatomic potential,
l_max = 2 — port of ``repro/models/nequip.py``.

Irreducible l <= 2 features are carried in Cartesian form, as the reference
carries them:

  l=0: scalars       (N, C)
  l=1: vectors       (N, C, 3)          rotate as  v -> R v
  l=2: traceless sym (N, C, 3, 3)       rotate as  T -> R T R^T

Every tensor-product path is a dense einsum: 0x0->0, 0x1->1, 1x1->0 (dot),
1x1->1 (cross), 1x1->2 (sym outer), 0x2->2, 2x1->1, 2x2->0, each gated by a
radial MLP of a Bessel basis under a polynomial cutoff.  Messages are
summed with ``index_add_`` (the reference's ``segment_sum``): no kernel of
the port.  Padded edges still carry messages (the radial MLP has a bias),
as in the reference.  Forces are ``-dE/dpos`` through
``torch.autograd.grad``.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..core.aggregate import segment_sum
from ..device import resolve_device
from ..dist import spmd
from ..nn.layers import linear_apply, linear_init, mlp_apply, mlp_init


# ------------------------------------------------------------------ radial
def bessel_basis(r: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """sin(n pi r / rc) / r basis (NequIP eq. 8), shape (E, n_rbf)."""
    n = torch.arange(1, n_rbf + 1, dtype=r.dtype, device=r.device)
    rs = torch.clamp(r, min=1e-9)[:, None]
    return math.sqrt(2.0 / cutoff) * torch.sin(n * math.pi * rs / cutoff) / rs


def poly_cutoff(r: torch.Tensor, cutoff: float, p: int = 6) -> torch.Tensor:
    """Smooth polynomial envelope, 1 at r=0, 0 at r>=cutoff (NequIP eq. 9)."""
    x = torch.clamp(r / cutoff, 0.0, 1.0)
    a = -(p + 1) * (p + 2) / 2.0
    b = p * (p + 2)
    c = -p * (p + 1) / 2.0
    return 1.0 + a * x ** p + b * x ** (p + 1) + c * x ** (p + 2)


def _traceless_sym(outer: torch.Tensor) -> torch.Tensor:
    """Project (..., 3, 3) onto its traceless symmetric part (the l=2
    irrep)."""
    sym = 0.5 * (outer + outer.transpose(-1, -2))
    tr = torch.diagonal(sym, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    eye = torch.eye(3, dtype=outer.dtype, device=outer.device)
    return sym - tr * eye / 3.0


# ------------------------------------------------------------------- model
N_PATHS = 10  # radial-weighted tensor-product paths per layer


def nequip_init(generator: torch.Generator, n_species: int = 16,
                channels: int = 32, n_layers: int = 5, n_rbf: int = 8,
                cutoff: float = 5.0, radial_hidden: int = 64,
                device="cuda") -> Dict:
    """Per layer the radial MLP [n_rbf, radial_hidden, 10 C], ``self0``
    (C -> C), ``self1`` and ``self2`` (N(0, 1/C)), ``gate`` (C -> 2C); then
    the species embedding (N(0, 0.25)) and the readout MLP [C,
    radial_hidden, 1]; drawn in that order from ``generator``."""
    dev = resolve_device(device)

    def randn(*shape):
        return torch.randn(shape, generator=generator,
                           device=generator.device)

    C = channels
    layers = []
    for _ in range(n_layers):
        layers.append({
            "radial": mlp_init(generator, [n_rbf, radial_hidden,
                                           N_PATHS * C], device=dev),
            "self0": linear_init(generator, C, C, device=dev),
            "self1": (randn(C, C) / math.sqrt(C)).to(dev),
            "self2": (randn(C, C) / math.sqrt(C)).to(dev),
            "gate": linear_init(generator, C, 2 * C, device=dev),
        })
    return {"embed": (randn(n_species, C) * 0.5).to(dev),
            "layers": layers,
            "readout": mlp_init(generator, [C, radial_hidden, 1],
                                device=dev)}


def nequip_layer(p: Dict, feats: Tuple, pos_diff: torch.Tensor,
                 rbf_w: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                 num_nodes: int, mesh=None) -> Tuple:
    """One interaction block.  ``feats = (s, v, T)``.  Under ``mesh``
    (``nequip_apply``'s layout) the features are the rank's rows and the
    edges the rank's (``num_nodes`` is ignored)."""
    s, v, T = feats
    C = s.shape[-1]
    r = torch.linalg.vector_norm(pos_diff, dim=-1)
    dirn = pos_diff / torch.clamp(r, min=1e-9)[:, None]       # (E, 3)
    w = mlp_apply(p["radial"], rbf_w, act=F.silu)             # (E, 10 C)
    w = w.reshape(-1, N_PATHS, C)

    if mesh is not None:
        num_nodes = spmd.node_count(s.shape[0], mesh)
    ss, sv, sT = (spmd.node_gather(f, mesh)[src] for f in (s, v, T))
    d1 = dirn[:, None, :]                                      # (E, 1, 3)
    Y2 = _traceless_sym(d1[..., :, None] * d1[..., None, :])   # (E,1,3,3)

    # --- messages per output irrep (each path radial-gated) ---
    m_s = (w[:, 0] * ss
           + w[:, 1] * torch.einsum("eci,ei->ec", sv, dirn)           # 1x1->0
           + w[:, 2] * torch.einsum("ecij,eij->ec", sT, Y2[:, 0]))    # 2x2->0
    m_v = (w[:, 3, :, None] * sv
           + w[:, 4, :, None] * ss[..., None] * d1                    # 0x1->1
           + w[:, 5, :, None] * torch.linalg.cross(
               sv, d1.expand_as(sv), dim=-1)                          # 1x1->1
           + w[:, 6, :, None] * torch.einsum("ecij,ej->eci", sT, dirn))
    m_T = (w[:, 7, :, None, None] * sT
           + w[:, 8, :, None, None] * ss[..., None, None] * Y2        # 0x2->2
           + w[:, 9, :, None, None] * _traceless_sym(
               sv[..., :, None] * d1[..., None, :]))                  # 1x1->2

    a_s, a_v, a_T = (spmd.node_scatter(segment_sum(m, dst, num_nodes), mesh)
                     for m in (m_s, m_v, m_T))

    # --- self-interaction (channel mixing, per l) + gated nonlinearity ---
    s_new = s + linear_apply(p["self0"], a_s)
    v_new = v + torch.einsum("ncx,cd->ndx", a_v, p["self1"].to(a_v.dtype))
    T_new = T + torch.einsum("ncxy,cd->ndxy", a_T, p["self2"].to(a_T.dtype))
    gates = linear_apply(p["gate"], F.silu(s_new))
    g_v, g_T = torch.chunk(torch.sigmoid(gates), 2, dim=-1)
    return (F.silu(s_new), v_new * g_v[..., None],
            T_new * g_T[..., None, None])


def nequip_apply(params: Dict, species: torch.Tensor, pos: torch.Tensor,
                 src: torch.Tensor, dst: torch.Tensor, edge_mask=None,
                 node_mask=None, cutoff: float = 5.0,
                 mesh=None) -> torch.Tensor:
    """Per-node invariant energy (N,).  ``species``: (N,) ints; ``pos``:
    (N, 3).  Channels and n_rbf come from the parameter shapes.  Under
    ``mesh`` the nodes (``species``, ``pos``, ``node_mask`` and the result)
    are the rank's rows of nodes cut over every axis and the edges the
    rank's, indexing the whole node set."""
    C = params["embed"].shape[1]
    n_rbf = params["layers"][0]["radial"][0]["w"].shape[0]
    N = species.shape[0]
    src, dst = src.long(), dst.long()
    s = params["embed"][species.long()].to(pos.dtype)
    v = pos.new_zeros((N, C, 3))
    T = pos.new_zeros((N, C, 3, 3))

    pos_all = spmd.node_gather(pos, mesh)
    pos_diff = pos_all[src] - pos_all[dst]
    r = torch.linalg.vector_norm(pos_diff, dim=-1)
    rbf = bessel_basis(r, n_rbf, cutoff) * poly_cutoff(r, cutoff)[:, None]
    if edge_mask is not None:
        rbf = torch.where(edge_mask[:, None], rbf, torch.zeros_like(rbf))

    feats = (s, v, T)
    for p in params["layers"]:
        feats = nequip_layer(p, feats, pos_diff, rbf, src, dst, N, mesh)
    energy_per_node = mlp_apply(params["readout"], feats[0], act=F.silu)[:, 0]
    if node_mask is not None:
        energy_per_node = energy_per_node * node_mask
    return energy_per_node


def nequip_energy(params: Dict, species, pos, src, dst, edge_mask=None,
                  node_mask=None, graph_ids=None, num_graphs: int = 1,
                  cutoff: float = 5.0, mesh=None) -> torch.Tensor:
    """Energy per graph: (num_graphs,) over ``graph_ids``, else (1,).
    Under ``mesh`` (``nequip_apply``'s layout; ``graph_ids`` the rank's
    rows) the sums over every rank's nodes, the same on every rank
    (backward: the rank's nodes' part)."""
    e = nequip_apply(params, species, pos, src, dst, edge_mask, node_mask,
                     cutoff=cutoff, mesh=mesh)
    if graph_ids is not None:
        out = segment_sum(e, graph_ids.long(), num_graphs)
    else:
        out = torch.sum(e)[None]
    return out if mesh is None else spmd.all_reduce(out, mesh,
                                                    mesh.axis_names)


def nequip_energy_forces(params: Dict, species, pos, src, dst, **kw):
    """``(E, forces)``: the total energy and ``-dE/dpos`` (the equivariant
    output), by ``torch.autograd.grad`` with respect to ``pos`` alone."""
    with torch.enable_grad():
        pp = pos.detach().requires_grad_()
        e = torch.sum(nequip_energy(params, species, pp, src, dst, **kw))
        (g,) = torch.autograd.grad(e, pp)
    return e.detach(), -g
