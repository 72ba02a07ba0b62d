"""Decoder-only LM family: dense and MoE GQA transformers (the port of
``repro/models/transformer.py``).

Layer parameters and KV caches stay **stacked** on a leading layer axis,
as in the reference, so ``convert.params_from_jax`` and the cache trees map
one to one; the reference's ``lax.scan`` over the stack is a Python loop
over ``stack[i]`` views here.  MoE configs interleave by **superblocks**,
as the reference: each runs ``moe_every - 1`` dense layers (the
``dense_layers`` stack seen as ``(n_moe, moe_every - 1, ...)``) and then
one attention + MoE layer (``moe_layers``); the aux loss of every MoE layer
is summed.  Every use casts to ``cfg.dtype`` where the reference casts (the
embedding, the norms' scales, ``linear_apply``, the FFN and expert weights,
the head; the router is cast to fp32 where it is used), so fp32 parameters
compute in bf16 as there; ``cast_params`` casts a tree's float leaves but
the routers once, for serving, with the same numbers.  Serving:
``lm_prefill`` returns the stacked caches, ``lm_decode_step`` writes the
new token's KV into them in place and attends through the flash-decode
kernel (``attn="kernel"``) or the reference's plain einsums
(``attn="plain"``).  Training: ``lm_loss`` is the reference's chunked
cross-entropy over ``lm_backbone(remat=True)``, each layer (each superblock
of a MoE config) and each loss chunk under ``torch.utils.checkpoint`` (the
counterpart of ``jax.checkpoint``); a layer casts its fp32 views, routers
included, to ``cfg.dtype`` inside its checkpointed function, as the
reference casts its stacks before its scan, so no bf16 copy of a whole
stack is ever made.

**The mesh path.**  Under ``dist.sharding.use_mesh`` (the reference's
``with mesh:``) every entry point runs as manual SPMD on rank-local
tensors (``dist.spmd``), the parameters laid out by ``lm_param_specs``
(``convert.shard_params``): the layer stacks' ZeRO shard over the batch
axes is gathered a layer at a time from its owner; ``wq`` / ``wk`` / ``wv``
/ ``wg`` / ``wu`` are column-parallel and ``wo`` / ``wd`` row-parallel over
``model`` (each ending in an all-reduce); the vocabulary-cut ``embed`` is a
masked lookup and an all-reduce, the vocabulary-cut ``head`` leaves the
logits cut (``("batch", None, "model")``) and ``lm_loss`` takes a
cross-rank log-sum-exp.  The attention core of training and prefill is cut
over ``model`` by heads where the head count divides the axis, else by
query rows (``nn.attention.core_cut``).  Between layers the residual
stream is held as the reference's ``shard_activation(h, ("batch",
"model", None))`` lays it out, its sequence cut over ``model`` where it
divides, and gathered whole at each layer's start.  Training remats as the
reference does: each layer (each superblock of a MoE config) runs under
``torch.utils.checkpoint`` from that sequence-cut carry, its ZeRO gather
and cast inside, so a layer stashes 1 / ``model`` of ``h`` and no gathered
weight; each loss chunk likewise.  The MoE branch runs shard-local
dispatch over the data axes with F-sliced experts
(``moe_apply(tp_axis="model")``), as the reference's ``shard_map``;
elsewhere it routes the tokens of every batch rank, and each model rank
runs only its E / model whole experts (``moe_apply(ep_axis="model")``, the
expert parallelism GSPMD derives there), or its F-slices where E does not
divide the axis.  Decode's caches follow
``LMBundle._cache_spec``.  Inputs and outputs are the rank's blocks:
tokens and logits batch-local, logits vocabulary-cut.  At a (1, 1) mesh
every collective is skipped and each step runs the single-device ops.
"""
from __future__ import annotations

import contextvars
import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..dist import spmd
from ..dist.sharding import (P, ambient_mesh, batch_axes, lm_param_specs,
                             shard_activation, unshard_activation, use_mesh)
from ..nn.attention import (causal_attention, decode_attention,
                            prefill_attention, rope_freqs,
                            tp_decode_attention, tp_prefill_attention)
from ..nn.layers import cross_entropy, rmsnorm_apply, swiglu
from ..nn.moe import fill_normal_, moe_apply
from ..train.optimizer import tree_map


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    # MoE
    n_experts: int = 0            # 0 = dense
    top_k: int = 1
    moe_every: int = 1            # one MoE layer per ``moe_every`` layers
    shared_expert: bool = False
    # numerics
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    rope_theta: float = 500000.0

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_moe_layers(self) -> int:
        return self.n_layers // self.moe_every if self.n_experts else 0

    @property
    def n_dense_layers(self) -> int:
        return self.n_layers - self.n_moe_layers

    def _attn_params(self) -> int:
        return self.n_layers * (self.d_model * self.n_heads * self.hd * 2
                                + self.d_model * self.n_kv * self.hd * 2)

    def param_count(self) -> int:
        f = 3 * self.d_model * self.d_ff
        if self.n_experts:
            ffn = (self.n_moe_layers * self.n_experts * f
                   + self.n_dense_layers * f
                   + (self.n_moe_layers * f if self.shared_expert else 0)
                   + self.n_moe_layers * self.d_model * self.n_experts)
        else:
            ffn = self.n_layers * f
        return self._attn_params() + ffn + 2 * self.vocab * self.d_model

    def active_param_count(self) -> int:
        """Parameters a token runs through: ``top_k`` experts of each MoE
        layer (the router not counted, as in the reference)."""
        if not self.n_experts:
            return self.param_count()
        f = 3 * self.d_model * self.d_ff
        ffn = (self.n_moe_layers * self.top_k * f + self.n_dense_layers * f
               + (self.n_moe_layers * f if self.shared_expert else 0))
        return self._attn_params() + ffn + 2 * self.vocab * self.d_model

    def kv_bytes_per_token(self) -> int:
        """Bytes of K and V one token adds over all layers (every layer,
        dense or MoE, has attention; the caches are ``dtype``)."""
        size = torch.empty((), dtype=self.dtype).element_size()
        return self.n_layers * 2 * self.n_kv * self.hd * size


# ------------------------------------------------------------------- init
def _layer_shapes(cfg: LMConfig, moe: bool = False) -> Dict:
    """One layer's leaves: (shape, init std) each; std None = ones.  A MoE
    layer has ``moe`` (router, experts, optional shared expert) where a
    dense one has ``ffn``."""
    D, hd, F = cfg.d_model, cfg.hd, cfg.d_ff
    lin = lambda i, o: {"w": ((i, o), 1.0 / math.sqrt(i))}
    swi = lambda *lead: {"wg": ((*lead, D, F), 1.0 / math.sqrt(D)),
                         "wu": ((*lead, D, F), 1.0 / math.sqrt(D)),
                         "wd": ((*lead, F, D), 1.0 / math.sqrt(F))}
    out = {
        "attn": {"wq": lin(D, cfg.n_heads * hd), "wk": lin(D, cfg.n_kv * hd),
                 "wv": lin(D, cfg.n_kv * hd), "wo": lin(cfg.n_heads * hd, D)},
        "ln1": {"scale": ((D,), None)},
        "ln2": {"scale": ((D,), None)},
    }
    if not moe:
        out["ffn"] = swi()
        return out
    out["moe"] = {"router": ((D, cfg.n_experts), 1.0 / math.sqrt(D)),
                  **swi(cfg.n_experts)}
    if cfg.shared_expert:
        out["moe"]["shared"] = swi()
    return out


def lm_init(generator: torch.Generator, cfg: LMConfig, device="cuda",
            dtype=None) -> Dict:
    """The reference's stacked parameter tree (``dense_layers`` leaves on a
    leading (n_dense_layers,) axis; a MoE config's ``moe_layers`` on
    (n_moe_layers,)), drawn where ``generator`` lives one matrix at a time
    (an expert stack expert by expert) and stored on ``device`` in
    ``dtype`` (``cfg.param_dtype`` by default).  At full width draw with a
    generator on the card and ``dtype=torch.bfloat16``: granite-8b's 16.5
    GB, or a llama4 MoE layer's 32.2 GB of experts, never an fp32 copy of
    a stack."""
    dev = resolve_device(device)

    def leaf(shape, std):
        out = torch.empty(shape, device=dev, dtype=dtype or cfg.param_dtype)
        if std is None:
            return out.fill_(1.0)
        fill_normal_(out, std, generator)
        return out
    return _param_tree(cfg, leaf)


def lm_abstract_params(cfg: LMConfig, dtype=None) -> Dict:
    """``lm_init``'s tree on the ``meta`` device: its shapes and dtypes
    (``cfg.param_dtype`` by default), nothing allocated or drawn."""
    return _param_tree(cfg, lambda shape, std: torch.empty(
        shape, dtype=dtype or cfg.param_dtype, device="meta"))


def _param_tree(cfg: LMConfig, leaf) -> Dict:
    """The stacked parameter tree, each leaf ``leaf(shape, init std)`` (std
    None: ones), built in the order ``lm_init`` draws."""
    def stacked(spec, n):
        if isinstance(spec, dict):
            return {k: stacked(v, n) for k, v in spec.items()}
        shape, std = spec
        return leaf((n, *shape) if n else shape, std)

    params = {"embed": stacked(((cfg.vocab, cfg.d_model), 0.02), 0),
              "ln_f": {"scale": stacked(((cfg.d_model,), None), 0)},
              "head": stacked(((cfg.d_model, cfg.vocab), 0.02), 0)}
    if cfg.n_dense_layers:
        params["dense_layers"] = stacked(_layer_shapes(cfg),
                                         cfg.n_dense_layers)
    if cfg.n_moe_layers:
        params["moe_layers"] = stacked(_layer_shapes(cfg, moe=True),
                                       cfg.n_moe_layers)
    return params


def cast_params(params, cfg: LMConfig):
    """The tree with every float leaf in ``cfg.dtype`` but the MoE routers:
    cast once for serving, it gives the numbers of the per-use casts (the
    reference routes its prefill and decode with the router as stored, in
    fp32, and casts it only where training casts the whole stacks)."""
    def walk(t, key=None):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        if key == "router" or not t.is_floating_point():
            return t
        return t.to(cfg.dtype)
    return walk(params)


def _layer(params, i: int, stack: str = "dense_layers"):
    """Layer i of a stack: views into it."""
    return tree_map(lambda a: a[i], params[stack])


def layer_schedule(params, cfg: LMConfig) -> list:
    """``(kind, layer params, cache index)`` for every layer in execution
    order: ``kind`` "dense" or "moe", the layer's views into its stack,
    and its index into that kind's cache stack (``(i,)`` for a dense
    model; a MoE config's superblock j runs ``("dense", ..., (j, i))`` for
    i < moe_every - 1, then ``("moe", ..., (j,))``)."""
    if not cfg.n_experts:
        return [("dense", _layer(params, i), (i,))
                for i in range(cfg.n_layers)]
    per = cfg.moe_every - 1
    out = []
    for j in range(cfg.n_moe_layers):
        out += [("dense", _layer(params, j * per + i), (j, i))
                for i in range(per)]
        out.append(("moe", _layer(params, j, "moe_layers"), (j,)))
    return out


# ---------------------------------------------------------------- helpers
def _attn(lp, h, cfg: LMConfig, cos, sin, window=None):
    h2 = rmsnorm_apply(lp["ln1"], h)
    return h + causal_attention(lp["attn"], h2, cfg.n_heads, cfg.n_kv,
                                cfg.hd, cos, sin, window=window)


def _dense_ffn(lp, h):
    h2 = rmsnorm_apply(lp["ln2"], h)
    dt = h.dtype
    return h + swiglu(h2 @ lp["ffn"]["wg"].to(dt),
                      h2 @ lp["ffn"]["wu"].to(dt)) @ lp["ffn"]["wd"].to(dt)


def _moe_ffn(lp, h, cfg: LMConfig):
    """MoE block.  Under a mesh, dispatch runs SHARD-LOCALLY over the data
    axes, each model rank computing its F-slice of every expert and one
    all-reduce combining them (the reference's ``shard_map`` body):
    per-shard capacity, no global sorts/scatters.  Returns (h + out, aux).

    With no mesh, and on the mesh where the branch does not apply, the
    tokens of (B, S) are routed as one (B·S, d) batch: on the mesh, those
    of every batch rank, in the model-axis layout of the expert weights
    (``_model_only_moe_specs``, ``_MeshLM.expert_layout``): each model
    rank runs its E / model whole experts where E divides the axis (the
    expert parallelism GSPMD derives from the reference's layout hints),
    else its F-slice of every expert."""
    h2 = rmsnorm_apply(lp["ln2"], h)
    B, S, D = h2.shape
    mesh = ambient_mesh()
    if mesh is None:
        out, aux = moe_apply(lp["moe"], h2.reshape(B * S, D), cfg.top_k)
        return h + out.reshape(B, S, D), aux
    lm = _MeshLM.of(cfg, mesh)
    T = B * S * (lm.nb if lm.batch_local else 1)
    data_axes = tuple(a for a in mesh.axis_names if a != "model")
    n_data = spmd.size(mesh, data_axes)
    has_model = "model" in mesh.axis_names and mesh.shape["model"] > 1
    if (lm.batch_local and data_axes and T % n_data == 0 and n_data > 1
            and has_model and cfg.d_ff % mesh.shape["model"] == 0):
        h2 = shard_activation(h2, ("batch", None, None))
        flat = h2.reshape(B * S, D)
        # chunk dispatch when the per-shard token count is training-scale
        chunks = 4 if T // n_data >= 16384 else 1
        out, aux = moe_apply(lm.f_sliced(lp["moe"]), flat, cfg.top_k,
                             tp_axis="model", token_chunks=chunks)
        aux = spmd.mean(aux, mesh, data_axes)
    else:
        if lm.expert_layout is None:
            raise ValueError(
                f"{cfg.n_experts} experts of d_ff {cfg.d_ff} on a model "
                f"axis of {mesh.shape['model']}: neither divides it, so "
                "the experts have no model-axis layout to run in")
        flat = h2.reshape(B * S, D)
        spread = lm.batch_local and lm.nb > 1
        if spread:
            flat = spmd.gather_sum(flat, mesh, lm.batch, 0)
        out, aux = moe_apply(lp["moe"], flat, cfg.top_k, **lm.expert_layout)
        if spread:
            i = mesh.index(lm.batch)
            out = out[i * B * S:(i + 1) * B * S]
            # every batch rank holds the same aux: a part each
            aux = spmd.scale_grad(aux, 1.0 / lm.nb)
    return h + out.reshape(B, S, D), aux


def _model_only_moe_specs(moe_p, mesh):
    """The model-axis-only layout of a MoE layer's expert weights (the ZeRO
    data sharding dropped): whole experts per model rank when E divides the
    axis, else F-slices, as the reference constrains them.  It is the
    layout the rank holds once its layer is gathered from the ZeRO shard
    (``lm_param_specs``) and the one ``_moe_ffn``'s non-shard-local branch
    runs in: ``moe_apply(ep_axis="model")`` on the rank's experts, or
    ``tp_axis="model"`` on its F-slices.  Returns the specs (None when the
    mesh has no model axis to cut on)."""
    mdl = mesh.shape.get("model", 1)
    E = moe_p["router"].shape[-1]
    if mdl > 1 and E % mdl == 0:
        specs = {"router": P(None, None), "wg": P("model", None, None),
                 "wu": P("model", None, None), "wd": P("model", None, None)}
    elif mdl > 1:
        specs = {"router": P(None, None), "wg": P(None, None, "model"),
                 "wu": P(None, None, "model"), "wd": P(None, "model", None)}
    else:
        return None
    out = {k: specs[k] for k in specs if k in moe_p}
    if "shared" in moe_p:
        out["shared"] = {"wg": P(None, "model"), "wu": P(None, "model"),
                         "wd": P("model", None)}
    return out


def _superblock_view(params, cfg: LMConfig):
    """The dense stack seen as (n_moe, moe_every - 1, ...), or None when a
    MoE config has no dense layer."""
    per = cfg.moe_every - 1
    if per == 0 or "dense_layers" not in params:
        return None
    return tree_map(lambda a: a.reshape((cfg.n_moe_layers, per)
                                        + tuple(a.shape[1:])),
                    params["dense_layers"])


def _embed(params, tokens, cfg: LMConfig):
    """The token rows of the embedding, in ``cfg.dtype``.  ``F.embedding``
    rather than indexing: its backward sums each row's gradients in a fixed
    order, where indexing's scatter-add order changes from run to run, so
    a training run (and a resumed one) repeats bit for bit."""
    return torch.nn.functional.embedding(tokens.long(),
                                         params["embed"].to(cfg.dtype))


# ---------------------------------------------------------------- forward
def _unbind_layers(stacks) -> list:
    """The per-layer trees of a stacked tree, one ``unbind`` per stack: its
    backward stacks the layers' gradients once, where indexing each layer
    would scatter every layer's gradient into a zero stack."""
    if not isinstance(stacks, dict):
        return list(torch.unbind(stacks))
    per = {k: _unbind_layers(v) for k, v in stacks.items()}
    n = len(next(iter(per.values())))
    return [{k: v[i] for k, v in per.items()} for i in range(n)]


def _compute_cast(lp, dt):
    """A layer's fp32 leaves (a MoE router too) in the compute dtype: the
    reference casts its stacks before its scan."""
    return tree_map(lambda a: a.to(dt) if a.dtype == torch.float32 else a,
                    lp)


def _dense_layer(lp, h, cfg: LMConfig, cos, sin):
    """One dense layer, its fp32 weights cast to the compute dtype first."""
    lp = _compute_cast(lp, h.dtype)
    return _dense_ffn(lp, _attn(lp, h, cfg, cos, sin))


def _superblock(dense_lps, moe_lp, h, cfg: LMConfig, cos, sin):
    """``moe_every - 1`` dense layers, then attention and the MoE FFN; (h,
    aux)."""
    for lp in dense_lps:
        h = _dense_layer(lp, h, cfg, cos, sin)
    lp = _compute_cast(moe_lp, h.dtype)
    return _moe_ffn(lp, _attn(lp, h, cfg, cos, sin), cfg)


def lm_backbone(params, tokens: torch.Tensor, cfg: LMConfig,
                remat: bool = True, constrain=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S) tokens -> final hidden states (B, S, d_model), aux loss (the
    sum over the MoE layers; 0 for dense models).  With ``remat`` (and
    autograd on), each layer (each superblock of a MoE config) keeps only
    its input for the backward and recomputes the rest.

    ``constrain(kind, lp)`` sees each layer's weights before they are used
    (``LMBundle.make_constrain``: under a mesh it holds the gathered layer
    to its per-layer layout); with no mesh it is given the layer's views
    and the identity is the default."""
    mesh = ambient_mesh()
    if mesh is not None:
        return _mesh_backbone(params, tokens, cfg, mesh, constrain, remat)
    cn = constrain if constrain is not None else (lambda kind, lp: lp)
    dt = cfg.dtype
    cos, sin = rope_freqs(cfg.hd, tokens.shape[1], cfg.rope_theta, dtype=dt,
                          device=tokens.device)
    h = _embed(params, tokens, cfg)
    remat = remat and torch.is_grad_enabled()
    ck = lambda f, *args: (checkpoint(f, *args, use_reentrant=False,
                                      preserve_rng_state=False)
                           if remat else f(*args))
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if not cfg.n_experts:
        for lp in _unbind_layers(params["dense_layers"]):
            h = ck(_dense_layer, cn("dense", lp), h, cfg, cos, sin)
        return rmsnorm_apply(params["ln_f"], h), aux
    view = _superblock_view(params, cfg)
    dense = ([_unbind_layers(sb) for sb in _unbind_layers(view)]
             if view is not None else [[]] * cfg.n_moe_layers)
    for dense_lps, moe_lp in zip(dense,
                                 _unbind_layers(params["moe_layers"])):
        h, a = ck(_superblock, [cn("dense", lp) for lp in dense_lps],
                  cn("moe", moe_lp), h, cfg, cos, sin)
        aux = aux + a
    return rmsnorm_apply(params["ln_f"], h), aux


def lm_forward(params, tokens: torch.Tensor, cfg: LMConfig,
               remat: bool = True, constrain=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S) tokens -> (B, S, vocab) logits, aux loss.  Under a mesh the
    logits are the rank's block of ``("batch", None, "model")``: the
    vocabulary-cut head gives that block itself."""
    h, aux = lm_backbone(params, tokens, cfg, remat, constrain)
    mesh = ambient_mesh()
    if mesh is not None:
        return _MeshLM.of(cfg, mesh).head(params, h), aux
    return h @ params["head"].to(cfg.dtype), aux


def _chunk_nll_sum(hb, tb, head):
    return cross_entropy(hb @ head, tb) * tb.numel()


def lm_loss(params, tokens: torch.Tensor, targets: torch.Tensor,
            cfg: LMConfig, aux_weight: float = 0.01, constrain=None,
            loss_chunks: int = 8) -> torch.Tensor:
    """Chunked-softmax cross-entropy: the (B, S, vocab) logits are never
    materialized; each sequence chunk's head matmul and CE run under
    checkpoint, so one chunk's logits are alive at a time.  Under a mesh
    (the rank's rows of tokens and targets) the loss of the whole batch on
    every rank: a cross-rank log-sum-exp over the vocabulary cut, the sum
    over the batch axes."""
    mesh = ambient_mesh()
    if mesh is not None:
        return _mesh_loss(params, tokens, targets, cfg, mesh, aux_weight,
                          constrain, loss_chunks)
    h, aux = lm_backbone(params, tokens, cfg, constrain=constrain)
    S = h.shape[1]
    n = loss_chunks if S % loss_chunks == 0 else 1
    c = S // n
    head = params["head"].to(cfg.dtype)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for j in range(n):
        hb, tb = h[:, j * c:(j + 1) * c], targets[:, j * c:(j + 1) * c]
        if torch.is_grad_enabled():
            total = total + checkpoint(_chunk_nll_sum, hb, tb, head,
                                       use_reentrant=False,
                                       preserve_rng_state=False)
        else:
            total = total + _chunk_nll_sum(hb, tb, head)
    return total / targets.numel() + aux_weight * aux


# ---------------------------------------------------------------- serving
def _ffn(kind, lp, h, cfg: LMConfig):
    return _dense_ffn(lp, h) if kind == "dense" else _moe_ffn(lp, h, cfg)[0]


def _stack_caches(kvs: Dict[str, list], cfg: LMConfig) -> Dict:
    """Per-layer (k, v) lists (execution order) -> the stacked cache tree,
    a MoE config's dense caches as (n_moe, moe_every - 1, ...)."""
    out = {}
    for kind in ("moe", "dense"):
        if not kvs[kind]:
            continue
        k, v = (torch.stack([kv[i] for kv in kvs[kind]]) for i in (0, 1))
        if kind == "dense" and cfg.n_experts:
            lead = (cfg.n_moe_layers, cfg.moe_every - 1)
            k, v = (t.reshape(lead + tuple(t.shape[1:])) for t in (k, v))
        out[kind] = (k, v)
    return out


def lm_prefill(params, tokens: torch.Tensor, cfg: LMConfig,
               window: Optional[int] = None, constrain=None):
    """Prefill: last-position logits (B, 1, vocab) and the KV caches in
    ``cfg.dtype``, mirroring the parameter stacks: ``{"dense": (k, v)}``,
    each (n_layers, B, S, n_kv, hd); a MoE config's ``{"moe": (k, v)}`` of
    (n_moe, B, S, n_kv, hd), and ``"dense"`` of (n_moe, moe_every - 1, B,
    S, n_kv, hd) when the superblocks have dense layers.  Under a mesh:
    the rank's batch rows, its vocabulary block of the logits, and the
    caches of its rows, whole on the sequence and the heads."""
    mesh = ambient_mesh()
    if mesh is not None:
        return _mesh_prefill(params, tokens, cfg, mesh, window, constrain)
    cn = constrain if constrain is not None else (lambda kind, lp: lp)
    dt = cfg.dtype
    S = tokens.shape[1]
    cos, sin = rope_freqs(cfg.hd, S, cfg.rope_theta, dtype=dt,
                          device=tokens.device)
    h = _embed(params, tokens, cfg)
    kvs = {"dense": [], "moe": []}
    for kind, lp, _ in layer_schedule(params, cfg):
        lp = cn(kind, lp)
        h2 = rmsnorm_apply(lp["ln1"], h)
        att, kv = prefill_attention(lp["attn"], h2, cfg.n_heads, cfg.n_kv,
                                    cfg.hd, cos, sin, window=window)
        h = _ffn(kind, lp, h + att, cfg)
        kvs[kind].append(kv)
    h = rmsnorm_apply(params["ln_f"], h)
    logits = h[:, -1:] @ params["head"].to(dt)
    return logits, _stack_caches(kvs, cfg)


def lm_decode_step(params, token: torch.Tensor, kv_caches, cache_len: int,
                   cfg: LMConfig, max_seq: int, attn: str = "kernel",
                   constrain=None):
    """One decode step.  token: (B, 1); cache_len: the new token's
    position.

    kv_caches mirror ``lm_prefill``'s output, padded on the sequence axis
    to ``max_seq``.  The new token's KV is written into them **in place**
    (the reference's caller donates its caches); returns (logits (B, 1,
    vocab), the same cache tree).  ``attn``: ``"kernel"`` (the flash-decode
    kernel, one launch per layer on the card, dense or MoE) or
    ``"plain"``.

    Under a mesh the caches are the rank's blocks of
    ``LMBundle._cache_spec``'s layout (the sequence over ``model`` and the
    batch over the batch axes, or the sequence over every axis), told apart
    by their sequence length against ``max_seq``; ``token`` holds the
    rows the caches hold.
    """
    mesh = ambient_mesh()
    if mesh is not None:
        return _mesh_decode_step(params, token, kv_caches, cache_len, cfg,
                                 max_seq, attn, mesh, constrain)
    cn = constrain if constrain is not None else (lambda kind, lp: lp)
    dt = cfg.dtype
    cos, sin = rope_freqs(cfg.hd, max_seq + 1, cfg.rope_theta, dtype=dt,
                          device=token.device)
    h = _embed(params, token, cfg)
    for kind, lp, idx in layer_schedule(params, cfg):
        lp = cn(kind, lp)
        k_stack, v_stack = kv_caches[kind]
        h2 = rmsnorm_apply(lp["ln1"], h)
        att, _ = decode_attention(lp["attn"], h2, (k_stack[idx],
                                                   v_stack[idx]),
                                  cache_len, cfg.n_heads, cfg.n_kv, cfg.hd,
                                  cos, sin, attn=attn)
        h = _ffn(kind, lp, h + att, cfg)
    h = rmsnorm_apply(params["ln_f"], h)
    return h @ params["head"].to(dt), kv_caches


def kv_cache_shapes(cfg: LMConfig, batch: int, max_seq: int) -> Dict:
    """name -> the shape of each of its (k, v) stacks: ``lm_decode_step``'s
    cache tree (``{"dense"}`` for a dense model; ``{"moe"}``, plus
    ``"dense"`` when ``moe_every > 1``, for a MoE config)."""
    tail = (batch, max_seq, cfg.n_kv, cfg.hd)
    if not cfg.n_experts:
        return {"dense": (cfg.n_layers, *tail)}
    out = {"moe": (cfg.n_moe_layers, *tail)}
    if cfg.moe_every > 1:
        out["dense"] = (cfg.n_moe_layers, cfg.moe_every - 1, *tail)
    return out


def make_kv_caches(cfg: LMConfig, batch: int, max_seq: int, device="cuda"):
    """Zero KV caches in ``cfg.dtype``, in the structure ``lm_decode_step``
    walks (``kv_cache_shapes``): (k, v) per stack."""
    dev = resolve_device(device)
    return {name: tuple(torch.zeros(shape, dtype=cfg.dtype, device=dev)
                        for _ in range(2))
            for name, shape in kv_cache_shapes(cfg, batch, max_seq).items()}


def fill_caches(full, caches) -> None:
    """Copy a prefill's caches into the first positions of padded caches
    (``make_kv_caches``), along the sequence axis (-3) of every stack,
    whatever its rank."""
    for name, pair in caches.items():
        for buf, c in zip(full[name], pair):
            buf.narrow(-3, 0, c.shape[-3]).copy_(c)


# ------------------------------------------------------------ the mesh path
# False while a decode step holds its batch whole on every rank (a batch
# that does not divide the batch axes: ``LMBundle._cache_spec`` cuts the
# sequence over every axis instead); every other mesh step holds its rows
_BATCH_LOCAL: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_lm_batch_local", default=True)


class _MeshLM:
    """What the mesh path needs of one (config, mesh): ``lm_param_specs``,
    the batch axes, which weights are cut over ``model``."""

    def __init__(self, cfg: LMConfig, mesh):
        self.cfg, self.mesh = cfg, mesh
        self.specs = lm_param_specs(cfg, mesh)
        ba = batch_axes(mesh)
        self.batch = (ba,) if isinstance(ba, str) else tuple(ba)
        self.nb = spmd.size(mesh, self.batch)
        cut = lambda spec, d: spec[d] == "model"
        self.vocab = cut(self.specs["embed"], 0)
        layer = self.specs.get("dense_layers") or self.specs["moe_layers"]
        self.col_q = cut(layer["attn"]["wq"], 2)
        self.col_kv = cut(layer["attn"]["wk"], 2)
        self.row_o = cut(layer["attn"]["wo"], 1)
        if "dense_layers" in self.specs:
            self.ffn = cut(self.specs["dense_layers"]["ffn"]["wg"], 2)
        if "moe_layers" in self.specs:
            moe = self.specs["moe_layers"]["moe"]
            self.expert_par = cut(moe["wg"], 1)
            self.expert_f = cut(moe["wg"], 3)
            self.shared_f = "shared" in moe and cut(moe["shared"]["wg"], 2)
            # ``_moe_ffn``'s non-shard-local branch: the rank's whole
            # experts (every expert on a model axis of one rank), else its
            # F-slices; None where the weights are held whole on a model
            # axis that divides neither E nor d_ff
            if self.expert_par or mesh.shape.get("model", 1) == 1:
                self.expert_layout = {"ep_axis": "model",
                                      "shared_cut": self.shared_f}
            elif self.expert_f:
                self.expert_layout = {"tp_axis": "model"}
            else:
                self.expert_layout = None

    @classmethod
    def of(cls, cfg: LMConfig, mesh) -> "_MeshLM":
        """The record of ``(cfg, mesh)``, cached on the mesh."""
        cache = mesh.__dict__.setdefault("_lm_records", {})
        if cfg not in cache:
            cache[cfg] = cls(cfg, mesh)
        return cache[cfg]

    @property
    def batch_local(self) -> bool:
        """Whether the step holds the rank's rows of the batch."""
        return _BATCH_LOCAL.get()

    def rep(self, tree):
        """A parameter every batch rank holds whole, entering the step
        (backward: summed over the batch axes, when the batch is cut)."""
        if not self.batch_local:
            return tree
        return tree_map(lambda a: spmd.copy(a, self.mesh, self.batch), tree)

    def layer(self, params, stack: str, i: int):
        """Layer ``i`` of ``params[stack]``, gathered from its ZeRO shard
        (``spmd.layer_of``).  ``params[stack]`` is the stacked tree or the
        rank's layers as a list of trees (``_unbind_layers``, as training
        passes them: the backward stacks their gradients once)."""
        n = (self.cfg.n_moe_layers if stack == "moe_layers"
             else self.cfg.n_dense_layers)
        layers = params[stack]
        if isinstance(layers, list):
            each = lambda fn: tree_map(lambda *views: fn(views), *layers)
        else:
            each = lambda fn: tree_map(fn, layers)
        if not self.batch_local:
            return each(lambda a: self._layer_whole(a, i, n))
        return each(lambda a: spmd.layer_of(a, i, n, self.mesh, self.batch))

    def _layer_whole(self, a, i, n):
        # a step that holds the batch whole (a decode batch below the
        # batch axes) has no gradient to sum: the broadcast alone
        if len(a) == n:
            return a[i]
        with torch.no_grad():
            return spmd.layer_of(a, i, n, self.mesh, self.batch)

    def embed(self, params, tokens):
        """The token rows of the (vocabulary-cut) embedding, whole on every
        rank: a masked lookup and an all-reduce over ``model``."""
        table = self.rep(params["embed"]).to(self.cfg.dtype)
        if not self.vocab:
            return torch.nn.functional.embedding(tokens.long(), table)
        V = table.shape[0]
        local = tokens.long() - self.mesh.coord("model") * V
        ok = (local >= 0) & (local < V)
        rows = torch.nn.functional.embedding(local.clamp(0, V - 1), table)
        return spmd.all_reduce(rows * ok[..., None].to(rows.dtype),
                               self.mesh, "model")

    def head_w(self, params):
        return self.rep(params["head"]).to(self.cfg.dtype)

    def head(self, params, h):
        """Logits, vocabulary-cut over ``model`` when the head is."""
        w = self.head_w(params)
        if not self.vocab:
            return h @ w
        return spmd.copy(h, self.mesh, "model") @ w

    def nll_sum(self, logits, targets):
        """Sum of the rows' cross-entropy of (vocabulary-cut) logits."""
        if not self.vocab:
            return cross_entropy(logits, targets) * targets.numel()
        lg = logits.to(torch.float32)
        m = spmd.max_(torch.amax(lg, dim=-1, keepdim=True), self.mesh,
                      "model")
        se = spmd.all_reduce(torch.sum(torch.exp(lg - m), dim=-1),
                             self.mesh, "model")
        logz = torch.log(se) + m[..., 0]
        V = lg.shape[-1]
        local = targets.long() - self.mesh.coord("model") * V
        ok = (local >= 0) & (local < V)
        gold = torch.gather(lg, -1, local.clamp(0, V - 1)[..., None])[..., 0]
        gold = spmd.all_reduce(gold * ok.to(gold.dtype), self.mesh, "model")
        return torch.sum(logz - gold)

    def dense_ffn(self, lp, h):
        if not self.ffn:
            return _dense_ffn(lp, h)
        h2 = rmsnorm_apply(lp["ln2"], h)
        dt, f = h.dtype, lp["ffn"]
        x = spmd.copy(h2, self.mesh, "model")
        y = swiglu(x @ f["wg"].to(dt), x @ f["wu"].to(dt)) @ f["wd"].to(dt)
        return h + spmd.all_reduce(y, self.mesh, "model")

    def f_sliced(self, moe_p):
        """The rank's F-slices of every expert (the reference's
        ``shard_map`` in-specs): whole experts per rank are all-gathered
        over ``model`` first, then cut on F (backward: summed, then the
        rank's experts)."""
        if not self.expert_par:
            return moe_p
        m, i = self.mesh, self.mesh.coord("model")
        out = dict(moe_p)
        for k, fdim in (("wg", 2), ("wu", 2), ("wd", 1)):
            whole = spmd.gather_sum(moe_p[k], m, "model", 0)
            n = whole.shape[fdim] // m.shape["model"]
            out[k] = whole.narrow(fdim, i * n, n)
        return out

    def attention(self, lp, h, cos, sin, window=None):
        cfg = self.cfg
        h2 = rmsnorm_apply(lp["ln1"], h)
        att, kv = tp_prefill_attention(
            lp["attn"], h2, cfg.n_heads, cfg.n_kv, cfg.hd, cos, sin,
            self.mesh, self.col_q, self.col_kv, self.row_o, window=window)
        return h + att, kv


def _mesh_schedule(cfg: LMConfig) -> list:
    """``(kind, stack, layer index in its stack, cache index)`` in
    execution order (``layer_schedule``'s walk)."""
    if not cfg.n_experts:
        return [("dense", "dense_layers", i, (i,))
                for i in range(cfg.n_layers)]
    per = cfg.moe_every - 1
    out = []
    for j in range(cfg.n_moe_layers):
        out += [("dense", "dense_layers", j * per + i, (j, i))
                for i in range(per)]
        out.append(("moe", "moe_layers", j, (j,)))
    return out


_SEQ = ("batch", "model", None)


def _mesh_units(cfg: LMConfig) -> list:
    """``_mesh_schedule`` in checkpointed units: a layer each for a dense
    config, a superblock each (``moe_every - 1`` dense layers, then the MoE
    layer) for a MoE config, as ``lm_backbone``'s."""
    sched = _mesh_schedule(cfg)
    if not cfg.n_experts:
        return [[entry] for entry in sched]
    n = cfg.moe_every
    return [sched[j * n:(j + 1) * n] for j in range(cfg.n_moe_layers)]


def _mesh_unit(mesh, batch_local: bool, cfg: LMConfig, local, unit, cn,
               cos, sin, shape, h):
    """One unit of the mesh backbone from the sequence-cut carry ``h`` to
    the next: each layer gathered from its ZeRO shard (``local``: stack
    name -> the rank's layers, ``_unbind_layers``) and cast, ``h``
    gathered whole, attention and FFN, ``h`` cut again.  Returns (h, the
    unit's aux).

    The mesh and ``_BATCH_LOCAL`` come as arguments and are installed
    here: a checkpoint recomputes the unit in autograd's thread (on CUDA a
    device thread), where the caller's context variables are not set."""
    token = _BATCH_LOCAL.set(batch_local)
    try:
        with use_mesh(mesh):
            lm = _MeshLM.of(cfg, mesh)
            aux = torch.zeros((), dtype=torch.float32, device=h.device)
            for kind, stack, i, _ in unit:
                lp = _compute_cast(cn(kind, lm.layer(local, stack, i)),
                                   cfg.dtype)
                h = unshard_activation(h, _SEQ, shape)
                h, _ = lm.attention(lp, h, cos, sin)
                if kind == "dense":
                    h = lm.dense_ffn(lp, h)
                else:
                    h, a = _moe_ffn(lp, h, cfg)
                    aux = aux + a
                h = shard_activation(h, _SEQ)
            return h, aux
    finally:
        _BATCH_LOCAL.reset(token)


def _remat(fn, *args):
    """``fn(*args)`` under a non-reentrant checkpoint.  Its recompute
    issues the forward's collectives again, up to the last tensor the
    forward saved (the recompute stops there): the same point, and so the
    same collectives in the same order, on every rank, as every rank
    builds the same graph (no rank decides by itself what is
    checkpointed)."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _mesh_backbone(params, tokens, cfg: LMConfig, mesh, constrain,
                   remat: bool = True):
    """``lm_backbone`` on the mesh path.  With ``remat`` (and autograd on)
    each unit (``_mesh_units``) runs under a checkpoint: it stashes its
    input, the rank's S / model rows of ``h`` (the sequence-parallel
    carry), and recomputes the rest, its layers' ZeRO gathers included."""
    lm = _MeshLM.of(cfg, mesh)
    cn = constrain if constrain is not None else (lambda kind, lp: lp)
    cos, sin = rope_freqs(cfg.hd, tokens.shape[1], cfg.rope_theta,
                          dtype=cfg.dtype, device=tokens.device)
    h = lm.embed(params, tokens)
    shape = tuple(h.shape)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    # sequence-parallel carry: between layers h lives seq-cut on model
    h = shard_activation(h, _SEQ)
    remat = remat and torch.is_grad_enabled()
    local = {k: _unbind_layers(params[k])
             for k in ("dense_layers", "moe_layers") if k in params}
    for unit in _mesh_units(cfg):
        args = (mesh, lm.batch_local, cfg, local, unit, cn, cos, sin, shape,
                h)
        h, a = _remat(_mesh_unit, *args) if remat else _mesh_unit(*args)
        aux = aux + a
    h = unshard_activation(h, _SEQ, shape)
    return rmsnorm_apply(lm.rep(params["ln_f"]), h), aux


def _mesh_chunk_nll(lm: "_MeshLM", hb, tb, w):
    """One loss chunk's head matmul and cross-entropy sum; the mesh comes
    with ``lm`` (no ambient read), so autograd's thread can recompute it."""
    if lm.vocab:
        hb = spmd.copy(hb, lm.mesh, "model")
    return lm.nll_sum(hb @ w, tb)


def _mesh_loss(params, tokens, targets, cfg: LMConfig, mesh, aux_weight,
               constrain, loss_chunks):
    """``lm_loss`` on the mesh path.  With autograd on, each chunk's head
    matmul and cross-entropy run under a checkpoint that stashes the
    chunk's rows of ``h``: one chunk's logits are alive at a time."""
    lm = _MeshLM.of(cfg, mesh)
    h, aux = _mesh_backbone(params, tokens, cfg, mesh, constrain)
    S = h.shape[1]
    n = loss_chunks if S % loss_chunks == 0 else 1
    c = S // n
    w = lm.head_w(params)
    remat = torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for j in range(n):
        args = (lm, h[:, j * c:(j + 1) * c], targets[:, j * c:(j + 1) * c],
                w)
        total = total + (_remat(_mesh_chunk_nll, *args) if remat
                         else _mesh_chunk_nll(*args))
    total = spmd.all_reduce(total, mesh, lm.batch)
    return total / (targets.numel() * lm.nb) + aux_weight * aux


def _mesh_prefill(params, tokens, cfg: LMConfig, mesh, window, constrain):
    lm = _MeshLM.of(cfg, mesh)
    cn = constrain if constrain is not None else (lambda kind, lp: lp)
    dt = cfg.dtype
    S = tokens.shape[1]
    cos, sin = rope_freqs(cfg.hd, S, cfg.rope_theta, dtype=dt,
                          device=tokens.device)
    h = lm.embed(params, tokens)
    shape = tuple(h.shape)
    h = shard_activation(h, _SEQ)
    kvs = {"dense": [], "moe": []}
    for kind, stack, i, _ in _mesh_schedule(cfg):
        lp = cn(kind, lm.layer(params, stack, i))
        h = unshard_activation(h, _SEQ, shape)
        h, kv = lm.attention(lp, h, cos, sin, window)
        h = (lm.dense_ffn(lp, h) if kind == "dense"
             else _moe_ffn(lp, h, cfg)[0])
        h = shard_activation(h, _SEQ)
        kvs[kind].append(kv)
    h = unshard_activation(h, _SEQ, shape)
    h = rmsnorm_apply(lm.rep(params["ln_f"]), h)
    return lm.head(params, h[:, -1:]), _stack_caches(kvs, cfg)


def _mesh_decode_step(params, token, kv_caches, cache_len, cfg: LMConfig,
                      max_seq, attn, mesh, constrain):
    lm = _MeshLM.of(cfg, mesh)
    first = next(iter(kv_caches.values()))[0]
    n_seq = max_seq // first.shape[-3]
    if n_seq == mesh.shape.get("model", 1):
        seq_axes, rows = ("model",), True
    elif n_seq == mesh.size:
        seq_axes, rows = tuple(mesh.axis_names), False
    else:
        raise ValueError(f"caches of {first.shape[-3]} positions of "
                         f"max_seq {max_seq} are not a layout of "
                         f"LMBundle._cache_spec on {mesh!r}")
    token_ = _BATCH_LOCAL.set(rows)
    try:
        cn = constrain if constrain is not None else (lambda kind, lp: lp)
        dt = cfg.dtype
        cos, sin = rope_freqs(cfg.hd, max_seq + 1, cfg.rope_theta, dtype=dt,
                              device=token.device)
        h = lm.embed(params, token)
        for kind, stack, i, idx in _mesh_schedule(cfg):
            lp = cn(kind, lm.layer(params, stack, i))
            k_stack, v_stack = kv_caches[kind]
            h2 = rmsnorm_apply(lp["ln1"], h)
            att, _ = tp_decode_attention(
                lp["attn"], h2, (k_stack[idx], v_stack[idx]), cache_len,
                cfg.n_heads, cfg.n_kv, cfg.hd, cos, sin, mesh, lm.col_q,
                lm.col_kv, lm.row_o, seq_axes, attn=attn)
            h = (lm.dense_ffn(lp, h + att) if kind == "dense"
                 else _moe_ffn(lp, h + att, cfg)[0])
        h = rmsnorm_apply(lm.rep(params["ln_f"]), h)
        return lm.head(params, h), kv_caches
    finally:
        _BATCH_LOCAL.reset(token_)
