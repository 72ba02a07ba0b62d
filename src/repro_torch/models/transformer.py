"""Decoder-only LM family: dense and MoE GQA transformers (the port of
``repro/models/transformer.py``; the mesh branch of ``_moe_ffn`` and the
``constrain`` hooks wait for ROADMAP item 9).

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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..nn.attention import (causal_attention, decode_attention,
                            prefill_attention, rope_freqs)
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
    dtype = dtype or cfg.param_dtype

    def stacked(spec, n):
        if isinstance(spec, dict):
            return {k: stacked(v, n) for k, v in spec.items()}
        shape, std = spec
        out = torch.empty((n, *shape) if n else shape, device=dev,
                          dtype=dtype)
        if std is None:
            return out.fill_(1.0)
        fill_normal_(out, std, generator)
        return out

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
    """The MoE block on one device: the tokens of (B, S) routed as one
    (B·S, d) batch, the reference's single-device branch.  Returns (h +
    out, aux)."""
    h2 = rmsnorm_apply(lp["ln2"], h)
    B, S, D = h2.shape
    out, aux = moe_apply(lp["moe"], h2.reshape(B * S, D), cfg.top_k)
    return h + out.reshape(B, S, D), aux


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
                remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S) tokens -> final hidden states (B, S, d_model), aux loss (the
    sum over the MoE layers; 0 for dense models).  With ``remat`` (and
    autograd on), each layer (each superblock of a MoE config) keeps only
    its input for the backward and recomputes the rest."""
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
            h = ck(_dense_layer, lp, h, cfg, cos, sin)
        return rmsnorm_apply(params["ln_f"], h), aux
    view = _superblock_view(params, cfg)
    dense = ([_unbind_layers(sb) for sb in _unbind_layers(view)]
             if view is not None else [[]] * cfg.n_moe_layers)
    for dense_lps, moe_lp in zip(dense,
                                 _unbind_layers(params["moe_layers"])):
        h, a = ck(_superblock, dense_lps, moe_lp, h, cfg, cos, sin)
        aux = aux + a
    return rmsnorm_apply(params["ln_f"], h), aux


def lm_forward(params, tokens: torch.Tensor, cfg: LMConfig,
               remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S) tokens -> (B, S, vocab) logits, aux loss."""
    h, aux = lm_backbone(params, tokens, cfg, remat)
    return h @ params["head"].to(cfg.dtype), aux


def _chunk_nll_sum(hb, tb, head):
    return cross_entropy(hb @ head, tb) * tb.numel()


def lm_loss(params, tokens: torch.Tensor, targets: torch.Tensor,
            cfg: LMConfig, aux_weight: float = 0.01,
            loss_chunks: int = 8) -> torch.Tensor:
    """Chunked-softmax cross-entropy: the (B, S, vocab) logits are never
    materialized; each sequence chunk's head matmul and CE run under
    checkpoint, so one chunk's logits are alive at a time."""
    h, aux = lm_backbone(params, tokens, cfg)
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
               window: Optional[int] = None):
    """Prefill: last-position logits (B, 1, vocab) and the KV caches in
    ``cfg.dtype``, mirroring the parameter stacks: ``{"dense": (k, v)}``,
    each (n_layers, B, S, n_kv, hd); a MoE config's ``{"moe": (k, v)}`` of
    (n_moe, B, S, n_kv, hd), and ``"dense"`` of (n_moe, moe_every - 1, B,
    S, n_kv, hd) when the superblocks have dense layers."""
    dt = cfg.dtype
    S = tokens.shape[1]
    cos, sin = rope_freqs(cfg.hd, S, cfg.rope_theta, dtype=dt,
                          device=tokens.device)
    h = _embed(params, tokens, cfg)
    kvs = {"dense": [], "moe": []}
    for kind, lp, _ in layer_schedule(params, cfg):
        h2 = rmsnorm_apply(lp["ln1"], h)
        att, kv = prefill_attention(lp["attn"], h2, cfg.n_heads, cfg.n_kv,
                                    cfg.hd, cos, sin, window=window)
        h = _ffn(kind, lp, h + att, cfg)
        kvs[kind].append(kv)
    h = rmsnorm_apply(params["ln_f"], h)
    logits = h[:, -1:] @ params["head"].to(dt)
    return logits, _stack_caches(kvs, cfg)


def lm_decode_step(params, token: torch.Tensor, kv_caches, cache_len: int,
                   cfg: LMConfig, max_seq: int, attn: str = "kernel"):
    """One decode step.  token: (B, 1); cache_len: the new token's
    position.

    kv_caches mirror ``lm_prefill``'s output, padded on the sequence axis
    to ``max_seq``.  The new token's KV is written into them **in place**
    (the reference's caller donates its caches); returns (logits (B, 1,
    vocab), the same cache tree).  ``attn``: ``"kernel"`` (the flash-decode
    kernel, one launch per layer on the card, dense or MoE) or
    ``"plain"``.
    """
    dt = cfg.dtype
    cos, sin = rope_freqs(cfg.hd, max_seq + 1, cfg.rope_theta, dtype=dt,
                          device=token.device)
    h = _embed(params, token, cfg)
    for kind, lp, idx in layer_schedule(params, cfg):
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
