"""Decoder-only LM family, dense GQA transformers (the port of the dense
paths of ``repro/models/transformer.py``; the MoE configs are not ported,
ROADMAP §1 item 8b).

Layer parameters and KV caches stay **stacked** on a leading layer axis,
as in the reference, so ``convert.params_from_jax`` and the cache trees map
one to one; the reference's ``lax.scan`` over the stack is a Python loop
over ``stack[i]`` views here.  Every use casts to ``cfg.dtype`` where the
reference casts (the embedding, the norms' scales, ``linear_apply``, the
FFN weights, the head), so fp32 parameters compute in bf16 as there;
``cast_params`` casts a tree's float leaves once, for serving, with the
same numbers.  Serving: ``lm_prefill`` returns the stacked caches,
``lm_decode_step`` writes the new token's KV into them in place and
attends through the flash-decode kernel (``attn="kernel"``) or the
reference's plain einsums (``attn="plain"``).  Training: ``lm_loss`` is
the reference's chunked cross-entropy over ``lm_backbone(remat=True)``,
each layer and each loss chunk under ``torch.utils.checkpoint`` (the
counterpart of ``jax.checkpoint``); a layer casts its fp32 views to
``cfg.dtype`` inside its checkpointed function, so no bf16 copy of a whole
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
    # numerics
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    rope_theta: float = 500000.0

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        attn = self.n_layers * (self.d_model * self.n_heads * self.hd * 2
                                + self.d_model * self.n_kv * self.hd * 2)
        ffn = self.n_layers * 3 * self.d_model * self.d_ff
        return attn + ffn + 2 * self.vocab * self.d_model

    def kv_bytes_per_token(self) -> int:
        """Bytes of K and V one token adds over all layers (the caches are
        ``dtype``)."""
        size = torch.empty((), dtype=self.dtype).element_size()
        return self.n_layers * 2 * self.n_kv * self.hd * size


# ------------------------------------------------------------------- init
def _layer_shapes(cfg: LMConfig) -> Dict:
    """One dense layer's leaves: (shape, init std) each; std None = ones."""
    D, hd = cfg.d_model, cfg.hd
    lin = lambda i, o: {"w": ((i, o), 1.0 / math.sqrt(i))}
    return {
        "attn": {"wq": lin(D, cfg.n_heads * hd), "wk": lin(D, cfg.n_kv * hd),
                 "wv": lin(D, cfg.n_kv * hd), "wo": lin(cfg.n_heads * hd, D)},
        "ln1": {"scale": ((D,), None)},
        "ln2": {"scale": ((D,), None)},
        "ffn": {"wg": ((D, cfg.d_ff), 1.0 / math.sqrt(D)),
                "wu": ((D, cfg.d_ff), 1.0 / math.sqrt(D)),
                "wd": ((cfg.d_ff, D), 1.0 / math.sqrt(cfg.d_ff))},
    }


def lm_init(generator: torch.Generator, cfg: LMConfig, device="cuda",
            dtype=None) -> Dict:
    """The reference's stacked parameter tree (``dense_layers`` leaves on a
    leading (n_layers,) axis), drawn where ``generator`` lives, one layer at
    a time, and stored on ``device`` in ``dtype`` (``cfg.param_dtype`` by
    default).  At granite-8b's full width draw with a generator on the card
    and ``dtype=torch.bfloat16``: 16.5 GB, never an fp32 copy of a stack."""
    dev = resolve_device(device)
    dtype = dtype or cfg.param_dtype
    gd = generator.device

    def draw(shape, std):
        if std is None:
            return torch.ones(shape, device=dev, dtype=dtype)
        t = torch.randn(shape, generator=generator, device=gd)
        return t.mul_(std).to(dev, dtype)

    def stacked(spec):
        if isinstance(spec, dict):
            return {k: stacked(v) for k, v in spec.items()}
        shape, std = spec
        out = torch.empty((cfg.n_layers, *shape), device=dev, dtype=dtype)
        for i in range(cfg.n_layers):
            out[i] = draw(shape, std)
        return out

    return {"embed": draw((cfg.vocab, cfg.d_model), 0.02),
            "ln_f": {"scale": draw((cfg.d_model,), None)},
            "head": draw((cfg.d_model, cfg.vocab), 0.02),
            "dense_layers": stacked(_layer_shapes(cfg))}


def cast_params(params, cfg: LMConfig):
    """The tree with every float leaf in ``cfg.dtype``: cast once for
    serving, it gives the numbers of the per-use casts."""
    return tree_map(lambda t: t.to(cfg.dtype) if t.is_floating_point()
                    else t, params)


def _layer(params, i: int):
    """Layer i's parameters: views into the stacks."""
    return tree_map(lambda a: a[i], params["dense_layers"])


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


def _dense_layer(lp, h, cfg: LMConfig, cos, sin):
    """One dense layer, its fp32 weights cast to the compute dtype first
    (the reference casts the stacks before its scan)."""
    lp = tree_map(lambda a: a.to(h.dtype) if a.dtype == torch.float32
                  else a, lp)
    return _dense_ffn(lp, _attn(lp, h, cfg, cos, sin))


def lm_backbone(params, tokens: torch.Tensor, cfg: LMConfig,
                remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S) tokens -> final hidden states (B, S, d_model), aux loss (0
    for dense models).  With ``remat`` (and autograd on), each layer keeps
    only its input for the backward and recomputes the rest."""
    dt = cfg.dtype
    cos, sin = rope_freqs(cfg.hd, tokens.shape[1], cfg.rope_theta, dtype=dt,
                          device=tokens.device)
    h = _embed(params, tokens, cfg)
    remat = remat and torch.is_grad_enabled()
    for lp in _unbind_layers(params["dense_layers"]):
        if remat:
            h = checkpoint(_dense_layer, lp, h, cfg, cos, sin,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            h = _dense_layer(lp, h, cfg, cos, sin)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
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
def lm_prefill(params, tokens: torch.Tensor, cfg: LMConfig,
               window: Optional[int] = None):
    """Prefill: last-position logits (B, 1, vocab) and the KV caches
    ``{"dense": (k, v)}``, each (n_layers, B, S, n_kv, hd) in
    ``cfg.dtype``."""
    dt = cfg.dtype
    S = tokens.shape[1]
    cos, sin = rope_freqs(cfg.hd, S, cfg.rope_theta, dtype=dt,
                          device=tokens.device)
    h = _embed(params, tokens, cfg)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        h2 = rmsnorm_apply(lp["ln1"], h)
        att, (k, v) = prefill_attention(lp["attn"], h2, cfg.n_heads,
                                        cfg.n_kv, cfg.hd, cos, sin,
                                        window=window)
        h = _dense_ffn(lp, h + att)
        ks.append(k)
        vs.append(v)
    h = rmsnorm_apply(params["ln_f"], h)
    logits = h[:, -1:] @ params["head"].to(dt)
    return logits, {"dense": (torch.stack(ks), torch.stack(vs))}


def lm_decode_step(params, token: torch.Tensor, kv_caches, cache_len: int,
                   cfg: LMConfig, max_seq: int, attn: str = "kernel"):
    """One decode step.  token: (B, 1); cache_len: the new token's
    position.

    kv_caches mirror ``lm_prefill``'s output, padded on the sequence axis
    to ``max_seq``.  The new token's KV is written into them **in place**
    (the reference's caller donates its caches); returns (logits (B, 1,
    vocab), the same cache tree).  ``attn``: ``"kernel"`` (the flash-decode
    kernel, one launch per layer on the card) or ``"plain"``.
    """
    dt = cfg.dtype
    cos, sin = rope_freqs(cfg.hd, max_seq + 1, cfg.rope_theta, dtype=dt,
                          device=token.device)
    h = _embed(params, token, cfg)
    k_stack, v_stack = kv_caches["dense"]
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        h2 = rmsnorm_apply(lp["ln1"], h)
        att, _ = decode_attention(lp["attn"], h2, (k_stack[i], v_stack[i]),
                                  cache_len, cfg.n_heads, cfg.n_kv, cfg.hd,
                                  cos, sin, attn=attn)
        h = _dense_ffn(lp, h + att)
    h = rmsnorm_apply(params["ln_f"], h)
    return h @ params["head"].to(dt), kv_caches


def make_kv_caches(cfg: LMConfig, batch: int, max_seq: int, device="cuda"):
    """Zero KV caches in ``cfg.dtype``, in the structure ``lm_decode_step``
    walks: ``{"dense": (k, v)}``, each (n_layers, batch, max_seq, n_kv,
    hd)."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv, cfg.hd)
    return {"dense": (torch.zeros(shape, dtype=cfg.dtype, device=dev),
                      torch.zeros(shape, dtype=cfg.dtype, device=dev))}
