"""``paddle.incubate.nn.functional``, the port of the fused-op surface of
``paddle_tpu/incubate/nn_functional.py:23-433``: the same signatures,
casts by the same op names under ``amp.auto_cast``, on the port's kernels
where the JAX package leaves the fusion to XLA (upstream Paddle backs
these with CUDA kernels of its own, ``paddle/phi/kernels/fusion/``):

* ``fused_rms_norm`` / ``fused_layer_norm``: the fused norm kernel
  (``ops/fused_norm.py``) in its fused order: the pre-norm bias and
  residual add, then the statistics in fp32, the weight and bias applied
  in fp32 and one rounding to x's dtype; ``(out, residual_out)`` when a
  residual is given;
* ``fused_rotary_position_embedding``: the RoPE kernel
  (``ops/rope.py``), q, k and v in one launch, each pair turned in fp32
  and rounded once (the JAX package rounds each product in the tensors'
  dtype);
* ``swiglu``: the SwiGLU kernel (``ops/swiglu.py``), silu rounded once and
  the product once;
* ``fused_dropout_add`` and ``fused_bias_dropout_residual_layer_norm``:
  the dropout kernel (``ops/dropout.py``; the add in it, or in the layer
  norm's kernel), its seed drawn from ``generator=`` (a ``DropoutRNG`` or
  a ``torch.Generator``, as the port's ``dropout``; the JAX package draws
  from its global key, so the masks differ by design);
* ``fused_linear``, ``fused_matmul_bias`` and ``fused_linear_activation``:
  the product in ``torch.matmul``, the bias add and activation in the
  epilogue kernel (``ops/bias_act.py``; ``"gelu"`` is ``jax.nn.gelu``'s
  default tanh form there);
* ``fused_feedforward`` and ``fused_multi_head_attention``: the fused
  encoder blocks on those kernels, the flash kernels behind the
  attention and the norm kernel taking the post-norm residual add;
* ``memory_efficient_attention`` and
  ``variable_length_memory_efficient_attention``: the port's SDPA routing,
  and the flash kernels' segment-id variant for lengths without a mask;
* ``softmax_mask_fuse`` and ``softmax_mask_fuse_upper_triangle``: the
  masked-softmax kernel (``ops/softmax_mask.py``);
* ``masked_multihead_attention``: one decode step of attention over a
  cache. Its dense branch (a ``(2, B, H, max_len, D)`` tensor) is plain
  PyTorch, as it is jnp in the JAX package; its paged branch (a
  ``PagedDecodeCache``) runs the paged decode kernel
  (``ops/paged_attention.py``) and the in-place token write;
* ``identity_loss`` and ``blha_get_max_len``: plain PyTorch.

* ``fused_ec_moe``: the expert-choice MoE (``:455``, through the JAX
  package's ``_ec_moe_apply``, ``nn.py:215``): softmax of the gate logits
  in their dtype (rounded after each step, as XLA rounds a bf16 softmax),
  each expert's top ``max(T // E, 1)`` tokens (ties to the lower token),
  the tokens gathered by the dispatch kernel (``ops/moe.py``), the two
  grouped products in ``torch.bmm``, the per-expert bias and activation in
  the epilogue kernel with a bias period of C rows (``"gelu"`` is
  ``jax.nn.gelu``'s default tanh form), and the rows scaled by their gate
  and summed back into the tokens by the combine kernel in expert order,
  each add rounded to x's dtype as the JAX package's scatter-add rounds.

The CPU runs the kernels' plain versions.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..amp import cast_dtype, cast_inputs
from ..ops import nn_ops
from ..ops.bias_act import ActSpec, bias_act
from ..ops.flash_attention import flash_attention
from ..ops.moe import (CombineSpec, expert_choice_routes, moe_combine,
                       moe_dispatch)
from ..ops.fused_norm import NormSpec, fused_norm
from ..ops.paged_attention import PagedDecodeCache, paged_decode_attention
from ..ops.rope import rope
from ..ops.softmax_mask import softmax_mask
from ..ops.swiglu import swiglu as _swiglu
from .moe import top_k

__all__ = ["blha_get_max_len", "fused_bias_dropout_residual_layer_norm",
           "fused_dropout_add", "fused_feedforward", "fused_layer_norm",
           "fused_ec_moe", "fused_linear", "fused_linear_activation",
           "fused_matmul_bias",
           "fused_multi_head_attention", "fused_rms_norm",
           "fused_rotary_position_embedding", "identity_loss",
           "masked_multihead_attention", "memory_efficient_attention",
           "softmax_mask_fuse",
           "softmax_mask_fuse_upper_triangle", "swiglu",
           "variable_length_memory_efficient_attention"]


def _fused_norm(op: str, kind: str, x, norm_weight, norm_bias, epsilon,
                begin_norm_axis, bias, residual):
    naxes = x.dim() - begin_norm_axis % x.dim()
    xd = cast_dtype(op, x.dtype)
    add = None
    if bias is not None or residual is not None:
        add = xd
        for t in (bias, residual):
            if t is not None:
                add = torch.promote_types(add, cast_dtype(op, t.dtype))
    spec = NormSpec(
        kind, float(epsilon), norm=add or xd, out=xd, add=add,
        weight=None if norm_weight is None else cast_dtype(op,
                                                           norm_weight.dtype),
        bias=None if norm_bias is None else cast_dtype(op, norm_bias.dtype),
        fused=True, naxes=naxes)
    out, h = fused_norm(x, norm_weight, norm_bias, residual, bias, spec=spec)
    return (out, h) if residual is not None else out


def fused_rms_norm(x, norm_weight=None, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1, bias=None, residual=None,
                   quant_scale=-1, quant_round_type=0, quant_max_bound=0,
                   quant_min_bound=0, name=None):
    """RMSNorm with optional pre-norm bias/residual add. Returns
    (out, residual_out) when ``residual`` is given, else out. The quant
    arguments are accepted and ignored, as in the JAX package."""
    return _fused_norm("fused_rms_norm", "rms", x, norm_weight, norm_bias,
                       epsilon, begin_norm_axis, bias, residual)


def fused_layer_norm(x, norm_weight=None, norm_bias=None, epsilon=1e-5,
                     begin_norm_axis=-1, bias=None, residual=None,
                     quant_scale=-1, name=None):
    """LayerNorm with optional pre-norm bias/residual add, as
    :func:`fused_rms_norm`."""
    return _fused_norm("fused_layer_norm", "ln", x, norm_weight, norm_bias,
                       epsilon, begin_norm_axis, bias, residual)


def _rope_tables(s: int, d: int, base: float, neox: bool, device):
    inv = 1.0 / (base ** (np.arange(0, d, 2, dtype=np.float32) / d))
    freqs = np.outer(np.arange(s, dtype=np.float32), inv)
    emb = np.concatenate([freqs, freqs], axis=-1) if neox \
        else np.repeat(freqs, 2, axis=-1)
    return (torch.from_numpy(np.cos(emb)).to(device),
            torch.from_numpy(np.sin(emb)).to(device))


def _table(t: torch.Tensor) -> torch.Tensor:
    """(S, D) of a (S, D) or (1, S, 1, D) table."""
    return t if t.dim() == 2 else t.reshape(t.shape[1], t.shape[3])


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True,
                                    time_major=False, rotary_emb_base=10000.0,
                                    name=None):
    """Apply RoPE to q (and k, v when given), (B, S, H, D) (``time_major``:
    (S, B, H, D)). ``sin``/``cos``: (1, S, 1, D) or (S, D); generated from
    ``rotary_emb_base`` when omitted. Returns ``(q, k, v)``, None where a
    tensor was not given."""
    given = [t for t in (q, k, v) if t is not None]
    if time_major:
        given = [t.transpose(0, 1) for t in given]
    s, d = given[0].shape[1], given[0].shape[3]
    if cos is None or sin is None:
        cos, sin = _rope_tables(s, d, rotary_emb_base,
                                use_neox_rotary_style, given[0].device)
    cos, sin = _table(cos), _table(sin)
    dt = cast_dtype("fused_rope", given[0].dtype)
    outs = list(rope(given, cos, sin, positions=position_ids,
                     neox=use_neox_rotary_style, dtype=dt, table_dtype=dt))
    if time_major:
        outs = [t.transpose(0, 1) for t in outs]
    return tuple(outs.pop(0) if t is not None else None for t in (q, k, v))


def swiglu(x, y=None, name=None):
    """silu(x) * y; when y is None, x is split in half on the last axis."""
    x, y = cast_inputs("swiglu", x, y)
    return _swiglu(x, y)


def _dropout(x, p: float, training: bool, mode: str, generator,
             residual=None):
    """paddle's dropout modes on the dropout kernel, then ``+ residual``
    (cast as the ``add`` op) in the same launch: ``upscale_in_train``
    scales kept values by ``1 / (1 - p)``, ``downscale_in_infer`` keeps
    them as they are; outside training both are the identity (the JAX
    package's)."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"mode must be 'upscale_in_train' or "
                         f"'downscale_in_infer', got {mode!r}")
    return nn_ops.dropout(x, p, training, generator=generator,
                          residual=residual,
                          upscale=mode == "upscale_in_train")


def fused_dropout_add(x, y, p=0.5, training=True, mode="upscale_in_train",
                      name=None, *, generator=None):
    """dropout(x) + y in one launch of the dropout kernel, the seed drawn
    from ``generator`` (a ``DropoutRNG`` or a ``torch.Generator``)."""
    return _dropout(x, p, training, mode, generator, residual=y)


def fused_bias_dropout_residual_layer_norm(x, residual, bias=None,
                                           ln_scale=None, ln_bias=None,
                                           dropout_rate=0.5, ln_epsilon=1e-5,
                                           training=True, name=None, *,
                                           generator=None):
    """layer_norm(residual + dropout(x + bias)): the residual add runs in
    the layer norm's kernel."""
    h = x if bias is None else nn_ops.add(x, bias)
    h = nn_ops.dropout(h, dropout_rate, training, generator=generator)
    out, _ = nn_ops.layer_norm(h, h.shape[-1:], ln_scale, ln_bias,
                               ln_epsilon, residual)
    return out


# fused_linear_activation's names: jax.nn's activations, gelu's default
# being the tanh form
_LINEAR_ACTS = {"gelu": "gelu_tanh", "relu": "relu", "none": "none",
                "": "none"}


def _matmul_epilogue(op, x, w, bias, trans_x, trans_y, act="none"):
    """``act(x @ w + bias)`` cast as op ``op``: the product in
    ``torch.matmul``, the epilogue in the bias_act kernel (none without a
    bias or an activation)."""
    x, w, bias = cast_inputs(op, x, w, bias)
    if trans_x:
        x = x.transpose(-1, -2)
    if trans_y:
        w = w.transpose(-1, -2)
    y = torch.matmul(x, w)
    if bias is None and act == "none":
        return y
    h = y.dtype if bias is None else torch.promote_types(y.dtype, bias.dtype)
    return bias_act(y, bias, ActSpec(act, h, h))


def fused_linear(x, weight, bias=None, transpose_weight=False, name=None):
    """x @ weight (+ bias); ``transpose_weight``: weight is (out, in)."""
    return _matmul_epilogue("fused_linear", x, weight, bias, False,
                            transpose_weight)


def fused_matmul_bias(x, y, bias=None, transpose_x=False, transpose_y=False,
                      name=None):
    """matmul + bias epilogue (the cublasLt-fused op upstream)."""
    return _matmul_epilogue("fused_matmul_bias", x, y, bias, transpose_x,
                            transpose_y)


def fused_linear_activation(x, y, bias=None, trans_x=False, trans_y=False,
                            activation="gelu", name=None):
    """act(x @ y + bias), act one of ``gelu`` (the tanh form, as
    ``jax.nn.gelu``), ``relu``, ``none``."""
    return _matmul_epilogue("fused_linear_activation", x, y, bias, trans_x,
                            trans_y, _LINEAR_ACTS[activation])


def _layer_norm(x, weight, bias, epsilon, residual=None):
    return nn_ops.layer_norm(x, x.shape[-1], weight, bias, epsilon, residual)


def _residual_tail(out, residual, p, training, mode, generator,
                   add_residual, pre_layer_norm, ln_scale, ln_bias,
                   ln_epsilon):
    """dropout, the residual add and (post-norm) the layer norm of a fused
    block: pre-norm adds in the dropout kernel, post-norm in the norm's."""
    if pre_layer_norm or not add_residual:
        out = _dropout(out, p, training, mode, generator,
                       residual=residual if add_residual else None)
        return out if pre_layer_norm else _layer_norm(out, ln_scale,
                                                      ln_bias, ln_epsilon)
    out = _dropout(out, p, training, mode, generator)
    return _layer_norm(out, ln_scale, ln_bias, ln_epsilon, residual)[0]


def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation="relu",
                      ln1_epsilon=1e-5, ln2_epsilon=1e-5,
                      pre_layer_norm=False, training=True,
                      mode="upscale_in_train", ring_id=-1, add_residual=True,
                      name=None, *, generator=None):
    """The reference's fused FFN: LN + linear + act + dropout + linear +
    dropout + residual (+ LN). ``activation``: ``relu`` or ``gelu`` (the
    erf form, paddle's ``F.gelu``). Dropout seeds come from
    ``generator``."""
    if activation not in ("relu", "gelu"):
        raise ValueError(f"activation must be 'relu' or 'gelu', got "
                         f"{activation!r}")
    residual = x
    if pre_layer_norm:
        x = _layer_norm(x, ln1_scale, ln1_bias, ln1_epsilon)
    x, w1, b1 = cast_inputs("fused_linear", x, linear1_weight, linear1_bias)
    y = torch.matmul(x, w1)
    h = y.dtype if b1 is None else torch.promote_types(y.dtype, b1.dtype)
    out = bias_act(y, b1, nn_ops.act_spec(activation, h))
    out = _dropout(out, dropout1_rate, training, mode, generator)
    out = fused_linear(out, linear2_weight, linear2_bias)
    return _residual_tail(out, residual, dropout2_rate, training, mode,
                          generator, add_residual, pre_layer_norm, ln2_scale,
                          ln2_bias, ln2_epsilon)


def fused_multi_head_attention(x, qkv_weight, linear_weight,
                               pre_layer_norm=False, pre_ln_scale=None,
                               pre_ln_bias=None, ln_scale=None, ln_bias=None,
                               pre_ln_epsilon=1e-5, qkv_bias=None,
                               linear_bias=None, cache_kv=None,
                               attn_mask=None, dropout_rate=0.0,
                               attn_dropout_rate=0.0, ln_epsilon=1e-5,
                               training=True, mode="upscale_in_train",
                               ring_id=-1, add_residual=True, num_heads=None,
                               name=None, *, generator=None):
    """The reference's fused attention block: (pre-LN) + qkv projection
    (``qkv_weight`` (3, H, D, embed), ``qkv_bias`` (3, H, D)) + attention
    (the port's SDPA routing: the flash kernels without a mask, attention
    dropout in them) + out projection + dropout + residual (+ post-LN).
    ``cache_kv`` (2, B, H, L, D) is prepended to k and v and ``(out,
    cache_out)`` returned. Dropout seeds come from ``generator``."""
    residual = x
    if pre_layer_norm:
        x = _layer_norm(x, pre_ln_scale, pre_ln_bias, pre_ln_epsilon)
    b, s, h = x.shape
    nh, hd = qkv_weight.shape[1], qkv_weight.shape[2]
    xa, w = cast_inputs("fused_qkv", x, qkv_weight)
    qkv = torch.einsum("bsh,tndh->tbsnd", xa, w)
    if qkv_bias is not None:
        qkv = nn_ops.add(qkv, qkv_bias.reshape(3, 1, 1, nh, hd))
    q, k, v = qkv[0], qkv[1], qkv[2]
    cache_out = None
    if cache_kv is not None:
        k = torch.cat([cache_kv[0].transpose(1, 2), k], dim=1)
        v = torch.cat([cache_kv[1].transpose(1, 2), v], dim=1)
        cache_out = torch.stack([k.transpose(1, 2), v.transpose(1, 2)])
    out = nn_ops.scaled_dot_product_attention(
        q, k, v, attn_mask=attn_mask,
        dropout_p=attn_dropout_rate if training else 0.0, training=training,
        generator=generator)
    out = out.reshape(b, s, h)
    oa, lw = cast_inputs("fused_out_proj", out, linear_weight)
    out = torch.matmul(oa, lw)
    if linear_bias is not None:
        out = nn_ops.add(out, linear_bias)
    out = _residual_tail(out, residual, dropout_rate, training, mode,
                         generator, add_residual, pre_layer_norm, ln_scale,
                         ln_bias, ln_epsilon)
    return out if cache_out is None else (out, cache_out)


def memory_efficient_attention(query, key, value, attn_bias=None, p=0.0,
                               scale=None, training=True, name=None, *,
                               generator=None):
    """Memory-efficient attention over ``(B, L, H, D)``: the port's SDPA
    (the flash kernels when there is no bias). A custom ``scale`` is folded
    into the query, so the net scaling equals ``scale``."""
    if scale is not None:
        query = query * (float(scale) * (query.shape[-1] ** 0.5))
    return nn_ops.scaled_dot_product_attention(
        query, key, value, attn_mask=attn_bias,
        dropout_p=p if training else 0.0, is_causal=False,
        generator=generator)


def variable_length_memory_efficient_attention(query, key, value, seq_lens,
                                               kv_seq_lens, mask=None,
                                               scale=None, causal=False,
                                               pre_cache_length=0, name=None):
    """Attention over a padded batch, ``(B, H, S, D)`` q/k/v and per-row
    lengths ``seq_lens`` / ``kv_seq_lens`` ((B,) or (B, 1)); query rows at
    or past ``seq_lens`` give 0, causal is bottom-right over the padded
    lengths. Without ``mask``, at D = 64 or 128 in fp32 or bf16, it runs the
    flash kernels' segment-id variant (keys at or past ``kv_seq_lens`` take
    id 0, the queries id 1; a row that sees no key gives 0, where the JAX
    package's dense softmax gives the mean of V). Otherwise the plain
    composition the JAX package computes: ``-1e30`` outside the lengths and
    the causal triangle, the mask added, fp32 softmax."""
    query, key, value, mask = cast_inputs("varlen_mea", query, key, value,
                                          mask)
    b, _, sq, d = query.shape
    sk = key.shape[2]
    sl = seq_lens.reshape(-1, 1).to(query.device)
    kvl = kv_seq_lens.reshape(-1, 1).to(query.device)
    qvalid = torch.arange(sq, device=query.device)[None, :] < sl
    if mask is None and d in (64, 128) and \
            query.dtype in (torch.float32, torch.bfloat16, torch.float16):
        kv_ids = (torch.arange(sk, device=query.device)[None, :] < kvl)
        q_ids = torch.ones(b, sq, dtype=torch.int32, device=query.device)
        out = flash_attention(query.transpose(1, 2), key.transpose(1, 2),
                              value.transpose(1, 2), causal=causal,
                              q_segment_ids=q_ids,
                              kv_segment_ids=kv_ids.to(torch.int32),
                              sm_scale=scale).transpose(1, 2)
    else:
        sc = scale if scale is not None else 1.0 / (d ** 0.5)
        logits = torch.einsum("bhqd,bhkd->bhqk", query, key) * sc
        kvalid = torch.arange(sk, device=query.device)[None, :] < kvl
        logits = torch.where(kvalid[:, None, None, :], logits, -1e30)
        if causal:
            keep = torch.ones(sq, sk, dtype=torch.bool,
                              device=query.device).tril(sk - sq)
            logits = torch.where(keep, logits, -1e30)
        if mask is not None:
            logits = logits + mask
        probs = torch.softmax(logits.float(), dim=-1)
        out = torch.einsum("bhqk,bhkd->bhqd", probs.to(query.dtype), value)
    return out * qvalid[:, None, :, None].to(out.dtype)


def softmax_mask_fuse(x, mask, name=None):
    """softmax(x + mask) over the last axis, fp32 statistics, in x's dtype
    (the masked-softmax kernel)."""
    x, mask = cast_inputs("softmax_mask_fuse", x, mask)
    return softmax_mask(x, mask)


def softmax_mask_fuse_upper_triangle(x, name=None):
    """Causal softmax over the last axis: keys above the bottom-right
    diagonal masked to -1e30 (the masked-softmax kernel)."""
    (x,) = cast_inputs("softmax_mask_fuse_upper_triangle", x)
    return softmax_mask(x, causal=True)


def identity_loss(x, reduction="none", name=None):
    """Pass-through loss head: ``sum`` (0), ``mean`` (1) or ``none`` (2)."""
    (x,) = cast_inputs("identity_loss", x)
    red = {0: "sum", 1: "mean", 2: "none"}.get(reduction, reduction)
    if red == "sum":
        return torch.sum(x)
    if red == "mean":
        return torch.mean(x)
    return x


def blha_get_max_len(seq_lens_encoder, seq_lens_decoder, batch_size=None,
                     name=None):
    """``(max(seq_lens_encoder), max(seq_lens_decoder))`` as 0-d tensors."""
    return torch.max(seq_lens_encoder), torch.max(seq_lens_decoder)


def _softmax_rounded(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis in x's dtype, each step rounded to it
    (the max subtracted, exp, the fp32 sum, the quotient), as XLA computes
    ``jax.nn.softmax`` of a bf16 array; fp32 is the plain softmax."""
    def rnd(t):
        return t.to(x.dtype).float()
    v = x.float()
    e = rnd(torch.exp(rnd(v - v.amax(-1, keepdim=True))))
    return rnd(e / rnd(e.sum(-1, keepdim=True))).to(x.dtype)


def _ec_moe_apply(x, gate, w0, b0, w1, b1, act: str):
    """The expert-choice MoE both ``FusedEcMoe`` and :func:`fused_ec_moe`
    run (see the module docstring)."""
    x, gate, w0, b0, w1, b1 = cast_inputs("fused_ec_moe", x, gate, w0, b0,
                                          w1, b1)
    b, s, h = x.shape
    t = b * s
    e = w0.shape[0]
    cap = max(t // e, 1)
    probs = _softmax_rounded(gate.reshape(t, -1))
    weight, sel = top_k(probs.t(), cap)                    # (E, C)
    routes, perm = expert_choice_routes(sel, t)
    tokens = x.reshape(t, h)
    picked = moe_dispatch(tokens, routes, acc_dtype=x.dtype)
    dt = torch.promote_types(x.dtype, w0.dtype)
    hid = torch.bmm(picked.view(e, cap, h).to(dt), w0.to(dt))
    hd = torch.promote_types(hid.dtype, b0.dtype)
    hid = bias_act(hid, b0, ActSpec("gelu_tanh" if act == "gelu" else "relu",
                                    hd, hd), period=cap)
    dt = torch.promote_types(hid.dtype, w1.dtype)
    y = torch.bmm(hid.to(dt), w1.to(dt))
    yd = torch.promote_types(y.dtype, b1.dtype)
    spec = CombineSpec(yd, torch.promote_types(yd, weight.dtype), x.dtype,
                       x.dtype)
    out = moe_combine(y.view(e * cap, h), weight.reshape(-1)[perm].float(),
                      routes, bias=b1.reshape(e, h), spec=spec)
    return out.view(b, s, h)


def fused_ec_moe(x, gate, bmm0_weight, bmm0_bias, bmm1_weight, bmm1_bias,
                 act_type="gelu", name=None):
    """Expert-choice MoE: ``x`` ``(B, S, H)``, gate LOGITS ``(B, S, E)``,
    weights ``(E, H, I)``, ``(E, 1, I)``, ``(E, I, H)``, ``(E, 1, H)``;
    ``act_type`` ``"gelu"`` (the tanh form) or ``"relu"``."""
    if act_type not in ("gelu", "relu"):
        raise ValueError("act_type must be gelu or relu")
    return _ec_moe_apply(x, gate, bmm0_weight, bmm0_bias, bmm1_weight,
                         bmm1_bias, act_type)


def _paged_mmha(x, cache: PagedDecodeCache):
    """The fused qkv ``(B, 3 * H * D)`` of one token over a paged view
    (q heads == kv heads): the paged decode kernel for the view's layer,
    then position ``t``'s K/V written into its page, in place. Returns
    ``(out (B, H * D), cache)``."""
    nh, hd = cache.pool.shape[3], cache.pool.shape[5]
    b = x.shape[0]
    qkv = x.reshape(b, 3, nh, hd)
    out, cache = paged_decode_attention(qkv[:, 0], qkv[:, 1], qkv[:, 2],
                                        cache)
    return out.reshape(b, nh * hd), cache


def masked_multihead_attention(x, bias=None, src_mask=None,
                               sequence_lengths=None, rotary_tensor=None,
                               beam_cache_offset=None, cache_kv=None,
                               out_shift=None, out_smooth=None, seq_len=1,
                               rotary_emb_dims=0, use_neox_rotary_style=False,
                               compute_dtype="default", out_scale=-1,
                               quant_round_type=1, quant_max_bound=127.0,
                               quant_min_bound=-127.0, name=None):
    """Single-token decode attention over a pre-allocated cache.

    ``x`` is the fused qkv ``(B, 3 * H * D)`` of one new token (``bias``
    added first). ``cache_kv`` is either

    * a tensor ``(2, B, H, max_len, D)``: slot ``t = sequence_lengths``
      (``(B,)`` or a scalar; zeros when absent) is overwritten in place
      with the token's K/V, and attention spans positions ``<= t`` (the
      rest ``-1e30``), plus the optional additive ``src_mask`` ``(B, 1|H,
      1, Lm)`` zero-padded to ``max_len``; the attention is taken in fp32
      and rounded once to ``x``'s dtype, as the paged kernel does. The
      JAX package takes it in ``x``'s dtype: the two agree in fp32 and
      differ by a rounding of the intermediates in bf16, so a bf16
      reference loop over this branch rounds otherwise than the JAX
      bench's (torch's own bf16 products land as far from JAX's on the
      CPU). A ``t >= max_len`` raises
      ``ValueError``; the check reads ``t`` on the host, so it is skipped
      while a CUDA graph captures. Plain PyTorch;
    * a ``PagedDecodeCache`` with its layer set: the paged decode kernel
      (the plain version for CPU tensors) at the view's ``t``, then the
      token write into its page. ``src_mask`` raises
      ``NotImplementedError``.

    Returns ``(out (B, H * D), cache)``, the cache written in place. The
    rotary, beam and quantisation knobs raise ``NotImplementedError``, as
    in the JAX package."""
    for unsupported, label in ((rotary_tensor, "rotary_tensor"),
                               (beam_cache_offset, "beam_cache_offset"),
                               (out_shift, "out_shift"),
                               (out_smooth, "out_smooth")):
        if unsupported is not None:
            raise NotImplementedError(
                f"masked_multihead_attention: {label} is not supported "
                "(quant/beam serving knobs)")
    if cache_kv is None:
        raise ValueError("masked_multihead_attention requires cache_kv")
    if bias is not None:
        x = x + bias
    if isinstance(cache_kv, PagedDecodeCache):
        if src_mask is not None:
            raise NotImplementedError(
                "masked_multihead_attention: src_mask is not supported on "
                "the paged path (span masking to <= t is built in; use a "
                "dense cache for additive masks)")
        return _paged_mmha(x, cache_kv)
    _, b, nh, max_len, hd = cache_kv.shape
    if sequence_lengths is None:
        t = torch.zeros(b, dtype=torch.int64, device=x.device)
    else:
        t = torch.as_tensor(sequence_lengths, device=x.device)
        t = t.to(torch.int64).reshape(-1).expand(b)
    capturing = torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()
    if not capturing and bool((t >= max_len).any()):
        raise ValueError(
            f"masked_multihead_attention: sequence length >= cache max_len "
            f"{max_len}: the write would be dropped")
    qkv = x.reshape(b, 3, nh, hd)
    rows = torch.arange(b, device=x.device)
    # overwrite slot t, never add to it: a retried step replaces
    cache_kv[0, rows, :, t] = qkv[:, 1].to(cache_kv.dtype)
    cache_kv[1, rows, :, t] = qkv[:, 2].to(cache_kv.dtype)
    # in fp32 (at least), rounded once: the paged kernel's precision
    dt = torch.promote_types(torch.promote_types(x.dtype, cache_kv.dtype),
                             torch.float32)
    logits = torch.einsum("bhd,bhld->bhl", qkv[:, 0].to(dt),
                          cache_kv[0].to(dt)) / (hd ** 0.5)
    span = torch.arange(max_len, device=x.device)[None, :] <= t[:, None]
    logits = torch.where(span[:, None, :], logits, -1e30)
    if src_mask is not None:
        m = src_mask.reshape(b, -1, src_mask.shape[-1])[:, :, :max_len]
        logits = logits + torch.nn.functional.pad(
            m, (0, max_len - m.shape[-1]))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhl,bhld->bhd", p, cache_kv[1].to(dt))
    return out.reshape(b, nh * hd).to(x.dtype), cache_kv
