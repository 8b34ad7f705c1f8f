"""Dense decoder-only transformer (GPT2 / Qwen2.5 / Qwen3 / LLaMA flags).

The forward of the JAX package's ``models/transformer.py`` for the dense
decoder. Params are a plain dict of tensors with the JAX package's key
names::

    params = {
      "wte": [V, E] tensor | QTensor[E, V] (head layout when quantized),
      "wpe": [maxpos, E]                  (GPT2 learned positions),
      "layers": [ { "ln1", ("ln1_b"), "q","k","v","o", ("q_b","k_b","v_b","o_b"),
                    ("qn","kn"), "ln2", ("ln2_b"),
                    "gate","up","down" | "fc","fc_b","proj","proj_b" }, ... ],
      "ln_f", ("ln_f_b"), ("head": [E, V]),
    }

MoE layers (all layers, or ``card.moe_layers``) hold ``router``,
``egate``, ``eup``, ``edown`` in place of the dense FFN (``models/moe.py``);
MLA cards (``card.attn == "mla"``) hold the latent projections of
``models/mla.py`` in place of ``q``, ``k``, ``v``.

The rest of the zoo: a MAMBA card's layers hold ``ln1`` and the selective-
SSM leaves of ``models/mamba.py``; GAU layers (``card.gau_layers``) hold
``ln1`` and ``models/gau.py``'s leaves in place of the attention and FFN;
BROWN layers (``card.brown_layers``) ``models/brown.py``'s learned table in
place of the attention, with the FFN kept; a GUPPY card's FFN is
``guppy_gain`` over sampled wte rows (``models/guppy.py``, injected as
``guppy_rows`` by ``model_forward``); a LLAMA_VAE card's embedding goes
through the ``evae`` latent stack (``models/embed_vae.py``).

Any weight-matrix leaf may be a QTensor; ``ops/matmul`` dispatches.

Under a ``TPPolicy`` (``ops/tracectx.py``) each rank runs this code on its
shard of the params with a card of its local head and FFN counts
(``parallel/sharding.local_card``): the column-parallel inputs pass
``comm.copy_to``, the row-parallel outputs (``o``, ``down``, ``proj``) are
summed over the group in f32 and rounded once, a vocab-sharded embedding
sums its ranks' rows, and a vocab-sharded head gathers its logits. The
zoo's replicated layers (Mamba, BROWN's table, Guppy's FFN) run whole on
every rank; MLA and GAU compute their replicated projections whole and
keep the rank's heads (``models/mla.py``, ``models/gau.py``).
Training differentiates ``model_forward`` with autograd (bf16 leaves with
``requires_grad``); ``remat`` recomputes blocks in the backward through
``torch.utils.checkpoint``.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from koifish_tpu_torch.config import ModelCard
from koifish_tpu_torch.dtypes import QFormat
from koifish_tpu_torch.models.brown import brown_attn, init_brown_layer
from koifish_tpu_torch.models.embed_vae import decode, encode, init_embed_vae
from koifish_tpu_torch.models.gau import gau_block, init_gau_layer
from koifish_tpu_torch.models.guppy import guppy_ffn, inject_rows
from koifish_tpu_torch.models.mamba import (init_mamba_layer, mamba_block,
                                            mamba_in, mamba_out,
                                            selective_scan)
from koifish_tpu_torch.models.mla import init_mla_layer, mla_qkv
from koifish_tpu_torch.models.moe import init_moe_layer, moe_ffn
from koifish_tpu_torch.ops.attention import causal_attention
from koifish_tpu_torch.ops.matmul import linear, qmatmul
from koifish_tpu_torch.ops.norms import layernorm, rmsnorm
from koifish_tpu_torch.ops.rope import apply_rope, rope_freqs
from koifish_tpu_torch.ops.tracectx import (current_int8, current_sp,
                                            current_tp, int8_scope, sp_scope,
                                            tp_scope)
from koifish_tpu_torch.parallel import comm
from koifish_tpu_torch.quant.packing import unpack_codes
from koifish_tpu_torch.quant.qtensor import QTensor, codebook_for
from koifish_tpu_torch.utils.device import resolve_device

Params = Dict[str, Any]


def _is_moe_layer(card: ModelCard, li: int) -> bool:
    return card.n_experts > 0 and (not card.moe_layers
                                   or li in card.moe_layers)


def init_params(card: ModelCard, generator: Optional[torch.Generator] = None,
                dtype=torch.bfloat16, device=None, seed: int = 0) -> Params:
    """GPT2-style init: normal(0.02), residual-out projections scaled by
    1/sqrt(2L). Random weights come from ``generator`` (a torch.Generator on
    ``device``), or from one seeded with ``seed``."""
    dev = resolve_device(device)
    gen = generator
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    E, Hq, Hkv, D, F, L = (card.n_embd, card.n_head, card.n_kv_head,
                           card.head_dim, card.n_ffn, card.n_layer)
    std = 0.02
    res_std = std / math.sqrt(2 * L)

    def nrm(shape, s=std):
        w = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (w * s).to(dtype)

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=dev)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=dev)

    params: Params = {"wte": nrm((card.vocab_size, E)), "ln_f": ones(E)}
    if card.pos_embed == "learned":
        params["wpe"] = nrm((card.max_pos, E))
    if card.norm == "layernorm":
        params["ln_f_b"] = zeros(E)
    if not card.tie_embeddings:
        params["head"] = nrm((E, card.vocab_size))

    if card.arch == "LLAMA_VAE":
        # the token embedding factored through the EmbedVAE latent stack
        # (reference LLAMA_VAE, gLLM.hpp:163-182; latent_dim default 192)
        params["evae"] = init_embed_vae(
            gen, [E] + list(card.token_embeds or (192,)), dtype=dtype,
            device=dev)

    layers: List[Params] = []
    for li in range(L):
        if card.arch == "MAMBA":
            lp = {"ln1": ones(E)}
            lp.update(init_mamba_layer(card, gen, dtype, dev))
            layers.append(lp)
            continue
        if li in card.gau_layers:
            # a GAU block replaces the whole (attention, FFN) pair
            lp = {"ln1": ones(E)}
            lp.update(init_gau_layer(card, gen, dtype, dev))
            layers.append(lp)
            continue
        if li in card.brown_layers:
            # BROWN replaces the attention; the FFN stays
            lp = {"ln1": ones(E), "ln2": ones(E)}
            lp.update(init_brown_layer(card, gen, dtype, dev))
        elif card.attn == "mla":
            lp = {"ln1": ones(E), "ln2": ones(E)}
            lp.update(init_mla_layer(card, gen, dtype, dev))
        else:
            lp = {"ln1": ones(E), "q": nrm((E, Hq * D)),
                  "k": nrm((E, Hkv * D)), "v": nrm((E, Hkv * D)),
                  "o": nrm((Hq * D, E), res_std), "ln2": ones(E)}
        if card.norm == "layernorm":
            lp["ln1_b"] = zeros(E)
            lp["ln2_b"] = zeros(E)
        if card.qkv_bias and "brown_w" not in lp:
            lp["q_b"] = zeros(Hq * D)
            lp["k_b"] = zeros(Hkv * D)
            lp["v_b"] = zeros(Hkv * D)
        if card.qk_norm and "brown_w" not in lp:
            lp["qn"] = ones(D)
            lp["kn"] = ones(D)
        if _is_moe_layer(card, li):
            lp.update(init_moe_layer(card, gen, dtype, dev))
        elif card.arch == "GUPPY":
            # the vocab-memory FFN: sampled wte rows (models/guppy.py),
            # only a gain is learned here
            lp["guppy_gain"] = torch.ones((), dtype=dtype, device=dev)
        elif card.act == "swiglu":
            lp["gate"] = nrm((E, F))
            lp["up"] = nrm((E, F))
            lp["down"] = nrm((F, E), res_std)
        else:  # gelu MLP (GPT2)
            lp["fc"] = nrm((E, F))
            lp["fc_b"] = zeros(F)
            lp["proj"] = nrm((F, E), res_std)
            lp["proj_b"] = zeros(E)
        if card.norm == "layernorm" and card.act != "swiglu":
            lp["o_b"] = zeros(E)
        layers.append(lp)
    params["layers"] = layers
    return params


def _vocab_rows(w) -> int:
    """The vocab entries an embedding leaf holds ([V, E], or [E, V] head
    layout when quantized)."""
    return w.shape[-1] if isinstance(w, QTensor) else w.shape[0]


def _tp_vocab(w):
    """The TP policy when ``w`` holds a vocab shard, else None."""
    tp = current_tp()
    return tp if tp is not None and _vocab_rows(w) != tp.vocab else None


def gather_embed(wte, tokens: torch.Tensor) -> torch.Tensor:
    """Token-embedding lookup. Plain [V, E] row gather; quantized embeddings
    are stored in head layout [E, V] and dequantized per column. A vocab
    shard under TP looks up the ids it holds, zeros the others, and the
    ranks' rows are summed."""
    tp = _tp_vocab(wte)
    if tp is not None:
        n = _vocab_rows(wte)
        local = tokens.long() - tp.rank * n
        inside = (local >= 0) & (local < n)
        e = _gather_rows(wte, torch.where(inside, local, 0))
        e = e * inside[..., None].to(e.dtype)
        return comm.reduce_from(e, tp.group).to(torch.bfloat16)
    return _gather_rows(wte, tokens)


def _gather_rows(wte, tokens: torch.Tensor) -> torch.Tensor:
    if isinstance(wte, QTensor):
        ids = tokens.reshape(-1).long()
        cols = wte.codes[:, ids]                          # [E_packed, N]
        raw = unpack_codes(cols, wte.fmt, wte.shape[0], group=wte.group)
        if wte.fmt is QFormat.INT8:
            vals = raw.to(torch.float32)
        elif wte.fmt.is_codebook:
            vals = codebook_for(wte.fmt, raw.device)[raw.long()]
        else:
            vals = raw.to(torch.float32) - float(1 << (wte.fmt.bits - 1))
        s = wte.scales[:, ids].to(torch.float32)          # [E/g, N]
        vals = vals.reshape(-1, wte.group, vals.shape[-1]) * s[:, None, :]
        emb = vals.reshape(wte.shape[0], -1).T            # [N, E]
        return emb.reshape(*tokens.shape, -1).to(torch.bfloat16)
    return wte[tokens.long()]


def embed_tokens(card: ModelCard, params: Params, tokens: torch.Tensor
                 ) -> torch.Tensor:
    """The token embedding, through the LLAMA_VAE latent stack where the
    params hold one: the training forward's and the prefill's entry."""
    x = gather_embed(params["wte"], tokens)
    if "evae" in params:
        x = decode(params["evae"], encode(params["evae"], x))
    return x


def _norm(card: ModelCard, x, w, b=None, residual=None):
    if card.norm == "rmsnorm":
        return rmsnorm(x, w, eps=card.norm_eps, residual=residual)
    return layernorm(x, w, b, eps=card.norm_eps, residual=residual)


#: row-parallel projections: their input features are sharded under TP
ROW_KEYS = ("o", "down", "proj")


def _tp_in(x: torch.Tensor) -> torch.Tensor:
    """A column-parallel region's input: identity, the gradient summed over
    the TP group."""
    tp = current_tp()
    return x if tp is None else comm.copy_to(x, tp.group)


def _linear_l(x: torch.Tensor, lp: Params, key: str) -> torch.Tensor:
    """Linear through ``lp[key]`` + optional LoRA adapter ``lp[key+"_lora"]``.
    Under TP a row-parallel product's partials come out in f32 (the
    kernels' f32 output; a bf16 weight's product in f32), are summed over
    the group, its bias added once and the sum rounded once; a row-parallel
    weight left whole (``parallel/sharding.py``) takes the gathered
    input."""
    tp = current_tp()
    if tp is not None and key in ROW_KEYS:
        if key + "_lora" in lp:
            raise NotImplementedError("LoRA adapters under tensor "
                                      "parallelism are not ported")
        w = lp[key]
        if w.shape[0] != x.shape[-1]:
            # a replicated weight (its K split would cut a quantization
            # group): gather the input and compute the whole product
            return linear(comm.gather_from(x, tp.group, -1), w,
                          lp.get(key + "_b"))
        y = comm.reduce_from(qmatmul(x, w, out_dtype=torch.float32),
                             tp.group)
        b = lp.get(key + "_b")
        if b is not None:
            y = y + b.to(torch.float32)
        return y.to(x.dtype)
    y = linear(x, lp[key], lp.get(key + "_b"))
    lora = lp.get(key + "_lora")
    if lora is not None:
        y = y + (x @ lora["a"].to(x.dtype)) @ lora["b"].to(x.dtype)
    return y


def qkv_project(card: ModelCard, lp: Params, x: torch.Tensor, cos, sin,
                positions) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x -> rotated q, k and v, shaped [B, T, H, D] (v's D is
    ``v_head_dim`` on an MLA card, which ropes at table ``positions``)."""
    if card.attn == "mla":
        return mla_qkv(card, lp, x, positions)
    B, T, _ = x.shape
    D = card.head_dim
    x = _tp_in(x)
    q = _linear_l(x, lp, "q").reshape(B, T, card.n_head, D)
    k = _linear_l(x, lp, "k").reshape(B, T, card.n_kv_head, D)
    v = _linear_l(x, lp, "v").reshape(B, T, card.n_kv_head, D)
    if card.qk_norm:  # per-head RMSNorm before RoPE (Qwen3)
        # shared by every head: under TP each rank's gradient is partial
        q = rmsnorm(q, _tp_in(lp["qn"]), eps=card.norm_eps)
        k = rmsnorm(k, _tp_in(lp["kn"]), eps=card.norm_eps)
    if card.pos_embed == "rope":
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)
    return q, k, v


def mlp(card: ModelCard, lp: Params, x: torch.Tensor) -> torch.Tensor:
    if "guppy_gain" in lp:
        # its sampled rows are whole on every rank under TP: a replicated
        # computation, whose input gradient is whole too
        return guppy_ffn(lp, x)
    x = _tp_in(x)
    if "router" in lp:
        return moe_ffn(card, lp, x)
    if card.act == "swiglu":
        g = _linear_l(x, lp, "gate")
        u = _linear_l(x, lp, "up")
        h = torch.nn.functional.silu(g.to(torch.float32)).to(x.dtype) * u
        return _linear_l(h, lp, "down")
    h = _linear_l(x, lp, "fc")
    h = torch.nn.functional.gelu(h.to(torch.float32), approximate="tanh"
                                 ).to(x.dtype)
    return _linear_l(h, lp, "proj")


def layer_forward(card: ModelCard, lp: Params, x: torch.Tensor, cos, sin,
                  positions, window: int = 0) -> torch.Tensor:
    """One transformer block over a full sequence (prefill / forward)."""
    if card.arch == "MAMBA":
        return x + mamba_block(card, lp, _norm(card, x, lp["ln1"],
                                               lp.get("ln1_b")))
    if "upU" in lp:      # a GAU block: no separate FFN
        return gau_block(card, lp, x, cos, sin, positions)
    if "brown_w" in lp:  # BROWN learned attention, then the FFN
        x = brown_attn(card, lp, x, cos, sin, positions)
        h = _norm(card, x, lp["ln2"], lp.get("ln2_b"))
        return x + mlp(card, lp, h)
    h = _norm(card, x, lp["ln1"], lp.get("ln1_b"))
    q, k, v = qkv_project(card, lp, h, cos, sin, positions)
    a = causal_attention(q, k, v, window=window, causal=card.causal)
    B, T = x.shape[:2]
    x = x + _linear_l(a.reshape(B, T, -1), lp, "o")
    h = _norm(card, x, lp["ln2"], lp.get("ln2_b"))
    return x + mlp(card, lp, h)


def lm_head(card: ModelCard, params: Params, x: torch.Tensor,
            out_dtype=torch.float32) -> torch.Tensor:
    """Hidden states -> logits (tied or untied head). The tied bf16 head is
    a plain ``torch.matmul`` against ``wte.T``. A vocab-sharded head under
    TP computes its columns and gathers every rank's."""
    w = params["head"] if not card.tie_embeddings else params["wte"]
    tp = _tp_vocab(w)
    if tp is not None:
        x = comm.copy_to(x, tp.group)
    if not card.tie_embeddings or isinstance(w, QTensor):   # [E, V] layout
        y = qmatmul(x, w, out_dtype=out_dtype)
    else:
        y = qmatmul(x, w.T, out_dtype=out_dtype)
    return y if tp is None else comm.gather_from(y, tp.group, -1)


def head_weight(params: Params) -> torch.Tensor:
    """The bf16 head as [E, V] (tied: ``wte.T``) for the fused CE; a vocab
    shard under TP is gathered first, as GSPMD gathers a kernel call's
    operands (the CE then runs whole on every rank)."""
    if "head" in params:
        w, dim = params["head"], 1
    else:
        w, dim = params["wte"], 0
    tp = _tp_vocab(w)
    if tp is not None:
        w = comm.gather_from(w, tp.group, dim)
    return w if dim == 1 else w.T


# matmuls without batch dims: the ops ``remat="dots"`` keeps resident, as
# jax.checkpoint_policies.dots_with_no_batch_dims_saveable does
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_block(remat, window: int):
    """``layer_forward`` wrapped for activation recompute: ``True``
    recomputes the whole block in the backward; ``"dots"`` keeps the
    projections' outputs and recomputes the elementwise chain (norms, rope,
    activations) — the JAX package's ``jax.checkpoint`` policies. The
    int8, sequence- and tensor-parallel policies in force at the forward
    are captured and re-entered by the recompute, which autograd runs on its
    own thread for a CUDA backward."""
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)

    def block(card, lp, x, cos, sin, positions):
        if card.arch == "MAMBA":
            return _mamba_remat(card, lp, x, kw)
        pol, sp, tp = current_int8(), current_sp(), current_tp()

        def run(*args):
            with int8_scope(pol), sp_scope(sp), tp_scope(tp):
                return layer_forward(*args)
        return checkpoint(run, card, lp, x, cos, sin, positions, window,
                          use_reentrant=False, **kw)
    return block


def _mamba_remat(card: ModelCard, lp: Params, x: torch.Tensor, kw: dict
                 ) -> torch.Tensor:
    """A Mamba layer under remat: the norm and projections before the scan
    and the gate and projection after it are recomputed in the backward;
    the scan is not, since it keeps only its inputs and its backward
    rebuilds its state (``mamba.SelectiveScan``)."""
    def pre(lp, x):
        return mamba_in(card, lp, _norm(card, x, lp["ln1"], lp.get("ln1_b")))
    u, dt, A, Bm, Cm, z = checkpoint(pre, lp, x, use_reentrant=False, **kw)
    y = selective_scan(u, dt, A, Bm, Cm)
    return x + checkpoint(mamba_out, lp, y, u, z, use_reentrant=False, **kw)


def model_forward(card: ModelCard, params: Params, tokens: torch.Tensor,
                  positions: Optional[torch.Tensor] = None, window: int = 0,
                  return_hidden: bool = False, remat=False,
                  logits_dtype=torch.float32,
                  guppy_samps=None) -> torch.Tensor:
    """Full-sequence forward: tokens [B, T] -> logits [B, T, V] in
    ``logits_dtype`` (training takes bf16), or the final-norm hidden states
    [B, T, E] with ``return_hidden``. ``remat``: False, True (recompute
    each block in the backward) or "dots" (keep the matmul outputs).
    ``guppy_samps`` [L, F]: a GUPPY card's FFN rows (None: the evaluation
    sample), unless the params already hold them."""
    B, T = tokens.shape
    dev = tokens.device
    if positions is None:
        positions = torch.arange(T, dtype=torch.int64, device=dev)
    window = window or card.window
    params = inject_rows(card, params, guppy_samps)
    x = embed_tokens(card, params, tokens)
    if card.pos_embed == "learned":
        x = x + params["wpe"][positions.long()]
    cos = sin = None
    if card.pos_embed == "rope" and card.attn != "mla":   # MLA: mla_qkv
        cos, sin = rope_freqs(card.head_dim, card.max_pos, card.rope_theta,
                              card.rope_scaling_dict(), device=dev)
    if remat:
        block = _remat_block(remat, window)
    else:
        block = functools.partial(layer_forward, window=window)
    for lp in params["layers"]:
        x = block(card, lp, x, cos, sin, positions.long())
    x = _norm(card, x, params["ln_f"], params.get("ln_f_b"))
    if return_hidden:
        return x
    return lm_head(card, params, x, out_dtype=logits_dtype)
