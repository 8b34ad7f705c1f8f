"""Streamed, sharded quantize-at-load — the Qwen3-32B serving path (the JAX
package's ``io/stream_load.py``; the reference's ``LoadFolderOfST`` ->
``Serial_Quant_MMAP``, Serialize.cpp:1018, which quantizes each tensor as
it streams out of the safetensors mmap).

Each rank of a process mesh reads and quantizes only its own shard of each
tensor, one tensor at a time:

    mmap view -> this rank's slice -> canonical layout ([in, out]) ->
    QuantCard rule -> packed QTensor on the rank's device

A column-parallel weight's shard is a row slice of the HF [out, in] view
(contiguous), a row-parallel one a column slice (read row chunk by row
chunk); the vocab shard of the embedding a row slice of [V, E]. RTN-family
rules stream in column chunks of the canonical matrix (``CHUNK_BYTES``):
groups run along the in axis, so column chunking is exact and a shard's
codes and scales are the whole tensor's, sliced (a row-parallel shard
splits K at group boundaries only, else the weight is replicated, as
``parallel/sharding.py`` lays it out). Codebook and Sinkhorn rules learn
from the whole tensor, so they quantize it whole and keep the shard. Host
memory stays of the order of one chunk; the full bf16 model never exists.

Dense llama-family checkpoints only (Qwen2/Qwen3/LLaMA/Mistral); GPT2 and
MoE raise, as in the JAX package, and keep ``load_hf_model`` +
``quantize_params`` + ``parallel/sharding.shard_params``.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

from koifish_tpu_torch.config import ModelCard, QuantCard
from koifish_tpu_torch.io.hf_loader import refuse_unmapped_zoo
from koifish_tpu_torch.quant.qtensor import QTensor
from koifish_tpu_torch.utils.device import resolve_device

# column-chunk size for streamed quantization (tests shrink this to
# force multi-chunk coverage on tiny tensors)
CHUNK_BYTES = 128 << 20

_STREAMABLE = ("RTN", "RTNF", "NF", "F8EX", "F8E5M2", "F8E4M3")

#: bytes this process has copied out of checkpoint views: a rank's shards,
#: and the whole of a tensor it keeps whole
_read = [0]


def bytes_read() -> int:
    """Bytes ``load_hf_sharded_quantized`` has read from the checkpoint in
    this process so far."""
    return _read[0]


def _read_view(v: torch.Tensor) -> torch.Tensor:
    _read[0] += v.numel() * v.element_size()
    return v


def _lazy_folder(folder: str) -> Dict[str, torch.Tensor]:
    """{name: zero-copy mmap view} over a HF dir (single file, index, or
    any *.safetensors). Nothing is read until a view is touched."""
    from koifish_tpu_torch.io.safetensors import read_safetensors
    out: Dict[str, torch.Tensor] = {}
    index = os.path.join(folder, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            files = sorted(set(json.load(f)["weight_map"].values()))
    else:
        files = sorted(f for f in os.listdir(folder)
                       if f.endswith(".safetensors"))
    for fname in files:
        tensors, _ = read_safetensors(os.path.join(folder, fname), mmap=True)
        out.update(tensors)
    return out


def _quantize_one(w: torch.Tensor, rule) -> Any:
    """One QuantCard rule on a [in, out] matrix (``quant/apply``'s
    per-leaf dispatch)."""
    if rule is None or w.dim() != 2 or w.shape[0] % rule.group:
        return w
    if rule.method in ("CLUSTER", "KMEANS"):
        from koifish_tpu_torch.quant.cluster import quantize_kmeans
        return quantize_kmeans(w, bits=rule.fmt.bits, group=rule.group)
    if rule.method in ("MINI", "MINI_GBDT"):
        from koifish_tpu_torch.quant.cluster import quantize_mini
        return quantize_mini(w, bits=rule.fmt.bits, group=rule.group)
    if rule.method in ("SNQ", "SINKHORN"):
        from koifish_tpu_torch.quant.cluster import quantize_sinkhorn
        return quantize_sinkhorn(w, rule.fmt, group=rule.group)
    from koifish_tpu_torch.quant.rtn import quantize_jit
    return quantize_jit(w, rule.fmt, group=rule.group,
                        symmetric=rule.symmetric)


def _cat(xs, dim):
    """The chunks joined, contiguous (the kernels take contiguous codes
    and scales only)."""
    return torch.cat(xs, dim=dim) if len(xs) > 1 else xs[0].contiguous()


def load_hf_sharded_quantized(folder: str, mesh, qcard: Optional[QuantCard]
                              = None, card: Optional[ModelCard] = None,
                              dtype=torch.bfloat16, tp: str = "tp"
                              ) -> tuple:
    """(card, params): this rank's shard of every leaf, on the mesh's
    device, weights quantized per ``qcard`` — never more than one chunk of
    a bf16 tensor in host memory. ``card`` is the whole model's; run the
    shard with ``parallel/sharding.local_card``."""
    from koifish_tpu_torch.parallel.sharding import _COL, _COL_BIAS, _ROW
    from koifish_tpu_torch.quant.apply import param_path

    if card is None:
        with open(os.path.join(folder, "config.json")) as f:
            card = ModelCard.from_hf(json.load(f))
    if card.arch == "GPT2" or card.n_experts > 0:
        raise NotImplementedError(
            "streaming sharded load covers dense llama-family checkpoints "
            "(the 32B serving target); use load_hf_model + quantize_params "
            "+ shard_params for GPT2/MoE")
    dev = resolve_device(mesh.device)
    n, r = mesh.size(tp), mesh.index(tp)
    raw = _lazy_folder(folder)
    refuse_unmapped_zoo(card, raw)

    def part(dim_len: int, ok: bool = True) -> slice:
        """This rank's range of a dim sharded on tp (all when it is not)."""
        if n == 1 or not ok or dim_len % n:
            return slice(0, dim_len)
        per = dim_len // n
        return slice(r * per, (r + 1) * per)

    def stream(a: torch.Tensor, rows: slice, cols: slice, rule) -> QTensor:
        """Quantize a[rows, cols] (HF layout: canonical [in, out]
        transposed) in row chunks, i.e. canonical column chunks."""
        n_rows = rows.stop - rows.start
        n_in = cols.stop - cols.start
        step = max(128, (CHUNK_BYTES // max(n_in * a.element_size(), 1))
                   // 128 * 128)
        parts = []
        for s in range(rows.start, rows.stop, step):
            chunk = _read_view(a[s:min(s + step, rows.stop), cols]
                               ).contiguous()
            chunk = chunk.to(dev).to(dtype).T          # [in, <=step]
            parts.append(_quantize_one(chunk, rule))
        return QTensor(
            codes=_cat([p.codes for p in parts], 1),
            scales=_cat([p.scales for p in parts], 1),
            zeros=(_cat([p.zeros for p in parts], 1)
                   if parts[0].zeros is not None else None),
            fmt=parts[0].fmt, shape=(n_in, n_rows), group=parts[0].group)

    def take_q(q: QTensor, k_sl: slice, n_sl: slice) -> QTensor:
        """The [k_sl, n_sl] shard of a whole-tensor QTensor (K at group
        boundaries: codes and scales rows in proportion)."""
        n_in = q.shape[0]
        kf = n_in // (k_sl.stop - k_sl.start)

        def rows(t):
            per = t.shape[0] // kf
            i = k_sl.start // (n_in // kf)
            return t[i * per:(i + 1) * per]
        cut = lambda t: None if t is None else rows(t)[:, n_sl].contiguous()
        cb = q.codebook
        if cb is not None and cb.dim() == 2:
            cb = cb[k_sl].contiguous()
        rs = q.row_scale[k_sl].contiguous() if q.row_scale is not None \
            else None
        return QTensor(codes=cut(q.codes), scales=cut(q.scales),
                       zeros=cut(q.zeros), fmt=q.fmt,
                       shape=(k_sl.stop - k_sl.start, n_sl.stop - n_sl.start),
                       group=q.group, codebook=cb, row_scale=rs)

    def leaf(name: str, hf_name: str, li: Optional[int],
             transpose: bool = False, head_layout: bool = False):
        a = raw[hf_name]
        rule = qcard.rule_for(param_path(li, name)) if qcard else None
        if a.dim() == 1:
            sl = part(a.shape[0], name in _COL_BIAS)
            return _read_view(a[sl]).to(dev).to(dtype)
        # which dims of the HF-layout view lie on tp: a column-parallel
        # weight's out rows, a row-parallel one's in columns, the vocab
        # rows of the embedding (plain [V, E] or head layout [E, V])
        rows_on = head_layout or (transpose and name in _COL)
        cols_on = transpose and name in _ROW
        n_in = a.shape[1]
        quant = (rule is not None and (transpose or head_layout)
                 and n_in % rule.group == 0)
        k_ok = cols_on and (not quant or (n_in % n == 0
                                        and (n_in // n) % rule.group == 0))
        rows, cols = part(a.shape[0], rows_on), part(n_in, k_ok)
        if quant and rule.method in _STREAMABLE:
            return stream(a, rows, cols, rule)
        if quant:             # a learned book: from the whole tensor
            q = _quantize_one(_read_view(a).to(dev).to(dtype).T, rule)
            return take_q(q, cols, rows)
        w = _read_view(a[rows, cols])
        w = (w.T if transpose else w).contiguous().to(dev).to(dtype)
        return w

    p: Dict[str, Any] = {
        "wte": leaf("wte", "model.embed_tokens.weight", None,
                    head_layout=True),
        "ln_f": leaf("ln_f", "model.norm.weight", None),
    }
    if not card.tie_embeddings:
        hf_head = ("lm_head.weight" if "lm_head.weight" in raw
                   else "model.embed_tokens.weight")
        p["head"] = leaf("head", hf_head, None, transpose=True)
    layers = []
    for i in range(card.n_layer):
        pre = f"model.layers.{i}."
        lp: Dict[str, Any] = {
            "ln1": leaf("ln1", pre + "input_layernorm.weight", i),
            "q": leaf("q", pre + "self_attn.q_proj.weight", i, True),
            "k": leaf("k", pre + "self_attn.k_proj.weight", i, True),
            "v": leaf("v", pre + "self_attn.v_proj.weight", i, True),
            "o": leaf("o", pre + "self_attn.o_proj.weight", i, True),
            "ln2": leaf("ln2", pre + "post_attention_layernorm.weight", i),
            "gate": leaf("gate", pre + "mlp.gate_proj.weight", i, True),
            "up": leaf("up", pre + "mlp.up_proj.weight", i, True),
            "down": leaf("down", pre + "mlp.down_proj.weight", i, True),
        }
        if card.qkv_bias:
            lp["q_b"] = leaf("q_b", pre + "self_attn.q_proj.bias", i)
            lp["k_b"] = leaf("k_b", pre + "self_attn.k_proj.bias", i)
            lp["v_b"] = leaf("v_b", pre + "self_attn.v_proj.bias", i)
        if card.qk_norm:
            lp["qn"] = leaf("qn", pre + "self_attn.q_norm.weight", i)
            lp["kn"] = leaf("kn", pre + "self_attn.k_norm.weight", i)
        layers.append(lp)
    p["layers"] = layers
    return card, p
