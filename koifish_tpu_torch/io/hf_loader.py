"""HF checkpoint -> the port's param tree.

The JAX package's ``io/hf_loader.py``: HF linears store [out, in] and the
canonical layout is [in, out] (y = x @ w), so matrices transpose on load;
GPT2 uses Conv1D ([in, out] already) and a fused c_attn, split here. AWQ
folders are unpacked to asymmetric INT4 QTensors at load
(``quant/awq.py``). Tensors are moved to the device before the transpose,
so the copy runs there.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import torch

from koifish_tpu_torch.config import ModelCard
from koifish_tpu_torch.io.safetensors import iter_hf_folder
from koifish_tpu_torch.quant.awq import convert_awq_weights, is_awq_checkpoint
from koifish_tpu_torch.quant.qtensor import QTensor
from koifish_tpu_torch.utils.device import resolve_device


def load_hf_model(folder: str, card: Optional[ModelCard] = None,
                  dtype=torch.bfloat16, device=None):
    """Returns (card, params) from a HF model directory, on ``device``
    (``None`` means CUDA)."""
    dev = resolve_device(device)
    if card is None:
        with open(os.path.join(folder, "config.json")) as f:
            card = ModelCard.from_hf(json.load(f))
    raw = dict(iter_hf_folder(folder))
    if is_awq_checkpoint(raw):
        raw = convert_awq_weights(raw)
    refuse_unmapped_zoo(card, raw)
    if card.arch == "GPT2":
        params = _map_gpt2(card, raw, dtype, dev)
    else:
        params = _map_llama_family(card, raw, dtype, dev)
    return card, params


def load_kun_model(path: str, dtype=torch.bfloat16, device=None):
    """Load a reference ``.kun`` single-file model: the embedded msgpack
    config (Safetensors.hpp:92-119) gives the ModelCard; the tensors (HF
    naming, Serialize.cpp) map as an HF folder's do, on ``device``
    (``None`` means CUDA). Returns (card, params, config_json). Packed or
    quantized tensors raise, as in the JAX package."""
    from koifish_tpu_torch.io.kun import read_kun
    dev = resolve_device(device)
    config, ktensors = read_kun(path)
    if config is None:
        raise ValueError(f"{path}: no embedded __koifish__config__ — not a "
                         f".kun file (plain safetensors? use load_hf_model)")
    card = ModelCard.from_json(config.get("model", {}))
    raw = {}
    for name, kt in ktensors.items():
        if kt.gama is not None or kt.data.dim() != len(kt.shape):
            raise NotImplementedError(
                f"{name}: packed/quantized .kun tensors need the quant "
                f"rules from the config — dequantize with the reference "
                f"or export HF-format for now")
        raw[name] = kt.data
    refuse_unmapped_zoo(card, raw)
    if card.arch == "GPT2":
        params = _map_gpt2(card, raw, dtype, dev)
    else:
        params = _map_llama_family(card, raw, dtype, dev)
    return card, params, config


def zoo_layers(card: ModelCard) -> List[str]:
    """The zoo's layers of ``card`` that have no Llama or GPT2 tensor
    names: MLA attention, MAMBA and GUPPY layers, GAU and BROWN layers."""
    out = ["MLA"] if card.attn == "mla" else []
    if card.arch in ("MAMBA", "GUPPY"):
        out.append(card.arch)
    if card.gau_layers:
        out.append("GAU")
    if card.brown_layers:
        out.append("BROWN")
    return out


def _reads(card: ModelCard, raw):
    """(name, the JAX loader's error where it is missing) of each tensor
    the JAX package's mapping reads, in its order: a missing name is a
    KeyError in the Llama mapping; in the GPT2 one ``jnp.asarray`` of the
    missing tensor's ``None`` is a TypeError, and the q/k/v slices of a
    missing fused ``c_attn`` an IndexError."""
    if card.arch != "GPT2":
        yield from (("model.embed_tokens.weight", "KeyError"),
                    ("model.norm.weight", "KeyError"))
        for i in range(card.n_layer):
            pre = f"model.layers.{i}."
            names = ["input_layernorm.weight"] + [
                f"self_attn.{k}_proj.weight" for k in "qkvo"] + [
                "post_attention_layernorm.weight"]
            if not (card.n_experts > 0 and pre + "mlp.gate.weight" in raw):
                names += [f"mlp.{k}_proj.weight"
                          for k in ("gate", "up", "down")]
            if card.qkv_bias:
                names += [f"self_attn.{k}_proj.bias" for k in "qkv"]
            if card.qk_norm:
                names += ["self_attn.q_norm.weight", "self_attn.k_norm.weight"]
            yield from ((pre + n, "KeyError") for n in names)
        return
    yield from ((n, "TypeError") for n in ("wte.weight", "wpe.weight",
                                            "ln_f.weight", "ln_f.bias"))
    for i in range(card.n_layer):
        pre = f"h.{i}."
        yield from ((pre + n, "TypeError") for n in ("ln_1.weight",
                                                     "ln_1.bias"))
        yield pre + "attn.c_attn.weight", "IndexError"
        yield pre + "attn.c_attn.bias", "IndexError"
        yield from ((pre + n, "TypeError") for n in (
            "attn.c_proj.weight", "attn.c_proj.bias", "ln_2.weight",
            "ln_2.bias", "mlp.c_fc.weight", "mlp.c_fc.bias",
            "mlp.c_proj.weight", "mlp.c_proj.bias"))


def refuse_unmapped_zoo(card: ModelCard, raw) -> None:
    """Raise for a checkpoint of a zoo card that the JAX package's loaders
    fail on: they map tensors by Llama and GPT2 names only, so an MLA,
    MAMBA or GUPPY checkpoint, or one with GAU or BROWN layers, lacks a
    name they read (ROADMAP.md queue 3, known quirks). The port refuses
    it at load, on one rank and under ``--tp`` alike, naming the JAX
    error; one that carries every name maps as the JAX package maps it.
    SALMON and LLAMA_VAE have no such layers: they load and serve."""
    what = zoo_layers(card)
    if not what:
        return
    for name, err in _reads(card, raw):
        if name not in raw and (card.arch != "GPT2"
                                or "transformer." + name not in raw):
            said = (f"{err}: {name!r}" if err == "KeyError"
                    else f"{err} on the missing {name!r}")
            raise NotImplementedError(
                f"a {'/'.join(what)} checkpoint: the JAX package's loaders "
                f"map Llama and GPT2 tensor names only and fail on it "
                f"({said}), so the port refuses it")


def _t(a, dtype, dev, transpose: bool = False):
    if isinstance(a, QTensor):
        return a.to(dev)      # AWQ import: already [in, out] packed
    a = a.to(dev)
    return (a.T if transpose else a).to(dtype).contiguous()


def _map_llama_family(card: ModelCard, raw: Dict[str, Any], dtype, dev
                      ) -> Dict[str, Any]:
    """Qwen2/Qwen3/Qwen3-MoE/LLaMA/Mistral naming:
    model.layers.N.self_attn.q_proj..."""
    p: Dict[str, Any] = {
        "wte": _t(raw["model.embed_tokens.weight"], dtype, dev),
        "ln_f": _t(raw["model.norm.weight"], dtype, dev),
    }
    if not card.tie_embeddings:
        head = raw.get("lm_head.weight")
        if head is None:  # some exports tie implicitly
            head = raw["model.embed_tokens.weight"]
        p["head"] = _t(head, dtype, dev, transpose=True)    # [V,E] -> [E,V]
    layers = []
    for i in range(card.n_layer):
        pre = f"model.layers.{i}."

        def w(name, transpose=True):
            return _t(raw[pre + name], dtype, dev, transpose)

        lp: Dict[str, Any] = {
            "ln1": w("input_layernorm.weight", False),
            "q": w("self_attn.q_proj.weight"),
            "k": w("self_attn.k_proj.weight"),
            "v": w("self_attn.v_proj.weight"),
            "o": w("self_attn.o_proj.weight"),
            "ln2": w("post_attention_layernorm.weight", False),
        }
        if (pre + "mlp.gate.weight") in raw and card.n_experts <= 0:
            raise ValueError(
                f"{pre}mlp.gate.weight is a MoE router, but the card has "
                f"n_experts {card.n_experts}: its config.json lacks "
                f"num_experts, the key ModelCard.from_hf reads")
        if card.n_experts > 0 and (pre + "mlp.gate.weight") in raw:
            # Qwen3-MoE: the router and each expert's projections, stacked
            # over the expert axis ([Ne, E, Fm] / [Ne, Fm, E])
            lp["router"] = w("mlp.gate.weight")

            def stack(part):
                return torch.stack([w(f"mlp.experts.{e}.{part}.weight")
                                    for e in range(card.n_experts)])
            lp["egate"] = stack("gate_proj")
            lp["eup"] = stack("up_proj")
            lp["edown"] = stack("down_proj")
        else:
            lp["gate"] = w("mlp.gate_proj.weight")
            lp["up"] = w("mlp.up_proj.weight")
            lp["down"] = w("mlp.down_proj.weight")
        if card.qkv_bias:
            for key in ("q", "k", "v"):
                lp[key + "_b"] = w(f"self_attn.{key}_proj.bias", False)
        if card.qk_norm:
            lp["qn"] = w("self_attn.q_norm.weight", False)
            lp["kn"] = w("self_attn.k_norm.weight", False)
        layers.append(lp)
    p["layers"] = layers
    return p


def _map_gpt2(card: ModelCard, raw: Dict[str, Any], dtype, dev
              ) -> Dict[str, Any]:
    """GPT2 naming (Conv1D = [in, out] already; fused c_attn split 3-way)."""
    def g(name):  # some exports prefix "transformer."
        a = raw.get(name, raw.get("transformer." + name))
        return _t(a, dtype, dev)

    E = card.n_embd
    p: Dict[str, Any] = {"wte": g("wte.weight"), "wpe": g("wpe.weight"),
                         "ln_f": g("ln_f.weight"), "ln_f_b": g("ln_f.bias")}
    layers = []
    for i in range(card.n_layer):
        pre = f"h.{i}."
        ca_w = g(pre + "attn.c_attn.weight")     # [E, 3E]
        ca_b = g(pre + "attn.c_attn.bias")
        lp = {
            "ln1": g(pre + "ln_1.weight"), "ln1_b": g(pre + "ln_1.bias"),
            "q": ca_w[:, :E].contiguous(), "k": ca_w[:, E:2 * E].contiguous(),
            "v": ca_w[:, 2 * E:].contiguous(),
            "q_b": ca_b[:E].contiguous(), "k_b": ca_b[E:2 * E].contiguous(),
            "v_b": ca_b[2 * E:].contiguous(),
            "o": g(pre + "attn.c_proj.weight"),
            "o_b": g(pre + "attn.c_proj.bias"),
            "ln2": g(pre + "ln_2.weight"), "ln2_b": g(pre + "ln_2.bias"),
            "fc": g(pre + "mlp.c_fc.weight"), "fc_b": g(pre + "mlp.c_fc.bias"),
            "proj": g(pre + "mlp.c_proj.weight"),
            "proj_b": g(pre + "mlp.c_proj.bias"),
        }
        layers.append(lp)
    p["layers"] = layers
    return p
