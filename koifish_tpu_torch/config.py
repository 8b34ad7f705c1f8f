"""Configuration universe — JSON cards + CLI flags (PyTorch port).

A pure-Python copy of the JAX package's ``config.py``: same cards, same
reference JSON schema (including the misspelt ``optimizatioin`` key).

Re-implements the reference's config contract (``CLI_params`` + nested
cards, reference: src/CLI_params.hpp:857-1127 and §5.6 of SURVEY.md) so
reference config files port directly:

- sections ``model`` (arch + ``parameter.transformer`` dims + backbone),
  ``quantizer`` (per-neuron-name bit spec), ``train``, ``datasets``,
  ``debug``, ``checkpoint_out``, ``seed``
- keys starting with ``"#"`` are comments (reference convention)
- HF ``config.json`` ingestion (``MODEL_CARD::InitHugFace``,
  reference: src/Utils/CLI_params.cpp:2224)
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Tuple

from koifish_tpu_torch.dtypes import DEFAULT_GROUP, QFormat, qformat_from_bits


def _strip_comments(obj: Any) -> Any:
    """Drop dict keys starting with '#' recursively (reference config style)."""
    if isinstance(obj, dict):
        return {k: _strip_comments(v) for k, v in obj.items() if not k.startswith("#")}
    if isinstance(obj, list):
        return [_strip_comments(v) for v in obj]
    return obj


def jkv(obj: Any, path: List[str], default: Any = None) -> Any:
    """Path query into nested JSON — analog of the reference's ``jKV``
    (src/CLI_params.hpp:1118-1126)."""
    cur = obj
    for key in path:
        if not isinstance(cur, dict) or key not in cur:
            return default
        cur = cur[key]
    return cur


# ---------------------------------------------------------------------------
# Model card
# ---------------------------------------------------------------------------

#: arch-family defaults: (pos_embed, norm, act, qkv_bias, qk_norm)
_ARCH_DEFAULTS = {
    "GPT2": dict(pos_embed="learned", norm="layernorm", act="gelu",
                 qkv_bias=True, qk_norm=False, mlp_bias=True, tie_embeddings=True),
    "QWEN2": dict(pos_embed="rope", norm="rmsnorm", act="swiglu",
                  qkv_bias=True, qk_norm=False, mlp_bias=False, tie_embeddings=True),
    "QWEN3": dict(pos_embed="rope", norm="rmsnorm", act="swiglu",
                  qkv_bias=False, qk_norm=True, mlp_bias=False, tie_embeddings=True),
    "LLAMA": dict(pos_embed="rope", norm="rmsnorm", act="swiglu",
                  qkv_bias=False, qk_norm=False, mlp_bias=False, tie_embeddings=False),
    # Guppy: decoder with vocab-memory FFNs over resampled embedding
    # rows (reference gLLM.hpp:231, SparseNeuron::SetEmbed/UpdateSamps)
    "GUPPY": dict(pos_embed="rope", norm="rmsnorm", act="gelu",
                  qkv_bias=False, qk_norm=False, mlp_bias=False,
                  tie_embeddings=True),
    # LLAMA_VAE: decoder whose token embedding is factored through the
    # EmbedVAE latent stack (reference gLLM.hpp:163-182, latent_dim 192)
    "LLAMA_VAE": dict(pos_embed="rope", norm="rmsnorm", act="swiglu",
                      qkv_bias=False, qk_norm=False, mlp_bias=False,
                      tie_embeddings=True),
    "MISTRAL": dict(pos_embed="rope", norm="rmsnorm", act="swiglu",
                    qkv_bias=False, qk_norm=False, mlp_bias=False, tie_embeddings=False),
    "DEEPSEEK": dict(pos_embed="rope", norm="rmsnorm", act="swiglu",
                     qkv_bias=False, qk_norm=False, mlp_bias=False, tie_embeddings=False),
    "BITNET": dict(pos_embed="rope", norm="rmsnorm", act="swiglu",
                   qkv_bias=False, qk_norm=False, mlp_bias=False, tie_embeddings=True),
    "QWEN3_MOE": dict(pos_embed="rope", norm="rmsnorm", act="swiglu",
                      qkv_bias=False, qk_norm=True, mlp_bias=False, tie_embeddings=True),
    "MAMBA": dict(pos_embed="none", norm="rmsnorm", act="silu",
                  qkv_bias=False, qk_norm=False, mlp_bias=False, tie_embeddings=True),
    # Salmon — masked-diffusion ("scoring") LM: bidirectional attention
    # (reference isCausalMask=false, Salmon.cpp:36; open-dcoder-0.5B has
    # QKV bias, Salmon.cpp:18)
    "SALMON": dict(pos_embed="rope", norm="rmsnorm", act="swiglu",
                   qkv_bias=True, qk_norm=False, mlp_bias=False,
                   tie_embeddings=True, causal=False),
}

# (arch, dims) per published HF config; vocab padded to a 128 multiple
# where it already is one. Sources: reference cases/gpt2_*.json,
# cases/qwen3/*.json + the HF cards they point at.
MODEL_PRESETS = {
    "gpt2-124m": ("GPT2", dict(vocab_size=50304, n_layer=12, n_embd=768,
                               n_head=12, n_kv_head=12, head_dim=64,
                               n_ffn=3072, n_ctx=1024, max_pos=1024)),
    "gpt2-774m": ("GPT2", dict(vocab_size=50304, n_layer=36, n_embd=1280,
                               n_head=20, n_kv_head=20, head_dim=64,
                               n_ffn=5120, n_ctx=1024, max_pos=1024)),
    "gpt2-1558m": ("GPT2", dict(vocab_size=50304, n_layer=48, n_embd=1600,
                                n_head=25, n_kv_head=25, head_dim=64,
                                n_ffn=6400, n_ctx=1024, max_pos=1024)),
    "qwen2.5-0.5b": ("QWEN2", dict(vocab_size=151936, n_layer=24, n_embd=896,
                                   n_head=14, n_kv_head=2, head_dim=64,
                                   n_ffn=4864, n_ctx=4096, max_pos=32768)),
    "qwen3-0.6b": ("QWEN3", dict(vocab_size=151936, n_layer=28, n_embd=1024,
                                 n_head=16, n_kv_head=8, head_dim=128,
                                 n_ffn=3072, n_ctx=4096, max_pos=40960)),
    "qwen3-1.7b": ("QWEN3", dict(vocab_size=151936, n_layer=28, n_embd=2048,
                                 n_head=16, n_kv_head=8, head_dim=128,
                                 n_ffn=6144, n_ctx=4096, max_pos=40960)),
    "qwen3-4b": ("QWEN3", dict(vocab_size=151936, n_layer=36, n_embd=2560,
                               n_head=32, n_kv_head=8, head_dim=128,
                               n_ffn=9728, n_ctx=8192, max_pos=40960)),
    "qwen3-8b": ("QWEN3", dict(vocab_size=151936, n_layer=36, n_embd=4096,
                               n_head=32, n_kv_head=8, head_dim=128,
                               n_ffn=12288, n_ctx=8192, max_pos=40960,
                               tie_embeddings=False)),
    "qwen3-32b": ("QWEN3", dict(vocab_size=151936, n_layer=64, n_embd=5120,
                                n_head=64, n_kv_head=8, head_dim=128,
                                n_ffn=25600, n_ctx=8192, max_pos=40960,
                                tie_embeddings=False)),
}

_HF_MODEL_TYPE = {
    "gpt2": "GPT2", "qwen2": "QWEN2", "qwen3": "QWEN3", "llama": "LLAMA",
    "mistral": "MISTRAL", "deepseek_v2": "DEEPSEEK", "deepseek_v3": "DEEPSEEK",
    "qwen3_moe": "QWEN3_MOE", "mamba": "MAMBA",
}


@dataclasses.dataclass(unsafe_hash=True)
class ModelCard:
    """Architecture hyperparameters — analog of the reference's MODEL_CARD
    (src/CLI_params.hpp:263-385).

    Hashable by value (as in the JAX package); ``rope_scaling``
    is therefore stored as a frozen tuple of (key, value) pairs — use
    :meth:`rope_scaling_dict`.
    """

    arch: str = "QWEN3"
    vocab_size: int = 151936
    n_layer: int = 28
    n_embd: int = 1024
    n_head: int = 16
    n_kv_head: int = 8
    head_dim: int = 64
    n_ffn: int = 3072
    n_ctx: int = 1024
    max_pos: int = 32768
    tie_embeddings: bool = True
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-6
    qkv_bias: bool = False
    qk_norm: bool = True
    mlp_bias: bool = False
    pos_embed: str = "rope"      # learned | rope | none
    norm: str = "rmsnorm"        # layernorm | rmsnorm
    act: str = "swiglu"          # gelu | swiglu | silu
    # rope long-context scaling (YaRN analog of reference rope.cu:129-243);
    # frozen tuple of (key, value) pairs — see rope_scaling_dict()
    rope_scaling: Optional[tuple] = None
    # sliding-window attention (Mistral); 0 = full causal
    window: int = 0
    # False = bidirectional attention (Salmon diffusion LM,
    # reference isCausalMask=false)
    causal: bool = True
    # diffusion-LM mask token id (-1 = vocab_size - 1 at runtime)
    mask_token_id: int = -1
    # MoE (QWEN3_MOE)
    n_experts: int = 0
    n_experts_active: int = 0
    moe_ffn: int = 0
    # hybrid backbone (J2Neuron interleaved arrangements): when non-empty,
    # ONLY these layer indices get the MoE FFN; the rest stay dense.
    # () + n_experts>0 = every layer MoE (the plain *_MOE arch)
    moe_layers: tuple = ()
    # layer indices that are GAU blocks (gated attention unit replaces
    # the attention+FFN pair — models/gau.py)
    gau_layers: tuple = ()
    # layer indices whose attention is BROWN (learned fixed attention,
    # the reference's BROWN_attn — models/brown.py); FFN kept
    brown_layers: tuple = ()
    # EmbedVAE latent dims for the LLAMA_VAE arch (reference
    # MODEL_CARD token_embeds / LLAMA_VAE latent_dim=192)
    token_embeds: tuple = ()
    # MLA (DeepSeek family; attn="mla")
    attn: str = "std"
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    dtype: str = "bfloat16"

    @property
    def n_qkv(self) -> Tuple[int, int, int]:
        d = self.head_dim
        return self.n_head * d, self.n_kv_head * d, self.n_kv_head * d

    def rope_scaling_dict(self) -> Optional[dict]:
        return dict(self.rope_scaling) if self.rope_scaling else None

    @classmethod
    def from_arch(cls, arch: str, **overrides) -> "ModelCard":
        arch = arch.upper()
        defaults = dict(_ARCH_DEFAULTS.get(arch, _ARCH_DEFAULTS["LLAMA"]))
        defaults.update(overrides)
        card = cls(arch=arch, **defaults)
        return card

    @classmethod
    def preset(cls, name: str) -> "ModelCard":
        """Named size presets for the model families the reference ships
        case configs for (cases/gpt2_*.json, cases/qwen3/*.json) plus the
        scale-out targets (Qwen3-8B/32B — reference README.md:23 runs 32B
        inference on one 4090; our analog is TP over a chip mesh, see
        parallel/planner.py)."""
        key = name.lower().replace("_", "-")
        if key not in MODEL_PRESETS:
            raise ValueError(f"unknown preset '{name}' "
                             f"(have: {sorted(MODEL_PRESETS)})")
        arch, kw = MODEL_PRESETS[key]
        return cls.from_arch(arch, **kw)

    @classmethod
    def from_json(cls, jmodel: dict) -> "ModelCard":
        """Parse a reference-style ``model`` section (SURVEY.md §5.6)."""
        arch = jmodel.get("arch", "QWEN3").upper()
        if arch in ("SCORE", "NLP_SCORE", "NLP_SCORE_"):
            arch = "SALMON"   # reference arch string (CLI_params.cpp:297)
        p = jmodel.get("parameter", {})
        t = p.get("transformer", {})
        kw: Dict[str, Any] = {}
        if "Layer" in p:
            kw["n_layer"] = int(p["Layer"])
        if "Ctx" in t:
            kw["n_ctx"] = int(t["Ctx"])
        if "Embed" in t:
            kw["n_embd"] = int(t["Embed"])
        if "Head" in t:
            kw["n_head"] = int(t["Head"])
        kw["n_kv_head"] = int(t.get("KVHead", kw.get("n_head", 0) or t.get("Head", 12)))
        if "Ffn" in t:
            kw["n_ffn"] = int(t["Ffn"])
        if "head_dim" in t:
            kw["head_dim"] = int(t["head_dim"])
        elif "Embed" in t and "Head" in t:
            kw["head_dim"] = int(t["Embed"]) // int(t["Head"])
        if "vocab_size" in jmodel:
            kw["vocab_size"] = int(jmodel["vocab_size"])
        if "tie_word_embeddings" in p:
            kw["tie_embeddings"] = bool(p["tie_word_embeddings"])
        if "token_embeds" in p:
            kw["token_embeds"] = tuple(int(d) for d in p["token_embeds"])
        if "max_pos_embeddings" in p:
            kw["max_pos"] = int(p["max_pos_embeddings"])
        if "num_experts" in p:
            kw["n_experts"] = int(p["num_experts"])
            kw["n_experts_active"] = int(p.get("num_experts_per_tok", 2))
            kw["moe_ffn"] = int(p.get("moe_intermediate_size",
                                      t.get("Ffn", 0)))
        card = cls.from_arch(arch, **kw)
        if arch == "GPT2":
            card.vocab_size = int(jmodel.get("vocab_size", 50257))
            card.n_ffn = 4 * card.n_embd  # GPT2 MLP is 4x (ref config "Ffn" field is unused scale)
            card.rope_theta = 0.0
            card.norm_eps = 1e-5
        # the backbone tree IS the graph in the reference (TGraph.cpp:1586):
        # a layout the decoder implements sets the card's per-layer blocks,
        # anything else raises BackboneError instead of being coerced
        bb = jmodel.get("backbone")
        if bb:
            from koifish_tpu_torch.models.backbone import (
                BackboneError, brown_layer_indices, gau_layer_indices,
                moe_layer_indices, validate_backbone)
            layout = validate_backbone(bb, card.n_layer)
            if layout == "hybrid":
                card.moe_layers = moe_layer_indices(bb, card.n_layer)
                card.gau_layers = gau_layer_indices(bb, card.n_layer)
                card.brown_layers = brown_layer_indices(bb, card.n_layer)
                if card.moe_layers and card.n_experts <= 0:
                    raise BackboneError(
                        "hybrid backbone has MOE layers but the model "
                        "config sets no experts (parameter.num_experts)")
            elif layout == "moe" and card.n_experts <= 0:
                raise BackboneError(
                    "MoE backbone but no experts configured "
                    "(parameter.num_experts)")
        return card

    @classmethod
    def from_hf(cls, hf_cfg: dict) -> "ModelCard":
        """Ingest a HuggingFace ``config.json`` —
        analog of MODEL_CARD::InitHugFace (src/Utils/CLI_params.cpp:2224)."""
        mt = hf_cfg.get("model_type", "llama")
        arch = _HF_MODEL_TYPE.get(mt, "LLAMA")
        n_head = int(hf_cfg.get("num_attention_heads", hf_cfg.get("n_head", 12)))
        n_embd = int(hf_cfg.get("hidden_size", hf_cfg.get("n_embd", 768)))
        card = cls.from_arch(
            arch,
            vocab_size=int(hf_cfg.get("vocab_size", 151936)),
            n_layer=int(hf_cfg.get("num_hidden_layers", hf_cfg.get("n_layer", 12))),
            n_embd=n_embd,
            n_head=n_head,
            n_kv_head=int(hf_cfg.get("num_key_value_heads", n_head)),
            head_dim=int(hf_cfg.get("head_dim", n_embd // n_head)),
            n_ffn=int(hf_cfg.get("intermediate_size", 4 * n_embd)),
            n_ctx=min(int(hf_cfg.get("max_position_embeddings", 32768)), 8192),
            max_pos=int(hf_cfg.get("max_position_embeddings", 32768)),
        )
        card.tie_embeddings = bool(hf_cfg.get("tie_word_embeddings", card.tie_embeddings))
        card.rope_theta = float(hf_cfg.get("rope_theta", card.rope_theta))
        card.norm_eps = float(hf_cfg.get("rms_norm_eps", hf_cfg.get("layer_norm_epsilon", card.norm_eps)))
        if hf_cfg.get("sliding_window"):
            card.window = int(hf_cfg["sliding_window"])
        if hf_cfg.get("rope_scaling"):
            card.rope_scaling = tuple(sorted(
                (k, v) for k, v in hf_cfg["rope_scaling"].items()
                if isinstance(v, (int, float, str, bool))))
        if "num_experts" in hf_cfg:
            card.n_experts = int(hf_cfg["num_experts"])
            card.n_experts_active = int(hf_cfg.get("num_experts_per_tok", 8))
            card.moe_ffn = int(hf_cfg.get("moe_intermediate_size", card.n_ffn))
        if "kv_lora_rank" in hf_cfg:       # DeepSeek MLA
            card.attn = "mla"
            card.q_lora_rank = int(hf_cfg.get("q_lora_rank") or 0)
            card.kv_lora_rank = int(hf_cfg["kv_lora_rank"])
            card.qk_nope_head_dim = int(hf_cfg.get("qk_nope_head_dim", 128))
            card.qk_rope_head_dim = int(hf_cfg.get("qk_rope_head_dim", 64))
            card.v_head_dim = int(hf_cfg.get("v_head_dim", 128))
            card.head_dim = card.qk_nope_head_dim + card.qk_rope_head_dim
            card.n_kv_head = card.n_head   # MLA materializes per-head K/V
        return card


# ---------------------------------------------------------------------------
# Quantizer card
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class QuantRule:
    pattern: str                     # substring match on param path
    fmt: QFormat
    group: int = DEFAULT_GROUP
    symmetric: bool = True
    method: str = "RTN"              # RTN | RTNf (NF codebook) | AWQ


@dataclasses.dataclass
class QuantCard:
    """Per-neuron-name quantization spec — analog of QUANT_CARD
    (reference: src/CLI_params.hpp:509-554; config example
    cases/qwen3/qwen3_596M_q4.json:3-8)."""

    rules: List[QuantRule] = dataclasses.field(default_factory=list)
    group: int = DEFAULT_GROUP
    train_target: str = ""           # "" (weights) | "gama" (scale-only QAT)
    kv_fmt: Optional[QFormat] = None  # quantized KV-cache format

    @classmethod
    def from_json(cls, jq: dict) -> "QuantCard":
        group = int(jq.get("group_size", DEFAULT_GROUP))
        card = cls(group=group, train_target=jq.get("train_target", ""))
        for name, spec in jq.items():
            if name in ("group_size", "train_target", "kv_cache", "MINI"):
                continue
            if not isinstance(spec, dict) or "bits" not in spec:
                continue
            method = spec.get("quant_method", "RTN").upper()
            nf = method in ("RTNF", "NF", "CLUSTER", "KMEANS",
                            "MINI", "MINI_GBDT")
            if method in ("F8EX", "F8E5M2"):
                # reference F8Ex casts weights to e5m2 (QUANT_MODE::F8Ex,
                # CLI_params.hpp:484; f8e5 cast kernels operator.cuh:519)
                fmt = QFormat.F8_E5M2
            elif method == "F8E4M3":
                fmt = QFormat.F8_E4M3
            else:
                fmt = qformat_from_bits(int(spec["bits"]), nf=nf)
            card.rules.append(QuantRule(
                pattern=name, fmt=fmt,
                group=int(spec.get("group_size", group)),
                symmetric=bool(spec.get("symmetric", True)),
                method=method,
            ))
        kv = jq.get("kv_cache")
        if isinstance(kv, dict) and "bits" in kv:
            card.kv_fmt = qformat_from_bits(int(kv["bits"]))
        return card

    def rule_for(self, param_path: str) -> Optional[QuantRule]:
        """First rule whose pattern is a substring of the param path —
        the analog of QUANT_CARD::isPass name filtering."""
        for rule in self.rules:
            if rule.pattern in param_path:
                return rule
        return None


# ---------------------------------------------------------------------------
# Train / SFT / sampler / dataset cards
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainCard:
    """Training knobs — analog of TRAIN_CARD + ADAM/MUON params
    (reference: src/CLI_params.hpp:556-635)."""

    batch: int = 16
    grad_accum: int = 1
    epochs: int = 1
    lr: float = 6e-4
    lr_min_ratio: float = 0.1
    warmup: int = 700
    scheduler: str = "cosine"   # static | cosine | cosine_epoch | wsd | tri_line
    epoch_iters: int = 0        # cosine_epoch restart period (nEpochIter)
    optimizer: str = "adamw"         # adamw | muon | lion | sgd
    moment_dtype: str = "f32"        # f32 | bf16 moment STORAGE (math is
                                     # always f32). The reference stores
                                     # Adam m/v as bf16 (floatMV,
                                     # g_float.hpp:248) — bf16 halves
                                     # the optimizer's memory
    # stochastic rounding on bf16 STORAGE writebacks (params + moments):
    # "auto"/True = on for every bf16 leaf (the reference's seeded SR in
    # CU_adamw_p, Optimizer.cu:135-393 — round-to-nearest drops every
    # sub-half-ulp update systematically); False = deterministic RTN
    stochastic_round: Any = "auto"
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    # LARS per-tensor trust ratio cap (reference config.lars_ratio,
    # CLI_params.hpp:1034; GTensor::rLARS, GTensor.cpp:24-33): when > 0,
    # each >=2D leaf's gradient is rescaled by
    # min(||w|| / (||g|| + 1e-8), lars_ratio). 0 = off (reference default)
    lars_ratio: float = 0.0
    muon_lr_ratio: float = 1.0
    muon_momentum: float = 0.95
    # MUON_params_::Orthogonalization (CLI_params.hpp:570-574): "ns"
    # (NewtonSchulz, reference default) | "chebyshev" (minimax-cubic
    # schedule — the enum the reference declares but never dispatches).
    # "gluon" is not implemented (declared-only there too).
    muon_ortho: str = "ns"
    remat: Any = True                # activation recompute (reference "Rematerialisation");
                                     # True=full, "dots"=save GEMM outputs, False=off
    int8_matmul: bool = False        # int8 fwd matmuls (FP8-GEMM analog)
    int8_wgrad: bool = False         # experimental: int8 wgrad too
    # int8 dgrad: False | True/'fold' (scale-folded dy) | 'tile'
    # (the per-tile int8 dgrad kernel, csrc/qdgrad.cu)
    int8_dgrad: Any = False
    fused_ce: Optional[bool] = None  # None: auto (vocab >= 64k). True
                                     # forces the chunked logits-free CE;
                                     # False forces the bf16-logits path
    int8_min_kn: int = 1 << 24       # K*N weight-size gate (ops/int8_train)
    dump_every: int = 10
    eval_every: int = 100
    gpt_every: int = 0               # in-training chat sample cadence
    save_every: int = 0
    most_iter: int = -1              # cap iterations (DEBUG.N_mostiter analog)
    # DEBUG/DUMP switch analogs (DEUG_SWITCH/DUMP_SWITCH,
    # CLI_params.hpp:720-785) — the subset the JAX package keeps; the
    # CUDA kernel-version selectors (verInferQKV, T_GEMM, ...) have no analog
    nn_structure: bool = True        # dump the param tree at startup
    check_tensor_norm: bool = False  # per-leaf grad-norm watch in metrics
    kernel_choices: bool = False     # verbose kernel-dispatch log (also
                                     # logs POSITIVE kernel picks;
                                     # fallbacks log by default on the
                                     # GPU — utils/kernel_log.py)
    graph_dump: str = ""             # write the step's graph here
    time_most: float = 0.0           # abort training after N seconds (Time_most)
    train_csv_path: str = ""         # loss CSV override (DUMP_SWITCH)
    seed: int = 42

    @classmethod
    def from_json(cls, jt: dict, debug: Optional[dict] = None) -> "TrainCard":
        card = cls()
        card.batch = int(jt.get("batch", card.batch))
        card.epochs = int(jt.get("epoch", card.epochs))
        card.lr = float(jt.get("learning-rate", card.lr))
        card.warmup = int(jt.get("warmup", card.warmup))
        card.dump_every = int(jt.get("dump-every", card.dump_every))
        card.save_every = int(jt.get("save-every", card.save_every))
        card.gpt_every = int(jt.get("gpt-every", card.gpt_every))
        card.eval_every = int(jt.get("eval-every", card.eval_every))
        r = jt.get("remat", jt.get("rematerialization", None))
        if r is not None:
            card.remat = r if isinstance(r, str) else bool(r)
        opt = jt.get("optimizatioin", jt.get("optimization", {}))  # sic — reference key
        card.optimizer = str(opt.get("method", card.optimizer)).lower()
        card.muon_ortho = str(opt.get("muon_ortho",
                                      card.muon_ortho)).lower()
        card.grad_accum = int(opt.get("grad_accumulation", card.grad_accum))
        card.moment_dtype = str(opt.get("moment_dtype",
                                        card.moment_dtype)).lower()
        card.int8_matmul = bool(opt.get("int8_matmul", card.int8_matmul))
        dg = opt.get("int8_dgrad", card.int8_dgrad)
        if isinstance(dg, str):
            dg = dg.lower()
            if dg in ("off", "false", "none", ""):
                dg = False
            elif dg == "fold":
                dg = True
            elif dg != "tile":
                raise ValueError(
                    f"int8_dgrad must be off|fold|tile, got {dg!r}")
        else:
            dg = bool(dg)
        card.int8_dgrad = dg
        card.int8_min_kn = int(opt.get("int8_min_kn", card.int8_min_kn))
        card.lars_ratio = float(opt.get("lars_ratio",
                                        jt.get("lars_ratio",
                                               card.lars_ratio)))
        srj = opt.get("stochastic_round", card.stochastic_round)
        if isinstance(srj, str):
            srj = False if srj.lower() in ("off", "false", "0", "none") \
                else "auto"
        else:
            srj = bool(srj)
        card.stochastic_round = srj
        if "fused_ce" in opt:
            card.fused_ce = bool(opt["fused_ce"])
        sched = jt.get("scheduler", {})
        if isinstance(sched, str):
            card.scheduler = sched
        elif isinstance(sched, dict) and "type" in sched:
            card.scheduler = str(sched["type"]).lower()
        if isinstance(sched, dict):
            card.epoch_iters = int(sched.get("epoch_iters", card.epoch_iters))
        if card.scheduler in ("lr_restart", "cosine_restart"):
            card.scheduler = "cosine_epoch"   # reference lr_restart=1 alias
        if debug:
            card.most_iter = int(debug.get("most_iter", card.most_iter))
            card.nn_structure = bool(debug.get("nn_structure",
                                               card.nn_structure))
            card.check_tensor_norm = bool(debug.get("check_tensor_norm",
                                                    card.check_tensor_norm))
            card.graph_dump = str(debug.get("graph_dump", card.graph_dump))
            card.time_most = float(debug.get("Time_most",
                                             debug.get("time_most",
                                                       card.time_most)))
            card.train_csv_path = str(debug.get("train_csv_path",
                                                card.train_csv_path))
            card.kernel_choices = bool(debug.get("kernel_choices",
                                                 card.kernel_choices))
        return card


@dataclasses.dataclass
class SFTCard:
    """Tuning method — analog of SFT_CARD (src/CLI_params.hpp:449-474)."""
    method: str = "full"             # full | lora | bitfit | only_attention | only_head
    hf_card: str = ""
    lora_rank: int = 16
    lora_alpha: float = 32.0
    lora_targets: Tuple[str, ...] = ("wq", "wk", "wv", "wo")

    @classmethod
    def from_json(cls, js: dict) -> "SFTCard":
        return cls(
            method=str(js.get("method", "Full")).lower(),
            hf_card=js.get("hf-card", ""),
            lora_rank=int(js.get("lora_rank", 16)),
            lora_alpha=float(js.get("lora_alpha", 32.0)),
        )


@dataclasses.dataclass(unsafe_hash=True)
class SamplerCard:
    """Decode sampler — analog of CHAT_SAMPLER
    (reference defaults src/CLI_params.hpp:677-680)."""
    temperature: float = 0.6
    top_p: float = 0.95
    top_k: int = 50
    min_p: float = 0.0
    max_new_tokens: int = 256
    seed: int = 42
    # opt-in approximate top-k in the JAX package; the port always takes
    # the EXACT top-k (torch.topk), matching the reference's heap
    # (GoPT.hpp:86-88), and keeps the field for config parity
    approx_top_k: bool = False
    # "topk" (GeneratOnPrompt::Sample pipeline) | "metropolis" — the
    # reference's GOPT_Metropolis generator (GoPT.cpp:516): plain CDF
    # sampling over the full softmax of the raw logits
    method: str = "topk"


@dataclasses.dataclass
class DatasetCard:
    glob: str = ""
    name: str = ""
    kind: str = "tokens"             # tokens | hellaswag | ChatML | OAI_message
    most: int = -1                   # max shards
    eval_every: int = 0
    samp: float = 1.0

    @classmethod
    def from_json(cls, jd: dict) -> "DatasetCard":
        return cls(
            glob=jd.get("glob", ""), name=jd.get("name", ""),
            kind=jd.get("type", "tokens"), most=int(jd.get("most", -1)),
            eval_every=int(jd.get("eval-every", 0)),
            samp=float(jd.get("samp", 1.0)),
        )


@dataclasses.dataclass
class CheckpointCard:
    """Checkpoint descriptor — analog of CheckPoint_Params
    (reference: src/CLI_params.hpp:800-855)."""
    path: str = ""
    state: str = "state"             # state | best | full
    save_every: int = 0


# ---------------------------------------------------------------------------
# Top-level
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CLIParams:
    model: ModelCard = dataclasses.field(default_factory=ModelCard)
    quant: QuantCard = dataclasses.field(default_factory=QuantCard)
    train: TrainCard = dataclasses.field(default_factory=TrainCard)
    sft: Optional[SFTCard] = None
    sampler: SamplerCard = dataclasses.field(default_factory=SamplerCard)
    datasets: Dict[str, DatasetCard] = dataclasses.field(default_factory=dict)
    checkpoint_in: str = ""
    checkpoint_out: Optional[CheckpointCard] = None
    hf_card: str = ""                # HF model dir (--hf flag / "hf-card")
    prompts: List[str] = dataclasses.field(default_factory=list)
    fuyou: Optional[dict] = None
    xi: Optional[dict] = None        # diffusion/score config (XI_CARD)
    seed: int = 42
    raw: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def load(cls, path: str, overrides: Optional[dict] = None) -> "CLIParams":
        with open(path) as f:
            raw = json.load(f)
        return cls.from_json(raw, overrides)

    @classmethod
    def from_json(cls, raw_in: dict, overrides: Optional[dict] = None) -> "CLIParams":
        raw = _strip_comments(raw_in)
        if overrides:
            raw = _deep_merge(raw, overrides)
        p = cls(raw=raw)
        jm = raw.get("model", {})
        hf_dir = jm.get("hf-card", "") or jkv(raw, ["sft", "hf-card"], "")
        if hf_dir and os.path.exists(os.path.join(hf_dir, "config.json")):
            with open(os.path.join(hf_dir, "config.json")) as f:
                p.model = ModelCard.from_hf(json.load(f))
            p.hf_card = hf_dir
        elif jm:
            p.model = ModelCard.from_json(jm)
        # legacy attention-type selector (reference gLLM.cpp:79:
        # model_v0.attention.type == "brown" -> every layer BROWN_attn)
        if (jkv(raw, ["model_v0", "attention", "type"], "QKV").lower()
                == "brown" and p.model is not None):
            p.model.brown_layers = tuple(range(p.model.n_layer))
        if "fuyou" in jm:
            p.fuyou = jm["fuyou"]
        p.xi = jm.get("xi", raw.get("xi"))   # XI_CARD (diffusion mask cfg)
        if "quantizer" in raw:
            p.quant = QuantCard.from_json(raw["quantizer"])
        p.train = TrainCard.from_json(raw.get("train", {}), raw.get("debug", {}))
        if "sft" in raw:
            p.sft = SFTCard.from_json(raw["sft"])
            if p.sft.hf_card:
                p.hf_card = p.sft.hf_card
        for name, jd in raw.get("datasets", {}).items():
            if isinstance(jd, dict):
                p.datasets[name] = DatasetCard.from_json(jd)
        cs = raw.get("chat_sampler", raw.get("sampler", {}))
        if isinstance(cs, dict) and cs:
            sd = p.sampler
            p.sampler = SamplerCard(
                temperature=float(cs.get("temperature", sd.temperature)),
                top_p=float(cs.get("top_p", sd.top_p)),
                top_k=int(cs.get("top_k", sd.top_k)),
                min_p=float(cs.get("min_p", sd.min_p)),
                max_new_tokens=int(cs.get("max_new_tokens",
                                          sd.max_new_tokens)),
                seed=int(cs.get("seed", sd.seed)),
                method=str(cs.get("method", sd.method)).lower())
        dbg = raw.get("debug", {})
        p.prompts = list(dbg.get("prompts", []))
        p.seed = int(raw.get("seed", 42))
        p.train.seed = p.seed
        if "checkpoint-in" in raw:
            p.checkpoint_in = raw["checkpoint-in"]
        co = raw.get("checkpoint_out") or raw.get("checkpoint-out")
        if isinstance(co, dict):
            first = next(iter(co.values())) if co else {}
            if isinstance(first, dict):
                p.checkpoint_out = CheckpointCard(
                    path=first.get("path", ""), state=first.get("state", "state"),
                    save_every=int(first.get("save-every", 0)))
        elif isinstance(co, str):
            p.checkpoint_out = CheckpointCard(path=co)
        return p


def _deep_merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out
