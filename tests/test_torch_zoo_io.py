"""PyTorch port vs the JAX package: a Qwen3-MoE HF folder through the
loader and ``bubble``, and the names of ported modules that the port's
packages export (``ops``, ``quant``, ``serve``), with ``quant_error`` and
``quantize_best`` on ``tests/test_quant.py``'s cases."""
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from koifish_tpu.config import QuantCard as JQuantCard
from koifish_tpu.config import SamplerCard as JSamplerCard
from koifish_tpu.data import chat_template as jct
from koifish_tpu.data import tokenizer as jtok
from koifish_tpu.dtypes import QFormat as JQFormat
from koifish_tpu.io import hf_loader as jhf
from koifish_tpu.quant import rtn as jrtn
from koifish_tpu.quant.apply import quantize_params as j_quantize_params
from koifish_tpu.serve import cache_for as j_cache_for
from koifish_tpu.serve import generate as j_generate

from koifish_tpu_torch.cli import bubble
from koifish_tpu_torch.dtypes import QFormat
from koifish_tpu_torch.io import hf_loader as thf
from koifish_tpu_torch.quant import rtn as trtn

from helpers import byte_level_tokenizer_json, write_safetensors
from torch_helpers import jax_tree_to_numpy, torch_threads

MOE_HF = dict(vocab_size=300, n_layer=2, E=128, H=2, Hkv=1, D=64, Fm=64,
              Ne=4, k=2)


def make_hf_qwen3_moe_dir(path, seed=0):
    """config.json, model.safetensors and tokenizer.json of a tiny
    Qwen3-MoE (the ``Qwen/Qwen3-30B-A3B`` naming: ``mlp.gate`` routes,
    ``mlp.experts.{e}.{gate,up,down}_proj`` hold the experts)."""
    c = MOE_HF
    rng = np.random.default_rng(seed)
    E, D = c["E"], c["D"]

    def w(shape, scale=0.05):
        return (rng.standard_normal(shape, dtype=np.float32) * scale
                ).astype(ml_dtypes.bfloat16)
    one = lambda n: np.ones((n,), ml_dtypes.bfloat16)
    t = {"model.embed_tokens.weight": w((c["vocab_size"], E)),
         "model.norm.weight": one(E), "lm_head.weight": w((c["vocab_size"], E))}
    for i in range(c["n_layer"]):
        pre = f"model.layers.{i}."
        t.update({
            pre + "input_layernorm.weight": one(E),
            pre + "self_attn.q_proj.weight": w((c["H"] * D, E)),
            pre + "self_attn.k_proj.weight": w((c["Hkv"] * D, E)),
            pre + "self_attn.v_proj.weight": w((c["Hkv"] * D, E)),
            pre + "self_attn.o_proj.weight": w((E, c["H"] * D)),
            pre + "self_attn.q_norm.weight": one(D),
            pre + "self_attn.k_norm.weight": one(D),
            pre + "post_attention_layernorm.weight": one(E),
            pre + "mlp.gate.weight": w((c["Ne"], E), 0.5),
        })
        for e in range(c["Ne"]):
            ex = f"{pre}mlp.experts.{e}."
            t.update({ex + "gate_proj.weight": w((c["Fm"], E)),
                      ex + "up_proj.weight": w((c["Fm"], E)),
                      ex + "down_proj.weight": w((E, c["Fm"]))})
    write_safetensors(str(path / "model.safetensors"), t)
    with open(path / "config.json", "w") as f:
        json.dump({
            "model_type": "qwen3_moe", "vocab_size": c["vocab_size"],
            "num_hidden_layers": c["n_layer"], "hidden_size": E,
            "num_attention_heads": c["H"], "num_key_value_heads": c["Hkv"],
            "head_dim": D, "intermediate_size": 192,
            "moe_intermediate_size": c["Fm"], "num_experts": c["Ne"],
            "num_experts_per_tok": c["k"], "rope_theta": 1e6,
            "rms_norm_eps": 1e-6, "tie_word_embeddings": False,
            "max_position_embeddings": 256}, f)
    with open(path / "tokenizer.json", "w") as f:
        json.dump(byte_level_tokenizer_json(), f)


def _bits(a):
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


def test_qwen3_moe_folder_loads_as_jax(tmp_path):
    """``load_hf_model`` on a Qwen3-MoE folder gives the JAX package's card
    and params bit for bit: the router [E, Ne] and the expert stacks
    [Ne, E, Fm] / [Ne, Fm, E] transposed from HF's [out, in]."""
    make_hf_qwen3_moe_dir(tmp_path)
    jcard, jp = jhf.load_hf_model(str(tmp_path))
    tcard, tp = thf.load_hf_model(str(tmp_path), device="cpu")
    assert (tcard.arch, tcard.n_experts, tcard.n_experts_active,
            tcard.moe_ffn) == (jcard.arch, jcard.n_experts,
                               jcard.n_experts_active, jcard.moe_ffn) == \
        ("QWEN3_MOE", 4, 2, 64)
    jn = jax_tree_to_numpy(jp)
    assert sorted(jn) == sorted(tp)
    for jl, tl in zip(jn["layers"], tp["layers"]):
        assert sorted(jl) == sorted(tl)
        for key in tl:
            assert tuple(tl[key].shape) == jl[key].shape, key
            np.testing.assert_array_equal(_bits(tl[key]), _bits(jl[key]),
                                          err_msg=key)
    assert tuple(tp["layers"][0]["egate"].shape) == (4, 128, 64)
    assert tuple(tp["layers"][0]["edown"].shape) == (4, 64, 128)
    for key in ("wte", "head", "ln_f"):
        np.testing.assert_array_equal(_bits(tp[key]), _bits(jn[key]))


def test_moe_folder_under_a_dense_card_names_the_missing_key(tmp_path):
    """A folder with MoE routers whose config.json names its experts by
    another key than ``num_experts`` (here ``n_routed_experts``, as
    DeepSeek's does) raises a ValueError naming the key, not a bare
    KeyError on ``mlp.gate_proj.weight``."""
    make_hf_qwen3_moe_dir(tmp_path)
    with open(tmp_path / "config.json") as f:
        cfg = json.load(f)
    cfg["n_routed_experts"] = cfg.pop("num_experts")
    with open(tmp_path / "config.json", "w") as f:
        json.dump(cfg, f)
    with pytest.raises(ValueError, match="num_experts"):
        thf.load_hf_model(str(tmp_path), device="cpu")


def test_bubble_serves_a_qwen3_moe_folder_as_jax_generates(tmp_path):
    """``bubble --bits 4 --kv-bits 8 --temperature 0`` on the folder: the
    prompt ids and 10 greedy tokens equal the JAX package's ``generate``
    on the same folder with the same INT4 rules (the expert stacks stay
    bf16 in both) and an INT8 cache."""
    make_hf_qwen3_moe_dir(tmp_path)
    prompt, new = "hello world, tell me something long enough", 10
    jcard, jp = jhf.load_hf_model(str(tmp_path))
    jp = j_quantize_params(jp, JQuantCard.from_json(
        {"self_attn": {"bits": 4}, "mlp": {"bits": 4}}), jcard)
    tk = jtok.BPETokenizer.from_file(str(tmp_path))
    tk._native_tried = True
    ids = tk.encode(jct.render([{"role": "user", "content": prompt}],
                               str(tmp_path), jcard.arch))
    eos = tk.token_id("<|im_end|>")
    toks, _ = j_generate(jcard, jp, jnp.asarray([ids], jnp.int32),
                         j_cache_for(jcard, 1, 128, fmt=JQFormat.INT8),
                         JSamplerCard(temperature=0.0), max_new_tokens=new,
                         eos_id=eos, decode_chunk=8)
    turns = []
    with torch_threads(1):
        assert bubble.main(["--hf", str(tmp_path), "--prompts", prompt,
                            "--max-new", str(new), "--bits", "4",
                            "--kv-bits", "8", "--temperature", "0", "--ctx",
                            "128", "--device", "cpu"], turns=turns) == 0
    (turn,) = turns
    assert turn["prompt_ids"] == ids
    assert turn["tokens"] == np.asarray(toks)[0].tolist()


def test_ported_names_are_exported():
    """The names the JAX package's ``ops``, ``quant`` and ``serve``
    packages export and the port had only in its modules."""
    from koifish_tpu_torch import ops, quant, serve
    for name in ("qmatmul", "linear", "rmsnorm", "layernorm", "rope_freqs",
                 "apply_rope", "causal_attention", "decode_attention",
                 "cross_entropy_loss", "sample_logits"):
        assert callable(getattr(ops, name)), name
    for name in ("fake_quant", "pack_codes", "unpack_codes", "codebook_for",
                 "quant_error", "quantize_best", "quantize"):
        assert callable(getattr(quant, name)), name
    from koifish_tpu.quant import NF3_CODEBOOK as J3, NF4_CODEBOOK as J4
    for t, j in ((quant.NF4_CODEBOOK, J4), (quant.NF3_CODEBOOK, J3)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j.get()))
    from koifish_tpu_torch.serve.speculative import speculative_generate
    assert serve.speculative_generate is speculative_generate
    # every name koifish_tpu/parallel/__init__.py exports
    import ast
    import koifish_tpu.parallel as jpar
    from koifish_tpu_torch import parallel
    tree = ast.parse(open(jpar.__file__).read())
    names = [a.asname or a.name for node in tree.body
             if isinstance(node, ast.ImportFrom) for a in node.names]
    assert len(names) >= 9
    for name in names:
        assert getattr(parallel, name, None) is not None, name


_KEY = jax.random.PRNGKey(0)


@pytest.mark.parametrize("case", ["int4", "int8", "nf4", "int8_asym",
                                  "int4_asym"])
def test_quant_error_matches_jax(case):
    """``quant_error`` of the same weights and quantization as
    ``tests/test_quant.py``'s cases: the JAX package's value within f32
    rounding (the codes and scales are byte-identical)."""
    fmt, sym, w = {
        "int4": ("int4", True, jax.random.normal(_KEY, (512, 256))),
        "int8": ("int8", True, jax.random.normal(_KEY, (512, 256))),
        "nf4": ("nf4", True, jax.random.normal(_KEY, (512, 256))),
        "int8_asym": ("int8", False,
                      jax.random.normal(_KEY, (256, 128)) + 3.0),
        "int4_asym": ("int4", False, jax.random.uniform(_KEY, (256, 64))),
    }[case]
    jq = jrtn.quantize(w, JQFormat(fmt), group=128, symmetric=sym)
    tw = torch.from_numpy(np.asarray(w, np.float32).copy())
    tq = trtn.quantize(tw, QFormat(fmt), group=128, symmetric=sym)
    np.testing.assert_allclose(float(trtn.quant_error(tw, tq)),
                               float(jrtn.quant_error(w, jq)), rtol=1e-5)


def test_quantize_best_matches_jax():
    """``tests/test_quant.py::test_quantize_best_sweep``'s case: NF4 beats
    INT4 on Gaussian weights in both packages, with the same error."""
    w = jax.random.normal(_KEY, (256, 64))
    jq, jerr = jrtn.quantize_best(w, [JQFormat.INT4, JQFormat.NF4])
    tq, terr = trtn.quantize_best(torch.from_numpy(np.asarray(w).copy()),
                                  [QFormat.INT4, QFormat.NF4])
    assert tq.fmt is QFormat.NF4 and jq.fmt is JQFormat.NF4
    assert terr < 0.10
    np.testing.assert_allclose(terr, jerr, rtol=1e-5)
