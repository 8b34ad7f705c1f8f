"""PyTorch port vs the JAX package: the chat entry point.

safetensors files (both writers, both readers, a sharded index), the HF
loader (Qwen3, AWQ and GPT2 folders), the byte-level BPE tokenizer (stdlib
``re`` with the Unicode classes rewritten, against the ``regex`` module),
chat-template rendering, and ``bubble`` itself: the port's CLI on the CPU,
plain and with a draft, against the JAX package's ``generate`` on the same
folder. Inputs come from numpy with a fixed seed."""
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from koifish_tpu.config import ModelCard as JModelCard
from koifish_tpu.config import QuantCard as JQuantCard
from koifish_tpu.config import SamplerCard as JSamplerCard
from koifish_tpu.data import chat_template as jct
from koifish_tpu.data import tokenizer as jtok
from koifish_tpu.dtypes import QFormat as JQFormat
from koifish_tpu.io import hf_loader as jhf
from koifish_tpu.io import safetensors as jst
from koifish_tpu.quant.apply import quantize_params as j_quantize_params
from koifish_tpu.serve import cache_for as j_cache_for
from koifish_tpu.serve import generate as j_generate
from koifish_tpu.serve.stacked import stack_layers as j_stack_layers

from koifish_tpu_torch.cli import bubble
from koifish_tpu_torch.data import chat_template as tct
from koifish_tpu_torch.data import tokenizer as ttok
from koifish_tpu_torch.io import hf_loader as thf
from koifish_tpu_torch.io import safetensors as tst
from koifish_tpu_torch.quant.qtensor import QTensor

from helpers import (byte_level_tokenizer_json, make_hf_awq_qwen3_dir,
                     make_hf_qwen3_dir)
from test_jinja import LLAMA3_TEMPLATE, MISTRAL_TEMPLATE, MSGS, QWEN3_TEMPLATE
from torch_helpers import jax_tree_to_numpy

TINY = dict(vocab_size=300, n_layer=2, n_embd=128, n_head=2, n_kv_head=1,
            head_dim=64, n_ffn=256, n_ctx=64, max_pos=256)


def _bits(a) -> np.ndarray:
    """The raw bits of a numpy (ml_dtypes bf16 included) or torch array."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        return a.cpu().numpy().view(np.uint8)
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint8)


def _tensors(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w.bf16": (rng.standard_normal((5, 7), np.float32)
                   ).astype(ml_dtypes.bfloat16),
        "w.f32": rng.standard_normal((3, 4)).astype(np.float32),
        "w.i32": rng.integers(-2**31, 2**31 - 1, (6,), dtype=np.int64
                              ).astype(np.int32),
        "w.i8": rng.integers(-128, 128, (2, 3, 4)).astype(np.int8),
        "w.u8": rng.integers(0, 256, (9,)).astype(np.uint8),
        "w.f16": rng.standard_normal((4,)).astype(np.float16),
    }


def test_safetensors_round_trips_both_ways(tmp_path):
    """A JAX-written file loads here bit for bit and the reverse; both
    writers make the same bytes."""
    ts = _tensors()
    jpath, tpath = str(tmp_path / "j.safetensors"), str(tmp_path / "t.safetensors")
    jst.write_safetensors(jpath, ts, metadata={"fmt": "pt"})
    got, meta = tst.read_safetensors(jpath)
    assert meta == {"fmt": "pt"} and list(got) == list(ts)
    assert got["w.bf16"].dtype == torch.bfloat16
    for k, a in ts.items():
        assert tuple(got[k].shape) == a.shape
        np.testing.assert_array_equal(_bits(got[k]), _bits(a))
    tst.write_safetensors(tpath, got, metadata={"fmt": "pt"})
    with open(jpath, "rb") as f1, open(tpath, "rb") as f2:
        assert f1.read() == f2.read()
    back, _ = jst.read_safetensors(tpath)
    for k, a in ts.items():
        assert back[k].dtype == a.dtype
        np.testing.assert_array_equal(_bits(back[k]), _bits(a))
    # copy-on-write views: writing a loaded tensor never reaches the file
    got["w.f32"].zero_()
    again, _ = tst.read_safetensors(jpath)
    np.testing.assert_array_equal(again["w.f32"].numpy(), ts["w.f32"])


def test_iter_hf_folder_sharded_index(tmp_path):
    ts = _tensors(1)
    names = list(ts)
    shards = {"model-00001-of-00002.safetensors": names[:3],
              "model-00002-of-00002.safetensors": names[3:]}
    for fname, keys in shards.items():
        jst.write_safetensors(str(tmp_path / fname), {k: ts[k] for k in keys})
    with open(tmp_path / "model.safetensors.index.json", "w") as f:
        json.dump({"weight_map": {k: fname for fname, keys in shards.items()
                                  for k in keys}}, f)
    jout = dict(jst.iter_hf_folder(str(tmp_path)))
    tout = dict(tst.iter_hf_folder(str(tmp_path)))
    assert list(tout) == list(jout) == names
    for k in names:
        np.testing.assert_array_equal(_bits(tout[k]), _bits(jout[k]))
    with pytest.raises(FileNotFoundError):
        list(tst.iter_hf_folder(str(tmp_path / "nothing")))


def _make_gpt2_dir(path, seed=0):
    rng = np.random.default_rng(seed)
    E, L, V, P = 64, 2, 97, 32

    def w(*shape):
        return (rng.standard_normal(shape, np.float32) * 0.05
                ).astype(np.float32)
    ts = {"wte.weight": w(V, E), "wpe.weight": w(P, E),
          "ln_f.weight": w(E), "ln_f.bias": w(E)}
    for i in range(L):
        pre = f"h.{i}."
        ts.update({pre + "ln_1.weight": w(E), pre + "ln_1.bias": w(E),
                   pre + "attn.c_attn.weight": w(E, 3 * E),
                   pre + "attn.c_attn.bias": w(3 * E),
                   pre + "attn.c_proj.weight": w(E, E),
                   pre + "attn.c_proj.bias": w(E),
                   pre + "ln_2.weight": w(E), pre + "ln_2.bias": w(E),
                   pre + "mlp.c_fc.weight": w(E, 4 * E),
                   pre + "mlp.c_fc.bias": w(4 * E),
                   pre + "mlp.c_proj.weight": w(4 * E, E),
                   pre + "mlp.c_proj.bias": w(E)})
    # some exports prefix "transformer."
    ts = {("transformer." + k if k.startswith("h.1") else k): v
          for k, v in ts.items()}
    jst.write_safetensors(str(path / "model.safetensors"), ts)
    with open(path / "config.json", "w") as f:
        json.dump({"model_type": "gpt2", "vocab_size": V, "n_layer": L,
                   "n_embd": E, "n_head": 4, "max_position_embeddings": P}, f)


def _assert_params_equal(jtree, ttree, path="params"):
    if isinstance(ttree, QTensor):
        assert jtree["fmt"] == ttree.fmt.value, path
        assert tuple(jtree["shape"]) == tuple(ttree.shape), path
        assert jtree["group"] == ttree.group, path
        for f in ("codes", "scales", "zeros", "codebook", "row_scale"):
            a, b = jtree[f], getattr(ttree, f)
            assert (a is None) == (b is None), (path, f)
            if a is not None:
                assert str(b.dtype).split(".")[-1] == a.dtype.name, (path, f)
                np.testing.assert_array_equal(_bits(b), _bits(a), err_msg=path)
        return
    if isinstance(ttree, dict):
        assert sorted(jtree) == sorted(ttree), path
        for k in ttree:
            _assert_params_equal(jtree[k], ttree[k], f"{path}.{k}")
        return
    if isinstance(ttree, list):
        assert len(jtree) == len(ttree), path
        for i, (a, b) in enumerate(zip(jtree, ttree)):
            _assert_params_equal(a, b, f"{path}[{i}]")
        return
    assert tuple(ttree.shape) == jtree.shape, path
    assert ttree.dtype == torch.bfloat16, path
    np.testing.assert_array_equal(_bits(ttree), _bits(jtree), err_msg=path)


@pytest.mark.parametrize("kind", ["qwen3", "awq", "gpt2"])
def test_load_hf_model_matches_jax(tmp_path, kind):
    """The same folder gives the JAX package's params: bf16 bits equal,
    AWQ QTensor fields equal, the card's dims equal."""
    if kind == "gpt2":
        _make_gpt2_dir(tmp_path)
    else:
        make = make_hf_qwen3_dir if kind == "qwen3" else make_hf_awq_qwen3_dir
        make(tmp_path, JModelCard.from_arch("QWEN3", **TINY))
    jcard, jp = jhf.load_hf_model(str(tmp_path))
    tcard, tp = thf.load_hf_model(str(tmp_path), device="cpu")
    for f in ("arch", "n_layer", "n_embd", "n_head", "n_kv_head", "head_dim",
              "n_ffn", "vocab_size", "tie_embeddings", "rope_theta",
              "norm_eps", "qk_norm", "qkv_bias"):
        assert getattr(tcard, f) == getattr(jcard, f), f
    _assert_params_equal(jax_tree_to_numpy(jp), tp)
    if kind == "awq":
        q = tp["layers"][0]["q"]
        assert isinstance(q, QTensor) and q.zeros is not None and q.group == 64


def test_load_kun_model_raises_until_ported(tmp_path):
    """``load_kun_model`` is ported: a ``.kun`` of a tiny folder's tensors
    (the port's writer, an embedded config) loads the folder's params bit
    for bit; a file without the config still raises, as in the JAX
    package."""
    from koifish_tpu_torch.io import kun as tkun
    card = JModelCard.from_arch("QWEN3", **TINY)
    make_hf_qwen3_dir(tmp_path, card)
    tensors, _ = tst.read_safetensors(str(tmp_path / "model.safetensors"))
    cfg = {"model": {"arch": "QWEN3", "vocab_size": card.vocab_size,
                     "parameter": {"Layer": card.n_layer,
                                   "tie_word_embeddings": True,
                                   "max_pos_embeddings": card.max_pos,
                                   "transformer": {
                                       "Ctx": card.n_ctx, "Embed": card.n_embd,
                                       "Head": card.n_head,
                                       "KVHead": card.n_kv_head,
                                       "head_dim": card.head_dim,
                                       "Ffn": card.n_ffn}}}}
    kun = str(tmp_path / "model.kun")
    tkun.write_kun(kun, cfg, tensors)
    kcard, kp, kcfg = thf.load_kun_model(kun, device="cpu")
    _, hp = thf.load_hf_model(str(tmp_path), device="cpu")
    assert kcfg == cfg and kcard.n_layer == card.n_layer
    for a, b in zip(_flat(kp), _flat(hp)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="__koifish__config__"):
        thf.load_kun_model(str(tmp_path / "model.safetensors"), device="cpu")


def _flat(tree):
    from koifish_tpu_torch.utils.tree import leaves
    return leaves(tree)


CORPUS = [
    "Hello world! It's a test, isn't it? They'll say we'd've gone.",
    "café naïve façade — Ελληνικά, русский, 中文字符与日本語のかな",
    "digits 0123 ٠١٢٣٤ ۴۵۶ Ⅻ ⅷ ½ ¾ ² 3.14159 1,000,000",
    "emoji 😀🎉👍🏽 and symbols ©®™ €£¥ → ∑∫√",
    "spaces   and\ttabs\t\tand\n\nnewlines\r\n  \n   trailing   ",
    "<|im_start|>user\nhello<|im_end|>\n<|im_start|>assistant\n",
    "MiXeD CaSe 'S 'T 'Re 'VE 'M 'LL 'D x'sY",
    "code: def f(x):\n    return x**2  # ok\n\t}\n",
]


def _tokenizer_files(tmp_path):
    """The byte-level tokenizer.json of tests/helpers.py (Qwen pattern by
    default) and the same with a Split pre-tokenizer carrying the GPT2
    pattern."""
    tj = byte_level_tokenizer_json()
    qpath = tmp_path / "qwen.json"
    qpath.write_text(json.dumps(tj))
    tj["pre_tokenizer"] = {"type": "Sequence", "pretokenizers": [
        {"type": "Split", "pattern": {"Regex": jtok._GPT2_PAT},
         "behavior": "Isolated"}, {"type": "ByteLevel"}]}
    gpath = tmp_path / "gpt2.json"
    gpath.write_text(json.dumps(tj))
    return {"qwen": str(qpath), "gpt2": str(gpath)}


@pytest.mark.parametrize("pattern", ["qwen", "gpt2"])
def test_tokenizer_matches_jax(tmp_path, pattern):
    """Pretokens, ids and decoded text equal the JAX package's (``regex``
    with \\p{L}/\\p{N}) on letters, digits of every Unicode number class,
    emoji, whitespace runs and special tokens."""
    path = _tokenizer_files(tmp_path)[pattern]
    jt = jtok.BPETokenizer.from_file(path)
    jt._native_tried = True            # the pure-Python merge, as here
    tt = ttok.BPETokenizer.from_file(path)
    assert tt.vocab_size == jt.vocab_size
    for text in CORPUS:
        jpre = [m.group() for m in jt.pat.finditer(text)]
        tpre = [m.group() for m in tt.pat.finditer(text)]
        assert tpre == jpre, text
        ids = tt.encode(text)
        assert ids == jt.encode(text), text
        assert tt.encode(text, allow_special=False) == \
            jt.encode(text, allow_special=False)
        assert tt.decode(ids) == jt.decode(ids) == text
    for tok in ("<|im_end|>", "<|endoftext|>", "he", "nope"):
        assert tt.token_id(tok) == jt.token_id(tok)


def test_unicode_pattern_classes():
    pat = ttok._compile(r"\p{N}+|\p{L}+|[^\s\p{L}\p{N}]+|\P{L}")
    assert pat.findall("Ⅻ½٣x") == ["Ⅻ½٣", "x"]
    assert pat.fullmatch("é") and pat.match("ß").group() == "ß"
    with pytest.raises(ValueError):
        ttok.unicode_pattern(r"[\P{L}]")


RENDER_CASES = [
    ("qwen3", QWEN3_TEMPLATE, True, True), ("qwen3", QWEN3_TEMPLATE, True, False),
    ("qwen3", QWEN3_TEMPLATE, False, False), ("llama3", LLAMA3_TEMPLATE, True, False),
    ("mistral", MISTRAL_TEMPLATE, False, False), ("none-qwen3", None, True, False),
    ("none-qwen3-think", None, True, True), ("none-gpt2", None, True, False),
]


@pytest.mark.parametrize("name,template,agp,think", RENDER_CASES,
                         ids=[f"{c[0]}-{int(c[2])}{int(c[3])}"
                              for c in RENDER_CASES])
def test_render_matches_jax(tmp_path, name, template, agp, think):
    """``render`` of a model folder's template (tokenizer_config.json, or
    chat_template.jinja) and of the arch defaults equals the JAX
    package's."""
    msgs = ([{"role": "user", "content": "hi"},
             {"role": "assistant", "content": "hello"}]
            if name == "mistral" else MSGS)
    if template is not None:
        cfg = {"chat_template": template, "bos_token": "<s>",
               "eos_token": {"content": "</s>"}}
        (tmp_path / "tokenizer_config.json").write_text(json.dumps(cfg))
        if name == "llama3":      # the newer layout takes precedence
            (tmp_path / "chat_template.jinja").write_text(template)
            cfg["chat_template"] = "{{ 'unused' }}"
            (tmp_path / "tokenizer_config.json").write_text(json.dumps(cfg))
    arch = "GPT2" if name.endswith("gpt2") else "QWEN3"
    kw = dict(arch=arch, add_generation_prompt=agp, enable_thinking=think)
    got = tct.render(msgs, str(tmp_path), **kw)
    assert got == jct.render(msgs, str(tmp_path), **kw)
    assert got


def test_sft_sample_to_tokens_matches_jax(tmp_path):
    path = _tokenizer_files(tmp_path)["qwen"]
    msgs = MSGS[:3]
    assert tct.sft_sample_to_tokens(ttok.BPETokenizer.from_file(path), msgs) \
        == jct.sft_sample_to_tokens(jtok.BPETokenizer.from_file(path), msgs)


def _jax_greedy(hf_dir, prompt, new):
    """The JAX package's bubble turn: the same folder, INT8 weights at load,
    an INT8 KV cache, greedy ``generate`` with stacked decode params."""
    jcard, jp = jhf.load_hf_model(hf_dir)
    jp = j_quantize_params(jp, JQuantCard.from_json(
        {"self_attn": {"bits": 8}, "mlp": {"bits": 8}}), jcard)
    tk = jtok.BPETokenizer.from_file(hf_dir)
    tk._native_tried = True
    ids = tk.encode(jct.render([{"role": "user", "content": prompt}], hf_dir,
                               jcard.arch))
    eos = tk.token_id("<|im_end|>")
    cache = j_cache_for(jcard, 1, 128, fmt=JQFormat.INT8)
    toks, _ = j_generate(jcard, jp, jnp.asarray([ids], jnp.int32), cache,
                         JSamplerCard(temperature=0.0), max_new_tokens=new,
                         eos_id=eos, decode_params=j_stack_layers(jp),
                         decode_chunk=8)
    return ids, np.asarray(toks)[0].tolist()


def test_bubble_cli_matches_jax_generate(tmp_path):
    """``bubble --device cpu --bits 8 --kv-bits 8 --temperature 0``, plain
    and with ``--draft-hf`` (a bf16 self-draft): the prompt ids and the
    greedy tokens equal the JAX ``generate`` on the same folder, the CSV
    gets one row per turn."""
    hf = tmp_path / "hf"
    hf.mkdir()
    make_hf_qwen3_dir(hf, JModelCard.from_arch("QWEN3", **TINY))
    prompt, new = "hello world, tell me something long enough", 10
    ids, jtoks = _jax_greedy(str(hf), prompt, new)
    csv_path = tmp_path / "chat.csv"
    base = ["--hf", str(hf), "--prompts", prompt, "--max-new", str(new),
            "--bits", "8", "--kv-bits", "8", "--temperature", "0", "--ctx",
            "128", "--device", "cpu", "--csv", str(csv_path)]
    for extra in ([], ["--draft-hf", str(hf)]):
        turns = []
        assert bubble.main(base + extra, turns=turns) == 0
        (turn,) = turns
        assert turn["prompt_ids"] == ids
        assert turn["tokens"] == jtoks, extra
        if extra:
            assert turn["stats"]["accept_rate"] > 0.5
    rows = csv_path.read_text().splitlines()
    assert rows[0] == "prompt,answer,tokens_per_sec" and len(rows) == 3


def test_bubble_refuses_what_is_not_ported(tmp_path):
    """A checkpoint of the zoo's layers that the JAX package's loaders
    cannot map is refused at load, naming the JAX error (with or without
    ``--tp``: ``tests/test_torch_slice21.py``); a ``.kun`` path is taken
    (the format is ported), and one without an embedded config is refused
    as the JAX package refuses it."""
    from koifish_tpu_torch.config import ModelCard
    from koifish_tpu_torch.io.hf_loader import refuse_unmapped_zoo
    with pytest.raises(NotImplementedError,
                       match="map Llama and GPT2 tensor names only"):
        refuse_unmapped_zoo(ModelCard.from_arch("MAMBA", **TINY), {})
    tst.write_safetensors(str(tmp_path / "m.kun"), {"x": torch.zeros(2)})
    with pytest.raises(ValueError, match="__koifish__config__"):
        bubble.main(["--hf", str(tmp_path / "m.kun"), "--device", "cpu"])
