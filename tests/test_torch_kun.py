"""The reference's ``.kun`` / ``.ckp`` / ``tokenizer.dat`` formats in the port
against the JAX package's ``io/kun.py``, on the CPU.

msgpack bytes both ways; ``write_kun`` files byte for byte the JAX writer's
for the same tensors (with and without moments); each package reading the
other's files, ``.ckp`` regions and token tables; ``ScoreTokenizer``;
``load_kun_model`` and ``bubble`` on a tiny ``.kun`` against the JAX CLI.
Inputs are made with numpy from seeds.
"""
import csv
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from koifish_tpu.cli import bubble as jbubble
from koifish_tpu.config import ModelCard as JModelCard
from koifish_tpu.data import tokenizer as jtok
from koifish_tpu.io import hf_loader as jhf
from koifish_tpu.io import kun as jkun

from koifish_tpu_torch.cli import bubble
from koifish_tpu_torch.data import tokenizer as ttok
from koifish_tpu_torch.io import hf_loader as thf
from koifish_tpu_torch.io import kun as tkun
from koifish_tpu_torch.io.safetensors import read_safetensors

from helpers import make_hf_qwen3_dir
from torch_helpers import jax_tree_to_numpy, torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


CONFIGS = [
    {"model": {"arch": "QWEN3", "layer": 2}, "seed": 42},
    {"a": None, "t": True, "f": False, "i": [0, 127, 128, 255, 256, 65535,
                                             65536, 2 ** 32, -1, -32, -33,
                                             -128, -129, -32768, -32769,
                                             -2 ** 31 - 1],
     "x": 1.5e-7, "s": "é" * 40, "long": "k" * 300, "b": b"\x00\x01" * 200,
     "arr": list(range(20)), "big": {str(i): i for i in range(20)}},
]


@pytest.mark.parametrize("cfg", CONFIGS, ids=["small", "every_type"])
def test_msgpack_matches_jax(cfg):
    """The encoder's bytes are the JAX codec's; each decodes the other's."""
    b = tkun.msgpack_encode(cfg)
    assert b == jkun.msgpack_encode(cfg)
    assert tkun.msgpack_decode(b) == jkun.msgpack_decode(b) == cfg


def _np_tensors(seed: int):
    rng = np.random.default_rng(seed)
    return {
        "model.embed_tokens.weight": (rng.standard_normal((12, 8)) * 0.02
                                      ).astype(ml_dtypes.bfloat16),
        "model.norm.weight": np.ones((8,), np.float32),
        "h16": rng.standard_normal((3, 5)).astype(np.float16),
        "i32": rng.integers(-9, 9, (4,)).astype(np.int32),
        "u8": rng.integers(0, 255, (2, 3)).astype(np.uint8),
    }


def _to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.contiguous().numpy().view(np.uint8)


@pytest.mark.parametrize("ckp", [False, True], ids=["kun", "ckp"])
def test_write_kun_bytes_match_jax(tmp_path, ckp):
    """``write_kun`` of the same tensors and config (and f32 moments, which
    both round to bf16) writes the JAX writer's file byte for byte."""
    nt = _np_tensors(3)
    rng = np.random.default_rng(4)
    moms = ({k: (rng.standard_normal(v.shape).astype(np.float32),
                 rng.random(v.shape).astype(np.float32))
             for k, v in nt.items() if k.startswith("model.")}
            if ckp else None)
    cfg = CONFIGS[0]
    jpath, tpath = str(tmp_path / "j.kun"), str(tmp_path / "t.kun")
    jkun.write_kun(jpath, cfg, nt, moments=moms)
    tkun.write_kun(tpath, cfg, {k: _to_torch(v) for k, v in nt.items()},
                   moments=None if moms is None else {
                       k: (torch.from_numpy(m), torch.from_numpy(v))
                       for k, (m, v) in moms.items()})
    assert open(tpath, "rb").read() == open(jpath, "rb").read()


def test_each_package_reads_the_others_kun_and_ckp(tmp_path):
    """A ``.ckp`` written by each package read by the other: the config,
    every entry's dtype name, shape and data bits, and the bf16 m / v
    regions; a hand-set gama region is read as bf16 by both."""
    nt = _np_tensors(5)
    rng = np.random.default_rng(6)
    moms = {k: (rng.standard_normal(v.shape).astype(np.float32),
                rng.random(v.shape).astype(np.float32))
            for k, v in nt.items() if k.startswith("model.")}
    cfg = CONFIGS[0]
    jpath, tpath = str(tmp_path / "j.ckp"), str(tmp_path / "t.ckp")
    jkun.write_kun(jpath, cfg, nt, moments=moms)
    tkun.write_kun(tpath, cfg, {k: _to_torch(v) for k, v in nt.items()},
                   moments={k: (torch.from_numpy(m), torch.from_numpy(v))
                            for k, (m, v) in moms.items()})
    for path in (jpath, tpath):
        jc, jt = jkun.read_ckp(path)
        tc, tt = tkun.read_ckp(path)
        assert jc == tc == cfg and sorted(jt) == sorted(tt) == sorted(nt)
        for name in nt:
            a, b = jt[name], tt[name]
            assert b.dtype_name == a.dtype_name and b.shape == a.shape
            assert tuple(b.data.shape) == a.data.shape
            assert np.array_equal(_bits(b.data),
                                  np.ascontiguousarray(a.data).view(np.uint8))
            for x, y in ((a.m, b.m), (a.v, b.v)):
                if x is None:
                    assert y is None
                else:
                    assert y.dtype == torch.bfloat16
                    assert np.array_equal(_bits(y), x.view(np.uint8))
    # a region with a bf16 gama block between data and moments
    g = np.arange(6, dtype=np.float32).astype(ml_dtypes.bfloat16)
    data = np.arange(8, dtype=np.uint8)
    info = {"dtype": "Q<4>", "shape": [4, 4], "szData": 8, "szGama": 12}
    region = np.concatenate([data, g.view(np.uint8),
                             np.zeros(16, np.uint8)])
    jk = jkun.KunTensor("w", info, region)
    tk = tkun.KunTensor("w", info, region)
    assert np.array_equal(tk.data.numpy(), jk.data)
    assert np.array_equal(_bits(tk.gama), jk.gama.view(np.uint8))
    assert tk.m.numel() == jk.m.size == 4


def _table():
    """A byte-level token table with merges and chat specials: ids 0-255
    are the bytes, then the merges, then the specials; merge scores
    -log(rank + 1), as the reference's PreTokenizer writes them."""
    toks = [bytes([b]) for b in range(256)]
    merges = [b"he", b"ll", b"hell", b"hello", b" w", b"or", b"wor",
              b" wor", b"ld", b" world"]
    toks += merges + [b"<|im_start|>", b"<|im_end|>", b"<|endoftext|>"]
    scores = [0.0] * 256 + [-float(np.log(i + 1)) for i in range(len(merges))]
    scores += [0.0] * 3
    return toks, scores


def test_tokenizer_dat_both_ways(tmp_path):
    """``tokenizer.dat`` written by each package: the bytes are the same
    and each reader returns the other's table."""
    toks, scores = _table()
    jp, tp = str(tmp_path / "j.dat"), str(tmp_path / "t.dat")
    jkun.write_tokenizer_dat(jp, toks, scores, bos_id=261, eos_id=267)
    tkun.write_tokenizer_dat(tp, toks, scores, bos_id=261, eos_id=267)
    assert open(jp, "rb").read() == open(tp, "rb").read()
    assert tkun.read_tokenizer_dat(jp) == jkun.read_tokenizer_dat(tp)


TEXTS = ["hello world", "hello, world! hell hello", "héllo… wörld ✓",
         "<|im_start|>user\nhello<|im_end|>", ""]


def test_score_tokenizer_matches_jax(tmp_path):
    """``ScoreTokenizer`` from one ``tokenizer.dat``: encode, decode,
    vocab_size and token_id against the JAX package's."""
    toks, scores = _table()
    path = str(tmp_path / "tokenizer.dat")
    tkun.write_tokenizer_dat(path, toks, scores, bos_id=0, eos_id=0)
    jt = jtok.ScoreTokenizer.from_tokenizer_dat(path)
    tt = ttok.ScoreTokenizer.from_tokenizer_dat(path)
    for text in TEXTS:
        ids = tt.encode(text)
        assert ids == jt.encode(text), text
        assert tt.decode(ids) == jt.decode(ids) == text
    assert tt.encode("hello world") == [259, 265]
    assert tt.vocab_size == jt.vocab_size == len(toks)
    for s in ("<|im_end|>", "hello", "zzz"):
        assert tt.token_id(s) == jt.token_id(s)


TINY = dict(vocab_size=300, n_layer=2, n_embd=128, n_head=2, n_kv_head=1,
            head_dim=64, n_ffn=256, n_ctx=64, max_pos=256)


def _kun_model(tmp_path, card):
    """A tiny Qwen3 ``.kun`` (HF tensor names, embedded config) written by
    the port's writer from a HF folder's tensors, and a ``tokenizer.dat``
    beside it. Returns the ``.kun`` path."""
    hf = tmp_path / "hf"
    hf.mkdir()
    make_hf_qwen3_dir(hf, card)
    tensors, _ = read_safetensors(str(hf / "model.safetensors"))
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
    d = tmp_path / "kun"
    d.mkdir()
    kun = str(d / "model.kun")
    tkun.write_kun(kun, cfg, dict(tensors))
    toks, scores = _table()
    tkun.write_tokenizer_dat(str(d / "tokenizer.dat"), toks, scores, 261, 262)
    return kun


def test_load_kun_model_matches_jax(tmp_path):
    """``load_kun_model`` of a tiny ``.kun``: the card's fields and every
    param bit for bit the JAX loader's; a ``.kun`` without its config and
    a packed entry raise as in the JAX package."""
    card = JModelCard.from_arch("QWEN3", **TINY)
    kun = _kun_model(tmp_path, card)
    jcard, jp, jcfg = jhf.load_kun_model(kun)
    tcard, tp, tcfg = thf.load_kun_model(kun, device="cpu")
    assert tcfg == jcfg
    for f in ("arch", "n_layer", "n_embd", "n_head", "n_kv_head", "head_dim",
              "n_ffn", "vocab_size", "tie_embeddings", "n_ctx", "max_pos"):
        assert getattr(tcard, f) == getattr(jcard, f), f
    jn = jax_tree_to_numpy(jp)
    assert sorted(jn) == sorted(tp)
    for li in range(card.n_layer):
        for k, v in jn["layers"][li].items():
            t = tp["layers"][li][k]
            assert np.array_equal(_bits(t), np.ascontiguousarray(v).view(
                np.uint8)), (li, k)
    assert np.array_equal(_bits(tp["wte"]), jn["wte"].view(np.uint8))
    plain = str(tmp_path / "plain.kun")
    from koifish_tpu_torch.io.safetensors import write_safetensors
    write_safetensors(plain, {"x": torch.zeros(2)})
    with pytest.raises(ValueError, match="__koifish__config__"):
        thf.load_kun_model(plain, device="cpu")
    packed = str(tmp_path / "packed.kun")
    tkun.write_kun(packed, {"model": {"arch": "QWEN3"}},
                   {"w": torch.zeros(8, dtype=torch.uint8)})
    import json
    import struct
    raw = open(packed, "rb").read()
    (n,) = struct.unpack("<Q", raw[:8])
    hdr = json.loads(raw[8:8 + n])
    hdr["w"]["dtype"], hdr["w"]["shape"] = "Q<4>", [4, 4]
    hj = json.dumps(hdr).encode()
    hj += b" " * (-len(hj) % 8)
    with open(packed, "wb") as f:
        f.write(struct.pack("<Q", len(hj)) + hj + raw[8 + n:])
    with pytest.raises(NotImplementedError, match="packed/quantized"):
        thf.load_kun_model(packed, device="cpu")


def test_bubble_on_a_kun_matches_jax(tmp_path, monkeypatch):
    """``bubble --hf model.kun --bits 8 --kv-bits 8 --temperature 0`` with
    the folder's ``tokenizer.dat``: the port's answer row equals the JAX
    CLI's on the same file, and its prompt ids are the JAX
    ``ScoreTokenizer``'s of the rendered ChatML prompt."""
    card = JModelCard.from_arch("QWEN3", **TINY)
    kun = _kun_model(tmp_path, card)
    prompt = "hello world, hello"
    argv = ["--hf", kun, "--prompts", prompt, "--max-new", "10", "--bits",
            "8", "--kv-bits", "8", "--temperature", "0", "--ctx", "128",
            "--device", "cpu"]
    jcsv, tcsv = str(tmp_path / "j.csv"), str(tmp_path / "t.csv")
    assert jbubble.main(argv + ["--csv", jcsv]) in (0, None)
    turns = []
    assert bubble.main(argv + ["--csv", tcsv], turns=turns) == 0
    rows = [list(csv.reader(open(p))) for p in (jcsv, tcsv)]
    assert rows[1][1][:2] == rows[0][1][:2] and rows[1][1][0] == prompt
    from koifish_tpu.data import chat_template as jct
    jt = jtok.ScoreTokenizer.from_tokenizer_dat(
        os.path.join(os.path.dirname(kun), "tokenizer.dat"))
    ids = jt.encode(jct.render([{"role": "user", "content": prompt}],
                               os.path.dirname(kun), "QWEN3"))
    assert turns[0]["prompt_ids"] == ids and len(turns[0]["tokens"]) == 10
