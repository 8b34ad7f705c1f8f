"""The port's native host layer (``koifish_tpu_torch/native.py``) against
its Python paths and the JAX package's bindings (``tests/test_native.py``
for the port): the library is built from ``native/*.cpp`` into
``build/native/`` by the port itself, the BPE engine gives the Python
BPE's ids and JAX ``NativeBPE``'s, the shard gather and the batch server
give the Python path's tokens element for element, the safetensors reader
the ``io/safetensors.py`` reader's bytes, and a library that cannot be had
is logged as a fallback before the Python path runs."""
import numpy as np
import pytest
import torch

from koifish_tpu import native as jnative
from koifish_tpu.data import tokenizer as jtok
from koifish_tpu.data.tokenset import TokenDataset as JTokenDataset

from koifish_tpu_torch import native
from koifish_tpu_torch.data import (MAGIC_GPT2, MAGIC_QWEN3, TokenDataset,
                                    write_shard)
from koifish_tpu_torch.data.tokenizer import BPETokenizer
from koifish_tpu_torch.io.kun import write_kun
from koifish_tpu_torch.io.safetensors import (read_safetensors,
                                              write_safetensors)
from koifish_tpu_torch.utils import kernel_log

from helpers import byte_level_tokenizer_json

TEXTS = ["hello", " world", "hello world hello", "héllo 世界", "x" * 500,
         "hello<|im_end|>hello world", "  spaces\tand\nlines 123 4567"]


def _tokenizers():
    tj = byte_level_tokenizer_json()
    vocab = tj["model"]["vocab"]
    merges = [tuple(m.split(" ", 1)) for m in tj["model"]["merges"]]
    special = {t["content"]: t["id"] for t in tj["added_tokens"]}
    return (BPETokenizer(vocab, merges, special_tokens=special),
            jtok.BPETokenizer(vocab, merges, special_tokens=special))


def test_library_is_built_from_the_sources_into_build():
    """The port builds its own library (``g++ -O3 -fPIC -std=c++17 -shared
    -lpthread``) under a name keyed by the sources' digest; it never loads
    the tracked ``native/libkoifish_native.so``."""
    lib = native.load_native()
    assert lib is not None and native.native_available()
    path = native.lib_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.parent.name == "native" and path.parent.parent.name == \
        "build"
    assert path.name.startswith("libkoifish_native-") and \
        path.name != "libkoifish_native.so"
    assert lib._name == str(path)


def test_native_bpe_matches_python_and_jax():
    """Pretoken by pretoken, the C++ merge engine gives the port's Python
    BPE ids and the JAX package's ``NativeBPE`` ids (where its library
    loads)."""
    tk, jtk = _tokenizers()
    engine = native.NativeBPE(tk)
    jengine = jnative.NativeBPE(jtk) if jnative.native_available() else None
    for t in TEXTS:
        pretokens = [m.group() for m in tk.pat.finditer(t)]
        py = [i for p in pretokens for i in tk._bpe(p)]
        assert engine.encode_pretokens(pretokens) == py, t
        if jengine is not None:
            assert jengine.encode_pretokens(pretokens) == py, t


def test_tokenizer_takes_the_native_engine():
    """``BPETokenizer.encode`` goes through the engine (its calls counted)
    and gives the ids of the Python path and of the JAX tokenizer."""
    tk, jtk = _tokenizers()
    py, _ = _tokenizers()
    py._native_tried = True                    # the Python path
    native.reset_calls()
    for t in TEXTS:
        ids = tk.encode(t)
        assert ids == py.encode(t) == jtk.encode(t), t
        assert tk.decode(ids) == t
    assert tk._native is not None and native.calls()["bpe"] >= len(TEXTS)


def test_a_missing_library_is_logged_and_the_python_path_runs(tmp_path,
                                                               monkeypatch):
    """No silent fallback: where the library cannot be had the tokenizer
    and the batch server log ``kernel_log.fallback`` and give the same
    ids and batches from Python."""
    tk, _ = _tokenizers()
    want = tk.encode("hello world")
    write_shard(str(tmp_path / "s0.bin"),
                (np.arange(3000) * 7 % 997).astype(np.uint32), MAGIC_QWEN3)
    ds = TokenDataset(str(tmp_path / "s*.bin"))
    batches = [b["tokens"] for b in ds.batches(4, 32, seed=3)]
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    monkeypatch.setattr(native, "_error", "RuntimeError: no g++")
    kernel_log.reset_launches()
    tk2, _ = _tokenizers()
    assert tk2.encode("hello world") == want
    got = [b["tokens"] for b in ds.batches(4, 32, seed=3)]
    assert len(got) == len(batches) and all(
        np.array_equal(a, b) for a, b in zip(got, batches))
    assert kernel_log.fallbacks() == {"native_bpe": 1,
                                      "native_batchserver": 1}


def test_native_shard_gather(tmp_path):
    """``NativeShard.gather`` on uint32 and uint16 shards: the windows of
    the shard, as int32; a window outside the shard raises."""
    toks = (np.arange(5000) * 7 % 997).astype(np.uint32)
    p = str(tmp_path / "s.bin")
    write_shard(p, toks, MAGIC_QWEN3, vocab_size=997)
    sh = native.NativeShard(p)
    assert sh.count == 5000 and sh.bpt == 4
    offs = np.array([0, 100, 4900], np.int64)
    out = sh.gather(offs, 100)
    for i, o in enumerate(offs):
        np.testing.assert_array_equal(out[i],
                                      toks[o:o + 100].astype(np.int32))
    p2 = str(tmp_path / "g.bin")
    write_shard(p2, (np.arange(1000) % 50000).astype(np.uint16), MAGIC_GPT2)
    sh2 = native.NativeShard(p2)
    assert sh2.bpt == 2
    np.testing.assert_array_equal(sh2.gather(np.array([10], np.int64),
                                             20)[0],
                                  np.arange(10, 30, dtype=np.int32))
    with pytest.raises(OSError):
        native.NativeShard(str(tmp_path / "missing.bin"))
    for bad in ([4901], [-1]):           # past the end, before the start
        with pytest.raises(IndexError):
            sh.gather(np.array(bad, np.int64), 100)


@pytest.mark.parametrize("accum", [1, 2])
def test_batch_server_matches_the_python_path_and_jax(tmp_path, accum):
    """``TokenDataset.batches`` on unmasked shards takes the C++ prefetch
    server (its batches counted) and yields the Python path's batches
    element for element, and the JAX package's: same shards, seed and
    order, two epochs."""
    rng = np.random.default_rng(0)
    for i in range(2):
        write_shard(str(tmp_path / f"s{i}.bin"),
                    rng.integers(0, 50000, size=4000, dtype=np.uint32),
                    MAGIC_QWEN3)
    pat = str(tmp_path / "s*.bin")
    native.reset_calls()
    got = [b["tokens"] for b in TokenDataset(pat).batches(
        batch=4, seq_len=64, seed=7, epochs=2, accum=accum)]
    assert native.calls()["batchserver"] == len(got) > 4
    ds2 = TokenDataset(pat)          # masks present: the Python path
    ds2.shards = [(t, np.ones(len(t), bool)) for t, _ in ds2.shards]
    python = [b["tokens"] for b in ds2.batches(batch=4, seq_len=64, seed=7,
                                               epochs=2, accum=accum)]
    jax_side = [b["tokens"] for b in JTokenDataset(pat).batches(
        batch=4, seq_len=64, seed=7, epochs=2, accum=accum)]
    assert len(got) == len(python) == len(jax_side)
    for a, b, c in zip(got, python, jax_side):
        assert a.dtype == b.dtype == np.int32 and a.shape == (accum, 4, 65)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_native_safetensors_matches_the_reader(tmp_path):
    """The C++ mmap'd parser gives ``io/safetensors.py``'s tensors, bf16
    included, bit for bit; and the ``.kun`` dialect (a msgpack config
    tensor, extra keys) parses."""
    g = torch.Generator().manual_seed(0)
    tensors = {"a.weight": torch.randn(33, 16, generator=g),
               "b/bias": torch.randn(8, generator=g).to(torch.bfloat16),
               "c": torch.randint(0, 255, (4, 4), generator=g,
                                  dtype=torch.uint8)}
    p = str(tmp_path / "m.safetensors")
    write_safetensors(p, tensors, metadata={"x": "1"})
    reader = native.NativeSafetensors(p)
    got = reader.tensors()
    ref, _ = read_safetensors(p)
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and torch.equal(got[k], ref[k])
    kp = str(tmp_path / "m.kun")
    write_kun(kp, {"seed": 1}, {"w": tensors["a.weight"]})
    kt = native.NativeSafetensors(kp).tensors()
    assert "__koifish__config__" in kt
    assert torch.equal(kt["w"], tensors["a.weight"])
