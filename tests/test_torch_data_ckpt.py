"""The port's token shards, SFT data, checkpoints, eval and structure dump
against the JAX package's, on the CPU at tiny sizes.

Shards and checkpoints must cross between the packages bit for bit in both
directions; batches must be equal element for element; the eval's mean CE
agrees within 1e-2 (bf16 activations round at other points in the two
packages) and HellaSwag picks are equal."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koifish_tpu import data as jdata
from koifish_tpu import evaluate as jeval
from koifish_tpu.config import ModelCard as JModelCard
from koifish_tpu.config import SFTCard as JSFTCard
from koifish_tpu.config import TrainCard as JTrainCard
from koifish_tpu.data.sft import SFTDataset as JSFTDataset
from koifish_tpu.io import checkpoint as jckpt
from koifish_tpu.models import init_params as j_init_params
from koifish_tpu.train import lora as jlora
from koifish_tpu.train import trainer as jtrainer
from koifish_tpu.utils.dump import model_structure as j_model_structure

from koifish_tpu_torch import data as tdata
from koifish_tpu_torch import evaluate as teval
from koifish_tpu_torch.config import ModelCard
from koifish_tpu_torch.config import TrainCard
from koifish_tpu_torch.data.sft import SFTDataset
from koifish_tpu_torch.io import checkpoint as tckpt
from koifish_tpu_torch.io.convert import (params_from_numpy,
                                          train_state_from_numpy)
from koifish_tpu_torch.train import trainer as ttrainer
from koifish_tpu_torch.utils.dump import model_structure
from koifish_tpu_torch.utils.tree import flatten_with_path

from helpers import byte_level_tokenizer_json
from torch_helpers import (jax_train_state_to_numpy, jax_tree_to_numpy,
                           tiny_models, torch_threads)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


TINY = dict(vocab_size=300, n_layer=2, n_embd=64, n_head=4, n_kv_head=2,
            head_dim=16, n_ffn=128, n_ctx=32, max_pos=64)


def _bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# token shards
# ---------------------------------------------------------------------------

SHARD_CASES = {
    "gpt2_uint16": (tdata.MAGIC_GPT2, 50257, np.uint16, False),
    "qwen3_uint32": (tdata.MAGIC_QWEN3, 151936, np.uint32, False),
    "qwen3_masked": (tdata.MAGIC_QWEN3, 151936, np.uint32, True),
    "qwen25_masked_odd": (tdata.MAGIC_QWEN25, 151665, np.uint32, True),
}


@pytest.mark.parametrize("case", sorted(SHARD_CASES))
def test_shards_byte_identical_both_ways(tmp_path, case):
    magic, vocab, dt, masked = SHARD_CASES[case]
    rng = np.random.default_rng(3)
    n = 1001 if "odd" in case else 4096
    toks = rng.integers(0, vocab, n).astype(dt)
    masks = rng.random(n) < 0.4 if masked else None
    tdata.write_shard(str(tmp_path / "t.bin"), toks, magic, vocab, masks)
    jdata.write_shard(str(tmp_path / "j.bin"), toks, magic, vocab, masks)
    assert _bytes(tmp_path / "t.bin") == _bytes(tmp_path / "j.bin")
    for name in ("t.bin", "j.bin"):     # each package reads either file
        jt, jm, ji = jdata.read_shard(str(tmp_path / name))
        tt, tm, ti = tdata.read_shard(str(tmp_path / name))
        np.testing.assert_array_equal(np.asarray(tt), toks)
        np.testing.assert_array_equal(np.asarray(jt), np.asarray(tt))
        assert ji == ti and tt.dtype == dt
        if masked:
            np.testing.assert_array_equal(tm, masks)
            np.testing.assert_array_equal(jm, tm)
        else:
            assert tm is None and jm is None


def _batches_equal(jb, tb):
    jb, tb = list(jb), list(tb)
    assert len(jb) == len(tb) > 0
    for a, b in zip(jb, tb):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("masked,seed,epochs,accum", [
    (False, 42, 1, 1), (False, 7, 2, 2), (True, 42, 1, 1), (True, 3, 2, 2)])
def test_token_batches_match_jax(tmp_path, masked, seed, epochs, accum):
    """Two shards (one masked, one not, in the masked case): the same
    windows in the same order, element for element."""
    rng = np.random.default_rng(5)
    for i in range(2):
        toks = rng.integers(0, 1000, 700 + 300 * i).astype(np.uint32)
        m = (rng.random(len(toks)) < 0.5) if masked and i == 0 else None
        jdata.write_shard(str(tmp_path / f"s_{i}.bin"), toks,
                          jdata.MAGIC_QWEN3, 1000, m)
    pat = str(tmp_path / "s_*.bin")
    jds, tds = jdata.TokenDataset(pat), tdata.TokenDataset(pat)
    assert jds.total == tds.total and jds.files == tds.files
    kw = dict(seed=seed, epochs=epochs, accum=accum)
    _batches_equal(jds.batches(3, 16, **kw), tds.batches(3, 16, **kw))
    if masked:
        assert "loss_mask" in next(iter(tds.batches(3, 16, **kw)))


def test_hellaswag_shard_matches_jax(tmp_path):
    path = str(tmp_path / "hs.bin")
    rng = np.random.default_rng(0)
    recs = []
    for idx in range(4):
        ctx = rng.integers(0, 100, size=int(rng.integers(3, 9))
                           ).astype(np.uint16)
        body = [np.array([int(rng.integers(0, 4)), len(ctx)], np.uint16), ctx]
        for _ in range(4):
            c = rng.integers(0, 100, size=int(rng.integers(1, 6))
                             ).astype(np.uint16)
            body += [np.array([len(c)], np.uint16), c]
        body = np.concatenate(body)
        recs.append(np.concatenate(
            [np.array([65535, (3 + len(body)) * 2, idx], np.uint16), body]))
    header = np.zeros(tdata.tokenset.HEADER_INTS, np.int32)
    header[:3] = (tdata.MAGIC_HELLASWAG, 1, len(recs))
    with open(path, "wb") as f:
        f.write(header.tobytes())
        for r in recs:
            f.write(r.tobytes())
    jout = list(jdata.read_hellaswag_shard(path))
    tout = list(tdata.read_hellaswag_shard(path))
    assert len(jout) == len(tout) == 4
    for (jl, jo), (tl, to) in zip(jout, tout):
        assert jl == tl
        for (jt, jm), (tt, tm) in zip(jo, to):
            np.testing.assert_array_equal(jt, tt)
            np.testing.assert_array_equal(jm, tm)


# ---------------------------------------------------------------------------
# SFT data
# ---------------------------------------------------------------------------

def _tokenizers(tmp_path):
    from koifish_tpu.data import BPETokenizer as JTok
    with open(tmp_path / "tokenizer.json", "w") as f:
        json.dump(byte_level_tokenizer_json(), f)
    return (JTok.from_file(str(tmp_path)),
            tdata.BPETokenizer.from_file(str(tmp_path)))


def test_sft_dataset_matches_jax(tmp_path):
    """Samples (padded to seq_len + 1, mask-less ones dropped, long ones cut)
    and batches, multi-turn and first-exchange only."""
    jtok, ttok = _tokenizers(tmp_path)
    rng = np.random.default_rng(2)
    lines = []
    for i in range(23):
        msgs = [{"role": "user", "content": "hello " * int(rng.integers(1, 9))},
                {"role": "assistant", "content": f"world {i} " * (i % 5)}]
        if i % 3 == 0:
            msgs += [{"role": "user", "content": "again"},
                     {"role": "assistant", "content": "yes " * (i % 7 + 1)}]
        lines.append(json.dumps({"messages": msgs} if i % 2 else msgs))
    p = tmp_path / "chat.jsonl"
    p.write_text("\n".join(lines[:10]) + "\n\n" + "\n".join(lines[10:]) + "\n")
    for multi in (True, False):
        jds = JSFTDataset.from_jsonl(str(p), jtok, 40, pad_id=3,
                                     multi_turn=multi)
        tds = SFTDataset.from_jsonl(str(p), ttok, 40, pad_id=3,
                                    multi_turn=multi)
        assert len(jds) == len(tds) > 10
        for (jt, jm), (tt, tm) in zip(jds.samples, tds.samples):
            np.testing.assert_array_equal(jt, tt)
            np.testing.assert_array_equal(jm, tm)
        _batches_equal(jds.batches(2, seed=9, epochs=2, accum=2),
                       tds.batches(2, seed=9, epochs=2, accum=2))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _jax_lora_state(steps: int = 2):
    """A tiny JAX train state with LoRA adapters after ``steps`` steps
    (moments and step counter off zero), SR off."""
    jcard = JModelCard.from_arch("QWEN3", **TINY)
    params = jlora.add_lora(j_init_params(jcard, jax.random.PRNGKey(0)),
                            JSFTCard(method="lora", lora_rank=4),
                            jax.random.PRNGKey(1))
    tcard = JTrainCard(batch=2, lr=1e-2, warmup=0, stochastic_round=False,
                       dump_every=0)
    st = jtrainer.init_train_state(jcard, tcard, params=params)
    toks = np.random.default_rng(0).integers(0, 300, (steps, 1, 2, 33)
                                             ).astype(np.int32)
    st, _ = jtrainer.train_loop(
        jcard, tcard, st, iter([{"tokens": jnp.asarray(t)} for t in toks]),
        total_steps=10, log_fn=None,
        trainable=jlora.trainable_mask(params, "lora"))
    return jcard, st


def _port_flat(state):
    """{name: tensor} of a port train state in the checkpoint's naming."""
    out = dict(tckpt._flatten(state.params, "params"))
    out.update(tckpt._flatten(state.opt.m, "opt_m"))
    out.update(tckpt._flatten(state.opt.v, "opt_v"))
    return out


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _jax_flat(state):
    return {k: np.asarray(v) for k, v in
            {**jckpt._flatten(state.params, "params"),
             **jckpt._flatten(state.opt.m, "opt_m"),
             **jckpt._flatten(state.opt.v, "opt_v")}.items()}


def _assert_same_bits(jflat, tflat):
    assert sorted(jflat) == sorted(tflat)
    for k, a in jflat.items():
        b = _bits(tflat[k])
        a = a.view(np.int16) if a.dtype.name == "bfloat16" else a
        assert a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_jax_checkpoint_loads_in_port(tmp_path):
    jcard, jst = _jax_lora_state()
    path = str(tmp_path / "j.safetensors")
    jckpt.save_train_state(path, jst, jcard, extra_meta={"iter": 2})
    card = ModelCard.from_arch("QWEN3", **TINY)
    template = ttrainer.init_train_state(card, TrainCard(), params=(
        params_from_numpy(jax_tree_to_numpy(jst.params), device="cpu")))
    st, meta = tckpt.load_train_state(path, template)
    _assert_same_bits(_jax_flat(jst), _port_flat(st))
    assert st.opt.step == int(jst.opt.step) == 2
    assert int(st.opt.spikes) == int(jst.opt.spikes)
    assert json.loads(meta["iter"]) == 2
    key = np.asarray(jst.rng).astype(np.int64)   # [0, seed]
    want = torch.Generator().manual_seed(int(key[0]) << 32 | int(key[1]))
    assert torch.equal(st.gen.get_state(), want.get_state())
    assert tckpt.load_model_card(path) == card


def test_port_checkpoint_loads_in_jax(tmp_path):
    jcard, jst = _jax_lora_state()
    st = train_state_from_numpy(jax_train_state_to_numpy(jst), device="cpu")
    st.gen.manual_seed(12345)
    path = str(tmp_path / "t.safetensors")
    card = ModelCard.from_arch("QWEN3", **TINY)
    tckpt.save_train_state(path, st, card, extra_meta={"iter": 5})
    jtemplate = jtrainer.init_train_state(jcard, JTrainCard(), params=jst.params)
    jloaded, meta = jckpt.load_train_state(path, jtemplate)
    _assert_same_bits(_jax_flat(jloaded), _port_flat(st))
    assert int(jloaded.opt.step) == 2 and json.loads(meta["iter"]) == 5
    assert jloaded.rng.shape == (2,) and jloaded.rng.dtype == jnp.uint32
    # the port reloads its own words into the same generator state
    st2, _ = tckpt.load_train_state(path, st)
    assert torch.equal(st2.gen.get_state(), tckpt.generator_from_words(
        tckpt.rng_words(st.gen)).get_state())
    jloaded_card = jckpt.load_model_card(path)   # tuples come back as lists
    assert dataclasses.asdict(jloaded_card) == json.loads(
        json.dumps(dataclasses.asdict(jcard)))


def test_quantized_model_file_crosses_both_ways(tmp_path):
    """``save_model`` / ``load_model`` of INT4 QTensor params: codes and
    scales bit for bit each way."""
    jcard, card, jp, tp = tiny_models()
    jckpt.save_model(str(tmp_path / "j.safetensors"), jp, jcard)
    tckpt.save_model(str(tmp_path / "t.safetensors"), tp, card)
    from_j = tckpt.load_model(str(tmp_path / "j.safetensors"), tp)
    from_t = jckpt.load_model(str(tmp_path / "t.safetensors"), jp)
    for path, leaf in flatten_with_path(from_j):
        if hasattr(leaf, "codes"):
            jl = jp["layers"][path[1]][path[2]] if path[0] == "layers" \
                else jp[path[0]]
            jt = from_t["layers"][path[1]][path[2]] if path[0] == "layers" \
                else from_t[path[0]]
            for f in ("codes", "scales"):
                np.testing.assert_array_equal(_bits(getattr(leaf, f)),
                                              np.asarray(getattr(jl, f)))
                np.testing.assert_array_equal(np.asarray(getattr(jt, f)),
                                              np.asarray(getattr(jl, f)))
            assert leaf.fmt.value == jl.fmt.value and leaf.codebook is None
    assert tckpt.load_model_card(str(tmp_path / "j.safetensors")) == card


# ---------------------------------------------------------------------------
# eval and structure
# ---------------------------------------------------------------------------

def test_perplexity_and_hellaswag_match_jax(tmp_path):
    jcard = JModelCard.from_arch("QWEN3", **TINY)
    card = ModelCard.from_arch("QWEN3", **TINY)
    jp = j_init_params(jcard, jax.random.PRNGKey(4))
    tp = params_from_numpy(jax_tree_to_numpy(jp), device="cpu")
    rng = np.random.default_rng(0)
    tdata.write_shard(str(tmp_path / "v.bin"),
                      rng.integers(0, 300, 3000).astype(np.uint32),
                      tdata.MAGIC_QWEN3, 300, rng.random(3000) < 0.7)
    jce, jppl = jeval.perplexity(
        jcard, jp, jdata.TokenDataset(str(tmp_path / "v.bin")).batches(4, 32),
        max_batches=3)
    tce, tppl = teval.perplexity(
        card, tp, tdata.TokenDataset(str(tmp_path / "v.bin")).batches(4, 32),
        max_batches=3)
    assert abs(jce - tce) <= 1e-2 and abs(tppl - np.exp(tce)) < 1e-6 * tppl
    samples = []
    for _ in range(12):
        opts = []
        for _ in range(4):
            t = rng.integers(0, 300, 14).astype(np.int32)
            m = np.zeros(14, bool)
            m[7:] = True
            opts.append((t, m))
        samples.append((int(rng.integers(0, 4)), opts))
    jl = [float(x) for x in jeval._option_losses(
        jcard, jp, jnp.asarray(np.stack([o[0] for o in samples[0][1]])),
        jnp.asarray(np.stack([o[1] for o in samples[0][1]])))]
    tl = teval._option_losses(
        card, tp, torch.from_numpy(np.stack([o[0] for o in samples[0][1]])
                                   ).long(),
        torch.from_numpy(np.stack([o[1] for o in samples[0][1]])))
    np.testing.assert_allclose(tl.numpy(), jl, atol=1e-2)
    assert jeval.hellaswag_accuracy(jcard, jp, samples, seq_len=16) == \
        teval.hellaswag_accuracy(card, tp, samples, seq_len=16)


def test_model_structure_matches_jax():
    jcard, card, jq, tq = tiny_models()     # INT4 QTensors
    assert model_structure(tq) == j_model_structure(jq)
    jp = jlora.add_lora(j_init_params(jcard, jax.random.PRNGKey(0)),
                        JSFTCard(method="lora", lora_rank=8),
                        jax.random.PRNGKey(1))
    tp = params_from_numpy(jax_tree_to_numpy(jp), device="cpu")
    assert model_structure(tp) == j_model_structure(jp)
    assert "layers.0.q_lora.a" in model_structure(tp)
