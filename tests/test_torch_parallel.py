"""PyTorch port vs the JAX package: the process-mesh layer in one process.

``param_specs`` leaf by leaf against the JAX package's PartitionSpecs; the
shards ``shard_params`` cuts and ``gather_params`` joins; a shard's
stochastic rounding against the slice of the whole leaf's, bit for bit;
the planner's plans against the JAX planner's at the same capacity and
reserve; the streamed load on a one-rank mesh against the JAX package's
(bit for bit, multi-chunk, single file and index); and the refusals: the
zoo served under tensor parallelism, ``--pp`` beside other axes, layers
that do not divide into stages, and the method combinations the process
mesh does not take. The multi-process checks are in
``tests/test_torch_parallel_{train,serve,pipeline,zoo,sp}.py``."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from koifish_tpu.config import ModelCard as JModelCard
from koifish_tpu.config import QuantCard as JQuantCard
from koifish_tpu.models import init_params as j_init_params
from koifish_tpu.parallel import param_specs as j_param_specs
from koifish_tpu.parallel import planner as jplanner
from koifish_tpu.quant.apply import quantize_params as j_quantize_params

from koifish_tpu_torch.config import ModelCard, QuantCard
from koifish_tpu_torch.io.convert import params_from_numpy
from koifish_tpu_torch.parallel import ProcessMesh, param_specs, planner
from koifish_tpu_torch.parallel import sharding as tsh
from koifish_tpu_torch.train import optimizer as topt
from koifish_tpu_torch.utils.tree import leaves

from torch_helpers import jax_tree_to_numpy

# the tiny card of tests/test_sharding.py
CARD = dict(vocab_size=512, n_layer=2, n_embd=128, n_head=8, n_kv_head=4,
            head_dim=16, n_ffn=256, n_ctx=64, max_pos=128)
QC = {"self_attn": {"bits": 4}, "mlp": {"bits": 4}, "group_size": 16}


class FakeMesh:
    """A rank's view of a process mesh, for layouts without a group."""

    def __init__(self, shape, coords):
        self.shape, self.coords = shape, coords

    def size(self, a):
        return self.shape.get(a, 1)

    def index(self, a):
        return self.coords.get(a, 0)


def _jparams(quant=False, gpt2=False):
    arch = "GPT2" if gpt2 else "QWEN3"
    kw = dict(CARD, n_kv_head=8) if gpt2 else CARD
    jcard = JModelCard.from_arch(arch, **kw)
    jp = j_init_params(jcard, jax.random.PRNGKey(0))
    if quant:
        jp = j_quantize_params(jp, JQuantCard.from_json(QC), jcard)
    return jcard, jp


def _spec_list(spec):
    """A JAX PartitionSpec (or QTensor of them) as plain tuples."""
    from koifish_tpu.quant.qtensor import QTensor as JQ
    if isinstance(spec, JQ):
        return [tuple(spec.codes), tuple(spec.scales),
                None if spec.zeros is None else tuple(spec.zeros)]
    return tuple(spec)


@pytest.mark.parametrize("case", ["bf16", "bf16_fsdp", "int4", "gpt2_fsdp"])
def test_param_specs_match_jax(case):
    """Every leaf's spec is the JAX package's PartitionSpec as a tuple:
    column-, row-parallel, vocab, biases, replicated, QTensor fields, the
    optional fsdp axis (tests/test_sharding.py:39)."""
    fsdp = "dp" if "fsdp" in case else None
    _, jp = _jparams(quant=case == "int4", gpt2=case.startswith("gpt2"))
    js = j_param_specs(jp, "tp", fsdp)
    tp = params_from_numpy(jax_tree_to_numpy(jp), device="cpu")
    ts = param_specs(tp, "tp", fsdp)
    for k in js:
        if k == "layers":
            for jl, tl in zip(js[k], ts[k]):
                assert sorted(jl) == sorted(tl)
                for n in jl:
                    got = tl[n]
                    got = ([got.codes, got.scales, got.zeros]
                           if hasattr(got, "codes") else got)
                    assert _spec_list(jl[n]) == got, (n, jl[n], got)
        else:
            got = ts[k]
            got = ([got.codes, got.scales, got.zeros]
                   if hasattr(got, "codes") else got)
            assert _spec_list(js[k]) == got, k
    lp = ts["layers"][0]
    if case == "bf16":
        assert lp["q"] == (None, "tp") == tuple(P(None, "tp"))
        assert lp["o"] == ("tp", None) and lp["ln1"] == (None,)
        assert ts["wte"] == ("tp", None)


def test_shards_cut_and_join():
    """``shard_params`` cuts each leaf to the rank's part (packed INT4 codes
    along K at group boundaries) and the parts join to the whole; the local
    card divides heads and FFN; a K split that would cut a group leaves
    the weight whole."""
    _, jp = _jparams(quant=True)
    whole = params_from_numpy(jax_tree_to_numpy(jp), device="cpu")
    parts = []
    for r in range(2):
        m = FakeMesh({"tp": 2}, {"tp": r})
        parts.append(tsh.shard_params(whole, m))
    sh = tsh.leaf_shards(whole, FakeMesh({"tp": 2}, {"tp": 0}))
    for w, a, b, s in zip(leaves(whole), leaves(parts[0]), leaves(parts[1]),
                          sh):
        if not s.sharded:
            assert torch.equal(a, w) and torch.equal(b, w)
            continue
        d = next(i for i, x in enumerate(s.spec) if x is not None)
        assert torch.equal(torch.cat([a, b], d), w)
    o = parts[1]["layers"][0]["o"]
    assert o.shape == (64, 128) and o.codes.shape == (32, 128)
    # the codes of the K shard are the shard's codes: dequantize equal
    np.testing.assert_array_equal(
        o.dequantize(torch.float32).numpy(),
        whole["layers"][0]["o"].dequantize(torch.float32)[64:].numpy())
    # group 128 > K/tp: the row-parallel INT4 weight stays whole
    qc = QuantCard.from_json({"self_attn": {"bits": 4}, "group_size": 128})
    from koifish_tpu_torch.quant.apply import quantize_params
    big = quantize_params(params_from_numpy(jax_tree_to_numpy(
        _jparams()[1]), device="cpu"), qc, None, device="cpu")
    cut = tsh.shard_params(big, FakeMesh({"tp": 2}, {"tp": 1}))
    assert cut["layers"][0]["o"].shape == (128, 128)
    assert cut["layers"][0]["q"].shape == (128, 64)
    lc = tsh.local_card(ModelCard.from_arch("QWEN3", **CARD), 2)
    assert (lc.n_head, lc.n_kv_head, lc.n_ffn) == (4, 2, 128)


def test_cache_and_batch_shards():
    """``shard_cache`` gives each rank its KV heads on tp (and its lanes on
    dp), whose parts join to the whole cache (tests/test_sharding.py:194's
    layout); ``batch_spec`` is JAX's; ``constrain_activations`` takes the
    rank's rows and refuses a batch that does not divide."""
    from koifish_tpu_torch.dtypes import QFormat
    from koifish_tpu_torch.serve import cache_for
    card = ModelCard.from_arch("QWEN3", **CARD)
    cache = cache_for(card, 4, 32, fmt=QFormat.INT8, device="cpu")
    cache.k.copy_(torch.randint(-100, 100, cache.k.shape))
    cache.k_scale.copy_(torch.rand(cache.k_scale.shape))
    cache.pos.copy_(torch.arange(4))
    parts = {}
    for d in range(2):
        for t in range(2):
            m = FakeMesh({"dp": 2, "tp": 2}, {"dp": d, "tp": t})
            parts[d, t] = tsh.shard_cache(cache, m, dp="dp")
    c = parts[1, 0]
    assert c.k.shape == (2, 2, 2, 32, 16) and c.k_scale.shape == (2, 2, 2, 32)
    assert torch.equal(c.pos, cache.pos[2:])
    for name in ("k", "v", "k_scale", "v_scale"):
        rows = [torch.cat([getattr(parts[d, t], name) for t in range(2)], 2)
                for d in range(2)]
        assert torch.equal(torch.cat(rows, 1), getattr(cache, name))
    from koifish_tpu.parallel import batch_spec as j_batch_spec
    assert tsh.batch_spec() == tuple(j_batch_spec())
    x = torch.arange(8 * 3).reshape(8, 3)
    m = FakeMesh({"dp": 4}, {"dp": 3})
    assert torch.equal(tsh.constrain_activations(x, m), x[6:])
    with pytest.raises(ValueError):
        tsh.constrain_activations(x[:6], m)


@pytest.mark.parametrize("spec", [("tp", None), (None, "tp"), ("dp", "tp"),
                                  ("tp",)])
def test_stochastic_round_of_a_shard_is_the_slice(spec):
    """A shard's stochastic rounding hashes each element's index in the
    whole leaf (GSPMD's global iota): the shards' roundings, joined, are
    the whole leaf's bit for bit — a column shard's indices are not
    contiguous — and the whole leaf's is the JAX package's."""
    from koifish_tpu.train import optimizer as jopt
    shape = (48, 40) if len(spec) == 2 else (96,)
    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    key = jax.random.PRNGKey(7)
    seed = int(jax.random.bits(key, (), jnp.uint32))
    whole = topt.stochastic_round(torch.from_numpy(x), seed, torch.bfloat16)
    jw = jopt.stochastic_round(jnp.asarray(x), key, jnp.bfloat16)
    assert np.array_equal(np.asarray(jw).view(np.uint16),
                          whole.view(torch.int16).numpy().view(np.uint16))
    sizes = {"tp": 2, "dp": 2}
    axes = [a for a in spec if a is not None]
    grid = np.zeros(shape, dtype=np.uint16)
    for coords in np.ndindex(*(sizes[a] for a in axes)):
        m = FakeMesh(sizes, dict(zip(axes, coords)))
        s = tsh._shard(shape, spec, m)
        part = tsh.take(torch.from_numpy(x), s)
        got = topt.stochastic_round(part, seed, torch.bfloat16, shard=s)
        idx = tuple(slice(a, a + n) for a, n in zip(s.start, s.local))
        grid[idx] = got.view(torch.int16).numpy().view(np.uint16)
    assert np.array_equal(grid, whole.view(torch.int16).numpy().view(
        np.uint16))


@pytest.mark.parametrize("name", ["gpt2-124m", "qwen2.5-0.5b", "qwen3-0.6b",
                                  "qwen3-8b", "qwen3-32b"])
def test_planner_matches_jax(name):
    """``param_count``, ``plan_serving``, ``plan_training`` and
    ``plan_decode`` give the JAX planner's numbers at the same capacity and
    reserve (the JAX package's 16 GiB and 1.2 GiB passed to the port), and
    the port's defaults are the H100's."""
    jc = JModelCard.preset(name)
    from koifish_tpu_torch.config import ModelCard as TC
    tc = TC.preset(name)
    hbm, res = jplanner.V5E_HBM, jplanner._XLA_RESERVE
    assert planner.param_count(tc) == jplanner.param_count(jc)
    for batch, ctx in ((8, 4096), (32, 1024)):
        a = jplanner.plan_serving(jc, batch, ctx)
        b = planner.plan_serving(tc, batch, ctx, hbm_bytes=hbm, reserve=res)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        a = jplanner.plan_training(jc, batch, ctx, remat=False)
        b = planner.plan_training(tc, batch, ctx, remat=False, hbm_bytes=hbm,
                                  reserve=res)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        a = jplanner.plan_decode(jc, batch, ctx, n_chips=2, layered=False)
        b = planner.plan_decode(tc, batch, ctx, n_chips=2, layered=False,
                                hbm_bytes=hbm, reserve=res)
        assert a == b
    assert planner.H100_HBM == 80 * 1000 ** 3
    # an H100 holds what a v5e chip cannot: Qwen3-8B training on fewer
    t = planner.plan_training(tc, 8, 4096)
    assert t.per_chip_bytes < planner.H100_HBM and t.summary()


def _hf_dirs(tmp_path):
    """A tiny Qwen3 HF folder, and the same weights as a two-file index."""
    import json
    from helpers import make_hf_qwen3_dir
    from koifish_tpu.io.safetensors import read_safetensors, write_safetensors
    single = tmp_path / "single"
    single.mkdir()
    make_hf_qwen3_dir(single, JModelCard.from_arch("QWEN3", **CARD))
    tensors, _ = read_safetensors(str(single / "model.safetensors"))
    names = sorted(tensors)
    half = len(names) // 2
    multi = tmp_path / "multi"
    multi.mkdir()
    wm = {}
    for fname, keys in (("model-00001-of-00002.safetensors", names[:half]),
                        ("model-00002-of-00002.safetensors", names[half:])):
        write_safetensors(str(multi / fname), {k: tensors[k] for k in keys})
        wm.update({k: fname for k in keys})
    with open(multi / "model.safetensors.index.json", "w") as f:
        json.dump({"weight_map": wm}, f)
    (multi / "config.json").write_bytes((single / "config.json").read_bytes())
    return single, multi


def test_stream_load_one_rank_matches_jax(tmp_path, monkeypatch):
    """On a one-rank mesh the streamed load is the JAX package's, leaf for
    leaf and bit for bit, with 128-row chunks (multi-chunk coverage), from
    a single file and from a two-file index
    (tests/test_stream_load.py:38, 258)."""
    from koifish_tpu.io import stream_load as jsl
    from koifish_tpu.parallel import make_mesh as j_make_mesh
    from koifish_tpu_torch.io import stream_load as tsl
    monkeypatch.setattr(jsl, "CHUNK_BYTES", 1)
    monkeypatch.setattr(tsl, "CHUNK_BYTES", 1)
    single, multi = _hf_dirs(tmp_path)
    mesh = ProcessMesh({"tp": 1}, "cpu")
    qc = {"self_attn": {"bits": 4}, "mlp": {"bits": 4}, "group_size": 32}
    _, jp = jsl.load_hf_sharded_quantized(str(single), j_make_mesh({"tp": 2}),
                                          JQuantCard.from_json(qc))
    want = leaves(params_from_numpy(jax_tree_to_numpy(jp), device="cpu"))
    for d in (single, multi):
        _, tp = tsl.load_hf_sharded_quantized(str(d), mesh,
                                              QuantCard.from_json(qc))
        got = leaves(tp)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_refusals():
    """Stream load of GPT2/MoE (as the JAX package), a zoo checkpoint the
    JAX package's loaders cannot map (refused at load, with or without
    ``bubble --tp``), ``--pp`` with dp/tp/sp, layers that do not divide
    into stages or differ, LoRA under tp, and LoRA adapters and LLAMA_VAE
    on any mesh of more than one rank (where the JAX package's
    ``shard_params`` fails; one rank shards nothing) raise, each naming its
    reason. (The zoo's training refusals, which mirror the JAX package's
    failures, are in ``tests/test_torch_parallel_zoo.py``; the JAX side of
    the mesh refusals is in ``tests/test_torch_slice20.py``.)"""
    from koifish_tpu_torch.cli import koifish
    from koifish_tpu_torch.io.hf_loader import refuse_unmapped_zoo
    from koifish_tpu_torch.io.stream_load import load_hf_sharded_quantized
    from koifish_tpu_torch.models import init_params
    from koifish_tpu_torch.models.transformer import _linear_l
    from koifish_tpu_torch.ops.tracectx import TPPolicy, tp_scope
    from koifish_tpu_torch.parallel.pipeline import stack_for_pipeline
    from koifish_tpu_torch.train.sharded import shard_train_state
    from koifish_tpu_torch.train.trainer import init_train_state
    from koifish_tpu_torch.config import TrainCard
    gpt2 = ModelCard.from_arch("GPT2", vocab_size=128, n_layer=1, n_embd=64,
                               n_head=4, n_kv_head=4, head_dim=16,
                               n_ffn=128, n_ctx=32, max_pos=32)
    with pytest.raises(NotImplementedError):
        load_hf_sharded_quantized("/nonexistent", ProcessMesh({}, "cpu"),
                                  card=gpt2)
    mla = ModelCard.from_arch("QWEN3", **dict(CARD, attn="mla",
                                              q_lora_rank=0, kv_lora_rank=32,
                                              qk_nope_head_dim=16,
                                              qk_rope_head_dim=8,
                                              v_head_dim=16))
    with pytest.raises(NotImplementedError, match="map Llama and GPT2 "
                       "tensor names only"):
        refuse_unmapped_zoo(mla, {})
    with pytest.raises(ValueError, match="pipeline alone"):
        koifish.main(["cfg.json", "--pp", "2", "--tp", "2"])
    card = ModelCard.from_arch("QWEN3", **dict(CARD, n_layer=3))
    with pytest.raises(AssertionError):
        stack_for_pipeline(init_params(card, device="cpu"), 2)
    hyb = init_params(ModelCard.from_arch("QWEN3", **CARD), device="cpu")
    hyb["layers"][1]["extra_b"] = torch.zeros(4)
    with pytest.raises(ValueError, match="heterogeneous"):
        stack_for_pipeline(hyb, 2)
    lp = {"o": torch.zeros(64, 128, dtype=torch.bfloat16),
          "o_lora": {"a": torch.zeros(64, 4), "b": torch.zeros(4, 128)}}
    with tp_scope(TPPolicy(group=None, rank=0, size=2, vocab=512)):
        with pytest.raises(NotImplementedError, match="LoRA adapters under "
                           "tensor parallelism"):
            _linear_l(torch.zeros(1, 64, dtype=torch.bfloat16), lp, "o")
    lora = init_params(ModelCard.from_arch("QWEN3", **CARD), device="cpu")
    lora["layers"][0]["q_lora"] = {"a": torch.zeros(64, 4),
                                   "b": torch.zeros(4, 64)}
    st = init_train_state(ModelCard.from_arch("QWEN3", **CARD),
                          TrainCard(batch=2), params=lora, device="cpu")
    for n in (2, 4):        # dp, tp or sp ranks: one check for the product
        with pytest.raises(NotImplementedError, match="LoRA adapters on a "
                           "process mesh.*AttributeError"):
            tsh.check_mesh_params(lora, n)
    shard_train_state(st, ProcessMesh({}, "cpu"))        # one rank: taken
    vcard = ModelCard.from_arch("LLAMA_VAE", **dict(CARD,
                                                    token_embeds=(24,)))
    with pytest.raises(NotImplementedError, match="LLAMA_VAE on a process "
                       "mesh.*evae"):
        tsh.check_mesh_params(init_params(vcard, device="cpu"), 2)
