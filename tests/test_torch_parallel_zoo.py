"""PyTorch port vs the JAX package: the model zoo under tensor and pipeline
parallelism, on process meshes of 2 gloo ranks on the CPU.

For each zoo card the JAX package's own run comes first, on its virtual
CPU devices: its GSPMD train step on a ``{"dp": 1, "tp": 2}`` mesh, and
its 1F1B pipeline step on a ``{"pp": 2}`` mesh
(``tests/test_torch_parallel_zoo_pp.py``). Where it trains, the port's
ranks (one spawn a mesh shape, every card in that spawn,
``tests/torch_dist_helpers.zoo_tp_worker`` / ``zoo_pp_worker``) train the
same curve: the losses within ``tests/test_torch_parallel_train.py``'s
1e-2 and the grad norms within the zoo tests' 2e-2 relative. Where it
fails, the port refuses the case, and the test shows the JAX error beside
the port's. Each tolerance is stated with the value measured beside it (on
this CPU)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from koifish_tpu.config import ModelCard as JModelCard
from koifish_tpu.config import TrainCard as JTrainCard
from koifish_tpu.models import init_params as j_init_params
from koifish_tpu.parallel.mesh import make_mesh as j_make_mesh
from koifish_tpu.parallel.pipeline import (make_pp_train_step,
                                           stack_for_pipeline)
from koifish_tpu.parallel.sharding import shard_params as j_shard_params
from koifish_tpu.train import trainer as jtrainer
from koifish_tpu.train.optimizer import init_opt_state
from koifish_tpu.train.sharded import shard_batch as j_shard_batch
from koifish_tpu.train.sharded import shard_train_state as j_shard_state

from koifish_tpu_torch.config import ModelCard
from koifish_tpu_torch.io.convert import params_from_numpy
from koifish_tpu_torch.models import init_params
from koifish_tpu_torch.parallel import pipeline as tpipeline
from koifish_tpu_torch.parallel import sharding as tsh
from koifish_tpu_torch.parallel.multihost import spawn

import torch
import torch_dist_helpers as dh
from torch_helpers import jax_tree_to_numpy, torch_threads

BASE = dict(vocab_size=128, n_layer=2, n_embd=64, n_head=4, n_kv_head=4,
            head_dim=16, n_ffn=128, n_ctx=16, max_pos=32)
MLA = dict(attn="mla", q_lora_rank=16, kv_lora_rank=32, qk_nope_head_dim=16,
           qk_rope_head_dim=8, v_head_dim=16, head_dim=24)
TCARD = dict(batch=8, lr=1e-3, warmup=0, stochastic_round=False)
CURVE_TOL = 1e-2       # tests/test_torch_parallel_train.py's
GNORM_RTOL = 2e-2      # the zoo tests' gradient tolerance
_TR = {"Ctx": 16, "Embed": 64, "Head": 4, "head_dim": 16, "Ffn": 128}


def _hybrid(arch, kv_head, n_qkv=1):
    """QKV FFN layers, a GAU and a BROWN FFN layer (the cards of
    tests/test_torch_zoo_gau_brown.py; ``n_qkv`` QKV layers first)."""
    return {
        "arch": arch, "vocab_size": 128,
        "parameter": {"Layer": n_qkv + 2, "max_pos_embeddings": 32,
                      "transformer": dict(_TR, KVHead=kv_head)},
        "backbone": {
            "embed_tokens": {"Embedding": []},
            f"a *{n_qkv}": {"self_attn": {"QKV": []}, "mlp": {"FFN": []}},
            "g *1": {"GAU": []},
            "b *1": {"self_attn": {"BROWN": []}, "mlp": {"FFN": []}},
            "norm": {"Normal": []}, "output": {"CLASIFY": []}}}


def _cards(name):
    """(JAX card, port card) of a zoo family at tiny widths."""
    if name == "mla":
        return (dataclasses.replace(JModelCard.from_arch("DEEPSEEK", **BASE),
                                    **MLA),
                dataclasses.replace(ModelCard.from_arch("DEEPSEEK", **BASE),
                                    **MLA))
    if name.startswith("hybrid"):
        arch, kv, n = {"hybrid_qwen3": ("QWEN3", 2, 1),
                       "hybrid_gpt2": ("GPT2", 4, 1),
                       "hybrid4_qwen3": ("QWEN3", 2, 2),
                       "hybrid4_gpt2": ("GPT2", 4, 2)}[name]
        return (JModelCard.from_json(_hybrid(arch, kv, n)),
                ModelCard.from_json(_hybrid(arch, kv, n)))
    kw = dict(BASE, token_embeds=(24,)) if name == "llama_vae" else BASE
    arch = name.upper()
    return JModelCard.from_arch(arch, **kw), ModelCard.from_arch(arch, **kw)


def _batches(n=3, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, (1, 8, 17)).astype(np.int32)
            for _ in range(n)]


def _jax_tp(jcard, init, batches):
    """The JAX package's GSPMD step on a dp 1 x tp 2 mesh: (losses, grad
    norms)."""
    tc = JTrainCard(**TCARD)
    st = jtrainer.init_train_state(jcard, tc)
    st = st.__class__(params=jax.tree_util.tree_map(jnp.asarray, init),
                      opt=st.opt, rng=st.rng)
    mesh = j_make_mesh({"dp": 1, "tp": 2})
    st = j_shard_state(st, mesh)
    step = jtrainer.make_train_step(jcard, tc, total_steps=10)
    out = []
    for b in batches:
        st, m = step(st, j_shard_batch({"tokens": jnp.asarray(b)}, mesh))
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return tuple(map(list, zip(*out)))


def _jax_pp(jcard, jp, batches):
    """The JAX package's 1F1B pipeline step on a pp-2 mesh, 4
    micro-batches: (losses, grad norms)."""
    mesh = j_make_mesh({"pp": 2}, devices=jax.devices()[:2])
    sl, ot = stack_for_pipeline(jp, 2)
    opt = init_opt_state({"stages": sl, "other": ot}, "adamw")
    step = make_pp_train_step(jcard, JTrainCard(**TCARD), mesh, 4, 10)
    out = []
    with mesh:
        for b in batches:
            sl, ot, opt, m = step(sl, ot, opt, jnp.asarray(b[0]))
            out.append((float(m["loss"]), float(m["grad_norm"])))
    return tuple(map(list, zip(*out)))


def _run(tmp_path, worker, names, jax_fn):
    """The JAX curves of ``names``, then the port's from one spawn of
    ``worker``: {name: (JAX curve, rank 0's, rank 1's)}."""
    batches = _batches()
    zoo, want = {}, {}
    for i, name in enumerate(names):
        jcard, card = _cards(name)
        jp = j_init_params(jcard, jax.random.PRNGKey(i))
        init = jax_tree_to_numpy(jp)
        want[name] = jax_fn(jcard, init if jax_fn is _jax_tp else jp,
                            batches)
        zoo[name] = dict(model_card=card, tcard=TCARD, init=init,
                         batches=batches)
    torch.save({"zoo": zoo}, str(tmp_path / "inp.pt"))
    out = tmp_path / "out"
    out.mkdir()
    spawn(worker, 2, (str(tmp_path / "inp.pt"), str(out)), device="cpu",
          threads=1, init_dir=str(tmp_path))
    r0, r1 = dh.load_results(str(out), 2)
    return {n: (want[n], r0[n], r1[n]) for n in names}


def _gate(label, want, got):
    gl = np.abs(np.array(got[0]) - np.array(want[0])).max()
    gg = (np.abs(np.array(got[1]) - np.array(want[1]))
          / np.array(want[1])).max()
    print(label, "loss gap", gl, "grad-norm gap", gg)
    assert gl <= CURVE_TOL and gg <= GNORM_RTOL, (label, gl, gg)


TP_ZOO = ("mamba", "guppy", "salmon", "mla", "hybrid_qwen3", "hybrid_gpt2")


def test_zoo_under_tp_trains_jaxs_curves(tmp_path):
    """Under tp 2 the port trains MAMBA, GUPPY, SALMON, MLA and the
    QWEN3 and GPT2 QKV/GAU/BROWN hybrids on the JAX package's GSPMD curves
    (3 steps; measured loss gaps <= 3.2e-4, grad-norm gaps <= 5.9e-4), both
    ranks reporting the same numbers."""
    with torch_threads(1):
        res = _run(tmp_path, dh.zoo_tp_worker, TP_ZOO, _jax_tp)
    for name, (want, g0, g1) in res.items():
        assert g0 == g1, name
        _gate(f"tp {name}", want, g0)


def _one_rank():
    """A one-rank process mesh (no group)."""
    from koifish_tpu_torch.parallel.mesh import ProcessMesh
    return ProcessMesh({"pp": 1}, "cpu")


def _jax_error(fn):
    try:
        fn()
    except Exception as e:     # the JAX package's own failure, shown
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case", ["llama_vae_tp", "guppy_pp", "hybrid_pp",
                                  "hybrid_gpt2_pp"])
def test_refusals_mirror_jax_failures(case):
    """Where the JAX package fails, the port raises, naming the case:
    LLAMA_VAE under tp (JAX's ``shard_params`` reads ``.shape`` of the
    nested evae params: AttributeError), GUPPY under pp (JAX's pipeline
    layers find no ``guppy_rows``: KeyError), and the 4-layer GAU/BROWN
    hybrids under pp (JAX: ValueError, heterogeneous layers)."""
    name = {"llama_vae_tp": "llama_vae", "guppy_pp": "guppy",
            "hybrid_pp": "hybrid4_qwen3",
            "hybrid_gpt2_pp": "hybrid4_gpt2"}[case]
    jcard, card = _cards(name)
    jp = j_init_params(jcard, jax.random.PRNGKey(0))
    if case == "llama_vae_tp":
        err = _jax_error(lambda: j_shard_params(
            jp, j_make_mesh({"dp": 1, "tp": 2})))
        assert err[0] == "AttributeError" and "shape" in err[1]
        with pytest.raises(NotImplementedError, match="LLAMA_VAE under "
                           "tensor parallelism"):
            tsh.local_card(card, 2)
        return
    if case == "guppy_pp":
        err = _jax_error(lambda: _jax_pp(jcard, jp, _batches(1)))
        assert err[0] == "KeyError" and "guppy_rows" in err[1]
        with pytest.raises(NotImplementedError, match="GUPPY under "
                           "pipeline parallelism"):
            tsh.check_parallel_card(card, "pipeline parallelism")
        with pytest.raises(NotImplementedError, match="GUPPY"):
            tpipeline._Stage(card, _one_rank(), "pp", 16, "cpu")
        return
    err = _jax_error(lambda: stack_for_pipeline(jp, 2))
    assert err == ("ValueError",
                   "heterogeneous layers can't be pipeline-stacked")
    tsh.check_parallel_card(card, "pipeline parallelism")   # not refused
    with pytest.raises(ValueError, match="heterogeneous"):
        tpipeline.stack_for_pipeline(init_params(card, device="cpu"), 2)


@pytest.mark.parametrize("name", TP_ZOO)
def test_zoo_param_specs_match_jax(name):
    """Each zoo leaf's spec is the JAX package's PartitionSpec as a tuple:
    MLA's ``o`` and GAU's ``down`` row-parallel, their latent and gating
    projections replicated, Mamba's, BROWN's and Guppy's own leaves
    replicated, the hybrids' QKV and FFN layers Megatron's."""
    from jax.sharding import PartitionSpec as P

    from koifish_tpu.parallel import param_specs as j_param_specs
    from koifish_tpu_torch.parallel import param_specs
    jcard, _ = _cards(name)
    jp = j_init_params(jcard, jax.random.PRNGKey(0))
    js = j_param_specs(jp, "tp")
    ts = param_specs(params_from_numpy(jax_tree_to_numpy(jp), device="cpu"),
                     "tp")
    assert sorted(js) == sorted(ts)
    for k in js:
        if k == "layers":
            for jl, tl in zip(js[k], ts[k]):
                assert sorted(jl) == sorted(tl)
                for n in jl:
                    assert tuple(jl[n]) == tl[n], (n, jl[n], tl[n])
        else:
            assert tuple(js[k]) == ts[k], k
    layer = {"mla": 0, "hybrid_qwen3": 1, "hybrid_gpt2": 1}.get(name)
    if layer is not None:
        lp = ts["layers"][layer]
        row = "o" if name == "mla" else "down"
        assert lp[row] == tuple(P("tp", None))
        for n in ("wq_a", "wkv_b", "upU", "gau_q"):
            if n in lp:
                assert lp[n] == (None, None)
