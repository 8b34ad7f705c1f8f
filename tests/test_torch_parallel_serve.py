"""PyTorch port vs the JAX package: tensor and expert parallelism, and the
streamed sharded load, on a process mesh of 2 gloo ranks on the CPU.

One spawn (``tests/torch_dist_helpers.tp_worker``) runs every check of the
tp group: a tp=2 training curve; TP prefill and decode logits, bf16 and
INT4 g16, against the JAX package's within its own 2e-2
(tests/test_sharding.py:194); a MoE card with its experts split over the
ranks; the streamed load's shards, gathered, against the JAX package's
streamed load bit for bit (multi-chunk, single file and index,
tests/test_stream_load.py:38, 258) and their prefill; a whole checkpoint
resumed under tp; and ``bubble --tp 2`` with and without ``--bits``
against the one-rank ``bubble``. Each tolerance is stated with the value
measured beside it (on this CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from koifish_tpu.config import ModelCard as JModelCard
from koifish_tpu.config import QuantCard as JQuantCard
from koifish_tpu.models import init_params as j_init_params
from koifish_tpu.models import model_forward as j_model_forward
from koifish_tpu.quant.apply import quantize_params as j_quantize_params
from koifish_tpu.serve import cache_for as j_cache_for
from koifish_tpu.serve import decode_step as j_decode_step
from koifish_tpu.serve import prefill as j_prefill

from koifish_tpu_torch.config import ModelCard, TrainCard
from koifish_tpu_torch.io import save_train_state
from koifish_tpu_torch.io.convert import params_from_numpy
from koifish_tpu_torch.parallel import sharding as tsh
from koifish_tpu_torch.parallel.multihost import spawn
from koifish_tpu_torch.train import trainer as ttrainer
from koifish_tpu_torch.utils.tree import leaves

import torch_dist_helpers as dh
from test_torch_parallel import CARD, FakeMesh, _hf_dirs
from test_torch_parallel_train import TCARD, _batches, _jax_curve
from torch_helpers import (LOGIT_TOL, assert_greedy_agrees,
                           jax_tree_to_numpy, top2_margin)

MOE_CARD = dict(vocab_size=256, n_layer=2, n_embd=128, n_head=4,
                n_kv_head=2, head_dim=32, n_ffn=256, n_ctx=64, max_pos=128,
                n_experts=4, n_experts_active=2, moe_ffn=64)
MOE_TOL = 5e-2          # tests/test_torch_zoo.py's MoE logit tolerance
STREAM_QC = {"self_attn": {"bits": 4}, "mlp": {"bits": 4}, "group_size": 32}
INT4_G16 = {"self_attn": {"bits": 4}, "mlp": {"bits": 4}, "group_size": 16}


def _gather_shards(whole_port, parts):
    """Join two ranks' leaves along each leaf's tp dim (the layout
    ``leaf_shards`` gives the whole tree)."""
    out = []
    sh = tsh.leaf_shards(whole_port, FakeMesh({"tp": 2}, {"tp": 0}))
    for s, a, b in zip(sh, parts[0], parts[1]):
        if not s.sharded:
            assert np.array_equal(a, b)
            out.append(a)
        else:
            d = next(i for i, x in enumerate(s.spec) if x is not None)
            out.append(np.concatenate([a, b], d))
    return out


def _bubble_one_rank(hf, bits):
    from koifish_tpu_torch.cli import bubble
    turns = []
    bubble.main(["--hf", hf, "--device", "cpu", "--bits", bits,
                 "--temperature", "0", "--max-new", "8", "--ctx", "96",
                 "--prompts", "hi", "--csv", ""], turns)
    return turns[0]["prompt_ids"], turns[0]["tokens"]


def _margins(hf, bits, ids, toks):
    """The one-rank port's top-2 margins along its own greedy tokens
    (teacher-forced): [N, 1]."""
    from koifish_tpu_torch.cli.bubble import _weight_qcard
    from koifish_tpu_torch.io.hf_loader import load_hf_model
    from koifish_tpu_torch.quant.apply import quantize_params
    from koifish_tpu_torch.serve import cache_for, prefill
    card, p = load_hf_model(hf, device="cpu")
    if bits != "0":
        p = quantize_params(p, _weight_qcard(int(bits)), card, device="cpu")
    seq = torch.tensor([list(ids) + list(toks)], dtype=torch.int64)
    with torch.no_grad():
        lg, _ = prefill(card, p, seq, cache_for(card, 1, seq.shape[1],
                                                device="cpu"),
                        return_all_logits=True, device="cpu")
    rows = lg[0, len(ids) - 1: len(ids) - 1 + len(toks)]
    return top2_margin(rows)[:, None]


def test_tp_group(tmp_path, monkeypatch):
    jcard = JModelCard.from_arch("QWEN3", **CARD)
    card = ModelCard.from_arch("QWEN3", **CARD)
    jp = j_init_params(jcard, jax.random.PRNGKey(0))
    init = jax_tree_to_numpy(jp)
    batches = _batches()
    curve = _jax_curve(jcard, init, batches)
    prompt = jax.random.randint(jax.random.PRNGKey(1), (2, 6), 0, 512)
    # JAX single-device serving (tests/test_sharding.py:194)
    c0 = j_cache_for(jcard, 2, 32)
    l0, c0 = j_prefill(jcard, jp, prompt, c0)
    bf16 = [np.asarray(l0)]
    for t in range(3):
        l0, c0 = j_decode_step(jcard, jp, jnp.full((2,), t + 7, jnp.int32),
                               c0)
        bf16.append(np.asarray(l0))
    jq = j_quantize_params(jp, JQuantCard.from_json(INT4_G16), jcard)
    int4, _ = j_prefill(jcard, jq, prompt, j_cache_for(jcard, 2, 32))
    # the MoE card
    jmoe = JModelCard.from_arch("QWEN3_MOE", **MOE_CARD)
    jmp = j_init_params(jmoe, jax.random.PRNGKey(3))
    moe_init = jax_tree_to_numpy(jmp)
    moe_logits = np.asarray(j_model_forward(jmoe, jmp, prompt % 256))
    moe_batches = [b % 256 for b in batches[:2]]
    moe_curve = _jax_curve(jmoe, moe_init, moe_batches)
    # the streamed load, JAX's
    from koifish_tpu.io import stream_load as jsl
    from koifish_tpu.parallel import make_mesh as j_make_mesh
    monkeypatch.setattr(jsl, "CHUNK_BYTES", 1)
    single, multi = _hf_dirs(tmp_path)
    _, jst = jsl.load_hf_sharded_quantized(str(single),
                                           j_make_mesh({"tp": 2}),
                                           JQuantCard.from_json(STREAM_QC))
    jst_np = jax_tree_to_numpy(jst)
    stream_prefill, _ = j_prefill(jcard, jst, prompt,
                                  j_cache_for(jcard, 2, 32))
    # a whole checkpoint, resumed under tp
    st = ttrainer.init_train_state(card, TrainCard(**TCARD),
                                   params=params_from_numpy(init,
                                                            device="cpu"))
    save_train_state(str(tmp_path / "ckpt.safetensors"), st, card)

    inp = dict(arch="QWEN3", card=CARD, tcard=TCARD, init=init,
               batches=batches, prompt=np.asarray(prompt),
               int4=jax_tree_to_numpy(jq),
               moe=dict(arch="QWEN3_MOE", card=MOE_CARD, tcard=TCARD,
                        batches=moe_batches),
               moe_init=moe_init, qc=STREAM_QC,
               hf={"single": str(single), "multi": str(multi)},
               ckpt=str(tmp_path / "ckpt.safetensors"))
    torch.save(inp, str(tmp_path / "inp.pt"))
    out = tmp_path / "out"
    out.mkdir()
    spawn(dh.tp_worker, 2, (str(tmp_path / "inp.pt"), str(out)),
          device="cpu", threads=1, init_dir=str(tmp_path))
    r0, r1 = dh.load_results(str(out), 2)

    # training: tp=2 curve vs JAX (measured 7.6e-5)
    gap = np.abs(np.array(r0["curve"][0]) - curve).max()
    print("tp curve gap", gap)
    assert gap <= 1e-2 and r0["curve"][0] == r1["curve"][0]
    # serving logits, bf16 prefill + 3 decode steps and INT4 g16 prefill,
    # within JAX's 2e-2 (measured ~4e-3 bf16, ~4e-3 INT4)
    for a, b in zip(r0["bf16"], bf16):
        assert np.abs(a - b).max() <= LOGIT_TOL, np.abs(a - b).max()
    assert np.abs(r0["int4"][0] - np.asarray(int4)).max() <= LOGIT_TOL
    for a, b in zip(r0["bf16"], r1["bf16"]):
        assert np.array_equal(a, b)              # every rank has the logits
    # expert parallelism: logits within the zoo's 5e-2 (measured 4.2e-3),
    # curve within 1e-2
    gap = np.abs(r0["moe_logits"] - moe_logits).max()
    print("moe logits gap", gap)
    assert gap <= MOE_TOL
    assert np.abs(np.array(r0["moe_curve"][0]) - moe_curve).max() <= 1e-2
    # the streamed shards, gathered, are JAX's streamed load bit for bit
    whole = params_from_numpy(jst_np, device="cpu")
    want = [x.to(torch.float32).numpy() if x.is_floating_point()
            else x.numpy() for x in leaves(whole)]
    for name in ("single", "multi"):
        got = _gather_shards(whole, [r0["stream_" + name],
                                     r1["stream_" + name]])
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        # each rank reads its shards of the checkpoint, not all of it
        for r in (r0, r1):
            read, whole_bytes = r["stream_read_" + name]
            print("streamed", name, "read", read, "of", whole_bytes)
            assert 0 < read <= 0.55 * whole_bytes
    gap = np.abs(r0["stream_prefill"] - np.asarray(stream_prefill)).max()
    assert gap <= LOGIT_TOL, gap
    assert r0["resume_equal"] and r1["resume_equal"]
    # bubble --tp 2 against the one-rank bubble: greedy tokens agree up to
    # the first near-tie (torch_helpers.assert_greedy_agrees)
    for bits in ("0", "4"):
        ids, toks = _bubble_one_rank(str(single), bits)
        tids, ttoks = r0["bubble" + bits]
        assert list(tids) == list(ids) and r1["bubble" + bits] == (tids,
                                                                   ttoks)
        assert_greedy_agrees(np.array([ttoks]), np.array([toks]),
                             _margins(str(single), bits, ids, toks))
