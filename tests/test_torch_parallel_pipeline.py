"""PyTorch port vs the JAX package: pipeline parallelism on a process mesh
of 2 gloo ranks on the CPU (one spawn, ``tests/torch_dist_helpers.
pp_worker``): the pipeline's logits against the one-device forward within
the JAX test's 3e-2 (tests/test_pipeline.py:20; measured 3.9e-3); 1F1B's
loss and grads equal GPipe's bit for bit (:147); the forward-only loss
equals them; and both schedules' train steps follow the JAX package's
``make_pp_train_step`` curve within the port's loss-curve tolerance, 1e-2
(:170; measured 4.0e-4), and train the same params bit for bit; only the
last stage calls the head, once a micro-batch (:197); ``koifish --pp 2``
trains (:71). Each tolerance is stated with the value measured beside it
(on this CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from koifish_tpu.config import ModelCard as JModelCard
from koifish_tpu.config import TrainCard as JTrainCard
from koifish_tpu.models import init_params as j_init_params
from koifish_tpu.models import model_forward as j_model_forward
from koifish_tpu.parallel.mesh import make_mesh as j_make_mesh
from koifish_tpu.parallel.pipeline import (make_pp_train_step,
                                           stack_for_pipeline)
from koifish_tpu.train.optimizer import init_opt_state

from koifish_tpu_torch.parallel.multihost import spawn

import torch_dist_helpers as dh
from torch_helpers import jax_tree_to_numpy

PP_CARD = dict(vocab_size=128, n_layer=4, n_embd=64, n_head=4, n_kv_head=2,
               head_dim=16, n_ffn=128, n_ctx=32, max_pos=64)
PP_TCARD = dict(batch=8, lr=0.01, warmup=3, stochastic_round=False)


def _pp_batches(n=4):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        s = rng.integers(0, 64, (8, 1))
        out.append(((s + np.arange(17)[None]) % 64).astype(np.int32))
    return out


def test_pp_group(tmp_path):
    jcard = JModelCard.from_arch("QWEN3", **PP_CARD)
    jp = j_init_params(jcard, jax.random.PRNGKey(0))
    init = jax_tree_to_numpy(jp)
    prompt = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 16),
                                           0, 128))
    ref = np.asarray(j_model_forward(jcard, jp, jnp.asarray(prompt)),
                     np.float32)
    batches = _pp_batches()
    mesh = j_make_mesh({"pp": 2}, devices=jax.devices()[:2])
    sl, ot = stack_for_pipeline(jp, 2)
    opt = init_opt_state({"stages": sl, "other": ot}, "adamw")
    step = make_pp_train_step(jcard, JTrainCard(**PP_TCARD), mesh, 4, 20)
    jl = []
    with mesh:
        for b in batches:
            sl, ot, opt, m = step(sl, ot, opt, jnp.asarray(b))
            jl.append(float(m["loss"]))
    from test_torch_parallel_train import _cfg
    inp = dict(arch="QWEN3", card=PP_CARD, tcard=PP_TCARD, init=init,
               cfg=_cfg(tmp_path, steps=6),
               prompt=prompt, pp_tokens=np.asarray(
                   jax.random.randint(jax.random.PRNGKey(1), (8, 17), 0,
                                      128)),
               pp_batches=batches)
    torch.save(inp, str(tmp_path / "inp.pt"))
    out = tmp_path / "out"
    out.mkdir()
    spawn(dh.pp_worker, 2, (str(tmp_path / "inp.pt"), str(out)),
          device="cpu", threads=1, init_dir=str(tmp_path))
    r0, r1 = dh.load_results(str(out), 2)
    gap = np.abs(r0["logits"] - ref).max()
    print("pipeline logits gap", gap)
    assert gap <= 3e-2 and np.array_equal(r0["logits"], r1["logits"])
    assert (r0["head_calls"], r1["head_calls"]) == (0, 4)
    for r in (r0, r1):
        assert r["grads_equal"]
        assert r["loss_gpipe"] == r["loss_1f1b"] == r0["loss_1f1b"]
        assert r["fwd_loss"] == r["loss_gpipe"]
    for sched in ("1f1b", "gpipe"):
        tl = np.array(r0["curve_" + sched][0])
        gap = np.abs(tl - np.array(jl)).max()
        print(sched, "curve gap to JAX", gap, tl)
        assert gap <= 1e-2 and tl[-1] < tl[0]
        assert r1["curve_" + sched][0] == r0["curve_" + sched][0]
    # koifish --pp 2 (1f1b) trains: the loss falls, every stage reports it
    assert r0["cli"] == r1["cli"] and r0["cli"][-1] < r0["cli"][0]
    # the two schedules train the same params bit for bit
    assert np.array_equal(r0["curve_1f1b"][1], r0["curve_gpipe"][1])
    for a, b in zip(r1["curve_1f1b"][2], r1["curve_gpipe"][2]):
        assert np.array_equal(a, b)
