"""PyTorch port vs the JAX package: sequence parallelism beside data and
tensor parallelism, one rank a process, on 4 gloo ranks on the CPU (one
spawn, ``tests/torch_dist_helpers.sp_worker``).

The JAX package trains through its plain ring on one ``{"dp", "tp",
"sp"}`` mesh of its virtual CPU devices (``koifish_tpu/cli/koifish.py:
213-239``); the port's ranks train the same curves (dp 2 x sp 2, tp 2 x sp
2) within ``tests/test_torch_parallel_train.py``'s 1e-2, their grad norms
within 1e-2 relative. Every sp rank holds the one-controller ring's
gradients bit for bit, which a plain slice in place of ``comm.split_to``
breaks. The process rings, plain and kernel (its CPU path), equal their
one-controller counterparts bit for bit, and the kernel ring's transfers
are its plan's: sp(sp-1)/2, chunk c reaching ranks c..sp-1. Each tolerance
is stated with the value measured beside it (on this CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koifish_tpu.config import ModelCard as JModelCard
from koifish_tpu.config import TrainCard as JTrainCard
from koifish_tpu.models import init_params as j_init_params
from koifish_tpu.ops.tracectx import SPPolicy as JSPPolicy
from koifish_tpu.parallel.mesh import make_mesh as j_make_mesh
from koifish_tpu.train import trainer as jtrainer
from koifish_tpu.train.sharded import shard_batch as j_shard_batch
from koifish_tpu.train.sharded import shard_train_state as j_shard_state

from koifish_tpu_torch.parallel.multihost import spawn

import torch_dist_helpers as dh
from test_torch_parallel_train import CARD, CURVE_TOL, TCARD, _batches, _cfg
from torch_helpers import jax_tree_to_numpy, torch_threads

GNORM_RTOL = 1e-2


def _jax_sp(jcard, init, batches, axes):
    """The JAX package's step on a ``{"dp", "tp", "sp"}`` mesh with its
    ring over sp: (losses, grad norms)."""
    tc = JTrainCard(**TCARD)
    st = jtrainer.init_train_state(jcard, tc)
    st = st.__class__(params=jax.tree_util.tree_map(jnp.asarray, init),
                      opt=st.opt, rng=st.rng)
    mesh = j_make_mesh(axes)
    st = j_shard_state(st, mesh)
    step = jtrainer.make_train_step(jcard, tc, total_steps=10,
                                    sp=JSPPolicy("sp", mesh))
    out = []
    for b in batches:
        st, m = step(st, j_shard_batch({"tokens": jnp.asarray(b)}, mesh))
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return tuple(map(list, zip(*out)))


@pytest.fixture(scope="module")
def sp_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp")
    jcard = JModelCard.from_arch("QWEN3", **CARD)
    init = jax_tree_to_numpy(j_init_params(jcard, jax.random.PRNGKey(0)))
    batches = _batches()
    want = {"dp_sp": _jax_sp(jcard, init, batches,
                             {"dp": 2, "tp": 1, "sp": 2}),
            "tp_sp": _jax_sp(jcard, init, batches,
                             {"dp": 1, "tp": 2, "sp": 2})}
    cfg = _cfg(tmp, steps=3)
    torch.save(dict(arch="QWEN3", card=CARD, tcard=TCARD, init=init,
                    batches=batches, cfg=cfg), str(tmp / "inp.pt"))
    out = tmp / "out"
    out.mkdir()
    with torch_threads(1):
        spawn(dh.sp_worker, 4, (str(tmp / "inp.pt"), str(out)),
              device="cpu", threads=1, init_dir=str(tmp))
    return want, dh.load_results(str(out), 4), cfg, tmp


@pytest.mark.parametrize("name", ["dp_sp", "tp_sp"])
def test_sp_beside_dp_and_tp_trains_jaxs_curve(sp_run, name):
    """dp 2 x sp 2 and tp 2 x sp 2 train the JAX package's curve on its
    {"dp", "tp", "sp"} mesh: losses within 1e-2 (measured 2.1e-4 and
    1.7e-4), grad norms within 1e-2 relative (measured 1.4e-4 and
    1.5e-4); every rank reports the same numbers."""
    want, res, _, _ = sp_run
    got = res[0][name]
    for r in res:
        assert r[name] == got
    gl = np.abs(np.array(got[0]) - np.array(want[name][0])).max()
    gg = (np.abs(np.array(got[1]) - np.array(want[name][1]))
          / np.array(want[name][1])).max()
    print(name, "loss gap", gl, "grad-norm gap", gg)
    assert gl <= CURVE_TOL and gg <= GNORM_RTOL


def test_each_sp_rank_holds_the_one_rank_gradients(sp_run):
    """Under dp 2 x sp 2, each rank's gradients of its dp rows' loss
    (attention the process ring) equal the one-controller ring's bit for
    bit: no sp rank holds a partial gradient and none is summed over sp. A
    plain slice in place of ``comm.split_to`` (a backward that does not
    gather the chunks' gradients) leaves partial ones, and the check
    catches it."""
    _, res, _, _ = sp_run
    for r in res:
        assert r["grads_equal"] is True
        assert r["planted_equal"] is False


def test_process_rings_equal_the_one_controller_rings(sp_run):
    """On 4 ranks: the differentiable process ring's output and q, k, v
    gradients are ``torch.equal`` to the one-controller ring's; the kernel
    ring's CPU path across processes (``ProcessTransport``) gives each rank
    the output ``ring_plain`` gives it."""
    _, res, _, _ = sp_run
    for r in res:
        assert r["plain_ring_equal"] == [True] * 4
        assert r["kernel_ring_equal"] is True


def test_process_transport_schedule(sp_run):
    """The kernel ring's transfers between processes, as each rank's
    ``ProcessTransport`` records them: sp(sp-1)/2 = 6 at sp 4, rank r
    forwarding chunks r, r-1, .., 0 to rank r + 1 (the last rank none), so
    chunk c reaches ranks c..sp-1 (the plan of
    ``tests/test_torch_ring_plan.py`` for one process's ranks)."""
    _, res, _, _ = sp_run
    n = len(res)
    sends = [t for r in res for t in r["transfers"]]
    assert len(sends) == n * (n - 1) // 2
    for r, rec in enumerate(res):
        assert rec["transfers"] == ([(r, r - s, r + 1) for s in range(r + 1)]
                                    if r < n - 1 else [])
    reach = {c: sorted({c} | {dst for _, cc, dst in sends if cc == c})
             for c in range(n)}
    assert reach == {c: list(range(c, n)) for c in range(n)}


def test_koifish_sp_beside_dp_and_tp_through_the_cli(sp_run):
    """``koifish --dp 2 --sp 2`` and ``--tp 2 --sp 2`` through the CLI's
    main on the 4 ranks train the one-rank run's curve within 1e-2
    (measured 5.8e-4 and 6.8e-4), every rank reporting it; ``--pp`` with
    ``--sp`` is refused (the pipeline runs alone)."""
    from koifish_tpu_torch.cli import koifish
    _, res, cfg, tmp = sp_run
    one = {}
    with torch_threads(1):
        koifish.main([cfg, "--device", "cpu", "--out-dir", str(tmp)], one)
    for flag in ("--dp", "--tp"):
        got = res[0]["cli" + flag]
        assert all(r["cli" + flag] == got for r in res)
        gap = np.abs(np.array(got) - np.array(one["infos"].losses)).max()
        print(flag, "--sp 2 vs one rank", gap)
        assert len(got) == 3 and gap <= CURVE_TOL
    with pytest.raises(ValueError, match="pipeline alone"):
        koifish.main([cfg, "--pp", "2", "--sp", "2"])
