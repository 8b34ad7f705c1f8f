"""Helpers for the PyTorch-port tests: carry JAX values across via numpy.

Inputs are made with numpy from a fixed seed and handed to both packages;
JAX runs on the CPU (tests/conftest.py), the port with ``device="cpu"``.
"""
import contextlib
import functools

import numpy as np
import torch

TINY_QWEN3 = dict(vocab_size=256, n_layer=2, n_embd=128, n_head=2,
                  n_kv_head=1, head_dim=64, n_ffn=256, n_ctx=64, max_pos=128)
INT4_RULES = {"self_attn": {"bits": 4}, "mlp": {"bits": 4},
              "group_size": 128}

# Logits of the tiny model are O(1) (max ~1.8). The two packages round bf16
# activations at other points (XLA vs PyTorch matmuls; the port's kernel
# math scales group partial sums where the JAX plain path rounds dequantized
# weights to bf16): measured <= 0.01, about one bf16 ulp at |logit| ~ 1.6.
LOGIT_TOL = 2e-2


@functools.lru_cache(maxsize=None)
def tiny_models():
    """(JAX card, port card, JAX INT4 params, the same params in the port):
    the tiny QWEN3 card from a JAX init, quantized by the JAX package and
    carried across with ``params_from_numpy``."""
    import jax
    from koifish_tpu.config import ModelCard as JModelCard
    from koifish_tpu.config import QuantCard as JQuantCard
    from koifish_tpu.models import init_params as j_init_params
    from koifish_tpu.quant.apply import quantize_params as j_quantize_params

    from koifish_tpu_torch.config import ModelCard
    from koifish_tpu_torch.io.convert import params_from_numpy
    jcard = JModelCard.from_arch("QWEN3", **TINY_QWEN3)
    card = ModelCard.from_arch("QWEN3", **TINY_QWEN3)
    jp = j_quantize_params(j_init_params(jcard, jax.random.PRNGKey(0)),
                           JQuantCard.from_json(INT4_RULES), jcard)
    tp = params_from_numpy(jax_tree_to_numpy(jp), device="cpu")
    return jcard, card, jp, tp


# Two packages' bf16 logits differ by about one ulp (<= 5e-3 measured on
# the tiny zoo cards); a JAX top-2 margin under this is a near-tie that
# either side may take.
NEAR_TIE = 1e-2


def top2_margin(logits) -> np.ndarray:
    """[B, V] logits -> each row's gap between its two largest entries."""
    s = -np.sort(-f32(logits), axis=-1)
    return s[:, 0] - s[:, 1]


def assert_greedy_agrees(tokens, jax_tokens, jax_margins,
                         tie: float = NEAR_TIE,
                         min_share: float = 0.5) -> int:
    """The port's greedy tokens [B, N] equal the JAX package's in each row
    up to the first step whose JAX top-2 margin (``jax_margins`` [N, B],
    teacher-forced on the JAX tokens) is under ``tie``; from such a
    near-tie on either package may take the other token. At least ``min_share``
    of the B·N tokens must be compared, so that near-ties cannot leave the
    check empty. Returns the number compared."""
    tokens, jax_tokens = np.asarray(tokens), np.asarray(jax_tokens)
    margins = np.asarray(jax_margins)
    compared = 0
    for b in range(tokens.shape[0]):
        for i in range(tokens.shape[1]):
            if margins[i, b] < tie:
                break
            assert tokens[b, i] == jax_tokens[b, i], (b, i)
            compared += 1
    print(f"greedy tokens compared: {compared} of {tokens.size}")
    assert compared >= min_share * tokens.size, (compared, tokens.size)
    return compared


def tiny_prompt(B: int, T: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, TINY_QWEN3["vocab_size"], size=(B, T)).astype(np.int32)


def jax_tree_to_numpy(tree):
    """A JAX param tree -> numpy leaves; a QTensor becomes a dict of its
    numpy fields plus ``fmt`` (string value), ``shape`` and ``group``."""
    from koifish_tpu.quant.qtensor import QTensor
    if isinstance(tree, QTensor):
        opt = lambda a: None if a is None else np.asarray(a)
        return dict(codes=np.asarray(tree.codes), scales=np.asarray(tree.scales),
                    zeros=opt(tree.zeros), codebook=opt(tree.codebook),
                    row_scale=opt(tree.row_scale), fmt=tree.fmt.value,
                    shape=tuple(tree.shape), group=tree.group)
    if isinstance(tree, dict):
        return {k: jax_tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [jax_tree_to_numpy(v) for v in tree]
    return np.asarray(tree)


def jax_cache_to_numpy(cache):
    """A JAX KVCache / LayeredKVCache -> the dict ``cache_from_numpy`` takes."""
    conv = lambda x: (None if x is None else
                      [np.asarray(a) for a in x] if isinstance(x, tuple)
                      else np.asarray(x))
    out = dict(k=conv(cache.k), v=conv(cache.v), k_scale=conv(cache.k_scale),
               v_scale=conv(cache.v_scale), pos=np.asarray(cache.pos),
               fmt=cache.fmt.value, sinks=cache.sinks)
    if hasattr(cache, "uniform"):
        out["uniform"] = cache.uniform
    return out


def f32(x) -> np.ndarray:
    """A JAX array or torch tensor (bf16 included) as an f32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def bf16_pair(a: np.ndarray):
    """The same bf16 values for both packages: (jnp bf16, torch bf16)."""
    import jax.numpy as jnp
    j = jnp.asarray(a, dtype=jnp.bfloat16)
    t = torch.from_numpy(np.asarray(j, dtype=np.float32)).to(torch.bfloat16)
    return j, t


def jax_train_state_to_numpy(state):
    """A JAX ``TrainState`` -> the dict ``train_state_from_numpy`` takes."""
    import jax
    import jax.numpy as jnp
    opt = state.opt
    rng = state.rng
    if jnp.issubdtype(rng.dtype, jax.dtypes.prng_key):
        rng = jax.random.key_data(rng)
    return dict(params=jax_tree_to_numpy(state.params),
                opt=dict(m=jax_tree_to_numpy(opt.m),
                         v=None if opt.v is None else jax_tree_to_numpy(opt.v),
                         step=np.asarray(opt.step),
                         spikes=np.asarray(opt.spikes)),
                rng=np.asarray(rng))


@contextlib.contextmanager
def torch_threads(n: int):
    """Run the body with ``n`` intra-op torch threads, then restore the
    count. The test run gives each of its workers a share of the cores;
    torch's default of one thread a core then makes every small op of a
    tiny model wait on the other workers (the tiny CLI runs took 40x
    longer under the parallel run than alone)."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def zoo_cli_losses(tmp_path, monkeypatch, arch: str, extra_p=None,
                   steps: int = 6, vocab: int = 300):
    """The JAX ``koifish`` CLI and the port's on one tiny config of
    ``tests/test_cli.py:482-520``'s shape (2 layers, E 64, a +1-pattern
    shard) with stochastic rounding off, for ``steps`` steps: (JAX losses,
    port losses, the port's ``result``). The port starts from the JAX
    init: ``koifish_tpu_torch.models.init_params`` is patched to carry the
    JAX package's ``init_params(card, PRNGKey(seed))`` across, the weights
    JAX's ``init_train_state`` draws."""
    import csv
    import dataclasses
    import json
    import os

    import jax
    from koifish_tpu.cli import koifish as jkoifish
    from koifish_tpu.config import ModelCard as JModelCard
    from koifish_tpu.models import init_params as j_init_params

    import koifish_tpu_torch.models as tmodels
    from koifish_tpu_torch.cli import koifish
    from koifish_tpu_torch.data import MAGIC_QWEN3, write_shard
    from koifish_tpu_torch.io.convert import params_from_numpy

    write_shard(str(tmp_path / "p_train_0.bin"),
                (np.arange(40000) % 64).astype(np.uint32), MAGIC_QWEN3, vocab)
    cfg = {
        "model": {"arch": arch, "vocab_size": vocab, "parameter": dict(
            {"Layer": 2, "transformer": {"Ctx": 32, "Embed": 64, "Ffn": 96,
                                         "Head": 4, "KVHead": 4,
                                         "head_dim": 16}},
            **(extra_p or {}))},
        "train": {"batch": 8, "learning-rate": 0.01, "dump-every": 5,
                  "warmup": 3,
                  "optimizatioin": {"method": "adamw", "grad_accumulation": 1,
                                    "stochastic_round": False}},
        "datasets": {"train": {"glob": str(tmp_path / "p_train_*.bin"),
                               "name": "pattern"}},
        "debug": {"most_iter": steps},
        "seed": 42,
    }
    cfgp = str(tmp_path / f"cfg_{arch}.json")
    with open(cfgp, "w") as f:
        json.dump(cfg, f)

    def jax_init(card, generator=None, dtype=None, device=None, seed=0):
        jcard = JModelCard(**{f.name: getattr(card, f.name)
                              for f in dataclasses.fields(card)})
        return params_from_numpy(jax_tree_to_numpy(
            j_init_params(jcard, jax.random.PRNGKey(seed))), device=device)

    monkeypatch.setattr(tmodels, "init_params", jax_init)
    losses, result = {}, {}
    for tag, main, kw in (("jax", jkoifish.main, {}),
                          ("port", koifish.main, {"result": result})):
        out = tmp_path / tag
        out.mkdir()
        with torch_threads(1):
            assert main([cfgp, "--device", "cpu", "--out-dir", str(out)],
                        **kw) == 0, tag
        with open(os.path.join(out, "koifish_loss.csv")) as f:
            losses[tag] = np.array([float(r["loss"])
                                    for r in csv.DictReader(f)])
    return losses["jax"], losses["port"], result
