"""Speculative decoding in the port: the five cases of the JAX package's
``tests/test_speculative.py`` on the port alone (greedy output equals plain
greedy target generation for a self-draft and a weaker draft, the first
sampled token follows the target distribution, multi-round runs, the
metropolis target distribution), and the port's greedy tokens against the
JAX ``speculative_generate`` on the same weights."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from koifish_tpu.config import ModelCard as JModelCard
from koifish_tpu.models import init_params as j_init_params
from koifish_tpu.serve import init_cache as j_init_cache
from koifish_tpu.serve.speculative import \
    speculative_generate as j_speculative_generate

from koifish_tpu_torch.config import ModelCard, SamplerCard
from koifish_tpu_torch.io.convert import params_from_numpy
from koifish_tpu_torch.models import init_params
from koifish_tpu_torch.ops.sampling import filtered_probs
from koifish_tpu_torch.serve import generate, init_cache, prefill
from koifish_tpu_torch.serve.speculative import (_rollback,
                                                 speculative_generate)

from torch_helpers import jax_tree_to_numpy

DIMS = dict(vocab_size=97, n_embd=64, n_head=4, n_kv_head=2, head_dim=16,
            n_ffn=128, n_ctx=64, max_pos=128)


def _card(layers=2):
    return ModelCard.from_arch("QWEN3", n_layer=layers, **DIMS)


def _cache(card):
    return init_cache(card.n_layer, 1, 128, card.n_kv_head, card.head_dim,
                      device="cpu")


def _greedy_reference(card, params, prompt, n):
    toks, _ = generate(card, params, prompt, _cache(card),
                       SamplerCard(temperature=0.0), max_new_tokens=n,
                       device="cpu")
    return toks[0].tolist()


def _spec(card, params, dcard, dparams, prompt, n, k=4, **kw):
    toks, stats = speculative_generate(card, params, dcard, dparams, prompt,
                                       _cache(card), _cache(dcard), k=k,
                                       max_new_tokens=n, device="cpu", **kw)
    return toks[0].tolist(), stats


def _models():
    card, dcard = _card(), _card(layers=1)
    return (card, init_params(card, device="cpu", seed=0),
            dcard, init_params(dcard, device="cpu", seed=7))


def test_self_draft_exact_and_full_accept():
    card, params, _, _ = _models()
    prompt = torch.tensor([[5, 11, 23, 42]])
    ref = _greedy_reference(card, params, prompt, 12)
    out, stats = _spec(card, params, card, params, prompt, 12)
    assert out[:len(ref)] == ref
    assert stats["accept_rate"] > 0.9        # draft == target: all accepted


def test_weak_draft_still_exact():
    card, params, dcard, dparams = _models()
    prompt = torch.tensor([[5, 11, 23, 42]])
    ref = _greedy_reference(card, params, prompt, 12)
    out, stats = _spec(card, params, dcard, dparams, prompt, 12, k=3)
    assert out[:len(ref)] == ref
    assert stats["rounds"] >= 1


def test_sampled_speculative_matches_target_distribution():
    """temperature > 0: the first emitted token's empirical distribution
    under speculative rejection sampling matches direct target sampling."""
    card, params, dcard, dparams = _models()
    prompt = torch.tensor([[5, 11, 23]])
    sampler = SamplerCard(temperature=1.0, top_k=8, top_p=1.0)
    logits, _ = prefill(card, params, prompt, _cache(card), fresh=True,
                        device="cpu")
    p_direct = filtered_probs(logits, 1.0, 8, 1.0)[0].numpy()
    n = 400
    counts = np.zeros(card.vocab_size)
    for s in range(n):
        out, _ = _spec(card, params, dcard, dparams, prompt, 1, k=2,
                       sampler=sampler, seed=s)
        counts[out[0]] += 1
    tv = 0.5 * np.abs(counts / n - p_direct).sum()
    assert tv < 0.12, tv                     # n=400: noise floor ~0.05


def test_sampled_speculative_runs_multiround():
    card, params, dcard, dparams = _models()
    prompt = torch.tensor([[5, 11, 23, 42]])
    out, stats = _spec(card, params, dcard, dparams, prompt, 16, k=3,
                       sampler=SamplerCard(temperature=0.8), seed=3)
    assert len(out) >= 16 - 3
    assert stats["rounds"] >= 2


def test_speculative_metropolis_target_dist():
    """The target distribution honours ``sampler.method``: metropolis takes
    the full softmax (a top-k cut would break the exact-target rule)."""
    logits = torch.tensor([[3.0, 1.0, 0.0, -1.0]])
    p = filtered_probs(logits, temperature=0.6, top_k=2, top_p=0.9,
                       min_p=0.0, method="metropolis")[0]
    torch.testing.assert_close(p, torch.softmax(logits, -1)[0], atol=1e-6,
                               rtol=0)
    assert p[3] > 0.0   # top_k=2 would have zeroed it


def test_rollback_keeps_the_buffers():
    card = _card()
    c = _cache(card)
    r = _rollback(c, 7)
    assert r.k is c.k and r.v is c.v and r.pos.tolist() == [7]
    assert c.pos.tolist() == [0]


def test_speculative_greedy_matches_jax():
    """The same weights (a JAX init carried across) through both packages'
    ``speculative_generate`` at temperature 0 with a weaker draft: the same
    tokens (both equal the target's greedy tokens)."""
    jcard = JModelCard.from_arch("QWEN3", n_layer=2, **DIMS)
    jdcard = JModelCard.from_arch("QWEN3", n_layer=1, **DIMS)
    jp = j_init_params(jcard, jax.random.PRNGKey(0))
    jdp = j_init_params(jdcard, jax.random.PRNGKey(7))
    prompt = np.asarray([[5, 11, 23, 42, 7, 1]], np.int32)
    jc = j_init_cache(2, 1, 128, jcard.n_kv_head, jcard.head_dim)
    jdc = j_init_cache(1, 1, 128, jdcard.n_kv_head, jdcard.head_dim)
    jtoks, jstats = j_speculative_generate(jcard, jp, jdcard, jdp,
                                           jnp.asarray(prompt), jc, jdc, k=3,
                                           max_new_tokens=14)
    card, dcard = _card(), _card(layers=1)
    tp = params_from_numpy(jax_tree_to_numpy(jp), device="cpu")
    tdp = params_from_numpy(jax_tree_to_numpy(jdp), device="cpu")
    out, stats = _spec(card, tp, dcard, tdp, torch.from_numpy(prompt), 14,
                       k=3)
    assert out == np.asarray(jtoks)[0].tolist()
    assert stats["tokens"] == jstats["tokens"]
