"""PyTorch port vs the JAX package: config, rope, norms, sampling, and the
port's own contracts (device rule, kernel log, no JAX imports)."""
import glob
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koifish_tpu.config import CLIParams as JCLIParams
from koifish_tpu.ops import norms as jnorms
from koifish_tpu.ops import rope as jrope
from koifish_tpu.ops import sampling as jsampling

from koifish_tpu_torch.config import CLIParams, ModelCard, QuantCard
from koifish_tpu_torch.ops import norms, rope, sampling
from koifish_tpu_torch.utils import kernel_log

from torch_helpers import f32

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# f32 elementwise math on both sides; libm cos/sin/pow/rsqrt may differ by
# an ulp or two between XLA and PyTorch
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _fields(obj):
    import dataclasses
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            v = _fields(v)
        elif isinstance(v, list):
            v = [_fields(x) if dataclasses.is_dataclass(x) else x for x in v]
        elif isinstance(v, dict):
            v = {k: _fields(x) if dataclasses.is_dataclass(x) else x
                 for k, x in v.items()}
        out[f.name] = getattr(v, "value", v)
    return out


@pytest.mark.parametrize("path", sorted(glob.glob(
    os.path.join(ROOT, "configs", "*.json"))))
def test_config_parses_like_jax(path):
    """Every field of every card, from the same reference JSON files."""
    assert _fields(CLIParams.load(path)) == _fields(JCLIParams.load(path))


def test_config_reads_misspelt_optimizer_key_and_rules():
    raw = {"train": {"optimizatioin": {"method": "MUON",
                                       "grad_accumulation": 4}},
           "quantizer": {"self_attn": {"bits": 4}, "group_size": 64}}
    p = CLIParams.from_json(raw)
    assert p.train.optimizer == "muon" and p.train.grad_accum == 4
    assert p.quant.rule_for("model.layers.3.self_attn.q_proj").group == 64
    assert p.quant.rule_for("model.layers.3.mlp.up_proj") is None
    assert ModelCard.preset("qwen3-0.6b").n_kv_head == 8
    assert QuantCard.from_json({"mlp": {"bits": 4, "quant_method": "RTNf"}}
                               ).rules[0].fmt.value == "nf4"


@pytest.mark.parametrize("scaling", [None, {"rope_type": "yarn", "factor": 4.0,
                                            "original_max_position_embeddings":
                                            1024}, {"type": "linear",
                                                    "factor": 2.0}])
def test_rope_matches_jax(scaling):
    D, theta = 64, 1_000_000.0
    jf, js = jrope.rope_inv_freq(D, theta, scaling)
    tf, ts = rope.rope_inv_freq(D, theta, scaling)
    np.testing.assert_allclose(f32(tf), f32(jf), **F32_TOL)
    assert abs(float(ts) - float(js)) < 1e-6
    jc, jsn = jrope.rope_freqs(D, 300, theta, scaling)
    tc, tsn = rope.rope_freqs(D, 300, theta, scaling)
    # angles up to 300 rad: cos/sin of an f32 product, 1e-4 absolute
    np.testing.assert_allclose(f32(tc), f32(jc), atol=1e-4)
    np.testing.assert_allclose(f32(tsn), f32(jsn), atol=1e-4)
    # direct evaluation past max_pos: a 1-ulp difference of inv_freq
    # (libm pow) grows with the position — 2e-3 at position 70000
    for p_max, atol in ((300, 1e-4), (70000, 2e-3)):
        pos = np.array([[0, 5, p_max]], np.int32)
        jc2, _ = jrope.rope_cos_sin_at(D, jnp.asarray(pos), theta, scaling)
        tc2, _ = rope.rope_cos_sin_at(D, torch.from_numpy(pos), theta,
                                      scaling)
        np.testing.assert_allclose(f32(tc2), f32(jc2), atol=atol)


def test_apply_rope_and_norms_match_jax():
    """apply_rope (table and direct), rmsnorm (incl. per-head QK-norm on
    [B,T,H,D]) and layernorm, in f32 (bf16 rounding is not the point)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    jc, js = jrope.rope_freqs(64, 16, 10_000.0)
    tc, ts = rope.rope_freqs(64, 16, 10_000.0)
    pos = np.arange(5)
    jr = jrope.apply_rope(jnp.asarray(x), jc, js, jnp.asarray(pos))
    tr = rope.apply_rope(torch.from_numpy(x), tc, ts, torch.from_numpy(pos))
    np.testing.assert_allclose(f32(tr), f32(jr), **F32_TOL)
    np.testing.assert_allclose(
        f32(norms.rmsnorm(torch.from_numpy(x), torch.from_numpy(w))),
        f32(jnorms.rmsnorm(jnp.asarray(x), jnp.asarray(w))), **F32_TOL)
    np.testing.assert_allclose(
        f32(norms.layernorm(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(b),
                            residual=torch.from_numpy(x))),
        f32(jnorms.layernorm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             residual=jnp.asarray(x))), **F32_TOL)


def test_greedy_is_argmax():
    logits = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 300)).astype(np.float32))
    tok = sampling.sample_logits(None, logits, temperature=0.0)
    assert tok.dtype == torch.int32
    assert tok.tolist() == torch.argmax(logits, -1).tolist()


@pytest.mark.parametrize("kw", [
    dict(temperature=0.7, top_k=20, top_p=1.0),
    dict(temperature=0.6, top_k=50, top_p=0.9),
    dict(temperature=1.3, top_k=0, top_p=0.8),
    dict(temperature=0.8, top_k=30, top_p=1.0, min_p=0.2),
    dict(temperature=0.5, method="metropolis"),
    dict(temperature=0.0),
])
def test_filtered_probs_match_jax(kw):
    """The dense distribution the sampler draws from (top-k, top-p, min-p,
    metropolis, greedy). jax.random and torch.Generator give different
    bits, so sampled tokens are not compared; the distributions are (f32
    softmax of the same values: 1e-6)."""
    logits = np.random.default_rng(2).standard_normal((3, 500)
                                                      ).astype(np.float32) * 3
    j = jsampling.filtered_probs(jnp.asarray(logits), **kw)
    t = sampling.filtered_probs(torch.from_numpy(logits), **kw)
    np.testing.assert_allclose(f32(t), f32(j), atol=1e-6)


def test_sampler_draws_inside_the_filtered_support():
    """Sampled ids land where filtered_probs > 0, with the empirical
    frequencies of that distribution (seeded torch.Generator)."""
    logits = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 64)).astype(np.float32) * 2).repeat(4000, 1)
    kw = dict(temperature=0.8, top_k=10, top_p=0.9)
    probs = sampling.filtered_probs(logits[:1], **kw)[0]
    gen = torch.Generator().manual_seed(0)
    toks = sampling.sample_logits(gen, logits, **kw).long()
    assert bool((probs[toks] > 0).all())
    freq = torch.bincount(toks, minlength=64).float() / toks.numel()
    assert float((freq - probs).abs().max()) < 0.03


def test_entry_points_raise_without_a_gpu():
    """device=None means CUDA; with no GPU every entry point raises instead
    of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from koifish_tpu_torch.models import init_params
    from koifish_tpu_torch.quant import quantize_params
    from koifish_tpu_torch.serve import cache_for, generate, prefill
    from koifish_tpu_torch.train import init_train_state
    from koifish_tpu_torch.config import TrainCard
    card = ModelCard.from_arch("QWEN3", vocab_size=64, n_layer=1, n_embd=128,
                               n_head=2, n_kv_head=1, head_dim=64, n_ffn=128)
    p = init_params(card, device="cpu")
    cache = cache_for(card, 1, 8, device="cpu")
    tok = torch.zeros((1, 2), dtype=torch.int64)
    calls = [lambda: init_params(card),
             lambda: quantize_params(p, QuantCard(), card),
             lambda: cache_for(card, 1, 8),
             lambda: prefill(card, p, tok, cache),
             lambda: generate(card, p, tok, cache),
             lambda: init_train_state(card, TrainCard())]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_kernel_log_contract(monkeypatch, capsys):
    kernel_log.reset()
    monkeypatch.setenv("KOIFISH_DUMP_KERNELS", "2")
    kernel_log.fallback("qmatmul", "why")
    kernel_log.fallback("qmatmul", "why")          # logged once
    kernel_log.choice("flash_fwd", "took it")
    err = capsys.readouterr().err
    assert err.count("kernel fallback -> torch: qmatmul (why)") == 1
    assert "kernel choice: flash_fwd (took it)" in err
    monkeypatch.setenv("KOIFISH_DUMP_KERNELS", "0")
    kernel_log.fallback("qmatmul", "other")
    assert capsys.readouterr().err == ""
    kernel_log.reset_launches()
    kernel_log.count("qmv")
    kernel_log.count("qmv")
    assert kernel_log.launches() == {"qmv": 2}
    kernel_log.reset_launches()
    assert kernel_log.launches() == {}


def test_port_imports_no_jax():
    """koifish_tpu_torch and chip_smoke.py import neither JAX nor the JAX
    package (nor ``regex`` or ``ml_dtypes``, which the card's machine does
    not have), in a fresh interpreter and in their sources."""
    code = ("import sys, koifish_tpu_torch.serve, koifish_tpu_torch.io.convert,"
            " koifish_tpu_torch.quant, koifish_tpu_torch.ops.kernels._build,"
            " koifish_tpu_torch.train, koifish_tpu_torch.ops.cross_entropy,"
            " koifish_tpu_torch.serve.batching, koifish_tpu_torch.serve.paged,"
            " koifish_tpu_torch.serve.stacked, koifish_tpu_torch.quant.cluster,"
            " koifish_tpu_torch.ops.kernels.slotwrite, koifish_tpu_torch.io,"
            " koifish_tpu_torch.data, koifish_tpu_torch.cli.bubble,"
            " koifish_tpu_torch.serve.speculative,"
            " koifish_tpu_torch.ops.kernels.qmv_int8,"
            " koifish_tpu_torch.data.tokenset, koifish_tpu_torch.data.sft,"
            " koifish_tpu_torch.train.lora, koifish_tpu_torch.train.fuyou,"
            " koifish_tpu_torch.io.checkpoint, koifish_tpu_torch.evaluate,"
            " koifish_tpu_torch.cli.koifish, koifish_tpu_torch.cli.pretokenize,"
            " koifish_tpu_torch.cli.pangpi, koifish_tpu_torch.parallel,"
            " koifish_tpu_torch.ops.kernels.ring_attn,"
            " koifish_tpu_torch.models.backbone, koifish_tpu_torch.models.moe,"
            " koifish_tpu_torch.models.mla, koifish_tpu_torch.serve.mla_cache,"
            " koifish_tpu_torch.utils.logging, koifish_tpu_torch.utils.profiler,"
            " koifish_tpu_torch.utils.xprof;"
            " bad = [m for m in sys.modules if m.split('.')[0] in"
            " ('jax', 'jaxlib', 'koifish_tpu', 'regex', 'ml_dtypes')];"
            " print(bad); sys.exit(bool(bad))")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
    srcs = glob.glob(os.path.join(ROOT, "koifish_tpu_torch", "**", "*.py"),
                     recursive=True) + [os.path.join(ROOT, "chip_smoke.py")]
    for path in srcs:
        text = open(path).read()
        for bad in ("import jax", "from jax", "import koifish_tpu\n",
                    "from koifish_tpu.", "import koifish_tpu."):
            assert bad not in text, (path, bad)
