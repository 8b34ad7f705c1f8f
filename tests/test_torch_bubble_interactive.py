"""``bubble --interactive`` through the port against the JAX package's REPL.

The REPL reads turns with ``input``; the tests feed them by monkeypatching
it, on a tiny Qwen3 folder written from a seed
(``tests/helpers.make_hf_qwen3_dir``). A conversation that fits carries one
cache across turns in both packages. A turn that no longer fits the carried
cache runs on a fresh cache in the port; the JAX package instead clamps the
write over the last turn's slots (ROADMAP queue 3), so that case is held
against a fresh single-turn run of the port.
"""
import builtins

import numpy as np
import pytest

import koifish_tpu.serve as jserve
from koifish_tpu.cli import bubble as jbubble
from koifish_tpu.config import ModelCard as JModelCard

from koifish_tpu_torch.cli import bubble
from koifish_tpu_torch.data import chat_template as tct
from koifish_tpu_torch.data import tokenizer as ttok

from helpers import make_hf_qwen3_dir

TINY = dict(vocab_size=300, n_layer=2, n_embd=128, n_head=2, n_kv_head=1,
            head_dim=64, n_ffn=256, n_ctx=64, max_pos=256)
BASE = ["--bits", "8", "--kv-bits", "8", "--temperature", "0",
        "--device", "cpu", "--decode-chunk", "4"]


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("hf")
    make_hf_qwen3_dir(path, JModelCard.from_arch("QWEN3", **TINY))
    return str(path)


def _feed(monkeypatch, prompts):
    lines = iter(list(prompts) + [""])
    monkeypatch.setattr(builtins, "input", lambda *_: next(lines))


def _port_turns(argv):
    turns = []
    assert bubble.main(argv, turns=turns) == 0
    return turns


def _jax_turns(monkeypatch, argv):
    """Each turn's new tokens from the JAX package's REPL: its ``generate``
    (imported inside ``main`` from ``koifish_tpu.serve``) is wrapped."""
    got = []
    real = jserve.generate

    def spy(*a, **kw):
        toks, cache = real(*a, **kw)
        got.append(np.asarray(toks)[0].tolist())
        return toks, cache

    monkeypatch.setattr(jserve, "generate", spy)
    assert jbubble.main(argv) in (0, None)
    return got


def test_interactive_turns_match_jax(hf_dir, monkeypatch, capsys):
    """Three turns that fit one 256-slot cache: the carried conversation
    gives the same greedy tokens, turn by turn, as the JAX REPL."""
    prompts = ["hello there", "and again?", "one more"]
    argv = ["--hf", hf_dir, "--interactive", "--ctx", "256",
            "--max-new", "8"] + BASE
    _feed(monkeypatch, prompts)
    turns = _port_turns(argv)
    _feed(monkeypatch, prompts)
    jtoks = _jax_turns(monkeypatch, argv)
    assert [t["tokens"] for t in turns] == jtoks
    assert len(jtoks) == 3
    assert "resetting" not in capsys.readouterr().out


def _prompt_of(hf_dir, n_ids):
    """A user message whose rendered chat prompt is ``n_ids`` tokens."""
    tok = ttok.BPETokenizer.from_file(hf_dir)
    for n in range(1, 200):
        text = "z" * n
        ids = tok.encode(tct.render([{"role": "user", "content": text}],
                                    hf_dir, "QWEN3"))
        if len(ids) == n_ids:
            return text
    raise AssertionError(f"no prompt renders to {n_ids} ids")


def test_interactive_answers_a_turn_past_the_carried_cache(
        hf_dir, monkeypatch, capsys):
    """``--ctx 128 --max-new 12`` and two 62-token prompts: after turn 1
    the cache holds 73 positions, so turn 2 cannot fit. Both turns are
    answered, the REPL prints one notice, and turn 2 equals a fresh
    single-turn run of its prompt."""
    p1 = _prompt_of(hf_dir, 62)
    p2 = p1.replace("z", "y")
    argv = ["--hf", hf_dir, "--ctx", "128", "--max-new", "12"] + BASE
    _feed(monkeypatch, [p1, p2])
    turns = _port_turns(argv + ["--interactive"])
    out = capsys.readouterr().out
    assert [len(t["prompt_ids"]) for t in turns] == [62, 62]
    assert all(len(t["tokens"]) > 0 for t in turns)
    assert out.count("starts a fresh context") == 1
    assert "resetting" not in out
    (fresh,) = _port_turns(argv + ["--prompts", p2])
    assert turns[1]["tokens"] == fresh["tokens"]
    assert turns[1]["prompt_ids"] == fresh["prompt_ids"]
