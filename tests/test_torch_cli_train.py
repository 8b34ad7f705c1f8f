"""The port's ``koifish``, ``pangpi`` and ``pretokenize`` CLIs against the
JAX package's on the same configs and inputs, on the CPU at tiny sizes,
each CLI's ``main`` called in this process.

Both trainers start from the same HF folder's weights with stochastic
rounding off (``optimizatioin.stochastic_round: false``); their loss curves
stay within 1e-2, the existing tolerance of the port's loss-curve tests
(measured 6.1e-3 at most, on the steep early steps of a 25-step run at lr
1e-2). Eval CE agrees within 1e-2; shards are byte identical. Each test
names the JAX CLI test in ``tests/test_cli.py`` it covers."""
import copy
import csv
import glob
import json
import os

import numpy as np
import pytest
import torch

from koifish_tpu.cli import koifish as jkoifish
from koifish_tpu.cli import pangpi as jpangpi
from koifish_tpu.cli import pretokenize as jpretok
from koifish_tpu.config import ModelCard as JModelCard

from koifish_tpu_torch.cli import koifish, pangpi, pretokenize
from koifish_tpu_torch.data import (MAGIC_GPT2, MAGIC_QWEN3, read_shard,
                                    write_shard)

from koifish_tpu_torch.io.convert import params_from_numpy

from helpers import make_hf_qwen3_dir
from torch_helpers import jax_tree_to_numpy, torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


TOL_CURVE = 1e-2
TRANSFORMER = {"Ctx": 32, "Embed": 64, "Ffn": 128, "Head": 4, "KVHead": 2,
               "head_dim": 16}
BASE_CFG = {
    "model": {"arch": "QWEN3", "vocab_size": 300,
              "parameter": {"Layer": 2, "transformer": TRANSFORMER}},
    "train": {"batch": 8, "learning-rate": 0.01, "dump-every": 5,
              "warmup": 3,
              "optimizatioin": {"method": "adamw", "grad_accumulation": 1,
                                "stochastic_round": False}},
    "debug": {"most_iter": 25},
    "seed": 42,
}


@pytest.fixture(scope="module")
def tiny_hf(tmp_path_factory):
    d = tmp_path_factory.mktemp("hf")
    card = JModelCard.from_arch("QWEN3", vocab_size=300, n_layer=2, n_embd=64,
                                n_head=4, n_kv_head=2, head_dim=16, n_ffn=128,
                                n_ctx=64, max_pos=256)
    make_hf_qwen3_dir(d, card)
    return str(d)


def _cfg(tmp_path, name, glob_pat, **over):
    cfg = copy.deepcopy(BASE_CFG)
    cfg["datasets"] = {"train": {"glob": glob_pat, "name": "pattern"}}
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(cfg.get(k), dict):
            cfg[k].update(v)
        else:
            cfg[k] = v
    path = str(tmp_path / f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def _pattern_shard(tmp_path, n=40000, name="p_train_0.bin"):
    write_shard(str(tmp_path / name), (np.arange(n) % 64).astype(np.uint32),
                MAGIC_QWEN3, 300)
    return str(tmp_path / "p_train_*.bin")


def _run(main, argv, capsys):
    """(return code, stdout, stderr) of one CLI ``main``."""
    capsys.readouterr()
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _losses(out_dir):
    return np.array([float(r["loss"]) for r in
                     _rows(os.path.join(out_dir, "koifish_loss.csv"))])


def _both(tmp_path, capsys, cfgp, *extra):
    """Run the JAX and the port trainer; their stdouts."""
    outs = {}
    for tag, main, dev in (("jax", jkoifish.main, "cpu"),
                           ("port", koifish.main, "cpu")):
        d = tmp_path / tag
        d.mkdir(exist_ok=True)
        rc, out, err = _run(main, [cfgp, "--device", dev, "--out-dir", str(d),
                                   *extra], capsys)
        assert rc == 0, (tag, err[-2000:])
        outs[tag] = out
    return outs


def test_koifish_train_cli_matches_jax(tmp_path, tiny_hf, capsys):
    """tests/test_cli.py:38, with an eval dataset: 25 rows, the port's curve
    and Eval.csv against the JAX CLI's from the same weights."""
    pat = _pattern_shard(tmp_path)
    cfgp = _cfg(tmp_path, "cfg", pat, train={"eval-every": 10})
    with open(cfgp) as f:
        cfg = json.load(f)
    cfg["datasets"]["eval_1"] = {"glob": pat, "name": "pv", "samp": 0.01}
    with open(cfgp, "w") as f:
        json.dump(cfg, f)
    outs = _both(tmp_path, capsys, cfgp, "--hf", tiny_hf)
    jl, tl = _losses(tmp_path / "jax"), _losses(tmp_path / "port")
    assert len(tl) == len(jl) == 25
    assert tl[-1] < tl[0] * 0.5
    assert np.abs(tl - jl).max() <= TOL_CURVE, np.abs(tl - jl).max()
    je, te = (_rows(tmp_path / t / "Eval.csv") for t in ("jax", "port"))
    assert [(r["iter"], r["dataset"]) for r in te] == \
        [(r["iter"], r["dataset"]) for r in je] == [("10", "pv"), ("20", "pv")]
    for a, b in zip(je, te):
        assert abs(float(a["ce"]) - float(b["ce"])) <= 1e-2
    assert "[eval pv@10]" in outs["port"]
    assert "layers.0.q " in outs["port"] and "... x 2 layers" in outs["port"]


def test_koifish_gpt_every_cli(tmp_path, tiny_hf, capsys):
    """tests/test_cli.py:77: train.gpt-every samples at 8 and 16."""
    pat = _pattern_shard(tmp_path)
    cfgp = _cfg(tmp_path, "cfg", pat, model={"arch": "QWEN3",
                                             "hf-card": tiny_hf},
                train={"gpt-every": 8, "dump-every": 50},
                debug={"most_iter": 17})
    rc, out, err = _run(koifish.main, [cfgp, "--device", "cpu", "--out-dir",
                                       str(tmp_path)], capsys)
    assert rc == 0, err[-2000:]
    assert "[gpt@8]" in out and "[gpt@16]" in out, out[-1500:]


def test_koifish_fuyou_cli(tmp_path, capsys):
    """tests/test_cli.py:101: model.fuyou rotates branches (its log lines)
    and the trajectory departs from the run without it; both learn."""
    pat = _pattern_shard(tmp_path)
    losses = {}
    for tag in ("no_fuyou", "fuyou"):
        model = copy.deepcopy(BASE_CFG["model"])
        if tag == "fuyou":
            model["fuyou"] = {"branch": 3, "switch": 8, "method": "pso_ga",
                              "crossover": 0.6, "mutation": 0.001,
                              "social": 2}
        out_dir = tmp_path / tag
        out_dir.mkdir()
        cfgp = _cfg(out_dir, "cfg", pat, model=model,
                    train={"dump-every": 50}, debug={"most_iter": 24})
        rc, out, err = _run(koifish.main, [cfgp, "--device", "cpu",
                                           "--out-dir", str(out_dir)], capsys)
        assert rc == 0, err[-2000:]
        if tag == "fuyou":
            assert "[fuyou] iter 7: rotate -> branch 1" in out, out[-1500:]
            assert "[fuyou] iter 23" in out
        losses[tag] = _losses(out_dir)
    assert losses["no_fuyou"][-1] < losses["no_fuyou"][0]
    assert losses["fuyou"][-1] < losses["fuyou"][0]
    assert np.array_equal(losses["fuyou"][:8], losses["no_fuyou"][:8])
    assert not np.array_equal(losses["fuyou"][10:], losses["no_fuyou"][10:])


def test_koifish_missing_dataset_error(tmp_path, capsys):
    """tests/test_cli.py:200: no train dataset -> return code 2."""
    cfg = {"model": {"arch": "QWEN3", "vocab_size": 300,
                     "parameter": {"Layer": 1, "transformer": TRANSFORMER}},
           "train": {"batch": 2}}
    cfgp = str(tmp_path / "c.json")
    with open(cfgp, "w") as f:
        json.dump(cfg, f)
    rc, _, err = _run(koifish.main, [cfgp, "--device", "cpu", "--out-dir",
                                     str(tmp_path)], capsys)
    assert rc == 2 and "no train dataset" in err


def test_koifish_sft_jsonl_cli(tmp_path, tiny_hf, capsys, monkeypatch):
    """tests/test_cli.py:215: LoRA SFT from OAI-message JSONL, 10 rows, the
    loss falls. The port's CLI takes the JAX CLI's adapters (the two draw
    from different generators), so the whole curve is held to the JAX
    CLI's: the LoRA mask, the SFTDataset order with the config's seed and
    epochs, and the adapters' updates."""
    from koifish_tpu.train import lora as jlora

    from koifish_tpu_torch.train import lora as tlora
    jp = str(tmp_path / "chat.jsonl")
    with open(jp, "w") as f:
        for i in range(64):
            f.write(json.dumps({"messages": [
                {"role": "user", "content": f"hello {i}"},
                {"role": "assistant", "content": "hello hello hello"}]})
                + "\n")
    cfg = {"sft": {"hf-card": tiny_hf, "method": "lora"},
           "model": {"arch": "QWEN3"},
           "train": {"batch": 4, "learning-rate": 0.01, "warmup": 2,
                     "dump-every": 5, "epoch": 2,
                     "optimizatioin": {"stochastic_round": False}},
           "datasets": {"train": {"glob": jp, "type": "OAI_message"}},
           "debug": {"most_iter": 10}, "seed": 42}
    cfgp = str(tmp_path / "sft.json")
    with open(cfgp, "w") as f:
        json.dump(cfg, f)
    seen = {}
    j_add, t_add = jlora.add_lora, tlora.add_lora

    def jax_add_lora(*a, **k):      # copied now: the JAX step donates it
        out = j_add(*a, **k)
        seen["jax"] = jax_tree_to_numpy(out)
        return out

    def port_add_lora(*a, **k):      # the port's tree, JAX's adapters
        out = t_add(*a, **k)
        jt = params_from_numpy(seen["jax"], device="cpu")
        for lp, jl in zip(out["layers"], jt["layers"]):
            for name in [n for n in lp if n.endswith("_lora")]:
                assert jl[name]["a"].shape == lp[name]["a"].shape, name
                lp[name] = jl[name]
        return out
    monkeypatch.setattr(jlora, "add_lora", jax_add_lora)
    monkeypatch.setattr(tlora, "add_lora", port_add_lora)
    outs = _both(tmp_path, capsys, cfgp)
    assert "SFT method=lora" in outs["port"]
    assert "SFT: 64 conversations, 32 steps" in outs["port"]
    jl, tl = _losses(tmp_path / "jax"), _losses(tmp_path / "port")
    assert len(tl) == len(jl) == 10 and tl[-1] < tl[0]
    assert np.abs(tl - jl).max() <= TOL_CURVE, np.abs(tl - jl).max()


def test_koifish_resume_cli(tmp_path, tiny_hf, capsys):
    """tests/test_cli.py:351: train, save, resume from step 15; the port
    also resumes from the JAX CLI's checkpoint and its first steps agree
    with the JAX CLI's resumed run."""
    pat = _pattern_shard(tmp_path, 30000)
    cfgp = _cfg(tmp_path, "r", pat, train={"save-every": 100},
                debug={"most_iter": 15})
    for tag, main in (("port", koifish.main), ("jax", jkoifish.main)):
        d = tmp_path / tag
        d.mkdir()
        rc, _, err = _run(main, [cfgp, "--device", "cpu", "--out-dir", str(d),
                                 "--hf", tiny_hf], capsys)
        assert rc == 0, err[-2000:]
    port_ck = glob.glob(str(tmp_path / "port" / "koifish_final_*"))
    jax_ck = glob.glob(str(tmp_path / "jax" / "koifish_final_*"))
    assert len(port_ck) == len(jax_ck) == 1
    before = _losses(tmp_path / "port")[-1]
    rc, out, err = _run(koifish.main, [cfgp, "--device", "cpu", "--out-dir",
                                       str(tmp_path / "port"), "--resume",
                                       port_ck[0]], capsys)
    assert rc == 0, err[-2000:]
    assert "resumed from" in out and "step 15" in out
    assert _losses(tmp_path / "port")[0] < before + 1.0
    # both packages resume from the JAX file: the same state, the same steps
    res = {}
    for tag, main in (("port", koifish.main), ("jax", jkoifish.main)):
        d = tmp_path / f"{tag}_from_jax"
        d.mkdir()
        rc, out, err = _run(main, [cfgp, "--device", "cpu", "--out-dir",
                                   str(d), "--resume", jax_ck[0],
                                   "--most-iter", "3"], capsys)
        assert rc == 0 and "step 15" in out, err[-2000:]
        res[tag] = _losses(d)
    assert len(res["port"]) == 3
    assert np.abs(res["port"] - res["jax"]).max() <= TOL_CURVE


def test_koifish_gpt2_uint16_shards_cli(tmp_path, capsys, monkeypatch):
    """tests/test_cli.py:387: GPT2 from uint16 shards, the loss falls by
    30 %. Both CLIs run; the port starts from the JAX CLI's random
    weights (the two draw from different generators) and its curve is
    held to the JAX CLI's, SR off."""
    from koifish_tpu.train import trainer as jtrainer

    from koifish_tpu_torch.train import trainer as ttrainer
    write_shard(str(tmp_path / "g_train.bin"),
                (np.arange(40000) % 64).astype(np.uint16), MAGIC_GPT2, 50257)
    cfg = {"model": {"arch": "GPT2", "vocab_size": 128,
                     "parameter": {"Layer": 2,
                                   "transformer": {"Ctx": 32, "Embed": 64,
                                                   "Head": 4, "Ffn": 256}}},
           "train": {"batch": 8, "learning-rate": 0.01, "warmup": 3,
                     "dump-every": 5,
                     "optimizatioin": {"stochastic_round": False}},
           "datasets": {"train": {"glob": str(tmp_path / "g_train.bin")}},
           "debug": {"most_iter": 20}, "seed": 42}
    cfgp = str(tmp_path / "g.json")
    with open(cfgp, "w") as f:
        json.dump(cfg, f)
    seen = {}
    j_init, t_init = jtrainer.init_train_state, ttrainer.init_train_state

    def jax_init(*a, **k):          # copied now: the JAX step donates it
        st = j_init(*a, **k)
        seen["jax"] = jax_tree_to_numpy(st.params)
        return st

    def port_init(card, tcard, params=None, device=None):
        assert params is None
        params = params_from_numpy(seen["jax"], device=device or "cpu")
        return t_init(card, tcard, params=params, device=device)
    monkeypatch.setattr(jtrainer, "init_train_state", jax_init)
    monkeypatch.setattr(ttrainer, "init_train_state", port_init)
    _both(tmp_path, capsys, cfgp)
    jl, tl = _losses(tmp_path / "jax"), _losses(tmp_path / "port")
    assert len(tl) == len(jl) == 20 and tl[-1] < tl[0] * 0.7
    assert np.abs(tl - jl).max() <= TOL_CURVE, np.abs(tl - jl).max()


@pytest.mark.parametrize("flags,item", [
    # the first three keep the ids of the refusals they replaced
    pytest.param(["--sp", "2", "--dp", "2"], 4,
                 id="flags0-the ring's process transport"),
    pytest.param(["--sp", "2", "--tp", "2"], 4,
                 id="flags1-the ring's process transport"),
    pytest.param(["--sp", "2", "--pp", "2"], "pipeline alone",
                 id="flags2-the ring's process transport"),
    (["--pp", "2", "--tp", "2"], "pipeline alone"),
    (["--fsdp"], None),
    ([], "gama training")])
def test_koifish_unported_paths_raise(tmp_path, flags, item, capsys,
                                      monkeypatch):
    """What the process mesh does not take raises and names why: ``--pp``
    beside ``--sp`` or ``--tp`` asks for the pipeline alone. ``--sp``
    beside ``--dp`` or ``--tp`` is ported: without a launcher the CLI
    starts dp·tp·sp ranks (the spawn is recorded here; they train in
    ``tests/test_torch_parallel_sp.py``), as ``--dp/--tp/--pp`` themselves
    are (``tests/test_torch_parallel_train.py``); ``--fsdp`` alone trains
    on a one-rank process mesh and returns 0. Gama (scale-only) QAT, the
    last case, is ported: the CLI prints its mode, trains the scales of
    the quantized params with every code frozen, and returns 0
    (``tests/test_torch_gama_distill.py`` holds its curve to JAX's)."""
    if isinstance(item, int):
        from koifish_tpu_torch.parallel import multihost
        started = []
        monkeypatch.setattr(multihost, "spawn", lambda fn, world, args=(),
                            **kw: started.append((fn, world, args, kw)))
        assert koifish.main(["cfg.json", "--device", "cpu", *flags]) == 0
        (fn, world, args, kw), = started
        assert world == item and kw == {"device": "cpu"}
        assert fn is koifish._rank_main and args[0][-2:] == flags[-2:]
        return
    pat = _pattern_shard(tmp_path, 3000)
    over = {} if flags and item else {"quantizer": {
        "self_attn": {"bits": 4}, "mlp": {"bits": 4}, "group_size": 32,
        "train_target": "gama"}, "debug": {"most_iter": 2}}
    if flags and item is None:
        over = {"debug": {"most_iter": 2}}
    cfgp = _cfg(tmp_path, "c", pat, **over)
    if flags and item:
        err = ValueError if item == "pipeline alone" else NotImplementedError
        pat_ = (item if err is ValueError
                else f"ROADMAP.md queue 1, {item}")
        with pytest.raises(err, match=pat_):
            koifish.main([cfgp, "--device", "cpu", *flags])
        return
    if flags:
        res = {}
        assert koifish.main([cfgp, "--device", "cpu", "--out-dir",
                             str(tmp_path), *flags], result=res) == 0
        out = capsys.readouterr().out
        assert "process mesh dp=1 tp=1 pp=1 fsdp=True: 1 rank(s)" in out
        assert len(res["infos"].losses) == 2
        assert res["state"].layout is not None
        return
    res = {}
    assert koifish.main([cfgp, "--device", "cpu", "--out-dir",
                         str(tmp_path)], result=res) == 0
    assert "QAT enabled: gama" in capsys.readouterr().out
    from koifish_tpu_torch.quant.qtensor import QTensor
    qs = [w for lp in res["state"].params["layers"] for w in lp.values()
          if isinstance(w, QTensor)]
    assert len(qs) == 2 * 7 and len(res["infos"].losses) == 2
    assert all(not q.codes.is_floating_point() and q.scales.requires_grad
               for q in qs)


def test_koifish_needs_the_card_unless_asked(tmp_path, monkeypatch):
    """Without --device the CLI runs on the card, and with no card raises."""
    cfgp = _cfg(tmp_path, "c", _pattern_shard(tmp_path, 3000))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        koifish.main([cfgp])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pangpi.main(["--hf", str(tmp_path), "--ppl", "x"])


def _hellaswag_shard(path, n, vocab, seed=0):
    rng = np.random.default_rng(seed)
    recs = []
    for idx in range(n):
        ctx = rng.integers(0, vocab, size=6).astype(np.uint16)
        body = [np.array([int(rng.integers(0, 4)), len(ctx)], np.uint16), ctx]
        for _ in range(4):
            c = rng.integers(0, vocab, size=int(rng.integers(2, 6))
                             ).astype(np.uint16)
            body += [np.array([len(c)], np.uint16), c]
        body = np.concatenate(body)
        recs.append(np.concatenate(
            [np.array([65535, (3 + len(body)) * 2, idx], np.uint16), body]))
    header = np.zeros(256, np.int32)
    header[:3] = (20240522, 1, n)
    with open(path, "wb") as f:
        f.write(header.tobytes())
        for r in recs:
            f.write(r.tobytes())


def test_pangpi_cli_matches_jax(tmp_path, tiny_hf, capsys):
    """tests/test_cli.py:190: --ppl (mean CE within 1e-2 of the JAX CLI's)
    and --hellaswag (the same accuracy)."""
    seq = np.random.default_rng(0).integers(0, 300, 20000).astype(np.uint32)
    write_shard(str(tmp_path / "val.bin"), seq, MAGIC_QWEN3, 300)
    _hellaswag_shard(str(tmp_path / "hs.bin"), 6, 300)
    argv = ["--hf", tiny_hf, "--ppl", str(tmp_path / "val.bin"), "--max", "2",
            "--batch", "2", "--hellaswag", str(tmp_path / "hs.bin"),
            "--device", "cpu"]
    rc, jout, err = _run(jpangpi.main, argv, capsys)
    assert rc == 0, err
    res = {}
    capsys.readouterr()
    assert pangpi.main(argv, result=res) == 0
    tout = capsys.readouterr().out
    assert "ppl=" in tout and "hellaswag acc=" in tout
    jce = float(jout.split("ce=")[-1].split()[0])
    assert abs(res["ce"] - jce) <= 1e-2
    assert f"hellaswag acc={res['acc']:.4f}" in jout
    assert _run(pangpi.main, ["--hf", tiny_hf, "--device", "cpu"],
                capsys)[0] == 2


def test_pretokenize_cli_matches_jax(tmp_path, tiny_hf, capsys):
    """tests/test_cli.py:274: shards byte identical to the JAX CLI's (Qwen3
    uint32 and GPT2 uint16, train and val splits) and decoding back."""
    with open(tmp_path / "doc1.txt", "w") as f:
        f.write("hello world hello\n" * 50)
    with open(tmp_path / "doc2.jsonl", "w") as f:
        for i in range(20):
            f.write(json.dumps({"text": f"hello {i}"}) + "\n")
        f.write("not json\n")
    for arch, val in (("qwen3", "0"), ("gpt2", "0.5")):
        outs = {}
        for tag, main in (("jax", jpretok.main), ("port", pretokenize.main)):
            out = str(tmp_path / f"{tag}_{arch}")
            rc, _, err = _run(main, [
                "--hf", tiny_hf, "--input", str(tmp_path / "doc*"), "--out",
                out, "--name", "toy", "--val-frac", val, "--arch", arch,
                "--tokens-per-shard", "300"], capsys)
            assert rc == 0, err
            outs[tag] = sorted(os.listdir(out))
        assert outs["port"] == outs["jax"] and len(outs["port"]) > 1
        for name in outs["port"]:
            with open(tmp_path / f"jax_{arch}" / name, "rb") as a, \
                    open(tmp_path / f"port_{arch}" / name, "rb") as b:
                assert a.read() == b.read(), name
    assert any("_val_" in n for n in outs["port"])
    toks, _, info = read_shard(str(tmp_path / "port_qwen3" /
                                   "toy_train_000000.bin"))
    assert info["count"] >= 300 and info["magic"] == MAGIC_QWEN3
    from koifish_tpu_torch.data import BPETokenizer
    tk = BPETokenizer.from_file(tiny_hf)
    assert "hello" in tk.decode(np.asarray(toks[:50]).tolist())
    assert _run(pretokenize.main, ["--hf", tiny_hf, "--input",
                                   str(tmp_path / "none*"), "--out",
                                   str(tmp_path / "x")], capsys)[0] == 2
