"""The general generator: deterministic per seed, the stated
distributions, the same sizes for every seed in another order."""
import json
import math
import statistics
from pathlib import Path

import numpy as np
import pytest

from kbench.traffic import Requests, quantile

MIX = json.loads((Path(__file__).resolve().parents[1] / "traffic" /
                  "docqa-c48.json").read_text())
SEEDS = (1, 2 ** 31 + 11, 3999999979)


@pytest.mark.parametrize("seed", SEEDS)
def test_requests_are_deterministic_per_seed(seed):
    a, b = Requests(MIX, seed, 151936), Requests(MIX, seed, 151936)
    for i in (0, 1, 17, 300):
        ra, rb = a.get(i), b.get(i)
        assert ra.prompt == rb.prompt and ra.max_new == rb.max_new
    c = Requests(MIX, seed + 1, 151936)
    assert a.get(0).prompt != c.get(0).prompt


def _median(spec):
    return spec["mean"] * math.exp(-spec["sigma"] ** 2 / 2)


@pytest.mark.parametrize("part", ["prompt", "output"])
@pytest.mark.parametrize("seed", SEEDS)
def test_lengths_follow_the_stated_distributions(seed, part):
    r = Requests(MIX, seed, 151936)
    sizes = [r.sizes(i)[part == "output"] for i in range(1000)]
    spec = MIX[part]
    assert min(sizes) >= spec["min"] and max(sizes) <= spec["max"]
    med = _median(spec)
    assert abs(statistics.median(sizes) / med - 1) < 0.02
    # the shares clipped at each end are the lognormal's tails there
    nd = statistics.NormalDist()
    z_hi = math.log(spec["max"] / med) / spec["sigma"]
    z_lo = math.log(spec["min"] / med) / spec["sigma"]
    hi = sum(p == spec["max"] for p in sizes) / len(sizes)
    lo = sum(p == spec["min"] for p in sizes) / len(sizes)
    assert abs(hi - (1 - nd.cdf(z_hi))) < 0.01
    assert abs(lo - nd.cdf(z_lo)) < 0.005


def test_a_lognormal_keeps_its_stated_mean():
    spec = {"dist": "lognormal", "mean": 182, "sigma": 0.8, "min": 1,
            "max": 10 ** 9}
    xs = [quantile(spec, (i + 0.5) / 20000) for i in range(20000)]
    assert abs(statistics.mean(xs) / 182 - 1) < 0.01


def test_uniform_lengths_cover_their_range():
    mix = dict(MIX, output={"dist": "uniform", "min": 16, "max": 64})
    r = Requests(mix, 5, 151936)
    outs = [r.sizes(i)[1] for i in range(1000)]
    assert min(outs) == 16 and max(outs) == 64
    counts = np.bincount(outs)[16:]
    assert counts.min() >= 15 and counts.max() <= 26     # ~20.4 each


def test_every_seed_draws_the_same_sizes():
    means = []
    for seed in SEEDS:
        r = Requests(MIX, seed, 151936)
        s = [r.sizes(i) for i in range(1000)]
        means.append((statistics.mean(p for p, _ in s),
                      statistics.mean(o for _, o in s)))
    for p, o in means:
        assert abs(p / means[0][0] - 1) < 0.01
        assert abs(o / means[0][1] - 1) < 0.01


@pytest.mark.parametrize("seed", SEEDS)
def test_token_ids_are_uniform_over_the_vocabulary(seed):
    r = Requests(MIX, seed, 151936)
    ids = np.concatenate([r.get(i).prompt for i in range(4)])
    assert ids.min() >= 0 and ids.max() < 151936
    assert abs(ids.mean() / (151936 / 2) - 1) < 0.02


def test_quantile_edges():
    spec = {"dist": "uniform", "min": 16, "max": 64}
    assert quantile(spec, 0.0) == 16 and quantile(spec, 0.999999) == 64
    with pytest.raises(ValueError):
        quantile({"dist": "zipf", "min": 1, "max": 2}, 0.5)
    with pytest.raises(ValueError, match="one of median and mean"):
        quantile({"dist": "lognormal", "mean": 5, "median": 5, "sigma": 1,
                  "min": 1, "max": 9}, 0.5)
    with pytest.raises(ValueError, match="shape"):
        quantile({"dist": "uniform", "min": 1, "max": 9, "shape": 2}, 0.5)


def test_training_shard_is_deterministic(tmp_path):
    from kbench import manifest
    from kbench.tests import tiny
    drv = manifest.driver("train")
    cfg = tiny.gpt2_config()
    rc = tiny.context(cfg, tiny.train_mix(), {}, seed=5)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    pa = drv._shard(rc, str(tmp_path / "a"))
    pb = drv._shard(rc, str(tmp_path / "b"))
    assert Path(pa).read_bytes() == Path(pb).read_bytes()
    rc2 = tiny.context(cfg, tiny.train_mix(), {}, seed=6)
    (tmp_path / "c").mkdir()
    pc = drv._shard(rc2, str(tmp_path / "c"))
    assert Path(pa).read_bytes() != Path(pc).read_bytes()
