"""The general generator of requests: a traffic mix's file gives the
distributions of prompt and output lengths; the seed gives the order and
the token ids.

Every seed draws the same set of sizes: the i-th request takes the
quantile u_i = frac(offset + i / phi) of each distribution (a golden-ratio
sequence, so any run of consecutive requests spreads evenly over the
distribution), and the seed sets only the offsets and the ids, which are
uniform over the vocabulary. Runs with different seeds then do the same
work in another order.
"""
from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import List

import numpy as np

from kbench.weights import subseed

PHI = (1 + 5 ** 0.5) / 2


@dataclasses.dataclass(frozen=True)
class Req:
    index: int
    prompt: List[int]
    max_new: int


#: the keys of a length distribution, by kind
DIST_KEYS = {"lognormal": {"dist", "sigma", "min", "max"},
             "uniform": {"dist", "min", "max"}}


def check_keys(spec: dict, allowed, what: str) -> None:
    """Refuse a mix or a distribution with a key nothing reads."""
    extra = set(spec) - set(allowed)
    if extra:
        raise ValueError(f"{what}: no reader for {sorted(extra)}")


def quantile(spec: dict, u: float) -> int:
    """The ``u`` quantile of a length distribution, clipped to its range.

    A lognormal gives its ``median`` or its ``mean`` (the median is then
    mean * exp(-sigma^2 / 2)), and its ``sigma``."""
    lo, hi = int(spec["min"]), int(spec["max"])
    kind = spec["dist"]
    if kind not in DIST_KEYS:
        raise ValueError(f"unknown length distribution {kind!r}")
    if kind == "lognormal":
        centre = {"median", "mean"} & set(spec)
        if len(centre) != 1:
            raise ValueError("a lognormal gives one of median and mean")
        check_keys(spec, DIST_KEYS[kind] | centre, "lognormal")
        s = float(spec["sigma"])
        med = (float(spec["median"]) if "median" in spec
               else float(spec["mean"]) * math.exp(-s * s / 2))
        z = NormalDist().inv_cdf(min(max(u, 1e-9), 1 - 1e-9))
        x = med * math.exp(s * z)
        return int(min(max(round(x), lo), hi))
    check_keys(spec, DIST_KEYS[kind], kind)
    return lo + min(int(u * (hi - lo + 1)), hi - lo)


class Requests:
    """The mix's requests in order, each made when it is asked for."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix, self.seed, self.vocab = mix, int(seed), int(vocab)
        off = np.random.default_rng(subseed(seed, "offsets")).random(2)
        self.off_p, self.off_o = float(off[0]), float(off[1])

    def sizes(self, i: int):
        up = (self.off_p + i / PHI) % 1.0
        uo = (self.off_o + i * (2 ** 0.5 - 1)) % 1.0
        return (quantile(self.mix["prompt"], up),
                quantile(self.mix["output"], uo))

    def get(self, i: int) -> Req:
        n, m = self.sizes(i)
        rng = np.random.default_rng([subseed(self.seed, "ids"), i])
        ids = rng.integers(0, self.vocab, n, dtype=np.int64).tolist()
        return Req(index=i, prompt=ids, max_new=m)
