"""The work of a call, counted from shapes: matmul operations and the bytes
each input is read and each output written once. The benchmark's own
yardstick, frozen here: the FLOP convention of the port's
``utils/mfu.py`` (PaLM: 2 operations a multiply-add, the backward twice
the forward, the embedding gather left out, the causal attention's
half-square) and ``chip_smoke.py::bound_ms`` (the larger of the bytes'
time and the operations' time, bf16 and int8 each at its peak).

A recomputation (remat, a backward that rebuilds logits) is not work the
function needs, so it is not counted: the least time bounds every
implementation of the same function.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

#: published dense peaks of NVIDIA's data sheets: (bf16 FLOP/s, int8
#: OP/s, HBM bytes/s), keyed by substrings of the device's name; the first
#: match wins
PEAKS = (
    ("H100 PCIe", (756e12, 1513e12, 2.0e12)),
    ("H100 NVL", (835e12, 1670e12, 3.9e12)),
    ("H100", (989e12, 1979e12, 3.35e12)),     # SXM, "NVIDIA H100 80GB HBM3"
)


def peaks(device_name: str) -> Optional[Tuple[float, float, float]]:
    for key, val in PEAKS:
        if key in device_name:
            return val
    return None


@dataclasses.dataclass(frozen=True)
class Shapes:
    """A decoder's sizes, from a configuration file's ``koifish.model``."""
    L: int
    E: int
    Hq: int
    Hkv: int
    D: int
    F: int
    V: int
    gated: bool          # SwiGLU (gate, up, down) or a GELU MLP (fc, proj)
    learned_pos: bool

    @classmethod
    def from_config(cls, cfg: dict) -> "Shapes":
        m = cfg["koifish"]["model"]
        p = m["parameter"]
        t = p["transformer"]
        E, Hq = int(t["Embed"]), int(t["Head"])
        arch = m["arch"].upper()
        return cls(L=int(p["Layer"]), E=E, Hq=Hq,
                   Hkv=int(t.get("KVHead", Hq)),
                   D=int(t.get("head_dim", E // Hq)), F=int(t["Ffn"]),
                   V=int(m["vocab_size"]), gated=arch != "GPT2",
                   learned_pos=arch == "GPT2")

    def linears(self) -> List[Tuple[str, int, int]]:
        """One layer's projections as (name, K, N): y[., N] = x[., K] w."""
        q, kv = self.Hq * self.D, self.Hkv * self.D
        out = [("q", self.E, q), ("k", self.E, kv), ("v", self.E, kv),
               ("o", q, self.E)]
        if self.gated:
            out += [("gate", self.E, self.F), ("up", self.E, self.F),
                    ("down", self.F, self.E)]
        else:
            out += [("fc", self.E, self.F), ("proj", self.F, self.E)]
        return out

    def n_params(self) -> int:
        """Every parameter, norms and biases included (tied head)."""
        n = self.V * self.E + self.E * (1 if self.gated else 2)
        per = sum(k * n_ for _, k, n_ in self.linears())
        if self.gated:
            per += 2 * self.E + 2 * self.D           # ln1, ln2, qn, kn
        else:
            per += 4 * self.E + sum(n_ for _, _, n_ in self.linears())
        if self.learned_pos:
            n += 1024 * self.E
        return n + self.L * per


@dataclasses.dataclass
class Work:
    bf16_flops: float = 0.0
    int8_ops: float = 0.0
    nbytes: float = 0.0

    def __iadd__(self, o: "Work") -> "Work":
        self.bf16_flops += o.bf16_flops
        self.int8_ops += o.int8_ops
        self.nbytes += o.nbytes
        return self

    def ops_s(self, pk) -> float:
        return self.bf16_flops / pk[0] + self.int8_ops / pk[1]

    def least_s(self, pk) -> float:
        """The least time of this one call: operations or bytes."""
        return max(self.ops_s(pk), self.nbytes / pk[2])


def attn_pairs(T: int) -> float:
    """(query, key) pairs of a causal T-row attention."""
    return T * (T + 1) / 2.0


def train_step(sh: Shapes, B: int, T: int, train: dict) -> Work:
    """One optimizer step over B x T tokens. ``train``: the recipe's
    ``int8_matmul``, ``int8_min_kn``, ``int8_dgrad``, ``int8_wgrad``,
    ``moment_bytes``. A projection routed to int8 (its K x N at least
    ``int8_min_kn``) runs its forward in int8 and its dgrad / wgrad in
    int8 only where the recipe says; the tied head takes the same rule
    in the fused CE."""
    N = B * T
    w = Work()
    int8 = bool(train.get("int8_matmul"))
    gate = int(train.get("int8_min_kn", 1 << 24))
    dgrad8 = bool(train.get("int8_dgrad"))
    wgrad8 = bool(train.get("int8_wgrad"))
    mats = [(k, n) for _, k, n in sh.linears()] * sh.L + [(sh.E, sh.V)]
    for k, n in mats:
        f = 2.0 * N * k * n
        routed = int8 and k * n >= gate
        if routed:
            w.int8_ops += f
        else:
            w.bf16_flops += f
        for on8 in (dgrad8, wgrad8):
            if routed and on8:
                w.int8_ops += f
            else:
                w.bf16_flops += f
    attn_fwd = sh.L * B * 2 * 2.0 * attn_pairs(T) * sh.Hq * sh.D
    w.bf16_flops += 3 * attn_fwd
    P = sh.n_params()
    mb = int(train.get("moment_bytes", 4))
    # parameters and both moments read and written once
    w.nbytes = 2 * (2 * P + 2 * mb * P)
    return w


def _weight_bytes(sh: Shapes, group: int = 128) -> float:
    """INT4 codes and one f32 scale a group of every projection, the bf16
    norms and the tied bf16 table."""
    lin = sum(k * n for _, k, n in sh.linears()) * sh.L
    return lin * (0.5 + 4.0 / group) + 2.0 * sh.E * sh.V + \
        2.0 * sh.L * (2 * sh.E + 2 * sh.D)


def _kv_row_bytes(sh: Shapes) -> float:
    """One position's INT8 K and V over every layer, with their scales."""
    return sh.L * sh.Hkv * 2 * (sh.D + 4.0)


def prefill(sh: Shapes, P: int) -> Work:
    """A fresh prefill of P real prompt tokens, logits at the last."""
    w = Work()
    lin = sum(k * n for _, k, n in sh.linears())
    w.bf16_flops = 2.0 * P * lin * sh.L + 2.0 * sh.E * sh.V + \
        sh.L * 2 * 2.0 * attn_pairs(P) * sh.Hq * sh.D
    w.nbytes = _weight_bytes(sh) + 2.0 * P * sh.E + P * _kv_row_bytes(sh)
    return w


def decode_step(sh: Shapes, ctx: Sequence[int]) -> Work:
    """One decode step of the lanes whose live lengths (positions attended,
    the new one included) are ``ctx``."""
    w = Work()
    lin = sum(k * n for _, k, n in sh.linears())
    per_tok = 2.0 * lin * sh.L + 2.0 * sh.E * sh.V
    w.bf16_flops = len(ctx) * per_tok + sum(
        sh.L * 2 * 2.0 * c * sh.Hq * sh.D for c in ctx)
    w.nbytes = _weight_bytes(sh) + sum(c for c in ctx) * _kv_row_bytes(sh) \
        + len(ctx) * 2.0 * sh.E
    return w


def serve_least(sh: Shapes, prompts: Sequence[int],
                steps: Sequence[Sequence[int]], pk) -> Dict[str, float]:
    """Least seconds of a serving window: each prefill and each decode step
    a call of its own. ``ops_s``: the operations alone (for the share of
    the peak); ``least_s``: each call's larger bound (for the roofline)."""
    ops = least = 0.0
    for P in prompts:
        w = prefill(sh, P)
        ops += w.ops_s(pk)
        least += w.least_s(pk)
    for ctx in steps:
        if ctx:
            w = decode_step(sh, ctx)
            ops += w.ops_s(pk)
            least += w.least_s(pk)
    return {"ops_s": ops, "least_s": least}
