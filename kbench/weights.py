"""Seeded weights, made by the benchmark on the device and handed alike to
the program and to the plain reference.

The tree is the one the port's models read (``{"wte", "ln_f", ...,
"layers": [{"q", "k", ...}]}``), a dict of plain tensors. Matrices are
GPT-2's init, normal(0, 0.02) with the residual outputs (``o``,
``proj``, ``down``) at 0.02 / sqrt(2L); gains are 1 and biases 0. The
normals come from one ``torch.Generator`` on the device in one call, in
the served type (bf16), and are cut into leaves; the same seed gives the
same bits.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import torch

from kbench.work import Shapes

RESIDUAL_OUT = ("o", "proj", "down")


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of the run's ``--seed``."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def layout(sh: Shapes) -> List[Tuple[Tuple, Tuple[int, ...], str]]:
    """(path, shape, kind) of every leaf; kind is ``normal``,
    ``residual``, ``one`` or ``zero``. A path is ("wte",) or
    ("layers", i, "q")."""
    E = sh.E
    out = [(("wte",), (sh.V, E), "normal"), (("ln_f",), (E,), "one")]
    if not sh.gated:
        out += [(("ln_f_b",), (E,), "zero"), (("wpe",), (1024, E), "normal")]
    for i in range(sh.L):
        for name, k, n in sh.linears():
            kind = "residual" if name in RESIDUAL_OUT else "normal"
            out.append((("layers", i, name), (k, n), kind))
            if not sh.gated:
                out.append((("layers", i, name + "_b"), (n,), "zero"))
        out += [(("layers", i, "ln1"), (E,), "one"),
                (("layers", i, "ln2"), (E,), "one")]
        if sh.gated:
            out += [(("layers", i, "qn"), (sh.D,), "one"),
                    (("layers", i, "kn"), (sh.D,), "one")]
        else:
            out += [(("layers", i, "ln1_b"), (E,), "zero"),
                    (("layers", i, "ln2_b"), (E,), "zero")]
    return out


def make(sh: Shapes, seed: int, device, dtype=torch.bfloat16) -> Dict:
    """The weight tree of ``sh`` from ``seed``."""
    lay = layout(sh)
    rand = [(p, s, k) for p, s, k in lay if k in ("normal", "residual")]
    total = sum(math.prod(s) for _, s, _ in rand)
    gen = torch.Generator(device=device)
    gen.manual_seed(subseed(seed, "weights"))
    flat = torch.randn((total,), generator=gen, device=device, dtype=dtype)
    tree: Dict = {"layers": [dict() for _ in range(sh.L)]}
    res = 0.02 / math.sqrt(2 * sh.L)
    off = 0
    for path, shape, kind in lay:
        if kind in ("normal", "residual"):
            n = math.prod(shape)
            leaf = flat[off: off + n].view(shape).clone()
            leaf.mul_(0.02 if kind == "normal" else res)
            off += n
        elif kind == "one":
            leaf = torch.ones(shape, device=device, dtype=dtype)
        else:
            leaf = torch.zeros(shape, device=device, dtype=dtype)
        if path[0] == "layers":
            tree["layers"][path[1]][path[2]] = leaf
        else:
            tree[path[0]] = leaf
    del flat
    return tree


def named(tree: Dict) -> List[Tuple[str, torch.Tensor]]:
    """(name, leaf) in sorted-key order, lists in order: the order in which
    the recipe's stochastic rounding draws one seed a leaf."""
    out: List[Tuple[str, torch.Tensor]] = []

    def walk(t, pre):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], pre + (str(k),))
        elif isinstance(t, (list, tuple)):
            for i, x in enumerate(t):
                walk(x, pre + (str(i),))
        else:
            out.append((".".join(pre), t))
    walk(tree, ())
    return out
