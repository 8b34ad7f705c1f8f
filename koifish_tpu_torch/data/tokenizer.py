"""Byte-level BPE tokenizer (HF tokenizer.json), self-contained.

The JAX package's ``data/tokenizer.py`` (``BPETokenizer``: byte-level
pretokens, ranked merges with a byte fallback, added special tokens) on the
standard library alone. The GPT2/Qwen pretokenizer patterns use the Unicode
property classes ``\\p{L}`` (letters) and ``\\p{N}`` (numbers), which
Python's ``re`` does not know (its ``\\d`` is Nd only: it misses Roman
numerals, Nl, and fractions, No). ``unicode_pattern`` rewrites each
``\\p{..}``/``\\P{..}`` into a character class of code-point ranges built
once from ``unicodedata``; a pattern read from a ``tokenizer.json`` goes
through the same rewrite.
"""
from __future__ import annotations

import json
import logging
import os
import re
import sys
import unicodedata
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

# GPT2/Qwen byte-level BPE pretokenization patterns
_GPT2_PAT = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+|"
             r" ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")
_QWEN_PAT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"
             r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")

_PROP = re.compile(r"\\([pP])(?:\{(\^?)([A-Za-z_]+)\}|([A-Za-z]))")


def _esc(cp: int) -> str:
    return f"\\U{cp:08x}"


@lru_cache(maxsize=None)
def _category_ranges(name: str) -> str:
    """The code points of general category ``name`` (a one-letter major
    class such as ``L``, or a full category such as ``Nd``) as the body of a
    character class: ``lo-hi`` ranges with ``\\U`` escapes."""
    cats = {c for c in ("Lu", "Ll", "Lt", "Lm", "Lo", "Mn", "Mc", "Me", "Nd",
                        "Nl", "No", "Pc", "Pd", "Ps", "Pe", "Pi", "Pf", "Po",
                        "Sm", "Sc", "Sk", "So", "Zs", "Zl", "Zp", "Cc", "Cf",
                        "Cs", "Co", "Cn") if c == name or c[0] == name}
    if not cats:
        raise ValueError(f"unsupported Unicode property \\p{{{name}}}")
    parts, lo, prev = [], None, None
    for cp in range(sys.maxunicode + 1):
        if unicodedata.category(chr(cp)) in cats:
            if lo is None:
                lo = cp
            prev = cp
        elif lo is not None:
            parts.append(_esc(lo) if lo == prev else f"{_esc(lo)}-{_esc(prev)}")
            lo = None
    if lo is not None:
        parts.append(f"{_esc(lo)}-{_esc(prev)}")
    return "".join(parts)


def unicode_pattern(pattern: str) -> str:
    """Rewrite ``\\p{X}`` / ``\\P{X}`` (and ``\\pX``) for stdlib ``re``:
    outside a character class into ``[..]`` / ``[^..]``, inside one into
    the ranges themselves (a negated property inside a class is refused)."""
    out, i, in_class = [], 0, False
    while i < len(pattern):
        ch = pattern[i]
        if ch == "\\":
            m = _PROP.match(pattern, i)
            if m is None:                 # any other escape: copy it whole
                out.append(pattern[i:i + 2])
                i += 2
                continue
            neg = (m.group(1) == "P") != bool(m.group(2))
            body = _category_ranges(m.group(3) or m.group(4))
            if in_class:
                if neg:
                    raise ValueError(f"negated property {m.group(0)} inside "
                                     f"a character class is not supported")
                out.append(body)
            else:
                out.append(f"[{'^' if neg else ''}{body}]")
            i = m.end()
            continue
        if ch == "[" and not in_class:
            in_class = True
            out.append(ch)
            i += 1
            if pattern.startswith("^", i):
                out.append("^")
                i += 1
            if pattern.startswith("]", i):   # a leading ] is a literal
                out.append("\\]")
                i += 1
            continue
        if ch == "]" and in_class:
            in_class = False
        out.append(ch)
        i += 1
    return "".join(out)


@lru_cache(maxsize=None)
def _compile(pattern: str) -> "re.Pattern":
    return re.compile(unicode_pattern(pattern))


@lru_cache()
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT2's reversible byte→unicode mapping (printable chars only)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


class BPETokenizer:
    """Encode/decode with ranked-merge BPE over byte-level pretokens."""

    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]],
                 pattern: str = _QWEN_PAT,
                 special_tokens: Optional[Dict[str, int]] = None):
        self.vocab = vocab
        self.id_to_token = {v: k for k, v in vocab.items()}
        self.ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.pat = _compile(pattern)
        self.special = dict(special_tokens or {})
        for t, i in self.special.items():
            self.id_to_token.setdefault(i, t)
        self._b2u = _bytes_to_unicode()
        self._u2b = {u: b for b, u in self._b2u.items()}
        if self.special:
            self._special_pat = re.compile(
                "(" + "|".join(re.escape(t) for t in
                               sorted(self.special, key=len, reverse=True)) + ")")
        else:
            self._special_pat = None
        self._cache: Dict[str, List[int]] = {}
        self._native = None       # the C++ merge engine, built at first use
        self._native_tried = False

    def _native_engine(self):
        """``native.NativeBPE`` over this vocab, or None where the library
        or the engine cannot be made (logged through ``kernel_log``)."""
        if not self._native_tried:
            self._native_tried = True
            try:
                from koifish_tpu_torch.native import NativeBPE
                self._native = NativeBPE(self)
            except (RuntimeError, OSError, KeyError) as e:
                from koifish_tpu_torch.utils import kernel_log
                kernel_log.fallback("native_bpe", f"{type(e).__name__}: "
                                    f"{str(e).splitlines()[0]}")
                self._native = None
        return self._native

    # -- construction -------------------------------------------------------

    @classmethod
    def from_file(cls, path: str) -> "BPETokenizer":
        """Load a HF tokenizer.json (or a model dir containing one)."""
        if os.path.isdir(path):
            path = os.path.join(path, "tokenizer.json")
        with open(path, encoding="utf-8") as f:
            tj = json.load(f)
        model = tj["model"]
        vocab = model["vocab"]
        merges = [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
                  for m in model["merges"]]
        special = {t["content"]: t["id"] for t in tj.get("added_tokens", [])}
        pattern = _QWEN_PAT
        pre = tj.get("pre_tokenizer") or {}
        for sub in pre.get("pretokenizers", [pre]):
            if sub.get("type") == "Split" and isinstance(sub.get("pattern"), dict):
                pattern = sub["pattern"].get("Regex", pattern)
                break
        return cls(vocab, merges, pattern, special)

    @classmethod
    def gpt2(cls, vocab_path: str, merges_path: str) -> "BPETokenizer":
        with open(vocab_path, encoding="utf-8") as f:
            vocab = json.load(f)
        merges = []
        with open(merges_path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                merges.append(tuple(line.split(" ", 1)))
        return cls(vocab, merges, _GPT2_PAT,
                   {"<|endoftext|>": vocab.get("<|endoftext|>", 50256)})

    # -- core ---------------------------------------------------------------

    def _bpe(self, pretoken: str) -> List[int]:
        cached = self._cache.get(pretoken)
        if cached is not None:
            return cached
        parts = [self._b2u[b] for b in pretoken.encode("utf-8")]
        while len(parts) > 1:
            best, best_rank = -1, None
            for i in range(len(parts) - 1):
                r = self.ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best_rank is None:
                break
            parts = (parts[:best] + [parts[best] + parts[best + 1]]
                     + parts[best + 2:])
        ids: List[int] = []
        for p in parts:
            i = self.vocab.get(p)
            if i is not None:
                ids.append(i)
                continue
            # byte fallback: a merged piece missing from the vocab decomposes
            # into its byte-units (all 256 byte chars exist in byte-level
            # vocabs); input is never dropped silently
            for ch in p:
                j = self.vocab.get(ch)
                if j is not None:
                    ids.append(j)
                else:
                    logging.getLogger("koifish_tpu_torch").warning(
                        "tokenizer: no byte token for %r — dropped", ch)
        if len(pretoken) < 64:
            self._cache[pretoken] = ids
        return ids

    def encode(self, text: str, allow_special: bool = True) -> List[int]:
        out: List[int] = []
        if allow_special and self._special_pat is not None:
            chunks = self._special_pat.split(text)
        else:
            chunks = [text]
        native = self._native_engine()
        for chunk in chunks:
            if not chunk:
                continue
            if chunk in self.special:
                out.append(self.special[chunk])
                continue
            pretokens = [m.group() for m in self.pat.finditer(chunk)]
            if native is not None:
                out.extend(native.encode_pretokens(pretokens))
            else:
                for p in pretokens:
                    out.extend(self._bpe(p))
        return out

    def decode(self, ids: Sequence[int]) -> str:
        buf = bytearray()
        for i in ids:
            tok = self.id_to_token.get(int(i))
            if tok is None:
                continue
            if tok in self.special:
                buf += tok.encode("utf-8")
            else:
                buf += bytes(self._u2b[ch] for ch in tok)
        return buf.decode("utf-8", errors="replace")

    @property
    def vocab_size(self) -> int:
        return max(max(self.vocab.values()),
                   max(self.special.values(), default=0)) + 1

    def token_id(self, token: str) -> Optional[int]:
        return self.special.get(token, self.vocab.get(token))


class ScoreTokenizer:
    """Tokenizer over the reference's binary ``tokenizer.dat`` table
    (PreTokenizer.py:136-146; used by GTokenizer at infer time,
    cases/tutorial/tutorial_qwen3.md:33-36).

    Encode is score-greedy merge (the llama2.c/sentencepiece style the
    scores are built for: score = -log(merge_rank+1), so the
    highest-scoring adjacent pair merges first — equivalent to ranked
    BPE). Decode is a byte-table join."""

    def __init__(self, tokens: List[bytes], scores: List[float],
                 bos_id: int = 0, eos_id: int = 0):
        self.tokens = tokens
        self.scores = scores
        self.bos_id, self.eos_id = bos_id, eos_id
        self.lookup: Dict[bytes, int] = {}
        for i, t in enumerate(tokens):
            self.lookup.setdefault(t, i)

    @classmethod
    def from_tokenizer_dat(cls, path: str) -> "ScoreTokenizer":
        from koifish_tpu_torch.io.kun import read_tokenizer_dat
        d = read_tokenizer_dat(path)
        return cls(d["tokens"], d["scores"], d["bos_id"], d["eos_id"])

    def encode(self, text: str, allow_special: bool = True) -> List[int]:
        data = text.encode("utf-8")
        ids: List[int] = []
        for b in data:
            i = self.lookup.get(bytes([b]))
            if i is not None:
                ids.append(i)
        # greedy highest-score merge until no adjacent pair is in vocab
        while len(ids) > 1:
            best, best_score, best_id = -1, None, -1
            for i in range(len(ids) - 1):
                cat = self.tokens[ids[i]] + self.tokens[ids[i + 1]]
                j = self.lookup.get(cat)
                if j is not None and (best_score is None
                                      or self.scores[j] > best_score):
                    best, best_score, best_id = i, self.scores[j], j
            if best < 0:
                break
            ids = ids[:best] + [best_id] + ids[best + 2:]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        return b"".join(self.tokens[int(i)] for i in ids
                        if 0 <= int(i) < len(self.tokens)
                        ).decode("utf-8", errors="replace")

    @property
    def vocab_size(self) -> int:
        return len(self.tokens)

    def token_id(self, token: str) -> Optional[int]:
        return self.lookup.get(token.encode("utf-8"))
