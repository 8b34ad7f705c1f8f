"""Chat templating — ChatML rendering for prompts and SFT samples.

The JAX package's ``data/chat_template.py``: the model's own template runs
through the port's zero-dependency engine (``data/jinja.py``) when the
model ships one, and a template error raises instead of falling back to
hardcoded ChatML. The arch-default renderers are used only when the model
ships no template.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

from koifish_tpu_torch.data.jinja import render_template

Message = Dict[str, str]

IM_START, IM_END = "<|im_start|>", "<|im_end|>"


def render_chatml(messages: Sequence[Message], add_generation_prompt: bool = True,
                  default_system: Optional[str] = None,
                  enable_thinking: bool = False) -> str:
    """Qwen-style ChatML."""
    out = []
    if default_system and not any(m["role"] == "system" for m in messages):
        out.append(f"{IM_START}system\n{default_system}{IM_END}\n")
    for m in messages:
        out.append(f"{IM_START}{m['role']}\n{m['content']}{IM_END}\n")
    if add_generation_prompt:
        out.append(f"{IM_START}assistant\n")
        if not enable_thinking:
            out.append("<think>\n\n</think>\n\n")
    return "".join(out)


def render_plain(messages: Sequence[Message], **_) -> str:
    """GPT2-style: plain concatenation."""
    return "\n".join(m["content"] for m in messages)


def load_hf_chat_template(model_dir: str) -> Optional[str]:
    # chat_template.jinja (new HF layout) takes precedence
    jpath = os.path.join(model_dir, "chat_template.jinja")
    if os.path.exists(jpath):
        with open(jpath, encoding="utf-8") as f:
            return f.read()
    cfg = os.path.join(model_dir, "tokenizer_config.json")
    if not os.path.exists(cfg):
        return None
    with open(cfg, encoding="utf-8") as f:
        return json.load(f).get("chat_template")


def _special_tokens(model_dir: Optional[str]) -> Dict[str, str]:
    """bos/eos token strings some templates reference."""
    out = {"bos_token": "", "eos_token": ""}
    if not model_dir:
        return out
    cfg = os.path.join(model_dir, "tokenizer_config.json")
    if os.path.exists(cfg):
        with open(cfg, encoding="utf-8") as f:
            j = json.load(f)
        for k in ("bos_token", "eos_token", "unk_token", "pad_token"):
            v = j.get(k)
            if isinstance(v, dict):
                v = v.get("content")
            if isinstance(v, str):
                out[k] = v
    return out


def render(messages: Sequence[Message], model_dir: Optional[str] = None,
           arch: str = "QWEN3", add_generation_prompt: bool = True,
           enable_thinking: bool = False, tools=None, **extra) -> str:
    """Render messages with the model's own template when one ships with
    the model, else the arch-default renderer. Template errors raise."""
    template = load_hf_chat_template(model_dir) if model_dir else None
    if template:
        ctx = dict(_special_tokens(model_dir))
        ctx.update(extra)
        return render_template(
            template, messages=list(messages), tools=tools,
            add_generation_prompt=add_generation_prompt,
            enable_thinking=enable_thinking, **ctx)
    if arch.upper().startswith("GPT2"):
        return render_plain(messages)
    return render_chatml(messages, add_generation_prompt,
                         enable_thinking=enable_thinking)


def sft_sample_to_tokens(tokenizer, messages: Sequence[Message],
                         ) -> tuple[List[int], List[bool]]:
    """Render a conversation to (tokens, loss_mask) — loss only on
    assistant spans."""
    tokens: List[int] = []
    mask: List[bool] = []
    for m in messages:
        head = tokenizer.encode(f"{IM_START}{m['role']}\n")
        body = tokenizer.encode(m["content"])
        tail = tokenizer.encode(f"{IM_END}\n")
        is_target = m["role"] == "assistant"
        tokens += head + body + tail
        mask += [False] * len(head) + [is_target] * len(body) + \
            [is_target] * len(tail)
    return tokens, mask
