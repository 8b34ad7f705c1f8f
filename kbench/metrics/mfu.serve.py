"""The window's share of the chip's peak: the least time of the matmul
work served (each admitted prompt's prefill and each kept decode token,
counted from shapes by ``kbench/work.py``) over the window's wall, in
percent. Moves ``serve_tok_s``."""


def read(run):
    w = run["layer"].get("serve_work")
    if not w or w["ops_s"] <= 0:
        return None
    return 100.0 * w["ops_s"] / run["layer"]["window_s"]
