"""The window's share of the chip's peak: the least time of the steps'
matmul work (bf16 FLOPs at the bf16 peak, int8 operations at the int8
peak, counted from shapes by ``kbench/work.py``) over the window's wall,
in percent. Moves ``train_tok_s``."""


def read(run):
    pk, lay = run["peaks"], run["layer"]
    if pk is None or not lay.get("steps"):
        return None
    return 100.0 * lay["steps"] * lay["step_work"].ops_s(pk) / lay["window_s"]
