"""The profiled steps' least time on the chip (each step the larger of its
operations' and its bytes' time, ``kbench/work.py``) over the time the
device was busy in them, in percent: how near the kernels run to their
roofline, whichever kernels do the work. Moves ``train_tok_s``."""


def read(run):
    pk, tr = run["peaks"], run["layer"].get("trace")
    if pk is None or not tr or tr["busy_s"] <= 0:
        return None
    least = tr["steps"] * run["layer"]["step_work"].least_s(pk)
    return 100.0 * least / tr["busy_s"]
