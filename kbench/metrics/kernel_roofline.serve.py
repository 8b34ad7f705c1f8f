"""The profiled engine steps' least time on the chip (each prefill and
each decode step the larger of its operations' and its bytes' time, the
decode's bytes the weights and the live KV rows, ``kbench/work.py``)
over the time the device was busy in them, in percent. Moves
``serve_tok_s``."""


def read(run):
    tr = run["layer"].get("trace")
    if not tr or not tr.get("work") or tr["busy_s"] <= 0:
        return None
    if tr["work"]["least_s"] <= 0:
        return None
    return 100.0 * tr["work"]["least_s"] / tr["busy_s"]
