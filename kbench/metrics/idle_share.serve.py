"""The share of the profiled engine steps' wall in which no kernel, copy
or set ran on the device (``torch.profiler``), in percent. Moves
``serve_tok_s``."""


def read(run):
    tr = run["layer"].get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
