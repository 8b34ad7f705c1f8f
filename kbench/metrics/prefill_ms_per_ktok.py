"""Milliseconds of admission per thousand prompt tokens: the batcher's
``Request.ttft_s`` (its prefill, lane merge and first sample, from
admission) summed over the requests admitted in the window, over their
prompt tokens. Moves ``ttft_p90_ms``."""


def read(run):
    lay = run["layer"]
    n = lay.get("prompt_tokens")
    return 1e6 * lay["prefill_s"] / n if n else None
