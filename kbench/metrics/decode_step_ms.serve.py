"""Host milliseconds of one decode step of the batcher: its
``decode_wall_s`` (each dispatch to the transfer of its tokens) over the
decode steps dispatched in the window. Moves ``serve_tok_s``."""


def read(run):
    lay = run["layer"]
    n = lay.get("decode_steps")
    return 1e3 * lay["decode_wall_s"] / n if n else None
