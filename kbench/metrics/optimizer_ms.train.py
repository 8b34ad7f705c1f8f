"""Device milliseconds of one ``train/optimizer.apply_updates`` over the
cell's own state (AdamW with the recipe's rounding, every leaf), by CUDA
events, the median of three calls after the window. Moves
``train_tok_s``."""
import statistics


def read(run):
    ms = run["layer"].get("optimizer_ms")
    return statistics.median(ms) if ms else None
