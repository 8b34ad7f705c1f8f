"""Host milliseconds a train step waited for its next batch: the span
around ``TokenDataset.batches``' next batch and its copy to the device,
averaged over the window's steps. Moves ``train_tok_s``."""


def read(run):
    waits = run["layer"].get("spans", {}).get("data_wait")
    return 1e3 * sum(waits) / len(waits) if waits else None
