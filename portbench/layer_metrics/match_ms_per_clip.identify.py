"""Embeddings, cosine match and gate per clip of an --identify batch: the
benchmark's span around the call, less its ingest and features phases
(model load and printing included)."""


def read(run):
    if not run.units:
        return None
    rest = sum(u["end"] - u["start"] - u["phase_seconds"].get("ingest", 0.0)
               - u["phase_seconds"].get("features", 0.0) for u in run.units)
    return 1e3 * rest / sum(u["clips"] for u in run.units)
