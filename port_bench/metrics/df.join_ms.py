"""Milliseconds of ``join`` an iteration, from the benchmark's
synchronized span around the call, the mean over the traced run's
iterations, the slowest rank's."""


def read(ctx):
    if ctx.get("kind") != "dataframe":
        return None
    ms = [r["ms"]["join"] for r in ctx["ranks"] if r["ms"].get("join") is not None]
    return max(ms) if ms else None
