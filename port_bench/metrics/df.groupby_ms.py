"""Milliseconds of ``groupby_sum`` an iteration, from the benchmark's
synchronized span around the call (a card synchronize before and after),
the mean over the traced run's iterations, the slowest rank's."""


def read(ctx):
    if ctx.get("kind") != "dataframe":
        return None
    ms = [r["ms"]["groupby"] for r in ctx["ranks"] if r["ms"].get("groupby") is not None]
    return max(ms) if ms else None
