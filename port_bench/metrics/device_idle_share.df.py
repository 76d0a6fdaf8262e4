"""Share of rank 0's traced window in which no operation ran on its card:
one minus the union of the trace's device intervals over the window."""


def read(ctx):
    if ctx.get("kind") != "dataframe":
        return None
    r0 = ctx["ranks"][0]
    if not r0.get("window_s"):
        return None
    return 100.0 * (1.0 - r0["busy_s"] / r0["window_s"])
