"""Share of the traced window in which no operation ran on the card:
one minus the union of the trace's device intervals over the window."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or ctx.get("kind", "serve") != "serve" or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
