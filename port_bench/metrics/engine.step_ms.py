"""Mean wall milliseconds of the engine's ``step()`` calls that lie in
the window, from the benchmark's span around each call."""


def read(ctx):
    if ctx.get("kind", "serve") != "serve":
        return None
    steps = [s for s in ctx["steps"] if s["t0"] >= ctx["w0"] and s["t1"] <= ctx["w1"]]
    if not steps:
        return None
    return 1e3 * sum(s["t1"] - s["t0"] for s in steps) / len(steps)
