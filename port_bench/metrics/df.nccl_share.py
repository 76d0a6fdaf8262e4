"""Share of rank 0's traced window in which NCCL's kernels ran on its
card (the exchanges' all-to-alls and the reductions' all-reduces)."""


def read(ctx):
    if ctx.get("kind") != "dataframe":
        return None
    r0 = ctx["ranks"][0]
    if not r0.get("window_s"):
        return None
    return 100.0 * r0["nccl_s"] / r0["window_s"]
