"""Share of the prefill chunks' slab positions that carried no prompt
token over the window: ``1 - prefill_tokens / prefill_slab_positions``
from the engine's counters (a chunk runs ``max_slots`` rows of its
power-of-two width), zeroed as the window opened and read as it closed.
A program without the slab counter gives nothing."""


def read(ctx):
    st = ctx.get("stats")
    if not st or not st.get("prefill_slab_positions"):
        return None
    return 100.0 * (1.0 - st["prefill_tokens"] / st["prefill_slab_positions"])
