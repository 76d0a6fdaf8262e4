"""Share of decode rows that carried a live sequence over the window:
``decode_slot_steps / (decode_steps * max_slots)`` from the engine's
counters, zeroed as the window opened and read as it closed."""


def read(ctx):
    st = ctx.get("stats")
    if not st or not st.get("decode_steps"):
        return None
    return 100.0 * st["decode_slot_steps"] / (st["decode_steps"] * ctx["max_slots"])
