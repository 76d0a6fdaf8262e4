"""Prompt tokens a prefill chunk carried over the window:
``prefill_tokens / prefill_chunks`` from the engine's counters."""


def read(ctx):
    st = ctx.get("stats")
    if not st or not st.get("prefill_chunks"):
        return None
    return st["prefill_tokens"] / st["prefill_chunks"]
