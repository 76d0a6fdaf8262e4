"""Faults planted in the program for the benchmark's tests: each breaks
the timed path underneath a run that must then come out not correct."""
from __future__ import annotations


def alter_tokens(engine, every: int = 5) -> None:
    """A served token altered where it is produced: every ``every``-th
    decode step hands each row the next token id instead of its own."""
    decode, calls = engine._decode, [0]

    def altered(*args, **kw):
        tok, logits, cache = decode(*args, **kw)
        calls[0] += 1
        if calls[0] % every == 0:
            tok = (tok + 1) % engine.cfg.vocab_size
        return tok, logits, cache

    engine._decode = altered


def skip_exchange() -> None:
    """The exchange between ranks left out: every rank keeps the buckets
    it would have sent."""
    from repro_torch.dataframe import ops_dist

    def local(sent, table):
        N, cap = sent.shape[1:3]
        return sent.reshape((sent.shape[0], N * cap) + tuple(sent.shape[3:]))

    old, ops_dist._all_to_all = ops_dist._all_to_all, local
    return lambda: setattr(ops_dist, "_all_to_all", old)


def alter_answer() -> None:
    """The answer altered where it is produced: the reduced key sum is one
    off."""
    from repro_torch.dataframe import ops_dist

    reduce_sum = ops_dist.reduce_sum

    def altered(table, cols):
        out = reduce_sum(table, cols)
        if "o_orderkey" in out:
            out["o_orderkey"] += 1.0
        return out

    ops_dist.reduce_sum = altered
    return lambda: setattr(ops_dist, "reduce_sum", reduce_sum)

