"""Serving step factories (mirror of ``repro.train.step``'s
``make_prefill_step(with_cache=True)``, ``make_prefill_chunk_step`` and
``make_decode_step``).  They run eagerly; the caches are updated in
place."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.common.params import map_tree
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models.lm import lm_apply, lm_cache_specs


def _last_valid(logits: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Each row's logits at its last valid position (position 0 for rows
    of length 0) -> ``(next_token [B], last [B, V])``."""
    pick = (lengths.to(torch.int64) - 1).clamp(min=0)
    last = logits[torch.arange(logits.shape[0], device=logits.device), pick]
    return torch.argmax(last, dim=-1).to(torch.int32), last


def make_prefill_step(cfg: ModelConfig, run_cfg: Optional[RunConfig] = None,
                      *, with_cache: bool = False, max_len: Optional[int] = None):
    """Serving prefill into a fresh contiguous cache.

    ``prefill_step(params, tokens, lengths)`` takes right-padded prompts
    ``tokens [B, P]`` with true lengths ``lengths [B]``, runs one ragged
    cache-writing forward at base 0 into a zero ``[B, max_len]`` cache
    (padding tokens write no K/V), and returns ``(next_token [B],
    last_logits [B, V], cache)`` with the logits read at each row's last
    valid position."""
    if not with_cache:
        raise NotImplementedError(
            "the last-logits prefill without a cache is the training slice "
            "(ROADMAP.md queue 1, item 8): pass with_cache=True")
    if cfg.is_encoder_decoder or cfg.input_kind != "tokens":
        raise NotImplementedError("cache-writing prefill targets token-LM archs")
    if max_len is None:
        raise ValueError("with_cache=True requires max_len")

    def prefill_step(params, tokens, lengths):
        B, dev = tokens.shape[0], tokens.device
        cache = map_tree(lambda p: torch.zeros(p.shape, dtype=p.dtype, device=dev),
                         lm_cache_specs(cfg, B, max_len))
        lengths = torch.as_tensor(lengths, device=dev).to(torch.int32)
        logits, new_cache, _ = lm_apply(
            cfg, params, tokens, None, cache,
            torch.zeros(B, dtype=torch.int32, device=dev), chunk_lens=lengths)
        next_token, last = _last_valid(logits, lengths)
        return next_token, last, new_cache

    return prefill_step


def make_prefill_chunk_step(cfg: ModelConfig,
                            run_cfg: Optional[RunConfig] = None):
    """Chunked-prefill step factory (Sarathi-style serving prefill).

    ``chunk_step(params, tokens, base, chunk_lens, cache, block_table=None)``
    appends a ``[B, T]`` token slab into an existing cache: row ``b``'s
    first ``chunk_lens[b]`` tokens land at offset ``base[b]`` and attend the
    full warm prefix through the ragged prefill kernel; rows with
    ``chunk_lens[b] == 0`` are inert.  ``block_table`` selects the paged
    pool; without it the cache is the contiguous slot cache.  Returns
    ``(next_token [B], last_logits [B, V], cache)`` with the last logits
    read at each row's final valid chunk position (junk for inert rows).
    """
    if cfg.is_encoder_decoder or cfg.input_kind != "tokens":
        raise NotImplementedError("chunked prefill targets token-LM archs")

    def chunk_step(params, tokens, base, chunk_lens, cache, block_table=None):
        chunk_lens = torch.as_tensor(chunk_lens, device=tokens.device).to(torch.int32)
        logits, new_cache, _ = lm_apply(
            cfg, params, tokens, None, cache, base,
            block_table=block_table, chunk_lens=chunk_lens)
        next_token, last = _last_valid(logits, chunk_lens)
        return next_token, last, new_cache

    return chunk_step


def make_decode_step(cfg: ModelConfig, run_cfg: Optional[RunConfig] = None):
    """One new token per row: ``decode_step(params, tokens [B,1], cache,
    cache_len, block_table=None)`` returns ``(next_token [B], logits
    [B,1,V], cache)``.  ``cache_len`` is [B] (each row at its own length)
    or a scalar (every row at one position); ``block_table`` selects the
    paged pool, else the cache is the contiguous slot cache."""
    if cfg.is_encoder_decoder or cfg.mrope_sections:
        raise NotImplementedError(
            "encoder-decoder and M-RoPE decode are later slices (ROADMAP.md "
            "queue 1, item 9)")

    def decode_step(params, tokens, cache, cache_len, block_table=None):
        logits, new_cache, _ = lm_apply(cfg, params, tokens, None, cache,
                                        cache_len, block_table=block_table)
        next_token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_token, logits, new_cache

    return decode_step
