"""Serving step factories (mirror of ``repro.train.step``'s
``make_prefill_chunk_step`` and ``make_decode_step``).  They run eagerly;
the paged pools are updated in place."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models.lm import lm_apply


def make_prefill_chunk_step(cfg: ModelConfig,
                            run_cfg: Optional[RunConfig] = None):
    """Chunked-prefill step factory (Sarathi-style serving prefill).

    ``chunk_step(params, tokens, base, chunk_lens, cache, block_table)``
    appends a ``[B, T]`` token slab into the paged cache: row ``b``'s first
    ``chunk_lens[b]`` tokens land at offset ``base[b]`` and attend the full
    warm prefix through the ragged prefill kernel; rows with
    ``chunk_lens[b] == 0`` are inert.  Returns ``(next_token [B],
    last_logits [B, V], cache)`` with the last logits read at each row's
    final valid chunk position (junk for inert rows).
    """
    if cfg.is_encoder_decoder or cfg.input_kind != "tokens":
        raise NotImplementedError("chunked prefill targets token-LM archs")

    def chunk_step(params, tokens, base, chunk_lens, cache, block_table=None):
        if block_table is None:
            raise NotImplementedError(
                "the contiguous slot cache is a later slice of the port "
                "(ROADMAP.md queue 1, item 6): pass a block_table")
        chunk_lens = torch.as_tensor(chunk_lens, device=tokens.device).to(torch.int32)
        logits, new_cache, _ = lm_apply(
            cfg, params, tokens, None, cache, base,
            block_table=block_table, chunk_lens=chunk_lens)
        pick = (chunk_lens.to(torch.int64) - 1).clamp(min=0)
        last = logits[torch.arange(logits.shape[0], device=logits.device), pick]
        next_token = torch.argmax(last, dim=-1).to(torch.int32)
        return next_token, last, new_cache

    return chunk_step


def make_decode_step(cfg: ModelConfig, run_cfg: Optional[RunConfig] = None):
    """One new token per row against the paged cache: ``decode_step(params,
    tokens [B,1], cache, cache_len [B], block_table)`` returns
    ``(next_token [B], logits [B,1,V], cache)``."""
    if cfg.is_encoder_decoder or cfg.mrope_sections:
        raise NotImplementedError(
            "encoder-decoder and M-RoPE decode are later slices (ROADMAP.md "
            "queue 1, item 9)")

    def decode_step(params, tokens, cache, cache_len, block_table=None):
        if block_table is None:
            raise NotImplementedError(
                "the contiguous slot cache is a later slice of the port "
                "(ROADMAP.md queue 1, item 6): pass a block_table")
        logits, new_cache, _ = lm_apply(cfg, params, tokens, None, cache,
                                        cache_len, block_table=block_table)
        next_token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_token, logits, new_cache

    return decode_step
