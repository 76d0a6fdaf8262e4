"""Train and serving step factories (mirror of ``repro.train.step``):
``make_train_step`` (microbatched gradient accumulation, fp32 loss,
global-norm clipping, AdamW/Adafactor), ``make_prefill_step`` (last
logits without a cache, or the serving prefill into a fresh cache),
``make_prefill_chunk_step`` and ``make_decode_step``.  They run eagerly
on the device their tensors live on; the caches, parameters and
optimizer states are updated in place."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.common.params import map_tree, tree_leaves
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models.lm import lm_apply, lm_cache_specs
from repro_torch.train.optimizer import opt_update

PyTree = Any


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits [B,S,V] (any float dtype), labels [B,S] int -> mean nats, in
    fp32; the max is a constant to autograd, as JAX's ``stop_gradient``
    makes it."""
    logits = logits.float()
    m = logits.amax(dim=-1, keepdim=True)
    shifted = logits - m.detach()
    lse = torch.log(torch.exp(shifted).sum(dim=-1))
    label_logit = torch.gather(shifted, -1, labels[..., None].long())[..., 0]
    return (lse - label_logit).mean()


def make_loss_fn(cfg: ModelConfig, run_cfg: RunConfig):
    """``loss_fn(params, batch)``: cross-entropy of the no-cache forward
    plus 0.01 x the auxiliary loss, under remat unless ``run_cfg.remat``
    is ``"none"``."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            "encoder-decoder training is a later slice (ROADMAP.md queue 1, "
            "item 5)")
    remat = run_cfg.remat != "none"

    def loss_fn(params, batch):
        inputs = batch.get("tokens", batch.get("embeds"))
        logits, _, aux = lm_apply(cfg, params, inputs, batch.get("positions"),
                                  remat=remat)
        return cross_entropy(logits, batch["labels"]) + 0.01 * aux

    return loss_fn


def global_norm(tree: PyTree) -> torch.Tensor:
    return torch.sqrt(sum((leaf.float() ** 2).sum() for leaf in tree_leaves(tree)))


def clip_by_global_norm(tree: PyTree, max_norm: float) -> Tuple[PyTree, torch.Tensor]:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-6), max=1.0)
    return map_tree(lambda g: (g.float() * scale).to(g.dtype), tree), norm


def _unflatten(like: PyTree, leaves) -> PyTree:
    it = iter(leaves)
    return map_tree(lambda _: next(it), like)


def make_train_step(cfg: ModelConfig, run_cfg: RunConfig):
    """``train_step(state, batch) -> (state, {"loss", "grad_norm"})``.

    ``state`` is ``{"params", "opt", "step"}`` (``state.init_train_state``
    or a JAX state carried across) and ``batch`` ``{"tokens", "labels"}``
    ([B, S] int), on one device.  Gradients come from
    ``torch.autograd.grad`` over the parameter leaves; with
    ``num_microbatches`` > 1 the batch is split along B and the gradients
    summed in ``cfg.grad_accum_dtype``, then averaged.  They are clipped to
    ``grad_clip`` by global norm and applied by ``opt_update``.  **The
    parameters and optimizer states are updated in place**; the returned
    state holds them and a new step."""
    if run_cfg.grad_compression == "int8":
        raise NotImplementedError(
            "int8 gradient compression rides on the data-parallel "
            "all-reduce: the distributed slice (ROADMAP.md queue 1, item 6)")
    loss_fn = make_loss_fn(cfg, run_cfg)
    n_micro = run_cfg.num_microbatches

    def value_and_grad(params, batch):
        leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
        with torch.enable_grad():
            loss = loss_fn(_unflatten(params, leaves), batch)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), grads

    def train_step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        params = state["params"]
        if n_micro == 1:
            loss, grads = value_and_grad(params, batch)
        else:
            acc_dt = cfg.grad_accum_dtype
            grads = [torch.zeros(p.shape, dtype=acc_dt, device=p.device)
                     for p in tree_leaves(params)]
            loss = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
            for i in range(n_micro):
                mb = {k: x.reshape((n_micro, x.shape[0] // n_micro) + x.shape[1:])[i]
                      for k, x in batch.items()}
                l, g = value_and_grad(params, mb)
                for acc, gi in zip(grads, g):
                    acc.add_(gi.to(acc_dt))
                loss = loss + l
            loss = loss / n_micro
            grads = [g / n_micro for g in grads]
        grads = _unflatten(params, grads)
        if run_cfg.grad_clip > 0:
            grads, gnorm = clip_by_global_norm(grads, run_cfg.grad_clip)
        else:
            gnorm = torch.zeros((), device=loss.device)
        opt_update(grads, state["opt"], params, state["step"], run_cfg)
        new_state = {"params": params, "opt": state["opt"],
                     "step": state["step"] + 1}
        return new_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def _last_valid(logits: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Each row's logits at its last valid position (position 0 for rows
    of length 0) -> ``(next_token [B], last [B, V])``."""
    pick = (lengths.to(torch.int64) - 1).clamp(min=0)
    last = logits[torch.arange(logits.shape[0], device=logits.device), pick]
    return torch.argmax(last, dim=-1).to(torch.int32), last


def make_prefill_step(cfg: ModelConfig, run_cfg: Optional[RunConfig] = None,
                      *, with_cache: bool = False, max_len: Optional[int] = None):
    """Prefill step factory.

    Without a cache, ``prefill_step(params, batch)`` runs the no-cache
    forward of ``batch["tokens"]`` (positions ``batch.get("positions")``)
    and returns the last position's logits ``[B, V]``.

    ``with_cache=True`` builds the serving prefill into a fresh contiguous
    cache: ``prefill_step(params, tokens, lengths)`` takes right-padded
    prompts ``tokens [B, P]`` with true lengths ``lengths [B]``, runs one
    ragged cache-writing forward at base 0 into a zero ``[B, max_len]``
    cache (padding tokens write no K/V), and returns ``(next_token [B],
    last_logits [B, V], cache)`` with the logits read at each row's last
    valid position."""
    if not with_cache:
        if cfg.is_encoder_decoder:
            raise NotImplementedError(
                "encoder-decoder prefill is a later slice (ROADMAP.md queue "
                "1, item 5)")

        def last_logits_step(params, batch):
            inputs = batch.get("tokens", batch.get("embeds"))
            with torch.no_grad():
                logits, _, _ = lm_apply(cfg, params, inputs,
                                        batch.get("positions"), remat=False,
                                        last_only=True)
            return logits[:, -1, :]

        return last_logits_step
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
            "queue 1, item 5)")

    def decode_step(params, tokens, cache, cache_len, block_table=None):
        logits, new_cache, _ = lm_apply(cfg, params, tokens, None, cache,
                                        cache_len, block_table=block_table)
        next_token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_token, logits, new_cache

    return decode_step
