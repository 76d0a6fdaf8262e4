"""Kernel contract pass: device-free shape and dtype verification (mirror
of ``repro.analysis.kernel_contracts``).

The serving steps that feed every ``kernels/ops.py`` dispatch (chunked
prefill -> prefill_attention / prefill_attention_paged, decode ->
decode_attention / decode_attention_paged) run once on meta tensors,
shapes and dtypes without memory, through the plain ops
(``decode_impl="ref"``: the kernels take CUDA tensors only), where JAX
runs ``jax.eval_shape``.  They run across

- the config matrix: all 11 ``configs/*`` modules (the 10 registered
  archs' smoke configs and the ``base`` default ``ModelConfig``),
- the power-of-two prefill and chunk buckets the ServeEngine retraces
  over, and
- both KV layouts (contiguous ``lm_cache_specs`` and paged
  ``lm_paged_cache_specs``).

Contracts checked: ``next_token [B] int32``; ``last_logits [B, V]`` /
decode ``logits [B, 1, V]``; the returned cache tree keeps the spec
tree's structure, shapes and dtypes.  Archs outside the serving envelope
(encoder-decoder, embedding input, recurrent state) must refuse with a
clean ``NotImplementedError``: any other exception is a finding.

In place of the Pallas BlockSpec divisibility, the CUDA kernels' own
limits, statically: ``H_pad % KV_pad`` (GQA groups), the paged pool's
coverage of ``max_len``, and every attention kernel a config's serving
path reaches (``lm.serving_attention_shapes``) instantiated for the head
dim it gets there (``kernels.build.check_head_dim``), at smoke and at
full width.
"""
from __future__ import annotations

import importlib
from typing import Any, List, Tuple

import torch

from repro_torch.analysis.findings import Finding

_PREFILL_BUCKETS = (8, 16)        # powers of two, like ServeEngine buckets
_CHUNK_BUCKETS = (4, 8)           # chunked-prefill token buckets
_B = 2
_MAX_LEN = 32
_PAGE_SIZE = 8


def _finding(rule: str, symbol: str, message: str) -> Finding:
    return Finding(pass_name="kernels", rule=rule, file="", line=0,
                   symbol=symbol, message=message)


def _base_config():
    from repro_torch.configs import ModelConfig

    return ModelConfig(
        name="base-default", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16,
        attention="gqa", mlp_act="swiglu",
    )


def config_matrix(smoke: bool = True) -> List[Tuple[str, Any]]:
    """All 11 config modules: the registered archs (smoke-sized unless
    ``smoke`` is False) and the base default."""
    from repro_torch.configs import ARCHS

    out: List[Tuple[str, Any]] = []
    for arch in sorted(ARCHS):
        mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
        out.append((arch, mod.smoke_config() if smoke else mod.config()))
    out.append(("base", _base_config()))
    return out


def _serving_supported(cfg) -> bool:
    from repro_torch.configs.base import block_pattern

    if cfg.is_encoder_decoder or cfg.input_kind != "tokens":
        return False
    head, unit, _, tail = block_pattern(cfg)
    kinds = {tk for tk, _ in (*head, *unit, *tail)}
    return kinds <= {"attn", "mla"}


def _tree_sig(tree, path: str = "") -> List[Tuple[str, Tuple, str]]:
    if isinstance(tree, dict):
        return [s for k in tree for s in _tree_sig(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [s for i, v in enumerate(tree) for s in _tree_sig(v, f"{path}[{i}]")]
    return [(path, tuple(tree.shape), str(tree.dtype))]


def _sig_mismatch(expect, got) -> str:
    e, g = dict((k, (s, d)) for k, s, d in expect), dict(
        (k, (s, d)) for k, s, d in got)
    for k in sorted(set(e) | set(g)):
        if e.get(k) != g.get(k):
            return (f"cache leaf {k}: expected "
                    f"{e.get(k, 'missing')}, got {g.get(k, 'missing')}")
    return ""


def _meta(shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _check_outputs(label, nt, lg, logits_shape, findings) -> None:
    if tuple(nt.shape) != (_B,) or nt.dtype != torch.int32:
        findings.append(_finding(
            "kernel-contract", label,
            f"next_token: expected [{_B}] int32, got {tuple(nt.shape)} {nt.dtype}"))
    if tuple(lg.shape) != logits_shape:
        findings.append(_finding(
            "kernel-contract", label,
            f"logits: expected {list(logits_shape)}, got {tuple(lg.shape)}"))


def _check_supported(arch: str, cfg, findings: List[Finding]) -> None:
    from repro_torch.common.params import abstract_params
    from repro_torch.models.lm import lm_cache_specs, lm_paged_cache_specs, lm_specs
    from repro_torch.train.step import (make_decode_step, make_prefill_chunk_step,
                                        make_prefill_step)

    cfg = cfg.with_overrides(decode_impl="ref")
    params = abstract_params(lm_specs(cfg))
    V = cfg.padded_vocab
    cache_sig = _tree_sig(abstract_params(lm_cache_specs(cfg, _B, _MAX_LEN)))

    # prefill (writes a fresh contiguous cache) across the bucket grid
    prefill = make_prefill_step(cfg, with_cache=True, max_len=_MAX_LEN)
    for P in _PREFILL_BUCKETS:
        label = f"{arch}/contiguous/prefill@P{P}"
        try:
            with torch.no_grad():
                nt, lg, cache = prefill(params, _meta((_B, P)), _meta((_B,)))
        except Exception as e:  # noqa: BLE001 - checker isolation boundary
            findings.append(_finding(
                "kernel-contract", label, f"meta run failed: {e!r}"))
            continue
        _check_outputs(label, nt, lg, (_B, V), findings)
        bad = _sig_mismatch(cache_sig, _tree_sig(cache))
        if bad:
            findings.append(_finding("kernel-contract", label, bad))

    # decode, both KV layouts (fresh meta caches per run: written in place)
    max_pages = _MAX_LEN // _PAGE_SIZE
    layouts = [
        ("contiguous", lambda: abstract_params(lm_cache_specs(cfg, _B, _MAX_LEN)), None),
        ("paged", lambda: abstract_params(
            lm_paged_cache_specs(cfg, _B * max_pages, _PAGE_SIZE)),
         _meta((_B, max_pages))),
    ]
    decode = make_decode_step(cfg)
    for layout, make_cache, bt in layouts:
        label = f"{arch}/{layout}/decode"
        cache_in = make_cache()
        in_sig = _tree_sig(cache_in)
        try:
            with torch.no_grad():
                nt, lg, nc = decode(params, _meta((_B, 1)), cache_in, _meta((_B,)), bt)
        except Exception as e:  # noqa: BLE001 - checker isolation boundary
            findings.append(_finding(
                "kernel-contract", label, f"meta run failed: {e!r}"))
            continue
        _check_outputs(label, nt, lg, (_B, 1, V), findings)
        bad = _sig_mismatch(in_sig, _tree_sig(nc))
        if bad:
            findings.append(_finding(
                "kernel-contract", label,
                f"decode must preserve the cache layout ({bad})"))

    # chunked prefill (ragged cache-writing append -> ops.prefill_attention
    # / prefill_attention_paged) across chunk buckets x both layouts
    chunk_step = make_prefill_chunk_step(cfg)
    for T in _CHUNK_BUCKETS:
        for layout, make_cache, bt in layouts:
            label = f"{arch}/{layout}/prefill_chunk@T{T}"
            cache_in = make_cache()
            in_sig = _tree_sig(cache_in)
            try:
                with torch.no_grad():
                    nt, lg, nc = chunk_step(params, _meta((_B, T)), _meta((_B,)),
                                            _meta((_B,)), cache_in, bt)
            except Exception as e:  # noqa: BLE001 - checker isolation boundary
                findings.append(_finding(
                    "kernel-contract", label, f"meta run failed: {e!r}"))
                continue
            _check_outputs(label, nt, lg, (_B, V), findings)
            bad = _sig_mismatch(in_sig, _tree_sig(nc))
            if bad:
                findings.append(_finding(
                    "kernel-contract", label,
                    f"chunked prefill must append in place, preserving "
                    f"the cache layout ({bad})"))


def _check_unsupported(arch: str, cfg, findings: List[Finding]) -> None:
    """Out-of-envelope archs must refuse cleanly, not mis-run."""
    from repro_torch.models.lm import lm_paged_cache_specs
    from repro_torch.train.step import make_prefill_chunk_step, make_prefill_step

    for name, build in (
            ("prefill", lambda: make_prefill_step(
                cfg, with_cache=True, max_len=_MAX_LEN)),
            ("prefill_chunk", lambda: make_prefill_chunk_step(cfg))):
        try:
            build()
        except NotImplementedError:
            continue
        except Exception as e:  # noqa: BLE001 - checker isolation boundary
            findings.append(_finding(
                "kernel-contract", f"{arch}/contiguous/{name}",
                f"expected clean NotImplementedError refusal, got {e!r}"))
        else:
            findings.append(_finding(
                "kernel-contract", f"{arch}/contiguous/{name}",
                "cache-writing prefill must refuse non-token-LM / "
                "non-attention archs with NotImplementedError"))
    try:
        lm_paged_cache_specs(cfg, _B * (_MAX_LEN // _PAGE_SIZE), _PAGE_SIZE)
    except NotImplementedError:
        pass  # clean refusal: paged layout is attention-family only
    except Exception as e:  # noqa: BLE001 - checker isolation boundary
        findings.append(_finding(
            "kernel-contract", f"{arch}/paged/specs",
            f"expected NotImplementedError or success, got {e!r}"))


def blockspec_findings(arch: str, cfg) -> List[Finding]:
    """The kernels' grid rules: uniform GQA groups and a page pool that
    covers ``max_len`` (JAX's BlockSpec rules, which the CUDA kernels
    keep)."""
    out: List[Finding] = []
    H, KV = cfg.padded_gqa()
    if KV == 0 or H % KV != 0:
        out.append(_finding(
            "blockspec", f"{arch}/gqa",
            f"padded head grid H={H}, KV={KV}: kernel index maps need "
            f"H %% KV == 0 (uniform GQA groups)"))
    num_pages, page_size = _B * (_MAX_LEN // _PAGE_SIZE), _PAGE_SIZE
    if num_pages * page_size < _MAX_LEN:
        out.append(_finding(
            "blockspec", f"{arch}/paged-pool",
            f"page pool {num_pages}x{page_size} cannot cover "
            f"max_len={_MAX_LEN}"))
    return out


def head_dim_findings(arch: str, cfg) -> List[Finding]:
    """Every attention kernel the config's serving path reaches must be
    instantiated for the head dim it gets there."""
    from repro_torch.kernels.build import check_head_dim
    from repro_torch.models.lm import serving_attention_shapes

    out: List[Finding] = []
    for kernel, (_, _, D) in sorted(serving_attention_shapes(cfg).items()):
        try:
            check_head_dim(kernel, D)
        except ValueError as e:
            out.append(_finding("head-dim", f"{arch}/{kernel}", str(e)))
    return out


def run() -> List[Finding]:
    findings: List[Finding] = []
    for arch, cfg in config_matrix():
        findings.extend(blockspec_findings(arch, cfg))
        findings.extend(head_dim_findings(arch, cfg))
        if _serving_supported(cfg):
            _check_supported(arch, cfg, findings)
        else:
            _check_unsupported(arch, cfg, findings)
    for arch, cfg in config_matrix(smoke=False)[:-1]:
        findings.extend(head_dim_findings(f"{arch}/full", cfg))
    return findings
