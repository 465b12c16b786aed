"""Full model: embeddings -> period-stacked decoder stack -> final norm ->
LM head, with train (``lm_loss``), prefill and decode entry points and a
chunked cross-entropy (port of ``repro.models.model``).

Layers group into the arch's repeating ``pattern`` period.  The
parameters of the ``num_periods`` full periods are stacked on a leading
axis (``decoder.scan.p{i}``, as in the reference); the reference's
``lax.scan`` over periods is a Python loop here.  Remainder layers are
the unrolled tail (``decoder.tail.t{i}``).  The LM head is the tied
embedding or, untied, the ``head`` projection (a ``dense()`` site tagged
``lm_head``).

In training each stacked period runs under the reference's remat policy
(``ParallelConfig.remat``, ``_remat_wrap``): ``"full"`` checkpoints the
period and recomputes it in backward, ``"dots"`` keeps the outputs of
the matrix products and recomputes the rest, ``"none"`` keeps
everything.  The tail is not rematerialized, as in the reference.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, Dict

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig
from repro_torch.models.blocks import apply_layer, layer_schema, layer_cache_schema
from repro_torch.models.common import (ParamSchema, apply_norm,
                                       current_dense_hook, dense, einsum,
                                       norm_schema, scan_states_provider,
                                       stack_schema, use_dense_hook)

NEG_INF = -1e30


def model_schema(cfg: ArchConfig) -> Dict[str, Any]:
    d, vp = cfg.d_model, cfg.padded_vocab
    if cfg.frontend != "none" or cfg.encoder_layers or cfg.logit_softcap:
        raise NotImplementedError(f"{cfg.name}: frontends, encoders and "
                                  "logit softcaps are not ported yet "
                                  "(ROADMAP A9c)")
    s: Dict[str, Any] = {
        "embed": ParamSchema((vp, d), "embed", d ** -0.5),
        "final_norm": norm_schema(d, cfg.norm),
    }
    if not cfg.tie_embeddings:
        s["head"] = ParamSchema((d, vp), "normal", d ** -0.5)
    scan: Dict[str, Any] = {}
    if cfg.num_periods > 0:
        for i, kind in enumerate(cfg.pattern):
            scan[f"p{i}"] = stack_schema(layer_schema(cfg, kind),
                                         cfg.num_periods)
    tail = {f"t{i}": layer_schema(cfg, kind)
            for i, kind in enumerate(cfg.tail_kinds)}
    s["decoder"] = {"scan": scan, "tail": tail}
    return s


def model_cache_schema(cfg: ArchConfig, batch: int, s_max: int, *,
                       dtype=None):
    """{scan: {p_i: stacked cache schema}, tail: {t_i: ...}} of
    (shape, dtype) leaves."""
    def stack_leaf(node, n):
        if isinstance(node, tuple):
            return ((n,) + tuple(node[0]), node[1])
        return {k: stack_leaf(v, n) for k, v in node.items()}

    scan = {}
    if cfg.num_periods > 0:
        for i, kind in enumerate(cfg.pattern):
            scan[f"p{i}"] = stack_leaf(
                layer_cache_schema(cfg, kind, batch, s_max, dtype=dtype),
                cfg.num_periods)
    tail = {f"t{i}": layer_cache_schema(cfg, kind, batch, s_max, dtype=dtype)
            for i, kind in enumerate(cfg.tail_kinds)}
    return {"scan": scan, "tail": tail}


def zeros_cache(cache_schema, device):
    if isinstance(cache_schema, tuple):
        return torch.zeros(cache_schema[0], dtype=cache_schema[1],
                           device=device)
    return {k: zeros_cache(v, device) for k, v in cache_schema.items()}


def _select(tree, p):
    if isinstance(tree, dict):
        return {k: _select(v, p) for k, v in tree.items()}
    return tree[p]


def _write_back(views, new):
    """Copy a layer's returned decode cache into the per-period ``views``
    of the stacked caches where the layer returned new tensors (a
    recurrent layer's conv and h states); attention returns the views it
    wrote in place, which need no copy."""
    for k, v in new.items():
        if isinstance(v, dict):
            _write_back(views[k], v)
        elif v is not views[k]:
            views[k].copy_(v)


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


# "dots": the matrix products whose outputs a period keeps for backward
# (the reference keeps dot_general outputs); ops run with grad disabled
# (inside a custom Function's forward) are recomputed
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    if op in _DOT_OPS and torch.is_grad_enabled():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _in_this_context(fn):
    """``fn`` run under the dense hook installed where it was wrapped.  A
    checkpoint recomputes in backward, on the autograd engine's thread
    for a CUDA graph, where this thread's hook (``use_dense_hook``) is not
    installed: without it the recompute would run an analog site
    digitally."""
    hook = current_dense_hook()

    def run(*args):
        with use_dense_hook(hook):
            return fn(*args)

    return run


def _remat_wrap(fn, remat: str):
    """``fn`` under the reference's remat policy (``_remat_wrap`` there):
    ``"none"`` as it is; ``"full"`` checkpointed, recomputed in backward;
    ``"dots"`` selectively checkpointed, the products' outputs kept.  The
    recompute runs under the dense hook of the first pass."""
    if remat == "none":
        return fn
    fn = _in_this_context(fn)
    if remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_dots))
    if remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    raise ValueError(f"unknown remat policy {remat!r}")


def _run_stack(stack_params, x, *, cfg: ArchConfig, pcfg, pattern,
               tail_kinds, mode, caches, pos, positions,
               scan_group: str = "dec"):
    """Stacked periods (a Python loop) + unrolled tail.  Returns
    (x, aux, new_caches): ``aux`` sums the layers' auxiliary losses in
    the reference's order (a float32 scalar with an MoE FFN, else the
    number 0.0).  Decode updates the stacked caches in place (what a
    period's layer returns is written back into its slice); its returned
    tree holds the same tensors.  A site-keying provider installed with
    ``use_scan_states`` sees each period announced, so analog call sites
    are keyed ``"{scan_group}.{p}:{tag}#{j}"`` as in the reference.  In
    training with grad enabled a period runs under ``pcfg.remat``; its
    scope is entered inside the checkpointed function, so a recompute
    keys its sites as the first pass did.  Under ``"dots"`` with a dense
    hook installed, each period first runs on one token without grad, so
    the hook's cache builds happen outside the checkpointed region (the
    hook sees each site once more a step)."""
    provider = scan_states_provider()
    new_caches: Dict[str, Any] = {"scan": {}, "tail": {}}
    scan_params = stack_params["scan"]

    def period_fn(x, aux, lp, lcs, p, positions):
        ncs = {}
        scope = (provider.scan_period(scan_group, p)
                 if provider is not None else contextlib.nullcontext())
        with scope:
            for i, kind in enumerate(pattern):
                lc = None if lcs is None else lcs[i]
                x, nc, a = apply_layer(lp[f"p{i}"], x, cfg=cfg, pcfg=pcfg,
                                       kind=kind, mode=mode, cache=lc,
                                       pos=pos, positions=positions)
                aux = aux + a
                if nc is not None:
                    ncs[f"p{i}"] = nc
                    if mode == "decode":
                        _write_back(lc, nc)
        return x, aux, ncs

    period = period_fn
    if mode == "train" and torch.is_grad_enabled():
        period = _remat_wrap(period_fn, pcfg.remat)
    # "dots" indexes the outputs it keeps by each op's call count, so the
    # recompute must run the ops its first pass ran; a dense hook builds
    # its per-weight caches on a site's first call and only looks them up
    # after, so those builds run first, on one token and without grad,
    # before the period enters the checkpointed region
    warm = (period is not period_fn and pcfg.remat == "dots"
            and current_dense_hook() is not None)
    aux = 0.0
    if scan_params:
        n = next(iter(scan_params.values()))["norm1"]["w"].shape[0]
        per = []
        for p in range(n):
            lcs = ([_select(caches["scan"][f"p{i}"], p)
                    for i in range(len(pattern))]
                   if mode == "decode" else None)
            lp = _select(scan_params, p)
            if warm:
                with torch.no_grad():
                    period_fn(x[:1, :1], 0.0, lp, None, p, positions[:, :1])
            x, aux, ncs = period(x, aux, lp, lcs, p, positions)
            per.append(ncs)
        if mode == "prefill":
            new_caches["scan"] = _stack(per)
        elif mode == "decode":
            new_caches["scan"] = caches["scan"]
    for i, kind in enumerate(tail_kinds):
        lc = caches["tail"].get(f"t{i}") if mode == "decode" else None
        x, nc, a = apply_layer(stack_params["tail"][f"t{i}"], x, cfg=cfg,
                               pcfg=pcfg, kind=kind, mode=mode, cache=lc,
                               pos=pos, positions=positions)
        aux = aux + a
        if nc is not None:
            new_caches["tail"][f"t{i}"] = nc
    return x, aux, new_caches


def embed_tokens(params, tokens, cfg: ArchConfig, compute_dtype):
    x = params["embed"][tokens].to(compute_dtype)
    if cfg.emb_scale:
        # the scale is cast to the compute dtype first, as in the reference
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=compute_dtype,
                         device=x.device)
    return x


def forward(params, tokens, *, cfg: ArchConfig, pcfg, mode: str = "train",
            cache=None, pos=None, compute_dtype=torch.bfloat16):
    """Returns (hidden (B,S,D), new_cache_or_None, aux loss): the aux
    loss is a float32 scalar, 0 for an arch without an MoE FFN."""
    x = embed_tokens(params, tokens, cfg, compute_dtype)
    positions = (None if mode == "decode" else
                 torch.arange(tokens.shape[1], device=tokens.device)[None, :])
    x, aux, new_caches = _run_stack(
        params["decoder"], x, cfg=cfg, pcfg=pcfg, pattern=cfg.pattern,
        tail_kinds=cfg.tail_kinds, mode=mode, caches=cache, pos=pos,
        positions=positions)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    if not isinstance(aux, torch.Tensor):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, (new_caches if mode in ("prefill", "decode") else None), aux


def compute_logits(params, h, cfg: ArchConfig):
    """h: (B,S,D) -> logits (B,S,Vp) fp32 from the tied embedding or the
    untied head, padded vocab masked."""
    if cfg.tie_embeddings:
        logits = einsum("bsd,vd->bsv", h, params["embed"].to(h.dtype))
    else:
        logits = dense(h, params["head"], "lm_head")
    logits = logits.float()
    if cfg.padded_vocab != cfg.vocab_size:
        mask = torch.arange(cfg.padded_vocab, device=h.device) >= cfg.vocab_size
        logits = torch.where(mask[None, None, :], NEG_INF, logits)
    return logits


def chunked_xent(params, h, targets, mask, *, cfg: ArchConfig,
                 chunk: int, z_coef: float = 0.0) -> torch.Tensor:
    """Mean xent (plus ``z_coef * lse**2``) over the masked positions; the
    logits live one sequence chunk at a time, each chunk recomputed in
    backward (the reference's ``jax.checkpoint`` per chunk)."""
    B, S, D = h.shape
    ck = min(chunk, S)
    if S % ck != 0:
        ck = S

    def chunk_fn(hc, tc, mc):
        logits = compute_logits(params, hc, cfg)
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, tc[..., None].long())[..., 0] - lse
        zl = z_coef * torch.square(lse) if z_coef else 0.0
        m = mc.float()
        return ((-ll + zl) * m).sum(), m.sum()

    loss_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    denom = torch.zeros((), dtype=torch.float32, device=h.device)
    recompute = _in_this_context(chunk_fn)       # an untied head may be analog
    for c in range(S // ck):
        sl = slice(c * ck, (c + 1) * ck)
        l, m = (checkpoint(recompute, h[:, sl], targets[:, sl], mask[:, sl],
                           use_reentrant=False)
                if torch.is_grad_enabled() else
                chunk_fn(h[:, sl], targets[:, sl], mask[:, sl]))
        loss_sum = loss_sum + l
        denom = denom + m
    return loss_sum / torch.clamp_min(denom, 1.0)


def lm_loss(params, batch, *, cfg: ArchConfig, pcfg,
            compute_dtype=torch.bfloat16, z_coef: float = 1e-4):
    """batch: {tokens, targets, mask}.  Returns (xent + aux, {"xent",
    "aux"}); aux is the MoE FFNs' load-balancing loss (0 without one)."""
    h, _, aux = forward(params, batch["tokens"], cfg=cfg, pcfg=pcfg,
                        mode="train", compute_dtype=compute_dtype)
    loss = chunked_xent(params, h, batch["targets"], batch["mask"], cfg=cfg,
                        chunk=pcfg.xent_chunk, z_coef=z_coef)
    return loss + aux, {"xent": loss, "aux": aux}


def prefill(params, tokens, *, cfg: ArchConfig, pcfg,
            compute_dtype=torch.bfloat16):
    """Returns (last-position logits (B,Vp), cache)."""
    h, cache, _ = forward(params, tokens, cfg=cfg, pcfg=pcfg,
                          mode="prefill", compute_dtype=compute_dtype)
    return compute_logits(params, h[:, -1:], cfg)[:, 0], cache


def decode_step(params, token, cache, pos, *, cfg: ArchConfig, pcfg,
                compute_dtype=torch.bfloat16):
    """token: (B,1) int64; pos: the position being written, an int (every
    row) or a (B,) tensor (each row its own).  Returns (logits (B,Vp),
    cache) -- the cache is updated in place."""
    h, new_cache, _ = forward(params, token, cfg=cfg, pcfg=pcfg,
                              mode="decode", cache=cache, pos=pos,
                              compute_dtype=compute_dtype)
    return compute_logits(params, h, cfg)[:, 0], new_cache
