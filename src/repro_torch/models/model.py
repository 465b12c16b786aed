"""Full model: embeddings (with a vision arch's projected image
embeddings written over the first positions) -> (encoder) ->
period-stacked decoder stack -> final norm -> LM head (softcapped where
the arch sets one), with train (``lm_loss``), prefill and decode entry
points and a chunked cross-entropy (port of ``repro.models.model``).

Layers group into the arch's repeating ``pattern`` period.  The
parameters of the ``num_periods`` full periods are stacked on a leading
axis (``decoder.scan.p{i}``, as in the reference); the reference's
``lax.scan`` over periods is a Python loop here.  Remainder layers are
the unrolled tail (``decoder.tail.t{i}``).  The LM head is the tied
embedding or, untied, the ``head`` projection (a ``dense()`` site tagged
``lm_head``).  The frontends are the reference's stubs: a vision arch
takes precomputed patch embeddings (``image_embeds``, through the
``frontend.proj`` site), an encoder-decoder precomputed frames
(``enc_frames``), which its encoder (``encoder.scan.p0``, bidirectional
layers, sites keyed ``enc.{p}:...``) turns into what every decoder layer's
cross attention reads.

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

from repro_torch.configs.base import ArchConfig, BIDIR_ATTN
from repro_torch.models.blocks import apply_layer, layer_schema, layer_cache_schema
from repro_torch.models.common import (ParamSchema, apply_norm,
                                       current_dense_hook, dense, einsum,
                                       norm_schema, scan_states_provider,
                                       stack_schema, use_dense_hook)

NEG_INF = -1e30


def model_schema(cfg: ArchConfig) -> Dict[str, Any]:
    d, vp = cfg.d_model, cfg.padded_vocab
    cross = cfg.encoder_layers > 0
    s: Dict[str, Any] = {
        "embed": ParamSchema((vp, d), "embed", d ** -0.5),
        "final_norm": norm_schema(d, cfg.norm),
    }
    if not cfg.tie_embeddings:
        s["head"] = ParamSchema((d, vp), "normal", d ** -0.5)
    if cfg.frontend == "vision":
        s["proj"] = ParamSchema((d, d), "normal", d ** -0.5)
    scan: Dict[str, Any] = {}
    if cfg.num_periods > 0:
        for i, kind in enumerate(cfg.pattern):
            scan[f"p{i}"] = stack_schema(layer_schema(cfg, kind, cross=cross),
                                         cfg.num_periods)
    tail = {f"t{i}": layer_schema(cfg, kind, cross=cross)
            for i, kind in enumerate(cfg.tail_kinds)}
    s["decoder"] = {"scan": scan, "tail": tail}
    if cross:
        s["encoder"] = {
            "scan": {"p0": stack_schema(layer_schema(cfg, BIDIR_ATTN),
                                        cfg.encoder_layers)},
            "tail": {}, "final_norm": norm_schema(d, cfg.norm)}
    return s


def model_cache_schema(cfg: ArchConfig, batch: int, s_max: int, *,
                       cross_len: int = 0, dtype=None):
    """{scan: {p_i: stacked cache schema}, tail: {t_i: ...}} of
    (shape, dtype) leaves; ``cross_len``: each decoder layer's cross
    cache holds that many encoder positions."""
    def stack_leaf(node, n):
        if isinstance(node, tuple):
            return ((n,) + tuple(node[0]), node[1])
        return {k: stack_leaf(v, n) for k, v in node.items()}

    scan = {}
    if cfg.num_periods > 0:
        for i, kind in enumerate(cfg.pattern):
            scan[f"p{i}"] = stack_leaf(
                layer_cache_schema(cfg, kind, batch, s_max,
                                   cross_len=cross_len, dtype=dtype),
                cfg.num_periods)
    tail = {f"t{i}": layer_cache_schema(cfg, kind, batch, s_max,
                                        cross_len=cross_len, dtype=dtype)
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


@contextlib.contextmanager
def _after(warm, ctx):
    """``warm()`` without grad, then ``ctx`` entered."""
    with torch.no_grad():
        warm()
    with ctx:
        yield


def _remat_wrap(fn, remat: str, one_token):
    """``fn`` under the reference's remat policy (``_remat_wrap`` there):
    ``"none"`` as it is; ``"full"`` checkpointed, recomputed in backward;
    ``"dots"`` selectively checkpointed, the products' outputs kept.  The
    recompute runs under the dense hook of the first pass.

    "dots" indexes the outputs it keeps by each op's call count, so a
    recompute must run the ops its forward ran.  A dense hook builds its
    per-weight caches on a site's first call and only looks them up
    after, and keeps one entry a tag: the next stacked period's weights
    replace it.  So with a hook installed (``one_token``: the call's
    arguments -> the same cut to one token), the forward and the
    recompute each first run ``fn`` on one token without grad, outside
    the region, and both find the caches built (the hook sees each site
    twice more a step)."""
    if remat == "none":
        return fn
    fn = _in_this_context(fn)
    if remat == "dots":
        if current_dense_hook() is None:
            return functools.partial(
                checkpoint, fn, use_reentrant=False,
                context_fn=functools.partial(
                    create_selective_checkpoint_contexts, _save_dots))

        def run(*args):
            small = one_token(*args)

            def contexts():
                fwd, rec = create_selective_checkpoint_contexts(_save_dots)
                return (_after(lambda: fn(*small), fwd),
                        _after(lambda: fn(*small), rec))

            return checkpoint(fn, *args, use_reentrant=False,
                              context_fn=contexts)

        return run
    if remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    raise ValueError(f"unknown remat policy {remat!r}")


def _run_stack(stack_params, x, *, cfg: ArchConfig, pcfg, pattern,
               tail_kinds, mode, caches, pos, positions, enc_out=None,
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
    keys its sites as the first pass did (under ``"dots"`` with a dense
    hook, see ``_remat_wrap``'s one-token runs).  ``enc_out`` is what a
    decoder layer's cross attention reads (train and prefill)."""
    provider = scan_states_provider()
    new_caches: Dict[str, Any] = {"scan": {}, "tail": {}}
    scan_params = stack_params["scan"]

    def period_fn(x, aux, lp, lcs, p, positions, enc_out):
        ncs = {}
        scope = (provider.scan_period(scan_group, p)
                 if provider is not None else contextlib.nullcontext())
        with scope:
            for i, kind in enumerate(pattern):
                lc = None if lcs is None else lcs[i]
                x, nc, a = apply_layer(lp[f"p{i}"], x, cfg=cfg, pcfg=pcfg,
                                       kind=kind, mode=mode, cache=lc,
                                       pos=pos, positions=positions,
                                       enc_out=enc_out)
                aux = aux + a
                if nc is not None:
                    ncs[f"p{i}"] = nc
                    if mode == "decode":
                        _write_back(lc, nc)
        return x, aux, ncs

    def one_token(x, aux, lp, lcs, p, positions, enc_out):
        return (x[:1, :1].detach(), 0.0, lp, None, p, positions[:, :1],
                None if enc_out is None else enc_out[:1, :1].detach())

    period = period_fn
    if mode == "train" and torch.is_grad_enabled():
        period = _remat_wrap(period_fn, pcfg.remat, one_token)
    aux = 0.0
    if scan_params:
        n = next(iter(scan_params.values()))["norm1"]["w"].shape[0]
        per = []
        for p in range(n):
            lcs = ([_select(caches["scan"][f"p{i}"], p)
                    for i in range(len(pattern))]
                   if mode == "decode" else None)
            lp = _select(scan_params, p)
            x, aux, ncs = period(x, aux, lp, lcs, p, positions, enc_out)
            per.append(ncs)
        if mode == "prefill":
            new_caches["scan"] = _stack(per)
        elif mode == "decode":
            new_caches["scan"] = caches["scan"]
    for i, kind in enumerate(tail_kinds):
        lc = caches["tail"].get(f"t{i}") if mode == "decode" else None
        x, nc, a = apply_layer(stack_params["tail"][f"t{i}"], x, cfg=cfg,
                               pcfg=pcfg, kind=kind, mode=mode, cache=lc,
                               pos=pos, positions=positions, enc_out=enc_out)
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


def encode(params, enc_frames, *, cfg: ArchConfig, pcfg):
    """The encoder over precomputed frames (B, S_enc, D): its stacked
    bidirectional layers (sites keyed ``enc.{p}:...``), then its final
    norm.  Returns (enc_out, aux).  The layers get explicit positions
    (the reference's default, ``arange(S_enc)``), which remat "dots"'
    one-token warm pass slices."""
    positions = torch.arange(enc_frames.shape[1],
                             device=enc_frames.device)[None, :]
    x, aux, _ = _run_stack(
        {"scan": params["encoder"]["scan"], "tail": {}}, enc_frames, cfg=cfg,
        pcfg=pcfg, pattern=(BIDIR_ATTN,), tail_kinds=(), mode="train",
        caches=None, pos=None, positions=positions, scan_group="enc")
    return apply_norm(params["encoder"]["final_norm"], x, cfg.norm), aux


def forward(params, tokens, *, cfg: ArchConfig, pcfg, mode: str = "train",
            cache=None, pos=None, image_embeds=None, enc_frames=None,
            compute_dtype=torch.bfloat16):
    """Returns (hidden (B,S,D), new_cache_or_None, aux loss): the aux
    loss is a float32 scalar, 0 for an arch without an MoE FFN.  An
    encoder-decoder arch encodes ``enc_frames`` (B, S_enc, D) at train
    and prefill (decode reads the cross caches); a vision arch writes
    ``dense(image_embeds, proj)`` (B, n, D) over the first n positions
    (n at most the sequence's length)."""
    aux = 0.0
    enc_out = None
    if cfg.encoder_layers and mode != "decode":
        if enc_frames is None:
            raise ValueError(f"{cfg.name} encodes enc_frames at {mode}")
        enc_out, aux = encode(params, enc_frames.to(compute_dtype), cfg=cfg,
                              pcfg=pcfg)
    x = embed_tokens(params, tokens, cfg, compute_dtype)
    if cfg.frontend == "vision" and image_embeds is not None:
        n, S = image_embeds.shape[1], tokens.shape[1]
        if n > S:
            raise ValueError(f"{cfg.name}: {n} image positions do not fit "
                             f"in a sequence of {S} tokens")
        img = dense(image_embeds.to(compute_dtype), params["proj"],
                    "frontend.proj")
        x = torch.cat([img, x[:, n:]], dim=1)
    positions = (None if mode == "decode" else
                 torch.arange(tokens.shape[1], device=tokens.device)[None, :])
    x, aux_d, new_caches = _run_stack(
        params["decoder"], x, cfg=cfg, pcfg=pcfg, pattern=cfg.pattern,
        tail_kinds=cfg.tail_kinds, mode=mode, caches=cache, pos=pos,
        positions=positions, enc_out=enc_out)
    aux = aux + aux_d
    x = apply_norm(params["final_norm"], x, cfg.norm)
    if not isinstance(aux, torch.Tensor):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, (new_caches if mode in ("prefill", "decode") else None), aux


def compute_logits(params, h, cfg: ArchConfig):
    """h: (B,S,D) -> logits (B,S,Vp) fp32 from the tied embedding or the
    untied head, softcapped (``tanh(logits / c) * c``) where the arch
    sets ``logit_softcap``, padded vocab masked."""
    if cfg.tie_embeddings:
        logits = einsum("bsd,vd->bsv", h, params["embed"].to(h.dtype))
    else:
        logits = dense(h, params["head"], "lm_head")
    logits = logits.float()
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
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
    """batch: {tokens, targets, mask, [image_embeds], [enc_frames]}.
    Returns (xent + aux, {"xent", "aux"}); aux is the MoE FFNs'
    load-balancing loss (0 without one)."""
    h, _, aux = forward(params, batch["tokens"], cfg=cfg, pcfg=pcfg,
                        mode="train", image_embeds=batch.get("image_embeds"),
                        enc_frames=batch.get("enc_frames"),
                        compute_dtype=compute_dtype)
    loss = chunked_xent(params, h, batch["targets"], batch["mask"], cfg=cfg,
                        chunk=pcfg.xent_chunk, z_coef=z_coef)
    return loss + aux, {"xent": loss, "aux": aux}


def prefill(params, tokens, *, cfg: ArchConfig, pcfg, image_embeds=None,
            enc_frames=None, compute_dtype=torch.bfloat16):
    """Returns (last-position logits (B,Vp), cache)."""
    h, cache, _ = forward(params, tokens, cfg=cfg, pcfg=pcfg,
                          mode="prefill", image_embeds=image_embeds,
                          enc_frames=enc_frames, compute_dtype=compute_dtype)
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
