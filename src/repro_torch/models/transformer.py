"""Model assembly, dense family — counterpart of ``repro/models/transformer.py``.

Parameters are plain dicts of tensors under the reference pytree's names,
with one difference of layout: the reference stacks every layer leaf on a
leading ``nb`` axis for ``lax.scan``, the port keeps ``params["layers"]``
as a list of ``nb`` block dicts and loops over it in Python
(``convert.model_params`` unstacks a reference pytree).  The serve cache
keeps the reference layout ``(nb, sub, B, S, KV, hd)`` and is written in
place.

Public entry points:
  init_params(cfg, gen)                      -> params dict
  forward(cfg, params, tokens)               -> (logits, aux)
  init_cache(cfg, batch, max_len, device)    -> serve cache dict
  prefill(cfg, params, tokens, cache)        -> (logits_last, cache)
  decode_step(cfg, params, token, cache, pos) -> (logits, cache)

Only the dense family is ported; ``moe``, ``ssm``, ``hybrid``, ``vlm`` and
``audio``, frame-embedding decode (``decode_step_embeds``) and
``train_loss`` raise ``NotImplementedError`` (ROADMAP queue 1 item 10).
"""
from __future__ import annotations

import torch

from repro_torch.core.ckks import resolve_device
from repro_torch.models.common import (ModelConfig, attn_forward, attn_init,
                                       dense_init, mlp_forward, mlp_init,
                                       rmsnorm)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue 1 item 10: the port "
        f"serves the dense family only)")


# ---------------------------------------------------------------------------
# block definitions (one "block" = the reference's scanned unit)
# ---------------------------------------------------------------------------


def _block_structure(cfg: ModelConfig):
    """(num_blocks, sub-layer plan per block): dense is one attn+ffn layer
    a block (the reference's plan also counts ssm and cross layers)."""
    if cfg.family != "dense":
        raise _not_ported(f"the {cfg.family!r} family")
    return cfg.num_layers, {"attn": 1}


def _layer_init(cfg: ModelConfig, gen: torch.Generator) -> dict:
    _, plan = _block_structure(cfg)
    ones = dict(dtype=cfg.adtype, device=gen.device)
    return {"attn_layers": [
        {"attn": attn_init(cfg, gen),
         "ln1": torch.ones((cfg.d_model,), **ones),
         "ln2": torch.ones((cfg.d_model,), **ones),
         "ffn": mlp_init(cfg, gen)}
        for _ in range(plan["attn"])]}


def _attn_sublayer(cfg, p, x, positions, kv_cache=None, cache_len=None):
    h, _ = attn_forward(cfg, p["attn"],
                                rmsnorm(x, p["ln1"], cfg.norm_eps),
                                positions, kv_cache=kv_cache,
                                cache_len=cache_len)
    x = x + h
    y = mlp_forward(cfg, p["ffn"], rmsnorm(x, p["ln2"], cfg.norm_eps))
    return x + y


def _block_forward(cfg: ModelConfig, p: dict, x, positions, *, cache=None,
                   cache_len=None):
    """One block.  ``cache``: {"kv": {"k", "v"}} with a leading sub-layer
    axis, written in place."""
    for i, ap in enumerate(p["attn_layers"]):
        kv = None if cache is None else {n: c[i]
                                         for n, c in cache["kv"].items()}
        x = _attn_sublayer(cfg, ap, x, positions, kv_cache=kv,
                           cache_len=cache_len)
    return x


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random weights drawn from ``gen`` on its device: the embedding,
    then the ``nb`` blocks in order, then the head."""
    nb, _ = _block_structure(cfg)
    p = {"embed": dense_init(gen, (cfg.vocab_size, cfg.d_model), cfg.adtype),
         "layers": [_layer_init(cfg, gen) for _ in range(nb)],
         "final_norm": torch.ones((cfg.d_model,), dtype=cfg.adtype,
                                  device=gen.device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                  cfg.adtype)
    return p


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _embed(cfg, params, tokens):
    return params["embed"][tokens]


def _logits(cfg, params, x):
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (x @ head).float()


def forward(cfg: ModelConfig, params: dict, tokens):
    """tokens (B, S): logits of every position (B, S, V) in float32, and
    the aux loss (0.0: the dense family has no router)."""
    _block_structure(cfg)
    x = _embed(cfg, params, tokens)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for lp in params["layers"]:
        x = _block_forward(cfg, lp, x, positions)
    return _logits(cfg, params, x), 0.0


def train_loss(cfg: ModelConfig, params, batch):
    raise _not_ported("training (train_loss)")


# ---------------------------------------------------------------------------
# serving: prefill + decode with caches
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> dict:
    """Zeroed KV cache {"kv": {"k", "v"}} of (nb, sub, batch, max_len, KV,
    hd), the reference's layout; CUDA unless ``device`` says otherwise."""
    nb, plan = _block_structure(cfg)
    shape = (nb, plan["attn"], batch, max_len, cfg.kv_heads, cfg.hdim)
    dev = resolve_device(device)
    return {"kv": {n: torch.zeros(shape, dtype=cfg.adtype, device=dev)
                   for n in ("k", "v")}}


def _serve_scan(cfg, params, x, positions, cache, cache_len):
    """The reference's ``lax.scan`` over blocks as a Python loop; block b
    reads and writes ``cache[...][b]`` in place."""
    nb, _ = _block_structure(cfg)
    for b in range(nb):
        lc = {"kv": {n: c[b] for n, c in cache["kv"].items()}}
        x = _block_forward(cfg, params["layers"][b], x, positions,
                           cache=lc, cache_len=cache_len)
    return x, cache


def prefill(cfg: ModelConfig, params: dict, tokens, cache: dict):
    """tokens (B, S): fill cache rows [0, S); logits of the last position
    (B, 1, V) and the cache."""
    x = _embed(cfg, params, tokens)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, cache = _serve_scan(cfg, params, x, positions, cache, 0)
    return _logits(cfg, params, x[:, -1:]), cache


def _decode_positions(pos, device) -> torch.Tensor:
    """Scalar pos (uniform batch) -> (1, 1); (B,) vector (continuous
    batching, per-slot lengths) -> (B, 1) so RoPE and the KV write use each
    slot's own position."""
    pos = torch.as_tensor(pos, device=device)
    return pos.reshape(-1, 1) if pos.ndim else pos.reshape(1, 1)


def decode_step(cfg: ModelConfig, params: dict, token, cache: dict, pos):
    """token: (B, 1) integer; pos: an int (the current length), or a (B,)
    array of per-slot lengths."""
    x = _embed(cfg, params, token)
    if not isinstance(pos, int):
        pos = torch.as_tensor(pos, device=x.device)
    positions = _decode_positions(pos, x.device)
    x, cache = _serve_scan(cfg, params, x, positions, cache, pos)
    return _logits(cfg, params, x), cache


def decode_step_embeds(cfg: ModelConfig, params, embeds, cache, pos):
    raise _not_ported("frame-embedding decode (the audio family)")
