"""Decoder-only LM (dense and MoE) with GQA, RoPE, sliding-window attention
and a KV-cached decode (ring buffer for the sliding window).

The PyTorch counterpart of ``src/repro/models/transformer.py`` for serving
and training; also the language backbone of InternVL (the vlm family).
JAX's ``scan`` over stacked layers becomes a loop over an
``nn.ModuleList``; with ``cfg.remat`` each layer's block is recomputed in
the backward (``layers.remat``), as the JAX package checkpoints its scan
body, so training keeps only the layers' inputs.  An MoE layer routes
groups of ``cfg.moe_group`` tokens in prefill and training, and the whole
batch's B tokens in a decode step (so capacity drops many assignments
there, by the reference's design).
"""

from __future__ import annotations

import torch

from . import layers as L
from .config import ArchConfig


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"DecoderLM serves the dense, moe and vlm families, "
                         f"not {cfg.family}")


def _fill_ring(dst: torch.Tensor, src: torch.Tensor, shift: int) -> None:
    """``dst[:, (shift + t) % W] = src[:, t]`` for the ``take`` entries of
    ``src``, as two slice copies."""
    take = src.shape[1]
    dst[:, shift:take] = src[:, :take - shift]
    if shift:
        dst[:, :shift] = src[:, take - shift:]


class DecoderLM(L.TreeLM):
    """Build with ``DecoderLM(cfg)``, then give it weights: :meth:`init`
    draws them from a generator, :meth:`load` takes the JAX package's
    parameter tree."""

    def __init__(self, cfg: ArchConfig):
        _check_family(cfg)
        super().__init__(cfg)

    # -- params ---------------------------------------------------------------
    def init_layer(self, generator: torch.Generator) -> dict:
        cfg = self.cfg
        dev = generator.device
        p = {"ln1": L.init_norm(cfg.d_model, cfg.pdt, dev),
             "ln2": L.init_norm(cfg.d_model, cfg.pdt, dev),
             "attn": L.init_attention(cfg, generator)}
        if cfg.family == "moe":
            p["moe"] = L.init_moe(cfg, generator)
        else:
            p["mlp"] = L.init_mlp(cfg, generator)
        return p

    def init(self, generator: torch.Generator) -> "DecoderLM":
        """Fresh weights with the JAX package's scales, drawn on the
        generator's device (full width never passes through the host)."""
        cfg = self.cfg
        params = {
            "embed": L.init_embedding(cfg.vocab_size, cfg.d_model, cfg.pdt,
                                      generator),
            "ln_f": L.init_norm(cfg.d_model, cfg.pdt, generator.device),
        }
        layers = [self.init_layer(generator) for _ in range(cfg.num_layers)]
        if not cfg.tie_embeddings:
            params["head"] = L.init_linear(cfg.d_model, cfg.vocab_size,
                                           cfg.pdt, generator)
        return self.load(params, layers)

    # -- blocks -----------------------------------------------------------------
    def _block(self, p, x, positions, mask, kv=None, *, use_kernel=None,
               causal=False):
        cfg = self.cfg
        if use_kernel is None:
            use_kernel = cfg.flash_attention
        a, new_kv = L.attention(p["attn"], cfg,
                                L.rms_norm(p["ln1"], x, cfg.norm_eps),
                                positions, mask, kv=kv, use_kernel=use_kernel,
                                causal=causal)
        x = x + a
        h = L.rms_norm(p["ln2"], x, cfg.norm_eps)
        if cfg.family == "moe":
            y, aux = L.moe(p["moe"], cfg, h, group_size=cfg.moe_group)
        else:
            y, aux = L.mlp(p["mlp"], cfg, h), 0.0
        return x + y, aux, new_kv

    # -- full forward (prefill) -----------------------------------------------------
    def forward(self, ids, *, return_cache: bool = False,
                last_only: bool = False):
        cfg = self.cfg
        B, S = ids.shape
        x = L.embed(self.params["embed"], ids).to(cfg.adt)
        positions = torch.arange(S, device=ids.device)
        mask = L.causal_mask(S, S, window=cfg.sliding_window,
                             device=ids.device)
        return self.forward_embedded(x, positions, mask,
                                     return_cache=return_cache,
                                     last_only=last_only)

    def forward_embedded(self, x, positions, mask, *,
                         return_cache: bool = False, last_only: bool = False):
        """``last_only`` computes logits for the final position only.  With
        ``return_cache`` the third result is one ``(k, v)`` per layer, each
        ``[B,S,K,hd]``."""
        aux, kvs = 0.0, []
        for lp in self.layers:
            x, a, kv = L.remat(self.cfg, self._block, lp, x, positions, mask,
                               causal=True)
            aux = aux + a
            if return_cache:
                kvs.append(kv)
        logits = self._logits(x[:, -1:] if last_only else x)
        if return_cache:
            return logits, aux, kvs
        return logits, aux

    # -- cached decode --------------------------------------------------------------
    def cache_len(self, max_len: int) -> int:
        w = self.cfg.sliding_window
        return min(w, max_len) if w else max_len

    def init_cache(self, B: int, max_len: int, device=None) -> dict:
        """``pos`` is a Python int, so decode never waits on the card for
        it."""
        cfg = self.cfg
        W = self.cache_len(max_len)
        K, hd, Lr = cfg.num_kv_heads, cfg.hd, cfg.num_layers
        return {
            "k": torch.zeros((Lr, B, W, K, hd), dtype=cfg.adt, device=device),
            "v": torch.zeros((Lr, B, W, K, hd), dtype=cfg.adt, device=device),
            "kpos": torch.full((W,), -1, dtype=torch.int32, device=device),
            "pos": 0,
        }

    def prefill(self, ids, max_len: int):
        """Run the full prompt, return (last-token logits, primed cache)."""
        B, S = ids.shape
        logits, _, kvs = self.forward(ids, return_cache=True, last_only=True)
        cache = L.new_cache(self.init_cache, B, max_len, ids)
        W = cache["k"].shape[2]
        take = min(S, W)
        # position p lives in ring slot p % W, the invariant decode_step
        # keeps: the kept positions fill slots 0..take from slot
        # (S - take) % W on, wrapping (only when take == W)
        shift = (S - take) % W
        keep_pos = torch.arange(S - take, S, dtype=torch.int32,
                                device=ids.device)
        for i, (k, v) in enumerate(kvs):
            for dst, src in ((cache["k"][i], k), (cache["v"][i], v)):
                _fill_ring(dst, src[:, S - take:], shift)
        _fill_ring(cache["kpos"][None], keep_pos[None], shift)
        cache["pos"] = S
        return logits[:, -1], cache

    def decode_step(self, cache, ids):
        """ids: [B,1] next token; returns (logits [B,V], new cache).

        Unlike the JAX version, the new key and value are written into the
        cache's ``k`` and ``v`` tensors in place (the returned cache shares
        them), so a step copies no cache."""
        cfg = self.cfg
        B = ids.shape[0]
        pos = cache["pos"]
        W = cache["k"].shape[2]
        slot = pos % W
        x = L.embed(self.params["embed"], ids).to(cfg.adt)
        positions = torch.full((1,), pos, device=ids.device)

        kpos = cache["kpos"].clone()
        kpos[slot] = pos
        # mask: valid slots, causal, within window
        valid = kpos >= 0
        if cfg.sliding_window:
            valid &= kpos > pos - cfg.sliding_window
        mask = valid[None, :]                          # [S=1, T=W]

        K, hd, H = cfg.num_kv_heads, cfg.hd, cfg.num_heads
        for i, lp in enumerate(self.layers):
            k_l, v_l = cache["k"][i], cache["v"][i]
            h = L.rms_norm(lp["ln1"], x, cfg.norm_eps)
            attn = lp["attn"]
            q = L.heads(L.linear(attn["wq"], h), H, hd, K)
            q = L.apply_rope(q, positions, cfg.rope_theta) if cfg.rope_theta else q
            kn = L.heads(L.linear(attn["wk"], h), K, hd, K)
            vn = L.heads(L.linear(attn["wv"], h), K, hd, K)
            kn = L.apply_rope(kn, positions, cfg.rope_theta) if cfg.rope_theta else kn
            k_l[:, slot] = kn[:, 0]
            v_l[:, slot] = vn[:, 0]
            qg = q.reshape(B, 1, K, H // K, hd)
            o = L._sdpa(qg, k_l, v_l, mask)
            x = x + L.linear(attn["wo"], o.reshape(B, 1, H * hd))
            h2 = L.rms_norm(lp["ln2"], x, cfg.norm_eps)
            if cfg.family == "moe":
                x = x + L.moe(lp["moe"], cfg, h2, group_size=B)[0]
            else:
                x = x + L.mlp(lp["mlp"], cfg, h2)
        logits = self._logits(x)[:, 0]
        new_cache = {"k": cache["k"], "v": cache["v"], "kpos": kpos,
                     "pos": pos + 1}
        return logits, new_cache
