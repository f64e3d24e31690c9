"""Zamba2-style hybrid: a Mamba2 backbone with one *shared* attention and
MLP block (arXiv:2411.15242), invoked at the start of every group of
``cfg.attn_every`` Mamba2 layers; each invocation keeps its own KV cache at
decode time.

The PyTorch counterpart of ``src/repro/models/zamba2.py`` for serving and
training.  The shared block's prefill and training attention goes through
``layers.attention``, so kernel B3 serves it when ``flash_attention`` is
on; the Mamba2 layers reuse ``Mamba2LM``'s blocks, with B4 in their prefill
and training forward.  With ``cfg.remat`` the training forward
recomputes the Mamba2 layers in the backward, not the shared block, as the
JAX model checkpoints its inner scan only.  The KV cache is not a ring:
position ``p`` lives in slot ``p``, and ``kpos`` marks the filled slots.
"""

from __future__ import annotations

import torch

from . import layers as L
from .config import ArchConfig
from .mamba2 import CONV_WIDTH, Mamba2LM


class Zamba2LM(L.TreeLM):
    """Build with ``Zamba2LM(cfg)``, then :meth:`init` or :meth:`load`; the
    top-level parameters also hold the ``shared`` block."""

    def __init__(self, cfg: ArchConfig):
        if cfg.family != "hybrid":
            raise ValueError(f"Zamba2LM serves the hybrid family, not "
                             f"{cfg.family}")
        if not cfg.attn_every or cfg.num_layers % cfg.attn_every:
            raise ValueError(f"attn_every {cfg.attn_every} must divide "
                             f"num_layers {cfg.num_layers}")
        super().__init__(cfg)
        self.mamba = Mamba2LM(cfg)          # the layers' blocks; holds no weights
        self.groups = cfg.num_layers // cfg.attn_every

    # -- params ---------------------------------------------------------------
    def init(self, generator: torch.Generator) -> "Zamba2LM":
        """Fresh weights with the JAX package's scales, drawn on the
        generator's device."""
        cfg = self.cfg
        dev = generator.device
        params = {
            "embed": L.init_embedding(cfg.vocab_size, cfg.d_model, cfg.pdt,
                                      generator),
            "ln_f": L.init_norm(cfg.d_model, cfg.pdt, dev),
            "shared": {"ln1": L.init_norm(cfg.d_model, cfg.pdt, dev),
                       "ln2": L.init_norm(cfg.d_model, cfg.pdt, dev),
                       "attn": L.init_attention(cfg, generator),
                       "mlp": L.init_mlp(cfg, generator)},
        }
        layers = [self.mamba.init_layer(generator)
                  for _ in range(cfg.num_layers)]
        if not cfg.tie_embeddings:
            params["head"] = L.init_linear(cfg.d_model, cfg.vocab_size,
                                           cfg.pdt, generator)
        return self.load(params, layers)

    def _group(self, gi: int):
        g = self.cfg.attn_every
        return range(gi * g, (gi + 1) * g)

    def _shared_block(self, x, positions, mask):
        cfg = self.cfg
        sp = self.params["shared"]
        a, kv = L.attention(sp["attn"], cfg,
                            L.rms_norm(sp["ln1"], x, cfg.norm_eps), positions,
                            mask, causal=True, use_kernel=cfg.flash_attention)
        x = x + a
        x = x + L.mlp(sp["mlp"], cfg, L.rms_norm(sp["ln2"], x, cfg.norm_eps))
        return x, kv

    def _prefill_layers(self, ids):
        """The whole prompt through every group: returns the last hidden
        state, each group's ``(k, v)`` and each layer's conv tail and final
        SSD state."""
        B, S = ids.shape
        x = L.embed(self.params["embed"], ids).to(self.cfg.adt)
        positions = torch.arange(S, device=ids.device)
        mask = L.causal_mask(S, S, device=ids.device)
        kvs, convs, ssms = [], [], []
        for gi in range(self.groups):
            x, kv = self._shared_block(x, positions, mask)
            kvs.append(kv)
            for li in self._group(gi):
                x, conv_tail, hlast = L.remat(self.cfg, self.mamba.layer,
                                              self.layers[li], x)
                convs.append(conv_tail)
                ssms.append(hlast)
        return x, kvs, convs, ssms

    # -- forward --------------------------------------------------------------------
    def forward(self, ids):
        x = self._prefill_layers(ids)[0]
        return self._logits(x), 0.0

    # -- decode -----------------------------------------------------------------------
    def init_cache(self, B: int, max_len: int, device=None) -> dict:
        """``pos`` is a Python int."""
        cfg = self.cfg
        m = self.mamba
        G, K, hd = self.groups, cfg.num_kv_heads, cfg.hd
        kw = dict(dtype=cfg.adt, device=device)
        return {
            "conv": torch.zeros((cfg.num_layers, B, CONV_WIDTH - 1, m.conv_dim),
                                **kw),
            "ssm": torch.zeros((cfg.num_layers, B, m.nheads, m.headdim,
                                cfg.ssm_state), **kw),
            "k": torch.zeros((G, B, max_len, K, hd), **kw),
            "v": torch.zeros((G, B, max_len, K, hd), **kw),
            "kpos": torch.full((max_len,), -1, dtype=torch.int32,
                               device=device),
            "pos": 0,
        }

    def prefill(self, ids, max_len: int):
        """Run the full prompt, return (last-token logits, primed cache)."""
        cfg = self.cfg
        B, S = ids.shape
        x, kvs, convs, ssms = self._prefill_layers(ids)
        cache = L.new_cache(self.init_cache, B, max_len, ids)
        cache["k"][:, :, :S] = torch.stack([k for k, _ in kvs])
        cache["v"][:, :, :S] = torch.stack([v for _, v in kvs])
        cache["kpos"][:S] = torch.arange(S, dtype=torch.int32,
                                         device=ids.device)
        cache["conv"] = torch.stack(convs).to(cfg.adt)
        cache["ssm"] = torch.stack(ssms).to(cfg.adt)
        cache["pos"] = S
        return self._logits(x[:, -1:])[:, -1], cache

    def decode_step(self, cache, ids):
        """ids: [B,1] next token; returns (logits [B,V], new cache).

        The new key, value, conv window and state are written into the
        cache's tensors in place (the returned cache shares them)."""
        cfg = self.cfg
        B = ids.shape[0]
        pos = cache["pos"]
        x = L.embed(self.params["embed"], ids).to(cfg.adt)
        positions = torch.full((1,), pos, device=ids.device)
        kpos = cache["kpos"].clone()
        kpos[pos] = pos
        mask = (kpos >= 0)[None, :]                         # [1,T]
        sp = self.params["shared"]
        attn = sp["attn"]
        K, hd, H = cfg.num_kv_heads, cfg.hd, cfg.num_heads
        for gi in range(self.groups):
            k_g, v_g = cache["k"][gi], cache["v"][gi]
            h = L.rms_norm(sp["ln1"], x, cfg.norm_eps)
            q = L.heads(L.linear(attn["wq"], h), H, hd, K)
            q = L.apply_rope(q, positions, cfg.rope_theta)
            kn = L.heads(L.linear(attn["wk"], h), K, hd, K)
            vn = L.heads(L.linear(attn["wv"], h), K, hd, K)
            kn = L.apply_rope(kn, positions, cfg.rope_theta)
            k_g[:, pos] = kn[:, 0]
            v_g[:, pos] = vn[:, 0]
            o = L._sdpa(q.reshape(B, 1, K, H // K, hd), k_g, v_g, mask)
            x = x + L.linear(attn["wo"], o.reshape(B, 1, H * hd))
            x = x + L.mlp(sp["mlp"], cfg, L.rms_norm(sp["ln2"], x, cfg.norm_eps))
            for li in self._group(gi):
                x, conv_new, ssm_new = self.mamba.decode_layer(
                    self.layers[li], x, cache["conv"][li], cache["ssm"][li])
                cache["conv"][li] = conv_new
                cache["ssm"][li] = ssm_new
        new_cache = dict(cache, kpos=kpos, pos=pos + 1)
        return self._logits(x)[:, 0], new_cache
