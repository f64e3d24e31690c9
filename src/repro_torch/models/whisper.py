"""Whisper-style encoder-decoder backbone (arXiv:2212.04356).

The PyTorch counterpart of ``src/repro/models/whisper.py``.  The conv/mel
frontend is a stub, as in the JAX package: ``frames`` are precomputed frame
embeddings ``[B, enc_frames, d_model]``.  The encoder is bidirectional with
sinusoidal positions; the decoder has causal self-attention and
cross-attention on the encoder's output, with learned positions
(``MAX_TGT`` rows) and the tied embedding as its head.  No RoPE.  Every
attention takes the einsum route of ``layers._sdpa`` (the JAX model never
asks for the kernel), so no kernel runs here.

The weights are :class:`layers.Tree` modules in the JAX package's layout:
top-level parameters in ``params`` (``embed``, ``pos_dec``, ``ln_enc``,
``ln_f``) and one tree per layer in ``enc`` and ``dec``.  JAX's ``scan``
over stacked layers becomes a loop; with ``cfg.remat`` training recomputes
each encoder and decoder layer in the backward (``layers.remat``).
"""

from __future__ import annotations

import torch
from torch import nn

from . import layers as L
from .config import ArchConfig

MAX_TGT = 32768   # decoder position table, as the JAX package's


def sinusoid(S: int, d: int, device=None) -> torch.Tensor:
    """``[sin | cos]`` of ``pos / 10000^(2i/d)``, concatenated (not
    interleaved), f32 ``[S, d]``."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class WhisperModel(nn.Module):
    """Build with ``WhisperModel(cfg)``, then :meth:`init` draws weights from
    a generator or :meth:`load` takes the JAX package's tree (see
    ``models.convert.model_from_numpy``)."""

    def __init__(self, cfg: ArchConfig):
        if cfg.family != "audio":
            raise ValueError(f"WhisperModel serves the audio family, not "
                             f"{cfg.family}")
        super().__init__()
        self.cfg = cfg
        self.params = nn.ModuleDict()
        self.enc = nn.ModuleList()
        self.dec = nn.ModuleList()

    # -- params ---------------------------------------------------------------
    def _attn_mlp_block(self, generator, cross=False) -> dict:
        cfg = self.cfg
        dev = generator.device
        p = {"ln1": L.init_norm(cfg.d_model, cfg.pdt, dev),
             "ln2": L.init_norm(cfg.d_model, cfg.pdt, dev),
             "attn": L.init_attention(cfg, generator),
             "mlp": L.init_mlp(cfg, generator)}
        if cross:
            p["lnx"] = L.init_norm(cfg.d_model, cfg.pdt, dev)
            p["xattn"] = L.init_attention(cfg, generator)
        return p

    def init(self, generator: torch.Generator) -> "WhisperModel":
        """Fresh weights with the JAX package's scales, drawn on the
        generator's device."""
        cfg = self.cfg
        dev = generator.device
        params = {
            "embed": L.init_embedding(cfg.vocab_size, cfg.d_model, cfg.pdt,
                                      generator),
            "pos_dec": L._normal((MAX_TGT, cfg.d_model), cfg.pdt, 0.01,
                                 generator),
            "ln_enc": L.init_norm(cfg.d_model, cfg.pdt, dev),
            "ln_f": L.init_norm(cfg.d_model, cfg.pdt, dev),
        }
        enc = [self._attn_mlp_block(generator) for _ in range(cfg.enc_layers)]
        dec = [self._attn_mlp_block(generator, cross=True)
               for _ in range(cfg.num_layers)]
        return self.load(params, enc, dec)

    def load(self, params: dict, enc: list, dec: list) -> "WhisperModel":
        self.params = L.Tree(params)
        self.enc = nn.ModuleList(L.Tree(lp) for lp in enc)
        self.dec = nn.ModuleList(L.Tree(lp) for lp in dec)
        return self

    # -- encoder ----------------------------------------------------------------
    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames: ``[B, F, d_model]`` precomputed frame embeddings."""
        cfg = self.cfg
        B, F, _ = frames.shape
        x = (frames.to(cfg.adt)
             + sinusoid(F, cfg.d_model, frames.device).to(cfg.adt))
        positions = torch.arange(F, device=frames.device)
        mask = torch.ones((F, F), dtype=torch.bool, device=frames.device)
        for lp in self.enc:
            x = L.remat(cfg, self._enc_layer, lp, x, positions, mask)
        return L.rms_norm(self.params["ln_enc"], x, cfg.norm_eps)

    def _enc_layer(self, lp, x, positions, mask):
        cfg = self.cfg
        a, _ = L.attention(lp["attn"], cfg,
                           L.rms_norm(lp["ln1"], x, cfg.norm_eps),
                           positions, mask)
        x = x + a
        return x + L.mlp(lp["mlp"], cfg,
                         L.rms_norm(lp["ln2"], x, cfg.norm_eps))

    # -- decoder ------------------------------------------------------------------
    def _cross_kv(self, lp, enc_out):
        cfg = self.cfg
        B, F = enc_out.shape[:2]
        K, hd = cfg.num_kv_heads, cfg.hd
        ek = L.heads(L.linear(lp["xattn"]["wk"], enc_out), K, hd, K)
        ev = L.heads(L.linear(lp["xattn"]["wv"], enc_out), K, hd, K)
        return ek, ev

    def _head(self, x):
        x = L.rms_norm(self.params["ln_f"], x, self.cfg.norm_eps)
        return L.unembed(self.params["embed"], x)    # tied embeddings

    def decode_train(self, enc_out: torch.Tensor, ids: torch.Tensor):
        """Teacher-forced decoder over ``ids [B, S]``: f32 logits
        ``[B, S, V]``."""
        cfg = self.cfg
        B, S = ids.shape
        F = enc_out.shape[1]
        dev = ids.device
        x = (L.embed(self.params["embed"], ids).to(cfg.adt)
             + self.params["pos_dec"][:S].to(cfg.adt))
        positions = torch.arange(S, device=dev)
        self_mask = L.causal_mask(S, S, device=dev)
        x_mask = torch.ones((S, F), dtype=torch.bool, device=dev)
        for lp in self.dec:
            x = L.remat(cfg, self._dec_layer, lp, x, enc_out, positions,
                        self_mask, x_mask)
        return self._head(x)

    def _dec_layer(self, lp, x, enc_out, positions, self_mask, x_mask):
        """One teacher-forced decoder layer, the cross K/V included (the
        JAX model computes them inside its checkpointed body)."""
        cfg = self.cfg
        a, _ = L.attention(lp["attn"], cfg,
                           L.rms_norm(lp["ln1"], x, cfg.norm_eps),
                           positions, self_mask, causal=True)
        x = x + a
        a, _ = L.attention(lp["xattn"], cfg,
                           L.rms_norm(lp["lnx"], x, cfg.norm_eps),
                           positions, x_mask, kv=self._cross_kv(lp, enc_out))
        x = x + a
        return x + L.mlp(lp["mlp"], cfg,
                         L.rms_norm(lp["ln2"], x, cfg.norm_eps))

    def forward(self, batch: dict):
        enc_out = self.encode(batch["frames"])
        return self.decode_train(enc_out, batch["tokens"]), 0.0

    def loss(self, batch: dict) -> torch.Tensor:
        logits, _ = self.forward(batch)
        return L.cross_entropy(logits[:, :-1], batch["labels"][:, 1:],
                               batch.get("mask", None))

    # -- cached decode ----------------------------------------------------------------
    def init_cache(self, B: int, max_len: int, device=None) -> dict:
        """``pos`` is a Python int."""
        cfg = self.cfg
        Lr, K, hd = cfg.num_layers, cfg.num_kv_heads, cfg.hd
        return {
            "k": torch.zeros((Lr, B, max_len, K, hd), dtype=cfg.adt,
                             device=device),
            "v": torch.zeros((Lr, B, max_len, K, hd), dtype=cfg.adt,
                             device=device),
            "pos": 0,
        }

    def decode_step(self, cache: dict, ids: torch.Tensor,
                    enc_out: torch.Tensor):
        """ids: ``[B, 1]`` next token; returns (logits ``[B, V]``, new
        cache).  Position ``p`` lives in slot ``p``; the new key and value
        are written into the cache's tensors in place (the returned cache
        shares them)."""
        cfg = self.cfg
        B = ids.shape[0]
        pos = cache["pos"]
        T = cache["k"].shape[2]
        F = enc_out.shape[1]
        dev = ids.device
        x = (L.embed(self.params["embed"], ids).to(cfg.adt)
             + self.params["pos_dec"][pos:pos + 1].to(cfg.adt)[None])
        mask = (torch.arange(T, device=dev) <= pos)[None, :]
        x_mask = torch.ones((1, F), dtype=torch.bool, device=dev)
        zero = torch.zeros((1,), dtype=torch.int32, device=dev)
        K, hd, H = cfg.num_kv_heads, cfg.hd, cfg.num_heads
        for i, lp in enumerate(self.dec):
            k_l, v_l = cache["k"][i], cache["v"][i]
            h = L.rms_norm(lp["ln1"], x, cfg.norm_eps)
            attn = lp["attn"]
            q = L.heads(L.linear(attn["wq"], h), H, hd, K)
            k_l[:, pos] = L.heads(L.linear(attn["wk"], h), K, hd, K)[:, 0]
            v_l[:, pos] = L.heads(L.linear(attn["wv"], h), K, hd, K)[:, 0]
            o = L._sdpa(q.reshape(B, 1, K, H // K, hd), k_l, v_l, mask)
            x = x + L.linear(attn["wo"], o.reshape(B, 1, H * hd))
            # cross attention against the (static) encoder output
            a, _ = L.attention(lp["xattn"], cfg,
                               L.rms_norm(lp["lnx"], x, cfg.norm_eps),
                               zero, x_mask, kv=self._cross_kv(lp, enc_out))
            x = x + a
            x = x + L.mlp(lp["mlp"], cfg, L.rms_norm(lp["ln2"], x, cfg.norm_eps))
        logits = self._head(x)[:, 0]
        return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}
