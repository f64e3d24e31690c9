"""InternVL2-style VLM backbone (arXiv:2404.16821).

The PyTorch counterpart of ``src/repro/models/internvl.py``.  The InternViT
frontend is a stub, as in the JAX package: ``vis`` holds precomputed patch
embeddings ``[B, vis_tokens, D_VIS]``; a 2-layer MLP projector maps them into
the LM's embedding space and they are prepended to the text tokens.  The
language backbone is the port's ``DecoderLM`` (``lm``), so kernel B3 serves
every layer's prefill and training forward when ``flash_attention`` is on;
logits and labels cover only the text positions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..data.pipeline import D_VIS
from . import layers as L
from .config import ArchConfig
from .transformer import DecoderLM


class InternVLModel(nn.Module):
    """Build with ``InternVLModel(cfg)``, then :meth:`init` draws weights from
    a generator or :meth:`load` takes the JAX package's tree (the ``lm``
    tree and ``proj``)."""

    def __init__(self, cfg: ArchConfig):
        if cfg.family != "vlm":
            raise ValueError(f"InternVLModel serves the vlm family, not "
                             f"{cfg.family}")
        super().__init__()
        self.cfg = cfg
        self.lm = DecoderLM(cfg)
        self.proj = nn.ModuleDict()

    def init(self, generator: torch.Generator) -> "InternVLModel":
        """Fresh weights with the JAX package's scales, drawn on the
        generator's device."""
        cfg = self.cfg
        self.lm.init(generator)
        self.proj = L.Tree({
            "w1": L.init_linear(D_VIS, cfg.d_model, cfg.pdt, generator),
            "w2": L.init_linear(cfg.d_model, cfg.d_model, cfg.pdt, generator)})
        return self

    def load(self, params: dict, layers: list, proj: dict) -> "InternVLModel":
        """``params`` and ``layers`` are the language model's (see
        ``TreeLM.load``), ``proj`` the projector's tree."""
        self.lm.load(params, layers)
        self.proj = L.Tree(proj)
        return self

    def _embed_multimodal(self, vis, ids):
        cfg = self.cfg
        # jax.nn.gelu defaults to the tanh approximation
        v = L.linear(self.proj["w2"],
                     F.gelu(L.linear(self.proj["w1"], vis.to(cfg.adt)),
                            approximate="tanh"))
        t = L.embed(self.lm.params["embed"], ids).to(cfg.adt)
        return torch.cat([v, t], dim=1)

    def _causal(self, x):
        S = x.shape[1]
        return (torch.arange(S, device=x.device),
                L.causal_mask(S, S, device=x.device))

    def forward(self, batch: dict):
        """batch: ``{vis: [B, Tv, D_VIS], tokens: [B, S]}``; logits over the
        text part and the MoE aux loss (0 here)."""
        x = self._embed_multimodal(batch["vis"], batch["tokens"])
        logits, aux = self.lm.forward_embedded(x, *self._causal(x))
        return logits[:, batch["vis"].shape[1]:], aux

    def loss(self, batch: dict) -> torch.Tensor:
        logits, aux = self.forward(batch)
        return L.cross_entropy(logits[:, :-1], batch["labels"][:, 1:],
                               batch.get("mask", None)) + 0.01 * aux

    # -- decode: delegate to the LM after a multimodal prefill --------------------
    def prefill(self, vis, ids, max_len: int):
        """The image and the prompt through the LM: (last-token logits, a
        primed cache).  The last ``min(S, W)`` positions go into slots
        ``0..take`` (not ``p % W``), as the JAX model writes them."""
        x = self._embed_multimodal(vis, ids)
        B, S = x.shape[:2]
        logits, _, kvs = self.lm.forward_embedded(x, *self._causal(x),
                                                  return_cache=True,
                                                  last_only=True)
        cache = L.new_cache(self.lm.init_cache, B, max_len, x)
        W = cache["k"].shape[2]
        take = min(S, W)
        for i, (k, v) in enumerate(kvs):
            cache["k"][i][:, :take] = k[:, S - take:]
            cache["v"][i][:, :take] = v[:, S - take:]
        cache["kpos"][:take] = torch.arange(S - take, S, dtype=torch.int32,
                                            device=x.device)
        cache["pos"] = S
        return logits[:, -1], cache

    def init_cache(self, B: int, max_len: int, device=None) -> dict:
        return self.lm.init_cache(B, max_len, device)

    def decode_step(self, cache: dict, ids: torch.Tensor):
        return self.lm.decode_step(cache, ids)
