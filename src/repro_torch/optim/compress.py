"""Gradient compression: int8 block quantization with error feedback.

The PyTorch counterpart of ``src/repro/optim/compress.py``.  Gradients (a
dict of name -> tensor) are quantized to int8 with one absmax scale per
block of 256 values, and the quantization error is fed back into the next
step's gradients.  Leaves are taken in sorted key order, as the JAX
package flattens a dict.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BLOCK = 256


def _quant(x: torch.Tensor):
    flat = x.float().reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    return flat[:torch.Size(shape).numel()].reshape(shape)


def compress_grads(grads: dict, error_feedback: dict | None = None):
    """int8-compress a gradient dict.

    Returns ``(comp, new_error_feedback)``: ``comp`` holds the leaves'
    ``q`` and ``s`` lists, their ``shapes`` and ``keys``; the error feedback
    is a dict with the gradients' keys."""
    keys = sorted(grads)
    leaves = [grads[k].float() for k in keys]
    if error_feedback is not None:
        leaves = [g + error_feedback[k] for g, k in zip(leaves, keys)]
    qs, ss, err = [], [], {}
    for k, g in zip(keys, leaves):
        q, s = _quant(g)
        qs.append(q)
        ss.append(s)
        err[k] = g - _dequant(q, s, g.shape)
    comp = {"q": qs, "s": ss, "shapes": [g.shape for g in leaves],
            "keys": keys}
    return comp, err


def decompress_grads(comp: dict) -> dict:
    return {k: _dequant(q, s, shape) for k, q, s, shape in
            zip(comp["keys"], comp["q"], comp["s"], comp["shapes"])}


def compression_ratio(grads: dict) -> float:
    """Bytes(int8 + scales) / bytes(fp32) for reporting."""
    total_in = sum(g.numel() * 4 for g in grads.values())
    total_out = sum(g.numel() + (g.numel() + BLOCK - 1) // BLOCK * 4
                    for g in grads.values())
    return total_out / total_in
