"""Step functions (train / prefill / decode) shared by the training driver
and the serving driver.

The PyTorch counterpart of ``src/repro/launch/steps.py``.  A step takes the
model's parameters as the dict that ``model.named_parameters()`` gives (the
model computes with them), where the JAX step takes a pytree; the train
step updates them and the moments in place.  Prefill and decode steps
serve every family, as the JAX package's do.
"""

from __future__ import annotations

from repro_torch.models import ArchConfig
from repro_torch.optim import adamw_update


def make_train_step(model, *, lr: float = 3e-4):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``: loss, backward, ``adamw_update``.  ``params``
    are ``model``'s trainable parameters by name."""
    def train_step(params, opt_state, batch):
        loss = model.loss(batch)
        loss.backward()
        grads = {k: p.grad for k, p in params.items()}
        params, opt_state, gnorm = adamw_update(params, grads, opt_state,
                                                lr=lr)
        for p in params.values():
            p.grad = None
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step


def make_prefill_step(model, cfg: ArchConfig, max_len: int):
    """``prefill_step(batch)``: the model's prefill of ``batch["tokens"]``
    (with ``batch["vis"]`` for the vlm family), ``(last-token logits,
    cache)``.  The audio family's step encodes ``batch["frames"]`` and runs
    the teacher-forced decoder, returning the last position's logits alone,
    as the JAX package's does."""
    if cfg.family == "audio":
        def prefill_step(batch):
            enc = model.encode(batch["frames"])
            return model.decode_train(enc, batch["tokens"])[:, -1]
        return prefill_step

    if cfg.family == "vlm":
        def prefill_step(batch):
            return model.prefill(batch["vis"], batch["tokens"], max_len)
        return prefill_step

    def prefill_step(batch):
        return model.prefill(batch["tokens"], max_len)

    return prefill_step


def make_decode_step(model, cfg: ArchConfig):
    """``decode_step(cache, ids)``, or ``decode_step(cache, ids, enc_out)``
    for the audio family (the decoder attends to the encoder's output)."""
    if cfg.family == "audio":
        def decode_step(cache, ids, enc_out):
            return model.decode_step(cache, ids, enc_out)
        return decode_step

    def decode_step(cache, ids):
        return model.decode_step(cache, ids)

    return decode_step
