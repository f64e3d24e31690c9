"""Logical-to-mesh sharding rules for every parameter / input / cache tensor.

The PyTorch counterpart of ``src/repro/sharding/rules.py``, with the same
rule table: parameter paths (regex over '/'-joined keys) map to *logical*
specs; ``_fit`` then drops any axis whose size does not divide the tensor
dimension (e.g. 2 KV heads cannot shard over a 16-way model axis).

Scheme (Megatron-style TP over 'model', DP over ('pod','data'), EP for MoE
experts over 'model', ZeRO-1 handled in optim):
  * embeddings / lm head        -> vocab-sharded over model
  * attention wq/wk/wv          -> output(heads)-sharded; wo input-sharded
  * MLP wi/wg                   -> d_ff-sharded; wo input-sharded
  * MoE expert weights [E,D,F]  -> expert-sharded over model (EP)
  * Mamba in/out projections    -> inner-dim sharded
  * norms / scalars             -> replicated

The JAX tree stacks each layer's arrays under a leading ``L`` axis and its
specs carry a ``None`` for it; the port keeps one tree per layer (a name
like ``layers.3.attn.wq.w``), so its spec is the reference's without that
leading entry.  Decode caches are stacked in both packages and get the same
specs; the port's ``pos`` is a Python int and gets none.
"""

from __future__ import annotations

import re

from .partition import NamedSharding, axis_size, data_axes

# Copied from src/repro/sharding/rules.py.
# (path regex, spec WITHOUT the leading stacked-layer axis)
# "D" placeholder = the data axes tuple, "M" = the model axis.
_RULES: list[tuple[str, tuple]] = [
    (r"embed/e$",                ("M", None)),          # vocab-sharded
    (r"head/w$",                 (None, "M")),
    (r"pos_dec$",                (None, None)),
    (r"(attn|xattn)/w[qkv]/w$",  (None, "M")),
    (r"(attn|xattn)/w[qkv]/b$",  ("M",)),
    (r"(attn|xattn)/wo/w$",      ("M", None)),
    (r"(attn|xattn)/wo/b$",      (None,)),
    (r"mlp/w[ig]/w$",            (None, "M")),
    (r"mlp/wo/w$",               ("M", None)),
    (r"moe/router/w$",           (None, None)),
    (r"moe/w[ig]$",              ("M", None, None)),    # expert-parallel
    (r"moe/wo$",                 ("M", None, None)),
    (r"in_proj/w$",              (None, "M")),
    (r"out_proj/w$",             ("M", None)),
    (r"conv_w$",                 (None, "M")),
    (r"conv_b$",                 ("M",)),
    (r"(A_log|dt_bias)$",        ("M",)),
    (r"/D$",                     ("M",)),
    (r"proj/w[12]/w$",           (None, "M")),
    (r"(ln1|ln2|lnx|ln|ln_f|ln_enc|norm)/g$", None),    # replicated
]


def _fit(spec_tpl, shape, mesh) -> tuple:
    """Materialize a rule into a spec that divides ``shape``."""
    if spec_tpl is None:
        return ()
    dp = data_axes(mesh)
    entries: list = []
    for axis_tag in spec_tpl:
        if axis_tag is None:
            entries.append(None)
        elif axis_tag == "M":
            entries.append("model")
        elif axis_tag == "D":
            entries.append(dp)
        else:
            entries.append(axis_tag)
    entries = entries[:len(shape)] + [None] * max(0, len(shape) - len(entries))
    # drop axes that do not divide the dim
    return tuple(e if e is not None and dim % axis_size(mesh, e) == 0
                 else None for dim, e in zip(shape, entries))


def _path_str(name: str) -> str:
    """The reference's '/'-joined tree path of a port parameter name: the
    ``params`` container and the layer index go (``layers.3.attn.wq.w`` ->
    ``layers/attn/wq/w``, ``lm.params.embed.e`` -> ``lm/embed/e``)."""
    return "/".join(k for k in name.split(".")
                    if k != "params" and not k.isdigit())


def spec_for_param(path: str, shape, mesh) -> tuple:
    """The spec of one parameter of the port (per layer: no leading axis)."""
    for pat, tpl in _RULES:
        if re.search(pat, path):
            return _fit(tpl, shape, mesh)
    return ()   # replicate by default


def param_shardings(params: dict, mesh) -> dict:
    """``{name: NamedSharding}`` for ``{name: tensor}`` (a model's
    ``named_parameters()``; fake or meta tensors do)."""
    return {name: NamedSharding(
                mesh, spec_for_param(_path_str(name), t.shape, mesh))
            for name, t in params.items()}


def batch_shardings(batch, mesh):
    """Training/prefill batch: leading dim sharded over all data axes.  Takes
    a dict of tensors or one tensor."""
    dp = data_axes(mesh)

    def one(leaf):
        if leaf.shape and leaf.shape[0] % axis_size(mesh, dp) == 0:
            return NamedSharding(mesh, (dp, *([None] * (len(leaf.shape) - 1))))
        return NamedSharding(mesh, ())

    if isinstance(batch, dict):
        return {k: one(v) for k, v in batch.items()}
    return one(batch)


def cache_shardings(cache: dict, mesh, *, batch_dim: int = 1) -> dict:
    """Decode caches: [L, B, T, K, hd] — shard batch over data axes and the
    kv-head dim over model when divisible (falls back per-dim).  Entries
    that are not tensors (``pos``) get none."""
    dp = data_axes(mesh)
    model = axis_size(mesh, "model")

    def one(key, shape):
        spec: list = [None] * len(shape)
        if key.endswith("pos") or not shape:
            return NamedSharding(mesh, ())
        if len(shape) >= 2 and shape[batch_dim] % axis_size(mesh, dp) == 0:
            spec[batch_dim] = dp
        # shard kv heads (dim -2 of k/v; dim 2 of ssm [L,B,h,p,n]) over model
        for cand in (len(shape) - 2, 2):
            if 0 <= cand < len(shape) and spec[cand] is None and cand != batch_dim:
                if shape[cand] % model == 0 and shape[cand] > 1:
                    spec[cand] = "model"
                    break
        return NamedSharding(mesh, tuple(spec))

    return {k: one(k, tuple(v.shape)) for k, v in cache.items()
            if hasattr(v, "shape")}
