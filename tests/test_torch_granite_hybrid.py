"""The hybrid_moe family (granite-4.0-h, ``models/granite_hybrid.py``) held
against the plain reference of the benchmark
(``portbench/reference/granite_hybrid.py``) on the CPU, and what it added to
the layers: the dropless expert-parallel MoE and B3's ``scale``.

Reduced configs compute in float32, as the reference does.  Tolerances:
the two sum in other orders (the SSD in chunks of 16 against 32, attention
blockwise, the experts' rows gathered and added back), a few float32 ulps
carried through four layers and the backward (measured 2e-6 of a
gradient's norm); logits 1e-5 of their largest magnitude, the loss 1e-6
relative, each gradient's gap 1e-4 of its norm.
"""

import copy
import dataclasses
import math
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_backward,
                                                 flash_attention_plain)
from repro_torch.models import GraniteHybridLM, HybridMoEConfig, build_model
from repro_torch.models import layers as L
from repro_torch.runtime import TrainLoop

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from portbench.reference import granite_hybrid as ref  # noqa: E402

GRAD_TOL = 1e-4


def _cfg(**kw) -> HybridMoEConfig:
    return get_config("granite-4.0-h-small").reduced(**kw)


def _spec(cfg: HybridMoEConfig, chunk: int = 32) -> ref.Spec:
    """The reference's spec of ``cfg`` (its SSD in chunks of ``chunk``)."""
    return ref.Spec(
        hidden_size=cfg.d_model, num_attention_heads=cfg.num_heads,
        num_key_value_heads=cfg.num_kv_heads, intermediate_size=cfg.d_ff,
        shared_intermediate_size=cfg.shared_ff, vocab_size=cfg.vocab_size,
        layer_types=cfg.layer_types, router_experts=cfg.num_experts,
        experts_held=len(cfg.held), expert_rank=cfg.expert_rank,
        num_experts_per_tok=cfg.top_k, mamba_n_heads=cfg.ssm_heads,
        mamba_d_head=cfg.ssm_expand * cfg.d_model // cfg.ssm_heads,
        mamba_d_state=cfg.ssm_state, mamba_chunk_size=chunk,
        attention_multiplier=cfg.attention_multiplier,
        embedding_multiplier=cfg.embedding_multiplier,
        residual_multiplier=cfg.residual_multiplier,
        logits_scaling=cfg.logits_scaling, rms_norm_eps=cfg.norm_eps)


def _model(cfg, seed=1):
    return build_model(cfg).init(torch.Generator().manual_seed(seed))


def _ids(cfg, B=2, S=64, seed=2):
    return torch.randint(0, cfg.vocab_size, (B, S),
                         generator=torch.Generator().manual_seed(seed))


def _weights(model) -> dict:
    return {k: p.detach().clone() for k, p in model.named_parameters()}


# -- the config ----------------------------------------------------------------
def test_published_config():
    cfg = get_config("granite-4.0-h-small")
    assert isinstance(cfg, HybridMoEConfig) and cfg.family == "hybrid_moe"
    assert [i for i, t in enumerate(cfg.layer_types) if t == "attention"] \
        == [5, 15, 25, 35]
    assert (cfg.d_model, cfg.hd, cfg.num_heads, cfg.num_kv_heads) \
        == (4096, 128, 32, 8)
    assert (cfg.num_experts, cfg.top_k, cfg.d_ff, cfg.shared_ff) \
        == (72, 10, 768, 1536)
    assert cfg.held == range(0, 72) and cfg.attention_multiplier == 1 / 128
    # "32B-A9B": 32.2 billion held, 8.8 billion a token uses
    assert cfg.param_count() == 32_207_337_984
    assert cfg.param_count(active_only=True) == 8_803_121_664


@pytest.mark.parametrize("full", [False, True])
def test_param_count_is_every_weight(full):
    """``param_count`` equals the weights the model holds: the reduced
    model's tensors, and the reference's shapes at the benchmark's cut
    (10 layers, 9 of 72 experts, an eighth of the vocabulary)."""
    if full:
        pub = get_config("granite-4.0-h-small")
        cfg = dataclasses.replace(pub, num_layers=10,
                                  layer_types=pub.layer_types[:10],
                                  experts_held=9, vocab_size=12544)
        held = sum(math.prod(s) for s in
                   ref.weight_shapes(_spec(cfg)).values())
        assert held == cfg.param_count() == 2_055_031_424
    else:
        cfg = _cfg()
        held = sum(p.numel() for p in _model(cfg).parameters())
        assert held == cfg.param_count()
    experts = 3 * cfg.d_model * cfg.d_ff * len(cfg.held)
    assert cfg.param_count() - cfg.param_count(active_only=True) == \
        cfg.num_layers * (experts - experts * cfg.top_k // cfg.num_experts)


def test_weight_names_are_the_references():
    cfg = _cfg()
    w = _weights(_model(cfg))
    shapes = ref.weight_shapes(_spec(cfg))
    assert {k: tuple(t.shape) for k, t in w.items()} == shapes


# -- the model against the reference ------------------------------------------
@pytest.mark.parametrize("rank", [0, 3])
def test_forward_loss_and_gradients_match_reference(rank):
    cfg = _cfg(expert_rank=rank, embedding_multiplier=12.0,
               residual_multiplier=0.22, logits_scaling=16.0)
    model = _model(cfg)
    w, spec, ids = _weights(model), _spec(cfg), _ids(cfg)
    with torch.no_grad():
        got = model(ids)[0]
        want = ref.logits(spec, w, ids)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    model.requires_grad_(True)
    loss = model.loss({"tokens": ids, "labels": ids})
    loss.backward()
    ref_loss, ref_grads = ref.loss_and_grads(spec, w, ids, list(w))
    assert abs(loss.item() - ref_loss) <= 1e-6 * abs(ref_loss)
    for name, p in model.named_parameters():
        want = ref_grads[name]
        assert (p.grad - want).norm() <= GRAD_TOL * want.norm(), name


def test_reference_init_weights_load_into_the_model():
    """The benchmark draws weights with the reference's ``init_weights``
    and hands them to the program (``apps/granite_hybrid.py`` ``nest``):
    the same loss both ways."""
    from portbench.apps.granite_hybrid import nest
    cfg = _cfg()
    spec = _spec(cfg)
    w = ref.init_weights(spec, torch.Generator().manual_seed(4))
    model = build_model(cfg).load(*nest(w))
    ids = _ids(cfg)
    with torch.no_grad():
        got = model.loss({"tokens": ids, "labels": ids})
    assert abs(got.item() - ref.loss(spec, w, ids).item()) <= 1e-5


def test_remat_is_bitwise():
    cfg = _cfg()
    ids = _ids(cfg)
    out = []
    for remat in (False, True):
        model = _model(dataclasses.replace(cfg, remat=remat)).requires_grad_()
        loss = model.loss({"tokens": ids, "labels": ids})
        loss.backward()
        out.append((loss.detach(), [p.grad for p in model.parameters()]))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_train_loop_trains_it():
    cfg = _cfg()
    loop = TrainLoop(cfg, global_batch=2, seq_len=32, device="cpu", seed=3)
    _, state, metrics = loop.run(3)
    assert len(metrics.losses) == 3
    assert all(math.isfinite(v) for v in metrics.losses)
    assert isinstance(loop.model, GraniteHybridLM)
    assert state["opt"]["step"] == 3


# -- the expert shares ---------------------------------------------------------
@pytest.mark.parametrize("kind", ["mamba", "attention"])
def test_expert_shares_add_up_to_the_uncut_layer(kind):
    """Four cards hold two of eight experts each: the parts of a layer that
    the four shares give, with what every card computes alike (the
    residual, the shared expert) counted once, add up to the uncut
    reference's layer."""
    uncut = _cfg(experts_held=0, layer_types=(kind,) * 4)
    model = _model(uncut)
    w = _weights(model)
    x = torch.randn(2, 16, uncut.d_model,
                    generator=torch.Generator().manual_seed(5))
    lp = model.layers[0]
    h = model._layer(lp, x, kind, 0, torch.arange(16),
                     L.causal_mask(16, 16))
    # the uncut reference's layer
    want = ref.layer(_spec(uncut), w, 0, x)
    assert (h - want).abs().max() <= 1e-5 * want.abs().max()
    # four shares of two experts, each with its slice of the experts
    parts = []
    for rank in range(4):
        share = dataclasses.replace(uncut, experts_held=2, expert_rank=rank)
        m = GraniteHybridLM(share)
        sl = copy.deepcopy(lp)
        for k in ("wg", "wi", "wo"):
            setattr(sl["moe"], k, torch.nn.Parameter(
                lp["moe"][k][2 * rank:2 * rank + 2].clone(),
                requires_grad=False))
        parts.append(m._layer(sl, x, kind, 0, torch.arange(16),
                              L.causal_mask(16, 16)))
    # what every share computes alike: the layer with no expert's part
    hmid = x + uncut.residual_multiplier * (
        model.mamba.mixer(lp["mamba"], x)[0] if kind == "mamba" else
        L.attention(lp["attn"], uncut, L.rms_norm(lp["ln1"], x),
                    torch.arange(16), L.causal_mask(16, 16), causal=True,
                    use_kernel=True, scale=uncut.attention_multiplier)[0])
    u = L.rms_norm(lp["ln2"], hmid)
    common = hmid + uncut.residual_multiplier * L.mlp(lp["shared"], uncut, u)
    total = sum(p - common for p in parts) + common
    assert (total - want).abs().max() <= 1e-5 * want.abs().max()


# -- the dropless MoE ----------------------------------------------------------
def _loop_moe(p, x, top_k, held):
    """Token by token, expert by expert, in float64."""
    N, D = x.reshape(-1, x.shape[-1]).shape
    xs = x.reshape(N, D).double()
    out = torch.zeros(N, D, dtype=torch.float64)
    counts = {e: 0 for e in held}
    for t in range(N):
        logits = xs[t] @ p["router"]["w"].double()
        top, idx = torch.topk(logits, top_k)
        gates = torch.softmax(top, -1)
        for g, e in zip(gates, idx.tolist()):
            if e in held:
                j = e - held.start
                h = F.silu(xs[t] @ p["wg"][j].double()) * (
                    xs[t] @ p["wi"][j].double())
                out[t] += g * (h @ p["wo"][j].double())
                counts[e] += 1
    return out.reshape(x.shape), counts


@pytest.mark.parametrize("held", [range(0, 3), range(5, 8), range(0, 8)])
def test_dropless_moe_matches_a_per_expert_loop(held):
    g = torch.Generator().manual_seed(6)
    E, D, Fw, K = 8, 16, 12, 3
    p = {"router": {"w": torch.randn(D, E, generator=g)},
         "wg": torch.randn(len(held), D, Fw, generator=g) / 4,
         "wi": torch.randn(len(held), D, Fw, generator=g) / 4,
         "wo": torch.randn(len(held), Fw, D, generator=g) / 4}
    x = torch.randn(2, 20, D, generator=g)
    before = (dict(L.moe_dropless.assigned), L.moe_dropless.absent,
              L.moe_dropless.dropped)
    got = L.moe_dropless(p, x, top_k=K, held=held, layer="test")
    want, counts = _loop_moe(p, x, K, held)
    assert (got.double() - want).abs().max() <= 1e-5 * want.abs().max()
    assigned = {e: L.moe_dropless.assigned.get(("test", e), 0)
                - before[0].get(("test", e), 0) for e in held}
    assert assigned == counts
    assert L.moe_dropless.absent - before[1] == 40 * K - sum(counts.values())
    assert L.moe_dropless.dropped == before[2]


def test_dropless_moe_gradients_match_the_loop():
    g = torch.Generator().manual_seed(7)
    # rows of 16 bytes' multiples, as the grouped product takes them
    E, D, Fw, K = 6, 8, 16, 2
    p = {"router": {"w": torch.randn(D, E, generator=g)},
         "wg": torch.randn(2, D, Fw, generator=g),
         "wi": torch.randn(2, D, Fw, generator=g),
         "wo": torch.randn(2, Fw, D, generator=g)}
    x = torch.randn(1, 12, D, generator=g)
    leaves = [p["router"]["w"], p["wg"], p["wi"], p["wo"], x]
    for t in leaves:
        t.requires_grad_(True)
    dy = torch.randn(1, 12, D, generator=g)
    got = torch.autograd.grad(
        (L.moe_dropless(p, x, top_k=K, held=range(2, 4)) * dy).sum(), leaves)
    want = torch.autograd.grad(
        (_loop_moe(p, x, K, range(2, 4))[0] * dy.double()).sum(), leaves)
    for a, b in zip(got, want):
        assert (a.double() - b).abs().max() <= 1e-5 * (1 + b.abs().max())


def test_tokens_routed_elsewhere_get_nothing_here():
    g = torch.Generator().manual_seed(8)
    D = 8
    w = torch.zeros(D, 4)
    w[0, 3] = 10.0                    # positive first channel: expert 3
    p = {"router": {"w": w}, "wg": torch.randn(1, D, 4, generator=g),
         "wi": torch.randn(1, D, 4, generator=g),
         "wo": torch.randn(1, 4, D, generator=g)}
    x = torch.randn(1, 10, D, generator=g)
    x[..., 0] = 1.0
    out = L.moe_dropless(p, x, top_k=1, held=range(0, 1))
    assert torch.equal(out, torch.zeros_like(out))


# -- the capacity path is the parent's, bit for bit ---------------------------
def _parent_moe(p, cfg, x, *, group_size: int = 512):
    """``layers.moe`` as it stood before the dropless path was added."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    tokens = x.reshape(-1, D)
    N = tokens.shape[0]
    Gs = min(group_size, N)
    G = N // Gs
    C = max(1, int(math.ceil(K * Gs / E * cfg.capacity_factor)))
    xg = tokens.reshape(G, Gs, D)
    logits = xg.float() @ p["router"]["w"]
    probs = torch.softmax(logits, dim=-1)
    top1 = torch.argmax(probs, dim=-1)
    frac_tokens = torch.mean(F.one_hot(top1, E).float(), dim=1)
    frac_probs = torch.mean(probs, dim=1)
    aux = E * torch.mean(torch.sum(frac_tokens * frac_probs, dim=-1))
    combine = torch.zeros((G, Gs, E, C), dtype=torch.float32, device=x.device)
    remaining = probs
    fill = torch.zeros((G, E), dtype=torch.int32, device=x.device)
    for _ in range(K):
        idx = torch.argmax(remaining, dim=-1)
        gate = torch.gather(remaining, -1, idx[..., None])[..., 0]
        onehot = F.one_hot(idx, E).float()
        pos = torch.cumsum(onehot, dim=1) - onehot
        pos = pos + fill[:, None, :]
        in_cap = pos < C
        slot = torch.sum(onehot * pos, dim=-1).to(torch.int32)
        keep = torch.sum(onehot * in_cap, dim=-1) > 0
        cslot = F.one_hot(torch.clamp(slot, 0, C - 1).long(), C).float()
        combine = combine + (gate * keep)[..., None, None] * \
            onehot[..., None] * cslot[:, :, None, :]
        fill = fill + torch.sum(onehot * in_cap, dim=1).to(torch.int32)
        remaining = remaining * (1.0 - onehot)
    denom = torch.sum(combine, dim=(2, 3), keepdim=True) + 1e-9
    combine = combine / denom
    wg, wi, wo = (p[k].to(x.dtype) for k in ("wg", "wi", "wo"))
    dispatch = (combine > 0).to(xg.dtype)
    xin = torch.einsum("gsec,gsd->egcd", dispatch, xg)
    h = F.silu(torch.einsum("egcd,edf->egcf", xin, wg))
    h = h * torch.einsum("egcd,edf->egcf", xin, wi)
    out_e = torch.einsum("egcf,efd->egcd", h, wo)
    out = torch.einsum("gsec,egcd->gsd", combine.to(xg.dtype), out_e)
    return out.reshape(B, S, D), aux


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_capacity_moe_is_the_parents_bitwise(dtype):
    """granite-moe-1b-a400m's layer, output, aux and gradients."""
    cfg = get_config("granite-moe-1b-a400m", reduced=True)
    p = L.init_moe(cfg, torch.Generator().manual_seed(9))
    x = torch.randn(2, 64, cfg.d_model,
                    generator=torch.Generator().manual_seed(10)).to(dtype)
    outs = []
    for fn in (L.moe, _parent_moe):
        q = {"router": {"w": p["router"]["w"].clone().requires_grad_()},
             **{k: p[k].clone().requires_grad_() for k in ("wg", "wi", "wo")}}
        xx = x.clone().requires_grad_()
        y, aux = fn(q, cfg, xx, group_size=32)
        grads = torch.autograd.grad((y.float() ** 2).sum() + aux,
                                    [xx, q["router"]["w"], q["wg"],
                                     q["wi"], q["wo"]])
        outs.append((y, aux, grads))
    (y0, a0, g0), (y1, a1, g1) = outs
    assert torch.equal(y0, y1) and torch.equal(a0, a1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


# -- B3's scale ------------------------------------------------------------------
@pytest.mark.parametrize("scale", [None, 1 / 128, 0.3])
@pytest.mark.parametrize("causal", [True, False])
def test_b3_scale_matches_sdpa(scale, causal):
    """The plain forward, its ``lse`` and the plain backward against
    ``scaled_dot_product_attention(scale=...)`` (f32: 1e-5)."""
    g = torch.Generator().manual_seed(11)
    B, S, K, G, hd = 1, 40, 2, 3, 16
    q = torch.randn(B, S, K, G, hd, generator=g, requires_grad=True)
    k = torch.randn(B, S, K, hd, generator=g, requires_grad=True)
    v = torch.randn(B, S, K, hd, generator=g, requires_grad=True)
    out, lse = flash_attention(q, k, v, causal=causal, scale=scale,
                               return_lse=True)
    qh = q.reshape(B, S, K * G, hd).transpose(1, 2)
    kh = k.repeat_interleave(G, dim=2).transpose(1, 2)
    vh = v.repeat_interleave(G, dim=2).transpose(1, 2)
    want = F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal,
                                          scale=scale)
    want = want.transpose(1, 2).reshape(B, S, K, G, hd)
    assert (out - want).abs().max() <= 1e-5
    s = scale if scale is not None else hd ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * s
    if causal:
        logits = logits.masked_fill(
            torch.ones(S, S, dtype=torch.bool).triu(1), -math.inf)
    want_lse = torch.logsumexp(logits, -1).reshape(B, K, G, S)
    assert (lse - want_lse).abs().max() <= 1e-5
    dy = torch.randn(out.shape, generator=g)
    got = torch.autograd.grad((out * dy).sum(), (q, k, v))
    ref_g = torch.autograd.grad((want * dy).sum(), (q, k, v))
    for a, b in zip(got, ref_g):
        assert (a - b).abs().max() <= 1e-5 * (1 + b.abs().max())


def test_b3_default_scale_unchanged():
    """No ``scale`` is ``1/sqrt(hd)``, bit for bit, forward and backward."""
    g = torch.Generator().manual_seed(12)
    q = torch.randn(1, 30, 2, 2, 16, generator=g)
    k = torch.randn(1, 30, 2, 16, generator=g)
    v = torch.randn(1, 30, 2, 16, generator=g)
    a, la = flash_attention_plain(q, k, v, return_lse=True)
    b, lb = flash_attention_plain(q, k, v, return_lse=True, scale=0.25)
    assert torch.equal(a, b) and torch.equal(la, lb)
    dout = torch.randn(a.shape, generator=g)
    assert all(torch.equal(x, y) for x, y in zip(
        flash_attention_backward(q, k, v, a, la, dout),
        flash_attention_backward(q, k, v, a, la, dout, scale=0.25)))
