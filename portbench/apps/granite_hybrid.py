"""Granite-4.0-H-Small's share of one card (``repro_torch.models.
GraniteHybridLM``), trained by ``repro_torch.runtime.TrainLoop``, as a
benchmark program.

The configuration file holds the model's ``config.json`` keys as run (the
cut in ``reduced``); :func:`arch_config` makes the program's config of them.
Weights are drawn from the seed by the reference's ``init_weights`` and
handed to the program (``TrainLoop``'s ``init``); tokens are the program's
``SyntheticLMData`` draw from the seed, which the check draws again.

What is compared (``check``), the program computing in bfloat16 with
float32 weights, the reference in float32 (TF32 off):

- ``start_grad_gap``: at step 1, over a fixed set of tensors (one held
  expert's ``W2``, the router, the first Mamba2 layer's ``in_proj`` and
  ``A_log``, the attention layer's ``q`` and ``k`` projections, the
  embedding slice), the largest norm of the gap over the norm of the
  reference's gradient, the reference's from the seed's weights on the
  same batch;
- ``update_gap``: step 1's change of each tensor of that set against the
  reference's AdamW step (the traffic's ``adamw``, ``lr``) from the seed's
  weights and the gradients the program's backward made, clipped by the
  global norm the step logged; the largest norm of the gap over the norm
  of the reference's change.  An update left out reads 1.  (From the
  reference's gradients it would read their signs: AdamW's first step is
  ``g / (|g| + eps)`` an element, so every element whose gradient is
  within bfloat16's gap of zero moves the wrong way by a full ``lr``.)
- ``dropped_assignments``: assignments to held experts that the program's
  MoE left uncomputed, over set-up and window (its counter); limit 0.

The loss is not compared: at step 1 it sits at ln(vocabulary) whatever the
weights, and after some steps float8 products move it by less than three
times the program's own gap (readings in PERF.md).

With ``control`` the reference computed otherwise stands in the
program's place: ``fp8_products`` (every product's inputs rounded to float8
e4m3) or ``dropped_tokens`` (GShard routing at capacity factor 1.0 in
groups of 512).  A control reads ``start_grad_gap`` alone: it makes no
update and has no counter.
"""

from __future__ import annotations

import torch

from portbench.reference import granite_hybrid as ref
from portbench.reference import no_tf32

CHECKS = ("start_grad_gap", "update_gap", "dropped_assignments")


def arch_config(cfg: dict):
    """The program's ``HybridMoEConfig`` of the configuration file."""
    from repro_torch.models import HybridMoEConfig
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    if cfg["mamba_expand"] * d != cfg["mamba_n_heads"] * cfg["mamba_d_head"]:
        raise ValueError("mamba_expand * hidden_size must equal "
                         "mamba_n_heads * mamba_d_head")
    if cfg["mamba_n_groups"] != 1 or cfg["mamba_d_conv"] != 4:
        raise ValueError("the program's Mamba2 takes one group, conv width 4")
    return HybridMoEConfig(
        name=cfg["name"], family="hybrid_moe",
        num_layers=cfg["num_hidden_layers"], d_model=d, num_heads=H,
        num_kv_heads=cfg["num_key_value_heads"], d_ff=cfg["intermediate_size"],
        vocab_size=cfg["vocab_size"], num_experts=cfg["router_experts"],
        top_k=cfg["num_experts_per_tok"],
        experts_held=cfg["num_local_experts"], expert_rank=cfg["expert_rank"],
        shared_ff=cfg["shared_intermediate_size"],
        ssm_state=cfg["mamba_d_state"], ssm_heads=cfg["mamba_n_heads"],
        ssm_expand=cfg["mamba_expand"], ssm_chunk=cfg["b4_chunk"],
        rope_theta=(0.0 if cfg["position_embedding_type"] == "nope"
                    else float(cfg["rope_theta"])),
        tie_embeddings=cfg["tie_word_embeddings"],
        norm_eps=cfg["rms_norm_eps"], mlp="swiglu", flash_attention=True,
        remat=True, layer_types=tuple(cfg["layer_types"]),
        attention_multiplier=cfg["attention_multiplier"],
        embedding_multiplier=float(cfg["embedding_multiplier"]),
        residual_multiplier=cfg["residual_multiplier"],
        logits_scaling=float(cfg["logits_scaling"]),
        param_dtype=cfg["param_dtype"], dtype=cfg["dtype"])


def nest(flat: dict) -> tuple[dict, list]:
    """Flat ``named_parameters`` names as ``TreeLM.load``'s arguments."""
    params: dict = {}
    layers: dict = {}
    for name, t in flat.items():
        top, *path = name.split(".")
        if top == "layers":
            node = layers.setdefault(int(path[0]), {})
            path = path[1:]
        else:
            node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    return params, [layers[i] for i in sorted(layers)]


def gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """``|a - b| / |b|`` in Frobenius norms, in float64."""
    b = b.double()
    return float((a.to(b.device).double() - b).norm() / b.norm())


class App:
    CONTROLS = ("fp8_products", "dropped_tokens")

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.cfg, self.seed = config, seed
        self.device = torch.device(device)
        self.spec = ref.Spec.from_config(config)
        self.arch = arch_config(config)
        self.batch, self.seq_len = int(traffic["batch"]), int(traffic["seq_len"])
        self.lr, self.adamw = float(traffic["lr"]), traffic["adamw"]
        kinds = list(self.spec.layer_types)
        m, a = kinds.index("mamba"), kinds.index("attention")
        # label -> (weight name, index into it or None)
        self.grad_set = {
            f"layers.{m}.moe.wo[0]": (f"layers.{m}.moe.wo", 0),
            f"layers.{m}.moe.router.w": (f"layers.{m}.moe.router.w", None),
            f"layers.{m}.mamba.in_proj.w": (f"layers.{m}.mamba.in_proj.w",
                                            None),
            f"layers.{m}.mamba.A_log": (f"layers.{m}.mamba.A_log", None),
            f"layers.{a}.attn.wq.w": (f"layers.{a}.attn.wq.w", None),
            f"layers.{a}.attn.wk.w": (f"layers.{a}.attn.wk.w", None),
            "params.embed.e": ("params.embed.e", None),
        }
        self._reference: dict = {}

    # -- the program's inputs ---------------------------------------------------
    def weights(self) -> dict:
        """The seed's weights, drawn on the device."""
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        return ref.init_weights(self.spec, gen)

    def build(self):
        """A model of the program holding the seed's weights."""
        from repro_torch.models import build_model
        return build_model(self.arch).load(*nest(self.weights()))

    def tokens(self, step: int) -> torch.Tensor:
        """Step ``step``'s batch, as the program's data draws it."""
        from repro_torch.data import SyntheticLMData
        data = SyntheticLMData(self.arch, self.batch, self.seq_len,
                               seed=self.seed)
        return torch.from_numpy(data.local_batch(step)["tokens"]).to(
            self.device, torch.long)

    def capture_grads(self, model) -> tuple[dict, list]:
        """Hooks that copy the gradient set's gradients of ``model``'s next
        backward; ``(copies by label, hook handles)``."""
        params = dict(model.named_parameters())
        out: dict = {}
        handles = []
        for label, (name, index) in self.grad_set.items():
            def keep(p, label=label, index=index):
                g = p.grad.detach()
                out[label] = (g if index is None else g[index]).clone()
            handles.append(params[name].register_post_accumulate_grad_hook(
                keep))
        return out, handles

    def leaves(self, weights: dict) -> dict:
        """The gradient set's tensors of ``weights`` (a name -> tensor
        dict), by label."""
        return {label: (weights[n] if i is None else weights[n][i])
                for label, (n, i) in self.grad_set.items()}

    # -- the reference ------------------------------------------------------------
    def _start(self, prod, route) -> tuple[dict, dict]:
        """The reference's gradient set at step 1, and the seed's weights
        of that set."""
        names = sorted({n for n, _ in self.grad_set.values()})
        w = self.weights()
        _, grads = ref.loss_and_grads(self.spec, w, self.tokens(0), names,
                                      prod, route)
        start = {label: t.detach().clone()
                 for label, t in self.leaves(w).items()}
        del w
        return self.leaves(grads), start

    def _computed(self, key, fn):
        if key not in self._reference:
            self._reference[key] = fn()
        return self._reference[key]

    def update_gap(self, start: dict, seed_leaves: dict) -> float:
        """Step 1's change of the gradient set against the reference's
        AdamW step from the seed's weights and the program's gradients."""
        opt = self.adamw
        clip = min(1.0, opt["grad_clip"] / (start["grad_norm"] + 1e-9))
        worst = 0.0
        for label, w0 in seed_leaves.items():
            g = start["grads"].get(label)
            g = torch.zeros_like(w0) if g is None else g.to(w0.device)
            want = ref.adamw_first_step(
                w0, g, lr=self.lr, b1=opt["b1"], b2=opt["b2"],
                eps=opt["eps"], weight_decay=opt["weight_decay"],
                clip_scale=clip)
            moved = start["updated"][label].to(w0.device).double() - \
                w0.double()
            worst = max(worst, gap(moved, want))
        return worst

    def check(self, start: dict, before, final: dict, steps: int,
              control: str | None = None) -> dict:
        """The compared numbers of a run; with ``control`` (one of
        ``CONTROLS``) that control's numbers from the same states.  The
        reference's are computed once per App; ``before`` is not read."""
        if control is not None and control not in self.CONTROLS:
            raise ValueError(f"no control {control!r}")
        stand_in = {"fp8_products": (ref.Products(fp8=True), "dropless"),
                    "dropped_tokens": (ref.EXACT, "capacity")}
        with no_tf32():
            ref_grads, seed_leaves = self._computed(
                "start", lambda: self._start(ref.EXACT, "dropless"))
            grads = (start["grads"] if control is None
                     else self._start(*stand_in[control])[0])
            # a weight the program gave no gradient reads as a zero gradient
            out = {"start_grad_gap": max(
                gap(grads.get(k, torch.zeros_like(g)), g)
                for k, g in ref_grads.items())}
            if control is None:
                out["update_gap"] = self.update_gap(start, seed_leaves)
                out["dropped_assignments"] = float(final["dropped"])
        return out
