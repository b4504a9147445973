"""The decoder LM of every assigned family (dense, MoE, RWKV6, hybrid
attention + mamba, audio over codebooks, vision-language), port of
`repro.models.transformer`.

`LM` is an `nn.Module` that holds the config and the layer plan; the
weights stay a flat dict[str, Tensor] under the JAX keys (stacked (L, K, N)
block tensors, `<name>.codes` / `<name>.packed{bits}` / `<name>.scale`
after compression), passed to every call, so weights cross between the
two packages 1:1.

PyTorch runs eagerly, so the layer stack is a Python loop over per-layer
views of the stacked tensors (one `torch.unbind` per stacked tensor, so
the backward stacks each tensor's layer gradients in one node), and
`prefill` / `decode_step` write the KV cache (the contiguous arena, or the
paged pools) IN PLACE and return the same dict.

The layer pattern repeats with a period (`layer_plan`: MoE every
`moe.every` layers); params stack over n_blocks = n_layers / period per
position-in-period, and each layer of the loop runs the period's
sublayers in turn: a mixer (attention, mamba or rwkv6 time-mix), then an
FFN (MLP, MoE, rwkv6 channel-mix, or none).

The recurrent mixers keep their decode state in the cache dict beside the
K/V leaves (`init_cache`: `<pre>.h` / `<pre>.conv` for mamba,
`<pre>.tm_shift` / `<pre>.wkv` / `<pre>.cm_shift` for rwkv6), one row per
slot, constant in length. `prefill` runs each mixer from zero state and
writes the state S sequential decode steps would leave; `decode_step`
reads and advances it. Both write the states IN PLACE (`copy_`), so a
CUDA graph captured over the arena replays against the same addresses.

Weight quantizers split as in JAX: sites on routed 2-D block projections
(attention, MLP, the MoE's shared expert) fuse into the GEMM's fake-quant
epilogue; the rest (the MoE router and expert stacks, the head) are
fake-quanted once per call in `_prequantize`. An MoE routes at capacity
in the training forward and in one-token decode, and at full capacity in
prefill and `verify_chunk`, as the reference does. `loss` is the training
objective; with `cfg.remat` each layer of the training forward runs under
`torch.utils.checkpoint` (non-reentrant), so the backward recomputes the
layer instead of keeping its activations, with the same numbers.
`build_graph` describes the model to QADG (`core.qadg`).

The audio family (musicgen) reads frames of `num_codebooks` tokens: the
embedding is (C, Vp, D), a frame's input the sum of its C codebook rows,
and the untied head (D, C * Vp) gives (..., C, Vp) logits, one
distribution per codebook. The vision-language family (internvl2)
prepends `vision_embeds` (B, P, D), the stub frontend's patch embeddings,
to the text in `forward` and `prefill`; the loss skips the P patch
positions. A sliding window (`cfg.window > 0`) masks attention to the
last `window` keys and shrinks the decode arena to a ring of
min(max_seq, window) rows (`layers.attn_apply`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.graph import FamilySpec, GraphBuilder
from repro_torch.core.quant import (KV_STORAGE_BITS, QuantParams, fake_quant,
                                    init_quant_params)
from repro_torch.models import layers as Lyr


@dataclasses.dataclass(frozen=True)
class SubLayer:
    j: int
    mixer: str     # attn | mamba | rwkv
    ffn: str       # mlp | moe | chanmix | none


def recurrent_mixers(plan: list[SubLayer]) -> list[str]:
    """The recurrent mixers (mamba, rwkv) of a layer plan, sorted."""
    return sorted({s.mixer for s in plan if s.mixer != "attn"})


def layer_plan(cfg: ModelConfig) -> tuple[list[SubLayer], int]:
    """(per-period sublayer specs, n_blocks): the period is the lcm of
    the hybrid interleave and `moe.every`; position j takes the MoE when
    j % every == every - 1."""
    if cfg.family == "ssm_rwkv":
        return [SubLayer(0, "rwkv", "chanmix")], cfg.n_layers
    period = 1
    if cfg.family == "hybrid":
        period = cfg.attn_every
    if cfg.moe is not None:
        period = period * cfg.moe.every // math.gcd(period, cfg.moe.every)
    if cfg.n_layers % period:
        raise ValueError(f"{cfg.name}: n_layers={cfg.n_layers} is not a "
                         f"multiple of the layer period {period}")
    plan = []
    for j in range(period):
        mixer = ("mamba" if cfg.family == "hybrid" and j % cfg.attn_every
                 else "attn")
        ffn = ("moe" if cfg.moe is not None
               and j % cfg.moe.every == cfg.moe.every - 1 else "mlp")
        plan.append(SubLayer(j, mixer, ffn))
    return plan, cfg.n_layers // period


# Which params receive weight-quant sites (per sublayer component).
_QUANT_WEIGHTS = {
    "attn": ["wq", "wk", "wv", "wo"],
    "mlp": ["w_gate", "w_up", "w_down"],
    "moe": ["router", "we_gate", "we_up", "we_down"],
    "mamba": ["in_proj_x", "in_proj_z", "x_proj", "dt_proj", "out_proj"],
    "rwkv": ["wr", "wk", "wv", "wg", "wo", "decay_w1", "decay_w2"],
    "chanmix": ["cm_k", "cm_v", "cm_r"],
}
# Logical axes of each component's params, after the stacked "layers"
# axis (the reference's init axes dicts); the sharding rules map them to
# mesh axes (`distributed.sharding`).
_MLP_AXES = {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
             "w_down": ("mlp", "embed")}
_PARAM_AXES = {
    "attn": {"wq": ("embed", "q_heads"), "wk": ("embed", "kv_heads"),
             "wv": ("embed", "kv_heads"), "wo": ("q_heads", "embed")},
    "attn_bias": {"bq": ("q_heads",), "bk": ("kv_heads",),
                  "bv": ("kv_heads",)},
    "mlp": _MLP_AXES,
    "moe": {"router": ("embed", "experts_router"),
            "we_gate": ("experts", "embed", "expert_mlp"),
            "we_up": ("experts", "embed", "expert_mlp"),
            "we_down": ("experts", "expert_mlp", "embed")},
    "mamba": {"in_proj_x": ("embed", "mamba_inner"),
              "in_proj_z": ("embed", "mamba_inner"),
              "conv_w": ("conv_k", "mamba_inner"),
              "x_proj": ("mamba_inner", "mamba_lowrank"),
              "dt_proj": ("mamba_lowrank_dt", "mamba_inner"),
              "dt_bias": ("mamba_inner",),
              "A_log": ("mamba_inner", "mamba_state"),
              "D": ("mamba_inner",), "out_proj": ("mamba_inner", "embed")},
    "rwkv": {"mu": ("mix5", "embed"), "wr": ("embed", "rwkv_heads"),
             "wk": ("embed", "rwkv_heads"), "wv": ("embed", "rwkv_heads"),
             "wg": ("embed", "rwkv_heads"), "wo": ("rwkv_heads", "embed"),
             "decay_w1": ("embed", "lora"), "decay_w2": ("lora", "rwkv_heads"),
             "decay_w0": ("rwkv_heads",), "u": ("rwkv_heads",),
             "lnx_scale": ("rwkv_heads",), "lnx_bias": ("rwkv_heads",),
             "cm_mu": ("mix2", "embed"), "cm_k": ("embed", "rwkv_ffn"),
             "cm_v": ("rwkv_ffn", "embed"), "cm_r": ("embed", "rwkv_heads")},
}
# Activation-quant sites (per sublayer component).
_ACT_SITES = {"attn": ["attn_out"], "mlp": ["mlp_act"], "moe": [],
              "mamba": ["mamba_out"], "rwkv": ["tm_out"],
              "chanmix": ["cm_act"]}


class LM(torch.nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.plan, self.n_blocks = layer_plan(cfg)
        # the physical dims of each position-in-period, which prefill,
        # decode and the KV arenas read instead of the config's: a pruned
        # subnet's after `apply_slim_plan`
        self.shapes = [Lyr.LayerShapes.from_config(cfg) for _ in self.plan]
        self.slim_plan = None
        # a `distributed.sharding.TensorParallel` when a rank of a
        # tensor-parallel engine serves this LM on its shards
        self.tp = None
        self._freqs: dict[torch.device, torch.Tensor] = {}

    def apply_slim_plan(self, plan) -> None:
        """Run at a `core.subnet.SlimPlan`'s widths: the forward, prefill
        and decode then take sliced params (`PruningSpace.materialize`
        output) and `init_cache` / `init_paged_cache` allocate the KV of
        the surviving KV heads only."""
        if len(plan.layer_shapes) != len(self.plan):
            raise ValueError(
                f"slim plan has {len(plan.layer_shapes)} sublayer shapes, "
                f"model period has {len(self.plan)}")
        self.shapes = list(plan.layer_shapes)
        self.slim_plan = plan

    # ------------------------------------------------------------- params
    def init(self, gen: torch.Generator) -> dict:
        """Random params on `gen.device` from the torch RNG (not held to
        the JAX package's `jax.random` numbers)."""
        cfg = self.cfg
        dt = Lyr.dtype_of(cfg)
        dev = gen.device
        D, Vp, C = cfg.d_model, cfg.vocab_padded, cfg.num_codebooks
        # codebooks: C embeddings and an untied head over C vocabularies
        params = {"embed": Lyr._normal(gen, (C, Vp, D) if C else (Vp, D),
                                       dt, 0.02)}
        if not self._tied:
            params["head"] = Lyr._normal(gen, (D, max(C, 1) * Vp), dt,
                                         D ** -0.5)
        params["final_norm"] = torch.ones((D,), dtype=torch.float32,
                                          device=dev)
        init_mixer = {"attn": Lyr.init_attention, "mamba": Lyr.init_mamba,
                      "rwkv": Lyr.init_rwkv}
        for sub in self.plan:
            pre = f"blocks.{sub.j}"
            norms = ("norm1",) if sub.ffn == "none" else ("norm1", "norm2")
            for norm in norms:
                params[f"{pre}.{norm}"] = torch.ones(
                    (self.n_blocks, D), dtype=torch.float32, device=dev)
            params.update(init_mixer[sub.mixer](
                gen, cfg, f"{pre}.{sub.mixer}", self.n_blocks, dt))
            if sub.ffn in ("mlp", "moe"):
                init_ffn = Lyr.init_moe if sub.ffn == "moe" else Lyr.init_mlp
                params.update(init_ffn(gen, cfg, f"{pre}.{sub.ffn}",
                                       self.n_blocks, dt))
        return params

    def param_axes(self) -> dict[str, tuple]:
        """The logical axes of every param `init` makes, by name: the
        reference's `lm.init(key)[1]`, which the sharding rules read."""
        cfg = self.cfg
        if cfg.num_codebooks:
            axes = {"embed": ("codebooks", "vocab", "embed"),
                    "head": ("embed", "vocab_out")}
        else:
            axes = {"embed": ("vocab", "embed")}
            if not cfg.tie_embeddings:
                axes["head"] = ("embed", "vocab_out")
        axes["final_norm"] = ("embed",)
        stacked = lambda pre, table: {f"{pre}.{k}": ("layers",) + a
                                      for k, a in table.items()}
        for sub in self.plan:
            pre = f"blocks.{sub.j}"
            axes[f"{pre}.norm1"] = ("layers", "embed")
            if sub.ffn != "none":
                axes[f"{pre}.norm2"] = ("layers", "embed")
            axes.update(stacked(f"{pre}.{sub.mixer}", _PARAM_AXES[sub.mixer]))
            if sub.mixer == "attn" and cfg.qkv_bias:
                axes.update(stacked(f"{pre}.attn", _PARAM_AXES["attn_bias"]))
            if sub.ffn in ("mlp", "moe"):
                axes.update(stacked(f"{pre}.{sub.ffn}", _PARAM_AXES[sub.ffn]))
            if sub.ffn == "moe" and cfg.moe.shared_expert:
                axes.update(stacked(f"{pre}.moe.shared", _MLP_AXES))
        return axes

    # --------------------------------------------------------- quantization
    @staticmethod
    def _ffn_prefix(sub: SubLayer) -> str:
        """The param prefix of a sublayer's FFN: the channel-mix's params
        live under its time-mix's `rwkv` prefix, as in the reference."""
        return "rwkv" if sub.ffn == "chanmix" else sub.ffn

    def quant_weight_names(self) -> list[str]:
        names = []
        for sub in self.plan:
            pre = f"blocks.{sub.j}"
            names += [f"{pre}.{sub.mixer}.{w}"
                      for w in _QUANT_WEIGHTS[sub.mixer]]
            if sub.ffn != "none":
                names += [f"{pre}.{self._ffn_prefix(sub)}.{w}"
                          for w in _QUANT_WEIGHTS[sub.ffn]]
            if sub.ffn == "moe" and self.cfg.moe.shared_expert:
                names += [f"{pre}.moe.shared.{w}"
                          for w in _QUANT_WEIGHTS["mlp"]]
        names.append("embed" if self._tied else "head")
        return names

    @property
    def _tied(self) -> bool:
        """The head is the embedding's transpose (never with codebooks)."""
        return self.cfg.tie_embeddings and not self.cfg.num_codebooks

    def act_site_names(self) -> list[str]:
        names = []
        for sub in self.plan:
            pre = f"blocks.{sub.j}"
            names += [f"{pre}.{sub.mixer}.{s}.aq"
                      for s in _ACT_SITES[sub.mixer]]
            if sub.ffn != "none":
                names += [f"{pre}.{self._ffn_prefix(sub)}.{s}.aq"
                          for s in _ACT_SITES[sub.ffn]]
        return names

    def check_prompt_length(self, S: int) -> None:
        """Raise ValueError if the recurrent prefill cannot take an S-token
        prompt: a scan over more than one chunk needs a multiple of it
        (`layers.scan_chunk`, the reference's rule)."""
        cfg = self.cfg
        for mixer in recurrent_mixers(self.plan):
            chunk = cfg.rwkv.chunk if mixer == "rwkv" else cfg.mamba.chunk
            try:
                Lyr.scan_chunk(S, chunk)
            except ValueError as e:
                raise ValueError(f"{cfg.name}: the {mixer} prefill cannot "
                                 f"take this prompt: {e}") from None

    def init_qparams(self, params: dict, bits_init: float = 8.0,
                     act_quant: bool = False) -> dict[str, QuantParams]:
        """Weight sites at `bits_init` from each weight's max|w| and, with
        `act_quant`, activation sites at q_m = 4, on the params' device."""
        qp = {name + ".wq": init_quant_params(params[name], bits=bits_init)
              for name in self.quant_weight_names() if name in params}
        if act_quant:
            q_m = torch.tensor(4.0, device=params["embed"].device)
            for site in self.act_site_names():
                qp[site] = init_quant_params(q_m=q_m, bits=bits_init)
        return qp

    @staticmethod
    def _fused_qat_site(name: str, w: torch.Tensor) -> bool:
        parts = name.split(".")
        return (name.startswith("blocks.") and len(parts) >= 3
                and parts[-2] in Lyr.ROUTED_COMPONENTS and w.ndim == 3)

    def _prequantize(self, params: dict, qparams: Optional[dict]
                     ) -> tuple[dict, Optional[dict]]:
        """Split weight quantizers into sites fused into the GEMM epilogue
        (routed block projections) and weights fake-quanted here (the MoE
        router and expert stacks, the head). Returns (params, body
        qparams)."""
        if qparams is None:
            return params, None
        out = dict(params)
        body_q = {k: v for k, v in qparams.items() if k.endswith(".aq")}
        for name in self.quant_weight_names():
            site = name + ".wq"
            if name in out and site in qparams:
                if self._fused_qat_site(name, out[name]):
                    body_q[site] = qparams[site]
                    continue
                q = qparams[site]
                out[name] = fake_quant(out[name], q.d, q.q_m, q.t)
        return out, (body_q or None)

    # -------------------------------------------------------------- forward
    def _embed_tokens(self, params: dict, tokens: torch.Tensor
                      ) -> torch.Tensor:
        """tokens (B, S) -> (B, S, D); with codebooks (B, S, C) -> the sum
        of the C codebooks' rows, added in codebook order as the
        reference sums them."""
        # F.embedding's backward sums rows without atomics on the card;
        # indexing (`embed[tokens]`) would backprop through index_put_
        # with accumulation
        emb = params["embed"]
        tp = self.tp
        if tp is not None and tp.split("embed", -2):
            # a rank holds rows [lo, lo + rows) of the vocab: its rows'
            # embeddings and zeros elsewhere, summed over the ranks (one
            # term of each sum is not zero, so the sum is exact)
            rows = emb.shape[0]
            local = tokens - tp.index * rows
            inside = (local >= 0) & (local < rows)
            x = F.embedding(torch.where(inside, local, 0), emb)
            return tp.sum(x * inside[..., None].to(x.dtype))
        if not self.cfg.num_codebooks:
            return F.embedding(tokens, emb)
        x = F.embedding(tokens[..., 0], emb[0])
        for c in range(1, self.cfg.num_codebooks):
            x = x + F.embedding(tokens[..., c], emb[c])
        return x

    def _head(self, params: dict, h: torch.Tensor) -> torch.Tensor:
        """Logits (B, S, Vp), or (B, S, C, Vp) with codebooks. Under
        tensor parallelism a rank projects onto its vocab tile and the
        tiles are gathered, so every rank holds the same logits."""
        tp = self.tp
        if self._tied:
            logits = h @ params["embed"].T
            return (tp.gather(logits) if tp is not None
                    and tp.split("embed", -2) else logits)
        logits = Lyr.dense_proj(h, params, None, "head")
        if tp is not None and tp.split(tp.key(params, "head"), -1):
            logits = tp.gather(logits)
        if self.cfg.num_codebooks:
            logits = logits.reshape(*logits.shape[:2],
                                    self.cfg.num_codebooks,
                                    self.cfg.vocab_padded)
        return logits

    def _with_patches(self, x: torch.Tensor, vision_embeds) -> torch.Tensor:
        """The vlm family's patch embeddings (B, P, D) prepended to the
        text, in x's dtype."""
        if self.cfg.vision_patches and vision_embeds is not None:
            x = torch.cat([vision_embeds.to(x.dtype), x], dim=1)
        return x

    def _layer_views(self, params: dict) -> list[dict]:
        """Each layer's view of the stacked block params (no copies)."""
        views = [{} for _ in range(self.n_blocks)]
        for k, v in params.items():
            if k.startswith("blocks."):
                for i, vi in enumerate(torch.unbind(v, 0)):
                    views[i][k] = vi
        return views

    def _mixer(self, sub, shp, lp, qp_body, h, rope, caches, pos, pages,
               i, chunked, prefill):
        """The sublayer's mixer on its normed input h. With `caches`, an
        attention mixer writes its K/V rows in place; a recurrent one runs
        from zero state (`prefill`) or from the slot's state (decode) and
        copies its new state into the cache leaves in place."""
        cfg = self.cfg
        pre = f"blocks.{sub.j}"
        if sub.mixer == "attn":
            cache = None
            if caches is not None:
                cache = (caches[f"{pre}.k"][i], caches[f"{pre}.v"][i], pos)
            if pages is not None and pages.kv_bits is not None:
                cache += (caches[f"{pre}.k_scale"][i],
                          caches[f"{pre}.v_scale"][i])
            elif pages is not None:
                cache += (None, None)
            mix, _ = Lyr.attn_apply(lp, qp_body, cfg, h, rope=rope,
                                    prefix=f"{pre}.attn", cache=cache,
                                    shapes=shp, pages=pages,
                                    chunked=chunked, tp=self.tp)
            return mix
        keys = ((f"{pre}.h", f"{pre}.conv") if sub.mixer == "mamba"
                else (f"{pre}.tm_shift", f"{pre}.wkv"))
        state = None
        if caches is not None and not prefill:
            state = tuple(caches[k][i] for k in keys)
        apply = (Lyr.mamba_apply if sub.mixer == "mamba"
                 else Lyr.rwkv_timemix_apply)
        mix, new = apply(lp, qp_body, cfg, h, prefix=f"{pre}.{sub.mixer}",
                         state=state, shapes=shp, tp=self.tp)
        if caches is not None:
            for k, t in zip(keys, new):
                caches[k][i].copy_(t)
        return mix

    def _ffn(self, sub, shp, lp, qp_body, h2, caches, i, prefill,
             full_capacity):
        cfg = self.cfg
        pre = f"blocks.{sub.j}"
        if sub.ffn == "moe":
            return Lyr.moe_apply(lp, qp_body, cfg, h2, prefix=f"{pre}.moe",
                                 full_capacity=full_capacity, shapes=shp,
                                 tp=self.tp)
        if sub.ffn == "mlp":
            return Lyr.mlp_apply(lp, qp_body, cfg, h2, prefix=f"{pre}.mlp",
                                 tp=self.tp)
        key = f"{pre}.cm_shift"
        state = None
        if caches is not None and not prefill:
            state = caches[key][i]
        f, new = Lyr.rwkv_chanmix_apply(lp, qp_body, cfg, h2,
                                        prefix=f"{pre}.rwkv", state=state,
                                        tp=self.tp)
        if caches is not None:
            caches[key][i].copy_(new)
        return f

    def _block(self, lp, qp_body, x, rope, caches=None, pos=None,
               pages=None, i=0, chunked=False, full_capacity=False,
               prefill=False):
        """One layer of the stack on the residual stream x; an MoE routes
        at full capacity with `full_capacity` (prefill, verify_chunk);
        `prefill` runs the recurrent mixers from zero state."""
        cfg = self.cfg
        for sub, shp in zip(self.plan, self.shapes):
            pre = f"blocks.{sub.j}"
            h = Lyr.rmsnorm(x, lp[f"{pre}.norm1"], cfg.norm_eps)
            x = x + self._mixer(sub, shp, lp, qp_body, h, rope, caches, pos,
                                pages, i, chunked, prefill)
            if sub.ffn == "none":
                continue
            h2 = Lyr.rmsnorm(x, lp[f"{pre}.norm2"], cfg.norm_eps)
            x = x + self._ffn(sub, shp, lp, qp_body, h2, caches, i, prefill,
                              full_capacity)
        return x

    def _blocks(self, params, qp_body, x, rope, caches=None, pos=None,
                pages=None, chunked=False, full_capacity=False,
                prefill=False):
        """Run the layer stack; with `caches`, each attention sublayer
        writes its K/V into the cache in place (into the shared page pools
        through `pages`, a `Lyr.PagedView`, when given; at rows pos + [0,
        S) with `chunked`) and each recurrent sublayer its new state. A
        training forward (grad enabled, no cache) under `cfg.remat`
        checkpoints each layer."""
        remat = (self.cfg.remat and caches is None
                 and torch.is_grad_enabled())
        for i, lp in enumerate(self._layer_views(params)):
            if remat:
                x = checkpoint(self._block, lp, qp_body, x, rope,
                               use_reentrant=False)
            else:
                x = self._block(lp, qp_body, x, rope, caches, pos, pages, i,
                                chunked, full_capacity, prefill)
        return x

    def forward(self, params: dict, qparams: Optional[dict],
                tokens: torch.Tensor, vision_embeds=None) -> torch.Tensor:
        """tokens: (B, S[, C]); vision_embeds: (B, P, D) for the vlm
        family. Returns logits (B, P + S, vocab_padded), (B, S, C,
        vocab_padded) with codebooks."""
        cfg = self.cfg
        params, qp_body = self._prequantize(params, qparams)
        x = self._with_patches(self._embed_tokens(params, tokens),
                               vision_embeds)
        rope = Lyr.rope_tables(x.shape[1], cfg.d_head, cfg.rope_theta,
                               device=x.device)
        x = self._blocks(params, qp_body, x, rope)
        x = Lyr.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return self._head(params, x)

    # ----------------------------------------------------------------- loss
    def loss(self, params: dict, qparams: Optional[dict], batch: dict
             ) -> torch.Tensor:
        """Next-token cross-entropy: f32 logsumexp, and the gold logit by
        a masked reduction over the vocab (no gather), as the JAX
        package computes it; over the text positions of a vlm batch (its
        "vision_embeds" go through `forward`) and per codebook of an audio
        one (targets (B, S - 1, C))."""
        tokens = batch["tokens"]
        logits = self.forward(params, qparams, tokens,
                              vision_embeds=batch.get("vision_embeds"))
        if self.cfg.vision_patches:
            logits = logits[:, self.cfg.vision_patches:]
        pred = logits[:, :-1].to(torch.float32)
        tgt = tokens[:, 1:]
        logz = torch.logsumexp(pred, dim=-1)
        return torch.mean(logz - Lyr.pick(pred, tgt))

    # -------------------------------------------------------------- graph
    def build_graph(self, act_quant: bool = False) -> GraphBuilder:
        """Trace graph + quant branches for QADG analysis: one vertex per
        (position-in-period, component); families over KV-head groups, MLP
        channels and experts apply uniformly across the n_blocks stack."""
        cfg = self.cfg
        gb = GraphBuilder()
        gb.input("in")
        gb.embedding("embed", "embed", out_dim=cfg.d_model,
                     non_prunable=True, after="in",
                     out_axis=(2 if cfg.num_codebooks else 1))
        resid = "embed"
        for sub in self.plan:
            pre = f"blocks.{sub.j}"
            gb.norm(f"{pre}.norm1", scale=f"{pre}.norm1", after=resid,
                    param_axis=1)
            mixer_v = {"attn": self._graph_attn, "mamba": self._graph_mamba,
                       "rwkv": self._graph_rwkv}[sub.mixer](gb, pre)
            resid = gb.add(f"{pre}.add1", [resid, mixer_v])
            if sub.ffn == "none":
                continue
            gb.norm(f"{pre}.norm2", scale=f"{pre}.norm2", after=resid,
                    param_axis=1)
            ffn_v = (self._graph_moe(gb, pre) if sub.ffn == "moe"
                     else self._graph_chanmix(gb, pre)
                     if sub.ffn == "chanmix"
                     else self._graph_mlp(gb, pre, act_quant))
            resid = gb.add(f"{pre}.add2", [resid, ffn_v])
        gb.norm("final_norm", scale="final_norm", after=resid)
        tied = self._tied
        head_param = "embed" if tied else "head"
        gb.linear("head", head_param,
                  out_dim=cfg.vocab_padded * max(cfg.num_codebooks, 1),
                  non_prunable=True, in_axis=(1 if tied else 0),
                  out_axis=(0 if tied else 1), after="final_norm")
        gb.attach_weight_quant("head", f"{head_param}.wq",
                               target_param=head_param)
        gb.output("out", after="head")
        return gb

    def _graph_attn(self, gb: GraphBuilder, pre: str) -> str:
        cfg = self.cfg
        gsz, dh = cfg.gqa_group, cfg.d_head
        members = [(f"{pre}.attn.wq", 2, gsz * dh), (f"{pre}.attn.wk", 2, dh),
                   (f"{pre}.attn.wv", 2, dh), (f"{pre}.attn.wo", 1, gsz * dh)]
        if cfg.qkv_bias:
            members += [(f"{pre}.attn.bq", 1, gsz * dh),
                        (f"{pre}.attn.bk", 1, dh), (f"{pre}.attn.bv", 1, dh)]
        spec = FamilySpec(name=f"{pre}.attn.kv_groups", units=cfg.n_kv_heads,
                          members=members, kind="head_group")
        vid = gb.composite(
            f"{pre}.attn", "attention", spec,
            params={f"p{i}": m[0] for i, m in enumerate(members)},
            in_members=[(f"{pre}.attn.wq", 1), (f"{pre}.attn.wk", 1),
                        (f"{pre}.attn.wv", 1)],
            resid_members=[(f"{pre}.attn.wo", 2)], after=f"{pre}.norm1")
        for w in _QUANT_WEIGHTS["attn"]:
            gb.attach_weight_quant(vid, f"{pre}.attn.{w}.wq",
                                   target_param=f"{pre}.attn.{w}")
        return vid

    def _graph_mamba(self, gb: GraphBuilder, pre: str) -> str:
        # the inner channels are the removable unit (a "state" family)
        cfg = self.cfg
        m = f"{pre}.mamba"
        members = [(f"{m}.in_proj_x", 2, 1), (f"{m}.in_proj_z", 2, 1),
                   (f"{m}.conv_w", 2, 1), (f"{m}.x_proj", 1, 1),
                   (f"{m}.dt_proj", 2, 1), (f"{m}.dt_bias", 1, 1),
                   (f"{m}.A_log", 1, 1), (f"{m}.D", 1, 1),
                   (f"{m}.out_proj", 1, 1)]
        spec = FamilySpec(name=f"{m}.channels",
                          units=cfg.mamba.expand * cfg.d_model,
                          members=members, kind="state")
        vid = gb.composite(
            m, "mamba", spec,
            params={f"p{i}": mm[0] for i, mm in enumerate(members)},
            in_members=[(f"{m}.in_proj_x", 1), (f"{m}.in_proj_z", 1)],
            resid_members=[(f"{m}.out_proj", 2)], after=f"{pre}.norm1")
        for w in _QUANT_WEIGHTS["mamba"]:
            gb.attach_weight_quant(vid, f"{m}.{w}.wq", target_param=f"{m}.{w}")
        return vid

    def _graph_rwkv(self, gb: GraphBuilder, pre: str) -> str:
        # time-mix: heads are the removable unit
        cfg = self.cfg
        dh = cfg.rwkv.head_size
        r = f"{pre}.rwkv"
        members = [(f"{r}.wr", 2, dh), (f"{r}.wk", 2, dh), (f"{r}.wv", 2, dh),
                   (f"{r}.wg", 2, dh), (f"{r}.wo", 1, dh),
                   (f"{r}.decay_w2", 2, dh), (f"{r}.decay_w0", 1, dh),
                   (f"{r}.u", 1, dh), (f"{r}.lnx_scale", 1, dh),
                   (f"{r}.lnx_bias", 1, dh)]
        spec = FamilySpec(name=f"{r}.heads", units=cfg.d_model // dh,
                          members=members, kind="head_group")
        vid = gb.composite(
            r, "rwkv_timemix", spec,
            params={f"p{i}": mm[0] for i, mm in enumerate(members)},
            in_members=[(f"{r}.wr", 1), (f"{r}.wk", 1), (f"{r}.wv", 1),
                        (f"{r}.wg", 1), (f"{r}.decay_w1", 1)],
            resid_members=[(f"{r}.wo", 2)], after=f"{pre}.norm1")
        for w in _QUANT_WEIGHTS["rwkv"]:
            gb.attach_weight_quant(vid, f"{r}.{w}.wq", target_param=f"{r}.{w}")
        return vid

    def _graph_chanmix(self, gb: GraphBuilder, pre: str) -> str:
        # channel-mix: the hidden channels are the removable unit
        r = f"{pre}.rwkv"
        members = [(f"{r}.cm_k", 2, 1), (f"{r}.cm_v", 1, 1)]
        spec = FamilySpec(name=f"{r}.cm_hidden", units=self.cfg.d_ff,
                          members=members, kind="channel")
        vid = gb.composite(
            f"{r}.cm", "rwkv_chanmix", spec,
            params={f"p{i}": mm[0] for i, mm in enumerate(members)},
            in_members=[(f"{r}.cm_k", 1), (f"{r}.cm_r", 1)],
            resid_members=[(f"{r}.cm_v", 2), (f"{r}.cm_r", 2)],
            after=f"{pre}.norm2")
        for w in _QUANT_WEIGHTS["chanmix"]:
            gb.attach_weight_quant(vid, f"{r}.{w}.wq", target_param=f"{r}.{w}")
        return vid

    def _graph_mlp(self, gb: GraphBuilder, pre: str, act_quant: bool) -> str:
        # gate/up produce the hidden space (tied through the product), down
        # consumes it, as generic vertices so the dependency analysis (and
        # inserted act-quant branches) apply
        cfg = self.cfg
        g = gb.linear(f"{pre}.mlp.gate", f"{pre}.mlp.w_gate",
                      out_dim=cfg.d_ff, in_axis=1, out_axis=2,
                      after=f"{pre}.norm2")
        u = gb.linear(f"{pre}.mlp.up", f"{pre}.mlp.w_up", out_dim=cfg.d_ff,
                      in_axis=1, out_axis=2, after=f"{pre}.norm2")
        m = gb.add(f"{pre}.mlp.prod", [g, u])
        a = gb.act(f"{pre}.mlp.silu", after=m)
        dn = gb.linear(f"{pre}.mlp.down", f"{pre}.mlp.w_down", in_axis=1,
                       out_axis=2, out_dim=cfg.d_model, non_prunable=True,
                       after=a)
        for w in ("gate", "up", "down"):
            gb.attach_weight_quant(f"{pre}.mlp.{w}", f"{pre}.mlp.w_{w}.wq")
        if act_quant:
            gb.insert_act_quant(a, dn, f"{pre}.mlp.mlp_act.aq")
        return dn

    def _graph_moe(self, gb: GraphBuilder, pre: str) -> str:
        # one composite over the experts; the shared expert's projections
        # read the sublayer's input and write the residual stream with it
        cfg = self.cfg
        members = [(f"{pre}.moe.router", 2, 1), (f"{pre}.moe.we_gate", 1, 1),
                   (f"{pre}.moe.we_up", 1, 1), (f"{pre}.moe.we_down", 1, 1)]
        spec = FamilySpec(name=f"{pre}.moe.experts", units=cfg.moe.n_experts,
                          members=members, kind="expert")
        in_m = [(f"{pre}.moe.router", 1), (f"{pre}.moe.we_gate", 2),
                (f"{pre}.moe.we_up", 2)]
        res_m = [(f"{pre}.moe.we_down", 3)]
        if cfg.moe.shared_expert:
            in_m += [(f"{pre}.moe.shared.w_gate", 1),
                     (f"{pre}.moe.shared.w_up", 1)]
            res_m += [(f"{pre}.moe.shared.w_down", 2)]
        vid = gb.composite(
            f"{pre}.moe", "moe", spec,
            params={f"p{i}": m[0] for i, m in enumerate(members)},
            in_members=in_m, resid_members=res_m, after=f"{pre}.norm2")
        for w in _QUANT_WEIGHTS["moe"]:
            gb.attach_weight_quant(vid, f"{pre}.moe.{w}.wq",
                                   target_param=f"{pre}.moe.{w}")
        return vid

    # ------------------------------------------------------------- serving
    def _state_leaves(self, sub, shp, batch: int, dtype, device) -> dict:
        """A recurrent sublayer's decode state for `batch` slots, at the
        sublayer's widths: mamba's h (f32) and conv (in `dtype`), rwkv6's
        token shifts and WKV state (f32)."""
        cfg, nb, pre = self.cfg, self.n_blocks, f"blocks.{sub.j}"
        z = lambda shape, dt: torch.zeros((nb, batch) + shape, dtype=dt,
                                          device=device)
        if sub.mixer == "mamba":
            Di = shp.mamba_inner
            return {f"{pre}.h": z((Di, cfg.mamba.d_state), torch.float32),
                    f"{pre}.conv": z((cfg.mamba.d_conv - 1, Di), dtype)}
        dh = cfg.rwkv.head_size
        return {f"{pre}.tm_shift": z((shp.d_model,), torch.float32),
                f"{pre}.wkv": z((shp.rwkv_heads, dh, dh), torch.float32),
                f"{pre}.cm_shift": z((shp.d_model,), torch.float32)}

    def init_cache(self, batch: int, max_seq: int, dtype=torch.bfloat16,
                   device=None) -> dict:
        """The decode arena: (n_blocks, batch, rows, KVh, dh) per attention
        K and V, rows = max_seq, or min(max_seq, window) for a
        sliding-window ring, and each recurrent sublayer's state leaves
        (`_state_leaves`), all at the sublayers' (possibly sliced) widths."""
        window = self.cfg.window
        rows = min(max_seq, window) if window > 0 else max_seq
        caches = {}
        for sub, shp in zip(self.plan, self.shapes):
            pre = f"blocks.{sub.j}"
            if sub.mixer != "attn":
                caches.update(self._state_leaves(sub, shp, batch, dtype,
                                                 device))
                continue
            shape = (self.n_blocks, batch, rows, shp.n_kv_heads, shp.d_head)
            caches[f"{pre}.k"] = torch.zeros(shape, dtype=dtype,
                                             device=device)
            caches[f"{pre}.v"] = torch.zeros(shape, dtype=dtype,
                                             device=device)
        return caches

    def init_paged_cache(self, n_pages: int, page_size: int,
                         dtype=torch.bfloat16, kv_bits: Optional[int] = None,
                         device=None, batch: Optional[int] = None) -> dict:
        """The paged decode arena: attention K and V become pools of
        (n_blocks, n_pages, page_size, KVh, dh) pages shared by every slot
        and addressed through per-slot page tables (`Lyr.PagedView`), so
        the device memory follows the rows written, not slots x max_seq.
        With `kv_bits` (8 or 4) the pools hold int8 codes (nibble pairs of
        width dh // 2 at 4 bits) plus per-row f32 scale pools
        `<pre>.k_scale` / `<pre>.v_scale` (n_blocks, n_pages, page_size,
        KVh), decoded by the kernel when it reads them. A recurrent
        sublayer's state is constant per slot and stays contiguous, one
        row per slot: `batch` (the slot count) sizes those leaves and is
        required when the plan has recurrent mixers."""
        if self.cfg.window > 0:
            raise ValueError("paged KV arena needs full (non-ring) caches; "
                             f"window={self.cfg.window}")
        if kv_bits is not None and kv_bits not in KV_STORAGE_BITS:
            raise ValueError(f"kv_bits must be in {KV_STORAGE_BITS}, "
                             f"got {kv_bits}")
        if recurrent_mixers(self.plan) and batch is None:
            raise ValueError(
                f"init_paged_cache: the plan has "
                f"{recurrent_mixers(self.plan)} "
                f"mixers, whose per-slot state needs batch= (the slot "
                f"count)")
        caches = {}
        for sub, shp in zip(self.plan, self.shapes):
            pre = f"blocks.{sub.j}"
            if sub.mixer != "attn":
                caches.update(self._state_leaves(sub, shp, batch, dtype,
                                                 device))
                continue
            KVh, dh = shp.n_kv_heads, shp.d_head
            rows = (self.n_blocks, n_pages, page_size, KVh)
            if kv_bits is None:
                for n in ("k", "v"):
                    caches[f"{pre}.{n}"] = torch.zeros(
                        rows + (dh,), dtype=dtype, device=device)
                continue
            if kv_bits == 4 and dh % 2:
                raise ValueError(f"kv_bits=4 packs code pairs; d_head={dh} "
                                 f"must be even")
            dhs = dh // 2 if kv_bits == 4 else dh
            for n in ("k", "v"):
                caches[f"{pre}.{n}"] = torch.zeros(
                    rows + (dhs,), dtype=torch.int8, device=device)
                caches[f"{pre}.{n}_scale"] = torch.zeros(
                    rows, dtype=torch.float32, device=device)
        return caches

    def prefill(self, params: dict, qparams: Optional[dict], caches: dict,
                tokens: torch.Tensor, vision_embeds=None,
                last_logit_only: bool = False):
        """One-shot prefill: a full-sequence pass that writes K/V rows
        [0, S) of `caches` in place (the rows must be zeroed beyond the
        prompt, as a fresh cache is) and each recurrent sublayer's state
        as S sequential decode steps from zero state would leave it. A
        prompt longer than a scan chunk must be a multiple of it
        (`check_prompt_length`); on a sliding-window config it must fit
        the ring. tokens: (B, S[, C]); a vlm's `vision_embeds` (B, P, D)
        are prefilled before the text (S counts them). Returns (logits,
        caches); `last_logit_only` projects only the final position
        through the head."""
        cfg = self.cfg
        params, qp_body = self._prequantize(params, qparams)
        x = self._with_patches(self._embed_tokens(params, tokens),
                               vision_embeds)
        rope = Lyr.rope_tables(x.shape[1], cfg.d_head, cfg.rope_theta,
                               device=x.device)
        pos = torch.zeros((), dtype=torch.int64, device=x.device)
        # serving semantics: prompt tokens never compete for expert
        # capacity, as one-token decode never overflows it
        x = self._blocks(params, qp_body, x, rope, caches, pos,
                         full_capacity=True, prefill=True)
        if last_logit_only:
            x = x[:, -1:]
        x = Lyr.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return self._head(params, x), caches

    def _rope_freqs(self, device: torch.device) -> torch.Tensor:
        """`rope_freqs` on `device`, computed once per LM and device: a
        decode step captured into a CUDA graph may not copy theta to the
        card, as computing them does."""
        freqs = self._freqs.get(device)
        if freqs is None:
            freqs = self._freqs[device] = Lyr.rope_freqs(
                self.cfg.d_head, self.cfg.rope_theta, device)
        return freqs

    def verify_chunk(self, params: dict, qparams: Optional[dict],
                     caches: dict, tokens: torch.Tensor, pos,
                     last_logit_only: bool = False):
        """Score a T-token chunk mid-sequence against the live contiguous
        caches: the speculative verify pass and chunked prefill. tokens:
        (B, T), column 0 at each slot's absolute position pos[b] (an int
        or a (B,) tensor). Writes K/V rows [pos, pos + T) of every slot in
        place and returns (logits (B, T, V), caches); `last_logit_only`
        projects only the final position through the head. Rope is taken
        at pos + [0, T) from the cached frequencies, so the pass can be
        captured in a CUDA graph.

        Attention mixers only: a recurrent state cannot be rolled back
        when a draft is rejected (KV rows can be zeroed). An MoE routes
        the chunk at full capacity, as prefill does: a dropping verify
        would part from the one-token decode steps it stands in for."""
        bad = recurrent_mixers(self.plan)
        if bad:
            raise ValueError(
                f"verify_chunk needs attention mixers everywhere (rollback "
                f"zeroes KV rows); plan has {bad} layers whose recurrent "
                f"state cannot be rolled back")
        cfg = self.cfg
        if cfg.num_codebooks:
            raise ValueError("verify_chunk serves plain token LMs")
        params, qp_body = self._prequantize(params, qparams)
        x = self._embed_tokens(params, tokens)
        B, T = x.shape[0], x.shape[1]
        pos = torch.as_tensor(pos, dtype=torch.int64,
                              device=x.device).reshape(-1).expand(B)
        posf = (pos[:, None] + torch.arange(T, device=x.device)[None, :]
                ).to(torch.float32)
        ang = posf[..., None] * self._rope_freqs(x.device)[None, None, :]
        rope = (torch.cos(ang), torch.sin(ang))               # (B, T, dh/2)
        x = self._blocks(params, qp_body, x, rope, caches, pos,
                         chunked=True, full_capacity=True)
        if last_logit_only:
            x = x[:, -1:]
        x = Lyr.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return self._head(params, x), caches

    def decode_step(self, params: dict, qparams: Optional[dict],
                    caches: dict, token: torch.Tensor, pos,
                    pages: Optional[Lyr.PagedView] = None):
        """One-token decode. token: (B, 1[, C]); pos: an int or a (B,) tensor
        of per-slot absolute positions. Writes each slot's K/V row at its
        position in place: into the contiguous arena of `init_cache`, or,
        with `pages`, into the page pools of `init_paged_cache` through
        its page table. The recurrent sublayers read each slot's state and
        write the next one in place (paged or not: their state is per
        slot). Returns (logits (B, 1, V) or (B, 1, C, V), caches)."""
        cfg = self.cfg
        params, qp_body = self._prequantize(params, qparams)
        x = self._embed_tokens(params, token)
        B = x.shape[0]
        pos = torch.as_tensor(pos, dtype=torch.int64,
                              device=x.device).reshape(-1).expand(B)
        ang = pos.to(torch.float32)[:, None] * self._rope_freqs(
            x.device)[None, :]
        rope = (torch.cos(ang)[:, None], torch.sin(ang)[:, None])
        x = self._blocks(params, qp_body, x, rope, caches, pos, pages)
        x = Lyr.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return self._head(params, x), caches
