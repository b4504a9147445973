"""The decoder LM of the dense family, port of `repro.models.transformer`.

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

Weight quantizers split as in JAX: sites on routed 2-D block projections
fuse into the GEMM's fake-quant epilogue; the rest (the head) are
fake-quanted once per call in `_prequantize`. `loss` is the training
objective; with `cfg.remat` each layer of the training forward runs under
`torch.utils.checkpoint` (non-reentrant), so the backward recomputes the
layer instead of keeping its activations, with the same numbers.
`build_graph` describes the model to QADG (`core.qadg`).
"""
from __future__ import annotations

import dataclasses
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
    mixer: str     # attn
    ffn: str       # mlp


# Which params receive weight-quant sites (per sublayer component).
_QUANT_WEIGHTS = {
    "attn": ["wq", "wk", "wv", "wo"],
    "mlp": ["w_gate", "w_up", "w_down"],
}
# Activation-quant sites (per sublayer component).
_ACT_SITES = {"attn": ["attn_out"], "mlp": ["mlp_act"]}


class LM(torch.nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.family != "dense":
            raise Lyr.not_in_this_slice(
                f"the {cfg.family!r} family ({cfg.name})",
                "ROADMAP Queue 1 item 12 (other families)")
        if cfg.window > 0:
            raise Lyr.not_in_this_slice(
                f"sliding-window attention (window={cfg.window})",
                "ROADMAP Queue 1 item 12 (other families)")
        self.cfg = cfg
        self.plan = [SubLayer(0, "attn", "mlp")]
        self.n_blocks = cfg.n_layers
        # the physical dims of each position-in-period, which prefill,
        # decode and the KV arenas read instead of the config's: a pruned
        # subnet's after `apply_slim_plan`
        self.shapes = [Lyr.LayerShapes.from_config(cfg)]
        self.slim_plan = None
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
        D, Vp = cfg.d_model, cfg.vocab_padded
        params = {"embed": Lyr._normal(gen, (Vp, D), dt, 0.02)}
        if not cfg.tie_embeddings:
            params["head"] = Lyr._normal(gen, (D, Vp), dt, D ** -0.5)
        params["final_norm"] = torch.ones((D,), dtype=torch.float32,
                                          device=dev)
        for sub in self.plan:
            pre = f"blocks.{sub.j}"
            for norm in ("norm1", "norm2"):
                params[f"{pre}.{norm}"] = torch.ones(
                    (self.n_blocks, D), dtype=torch.float32, device=dev)
            params.update(Lyr.init_attention(gen, cfg, f"{pre}.attn",
                                             self.n_blocks, dt))
            params.update(Lyr.init_mlp(gen, cfg, f"{pre}.mlp",
                                       self.n_blocks, dt))
        return params

    # --------------------------------------------------------- quantization
    def quant_weight_names(self) -> list[str]:
        names = []
        for sub in self.plan:
            pre = f"blocks.{sub.j}"
            names += [f"{pre}.attn.{w}" for w in _QUANT_WEIGHTS["attn"]]
            names += [f"{pre}.mlp.{w}" for w in _QUANT_WEIGHTS["mlp"]]
        names.append("embed" if self.cfg.tie_embeddings else "head")
        return names

    def act_site_names(self) -> list[str]:
        names = []
        for sub in self.plan:
            pre = f"blocks.{sub.j}"
            names += [f"{pre}.{sub.mixer}.{s}.aq"
                      for s in _ACT_SITES[sub.mixer]]
            names += [f"{pre}.{sub.ffn}.{s}.aq" for s in _ACT_SITES[sub.ffn]]
        return names

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
        (routed block projections) and weights fake-quanted here (the
        head). Returns (params, body qparams)."""
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
        # F.embedding's backward sums rows without atomics on the card;
        # indexing (`embed[tokens]`) would backprop through index_put_
        # with accumulation
        return F.embedding(tokens, params["embed"])

    def _head(self, params: dict, h: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return h @ params["embed"].T
        return Lyr.dense_proj(h, params, None, "head")

    def _layer_views(self, params: dict) -> list[dict]:
        """Each layer's view of the stacked block params (no copies)."""
        views = [{} for _ in range(self.n_blocks)]
        for k, v in params.items():
            if k.startswith("blocks."):
                for i, vi in enumerate(torch.unbind(v, 0)):
                    views[i][k] = vi
        return views

    def _block(self, lp, qp_body, x, rope, caches=None, pos=None,
               pages=None, i=0, chunked=False):
        """One layer of the stack on the residual stream x."""
        cfg = self.cfg
        for sub, shp in zip(self.plan, self.shapes):
            pre = f"blocks.{sub.j}"
            h = Lyr.rmsnorm(x, lp[f"{pre}.norm1"], cfg.norm_eps)
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
                                    chunked=chunked)
            x = x + mix
            h2 = Lyr.rmsnorm(x, lp[f"{pre}.norm2"], cfg.norm_eps)
            x = x + Lyr.mlp_apply(lp, qp_body, cfg, h2, prefix=f"{pre}.mlp")
        return x

    def _blocks(self, params, qp_body, x, rope, caches=None, pos=None,
                pages=None, chunked=False):
        """Run the layer stack; with `caches`, each attention sublayer
        writes its K/V into the cache in place (into the shared page pools
        through `pages`, a `Lyr.PagedView`, when given; at rows pos + [0,
        S) with `chunked`). A training forward (grad enabled, no cache)
        under `cfg.remat` checkpoints each layer."""
        remat = (self.cfg.remat and caches is None
                 and torch.is_grad_enabled())
        for i, lp in enumerate(self._layer_views(params)):
            if remat:
                x = checkpoint(self._block, lp, qp_body, x, rope,
                               use_reentrant=False)
            else:
                x = self._block(lp, qp_body, x, rope, caches, pos, pages, i,
                                chunked)
        return x

    def forward(self, params: dict, qparams: Optional[dict],
                tokens: torch.Tensor) -> torch.Tensor:
        """tokens: (B, S). Returns logits (B, S, vocab_padded)."""
        cfg = self.cfg
        params, qp_body = self._prequantize(params, qparams)
        x = self._embed_tokens(params, tokens)
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
        package computes it."""
        tokens = batch["tokens"]
        logits = self.forward(params, qparams, tokens)
        pred = logits[:, :-1].to(torch.float32)
        tgt = tokens[:, 1:]
        logz = torch.logsumexp(pred, dim=-1)
        return torch.mean(logz - Lyr.pick(pred, tgt))

    # -------------------------------------------------------------- graph
    def build_graph(self, act_quant: bool = False) -> GraphBuilder:
        """Trace graph + quant branches for QADG analysis: one vertex per
        (position-in-period, component); families over KV-head groups and
        MLP channels apply uniformly across the n_blocks stack."""
        cfg = self.cfg
        gb = GraphBuilder()
        gb.input("in")
        gb.embedding("embed", "embed", out_dim=cfg.d_model,
                     non_prunable=True, after="in", out_axis=1)
        resid = "embed"
        for sub in self.plan:
            pre = f"blocks.{sub.j}"
            gb.norm(f"{pre}.norm1", scale=f"{pre}.norm1", after=resid,
                    param_axis=1)
            mixer_v = self._graph_attn(gb, pre)
            resid = gb.add(f"{pre}.add1", [resid, mixer_v])
            gb.norm(f"{pre}.norm2", scale=f"{pre}.norm2", after=resid,
                    param_axis=1)
            ffn_v = self._graph_mlp(gb, pre, act_quant)
            resid = gb.add(f"{pre}.add2", [resid, ffn_v])
        gb.norm("final_norm", scale="final_norm", after=resid)
        tied = cfg.tie_embeddings
        head_param = "embed" if tied else "head"
        gb.linear("head", head_param, out_dim=cfg.vocab_padded,
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

    # ------------------------------------------------------------- serving
    def init_cache(self, batch: int, max_seq: int, dtype=torch.bfloat16,
                   device=None) -> dict:
        """The decode KV arena: (n_blocks, batch, max_seq, KVh, dh) per
        attention K and V."""
        caches = {}
        for sub, shp in zip(self.plan, self.shapes):
            pre = f"blocks.{sub.j}"
            shape = (self.n_blocks, batch, max_seq, shp.n_kv_heads,
                     shp.d_head)
            caches[f"{pre}.k"] = torch.zeros(shape, dtype=dtype,
                                             device=device)
            caches[f"{pre}.v"] = torch.zeros(shape, dtype=dtype,
                                             device=device)
        return caches

    def init_paged_cache(self, n_pages: int, page_size: int,
                         dtype=torch.bfloat16, kv_bits: Optional[int] = None,
                         device=None) -> dict:
        """The paged decode arena: attention K and V become pools of
        (n_blocks, n_pages, page_size, KVh, dh) pages shared by every slot
        and addressed through per-slot page tables (`Lyr.PagedView`), so
        the device memory follows the rows written, not slots x max_seq.
        With `kv_bits` (8 or 4) the pools hold int8 codes (nibble pairs of
        width dh // 2 at 4 bits) plus per-row f32 scale pools
        `<pre>.k_scale` / `<pre>.v_scale` (n_blocks, n_pages, page_size,
        KVh), decoded by the kernel when it reads them."""
        if self.cfg.window > 0:
            raise ValueError("paged KV arena needs full (non-ring) caches; "
                             f"window={self.cfg.window}")
        if kv_bits is not None and kv_bits not in KV_STORAGE_BITS:
            raise ValueError(f"kv_bits must be in {KV_STORAGE_BITS}, "
                             f"got {kv_bits}")
        caches = {}
        for sub, shp in zip(self.plan, self.shapes):
            pre = f"blocks.{sub.j}"
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
                tokens: torch.Tensor, last_logit_only: bool = False):
        """One-shot prefill: a full-sequence pass that writes K/V rows
        [0, S) of `caches` in place (the rows must be zeroed beyond the
        prompt, as a fresh cache is). Returns (logits, caches);
        `last_logit_only` projects only the final position through the
        head."""
        cfg = self.cfg
        params, qp_body = self._prequantize(params, qparams)
        x = self._embed_tokens(params, tokens)
        rope = Lyr.rope_tables(x.shape[1], cfg.d_head, cfg.rope_theta,
                               device=x.device)
        pos = torch.zeros((), dtype=torch.int64, device=x.device)
        x = self._blocks(params, qp_body, x, rope, caches, pos)
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
        when a draft is rejected (KV rows can be zeroed)."""
        bad = sorted({sub.mixer for sub in self.plan if sub.mixer != "attn"})
        if bad:
            raise ValueError(
                f"verify_chunk needs attention mixers everywhere (rollback "
                f"zeroes KV rows); plan has {bad} layers whose recurrent "
                f"state cannot be rolled back")
        if any(sub.ffn == "moe" for sub in self.plan):
            raise Lyr.not_in_this_slice(
                "verify_chunk over MoE layers (full-capacity routing)",
                "ROADMAP Queue 1 item 12 (other families)")
        cfg = self.cfg
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
                         chunked=True)
        if last_logit_only:
            x = x[:, -1:]
        x = Lyr.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return self._head(params, x), caches

    def decode_step(self, params: dict, qparams: Optional[dict],
                    caches: dict, token: torch.Tensor, pos,
                    pages: Optional[Lyr.PagedView] = None):
        """One-token decode. token: (B, 1); pos: an int or a (B,) tensor
        of per-slot absolute positions. Writes each slot's K/V row at its
        position in place: into the contiguous arena of `init_cache`, or,
        with `pages`, into the page pools of `init_paged_cache` through
        its page table. Returns (logits (B, 1, V), caches)."""
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
