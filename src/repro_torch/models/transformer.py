"""The decoder LM of the dense family, port of `repro.models.transformer`.

`LM` is an `nn.Module` that holds the config and the layer plan; the
weights stay a flat dict[str, Tensor] under the JAX keys (stacked (L, K, N)
block tensors, `<name>.codes` / `<name>.packed{bits}` / `<name>.scale`
after compression), passed to every call, so weights cross between the
two packages 1:1.

PyTorch runs eagerly, so the layer stack is a Python loop over per-layer
views of the stacked tensors, and `prefill` / `decode_step` write the KV
cache (the contiguous arena, or the paged pools) IN PLACE and return the
same dict.

Weight quantizers split as in JAX: sites on routed 2-D block projections
fuse into the GEMM's fake-quant epilogue; the rest (the head) are
fake-quanted once per call in `_prequantize`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
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
        self.shapes = [Lyr.LayerShapes.from_config(cfg)]

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

    def init_qparams(self, params: dict, bits_init: float = 8.0
                     ) -> dict[str, QuantParams]:
        return {name + ".wq": init_quant_params(params[name], bits=bits_init)
                for name in self.quant_weight_names() if name in params}

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
        return params["embed"][tokens]

    def _head(self, params: dict, h: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return h @ params["embed"].T
        return Lyr.dense_proj(h, params, None, "head")

    @staticmethod
    def _layer(params: dict, i: int) -> dict:
        """Layer i's view of the stacked block params (no copies)."""
        return {k: v[i] for k, v in params.items() if k.startswith("blocks.")}

    def _blocks(self, params, qp_body, x, rope, caches=None, pos=None,
                pages=None):
        """Run the layer stack; with `caches`, each attention sublayer
        writes its K/V into the cache in place (into the shared page pools
        through `pages`, a `Lyr.PagedView`, when given)."""
        cfg = self.cfg
        for i in range(self.n_blocks):
            lp = self._layer(params, i)
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
                                        shapes=shp, pages=pages)
                x = x + mix
                h2 = Lyr.rmsnorm(x, lp[f"{pre}.norm2"], cfg.norm_eps)
                x = x + Lyr.mlp_apply(lp, qp_body, cfg, h2,
                                      prefix=f"{pre}.mlp")
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
        ang = pos.to(torch.float32)[:, None] * Lyr.rope_freqs(
            cfg.d_head, cfg.rope_theta, x.device)[None, :]
        rope = (torch.cos(ang)[:, None], torch.sin(ang)[:, None])
        x = self._blocks(params, qp_body, x, rope, caches, pos, pages)
        x = Lyr.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return self._head(params, x), caches
