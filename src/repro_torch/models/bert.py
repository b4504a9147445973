"""BERT-style encoder (per layer, unstacked), port of `repro.models.bert`:
Table 3's substrate.

The GETA path for transformers at full fidelity: per-layer quant sites,
per-layer attention-head and MLP-channel pruning families (the QADG
appendix-D graph), the same graph as the JAX package's. Projections are
`x @ fake_quant(w)` in plain `torch.matmul`, as they were plain XLA
there; the weights go through `core.quant.fake_quant`, which on a CUDA
tensor launches the fake-quant kernels. Attention is `attention_dense`
without the causal mask, GELU the tanh form (`jax.nn.gelu`'s default).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.bops import LayerMacs
from repro_torch.core.graph import FamilySpec, GraphBuilder
from repro_torch.core.quant import fake_quant, init_quant_params
from repro_torch.models.layers import attention_dense, pick


def _qw(params, qparams, name):
    w = params[name]
    site = name + ".wq"
    if qparams is not None and site in qparams:
        qp = qparams[site]
        w = fake_quant(w, qp.d, qp.q_m, qp.t)
    return w


def layernorm(x, scale, bias, eps=1e-5):
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    return ((x32 - mu) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


class BertEncoder:
    def __init__(self, n_layers=4, d_model=256, n_heads=4, d_ff=1024,
                 vocab=8192, max_seq=512):
        self.L = n_layers
        self.D = d_model
        self.H = n_heads
        self.dh = d_model // n_heads
        self.F = d_ff
        self.V = vocab
        self.S = max_seq

    def init(self, gen: torch.Generator) -> dict:
        """f32 params on `gen.device`, drawn from the torch RNG (not held
        to the JAX package's `jax.random` numbers)."""
        D, F_, V = self.D, self.F, self.V
        dev = gen.device

        def normal(shape, std):
            return torch.randn(shape, generator=gen, device=dev) * std

        def zeros(n):
            return torch.zeros((n,), device=dev)

        p = {"embed": normal((V, D), 0.02),
             "pos_embed": normal((self.S, D), 0.02)}
        for i in range(self.L):
            pre = f"enc.{i}"
            std = D ** -0.5
            for nm in ("wq", "wk", "wv", "wo"):
                p[f"{pre}.attn.{nm}"] = normal((D, D), std)
            for nm in ("bq", "bk", "bv"):
                p[f"{pre}.attn.{nm}"] = zeros(D)
            p[f"{pre}.ln1.scale"] = torch.ones((D,), device=dev)
            p[f"{pre}.ln1.bias"] = zeros(D)
            p[f"{pre}.mlp.w1"] = normal((D, F_), std)
            p[f"{pre}.mlp.b1"] = zeros(F_)
            p[f"{pre}.mlp.w2"] = normal((F_, D), F_ ** -0.5)
            p[f"{pre}.mlp.b2"] = zeros(D)
            p[f"{pre}.ln2.scale"] = torch.ones((D,), device=dev)
            p[f"{pre}.ln2.bias"] = zeros(D)
        p["qa_head.w"] = normal((D, 2), D ** -0.5)
        p["qa_head.b"] = zeros(2)
        return p

    def apply(self, params, qparams, tokens):
        B, S = tokens.shape
        x = params["embed"][tokens] + params["pos_embed"][:S]
        for i in range(self.L):
            pre = f"enc.{i}"

            def proj(name):
                return (x @ _qw(params, qparams, f"{pre}.attn.w{name}")
                        + params[f"{pre}.attn.b{name}"]).reshape(
                            B, S, self.H, self.dh)

            a = attention_dense(proj("q"), proj("k"), proj("v"),
                                causal=False).reshape(B, S, self.D)
            x = layernorm(x + a @ _qw(params, qparams, f"{pre}.attn.wo"),
                          params[f"{pre}.ln1.scale"],
                          params[f"{pre}.ln1.bias"])
            h = F.gelu(x @ _qw(params, qparams, f"{pre}.mlp.w1")
                       + params[f"{pre}.mlp.b1"], approximate="tanh")
            h = h @ _qw(params, qparams, f"{pre}.mlp.w2") \
                + params[f"{pre}.mlp.b2"]
            x = layernorm(x + h, params[f"{pre}.ln2.scale"],
                          params[f"{pre}.ln2.bias"])
        return x @ _qw(params, qparams, "qa_head.w") + params["qa_head.b"]

    def loss(self, params, qparams, batch):
        """SQuAD-style span loss: predict start/end positions."""
        logits = self.apply(params, qparams, batch["tokens"]).to(
            torch.float32)                                   # (B, S, 2)
        out = 0.0
        for j, key in enumerate(("start", "end")):
            lj = logits[..., j]
            logz = torch.logsumexp(lj, dim=-1)
            out = out + torch.mean(logz - pick(lj, batch[key]))
        return out / 2.0

    def exact_match(self, params, qparams, batch):
        logits = self.apply(params, qparams, batch["tokens"])
        s = torch.argmax(logits[..., 0], -1)
        e = torch.argmax(logits[..., 1], -1)
        return torch.mean(((s == batch["start"])
                           & (e == batch["end"])).to(torch.float32))

    # ------------------------------------------------------------- graph
    def build_graph(self, act_quant: bool = False) -> GraphBuilder:
        gb = GraphBuilder()
        gb.input("in")
        gb.embedding("embed", "embed", out_dim=self.D, non_prunable=True)
        resid = "embed"
        for i in range(self.L):
            pre = f"enc.{i}"
            members = [(f"{pre}.attn.wq", 1, self.dh),
                       (f"{pre}.attn.wk", 1, self.dh),
                       (f"{pre}.attn.wv", 1, self.dh),
                       (f"{pre}.attn.bq", 0, self.dh),
                       (f"{pre}.attn.bk", 0, self.dh),
                       (f"{pre}.attn.bv", 0, self.dh),
                       (f"{pre}.attn.wo", 0, self.dh)]
            spec = FamilySpec(name=f"{pre}.attn.heads", units=self.H,
                              members=members, kind="head_group")
            attn = gb.composite(
                f"{pre}.attn", "attention", spec,
                params={f"p{j}": m[0] for j, m in enumerate(members)},
                in_members=[(f"{pre}.attn.wq", 0), (f"{pre}.attn.wk", 0),
                            (f"{pre}.attn.wv", 0)],
                resid_members=[(f"{pre}.attn.wo", 1)],
                after=resid)
            for w in ("wq", "wk", "wv", "wo"):
                gb.attach_weight_quant(attn, f"{pre}.attn.{w}.wq",
                                       target_param=f"{pre}.attn.{w}")
            a1 = gb.add(f"{pre}.add1", [resid, attn])
            gb.norm(f"{pre}.ln1", scale=f"{pre}.ln1.scale",
                    bias=f"{pre}.ln1.bias", after=a1)
            fc1 = gb.linear(f"{pre}.mlp.fc1", f"{pre}.mlp.w1",
                            bias=f"{pre}.mlp.b1", out_dim=self.F,
                            after=f"{pre}.ln1")
            gb.attach_weight_quant(fc1, f"{pre}.mlp.w1.wq")
            act = gb.act(f"{pre}.mlp.gelu")
            fc2 = gb.linear(f"{pre}.mlp.fc2", f"{pre}.mlp.w2",
                            bias=f"{pre}.mlp.b2", out_dim=self.D,
                            non_prunable=True, after=act)
            if act_quant:
                gb.insert_act_quant(act, fc2, f"{pre}.mlp.gelu.aq")
            gb.attach_weight_quant(fc2, f"{pre}.mlp.w2.wq")
            a2 = gb.add(f"{pre}.add2", [f"{pre}.ln1", fc2])
            gb.norm(f"{pre}.ln2", scale=f"{pre}.ln2.scale",
                    bias=f"{pre}.ln2.bias", after=a2)
            resid = f"{pre}.ln2"
        head = gb.linear("qa_head", "qa_head.w", bias="qa_head.b",
                         out_dim=2, non_prunable=True, after=resid)
        gb.attach_weight_quant(head, "qa_head.w.wq")
        gb.output("out")
        return gb

    def quant_weight_names(self):
        names = []
        for i in range(self.L):
            pre = f"enc.{i}"
            names += [f"{pre}.attn.{w}" for w in ("wq", "wk", "wv", "wo")]
            names += [f"{pre}.mlp.w1", f"{pre}.mlp.w2"]
        names.append("qa_head.w")
        return names

    def init_qparams(self, params, bits_init=8.0, act_quant=False):
        """Weight sites from each weight's max|w| and, with `act_quant`,
        the GELU sites at q_m = 4, all at `bits_init`, on the params'
        device. (The encoder's forward quantizes weights only, as the JAX
        package's does: the GELU sites shape the graph and QASSO's bit
        ranges.)"""
        qp = {name + ".wq": init_quant_params(params[name], bits=bits_init)
              for name in self.quant_weight_names()}
        if act_quant:
            q_m = torch.tensor(4.0, device=params["embed"].device)
            for i in range(self.L):
                qp[f"enc.{i}.mlp.gelu.aq"] = init_quant_params(
                    q_m=q_m, bits=bits_init)
        return qp

    def layer_macs(self, batch: int, seq: int) -> list[LayerMacs]:
        out = []
        toks = float(batch * seq)
        for i in range(self.L):
            pre = f"enc.{i}"
            for w in ("wq", "wk", "wv", "wo"):
                out.append(LayerMacs(f"{pre}.attn", toks * self.D * self.D,
                                     f"{pre}.attn.{w}"))
            out.append(LayerMacs(f"{pre}.mlp.fc1", toks * self.D * self.F,
                                 f"{pre}.mlp.w1"))
            out.append(LayerMacs(f"{pre}.mlp.fc2", toks * self.F * self.D,
                                 f"{pre}.mlp.w2"))
        out.append(LayerMacs("qa_head", toks * self.D * 2, "qa_head.w"))
        return out
