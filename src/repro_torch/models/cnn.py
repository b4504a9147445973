"""CNN family (VGG7, ResNet20/56), port of `repro.models.cnn`: the
paper's own experiment substrate.

Built per layer: every conv gets its own trace-graph vertex, attached
weight-quant branch, optional inserted act-quant branch, per-layer
(d, q_m, t) site and per-layer pruning families, the same graph as the
JAX package's, so QADG derives the same families and sites.

Layouts are the JAX package's: NHWC activations, HWIO conv weights, (in,
out) fc weights; QADG's member axes index them. `conv2d` and `maxpool`
permute to NCHW / OIHW only around `F.conv2d` / `F.max_pool2d` (an NHWC
tensor seen as NCHW is channels-last, so the convolution's output comes
back NHWC-contiguous) and pad "SAME" as XLA does: at stride 2 on an even
size, 0 before and 1 after. Convolutions and fc products are plain
PyTorch, as they were plain XLA in the JAX package; the weights and the
activation sites go through `core.quant.fake_quant`, which on a CUDA
tensor launches the fake-quant kernels. BatchNorm normalises with the
batch's statistics (population variance, no running buffers).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.bops import LayerMacs
from repro_torch.core.graph import GraphBuilder
from repro_torch.core.quant import fake_quant, init_quant_params
from repro_torch.models.layers import pick


def _same_pads(n: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: (before, after)."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
           padding: str = "SAME") -> torch.Tensor:
    """x (N, H, W, Cin) NHWC, w (kh, kw, Cin, Cout) HWIO -> NHWC."""
    kh, kw = w.shape[0], w.shape[1]
    pad = 0
    if padding == "SAME":
        (hb, ha), (wb, wa) = (_same_pads(x.shape[1], kh, stride),
                              _same_pads(x.shape[2], kw, stride))
        if hb == ha and wb == wa:
            pad = (hb, wb)
        else:
            x = F.pad(x, (0, 0, wb, wa, hb, ha))
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1).contiguous()


def batchnorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    mu = torch.mean(x, dim=(0, 1, 2), keepdim=True)
    var = torch.var(x, dim=(0, 1, 2), keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def maxpool(x: torch.Tensor, k: int = 2) -> torch.Tensor:
    """k x k max pool at stride k, "VALID", NHWC."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), k, k)
    return y.permute(0, 2, 3, 1).contiguous()


def _qw(params, qparams, name):
    w = params[name]
    site = name + ".wq"
    if qparams is not None and site in qparams:
        qp = qparams[site]
        w = fake_quant(w, qp.d, qp.q_m, qp.t)
    return w


def _qa(x, qparams, site):
    if qparams is not None and site in qparams:
        qp = qparams[site]
        x = fake_quant(x, qp.d, qp.q_m, qp.t)
    return x


@dataclasses.dataclass
class CNNSpec:
    name: str
    kind: str                 # "vgg" | "resnet"
    widths: list              # vgg: conv widths; resnet: stage widths
    blocks_per_stage: int = 3  # resnet
    fc_dim: int = 1024         # vgg classifier hidden
    num_classes: int = 10
    in_hw: int = 32


VGG7 = CNNSpec("vgg7", "vgg", [128, 128, 256, 256, 512, 512])
RESNET20 = CNNSpec("resnet20", "resnet", [16, 32, 64], blocks_per_stage=3)
RESNET56 = CNNSpec("resnet56", "resnet", [16, 32, 64], blocks_per_stage=9)


class CNN:
    def __init__(self, spec: CNNSpec):
        self.spec = spec
        self._plan = self._build_plan()

    # ------------------------------------------------------------- plan
    def _build_plan(self):
        """List of op dicts; shared by init / apply / graph / macs."""
        s = self.spec
        plan = []
        if s.kind == "vgg":
            cin, hw = 3, s.in_hw
            for i, w in enumerate(s.widths):
                plan.append(dict(op="conv", name=f"conv{i}", cin=cin, cout=w,
                                 k=3, stride=1, hw=hw))
                plan.append(dict(op="bn", name=f"bn{i}", c=w))
                plan.append(dict(op="relu", name=f"relu{i}"))
                if i % 2 == 1:
                    plan.append(dict(op="pool", name=f"pool{i}"))
                    hw //= 2
                cin = w
            plan.append(dict(op="flatten", name="flatten",
                             factor=hw * hw))
            plan.append(dict(op="fc", name="fc0", cin=cin * hw * hw,
                             cout=s.fc_dim))
            plan.append(dict(op="relu", name="fc0.relu"))
            plan.append(dict(op="fc", name="fc1", cin=s.fc_dim,
                             cout=s.num_classes, final=True))
        else:  # resnet (CIFAR style: 3 stages)
            hw = s.in_hw
            plan.append(dict(op="conv", name="stem", cin=3, cout=s.widths[0],
                             k=3, stride=1, hw=hw))
            plan.append(dict(op="bn", name="stem.bn", c=s.widths[0]))
            plan.append(dict(op="relu", name="stem.relu"))
            cin = s.widths[0]
            for st, w in enumerate(s.widths):
                for b in range(s.blocks_per_stage):
                    stride = 2 if (st > 0 and b == 0) else 1
                    if stride == 2:
                        hw //= 2
                    pre = f"s{st}b{b}"
                    plan.append(dict(op="block", name=pre, cin=cin, cout=w,
                                     stride=stride, hw=hw,
                                     proj=(cin != w or stride != 1)))
                    cin = w
            plan.append(dict(op="gap", name="gap"))
            plan.append(dict(op="fc", name="fc", cin=cin,
                             cout=s.num_classes, final=True))
        return plan

    # ------------------------------------------------------------- params
    def init(self, gen: torch.Generator) -> dict:
        """f32 params on `gen.device`, drawn from the torch RNG (not held
        to the JAX package's `jax.random` numbers)."""
        params = {}
        dev = gen.device

        def normal(shape, std):
            return torch.randn(shape, generator=gen, device=dev) * std

        def conv_init(name, k, cin, cout):
            params[f"{name}.w"] = normal((k, k, cin, cout),
                                         (k * k * cin) ** -0.5)

        def bn_init(name, c):
            params[f"{name}.scale"] = torch.ones((c,), device=dev)
            params[f"{name}.bias"] = torch.zeros((c,), device=dev)

        for item in self._plan:
            if item["op"] == "conv":
                conv_init(item["name"], item["k"], item["cin"], item["cout"])
            elif item["op"] == "bn":
                bn_init(item["name"], item["c"])
            elif item["op"] == "fc":
                params[f"{item['name']}.w"] = normal(
                    (item["cin"], item["cout"]), item["cin"] ** -0.5)
                params[f"{item['name']}.b"] = torch.zeros((item["cout"],),
                                                          device=dev)
            elif item["op"] == "block":
                n, cin, cout = item["name"], item["cin"], item["cout"]
                conv_init(f"{n}.conv1", 3, cin, cout)
                bn_init(f"{n}.bn1", cout)
                conv_init(f"{n}.conv2", 3, cout, cout)
                bn_init(f"{n}.bn2", cout)
                if item["proj"]:
                    conv_init(f"{n}.proj", 1, cin, cout)
                    bn_init(f"{n}.bn_proj", cout)
        return params

    # -------------------------------------------------------------- apply
    def apply(self, params, qparams, x):
        for item in self._plan:
            op, n = item["op"], item["name"]
            if op == "conv":
                x = conv2d(x, _qw(params, qparams, f"{n}.w"),
                           stride=item.get("stride", 1))
            elif op == "bn":
                x = batchnorm(x, params[f"{n}.scale"], params[f"{n}.bias"])
            elif op == "relu":
                x = _qa(torch.relu(x), qparams, f"{n}.aq")
            elif op == "pool":
                x = maxpool(x)
            elif op == "flatten":
                x = x.reshape(x.shape[0], -1)
            elif op == "gap":
                x = torch.mean(x, dim=(1, 2))
            elif op == "fc":
                x = x @ _qw(params, qparams, f"{n}.w") + params[f"{n}.b"]
            elif op == "block":
                sc = x
                h = conv2d(x, _qw(params, qparams, f"{n}.conv1.w"),
                           stride=item["stride"])
                h = batchnorm(h, params[f"{n}.bn1.scale"],
                              params[f"{n}.bn1.bias"])
                h = _qa(torch.relu(h), qparams, f"{n}.relu1.aq")
                h = conv2d(h, _qw(params, qparams, f"{n}.conv2.w"))
                h = batchnorm(h, params[f"{n}.bn2.scale"],
                              params[f"{n}.bn2.bias"])
                if item["proj"]:
                    sc = conv2d(sc, _qw(params, qparams, f"{n}.proj.w"),
                                stride=item["stride"])
                    sc = batchnorm(sc, params[f"{n}.bn_proj.scale"],
                                   params[f"{n}.bn_proj.bias"])
                x = _qa(torch.relu(h + sc), qparams, f"{n}.out.aq")
        return x

    def loss(self, params, qparams, batch):
        logits = self.apply(params, qparams, batch["images"]).to(
            torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        return torch.mean(logz - pick(logits, batch["labels"]))

    def accuracy(self, params, qparams, batch):
        logits = self.apply(params, qparams, batch["images"])
        return torch.mean((torch.argmax(logits, -1)
                           == batch["labels"]).to(torch.float32))

    # -------------------------------------------------------------- graph
    def build_graph(self, act_quant: bool = False) -> GraphBuilder:
        gb = GraphBuilder()
        gb.input("in")
        pending_act = None     # last relu vertex awaiting act-quant insertion

        def wire_act_quant(consumer_vid):
            # the inserted branch goes between the activation and its
            # *immediate* consumer (paper Fig 2b)
            nonlocal pending_act
            if act_quant and pending_act is not None:
                gb.insert_act_quant(pending_act, consumer_vid,
                                    f"{pending_act}.aq")
            pending_act = None

        for item in self._plan:
            op, n = item["op"], item["name"]
            if op == "conv":
                vid = gb.conv(n, f"{n}.w", out_dim=item["cout"])
                wire_act_quant(vid)
                gb.attach_weight_quant(n, f"{n}.w.wq")
            elif op == "bn":
                gb.bn(n, f"{n}.scale", f"{n}.bias")
            elif op == "relu":
                gb.act(n)
                pending_act = n
            elif op == "pool":
                gb.pool(n)
                wire_act_quant(n)
            elif op == "flatten":
                gb.pool(n, flatten_factor=item["factor"],
                        flatten_layout="interleaved")
                wire_act_quant(n)
            elif op == "gap":
                gb.pool(n)
                wire_act_quant(n)
            elif op == "fc":
                vid = gb.linear(n, f"{n}.w", bias=f"{n}.b",
                                out_dim=item["cout"],
                                non_prunable=item.get("final", False))
                wire_act_quant(vid)
                gb.attach_weight_quant(n, f"{n}.w.wq")
            elif op == "block":
                entry = gb._last
                c1 = gb.conv(f"{n}.conv1", f"{n}.conv1.w",
                             out_dim=item["cout"], after=entry)
                wire_act_quant(c1)
                gb.attach_weight_quant(c1, f"{n}.conv1.w.wq")
                gb.bn(f"{n}.bn1", f"{n}.bn1.scale", f"{n}.bn1.bias")
                r1 = gb.act(f"{n}.relu1")
                c2 = gb.conv(f"{n}.conv2", f"{n}.conv2.w",
                             out_dim=item["cout"], after=r1)
                if act_quant:
                    gb.insert_act_quant(r1, c2, f"{n}.relu1.aq")
                gb.attach_weight_quant(c2, f"{n}.conv2.w.wq")
                b2 = gb.bn(f"{n}.bn2", f"{n}.bn2.scale", f"{n}.bn2.bias")
                if item["proj"]:
                    pj = gb.conv(f"{n}.proj", f"{n}.proj.w",
                                 out_dim=item["cout"], after=entry)
                    gb.attach_weight_quant(pj, f"{n}.proj.w.wq")
                    sc = gb.bn(f"{n}.bn_proj", f"{n}.bn_proj.scale",
                               f"{n}.bn_proj.bias", after=pj)
                else:
                    sc = entry
                ad = gb.add(f"{n}.add", [b2, sc])
                gb.act(f"{n}.out", after=ad)
                pending_act = f"{n}.out"
        gb.output("out")
        return gb

    # ------------------------------------------------------------- quant
    def quant_weight_names(self) -> list[str]:
        names = []
        for item in self._plan:
            op, n = item["op"], item["name"]
            if op in ("conv", "fc"):
                names.append(f"{n}.w")
            elif op == "block":
                names += [f"{n}.conv1.w", f"{n}.conv2.w"]
                if item["proj"]:
                    names.append(f"{n}.proj.w")
        return names

    def act_site_names(self) -> list[str]:
        """The activation sites `init_qparams(act_quant=True)` adds, in
        its order."""
        names = []
        for item in self._plan:
            op, n = item["op"], item["name"]
            if op == "relu":
                names.append(f"{n}.aq")
            elif op == "block":
                names += [f"{n}.relu1.aq", f"{n}.out.aq"]
        return names

    def init_qparams(self, params, bits_init=32.0, act_quant=False):
        """Weight sites from each weight's max|w| and, with `act_quant`,
        activation sites at q_m = 4, all at `bits_init`, on the params'
        device."""
        qp = {name + ".wq": init_quant_params(params[name], bits=bits_init)
              for name in self.quant_weight_names()}
        if act_quant:
            q_m = torch.tensor(4.0, device=next(iter(params.values())).device)
            for site in self.act_site_names():
                qp[site] = init_quant_params(q_m=q_m, bits=bits_init)
        return qp

    # -------------------------------------------------------------- bops
    def layer_macs(self, batch: int = 1) -> list[LayerMacs]:
        out = []
        for item in self._plan:
            op, n = item["op"], item["name"]
            if op == "conv":
                hw = item["hw"] // item.get("stride", 1)
                out.append(LayerMacs(
                    n, float(batch) * hw * hw * item["k"] ** 2
                    * item["cin"] * item["cout"], f"{n}.w"))
            elif op == "fc":
                out.append(LayerMacs(n, float(batch) * item["cin"]
                                     * item["cout"], f"{n}.w"))
            elif op == "block":
                hw = item["hw"]
                cin, cout = item["cin"], item["cout"]
                out.append(LayerMacs(f"{n}.conv1", float(batch) * hw * hw
                                     * 9 * cin * cout, f"{n}.conv1.w"))
                out.append(LayerMacs(f"{n}.conv2", float(batch) * hw * hw
                                     * 9 * cout * cout, f"{n}.conv2.w"))
                if item["proj"]:
                    out.append(LayerMacs(f"{n}.proj", float(batch) * hw * hw
                                         * cin * cout, f"{n}.proj.w"))
        return out
