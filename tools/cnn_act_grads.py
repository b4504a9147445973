"""VGG7_R's gradients with activation quantizers, card against CPU, with
the CPU pass pinned to the card's activation-site inputs.

    PYTHONPATH=src python3 tools/cnn_act_grads.py

Run from the repo root on a CUDA card. For 6- and 16-bit quantizers
(weights and activation sites alike; VGG7 at the reduced widths of
`benchmarks/geta_experiments.py`, 8 images of `image_batch`, params from
a generator seeded with 0), without and with
`torch.use_deterministic_algorithms`, three passes of
`launch.train.loss_and_grads`: two on the card and one on the CPU, whose
activation sites quantize the first card pass's inputs (the gradient
flows to the CPU's own). Prints, for the second card pass and for the
CPU pass against the first card pass, the three params whose gradients
part most (max |diff| over the card's max |g|) and, per activation site,
how far the cotangent of its output parts (max |diff| over max |g|).
`tests/test_torch_gpu.py::test_substrate_loss_and_grads_card_vs_cpu`
pins batch norm's outputs too, for the reason these numbers show.
"""
import os

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

from repro_torch.data.synthetic import image_batch  # noqa: E402
from repro_torch.launch import train as T  # noqa: E402
from repro_torch.models import cnn  # noqa: E402


class _Pinned(torch.autograd.Function):
    """`value` forward; the identity's gradient to `x` backward."""

    @staticmethod
    def forward(ctx, x, value):
        return value.clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


def passes(m, p, q, batch, runs, deterministic):
    """`runs` = [(tag, device)], the first on the card: each tag's
    (loss, gx, gq) and each (tag, site)'s output cotangent."""
    torch.use_deterministic_algorithms(deterministic)
    card_in, cot, qa = {}, {}, cnn._qa
    tag = [None]

    def pinning_qa(h, qparams, site):
        if qparams is not None and site in qparams:
            if tag[0] == runs[0][0]:
                card_in[site] = h.detach().cpu()
            else:
                h = _Pinned.apply(h, card_in[site].to(h.device))
        out = qa(h, qparams, site)
        if qparams is not None and site in qparams:
            key = (tag[0], site)
            out.register_hook(
                lambda g: cot.__setitem__(key, g.detach().cpu()))
        return out

    cnn._qa = pinning_qa
    out = {}
    try:
        for tag[0], dev in runs:
            out[tag[0]] = T.loss_and_grads(
                m, {k: v.to(dev) for k, v in p.items()},
                {k: type(v)(*(t.to(dev) for t in (v.d, v.q_m, v.t)))
                 for k, v in q.items()},
                {k: v.to(dev) for k, v in batch.items()})
    finally:
        cnn._qa = qa
        torch.use_deterministic_algorithms(False)
    return out, cot


def main():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = cnn.CNNSpec("vgg7-r", "vgg", [16, 16, 32, 32, 64, 64],
                       fc_dim=128)
    m = cnn.CNN(spec)
    p = m.init(torch.Generator().manual_seed(0))
    batch = image_batch(0, 0, 8)
    runs = [("cuda0", "cuda"), ("cuda1", "cuda"), ("cpu", "cpu")]
    for bits in (6.0, 16.0):
        q = m.init_qparams(p, bits_init=bits, act_quant=True)
        for det in (False, True):
            out, cot = passes(m, p, q, batch, runs, det)
            for a, b in (("cuda1", "cuda0"), ("cpu", "cuda0")):
                ga, gb = out[a][1], out[b][1]
                gaps = {k: float((ga[k].cpu() - gb[k].cpu()).abs().max()
                                 / gb[k].abs().max()) for k in gb}
                worst = sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
                sites = {s: float((cot[(a, s)] - cot[(b, s)]).abs().max()
                                  / cot[(b, s)].abs().max())
                         for (t, s) in cot if t == b}
                print(f"bits {bits} deterministic {det} {a} vs {b}: worst "
                      f"grads {[(k, f'{v:.1e}') for k, v in worst]}, site "
                      f"cotangents {({k: f'{v:.1e}' for k, v in sites.items()})}",
                      flush=True)


if __name__ == "__main__":
    main()
