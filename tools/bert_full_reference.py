"""The Table 3 GETA run on the full BERT encoder (`BertEncoder()`'s
defaults: 4 layers, d_model 256, vocab 8192) in both packages, on the
CPU: the JAX package's runner loop (`benchmarks/geta_experiments.py`'s
pieces, jitted step) and the port's `run_geta_bert(encoder=BERT_FULL)`.
Prints each run's loss every 10 steps and its exact match on the
held-out batch, to tell a port fault from what the schedule does to this
encoder.

    PYTHONPATH=src python3 tools/bert_full_reference.py [--steps 200]
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def reference(steps: int, sparsity: float, seq: int = 64):
    import jax

    import benchmarks.geta_experiments as G
    from repro.core.qadg import build_qadg
    from repro.core.qasso import QASSO
    from repro.data.synthetic import qa_batch
    from repro.models.bert import BertEncoder
    from repro.optim.schedules import constant
    model = BertEncoder(max_seq=seq)
    params = model.init(jax.random.PRNGKey(0))
    qparams = model.init_qparams(params, bits_init=8.0)
    qadg = build_qadg(model.build_graph().graph)
    cfg = G.qasso_cfg(steps, sparsity)
    qasso = QASSO(qadg.space, qadg.sites, cfg, constant(2e-3))
    state = qasso.init(params, qparams)

    @jax.jit
    def step(p, q, s, b):
        loss, (gx, gq) = jax.value_and_grad(model.loss, argnums=(0, 1))(
            p, q, b)
        return qasso.update(p, q, gx, gq, s) + (loss,)

    losses = []
    for i in range(cfg.total_steps):
        params, qparams, state, _, loss = step(
            params, qparams, state, qa_batch(0, i, 16, seq, model.V))
        losses.append(float(loss))
    test = qa_batch(1, 77_000, 128, seq, model.V)
    return losses, float(jax.jit(model.exact_match)(params, qparams, test))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--sparsity", type=float, default=0.3)
    args = ap.parse_args()
    import torch

    from repro_torch.launch import experiments as E
    torch.set_num_threads(4)
    port = E.run_geta_bert(args.sparsity, steps=args.steps,
                           encoder=E.BERT_FULL, device="cpu")
    ref = reference(args.steps, args.sparsity)
    for name, (losses, em) in (("JAX package", ref),
                               ("port", (port["losses"], port["em"]))):
        print(f"{name}: em {em:.4f}; loss every 10 steps "
              f"{[round(x, 3) for x in losses[::10]]}")


if __name__ == "__main__":
    main()
