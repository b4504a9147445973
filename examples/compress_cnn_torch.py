"""Compress a CNN (the paper's Table 2/4 setting) on synthetic CIFAR with
the PyTorch/CUDA port: the twin of `examples/compress_cnn.py`.

Joint structured pruning + mixed-precision QAT on ResNet20 (the reduced
widths by default, `--spec full` for the paper's), reporting accuracy and
relative BOPs against the FP32 baseline. Runs on CUDA (the fake-quant
kernels); `--device cpu` runs their plain PyTorch versions.

    PYTHONPATH=src python examples/compress_cnn_torch.py [--steps 240] \
        [--spec reduced|full] [--act-quant] [--device cpu]
"""
import argparse


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=160)
    ap.add_argument("--sparsity", type=float, default=0.35)
    ap.add_argument("--act-quant", action="store_true")
    ap.add_argument("--spec", default="reduced", choices=["reduced", "full"])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args()

    from repro_torch.launch.experiments import (SPECS, run_baseline_cnn,
                                                run_geta_cnn)
    spec = SPECS[args.spec]["resnet20"]
    print(f"training FP32 baseline ({spec.name}) ...")
    base = run_baseline_cnn(spec, steps=args.steps, device=args.device)
    print(f"baseline: acc={base['acc']:.3f} rel_bops=1.0")
    print("training GETA joint compressed ...")
    geta = run_geta_cnn(spec, steps=args.steps, sparsity=args.sparsity,
                        act_quant=args.act_quant, device=args.device)
    print(f"GETA:     acc={geta['acc']:.3f} "
          f"rel_bops={geta['rel_bops']:.4f} "
          f"sparsity={geta['sparsity']:.2f} "
          f"mean_bits={geta['mean_bits']:.1f}")


if __name__ == "__main__":
    main()
