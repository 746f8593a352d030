"""Command-line interface of the port: the testing subcommands.

Counterpart of ``depgan_tpu/cli.py``'s ``test-gan`` and ``test-uresnet``
(:30-60, :112-140, :214-241), with the same flags; ``--device`` takes the
place of JAX's ``--platform`` and defaults to the card:

    python -m depgan_tpu_torch.cli test-gan     --weights 'models/netG_depgan_fold{fold}.h5'
    python -m depgan_tpu_torch.cli test-uresnet --weights 'models/trained_depuresnet_fold{fold}.h5'
    python -m depgan_tpu_torch.cli test-gan --device cpu ...   # on the CPU, plain versions

``--fast`` serves through ``FastGenerator`` (folded BN, the s2d kernels, a
bfloat16 trunk); without it the plain ``GenUNet2D`` runs in ``--bf16``'s
dtype. ``--first-fm`` widths that no kernel takes run their sites' plain
versions, with a warning (``ops/fast_gen.py``'s width gate). Reading
``--weights`` needs h5py.
"""

from __future__ import annotations

import argparse
import json
import sys

from .config import DataConfig, EvalConfig, ModelConfig


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--manifest-dir", default="test_data_server_fold")
    p.add_argument("--folds", type=int, nargs="+", default=[1, 2, 3, 4])
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--noise-size", type=int, default=32)
    p.add_argument("--first-fm", type=int, default=32)
    p.add_argument("--nicg", type=int, default=1, choices=(1, 2),
                   help="generator input channels: 1=map, 2=map+FLAIR")
    pm = p.add_mutually_exclusive_group()
    pm.add_argument("--pm", dest="pm", action="store_true", default=True,
                    help="probability maps (threshold 0.5, default)")
    pm.add_argument("--im", dest="pm", action="store_false",
                    help="irregularity maps (threshold 0.178)")
    p.add_argument("--use-pallas", action="store_true",
                   help="the plain module's FiLM sites through the film_residual kernel")
    p.add_argument("--bf16", action="store_true", help="bfloat16 trunk of the plain module")
    p.add_argument("--device", default="cuda",
                   help="torch device: the card by default, 'cpu' for the plain versions")


def _model_cfg(args, n_out=1, dropout="gan") -> ModelConfig:
    return ModelConfig(
        image_size=args.image_size,
        noise_size=args.noise_size,
        first_fm=args.first_fm,
        n_input_channels=args.nicg if n_out == 1 else 1,
        n_out=n_out,
        dropout_mode=dropout,
        compute_dtype="bfloat16" if args.bf16 else "float32",
        use_pallas=args.use_pallas,
    )


def _data_cfg(args) -> DataConfig:
    return DataConfig(
        manifest_dir=args.manifest_dir,
        image_size=args.image_size,
        n_input_channels=args.nicg,
        use_probability_map=args.pm,
    )


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="depgan_tpu_torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("test-gan", help="GAN inference + evaluation, 4-fold")
    _add_common(p)
    p.add_argument("--weights", required=True,
                   help="pattern with {fold}, e.g. models/netG_x_fold{fold}.h5")
    p.add_argument("--out-dir", default="outputs/depgan")
    p.add_argument("--n-repeat", type=int, default=10)
    p.add_argument("--fast", action="store_true",
                   help="FastGenerator inference (folded BN + the fused s2d kernels, "
                        "bfloat16 trunk), within 0.05 of the plain module's maps. "
                        "Default OFF = the plain module's numerics.")

    p = sub.add_parser("test-uresnet", help="UResNet inference + evaluation, 4-fold")
    _add_common(p)
    p.add_argument("--weights", required=True)
    p.add_argument("--out-dir", default="outputs/depuresnet")
    p.add_argument("--n-repeat", type=int, default=10)
    p.add_argument("--fast", action="store_true",
                   help="FastGenerator inference (softmax variant). Default OFF = the "
                        "plain module's numerics.")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from . import drivers
    from .eval.runner import run_gan_testing, run_uresnet_testing

    if args.cmd == "test-gan":
        eval_cfg = EvalConfig(n_repeat=args.n_repeat, use_probability_map=args.pm,
                              n_input_channels=args.nicg, output_dir=args.out_dir,
                              fast=args.fast)
        mc = _model_cfg(args)
        run = run_gan_testing
    else:
        eval_cfg = EvalConfig(n_repeat=args.n_repeat, output_dir=args.out_dir, fast=args.fast)
        mc = _model_cfg(args, n_out=4, dropout="uresnet")
        run = run_uresnet_testing
    results = run(mc, _data_cfg(args), eval_cfg, drivers.generator_loader(mc, args.weights),
                  folds=tuple(args.folds), device=args.device)
    print(json.dumps({"subjects": len(results)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
