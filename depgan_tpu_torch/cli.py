"""Command-line interface of the port.

Counterpart of ``depgan_tpu/cli.py`` (:30-268), with the same subcommands,
flags and defaults but for the ones listed below:

    python -m depgan_tpu_torch.cli train-gan      --manifest-dir train_data_server_fold
    python -m depgan_tpu_torch.cli train-uresnet  --manifest-dir train_data_server_fold
    python -m depgan_tpu_torch.cli test-gan       --weights 'models/netG_depgan_fold{fold}.h5'
    python -m depgan_tpu_torch.cli test-uresnet   --weights 'models/trained_depuresnet_fold{fold}.h5'
    python -m depgan_tpu_torch.cli import-weights --h5 netG.h5 --out vars.pt
    python -m depgan_tpu_torch.cli bench          --what gen-inference|uresnet-inference|gan-step
    python -m depgan_tpu_torch.cli train-gan --device cpu ...   # on the CPU, plain versions

``--device`` takes the place of JAX's ``--platform`` and defaults to the
card. The training subcommands leave out ``--n-data`` and
``--folds-parallel`` (more than one device); ``import-weights --out``
writes the imported tree with ``torch.save`` in place of flax's msgpack.
``--use-pallas`` trains through the fused superstep (K1, K3-K7) and runs K8
at the plain generator's FiLM sites (validation, ``--bn-mode batch``,
``train-uresnet``, plain testing); ``--fast`` serves through
``FastGenerator`` (folded BN, the s2d kernels, a bfloat16 trunk), without
it ``GenUNet2D``'s eval forward on BN-folded weights (``models/folded.py``)
runs in ``--bf16``'s dtype. ``--first-fm``
widths that no kernel takes run their sites' plain versions, with a
warning (``ops/fast_gen.py``'s width gate). Reading or writing ``.h5``
weights needs h5py.
"""

from __future__ import annotations

import argparse
import json
import sys

from .config import DataConfig, EvalConfig, GanTrainConfig, ModelConfig, UResNetTrainConfig


def _add_common(p: argparse.ArgumentParser, train_manifests: bool) -> None:
    default_dir = "train_data_server_fold" if train_manifests else "test_data_server_fold"
    p.add_argument("--manifest-dir", default=default_dir)
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
                   help="train through the fused superstep's kernels (K1, K3-K7), and run "
                        "the plain module's FiLM sites through the film_residual kernel (K8)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 trunk of the training networks and of the plain module")
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

    p = sub.add_parser("train-gan", help="two-critic WGAN-GP training, 4-fold")
    _add_common(p, train_manifests=True)
    p.add_argument("--run-name", default="depgan_twoCritics")
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--d-iters", type=int, default=5)
    p.add_argument("--bn-mode", choices=("frozen", "batch"), default="frozen")
    p.add_argument("--threshold-mode", choices=("hard", "soft"), default="hard")
    p.add_argument("--checkpoint-every", type=int, default=100)
    p.add_argument("--reset-counters-per-fold", action="store_true")
    p.add_argument("--model-dir", default="models")
    p.add_argument("--log-dir", default="logdir")

    p = sub.add_parser("train-uresnet", help="supervised 4-class training, 4-fold")
    _add_common(p, train_manifests=True)
    p.add_argument("--run-name", default="depuresnet_pNoises")
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--model-dir", default="models")
    p.add_argument("--log-dir", default="logs")

    p = sub.add_parser("test-gan", help="GAN inference + evaluation, 4-fold")
    _add_common(p, train_manifests=False)
    p.add_argument("--weights", required=True,
                   help="pattern with {fold}, e.g. models/netG_x_fold{fold}.h5")
    p.add_argument("--out-dir", default="outputs/depgan")
    p.add_argument("--n-repeat", type=int, default=10)
    p.add_argument("--fast", action="store_true",
                   help="FastGenerator inference (folded BN + the fused s2d kernels, "
                        "bfloat16 trunk), within 0.05 of the plain module's maps. "
                        "Default OFF = the plain module's numerics.")

    p = sub.add_parser("test-uresnet", help="UResNet inference + evaluation, 4-fold")
    _add_common(p, train_manifests=False)
    p.add_argument("--weights", required=True)
    p.add_argument("--out-dir", default="outputs/depuresnet")
    p.add_argument("--n-repeat", type=int, default=10)
    p.add_argument("--fast", action="store_true",
                   help="FastGenerator inference (softmax variant). Default OFF = the "
                        "plain module's numerics.")

    p = sub.add_parser("import-weights",
                       help="Keras .h5 -> Flax-layout variables (optionally saved)")
    _add_common(p, train_manifests=False)
    p.add_argument("--h5", required=True)
    p.add_argument("--n-out", type=int, default=1)
    p.add_argument("--out", default=None,
                   help="write the imported variables with torch.save, e.g. vars.pt")

    p = sub.add_parser("bench", help="throughput benchmarks on the card (one JSON line)")
    p.add_argument("--what", choices=("gen-inference", "uresnet-inference", "gan-step"),
                   default="gen-inference")
    return parser


def _tensor_tree(tree: dict) -> dict:
    import torch

    return {k: _tensor_tree(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.cmd == "train-gan":
        from . import drivers

        cfg = GanTrainConfig(batch_size=args.batch_size, n_epochs=args.epochs,
                             d_iters=args.d_iters, bn_mode=args.bn_mode,
                             threshold_mode=args.threshold_mode,
                             checkpoint_every=args.checkpoint_every,
                             reset_counters_per_fold=args.reset_counters_per_fold)
        drivers.run_gan_training(_model_cfg(args), cfg, _data_cfg(args), run_name=args.run_name,
                                 folds=tuple(args.folds), log_dir=args.log_dir,
                                 model_dir=args.model_dir, device=args.device)
    elif args.cmd == "train-uresnet":
        from . import drivers

        cfg = UResNetTrainConfig(batch_size=args.batch_size, n_epochs=args.epochs)
        drivers.run_uresnet_training(_model_cfg(args, n_out=4, dropout="uresnet"), cfg,
                                     _data_cfg(args), run_name=args.run_name,
                                     folds=tuple(args.folds), log_dir=args.log_dir,
                                     model_dir=args.model_dir, device=args.device)
    elif args.cmd in ("test-gan", "test-uresnet"):
        from . import drivers
        from .eval.runner import run_gan_testing, run_uresnet_testing

        if args.cmd == "test-gan":
            eval_cfg = EvalConfig(n_repeat=args.n_repeat, use_probability_map=args.pm,
                                  n_input_channels=args.nicg, output_dir=args.out_dir,
                                  fast=args.fast)
            mc = _model_cfg(args)
            run = run_gan_testing
        else:
            eval_cfg = EvalConfig(n_repeat=args.n_repeat, output_dir=args.out_dir,
                                  fast=args.fast)
            mc = _model_cfg(args, n_out=4, dropout="uresnet")
            run = run_uresnet_testing
        results = run(mc, _data_cfg(args), eval_cfg, drivers.generator_loader(mc, args.weights),
                      folds=tuple(args.folds), device=args.device)
        print(json.dumps({"subjects": len(results)}))
    elif args.cmd == "import-weights":
        from .io import h5_import
        from .models import init_generator

        mc = _model_cfg(args, n_out=args.n_out, dropout="gan" if args.n_out == 1 else "uresnet")
        variables = h5_import.import_keras_h5(args.h5, init_generator(mc, seed=0))
        if args.out:
            import torch

            torch.save(_tensor_tree(variables), args.out)
        print(json.dumps({"status": "ok", "h5": args.h5, "out": args.out}))
    elif args.cmd == "bench":
        from . import benchmarks

        if args.what == "gan-step":
            b = benchmarks.gan_step_bench()
            result = {"metric": "gan_superstep_wall", "value": round(b["ms_per_superstep"], 1),
                      "unit": "ms/superstep", "reps_ms": b["reps_ms"], "launches": b["launches"]}
        else:
            result = {"gen-inference": benchmarks.gen_inference_bench,
                      "uresnet-inference": benchmarks.uresnet_inference_bench}[args.what]()
        print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
