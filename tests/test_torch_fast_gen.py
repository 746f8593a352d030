"""The port's serving path against the JAX package: FastGenerator, the
ensemble, the package's freedom from JAX, and the chip smoke script's
refusal to run without a card."""

import inspect
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depgan_tpu.eval.predict import EnsemblePredictor as JaxEnsemblePredictor
from depgan_tpu.eval.predict import reconstruct_follow_up as jax_reconstruct
from depgan_tpu.models import GenUNet2D as FlaxGenUNet2D
from depgan_tpu.ops.fast_gen import FastGenerator as JaxFastGenerator
from depgan_tpu_torch import cli, drivers
from depgan_tpu_torch.eval.predict import EnsemblePredictor, reconstruct_follow_up
from depgan_tpu_torch.eval.runner import run_gan_testing, run_uresnet_testing
from depgan_tpu_torch.io.flax_bridge import load_flax_variables
from depgan_tpu_torch.models import GenUNet2D
from depgan_tpu_torch.ops import conv_s2d
from depgan_tpu_torch.ops.fast_gen import FastGenerator
from depgan_tpu_torch.train.gan_trainer import GanTrainer
from depgan_tpu_torch.train.uresnet_trainer import UResNetTrainer
from test_torch_models import CONFIGS, _map, inputs, jax_cfg, randomized_variables

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", ["tanh", "softmax"])
def test_fast_generator_matches_jax(name):
    cfg = CONFIGS[name]
    variables = randomized_variables(cfg, seed=5)
    x, z = inputs(cfg)
    jax_fast = JaxFastGenerator(jax_cfg(cfg), _map(jnp.asarray, variables),
                                pallas_levels=(1, 2), compute_dtype=jnp.float32)
    ref_fast = np.asarray(jax_fast(jnp.asarray(x), jnp.asarray(z)))
    # The port's plain generator, which test_torch_models holds to the Flax
    # module's apply at the same tolerance.
    plain = load_flax_variables(GenUNet2D(cfg), variables).eval()
    with torch.no_grad():
        ref = plain(torch.from_numpy(x), torch.from_numpy(z)).numpy()

    conv_s2d.reset_launch_counts()
    fast = FastGenerator(cfg, variables, compute_dtype=torch.float32, device="cpu")
    out = fast(torch.from_numpy(x), torch.from_numpy(z)).numpy()
    # CPU tensors take the plain versions: no kernel was launched.
    assert not any(conv_s2d.launches().values())
    assert out.shape == (2, 32, 32, cfg.n_out)
    np.testing.assert_allclose(out, ref_fast, atol=2e-4)
    np.testing.assert_allclose(out, ref, atol=2e-4)


def test_ensemble_matches_jax():
    cfg = CONFIGS["tanh"]
    variables = randomized_variables(cfg, seed=9)
    rng = np.random.default_rng(2)
    x = rng.uniform(size=(3, 32, 32, 1)).astype(np.float32)
    mask = (rng.uniform(size=(3, 32, 32)) > 0.3).astype(np.float32)
    noises = rng.normal(size=(2, 3, cfg.noise_size, 1)).astype(np.float32)

    jax_pred = JaxEnsemblePredictor(FlaxGenUNet2D(jax_cfg(cfg)), _map(jnp.asarray, variables),
                                    n_repeat=2)
    ref = np.asarray(jax_pred._ensemble(jax_pred.variables, jnp.asarray(x),
                                        jnp.asarray(noises), jnp.asarray(mask)))
    for fast in (False, True):
        pred = EnsemblePredictor(cfg, variables, n_repeat=2, fast=fast,
                                 compute_dtype=torch.float32, device="cpu")
        out = pred._ensemble(torch.from_numpy(x), torch.from_numpy(noises),
                             torch.from_numpy(mask)).numpy()
        np.testing.assert_allclose(out, ref, atol=2e-4, err_msg=f"fast={fast}")
    assert not out[mask == 0].any()


def test_predict_draws_seeded_noise():
    cfg = CONFIGS["softmax"]
    variables = randomized_variables(cfg, seed=4)
    x, _ = inputs(cfg)
    mask = np.ones((2, 32, 32), np.float32)
    first = EnsemblePredictor(cfg, variables, n_repeat=2, seed=3, device="cpu").predict(x, mask)
    again = EnsemblePredictor(cfg, variables, n_repeat=2, seed=3, device="cpu")
    np.testing.assert_array_equal(again.predict(x, mask), first)
    assert not np.array_equal(again.predict(x, mask), first)  # fresh noise per call
    np.testing.assert_allclose(first.sum(-1), 1.0, atol=1e-5)

    y1 = np.linspace(-1, 1, 12, dtype=np.float32)
    dem = np.linspace(1, -0.5, 12, dtype=np.float32)
    np.testing.assert_array_equal(reconstruct_follow_up(y1, dem), jax_reconstruct(y1, dem))


def test_entry_points_default_to_cuda():
    """The port's entry points run on the card unless the caller asks for
    the CPU, as these tests do."""
    for entry in (EnsemblePredictor, FastGenerator, GanTrainer, UResNetTrainer,
                  run_gan_testing, run_uresnet_testing, drivers.run_gan_training,
                  drivers.run_uresnet_training):
        assert inspect.signature(entry).parameters["device"].default == "cuda", entry
    for cmd in ("test-gan", "test-uresnet"):
        assert cli.build_parser().parse_args([cmd, "--weights", "w.h5"]).device == "cuda"
    for args in (["train-gan"], ["train-uresnet"], ["import-weights", "--h5", "w.h5"]):
        assert cli.build_parser().parse_args(args).device == "cuda"


def test_port_imports_no_jax():
    """Nothing of JAX, Flax or the JAX package loads with the port, and
    neither h5py nor sklearn, which the card's machine lacks (the .h5
    import and export load h5py when called; the training split is
    numpy), nor Pillow (loaded when an image is logged)."""
    code = ("import sys; import depgan_tpu_torch.eval.predict, depgan_tpu_torch.ops.fast_gen, "
            "depgan_tpu_torch.io.flax_bridge, depgan_tpu_torch.models, "
            "depgan_tpu_torch.ops.fast_critic, depgan_tpu_torch.train.gan_trainer, "
            "depgan_tpu_torch.benchmarks, depgan_tpu_torch.train.uresnet_trainer, "
            "depgan_tpu_torch.ops.film, depgan_tpu_torch.data.pipeline, "
            "depgan_tpu_torch.data.preprocess, depgan_tpu_torch.utils.profiling, "
            "depgan_tpu_torch.ops.conv_s2d, depgan_tpu_torch.ops._cuda, "
            "depgan_tpu_torch.ops.wgmma_plan, depgan_tpu_torch.ops.probes, "
            "depgan_tpu_torch.data.manifest, depgan_tpu_torch.data.nifti, "
            "depgan_tpu_torch.data.native, depgan_tpu_torch.data.dataset, "
            "depgan_tpu_torch.eval.metrics, depgan_tpu_torch.eval.writers, "
            "depgan_tpu_torch.eval.runner, depgan_tpu_torch.io.h5_import, "
            "depgan_tpu_torch.drivers, depgan_tpu_torch.cli, depgan_tpu_torch.config, "
            "depgan_tpu_torch.io.checkpoint, depgan_tpu_torch.utils.logging, "
            "depgan_tpu_torch.utils.tb_writer; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "             ('jax', 'flax', 'jaxlib', 'depgan_tpu', 'h5py', 'sklearn', 'PIL')); "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_fails_without_cuda():
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["CUDA_VISIBLE_DEVICES"] = ""  # hides any card: the script must refuse
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
