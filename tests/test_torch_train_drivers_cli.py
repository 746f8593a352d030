"""The port's training drivers and CLI against the JAX package's: the
training folds read from the same NIfTI files, ``run_gan_training`` and
``run_uresnet_training`` for one epoch (what each writes, resume, the
checkpoint served through ``generator_loader`` and ``test-gan``), the
``train-*``, ``import-weights`` and ``bench`` parsers against JAX's
``cli.main`` parser, and the h5py check before the first step. Image 32,
first_fm 8, float32, on the CPU."""

import argparse
import json
import sys

import numpy as np
import pytest
import torch

from depgan_tpu import cli as jax_cli
from depgan_tpu.data import dataset as jax_dataset
from depgan_tpu_torch import benchmarks, cli, drivers
from depgan_tpu_torch.config import (DataConfig, GanTrainConfig, ModelConfig, UResNetTrainConfig,
                                     load_config)
from depgan_tpu_torch.data import dataset, manifest, nifti
from depgan_tpu_torch.io.checkpoint import CheckpointManager
from depgan_tpu_torch.io.flax_bridge import flatten_tree, numpy_tree
from depgan_tpu_torch.io.h5_import import import_keras_h5
from depgan_tpu_torch.models import init_generator
from depgan_tpu_torch.utils import tb_writer
from test_torch_data_eval import assert_same, write_fold

TRAIN_MODALITIES = tuple(dict.fromkeys(manifest.GAN_TRAIN_MODALITIES
                                       + manifest.URESNET_TRAIN_MODALITIES))
GAN = ModelConfig(image_size=32, first_fm=8)
URESNET = ModelConfig(image_size=32, first_fm=8, n_out=4, dropout_mode="uresnet")
GAN_TRAIN = GanTrainConfig(batch_size=2, n_epochs=1, d_iters=2, warmup_d_iters=3,
                           warmup_until=1, k_noise=2, validate_every=2, image_log_every=2,
                           n_val_images=2, checkpoint_every=2, metric_flush_every=3)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small tensors: under pytest-xdist,
    torch's threads contend with the other workers' for the cores, which
    slowed these fits ~50x; alone they run as fast on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_training_fold(root, n_subjects=2, size=32, n_slices=8, fold=1):
    """A synthetic training fold: every GAN and UResNet training modality
    of each subject as .nii.gz and the manifests; the sl_cleaned masks
    exist for the first subject only (an optional modality). Returns the
    manifest directory."""
    rng = np.random.default_rng(fold)
    mdir = root / "train_manifests"
    mdir.mkdir(exist_ok=True)
    lists = {m: [] for m in TRAIN_MODALITIES}
    shape = (size, size, n_slices)
    for s in range(n_subjects):
        sd = root / f"train_subj{s}"
        sd.mkdir(exist_ok=True)
        vols = {"flair_1tp": rng.uniform(0, 200, shape),
                "wmh_prob_1tp": rng.uniform(-0.1, 1, shape),
                "wmh_prob_2tp": rng.uniform(0, 1, shape),
                "icv_1tp": rng.uniform(size=shape) > 0.1, "icv_2tp": rng.uniform(size=shape) > 0.1,
                "sl_cleaned_1tp": rng.uniform(size=shape) > 0.9,
                "sl_cleaned_2tp": rng.uniform(size=shape) > 0.9,
                "wmh_subtracted_coded_2tp_1tp": rng.integers(0, 4, shape)}
        for m in TRAIN_MODALITIES:
            path = sd / f"{m}.nii.gz"
            if not m.startswith("sl_cleaned") or s == 0:
                nifti.save(vols[m].astype(np.float32), np.diag([1.2, 0.9, 3.0, 1.0]), path)
            lists[m].append(str(path))
    for m, paths in lists.items():
        (mdir / f"{m}_fold{fold}.txt").write_text("\n".join(paths) + "\n")
    return mdir


@pytest.mark.parametrize("kind", ["gan", "uresnet"])
def test_training_folds_match_jax(tmp_path, kind):
    """``load_*_training_fold`` and ``train_val_split`` (the numpy copy of
    sklearn's split) give JAX's arrays bit for bit."""
    mdir = write_training_fold(tmp_path)
    cfg = DataConfig(manifest_dir=str(mdir), image_size=32, val_fraction=0.2)
    name = f"load_{kind}_training_fold"
    ours = getattr(dataset, name)(cfg, 1)
    ref = getattr(jax_dataset, name)(cfg, 1)
    for a, b, what in zip(ours, ref, ("x", "y")):
        assert_same(a, b, what)
    for a, b, what in zip(dataset.train_val_split(*ours, 0.2, 42),
                          jax_dataset.train_val_split(*ref, 0.2, 42),
                          ("x_train", "x_val", "y_train", "y_val")):
        assert_same(a, b, what)


def _events(log_dir):
    (path,) = log_dir.glob("events.*")
    return tb_writer.read_events(path)


def test_run_gan_training_and_resume(tmp_path, capsys):
    """One epoch of ``run_gan_training``: the checkpoints of
    ``checkpoint_every`` and of the end, the ``.h5`` of the last, the
    event file with the first validation images, the graph and the
    scalars; a second run resumes the counters of the last checkpoint and
    continues them; ``generator_loader`` serves the checkpoint directory
    as the saved generator, and refuses a leaf of another shape."""
    mdir = write_training_fold(tmp_path, n_slices=10)
    data_cfg = DataConfig(manifest_dir=str(mdir), image_size=32, val_fraction=0.2)
    models, logs = tmp_path / "models", tmp_path / "logdir"
    kw = dict(run_name="r", folds=(1,), log_dir=str(logs), model_dir=str(models), device="cpu")
    states = drivers.run_gan_training(GAN, GAN_TRAIN, data_cfg, **kw)
    # 16 training slices, 8 batches: supersteps of 3, 2, 2, 1 (gi 0-3).
    ckpt = CheckpointManager(models / "r_fold1")
    assert ckpt.all_steps() == [2, 4]
    assert sorted(p.name for p in models.iterdir()) == ["netG_r_fold1.h5", "r_fold1"]
    got = import_keras_h5(str(models / "netG_r_fold1.h5"), init_generator(GAN, seed=1))
    want = {"params": numpy_tree(states[1].g_params), "batch_stats": numpy_tree(states[1].g_stats)}
    for k, v in flatten_tree(want).items():
        np.testing.assert_array_equal(flatten_tree(got)[k], v, err_msg=k)
    events = _events(logs / "r_fold1")
    tags = [(v[0], e["step"]) for e in events for v in e["values"]]
    assert tags[:2] == [("val_img_Y1_IM/0", 0), ("val_img_Y1_IM/1", 0)]
    assert ("val_D_real_generated_loss", 2) in tags and ("errCrit_aaLosses", 7) in tags
    assert sum(e["graph"] is not None for e in events) == 1
    _, counters, _ = ckpt.restore(states[1])
    assert (counters.gen_iterations, counters.crit_iterations) == (4, 8)

    capsys.readouterr()
    drivers.run_gan_training(GAN, GAN_TRAIN, data_cfg, **kw)
    assert "resumed fold 1 at gen_iteration 4" in capsys.readouterr().out
    assert ckpt.all_steps() == [4, 6, 8]  # gi 4-7 after the resume
    _, counters, _ = ckpt.restore(states[1])
    assert (counters.gen_iterations, counters.crit_iterations) == (8, 16)

    loaded = drivers.generator_loader(GAN, str(models / "r_fold{fold}"))(1)
    saved = CheckpointManager(models / "r_fold1").restore(states[1])[0]
    want = {"params": numpy_tree(saved.g_params), "batch_stats": numpy_tree(saved.g_stats)}
    assert flatten_tree(loaded).keys() == flatten_tree(want).keys()
    for k, v in flatten_tree(want).items():
        np.testing.assert_array_equal(flatten_tree(loaded)[k], v, err_msg=k)
    with pytest.raises(ValueError, match="has shape"):
        drivers.generator_loader(ModelConfig(image_size=32, first_fm=16),
                                 str(models / "r_fold{fold}"))(1)


def test_run_uresnet_training(tmp_path):
    """Two epochs of ``run_uresnet_training``: the model config, a loss
    line an epoch in each history, a checkpoint an epoch (the newest 3
    kept), and the ``.h5`` of the last."""
    mdir = write_training_fold(tmp_path)
    data_cfg = DataConfig(manifest_dir=str(mdir), image_size=32, val_fraction=0.2)
    models, logs = tmp_path / "models", tmp_path / "logs"
    states = drivers.run_uresnet_training(
        URESNET, UResNetTrainConfig(batch_size=4, n_epochs=2), data_cfg, run_name="u",
        folds=(1,), log_dir=str(logs), model_dir=str(models), device="cpu")
    assert load_config(ModelConfig, models / "model_u_fold1.json") == URESNET
    for name in ("loss_u_fold1.txt", "val_loss_u_fold1.txt"):
        values = np.loadtxt(logs / name)
        assert values.shape == (2,) and np.isfinite(values).all()
    ckpt = CheckpointManager(models / "u_fold1")
    assert ckpt.all_steps() == [0, 1]
    restored = ckpt.restore(states[1])[0]
    assert restored.epoch == 2
    got = import_keras_h5(str(models / "trained_u_fold1.h5"), init_generator(URESNET, seed=1))
    for k, v in flatten_tree(numpy_tree(states[1].params)).items():
        np.testing.assert_array_equal(flatten_tree(got["params"])[k], v, err_msg=k)


def test_cli_trains_and_serves_the_checkpoint(tmp_path, capsys):
    """``train-gan`` and ``train-uresnet`` with ``--device cpu`` train a
    fold for one epoch; ``test-gan --weights <checkpoint dir>`` serves the
    GAN's checkpoint; ``import-weights --out`` writes the imported tree."""
    mdir = write_training_fold(tmp_path)
    common = ["--device", "cpu", "--manifest-dir", str(mdir), "--folds", "1", "--image-size",
              "32", "--first-fm", "8", "--epochs", "1", "--batch-size", "4",
              "--model-dir", str(tmp_path / "models")]
    assert cli.main(["train-gan", *common, "--d-iters", "2", "--checkpoint-every", "1",
                     "--run-name", "g", "--log-dir", str(tmp_path / "logdir")]) == 0
    assert cli.main(["train-uresnet", *common, "--run-name", "u",
                     "--log-dir", str(tmp_path / "logs")]) == 0
    models = tmp_path / "models"
    assert {"netG_g_fold1.h5", "g_fold1", "trained_u_fold1.h5", "u_fold1",
            "model_u_fold1.json"} == {p.name for p in models.iterdir()}
    assert list((tmp_path / "logdir" / "g_fold1").glob("events.*"))
    assert (tmp_path / "logs" / "loss_u_fold1.txt").exists()

    tdir = write_fold(tmp_path, size=32)
    capsys.readouterr()
    assert cli.main(["test-gan", "--device", "cpu", "--manifest-dir", str(tdir), "--folds", "1",
                     "--image-size", "32", "--first-fm", "8", "--n-repeat", "2",
                     "--weights", str(models / "g_fold{fold}"),
                     "--out-dir", str(tmp_path / "out")]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == '{"subjects": 2}'
    assert (tmp_path / "out" / "RECAP_evaluation_for_allData.csv").exists()

    out = tmp_path / "vars.pt"
    assert cli.main(["import-weights", "--h5", str(models / "netG_g_fold1.h5"), "--image-size",
                     "32", "--first-fm", "8", "--out", str(out)]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["status"] == "ok"
    saved = torch.load(out, weights_only=True)
    want = import_keras_h5(str(models / "netG_g_fold1.h5"), init_generator(GAN, seed=0))
    for k, v in flatten_tree(want).items():
        np.testing.assert_array_equal(flatten_tree(saved)[k].numpy(), v, err_msg=k)


class _Parsed(Exception):
    pass


def _jax_parser(monkeypatch):
    """The parser JAX's ``cli.main`` builds, caught at ``parse_args``."""
    def catch(self, *a, **k):
        raise _Parsed(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", catch)
        with pytest.raises(_Parsed) as e:
            jax_cli.main([])
    return e.value.args[0]


def _options(parser):
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {name: {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices, a.nargs,
                            a.required, a.const)
                   for a in p._actions if a.dest != "help"}
            for name, p in sub.choices.items()}


def test_parsers_match_jax(monkeypatch, capsys):
    """Every subcommand of the port has JAX's options, defaults, types and
    choices but for the listed differences: ``--device`` in place of JAX's
    ``--platform``; the training subcommands leave out ``--n-data`` and
    ``--folds-parallel``. ``bench`` runs the chosen benchmark and prints
    one JSON line."""
    ours, ref = _options(cli.build_parser()), _options(_jax_parser(monkeypatch))
    assert ours.keys() == ref.keys() == {"train-gan", "train-uresnet", "test-gan",
                                         "test-uresnet", "import-weights", "bench"}
    for cmd, options in ref.items():
        got = dict(ours[cmd])
        if cmd != "bench":
            assert got.pop("device")[:2] == (("--device",), "cuda")
        if cmd.startswith("train-"):
            options = {k: v for k, v in options.items() if k not in ("n_data", "folds_parallel")}
        assert got == options, cmd
    assert [a.dest for a in _jax_parser(monkeypatch)._actions][-1] == "cmd"

    stub = {"metric": "gen_inference_throughput", "value": 1.0}
    monkeypatch.setattr(benchmarks, "gen_inference_bench", lambda: stub)
    assert cli.main(["bench", "--what", "gen-inference"]) == 0
    assert json.loads(capsys.readouterr().out) == stub
    with pytest.raises(RuntimeError, match="CUDA"):  # no card here
        cli.main(["bench", "--what", "uresnet-inference"])


def test_drivers_check_h5py_before_the_first_step(tmp_path, monkeypatch):
    """Without h5py both drivers raise, naming it, before reading data or
    writing anything; with an ``export_h5`` of the caller's they train."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    data_cfg = DataConfig(manifest_dir=str(tmp_path / "missing"), image_size=32)
    for run, model_cfg, train_cfg in ((drivers.run_gan_training, GAN, GAN_TRAIN),
                                      (drivers.run_uresnet_training, URESNET,
                                       UResNetTrainConfig(n_epochs=1))):
        with pytest.raises(ImportError, match="h5py"):
            run(model_cfg, train_cfg, data_cfg, model_dir=str(tmp_path / "models"),
                device="cpu")
    assert not (tmp_path / "models").exists()
    mdir = write_training_fold(tmp_path, n_slices=4)
    written = []
    drivers.run_gan_training(
        GAN, GanTrainConfig(batch_size=4, n_epochs=1, d_iters=1, warmup_d_iters=1, k_noise=1),
        DataConfig(manifest_dir=str(mdir), image_size=32, val_fraction=0.25), folds=(1,),
        model_dir=str(tmp_path / "models"), use_tensorboard=False, device="cpu",
        export_h5=lambda s, p: written.append(p.name))
    assert written == ["netG_depgan_fold1.h5"]
