"""The port's data layer, metrics, writers and Keras .h5 import/export
against the JAX package's, on the same files and arrays: the data and the
metrics bit for bit, the writers' maps by array, affine and dtype (not by
gzip bytes, which carry a time stamp)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from depgan_tpu import config as jax_config
from depgan_tpu.data import dataset as jax_dataset
from depgan_tpu.data import manifest as jax_manifest
from depgan_tpu.data import nifti as jax_nifti
from depgan_tpu.data import pipeline as jax_pipeline
from depgan_tpu.data import preprocess as jax_pp
from depgan_tpu.eval import metrics as jax_metrics
from depgan_tpu.eval import writers as jax_writers
from depgan_tpu.io import h5_import as jax_h5
from depgan_tpu.models import init_generator as flax_init_generator
from depgan_tpu_torch.config import DataConfig, ModelConfig
from depgan_tpu_torch.data import dataset, manifest, nifti, pipeline
from depgan_tpu_torch.data import preprocess as pp
from depgan_tpu_torch.eval import metrics, writers
from depgan_tpu_torch.io import h5_import
from depgan_tpu_torch.io.flax_bridge import flatten_tree
from depgan_tpu_torch.models import init_generator
from test_torch_models import _map, jax_cfg, randomized_variables

TEST_MODALITIES = tuple(dict.fromkeys(manifest.GAN_TEST_MODALITIES
                                      + manifest.URESNET_TEST_MODALITIES))


def write_fold(root, n_subjects=2, size=16, n_slices=4, fold=1, lesions=(1,)):
    """A synthetic test fold: every test modality of each subject as
    .nii.gz, manifests and names; the sl_cleaned files exist only for the
    subjects in ``lesions`` (an optional modality, skipped where missing).
    Returns the manifest directory."""
    rng = np.random.default_rng(fold)
    mdir = root / "manifests"
    mdir.mkdir(exist_ok=True)
    lists = {m: [] for m in TEST_MODALITIES}
    affine = np.diag([1.2, 0.9, 3.0, 1.0])
    shape = (size, size, n_slices)
    for s in range(n_subjects):
        sd = root / f"subj{s}"
        sd.mkdir(exist_ok=True)
        icv = (rng.uniform(size=shape) > 0.1).astype(np.float32)
        vols = {
            "flair_1tp": rng.uniform(0, 100, shape),
            "iam_1tp": rng.uniform(-0.1, 1, shape),
            "wmh_prob_v2_1tp": rng.uniform(-0.1, 1, shape),
            "wmh_prob_v2_2tp": rng.uniform(0, 1, shape),
            "icv_1tp": icv,
            "icv_2tp": (rng.uniform(size=shape) > 0.1).astype(np.float32),
            "wmh_1tp": (rng.uniform(size=shape) > 0.8).astype(np.float32),
            "wmh_2tp": (rng.uniform(size=shape) > 0.8).astype(np.float32),
            "wmh_subtracted_coded_2tp_1tp": rng.integers(0, 4, shape).astype(np.float32),
            "sl_cleaned_1tp": (rng.uniform(size=shape) > 0.9).astype(np.float32),
            "sl_cleaned_2tp": (rng.uniform(size=shape) > 0.9).astype(np.float32),
        }
        for m in TEST_MODALITIES:
            path = sd / f"{m}.nii.gz"
            if not m.startswith("sl_cleaned") or s in lesions:
                nifti.save(vols[m].astype(np.float32), affine, path)
            lists[m].append(str(path))
    for m, paths in lists.items():
        (mdir / f"{m}_fold{fold}.txt").write_text("\n".join(paths) + "\n")
    (mdir / f"name_fold{fold}.txt").write_text(
        "\n".join(f"SUBJ{s:03d}" for s in range(n_subjects)) + "\n")
    return mdir


def assert_same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("kind", ["gan", "uresnet"])
def test_test_subjects_match_jax(tmp_path, kind):
    """The test-subject loaders give JAX's arrays bit for bit, with and
    without the optional stroke-lesion masks, in both map modes."""
    mdir = write_fold(tmp_path)
    for pm in (True, False):
        kw = dict(manifest_dir=str(mdir), image_size=16, use_probability_map=pm,
                  n_input_channels=2 if kind == "gan" and pm else 1)
        ours = list(getattr(dataset, f"iter_{kind}_test_subjects")(DataConfig(**kw), 1))
        ref = list(getattr(jax_dataset, f"iter_{kind}_test_subjects")(
            jax_config.DataConfig(**kw), 1))
        assert [s.name for s in ours] == [s.name for s in ref] == ["SUBJ000", "SUBJ001"]
        for a, b in zip(ours, ref):
            for field in dataclasses.fields(a):
                va, vb = getattr(a, field.name), getattr(b, field.name)
                if isinstance(va, np.ndarray):
                    assert_same(va, vb, f"{kind} {a.name} {field.name}")
                else:
                    assert va == vb, field.name


def test_manifest_and_nifti_match_jax(tmp_path):
    """Manifest bundles (short manifests padded, missing primaries skipped),
    NIfTI files written by either side and read by the other, .nii and
    .nii.gz, and the orientation transforms."""
    mdir = write_fold(tmp_path, n_subjects=3)
    (mdir / "icv_2tp_fold1.txt").write_text(
        (mdir / "icv_2tp_fold1.txt").read_text().splitlines()[0] + "\n")
    (mdir / "flair_1tp_fold1.txt").write_text(
        (mdir / "flair_1tp_fold1.txt").read_text().replace("subj1/", "missing/"))
    bundles = [m.ManifestBundle(mdir, 1, m.GAN_TEST_MODALITIES, primary="flair_1tp",
                                name_modality="name") for m in (manifest, jax_manifest)]
    ours, ref = ([(r.index, r.name, dict(r.paths), r.exists("sl_cleaned_1tp"))
                  for r in b.subjects()] for b in bundles)
    assert ours == ref and [r[0] for r in ours] == [0, 2]

    rng = np.random.default_rng(0)
    affine = np.array([[0.9, 0.1, 0, -5], [0, 1.1, 0, 3], [0.2, 0, 2.5, 1], [0, 0, 0, 1]])
    for dtype in (np.float32, np.int16, np.uint8, np.float64):
        vol = (rng.uniform(0, 100, (6, 5, 3))).astype(dtype)
        for suffix in (".nii", ".nii.gz"):
            for save, load in ((nifti.save, jax_nifti.load), (jax_nifti.save, nifti.load)):
                path = tmp_path / f"v_{np.dtype(dtype).name}_{save.__module__}{suffix}"
                save(vol, affine, path)
                a, b = load(path), nifti.load(path)
                assert_same(a.image, b.image, str(path))
                assert_same(a.affine, b.affine, str(path))
                assert_same(a.pixdim, b.pixdim, str(path))
                assert_same(nifti.load_auto(path).image, jax_nifti.load_auto(path).image,
                            str(path))
        slices = nifti.volume_to_slices(vol)
        assert_same(slices, jax_nifti.volume_to_slices(vol), "volume_to_slices")
        assert_same(nifti.slices_to_volume(slices), jax_nifti.slices_to_volume(slices),
                    "slices_to_volume")


def test_preprocess_matches_jax():
    rng = np.random.default_rng(3)
    img = rng.normal(2, 3, (3, 8, 8, 1)).astype(np.float32)
    mask = (rng.uniform(size=img.shape) > 0.3).astype(np.float32)
    probs = rng.dirichlet(np.ones(4), size=(3, 8, 8)).astype(np.float32)
    for name, args in (("map_to_intensity_range", (img, 0, 1, 0)),
                       ("map_to_intensity_range", (img, 0, 1, 2.5)),
                       ("zscore_normalise", (img,)),
                       ("zscore_normalise", (np.full((4, 4), 7.0, np.float32),)),
                       ("apply_brain_mask", (img, mask)), ("apply_lesion_mask", (img, mask)),
                       ("clamp_negative", (img,)), ("assemble_channels", (img, mask, 1)),
                       ("assemble_channels", (img, mask, 2)),
                       ("one_hot", (rng.integers(0, 4, (3, 8, 8, 1)), 4)),
                       ("from_one_hot", (probs,)), ("from_one_hot", (probs, True))):
        assert_same(getattr(pp, name)(*args), getattr(jax_pp, name)(*args), name)


def test_metrics_match_jax():
    """The 6-way Dice, the volumes, the direction flags and the 18-column
    row, equal on the same maps."""
    rng = np.random.default_rng(5)
    y1, y2 = rng.uniform(-1, 1, (2, 4, 16, 16))
    real = rng.integers(0, 4, (4, 16, 16)).astype(np.float32)
    pixdim = np.array([0.94, 0.94, 3.0])
    for t in (0.5, 0.178):
        fake = metrics.code_change_map(y2, y1, t)
        assert_same(fake, jax_metrics.code_change_map(y2, y1, t), "code_change_map")
        assert metrics.dice_suite(fake, real) == jax_metrics.dice_suite(fake, real)
        for k in (1, 2, 3):
            assert metrics.category_dice(fake, real, k) == jax_metrics.category_dice(fake, real, k)
        assert metrics.volume_ml(y2 > t, pixdim) == jax_metrics.volume_ml(y2 > t, pixdim)
    for vols in ((10.0, 12.0, 11.0), (10.0, 8.0, 9.0), (10.0, 8.0, 11.0), (3.0, 3.0, 2.0)):
        ours, ref = metrics.volumetric_metrics(*vols), jax_metrics.volumetric_metrics(*vols)
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        dices = metrics.dice_suite(fake, real)
        assert metrics.csv_row(ours, dices) == jax_metrics.csv_row(ref, dices)
    assert metrics.CSV_COLUMNS == jax_metrics.CSV_COLUMNS and len(metrics.CSV_COLUMNS) == 18


def test_writers_match_jax(tmp_path):
    """Both sides' maps reloaded: equal arrays, affines and dtypes; the CSV
    recaps equal as text."""
    rng = np.random.default_rng(7)
    affine, pixdim = np.diag([0.9, 0.9, 3.0, 1.0]), np.array([0.9, 0.9, 3.0])
    y2, dem = rng.uniform(-1, 1, (2, 4, 16, 16)).astype(np.float32)
    code = rng.integers(0, 4, (4, 16, 16)).astype(np.float32)
    probs = rng.dirichlet(np.ones(4), size=(4, 16, 16)).astype(np.float32)
    labels = pp.from_one_hot(probs)
    rows = rng.uniform(size=(3, 18)).tolist()
    for side, mod in (("ours", writers), ("ref", jax_writers)):
        mod.write_gan_outputs(tmp_path / side, "S0", affine, pixdim, y2, dem, code)
        mod.write_uresnet_outputs(tmp_path / side, "S0", affine, pixdim, labels, probs)
        recap = mod.CsvRecap(tmp_path / side / "recap.csv", metrics.CSV_COLUMNS)
        for row in rows:
            recap.append(row)
    names = sorted(p.relative_to(tmp_path / "ref") for p in (tmp_path / "ref").rglob("*.nii.gz"))
    assert len(names) == 3 + 5
    assert names == sorted(p.relative_to(tmp_path / "ours")
                           for p in (tmp_path / "ours").rglob("*.nii.gz"))
    for name in names:
        a, b = nifti.load(tmp_path / "ours" / name), jax_nifti.load(tmp_path / "ref" / name)
        for what in ("image", "affine", "pixdim"):
            assert_same(getattr(a, what), getattr(b, what), f"{name} {what}")
    assert ((tmp_path / "ours" / "recap.csv").read_text()
            == (tmp_path / "ref" / "recap.csv").read_text())


def test_h5_import_export_match_jax(tmp_path):
    """A JAX-exported .h5 imports to the same tree in the port, and the
    port's export followed by JAX's import is the identity."""
    cfg = ModelConfig(image_size=16, first_fm=4)
    variables = randomized_variables(cfg, seed=8)
    jax_h5.export_keras_h5(_map(jnp.asarray, variables), str(tmp_path / "jax.h5"))
    assert (h5_import.load_keras_h5(str(tmp_path / "jax.h5")).keys()
            == jax_h5.load_keras_h5(str(tmp_path / "jax.h5")).keys())
    ours = h5_import.import_keras_h5(str(tmp_path / "jax.h5"), init_generator(cfg, seed=0))
    h5_import.export_keras_h5(variables, str(tmp_path / "port.h5"))
    _, template = flax_init_generator(jax_cfg(cfg), jax.random.key(0))
    ref = jax_h5.import_keras_h5(str(tmp_path / "port.h5"), template)
    want = flatten_tree(variables)
    for tree in (ours, ref):
        got = flatten_tree(tree)
        assert got.keys() == want.keys()
        for name, leaf in want.items():
            assert_same(np.asarray(got[name]), leaf, name)


def test_prefetch_matches_jax():
    """Items in order, and the producer's exception after the items before
    it, as JAX's prefetch."""
    def items():
        yield from range(5)
        raise KeyError("boom")

    for fn in (pipeline.prefetch, jax_pipeline.prefetch):
        got = []
        with pytest.raises(KeyError, match="boom"):
            for item in fn(items(), size=2):
                got.append(item)
        assert got == list(range(5))
        assert list(fn(iter(range(7)), size=1)) == list(range(7))
