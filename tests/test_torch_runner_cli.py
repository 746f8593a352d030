"""The port's testing path against the JAX package's: ``run_gan_testing`` and
``run_uresnet_testing`` end to end with the same noise on both sides, the
CLI against the API, the ``.h5`` weights loader, and the generator's width
gate against the kernels' plans."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depgan_tpu import config as jax_config
from depgan_tpu.eval import predict as jax_predict
from depgan_tpu.eval import runner as jax_runner
from depgan_tpu.models import GenUNet2D as FlaxGenUNet2D
from depgan_tpu_torch import cli, drivers
from depgan_tpu_torch.config import DataConfig, EvalConfig, GanTrainConfig, ModelConfig
from depgan_tpu_torch.data import nifti
from depgan_tpu_torch.eval import predict, runner
from depgan_tpu_torch.io.flax_bridge import flatten_tree, load_flax_variables
from depgan_tpu_torch.io.h5_import import export_keras_h5
from depgan_tpu_torch.models import GenUNet2D
from depgan_tpu_torch.ops import wgmma_plan
from depgan_tpu_torch.ops.fast_gen import (FastGenerator, FusedGenerator, gate_message,
                                           site_problems, site_routes, taken_launches)
from depgan_tpu_torch.train.gan_trainer import GanTrainer
from test_torch_data_eval import write_fold
from test_torch_models import _map, jax_cfg, randomized_variables

GAN = ModelConfig(image_size=16, first_fm=4)
URESNET = ModelConfig(image_size=16, first_fm=4, n_out=4, dropout_mode="uresnet")
N_REPEAT = 2
MARGIN = 2e-4  # the maps' tolerance: no decision may lie this close to its threshold


def _same_noise(monkeypatch, seed):
    """Both runners' predictors draw each subject's noises from one numpy
    stream (the same seed on both sides) and call their ``_ensemble``."""
    rngs = [np.random.default_rng(seed) for _ in range(2)]

    def noises(rng, pred, x):
        return rng.normal(size=(pred.n_repeat, x.shape[0], pred.noise_size, 1)).astype(
            np.float32)

    class JaxPredictor(jax_predict.EnsemblePredictor):
        def predict(self, x, mask):
            return np.asarray(self._ensemble(self.variables, jnp.asarray(x),
                                             jnp.asarray(noises(rngs[0], self, x)),
                                             jnp.asarray(mask)))

    class TorchPredictor(predict.EnsemblePredictor):
        def predict(self, x, mask):
            return self._ensemble(torch.from_numpy(x), torch.from_numpy(noises(rngs[1], self, x)),
                                  torch.from_numpy(mask)).numpy()

    monkeypatch.setattr(jax_runner, "EnsemblePredictor", JaxPredictor)
    monkeypatch.setattr(runner, "EnsemblePredictor", TorchPredictor)


def _run_both(tmp_path, monkeypatch, cfg, kind, seed):
    mdir = write_fold(tmp_path)
    variables = randomized_variables(cfg, seed=seed)
    _same_noise(monkeypatch, seed)
    data = dict(manifest_dir=str(mdir), image_size=16)
    getattr(jax_runner, f"run_{kind}_testing")(
        jax_cfg(cfg), jax_config.DataConfig(**data),
        jax_config.EvalConfig(n_repeat=N_REPEAT, output_dir=str(tmp_path / "ref")),
        lambda fold: (FlaxGenUNet2D(jax_cfg(cfg)), _map(jnp.asarray, variables)), folds=(1,))
    results = getattr(runner, f"run_{kind}_testing")(
        cfg, DataConfig(**data), EvalConfig(n_repeat=N_REPEAT, output_dir=str(tmp_path / "ours")),
        lambda fold: variables, folds=(1,), device="cpu")
    assert [r.name for r in results] == ["SUBJ000", "SUBJ001"]
    csv = "RECAP_evaluation_for_allData.csv" if kind == "gan" else "vol_dsc_all.csv"
    ours, ref = (np.loadtxt(tmp_path / side / csv, delimiter=",", skiprows=1)
                 for side in ("ours", "ref"))
    assert ours.shape == ref.shape == (2, 18)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    return mdir


def _maps(path_ours, path_ref):
    a, b = nifti.load(path_ours), nifti.load(path_ref)
    assert a.image.dtype == b.image.dtype and a.image.shape == b.image.shape
    np.testing.assert_array_equal(a.affine, b.affine)
    return a.image, b.image


def test_gan_runner_matches_jax(tmp_path, monkeypatch):
    """Maps within 2e-4, the code map exactly, CSV rows within 1e-5; the
    test asserts that no masked-in y2_fake lies within 2e-4 of the 0.5
    threshold for its seed, so no decision can flip between the sides."""
    _run_both(tmp_path, monkeypatch, GAN, "gan", seed=3)
    for s in ("SUBJ000", "SUBJ001"):
        icv = nifti.load(tmp_path / f"subj{s[-1]}" / "icv_2tp.nii.gz").image
        for suffix in ("2tp_prob_fake", "network_output", "2tp_code_fake"):
            ours, ref = _maps(tmp_path / "ours" / f"{s}_{suffix}.nii.gz",
                              tmp_path / "ref" / f"{s}_{suffix}.nii.gz")
            if suffix == "2tp_code_fake":
                np.testing.assert_array_equal(ours, ref)
            else:
                np.testing.assert_allclose(ours, ref, rtol=0, atol=MARGIN)
            if suffix == "2tp_prob_fake":
                inside = np.abs(ref - 0.5)[icv > 0]
                assert inside.min() > MARGIN, f"{s}: y2_fake within {MARGIN} of the threshold"


def test_uresnet_runner_matches_jax(tmp_path, monkeypatch):
    """Probability maps within 2e-4, class maps exactly, CSV rows within
    1e-5; the test asserts that every masked-in voxel's top two classes
    differ by more than 2e-4 for its seed."""
    _run_both(tmp_path, monkeypatch, URESNET, "uresnet", seed=4)
    for s in ("SUBJ000", "SUBJ001"):
        ours, ref = _maps(tmp_path / "ours" / s / f"{s}_cls_map.nii.gz",
                          tmp_path / "ref" / s / f"{s}_cls_map.nii.gz")
        np.testing.assert_array_equal(ours, ref)
        probs = []
        for c in range(4):
            ours, ref = _maps(tmp_path / "ours" / s / f"{s}_prb_map_c{c}.nii.gz",
                              tmp_path / "ref" / s / f"{s}_prb_map_c{c}.nii.gz")
            np.testing.assert_allclose(ours, ref, rtol=0, atol=MARGIN)
            probs.append(ref)
        top2 = np.sort(np.stack(probs, -1), axis=-1)[..., -2:]
        inside = top2.sum(-1) > 0  # the ensemble's mask zeroes every class outside
        assert (top2[..., 1] - top2[..., 0])[inside].min() > MARGIN, s


def test_cli_writes_the_api_csv(tmp_path, capsys):
    """``test-gan`` and ``test-uresnet`` with ``--device cpu`` and ``.h5``
    weights write the CSV that the API writes from the same weights."""
    mdir = write_fold(tmp_path)
    for cmd, cfg, run, csv in (
            ("test-gan", GAN, runner.run_gan_testing, "RECAP_evaluation_for_allData.csv"),
            ("test-uresnet", URESNET, runner.run_uresnet_testing, "vol_dsc_all.csv")):
        export_keras_h5(randomized_variables(cfg, seed=5), str(tmp_path / f"{cmd}_fold1.h5"))
        pattern = str(tmp_path / f"{cmd}_fold{{fold}}.h5")
        assert cli.main([cmd, "--device", "cpu", "--weights", pattern, "--manifest-dir",
                         str(mdir), "--folds", "1", "--image-size", "16", "--first-fm", "4",
                         "--n-repeat", str(N_REPEAT), "--out-dir", str(tmp_path / cmd)]) == 0
        assert capsys.readouterr().out.strip().splitlines()[-1] == '{"subjects": 2}'
        run(cfg, DataConfig(manifest_dir=str(mdir), image_size=16),
            EvalConfig(n_repeat=N_REPEAT, output_dir=str(tmp_path / f"{cmd}_api")),
            drivers.generator_loader(cfg, pattern), folds=(1,), device="cpu")
        assert ((tmp_path / cmd / csv).read_text()
                == (tmp_path / f"{cmd}_api" / csv).read_text())
    with pytest.raises(SystemExit):  # the multi-device training flags are not ported
        cli.build_parser().parse_args(["train-gan", "--folds-parallel"])


def test_generator_loader(tmp_path):
    """A .h5 gives its tree; a checkpoint directory, a missing file and
    another suffix raise."""
    variables = randomized_variables(GAN, seed=6)
    export_keras_h5(variables, str(tmp_path / "g_fold1.h5"))
    got = flatten_tree(drivers.generator_loader(GAN, str(tmp_path / "g_fold{fold}.h5"))(1))
    want = flatten_tree(variables)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    (tmp_path / "ckpt_fold1").mkdir()
    (tmp_path / "w_fold1.npz").write_bytes(b"")
    for pattern, error, match in (("ckpt_fold{fold}", ValueError, "checkpoint directory"),
                                  ("g_fold{fold}.h5", FileNotFoundError, "fold 2"),
                                  ("w_fold{fold}.npz", ValueError, "unsupported")):
        fold = 2 if error is FileNotFoundError else 1
        with pytest.raises(error, match=match):
            drivers.generator_loader(GAN, str(tmp_path / pattern))(fold)


def _plan_route(name, problem, dtype):
    """The route the Python plans give, written from them directly."""
    def refuses(fn, *args, **kw):
        try:
            fn(*args, **kw)
        except ValueError:
            return True
        return False

    bf16 = dtype == torch.bfloat16
    if name == "pool_to_s2d" or name == "pool_s2d":
        return "pool" if problem[1] % 32 == 0 else None
    if name == "deconv_s2d":
        m, c4, o4 = problem
        if c4 % 32:
            return None
        return "wgmma" if bf16 and not refuses(wgmma_plan.deconv_plan, m, c4, o4) else "engine"
    if name == "conv3x3_s2d_chain3":
        n, c4a, c4b, c4m, c4o, pool = problem
        c4s = (c4a, c4b) if c4b else (c4a,)
        if any(c4 % 32 for c4 in (*c4s, c4m)):
            return None
        if not bf16:
            return "chain"
        return None if refuses(wgmma_plan.chain_plan, n, c4s, c4m, c4o, pool) else "wgmma"
    n, *c4s, co4 = problem[:3] if name in ("conv3x3_s2d_fused", "conv3x3_s2d_fused_pool",
                                            "conv3x3_s2d_fused_head") else problem
    pool = problem[3] if name == "conv3x3_s2d_fused_pool" else ""
    if refuses(wgmma_plan.plan, n, tuple(c4s), co4):
        return None
    if name == "conv3x3_s2d_fused_head" and (co4 > 256 or problem[3] > 16):
        return None
    if pool:
        if co4 > 256:
            return None
        return "wgmma" if bf16 and not refuses(wgmma_plan.plan, n, tuple(c4s), co4,
                                               pool=pool) else "engine"
    return "wgmma" if bf16 else "engine"


def test_gate_routes_agree_with_the_plans():
    """Each site's route and the gate's answer over first_fm 8-64 at image
    256, both dtypes, against the plans; the default configuration keeps
    its 8/2/2/1 launches a forward."""
    for first_fm in (8, 16, 20, 24, 32, 48, 64):
        cfg = ModelConfig(image_size=256, first_fm=first_fm)
        for dtype in (torch.bfloat16, torch.float32):
            routes = site_routes(cfg, dtype)
            for key, (name, problem) in site_problems(cfg).items():
                assert routes[key] == _plan_route(name, problem, dtype), (first_fm, key)
            # No kernel takes a 4C that is not a multiple of 32: 4 first_fm at
            # level 1, 12 first_fm at p2's entry.
            assert (gate_message(cfg, routes) is None) == (first_fm % 8 == 0), first_fm
    routes = {f: site_routes(ModelConfig(image_size=256, first_fm=f), torch.bfloat16)
              for f in (24, 32, 48, 64)}
    assert routes[24]["m1.conv_out_pool"] == routes[24]["m2.conv_out_pool"] == "engine"
    assert routes[48]["m1.conv_out_pool"] == "engine" and routes[48]["m2.conv_out_pool"] is None
    assert routes[64]["m2.conv_out_pool"] is None and routes[64]["p1.deconv"] == "engine"
    assert all(routes[32][f"{s}.{op}"] == "wgmma" for s in ("m1", "m2", "p2", "p1")
               for op in ("conv_in", "film", "chain")) and routes[32]["p1.deconv"] == "wgmma"

    cfg = ModelConfig(image_size=32, first_fm=32)
    fast = FastGenerator(cfg, randomized_variables(cfg, seed=1), torch.float32, "cpu")
    fast(torch.zeros(1, 32, 32, 1), torch.zeros(1, 32, 1))
    assert taken_launches(cfg, fast.taken) == {"conv3x3_s2d_fused": 8,
                                               "conv3x3_s2d_fused_pool": 2,
                                               "conv3x3_s2d_fused2": 2, "deconv_s2d": 1}


def test_gate_warns_at_construction_and_serves_plain_sites():
    """At first_fm 20 (4C 80) the generator built for a CUDA device and the
    fused trainer warn at construction, naming the sites, their widths and
    the rule; nothing warns at first_fm 32. On the CPU the gated sites run
    their plain versions and the forward equals the plain generator's."""
    cfg = ModelConfig(image_size=32, first_fm=20)
    with pytest.warns(UserWarning, match=r"m1\.film \(conv3x3_s2d_fused \(16, 80, 80, 'film'\)\)"
                                         r".*4C a multiple of 32"):
        FusedGenerator(cfg, torch.bfloat16, "cuda")
    with pytest.warns(UserWarning, match="first_fm=20"):
        GanTrainer(ModelConfig(image_size=32, first_fm=20, use_pallas=True), GanTrainConfig(),
                   device="cuda")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        FusedGenerator(ModelConfig(image_size=32, first_fm=32), torch.bfloat16, "cuda")
        FusedGenerator(cfg, torch.bfloat16, "cpu")  # the CPU runs plain versions anyway

    variables = randomized_variables(cfg, seed=2)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(size=(2, 32, 32, 1)).astype(np.float32))
    z = torch.from_numpy(rng.normal(size=(2, 32, 1)).astype(np.float32))
    fast = FastGenerator(cfg, variables, torch.float32, "cpu")
    with torch.no_grad():
        out = fast(x, z)
        ref = load_flax_variables(GenUNet2D(cfg), variables).eval()(x, z)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-4)
    plain = {key for key, route in fast.taken.items() if route == "plain"}
    assert plain == {"m1.film", "m1.conv_out", "m1.pool", "m2.conv_in", "p2.conv_in",
                     "p1.conv_in", "p1.film", "p1.conv_out"}
    assert all(key in gate_message(cfg, fast.routes) for key in plain)
