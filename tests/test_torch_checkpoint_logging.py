"""The port's checkpoints, ``.h5`` export, state <-> trees bridge and
TensorBoard logging, against the JAX package where it has a counterpart:
resume bit for bit on the CPU, retention, the template-free generator
restore, the ``.h5`` read back by JAX's importer, the bridge against JAX
training states, and the event and loss-history files byte for byte.
Image 32, first_fm 8, float32."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from depgan_tpu.io import h5_import as jax_h5
from depgan_tpu.train.state import GanTrainState as JaxGanTrainState
from depgan_tpu.train.state import UResNetTrainState as JaxUResNetTrainState
from depgan_tpu.utils import logging as jax_logging
from depgan_tpu.utils import tb_writer as jax_tb
from depgan_tpu_torch.config import GanTrainConfig, ModelConfig, UResNetTrainConfig
from depgan_tpu_torch.io import checkpoint
from depgan_tpu_torch.io.checkpoint import CheckpointManager
from depgan_tpu_torch.io.flax_bridge import (flatten_tree, gan_train_state_from_trees,
                                             gan_trees_from_state, uresnet_train_state_from_trees,
                                             uresnet_trees_from_state)
from depgan_tpu_torch.models import init_critic, init_generator
from depgan_tpu_torch.train.gan_trainer import GanTrainer
from depgan_tpu_torch.train.state import Counters
from depgan_tpu_torch.train.uresnet_trainer import UResNetTrainer
from depgan_tpu_torch.utils import logging, tb_writer
from test_torch_gan_trainer import _adam_state
from test_torch_models import _map

GAN = ModelConfig(image_size=32, first_fm=8, use_pallas=True)
URESNET = ModelConfig(image_size=32, first_fm=8, n_out=4, dropout_mode="uresnet")
TRAIN = GanTrainConfig(batch_size=2, d_iters=2, warmup_d_iters=2, k_noise=2)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small tensors: under pytest-xdist,
    torch's threads contend with the other workers' for the cores, which
    slowed these fits ~50x; alone they run as fast on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_trees(rng):
    """A GAN state's numpy trees with Adam moments that are not zero."""
    gen = init_generator(GAN, seed=0)
    trees = {"g_params": gen["params"], "g_stats": gen["batch_stats"],
             "dy2_params": init_critic(GAN, seed=1)["params"],
             "ddem_params": init_critic(GAN, seed=2)["params"]}
    for name in ("g", "dy2", "ddem"):
        trees[f"{name}_opt"] = {
            "count": 5, "mu": _map(lambda a: rng.normal(0, 1e-3, a.shape).astype(np.float32),
                                   trees[f"{name}_params"]),
            "nu": _map(lambda a: rng.uniform(1e-6, 1e-5, a.shape).astype(np.float32),
                       trees[f"{name}_params"])}
    return trees


def assert_trees_equal(got, want, what=""):
    assert isinstance(got, dict) == isinstance(want, dict), what
    if isinstance(want, dict):
        assert got.keys() == want.keys(), what
        for k in want:
            assert_trees_equal(got[k], want[k], f"{what}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=what)


def state_tensors(state):
    """Every tensor of a GAN state, Adam's step counts and moments included."""
    trees = gan_trees_from_state(state)
    return flatten_tree({k: v for k, v in trees.items()})


def test_resume_is_bit_exact(tmp_path):
    """Save after one superstep, run a second; restore the checkpoint into a
    fresh state and run the same second superstep: every parameter,
    statistic, Adam count and moment, and every metric, equal bit for bit."""
    trainer = GanTrainer(GAN, TRAIN, device="cpu")
    rng = np.random.default_rng(0)
    state = gan_train_state_from_trees(random_trees(rng), TRAIN.lr_g, TRAIN.lr_d, TRAIN.adam_b1,
                                       TRAIN.adam_b2, device="cpu")
    x_all, y_all = (torch.tensor(rng.uniform(size=(8, 32, 32, 1)), dtype=torch.float32)
                    for _ in range(2))
    gen = torch.Generator().manual_seed(1)
    first, second = (trainer.draw(2, 2, gen) for _ in range(2))
    idx1, idx2 = np.array([[0, 1], [2, 3]]), np.array([[4, 5], [6, 7]])
    state, _ = trainer.superstep(state, x_all, y_all, idx1, 2, draws=first)
    mgr = CheckpointManager(tmp_path / "ckpt")
    mgr.save(1, state, Counters(1, 2, 2), extra={"fold": 3})
    state, want_metrics = trainer.superstep(state, x_all, y_all, idx2, 1, draws=second)
    want = state_tensors(state)

    fresh = GanTrainer(GAN, TRAIN, device="cpu").init_state(seed=9)
    restored, counters, extra = mgr.restore(fresh)
    assert dataclasses.asdict(counters) == {"gen_iterations": 1, "crit_iterations": 2,
                                            "crit_dem_iterations": 2}
    assert extra == {"fold": 3}
    restored, metrics = trainer.superstep(restored, x_all, y_all, idx2, 1, draws=second)
    got = state_tensors(restored)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert gan_trees_from_state(restored)["g_opt"]["count"] == 5 + 2
    for k in ("crit_y2_real", "crit_y2_fake", "crit_dem_real", "crit_dem_fake"):
        assert torch.equal(metrics[k].nan_to_num(), want_metrics[k].nan_to_num()), k
    for k, v in want_metrics["gen"].items():
        assert torch.equal(metrics["gen"][k], v), k


def test_retention_latest_step_and_uresnet_state(tmp_path):
    """``max_to_keep``, ``latest_step``, a step saved twice replaced, no
    temporary directory left, a UResNet state with its epoch, and the
    files: ``state.pt`` loads with ``weights_only=True``."""
    trainer = UResNetTrainer(URESNET, UResNetTrainConfig(), device="cpu")
    state = trainer.init_state(seed=0)
    mgr = CheckpointManager(tmp_path / "ckpt", max_to_keep=2)
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        mgr.restore(state)
    assert mgr.latest_step() is None
    for step in (1, 2, 3, 4):
        state.epoch = step
        mgr.save(step, state, Counters(gen_iterations=step))
    state.epoch = 40
    mgr.save(4, state)  # replaces step 4
    assert mgr.latest_step() == 4 and mgr.all_steps() == [3, 4]
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["3", "4"]
    assert sorted(p.name for p in (tmp_path / "ckpt" / "4").iterdir()) == ["meta.json",
                                                                            "state.pt"]
    flat = torch.load(tmp_path / "ckpt" / "4" / "state.pt", weights_only=True)
    assert flat["opt/count"] == 0 and flat["epoch"] == 40
    assert json.loads((tmp_path / "ckpt" / "4" / "meta.json").read_text()) == {
        "kind": "uresnet", "counters": None, "extra": {}}
    restored, counters, _ = mgr.restore(trainer.init_state(seed=5))
    assert restored.epoch == 40 and counters == Counters()
    assert_trees_equal(uresnet_trees_from_state(restored), uresnet_trees_from_state(state))
    older, counters, _ = mgr.restore(state, step=3)
    assert older.epoch == 3 and counters.gen_iterations == 3
    with pytest.raises(ValueError, match="uresnet checkpoint"):
        mgr.restore(GanTrainer(GAN, TRAIN, device="cpu").init_state(seed=0))


def test_load_generator_variables(tmp_path):
    """The template-free restore gives the saved generator trees, the
    latest step by default; a UResNet checkpoint is refused with JAX's
    message."""
    rng = np.random.default_rng(1)
    trees = random_trees(rng)
    state = gan_train_state_from_trees(trees, 1e-4, 1e-4, 0.0, 0.9, device="cpu")
    mgr = CheckpointManager(tmp_path / "gan")
    mgr.save(3, state)
    with torch.no_grad():
        for p in state.g_params.values():
            p.add_(1.0)
    mgr.save(6, state)
    got = checkpoint.load_generator_variables(tmp_path / "gan", step=3)
    assert_trees_equal(got, {"params": trees["g_params"], "batch_stats": trees["g_stats"]})
    latest = checkpoint.load_generator_variables(tmp_path / "gan")
    assert_trees_equal(latest["params"], _map(lambda a: a + 1.0, trees["g_params"]))
    CheckpointManager(tmp_path / "u").save(1, UResNetTrainer(
        URESNET, UResNetTrainConfig(), device="cpu").init_state(seed=0))
    with pytest.raises(ValueError, match=r"step 1 is not a GAN training checkpoint \(missing "
                                         r"'g_params'; found \['batch_stats', 'epoch', 'opt', "
                                         r"'params'\]\)"):
        checkpoint.load_generator_variables(tmp_path / "u")


def test_h5_export_reads_back_in_jax(tmp_path):
    """``export_generator_h5`` and ``export_uresnet_h5`` read back by JAX's
    ``import_keras_h5`` equal to the state's generator."""
    rng = np.random.default_rng(2)
    trees = random_trees(rng)
    trees["g_stats"] = _map(lambda a: rng.uniform(0.1, 1, a.shape).astype(np.float32),
                            trees["g_stats"])
    state = gan_train_state_from_trees(trees, 1e-4, 1e-4, 0.0, 0.9, device="cpu")
    checkpoint.export_generator_h5(state, tmp_path / "netG.h5")
    template = _map(jnp.zeros_like, init_generator(GAN, seed=3))
    got = jax_h5.import_keras_h5(str(tmp_path / "netG.h5"), template)
    assert_trees_equal(got, {"params": trees["g_params"], "batch_stats": trees["g_stats"]})

    ustate = UResNetTrainer(URESNET, UResNetTrainConfig(), device="cpu").init_state(seed=4)
    checkpoint.export_uresnet_h5(ustate, tmp_path / "trained.h5")
    got = jax_h5.import_keras_h5(str(tmp_path / "trained.h5"),
                                 _map(jnp.zeros_like, init_generator(URESNET, seed=5)))
    want = uresnet_trees_from_state(ustate)
    assert_trees_equal(got, {"params": want["params"], "batch_stats": want["batch_stats"]})


def _optax_tree(opt_state):
    adam = opt_state[0]
    return {"count": int(adam.count), "mu": _map(np.asarray, adam.mu),
            "nu": _map(np.asarray, adam.nu)}


def test_bridge_round_trip_against_jax_states():
    """A JAX ``GanTrainState`` and ``UResNetTrainState`` (optax Adam states
    with non-zero moments) -> numpy trees -> the port's state -> trees:
    every leaf and count equal to the JAX state's."""
    rng = np.random.default_rng(3)
    trees = random_trees(rng)
    tx = optax.adam(1e-4, b1=0.0, b2=0.9)
    jax_parts = {}
    for name in ("g", "dy2", "ddem"):
        params = _map(jnp.asarray, trees[f"{name}_params"])
        opt = trees[f"{name}_opt"]
        jax_parts[f"{name}_params"] = params
        jax_parts[f"{name}_opt"] = _adam_state(tx, params, opt["count"],
                                               _map(jnp.asarray, opt["mu"]),
                                               _map(jnp.asarray, opt["nu"]))
    jstate = JaxGanTrainState(g_stats=_map(jnp.asarray, trees["g_stats"]), **jax_parts)
    from_jax = {"g_stats": _map(np.asarray, jstate.g_stats)}
    for name in ("g", "dy2", "ddem"):
        from_jax[f"{name}_params"] = _map(np.asarray, getattr(jstate, f"{name}_params"))
        from_jax[f"{name}_opt"] = _optax_tree(getattr(jstate, f"{name}_opt"))
    state = gan_train_state_from_trees(from_jax, 1e-4, 1e-4, 0.0, 0.9, device="cpu")
    assert_trees_equal(gan_trees_from_state(state), from_jax)

    utx = optax.adam(1e-4)
    params = _map(jnp.asarray, trees["g_params"])
    ujax = JaxUResNetTrainState(
        params=params, batch_stats=_map(jnp.asarray, trees["g_stats"]),
        opt_state=_adam_state(utx, params, 7, _map(jnp.asarray, trees["g_opt"]["mu"]),
                              _map(jnp.asarray, trees["g_opt"]["nu"])), epoch=2)
    want = {"params": _map(np.asarray, ujax.params),
            "batch_stats": _map(np.asarray, ujax.batch_stats),
            "opt": _optax_tree(ujax.opt_state)}
    ustate = uresnet_train_state_from_trees(want["params"], want["batch_stats"], want["opt"],
                                            1e-4, device="cpu")
    assert_trees_equal(uresnet_trees_from_state(ustate), want)


def test_event_and_history_files_match_jax_bytes(tmp_path, monkeypatch):
    """With ``time.time`` fixed, the port's ``Logger`` writes JAX's event
    file byte for byte for scalars, images and a histogram, and
    ``LossHistory`` JAX's text; ``read_events`` parses it back with every
    CRC checked, and a flipped byte fails the check."""
    rng = np.random.default_rng(4)
    images = rng.uniform(-1, 1, (2, 8, 8, 1)).astype(np.float32)
    rgb = rng.uniform(-1, 1, (1, 6, 5, 3)).astype(np.float32)
    hist = rng.normal(size=500)
    for module in (tb_writer, jax_tb):
        monkeypatch.setattr(module.time, "time", lambda: 1234567890.25)
    for name, mod in (("port", logging), ("jax", jax_logging)):
        log = mod.Logger(tmp_path / name)
        log.log_scalar("errG_losses", np.float32(1.5), 3)
        log.log_scalars({"a": 0.25, "b": -2.0}, 4)
        log.log_images("attributed_img_step4", images, 4)
        log.log_images("rgb", rgb, 5)
        log.log_histogram("weights", hist, 6, bins=50)
        log.close()
        history = mod.LossHistory(tmp_path / name / "loss.txt")
        history.append(0.5)
        history.append([0.25, 0.125])
    (port,), (ref,) = (list((tmp_path / n).glob("events.*")) for n in ("port", "jax"))
    assert port.read_bytes() == ref.read_bytes()
    assert ((tmp_path / "port" / "loss.txt").read_bytes()
            == (tmp_path / "jax" / "loss.txt").read_bytes())

    events = tb_writer.read_events(port)
    assert events[0]["file_version"] == "brain.Event:2"
    got = [(v[0], v[1], e["step"]) for e in events for v in e["values"]]
    assert got == [("errG_losses", "scalar", 3), ("a", "scalar", 4), ("b", "scalar", 4),
                   ("attributed_img_step4/0", "image", 4), ("attributed_img_step4/1", "image", 4),
                   ("rgb/0", "image", 5), ("weights", "histogram", 6)]
    assert events[1]["values"][0][2] == 1.5 and events[1]["wall_time"] == 1234567890.25
    assert all(v[2][:8] == b"\x89PNG\r\n\x1a\n" for e in events for v in e["values"]
               if v[1] == "image")
    data = bytearray(port.read_bytes())
    data[-7] ^= 1
    port.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        tb_writer.read_records(port)


def test_log_graph(tmp_path):
    """``log_graph`` runs the function once, returns its result, and writes
    its aten operators as a GraphDef with their data flow, capped at
    ``max_nodes``; ``NullLogger.log_graph`` only runs it."""
    calls = []

    def fn(x, y):
        calls.append(1)
        return torch.relu(x * 2 + y).sum()

    x, y = torch.ones(3), torch.arange(3.0)
    log = logging.Logger(tmp_path)
    assert log.log_graph(fn, (x, y)).item() == 9.0 and len(calls) == 1
    log.log_graph(fn, (x, y), max_nodes=2)
    log.close()
    assert logging.NullLogger().log_graph(fn, (x, y)).item() == 9.0 and len(calls) == 3
    (events,) = [tb_writer.read_events(p) for p in tmp_path.glob("events.*")]
    full, capped = (tb_writer.graph_nodes(e["graph"]) for e in events if e["graph"])
    assert full == [("input_0", "Placeholder", []),
                    ("aten.mul.Tensor_0", "aten.mul.Tensor", ["input_0"]),
                    ("input_1", "Placeholder", []),
                    ("aten.add.Tensor_1", "aten.add.Tensor", ["aten.mul.Tensor_0", "input_1"]),
                    ("aten.relu.default_2", "aten.relu.default", ["aten.add.Tensor_1"]),
                    ("aten.sum.default_3", "aten.sum.default", ["aten.relu.default_2"])]
    assert [n for n in capped if n[1] != "Placeholder"] == [n for n in full[:4]
                                                            if n[1] != "Placeholder"]
