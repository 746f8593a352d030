"""The kernel probes P1-P3 (``ops/probes.py``) against the JAX package's
scripts: the row-blocked conv in interpret mode, the deinterleave's XLA
reference, and the phases of the fused conv against ``conv3x3_s2d_fused``.
The JAX scripts parse ``sys.argv`` when imported, so they are loaded with
it set; P1's and P3's Pallas kernels set no interpret flag and cannot run on
a CPU, so their plain references stand in."""

import importlib.util
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depgan_tpu.ops import conv_s2d_pallas as csp
from depgan_tpu_torch.ops import probes

REPO = Path(__file__).resolve().parents[1]
ATOL = 2e-4


def _jax_script(name, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["probe"])
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _conv_inputs(n=12, c4=32, co4=64, seed=0):
    rng = np.random.default_rng(seed)
    x = np.zeros((2, n + 2, n + 2, c4), np.float32)
    x[:, 1:n + 1, 1:n + 1] = rng.normal(size=(2, n, n, c4))
    w4 = (rng.normal(size=(2, 2, c4, co4)) / np.sqrt(4 * c4)).astype(np.float32)
    return x, w4, rng.normal(0, 0.1, co4).astype(np.float32)


def test_rowblk_matches_jax(monkeypatch):
    """P2's plain version against the JAX probe's kernel in interpret mode,
    which equals the JAX package's conv3x3_s2d_fused exactly."""
    rowblk = _jax_script("rowblk_probe", monkeypatch)
    x, w4, bias = _conv_inputs(n=16, c4=32, co4=32)
    ref = rowblk.conv3x3_rowblk(jnp.asarray(x), jnp.asarray(w4), jnp.asarray(bias), 3)
    fused = csp.conv3x3_s2d_fused(jnp.asarray(x), jnp.asarray(w4), jnp.asarray(bias), mode="relu")
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(fused))
    out = probes.conv3x3_rowblk(*map(torch.from_numpy, (x, w4, bias)), 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    with pytest.raises(ValueError, match="divide"):
        probes.conv3x3_rowblk(*map(torch.from_numpy, (x, w4, bias)), 4)


def test_deint_matches_xla_strided(monkeypatch):
    deint = _jax_script("packed_tap_probe", monkeypatch)
    x = np.random.default_rng(1).normal(size=(2, 6, 10, 8)).astype(np.float32)
    ref = np.asarray(deint.xla_strided(jnp.asarray(x)))
    for kind in ("reshape_idx", "merge"):
        np.testing.assert_array_equal(probes.deint(torch.from_numpy(x), kind).numpy(), ref)
    # On a row-major layout the merge (2m, c) -> (m, 2c) is a reshape.
    np.testing.assert_array_equal(ref, x.reshape(2, 6, 5, 16))


@pytest.mark.parametrize("phase", ["full", "no_epi", "matmul_only"])
def test_anatomy_phases_match_jax(phase):
    """full and matmul_only compute the relu conv, no_epi the conv without
    bias (the 'none' conv with zero bias)."""
    x, w4, bias = _conv_inputs()
    if phase == "no_epi":
        ref = csp.conv3x3_s2d_fused(jnp.asarray(x), jnp.asarray(w4), jnp.zeros(bias.shape),
                                    mode="none")
    else:
        ref = csp.conv3x3_s2d_fused(jnp.asarray(x), jnp.asarray(w4), jnp.asarray(bias), mode="relu")
    xt, wt, bt = map(torch.from_numpy, (x, w4, bias))
    a = probes.gathered_taps(xt) if phase == "matmul_only" else None
    out = probes.kernel_anatomy(phase, xt, wt, bt, reps=2, a_dense=a)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_anatomy_stage_only_sums_the_gathered_taps():
    """stage_only's plain version: the sum of every gathered tap value of
    each block row of the engine's tile, the taps taken here straight from
    the 3x3 gather's definition (tap (A, B), destination group 2p+q reads
    source group 3-(2p+q) at block offset (A+p, B+q))."""
    n, c4, co4 = 12, 32, 64
    x, w4, bias = _conv_inputs(n, c4, co4)
    c = c4 // 4
    per_row = np.zeros((2, n, n))
    for a in range(2):
        for b in range(2):
            for p in range(2):
                for q in range(2):
                    src = 3 - (2 * p + q)
                    per_row += x[:, a + p:a + p + n, b + q:b + q + n, src * c:(src + 1) * c].sum(-1)
    rows = probes.stage_tile_rows(co4, torch.float32, n, c4)
    per_row = np.pad(per_row.reshape(-1), (0, -per_row.size % rows))
    sums = probes.kernel_anatomy("stage_only", *map(torch.from_numpy, (x, w4, bias)))
    np.testing.assert_allclose(sums.numpy(), per_row.reshape(-1, rows).sum(-1), rtol=1e-5,
                               atol=1e-4)


def test_probe_entry_points_import_without_gpu_or_jax():
    """The probes' modules load without JAX and without a card, and each
    ``main`` refuses to time anything without one."""
    code = ("import sys\n"
            "import depgan_tpu_torch.ops.probes\n"
            "from depgan_tpu_torch.scripts import engine_registers, kernel_anatomy, "
            "packed_tap_probe, rowblk_probe\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'jaxlib', 'depgan_tpu'))\n"
            "assert not bad, bad\n"
            "import torch\n"
            "if not torch.cuda.is_available():\n"
            "    for probe in (kernel_anatomy, packed_tap_probe, rowblk_probe):\n"
            "        try:\n"
            "            probe.main(['2'])\n"
            "        except SystemExit as e:\n"
            "            assert 'CUDA' in str(e), e\n"
            "        else:\n"
            "            raise AssertionError(probe)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
