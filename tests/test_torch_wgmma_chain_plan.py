"""K10's wgmma chain plan on the CPU, against the plain chain and JAX.

``ops/wgmma_plan.py`` mirrors ``ChainPlan`` in ``csrc/s2d_wgmma.cuh``: a
T x T tile of outputs, its two intermediate regions in shared memory at
pitch T + 4, and each stage computed over its region's rows x pitch
flattened into GEMM rows, in passes, reading the previous region at
+ dy * pitch + dx pixels. ``run_chain`` runs those stages in plain torch as
the kernel walks them; here its result is held to
``conv3x3_s2d_chain3_plain`` and to the JAX package's
``conv3x3_s2d_chain3`` (interpret mode on the CPU), f32, atol 2e-4, at the
kernel's widths (4Cm 128 and 256) and small n, for one- and two-operand
sites and each pool mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depgan_tpu.ops import conv_s2d_pallas as P
from depgan_tpu_torch.ops import conv_s2d as K
from depgan_tpu_torch.ops import wgmma_plan as W

ATOL = 2e-4
# Site kinds at small n: (n, stage-0 4C, 4Cm, pool). m1 and p1 are level-1
# kinds (4Cm 128: T 12, n 14 gives a tail tile), m2 and p2 level-2 kinds
# (4Cm 256: T 8, two passes of stage 0); m1's 4C 32 takes cp.async, the
# others TMA boxes.
SITES = {"m1": (14, (32,), 128, "s2d"), "m2": (10, (128,), 256, "pixel"),
         "p2": (10, (96, 64), 256, ""), "p1": (14, (64, 32), 128, "")}
# The production sites: (n, stage-0 4C, 4Cm, pool) -> (route, T, passes,
# ring stages).
PRODUCTION = {(128, (32,), 128, "s2d"): ("cp.async", 12, (1, 1, 1), 3),
              (64, (128,), 256, "pixel"): ("tma", 8, (2, 1, 1), 2),
              (64, (384, 256), 256, ""): ("tma", 8, (2, 1, 1), 2),
              (128, (256, 128), 128, ""): ("tma", 12, (1, 1, 1), 3)}


def _site(name, seed=0):
    """The plan and f32 inputs of one site kind: planes, stage-0 weights,
    then b0, w1, b1, gamma, beta, w2, b2 (FiLM vectors around 1 and 0)."""
    n, c4s, c4m, pool = SITES[name]
    rng = np.random.default_rng(seed)
    planes = []
    for c4 in c4s:
        x = np.zeros((2, n + 2, n + 2, c4), np.float32)
        x[:, 1:n + 1, 1:n + 1] = rng.normal(size=(2, n, n, c4))
        planes.append(x)
    w0s = [(rng.normal(size=(2, 2, c4, c4m)) / np.sqrt(4 * sum(c4s))).astype(np.float32)
           for c4 in c4s]
    w = lambda: (rng.normal(size=(2, 2, c4m, c4m)) / np.sqrt(4 * c4m)).astype(np.float32)  # noqa: E731
    v = lambda *s, mean=0.0: rng.normal(mean, 0.3, size=s).astype(np.float32)  # noqa: E731
    rest = [v(c4m), w(), v(c4m), v(2, c4m, mean=1.0), v(2, c4m), w(), v(c4m)]
    return W.chain_plan(n, c4s, c4m, c4m, pool), planes, w0s, rest, pool


@pytest.mark.parametrize("name", sorted(SITES))
def test_chain_stages_match_plain_and_jax(name):
    """The plan's stages over the flattened pitch grid, region pixels no
    stage writes holding NaN, against the plain chain and JAX's."""
    p, planes, w0s, (b0, w1, b1, gamma, beta, w2, b2), pool = _site(name)
    t = [torch.from_numpy(a) for a in (b0, w1, b1, gamma, beta, w2, b2)]
    got = W.run_chain(p, [torch.from_numpy(x) for x in planes],
                      [torch.from_numpy(w) for w in w0s], *t, pool=pool)
    two = len(planes) == 2
    args = (planes[0], w0s[0], b0, w1, b1, gamma, beta, w2, b2)
    x2, w1b = (planes[1], w0s[1]) if two else (None, None)
    with torch.no_grad():
        plain = K.conv3x3_s2d_chain3(*(torch.from_numpy(a) for a in args),
                                     x2_padded=None if x2 is None else torch.from_numpy(x2),
                                     w1b4=None if w1b is None else torch.from_numpy(w1b),
                                     pool=pool)
    ref = P.conv3x3_s2d_chain3(*(jnp.asarray(a) for a in args),
                               x2_padded=None if x2 is None else jnp.asarray(x2),
                               w1b4=None if w1b is None else jnp.asarray(w1b), pool=pool)
    plain = plain if pool else (plain,)
    ref = ref if pool else (ref,)
    outs = (got["out"], got["pooled"]) if pool else (got["out"],)
    for o, pl_, r in zip(outs, plain, ref):
        assert bool(torch.isfinite(o).all())
        np.testing.assert_allclose(o.numpy(), pl_.numpy(), atol=ATOL, rtol=0)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=ATOL, rtol=0)


def test_outputs_stored_once_and_regions_zero_off_the_plane():
    """Every interior output position is stored by exactly one tile and no
    ring position by any; in every tile's regions the positions off the
    plane's interior and the columns past a stage's side hold exact zeros."""
    for name in sorted(SITES):
        p, planes, w0s, rest, pool = _site(name, seed=1)
        n = planes[0].shape[1] - 2
        got = W.run_chain(p, [torch.from_numpy(x) for x in planes],
                          [torch.from_numpy(w) for w in w0s],
                          *(torch.from_numpy(a) for a in rest), pool=pool)
        stores = got["stores"]
        assert bool((stores[:, 1:n + 1, 1:n + 1] == 1).all()), name
        assert int(stores.sum()) == 2 * n * n, name
        for (b, y0, x0), *regions in got["regions"]:
            for s, region in enumerate(regions):
                rows = W.chain_rows(p.tile, s)
                f = torch.arange(rows * p.pitch)
                ry, rx = f // p.pitch, f % p.pitch
                yp, xp = y0 - 2 + s + ry, x0 - 2 + s + rx
                off = ~((yp >= 1) & (yp <= n) & (xp >= 1) & (xp <= n)) | (rx >= p.tile + 4 - 2 * s)
                assert not region[f[off]].any(), (name, s, b, y0, x0)
                assert bool(torch.isfinite(region[f]).all()), (name, s)


def test_production_chain_plans():
    """The four serving sites: route, T, passes and ring stages as PERF.md
    states (3 at level 1, the A ring running past region 1; 2 at level 2),
    inside the shared memory beside two regions, each pass's GEMM rows whole
    region rows, every read of a region inside it, and the library's
    layout; widths the kernel refuses raise."""
    for (n, c4s, c4m, pool), (route, tile, passes, stages) in PRODUCTION.items():
        p = W.chain_plan(n, c4s, c4m, c4m, pool)
        assert (p.route, p.tile, p.passes, p.stages) == (route, tile, passes, stages)
        assert p.bn == c4m and p.mt * c4m == 256 and p.pitch == tile + 4
        assert p.smem <= W.SMEM_MAX and p.region <= p.area1
        assert p.area1 == max(p.region, p.stages * W.BM * p.mt * W.BK * 2)
        bmp = W.BM * p.mt
        for s in range(3):
            assert p.prow[s] * p.pitch <= bmp
            assert p.passes[s] * p.prow[s] >= W.chain_rows(tile, s)
            if s:  # the last pass's rows, shifted by the farthest tap, stay in the region
                assert (p.passes[s] - 1) * p.prow[s] * p.pitch + bmp + 2 * p.pitch + 2 <= p.rpx
        assert p.region >= c4m // 8 * p.lead and p.lead == 16 * p.rpx
        assert W.chain_ints(p) == [W.ROUTES.index(route), c4m, p.mt, tile, tile + 4, *p.prow,
                                   *passes, p.rpx, p.lead, p.region, p.area1, p.stages, p.smem]
    for n, c4s, c4m, c4o, pool in ((64, (128,), 64, 64, ""), (64, (128,), 256, 128, ""),
                                   (64, (48,), 256, 256, ""), (63, (128,), 256, 256, "s2d"),
                                   (64, (128, 128, 128), 256, 256, "")):
        with pytest.raises(ValueError):
            W.chain_plan(n, c4s, c4m, c4o, pool)
