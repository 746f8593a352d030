"""The hand-written CUDA kernels against their plain versions, on a card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX, so it also runs where JAX is not installed; from the repository
root on a machine with a card:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py

(``--noconftest`` leaves out ``tests/conftest.py``, which sets JAX up for the
rest of the suite.) The shapes are small and ragged on purpose: GEMM rows,
depth and columns that are not multiples of the kernels' tiles.
"""

import numpy as np
import pytest
import torch

from depgan_tpu_torch.config import ModelConfig, UResNetTrainConfig
from depgan_tpu_torch.io.flax_bridge import (
    flatten_tree, load_flax_variables, unflatten_tree, uresnet_train_state_from_trees)
from depgan_tpu_torch.models import DisC2DFCN1, GenUNet2D, init_critic, init_generator
from depgan_tpu_torch.models.generator import dropout_masks
from depgan_tpu_torch.ops import conv_s2d as K
from depgan_tpu_torch.ops import s2d_conv as S
from depgan_tpu_torch.ops.fast_critic import FusedCritic
from depgan_tpu_torch.ops.fast_gen import FastGenerator, FusedGenerator
from depgan_tpu_torch.ops.film import film_residual, film_residual_plain
from depgan_tpu_torch.ops import probes, wgmma_plan
from depgan_tpu_torch.train.state import adam_moments
from depgan_tpu_torch.train.uresnet_trainer import UResNetTrainer

TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}

# kernel -> shape arguments; n is the interior side of the output plane.
CASES = {
    "relu_ragged_n": ("fused", dict(b=2, n=12, c4=32, co4=40)),
    "relu_two_column_blocks": ("fused", dict(b=3, n=16, c4=128, co4=256)),
    "film": ("fused", dict(b=2, n=10, c4=64, co4=64, film=True)),
    "pool_s2d_256": ("fused", dict(b=2, n=10, c4=32, co4=256, pool="s2d")),
    "pool_pixel_odd_n": ("fused", dict(b=2, n=9, c4=32, co4=128, pool="pixel")),
    "fused2": ("fused2", dict(b=2, n=12, c4=96, c4b=32, co4=64)),
    "deconv_ragged_k": ("deconv", dict(b=2, n=12, c4=32, co4=64)),
    "none_narrow_out": ("fused", dict(b=2, n=12, c4=64, co4=32, mode="none")),
    "conv5_entry_16": ("conv5", dict(b=2, n=12, c4=16, co4=64, mode="relu")),
    "conv5_none_to_16": ("conv5", dict(b=2, n=10, c4=64, co4=16, mode="none")),
    "conv5_two_column_blocks": ("conv5", dict(b=2, n=8, c4=24, co4=136, mode="relu")),
    "pool_s2d_kernel": ("pool", dict(b=2, n=10, c4=64, to_s2d=False)),
    "pool_to_s2d_kernel": ("pool", dict(b=3, n=12, c4=32, to_s2d=True)),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _case(kind, a, dtype, device, seed=0):
    """(launch counter name, kernel, plain version, inputs, keyword args)."""
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, std=1.0, mean=0.0):
        return torch.randn(shape, generator=g, device=device) * std + mean

    def plane(n, c4):
        return K.pad_s2d(randn(a["b"], n, n, c4)).to(dtype)

    if kind == "pool":
        to_s2d = a["to_s2d"]
        name = "pool_to_s2d" if to_s2d else "pool_s2d"
        return (name, lambda x: K._pool_impl(x, to_s2d),
                K.pool_to_s2d_plain if to_s2d else K.pool_s2d_plain, (plane(a["n"], a["c4"]),), {})
    bias = randn(a["co4"], std=0.1)
    if kind == "conv5":
        w9 = randn(3, 3, a["c4"], a["co4"], std=(9 * a["c4"]) ** -0.5).to(dtype)
        return ("conv5x5_s2d_fused", K._conv5_impl, K.conv5x5_s2d_fused_plain,
                (plane(a["n"], a["c4"]), w9, bias), {"mode": a["mode"]})
    if kind == "deconv":
        x = plane(a["n"] // 2, a["c4"])
        w2 = randn(a["c4"] // 4, a["co4"], std=0.3).to(dtype)
        return "deconv_s2d", K._deconv_impl, K.deconv_s2d_plain, (x, w2, bias), {}
    x = plane(a["n"], a["c4"])
    w4 = randn(2, 2, a["c4"], a["co4"], std=(4 * a["c4"]) ** -0.5).to(dtype)
    if kind == "fused2":
        w4b = randn(2, 2, a["c4b"], a["co4"], std=(4 * a["c4b"]) ** -0.5).to(dtype)
        return ("conv3x3_s2d_fused2", K._conv2_impl, K.conv3x3_s2d_fused2_plain,
                (x, plane(a["n"], a["c4b"]), w4, w4b, bias), {})
    if "pool" in a:
        return ("conv3x3_s2d_fused_pool", K.conv3x3_s2d_fused_pool,
                K.conv3x3_s2d_fused_pool_plain, (x, w4, bias), {"pool": a["pool"]})
    if a.get("film"):
        gamma, beta = randn(a["b"], a["c4"], std=0.3, mean=1.0), randn(a["b"], a["c4"], std=0.3)
        return ("conv3x3_s2d_fused", K._conv3x3_s2d_impl, K.conv3x3_s2d_fused_plain,
                (x, w4, bias, gamma, beta), {"mode": "film"})
    mode = a.get("mode", "relu")
    name = "conv3x3_s2d_fused[none]" if mode == "none" else "conv3x3_s2d_fused"
    return (name, K._conv3x3_s2d_impl, K.conv3x3_s2d_fused_plain, (x, w4, bias),
            {"mode": mode})


# The float32 engine at every shape a float32 superstep launches (batch 2 of
# its 16): K1 relu and film at the generator's sites, K1 none at the dX of
# its backward, K3 at the decoder's two-operand convs, K4 at p2 -> p1 and K7
# at the critics' four 5x5 levels and their transposes; and the pooled
# conv_out. 4Co <= 64 takes the 256 x 64 block tile, wider outputs 128 x 128
# (64 x 256 pooled at 4Co = 256). The ragged cases have GEMM rows that are not
# a whole number of block tiles, at each tile.
SUPERSTEP_F32 = {
    "k1_relu_l1_32_128": ("fused", dict(b=2, n=128, c4=32, co4=128)),
    "k1_relu_l1_128_128": ("fused", dict(b=2, n=128, c4=128, co4=128)),
    "k1_relu_l2_128_256": ("fused", dict(b=2, n=64, c4=128, co4=256)),
    "k1_relu_l2_256_256": ("fused", dict(b=2, n=64, c4=256, co4=256)),
    "k1_film_l1_128": ("fused", dict(b=2, n=128, c4=128, co4=128, film=True)),
    "k1_film_l2_256": ("fused", dict(b=2, n=64, c4=256, co4=256, film=True)),
    "k1_none_l1_128_128": ("fused", dict(b=2, n=128, c4=128, co4=128, mode="none")),
    "k1_none_p1_128_256": ("fused", dict(b=2, n=128, c4=128, co4=256, mode="none")),
    "k1_none_l2_256_128": ("fused", dict(b=2, n=64, c4=256, co4=128, mode="none")),
    "k1_none_l2_256_256": ("fused", dict(b=2, n=64, c4=256, co4=256, mode="none")),
    "k1_none_p2_256_384": ("fused", dict(b=2, n=64, c4=256, co4=384, mode="none")),
    "k3_p2_384_256": ("fused2", dict(b=2, n=64, c4=384, c4b=256, co4=256)),
    "k3_p1_256_128": ("fused2", dict(b=2, n=128, c4=256, c4b=128, co4=128)),
    "k4_p2_p1_256": ("deconv", dict(b=2, n=128, c4=256, co4=256)),
    "k7_relu_l0a_16_64": ("conv5", dict(b=2, n=128, c4=16, co4=64, mode="relu")),
    "k7_relu_l0b_64_64": ("conv5", dict(b=2, n=128, c4=64, co4=64, mode="relu")),
    "k7_relu_l1a_64_128": ("conv5", dict(b=2, n=64, c4=64, co4=128, mode="relu")),
    "k7_relu_l1b_128_128": ("conv5", dict(b=2, n=64, c4=128, co4=128, mode="relu")),
    "k7_none_l0a_64_16": ("conv5", dict(b=2, n=128, c4=64, co4=16, mode="none")),
    "k7_none_l0b_64_64": ("conv5", dict(b=2, n=128, c4=64, co4=64, mode="none")),
    "k7_none_l1a_128_64": ("conv5", dict(b=2, n=64, c4=128, co4=64, mode="none")),
    "k7_none_l1b_128_128": ("conv5", dict(b=2, n=64, c4=128, co4=128, mode="none")),
    "k2_pool_s2d_l1_128": ("fused", dict(b=2, n=128, c4=128, co4=128, pool="s2d")),
    "k2_pool_pixel_l2_256": ("fused", dict(b=2, n=64, c4=256, co4=256, pool="pixel")),
    "ragged_k1_relu_tile_256x64": ("fused", dict(b=2, n=13, c4=128, co4=64)),
    "ragged_k3_tile_128x128": ("fused2", dict(b=3, n=11, c4=256, c4b=128, co4=128)),
    "ragged_k7_none_tile_256x64": ("conv5", dict(b=2, n=13, c4=64, co4=16, mode="none")),
    "ragged_k2_pool_tile_64x256": ("fused", dict(b=2, n=10, c4=32, co4=256, pool="s2d")),
}


def _check_kernel_case(kind, args, dt, cuda):
    """One launch against the plain version (atol = rtol = TOL), counted
    once, its padded planes' rings exactly zero."""
    name, kernel, plain, inputs, kwargs = _case(kind, args, dt, cuda)
    before = K.launches()[name]
    out = kernel(*inputs, **kwargs)
    torch.cuda.synchronize()
    assert K.launches()[name] == before + 1
    ref = plain(*inputs, **kwargs)
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    for j, (o, r) in enumerate(zip(outs, refs)):
        assert o.dtype == r.dtype and o.shape == r.shape
        torch.testing.assert_close(o.float(), r.float(), atol=TOL[dt], rtol=TOL[dt])
        pixel = (kind == "pool" and not args["to_s2d"]) or (j == 1 and args.get("pool") == "pixel")
        if not pixel:  # a padded plane
            n = o.shape[1] - 2
            ring = torch.ones(o.shape[1:3], dtype=torch.bool, device=cuda)
            ring[1:n + 1, 1:n + 1] = False
            assert not o[:, ring].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain(cuda, case, dtype):
    kind, args = CASES[case]
    _check_kernel_case(kind, args, getattr(torch, dtype), cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(SUPERSTEP_F32))
def test_float32_engine_at_superstep_shapes(cuda, case):
    """The float32 engine's register-tiled mainloop at the superstep's
    shapes and both tile widths, ragged GEMM rows included."""
    kind, args = SUPERSTEP_F32[case]
    _check_kernel_case(kind, args, torch.float32, cuda)


@pytest.mark.gpu
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    _, _, _, (x, w4, bias), _ = _case("fused", CASES["relu_two_column_blocks"][1],
                                      torch.float32, cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        K.conv3x3_s2d_fused(x.half(), w4.half(), bias)
    with pytest.raises(ValueError, match="contiguous"):
        K.conv3x3_s2d_fused(x.transpose(1, 2), w4, bias)
    with pytest.raises(ValueError, match="different devices"):
        K.conv3x3_s2d_fused(x, w4.cpu(), bias)
    with pytest.raises(ValueError, match="multiple of 32"):
        K.conv3x3_s2d_fused(x[..., :120].contiguous(), w4[:, :, :120].contiguous(), bias)
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.deconv_s2d(x.flatten()[1:1 + x.numel() // 2].view(3, 18, 18, 64)[..., :64],
                     torch.zeros(16, 64, device=cuda), torch.zeros(64, device=cuda))
    with pytest.raises(ValueError, match="at most 256"):
        K.conv3x3_s2d_fused_pool(x, torch.zeros(2, 2, 128, 512, device=cuda),
                                 torch.zeros(512, device=cuda))
    # bf16 4Co 96 is outside the wgmma pool's widths: the wrapper launches
    # the engine's K2, counted as K2, and equals it bit for bit.
    before = K.launches()["conv3x3_s2d_fused_pool"]
    xb, wb = x.bfloat16(), (0.05 * torch.randn(2, 2, 128, 96, device=cuda)).bfloat16()
    b96 = torch.randn(96, device=cuda)
    assert K.kernel_route("conv3x3_s2d_fused_pool", (16, 128, 96, "s2d"), xb.dtype) == "engine"
    out, pooled = K.conv3x3_s2d_fused_pool(xb, wb, b96)
    ref, ref_pooled = probes.conv3x3_engine(xb, wb, b96, pool="s2d")
    assert torch.equal(out, ref) and torch.equal(pooled, ref_pooled)
    assert K.launches()["conv3x3_s2d_fused_pool"] == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("first_fm", [24, 48, 64])
def test_fast_generator_at_other_widths(cuda, first_fm):
    """bf16 serving at widths the wgmma plans refuse somewhere (K2 at 4Co 96,
    192, 384, 512; K4 at 4C 512 at image 256): every site runs a kernel (the
    engine, or K1 and the pool kernel where the fused pool takes no 4Co above
    256), the launches are those of the routes, and the output is within the
    serving gate of the plain float32 generator."""
    from depgan_tpu_torch.ops.fast_gen import taken_launches

    cfg = ModelConfig(image_size=64, first_fm=first_fm)
    rng = np.random.default_rng(first_fm)
    variables = init_generator(cfg, seed=first_fm)
    x = torch.from_numpy(rng.uniform(size=(2, 64, 64, 1)).astype(np.float32)).to(cuda)
    z = torch.from_numpy(rng.normal(size=(2, 32, 1)).astype(np.float32)).to(cuda)
    with torch.no_grad():
        ref = load_flax_variables(GenUNet2D(cfg, device=cuda), variables).eval()(x, z)
    fast = FastGenerator(cfg, variables, torch.bfloat16, cuda)
    K.reset_launch_counts()
    out = fast(x, z)
    torch.cuda.synchronize()
    assert "plain" not in fast.taken.values(), fast.taken
    assert {k: v for k, v in K.launches().items() if v} == taken_launches(cfg, fast.taken)
    diff = float((out - ref).abs().max())
    print(f"first_fm {first_fm}: max abs {diff:.3e} from the plain float32 generator, "
          f"routes {fast.taken}")
    assert diff < 0.05


@pytest.mark.gpu
@pytest.mark.parametrize("n_out", [1, 4])
def test_fast_generator_on_cuda(cuda, n_out):
    cfg = ModelConfig(image_size=32, first_fm=8, n_out=n_out)
    rng = np.random.default_rng(n_out)
    variables = init_generator(cfg, seed=n_out)
    x = torch.from_numpy(rng.uniform(size=(2, 32, 32, 1)).astype(np.float32)).to(cuda)
    z = torch.from_numpy(rng.normal(size=(2, 32, 1)).astype(np.float32)).to(cuda)
    with torch.no_grad():
        ref = load_flax_variables(GenUNet2D(cfg, device=cuda), variables).eval()(x, z)
    K.reset_launch_counts()
    out32 = FastGenerator(cfg, variables, torch.float32, cuda)(x, z)
    out16 = FastGenerator(cfg, variables, torch.bfloat16, cuda)(x, z)
    assert {k: v for k, v in K.launches().items() if v} == {
        "conv3x3_s2d_fused": 16, "conv3x3_s2d_fused_pool": 4, "conv3x3_s2d_fused2": 4,
        "deconv_s2d": 2}
    torch.testing.assert_close(out32, ref, atol=2e-4, rtol=0)
    assert float((out16 - ref).abs().max()) < 0.05


# The serving options' kernels: (shape arguments); ragged n against the
# chain's 8 x 8 output tiles, two column blocks at 4Cm = 256, an output
# width that is no multiple of 32.
CHAIN_CASES = {
    "chain3_pool_s2d": dict(b=2, n=10, c4a=32, c4m=64, c4o=64, pool="s2d"),
    "chain3_pool_pixel_wide": dict(b=2, n=12, c4a=64, c4m=256, c4o=256, pool="pixel"),
    "chain3_two_operand": dict(b=2, n=9, c4a=96, c4b=32, c4m=64, c4o=40),
    "chain2_relu_film": dict(b=2, n=10, c4a=32, c4m=64, c4o=64, modes=("relu", "film")),
    "chain2_film_none": dict(b=2, n=11, c4a=64, c4m=64, c4o=32, modes=("film", "none")),
    "head": dict(b=2, n=12, c4a=64, c4m=128, h4=4),
}
# bfloat16 K10 runs the wgmma chain, which takes 4Cm = 4Co of 128 or 256: its
# widths where a float32 case's are others (ragged n against the plan's T x T
# tiles stays). The float32 widths run in bfloat16 through the old route
# (s2d_chain), which still takes them.
CHAIN3_WGMMA_WIDTHS = {"chain3_pool_s2d": dict(c4m=128, c4o=128),
                       "chain3_two_operand": dict(c4m=128, c4o=128)}


def _chain_case(a, dtype, device, seed=0, old_route=False):
    """(launch counter name, kernel call, plain call, the sequential kernels'
    call or None) on inputs made from ``seed``; with ``old_route`` K10's
    call is ``probes.conv3x3_chain3_wmma``, which counts no launch."""
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, std=1.0, mean=0.0):
        return torch.randn(shape, generator=g, device=device) * std + mean

    def plane(c4):
        return K.pad_s2d(randn(a["b"], a["n"], a["n"], c4)).to(dtype)

    def w4(ci, co):
        return randn(2, 2, ci, co, std=(4 * ci) ** -0.5).to(dtype)

    x, c4a, c4m = plane(a["c4a"]), a["c4a"], a["c4m"]
    if "h4" in a:
        args = (x, w4(c4a, c4m), randn(c4m, std=0.1), randn(1, 1, c4m, a["h4"], std=0.3),
                randn(a["h4"], std=0.1))
        kernel = lambda: K.conv3x3_s2d_fused_head(*args)  # noqa: E731
        kernel.args = args
        return ("conv3x3_s2d_fused_head", kernel,
                lambda: K.conv3x3_s2d_fused_head_plain(*args), None)
    c4o = a["c4o"]
    gamma, beta = randn(a["b"], c4m, std=0.3, mean=1.0), randn(a["b"], c4m, std=0.3)
    if "modes" in a:
        modes = a["modes"]
        args = (x, w4(c4a, c4m), randn(c4m, std=0.1), w4(c4m, c4o), randn(c4o, std=0.1),
                gamma, beta)

        def sequential():
            h = K._conv3x3_s2d_impl(*args[:3], gamma, beta, mode=modes[0])
            return K._conv3x3_s2d_impl(h, *args[3:5], gamma, beta, mode=modes[1])

        return ("conv3x3_s2d_chain2", lambda: K.conv3x3_s2d_chain2(*args, modes=modes),
                lambda: K.conv3x3_s2d_chain2_plain(*args, modes=modes), sequential)
    x2, w1b = (plane(a["c4b"]), w4(a["c4b"], c4m)) if "c4b" in a else (None, None)
    args = (x, w4(c4a, c4m), randn(c4m, std=0.1), w4(c4m, c4m), randn(c4m, std=0.1), gamma,
            beta, w4(c4m, c4o), randn(c4o, std=0.1))
    pool = a.get("pool", "")

    def sequential():
        h = (K._conv3x3_s2d_impl(*args[:3]) if x2 is None
             else K._conv2_impl(x, x2, args[1], w1b, args[2]))
        h = K._conv3x3_s2d_impl(h, *args[3:7], mode="film")
        if pool:
            return K.conv3x3_s2d_fused_pool(h, *args[7:], pool=pool)
        return K._conv3x3_s2d_impl(h, *args[7:])

    chain3 = probes.conv3x3_chain3_wmma if old_route else K.conv3x3_s2d_chain3
    return ("conv3x3_s2d_chain3",
            lambda: chain3(*args, x2_padded=x2, w1b4=w1b, pool=pool),
            lambda: K.conv3x3_s2d_chain3_plain(*args, x2, w1b, pool), sequential)


def _head_rounding_slack(x_padded, w4, bias4, w_head4, rel=5e-6):
    """K9 rounds its relu output to bf16: where a float32 value lies within
    ``rel`` (1 + |y|) of a bf16 rounding boundary, the kernel's and the plain
    version's sums (taken in other orders) may round it either way. Per
    head logit: one bf16 ulp times the head weight's size for each such
    value."""
    y = torch.relu(K._matmul_taps(K._taps(x_padded), w4) + bias4.float())
    tol = rel * (1 + y.abs())
    either = (y - tol).to(torch.bfloat16) != (y + tol).to(torch.bfloat16)
    ulp = torch.exp2(torch.floor(torch.log2((y + tol).clamp_min(1e-30))) - 7)
    return (either * ulp) @ w_head4.reshape(w4.shape[-1], -1).to(torch.bfloat16).float().abs()


def _ring_zero(plane):
    n = plane.shape[1] - 2
    ring = torch.ones(plane.shape[1:3], dtype=torch.bool, device=plane.device)
    ring[1:n + 1, 1:n + 1] = False
    return not plane[:, ring].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CHAIN_CASES))
def test_chain_and_head_kernels_match_plain(cuda, case, dtype):
    """Against the plain version (f32 atol 1e-4, for K9 plus its bf16
    rounding ties; bf16 atol = rtol = 1e-2), rings exactly zero, and the
    chains against the sequential kernels on the same inputs: bit for bit,
    the chain summing each product in the engine's order and rounding where
    the sequential kernels store. bfloat16 K10 runs at the wgmma chain's
    widths, and the old route at the case's own."""
    dt = getattr(torch, dtype)
    a = CHAIN_CASES[case]
    if dt == torch.bfloat16 and "c4o" in a and "modes" not in a:
        _check_chain_case(dict(a, **CHAIN3_WGMMA_WIDTHS.get(case, {})), dt, cuda)
        _check_chain_case(a, dt, cuda, old_route=True)
    else:
        _check_chain_case(a, dt, cuda)


def _check_chain_case(a, dt, cuda, old_route=False):
    name, kernel, plain, sequential = _chain_case(a, dt, cuda, old_route=old_route)
    before = K.launches()[name]
    with torch.no_grad():
        out = kernel()
    torch.cuda.synchronize()
    assert K.launches()[name] == before + (0 if old_route else 1)
    outs, refs = (out if isinstance(out, tuple) else (out,)), plain()
    refs = refs if isinstance(refs, tuple) else (refs,)
    for j, (o, r) in enumerate(zip(outs, refs)):
        assert o.dtype == r.dtype and o.shape == r.shape
        if name == "conv3x3_s2d_fused_head" and dt == torch.float32:
            slack = _head_rounding_slack(*kernel.args[:4])
            assert bool(((o - r).abs() <= TOL[dt] + slack).all())
        else:
            torch.testing.assert_close(o.float(), r.float(), atol=TOL[dt], rtol=TOL[dt])
        if name != "conv3x3_s2d_fused_head" and not (j == 1 and a.get("pool") == "pixel"):
            assert _ring_zero(o)
    if sequential is not None:
        seq = sequential()
        seq = seq if isinstance(seq, tuple) else (seq,)
        for o, r in zip(outs, seq):
            torch.testing.assert_close(o, r, atol=0, rtol=0)


@pytest.mark.gpu
def test_chain_and_head_wrappers_refuse_on_cuda(cuda):
    x = K.pad_s2d(torch.randn(2, 8, 8, 48, device=cuda))
    w = torch.randn(2, 2, 48, 48, device=cuda)
    v, gb = torch.zeros(48, device=cuda), torch.zeros(2, 48, device=cuda)
    with pytest.raises(ValueError, match="multiple of 32"):
        K.conv3x3_s2d_chain3(x, w, v, w, v, gb, gb, w, v)
    with pytest.raises(ValueError, match="multiple of 32"):
        K.conv3x3_s2d_chain2(x, w, v, w, v, gb, gb)
    # bfloat16 K10 takes 4Cm = 4Co of 128 or 256 and never falls back
    x = K.pad_s2d(torch.randn(2, 8, 8, 64, device=cuda)).bfloat16()
    w = torch.randn(2, 2, 64, 64, device=cuda).bfloat16()
    v, gb = torch.zeros(64, device=cuda), torch.zeros(2, 64, device=cuda)
    before = K.launches()
    with pytest.raises(ValueError, match="wgmma chain"):
        K.conv3x3_s2d_chain3(x, w, v, w, v, gb, gb, w, v)
    assert K.launches() == before
    x = K.pad_s2d(torch.randn(2, 8, 8, 32, device=cuda))
    with pytest.raises(ValueError, match="4Co <= 256"):
        K.conv3x3_s2d_fused_head(x, torch.zeros(2, 2, 32, 512, device=cuda),
                                 torch.zeros(512, device=cuda),
                                 torch.zeros(1, 1, 512, 4, device=cuda),
                                 torch.zeros(4, device=cuda))
    w = torch.randn(2, 2, 32, 32, device=cuda, requires_grad=True)
    v, gb = torch.zeros(32, device=cuda), torch.zeros(2, 32, device=cuda)
    with pytest.raises(RuntimeError, match="inference-only"):
        K.conv3x3_s2d_chain3(x, w, v, w, v, gb, gb, w, v)


@pytest.mark.gpu
@pytest.mark.parametrize("options", ["fuse_chain", "fuse_head", "both"])
def test_fast_generator_options_on_cuda(cuda, options):
    """The serving forward with each option on the card against the port's
    plain generator on the CPU, with the launches of the path."""
    cfg = ModelConfig(image_size=32, first_fm=8)
    rng = np.random.default_rng(7)
    variables = init_generator(cfg, seed=7)
    x = rng.uniform(size=(2, 32, 32, 1)).astype(np.float32)
    z = rng.normal(size=(2, 32, 1)).astype(np.float32)
    with torch.no_grad():
        ref = load_flax_variables(GenUNet2D(cfg), variables).eval()(
            torch.from_numpy(x), torch.from_numpy(z))
    fast = FastGenerator(cfg, variables, torch.float32, cuda)
    fast.fuse_chain = options in ("fuse_chain", "both")
    fast.fuse_head = options in ("fuse_head", "both")
    K.reset_launch_counts()
    out = fast(torch.from_numpy(x).to(cuda), torch.from_numpy(z).to(cuda)).cpu()
    want = {"fuse_chain": {"conv3x3_s2d_chain3": 4, "deconv_s2d": 1},
            "fuse_head": {"conv3x3_s2d_fused": 7, "conv3x3_s2d_fused_pool": 2,
                          "conv3x3_s2d_fused2": 2, "deconv_s2d": 1,
                          "conv3x3_s2d_fused_head": 1},
            "both": {"conv3x3_s2d_chain3": 3, "conv3x3_s2d_fused2": 1, "conv3x3_s2d_fused": 1,
                     "conv3x3_s2d_fused_head": 1, "deconv_s2d": 1}}[options]
    assert {k: v for k, v in K.launches().items() if v} == want
    # The fused head rounds its input and weights to bf16 (~1e-2 in logits).
    atol = 2e-4 if options == "fuse_chain" else 1e-2
    torch.testing.assert_close(out, ref, atol=atol, rtol=0)


def _grads(fn, inputs, need, seed):
    """fn's output and its gradients wrt the inputs flagged in ``need``,
    for one random cotangent."""
    leaves = [t.detach().clone().requires_grad_(n) for t, n in zip(inputs, need)]
    out = fn(*leaves)
    r = torch.randn(out.shape, generator=torch.Generator(device=out.device).manual_seed(seed),
                    device=out.device)
    grads = torch.autograd.grad((out.float() * r).sum(), [t for t in leaves if t.requires_grad])
    return out, grads


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["relu", "film", "fused2", "deconv", "pool", "pool_to_s2d",
                                "conv5"])
def test_backward_matches_autograd_of_plain(cuda, op):
    """Each autograd rule on the card against autograd of the plain version
    (float32; padded-plane gradients compared on the interior, where the
    plain version also sees the ring)."""
    g = torch.Generator(device=cuda).manual_seed(1)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=g, device=cuda) * std

    def plane(n, c4):
        return K.pad_s2d(randn(2, n, n, c4))

    def w4(ci, co):
        return S.conv3x3_to_s2d_kernel(randn(3, 3, ci, co, std=0.2))[0].contiguous()

    gamma, beta = 1.0 + randn(2, 32, std=0.3), randn(2, 32, std=0.3)
    cases = {
        "relu": (K.conv3x3_s2d_fused, K.conv3x3_s2d_fused_plain,
                 (plane(8, 32), w4(8, 16), randn(64, std=0.1))),
        "film": (lambda *a: K.conv3x3_s2d_fused(*a, mode="film"),
                 lambda *a: K.conv3x3_s2d_fused_plain(*a, mode="film"),
                 (plane(8, 32), w4(8, 8), randn(32, std=0.1), gamma, beta)),
        "fused2": (K.conv3x3_s2d_fused2, K.conv3x3_s2d_fused2_plain,
                   (plane(8, 64), plane(8, 32), w4(16, 8), w4(8, 8), randn(32, std=0.1))),
        "deconv": (K.deconv_s2d, K.deconv_s2d_plain,
                   (plane(4, 64), randn(16, 32, std=0.3), randn(32, std=0.1))),
        "pool": (K.pool_s2d, K.pool_s2d_plain, (plane(8, 32),)),
        "pool_to_s2d": (K.pool_to_s2d, K.pool_to_s2d_plain, (plane(8, 64),)),
        "conv5": (K.conv5x5_s2d_fused,
                  lambda x, w, b: K.conv5x5_s2d_fused_plain(x, *S.conv5x5_to_s2d_kernel(w, b)),
                  (plane(8, 16), randn(5, 5, 4, 16, std=0.2), randn(16, std=0.1))),
    }
    fn, plain, inputs = cases[op]
    need = [True] * len(inputs)
    out, grads = _grads(fn, inputs, need, seed=2)
    ref, ref_grads = _grads(plain, inputs, need, seed=2)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    for i, (a, b) in enumerate(zip(grads, ref_grads)):
        if a.ndim == 4 and a.shape[1] == a.shape[2]:
            a, b = K.unpad_s2d(a), K.unpad_s2d(b)
        torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-4, msg=f"{op} input {i}")


@pytest.mark.gpu
def test_conv5_double_backward_on_cuda(cuda):
    """grad of a function of K7's dX wrt w5 and x, against the plain version."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x = K.pad_s2d(torch.randn(2, 8, 8, 16, generator=g, device=cuda))
    w5 = torch.randn(5, 5, 4, 16, generator=g, device=cuda) * 0.2
    b = torch.randn(16, generator=g, device=cuda) * 0.1
    r = torch.randn(2, 10, 10, 64, generator=g, device=cuda)

    def second(conv):
        xx, ww = x.clone().requires_grad_(), w5.clone().requires_grad_()
        (dx,) = torch.autograd.grad((conv(xx, ww, b) * r).sum(), xx, create_graph=True)
        return torch.autograd.grad((K.unpad_s2d(dx) ** 2).sum(), ww)[0]

    ours = second(K.conv5x5_s2d_fused)
    ref = second(lambda x, w, b: K.conv5x5_s2d_fused_plain(x, *S.conv5x5_to_s2d_kernel(w, b)))
    torch.testing.assert_close(ours, ref, atol=1e-3, rtol=1e-4)


@pytest.mark.gpu
def test_fused_generator_grad_on_cuda(cuda):
    """The training form's parameter gradient against the plain module's."""
    cfg = ModelConfig(image_size=32, first_fm=8)
    variables = init_generator(cfg, seed=4)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(size=(2, 32, 32, 1)).astype(np.float32)).to(cuda)
    z = torch.from_numpy(rng.normal(size=(2, 32, 1)).astype(np.float32)).to(cuda)
    params = {k: torch.tensor(v, device=cuda, requires_grad=True)
              for k, v in flatten_tree(variables["params"]).items()}
    fused = FusedGenerator(cfg, torch.float32)
    W = fused.build_weights({"params": unflatten_tree(params),
                             "batch_stats": variables["batch_stats"]}, cuda)
    K.reset_launch_counts()
    out = fused.forward(W, x, z)
    (out ** 2).sum().backward()
    counts = K.launches()
    assert counts["pool_to_s2d"] == 1 and counts["pool_s2d"] == 1
    assert counts["conv3x3_s2d_fused[none]"] > 0
    module = load_flax_variables(GenUNet2D(cfg, device=cuda), variables)
    ref = module(x, z)
    (ref ** 2).sum().backward()
    torch.testing.assert_close(out, ref, atol=2e-4, rtol=0)
    for name, p in module.named_parameters():
        torch.testing.assert_close(params[name].grad, p.grad, atol=2e-3, rtol=1e-3, msg=name)


@pytest.mark.gpu
def test_fused_critic_gp_on_cuda(cuda):
    """FusedCritic's score, input gradient and the GP's parameter gradient
    on the card against the plain critic with double backward."""
    cfg = ModelConfig(image_size=32, first_fm=8)
    tree = flatten_tree(init_critic(cfg, seed=5)["params"])
    params = {k: torch.tensor(v, device=cuda, requires_grad=True) for k, v in tree.items()}
    x = torch.rand(2, 32, 32, 1, generator=torch.Generator(device=cuda).manual_seed(5),
                   device=cuda)

    def gp(grad):
        return ((grad.square().sum((1, 2, 3)).sqrt() - 1) ** 2).mean()

    score, grad = FusedCritic(cfg, torch.float32).score_and_input_grad(params, x)
    gp(grad).backward()
    module = load_flax_variables(DisC2DFCN1(cfg, device=cuda), init_critic(cfg, seed=5))
    xx = x.clone().requires_grad_()
    ref = module(xx)
    (ref_grad,) = torch.autograd.grad(ref.sum(), xx, create_graph=True)
    gp(ref_grad).backward()
    torch.testing.assert_close(score, ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(grad, ref_grad, atol=1e-4, rtol=1e-4)
    for name, p in module.named_parameters():
        # Biases reach the input gradient only through masks: no gradient
        # or exact zeros, depending on the path autograd took.
        ours, ref = (torch.zeros_like(p) if t is None else t for t in (params[name].grad, p.grad))
        torch.testing.assert_close(ours, ref, atol=1e-3, rtol=1e-3, msg=name)


# K8 at the generator's site shapes (H, C) at image 256, first_fm 32 (p3,
# p2 and p1 repeat m3, m2 and m1), a ragged C and one below a vector.
FILM_CASES = {"m1_256x32": (2, 256, 256, 32), "m2_128x64": (2, 128, 128, 64),
              "m3_64x96": (2, 64, 64, 96), "p4_32x128": (2, 32, 32, 128),
              "ragged_c13": (3, 5, 7, 13), "c3": (2, 3, 5, 3)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(FILM_CASES))
def test_film_kernel_matches_plain(cuda, case, dtype):
    """f32: the plain version's arithmetic exactly (no FMA contraction; atol
    2e-6 all the same); bf16: within one bf16 ulp of the f32 result."""
    dt = getattr(torch, dtype)
    shape = FILM_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(len(case))
    h, trunk = (torch.randn(shape, generator=g, device=cuda).to(dt) for _ in range(2))
    gamma = (1.0 + 0.5 * torch.randn(shape[0], shape[-1], generator=g, device=cuda)).to(dt)
    beta = torch.randn(shape[0], shape[-1], generator=g, device=cuda).to(dt)
    before = K.launches()["film_residual"]
    out = film_residual(h, gamma, beta, trunk)
    torch.cuda.synchronize()
    assert K.launches()["film_residual"] == before + 1
    assert out.dtype == dt and out.shape == h.shape
    if dt == torch.float32:
        torch.testing.assert_close(out, film_residual_plain(h, gamma, beta, trunk), atol=2e-6,
                                   rtol=0)
    else:
        exact = film_residual_plain(h.float(), gamma.float(), beta.float(), trunk.float())
        ulp = torch.exp2(torch.floor(torch.log2(exact.abs().clamp_min(1e-30))) - 7)
        assert bool(((out.float() - exact).abs() <= ulp).all())


@pytest.mark.gpu
def test_film_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    h = torch.randn(2, 8, 8, 16, device=cuda)
    gamma, beta = torch.ones(2, 16, device=cuda), torch.zeros(2, 16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        film_residual(h.transpose(1, 2), gamma, beta, h)
    with pytest.raises(ValueError, match="different devices"):
        film_residual(h, gamma.cpu(), beta, h)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        film_residual(h.half(), gamma, beta, h.half())


@pytest.mark.gpu
def test_uresnet_step_on_cuda_matches_cpu(cuda):
    """One UResNetTrainer step through K8 on the card against the same step
    on the CPU (the kernel's plain version): the same state, batch, noise
    and dropout masks; float32, random weights."""
    cfg = ModelConfig(image_size=32, first_fm=8, n_out=4, dropout_mode="uresnet",
                      use_pallas=True)
    rng = np.random.default_rng(5)
    variables = init_generator(cfg, seed=5)
    params = {k: rng.normal(0, 0.2, v.shape).astype(np.float32)
              for k, v in flatten_tree(variables["params"]).items()}
    tree = unflatten_tree(params)
    x = rng.uniform(size=(6, 32, 32, 1)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[np.digitize(x[..., 0], [0.3, 0.6, 0.85])]
    noise = rng.normal(size=(6, cfg.noise_size, 1)).astype(np.float32)
    masks = dropout_masks(cfg, 4, torch.Generator().manual_seed(5))
    # Adam moments that are not zero, so a rounding-level gradient (the
    # biases before a training BatchNorm have an exact gradient of zero)
    # does not become a step of +-lr.
    opt = {"count": 3,
           "mu": unflatten_tree({k: rng.normal(0, 1e-3, v.shape).astype(np.float32)
                                 for k, v in params.items()}),
           "nu": unflatten_tree({k: rng.uniform(1e-6, 1e-5, v.shape).astype(np.float32)
                                 for k, v in params.items()})}
    runs = {}
    for device in ("cpu", cuda):
        trainer = UResNetTrainer(cfg, UResNetTrainConfig(batch_size=4), device=device)
        state = uresnet_train_state_from_trees(tree, variables["batch_stats"], opt, 1e-4, device)
        K.reset_launch_counts()
        state, loss = trainer.step(
            state, *(torch.from_numpy(a).to(device) for a in (x, y, noise)), [5, 1, 3, 0],
            dropout={k: m.to(device) for k, m in masks.items()})
        runs[str(device)] = (state, float(loss), K.launches()["film_residual"])
    (ref, ref_loss, cpu_launches), (state, loss, launches) = runs["cpu"], runs["cuda"]
    assert cpu_launches == 0 and launches == 7
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    for name, p in state.params.items():
        # Within 5% of lr (1e-4).
        torch.testing.assert_close(p.detach().cpu(), ref.params[name].detach(), atol=5e-6,
                                   rtol=0, msg=name)
    for name, s in state.batch_stats.items():
        torch.testing.assert_close(s.cpu(), ref.batch_stats[name], atol=1e-5, rtol=1e-4, msg=name)
    assert adam_moments(state.opt, state.params)[0] == 4


# K11 (the packed 5x5 conv) at ragged shapes: (b, n, 4C, 4Co, mode); n not a
# multiple of the row group, 4Co below, at and above one N tile.
PACKED_CASES = {"entry_16_to_64": (2, 12, 16, 64, "relu"),
                "none_64_to_16": (2, 10, 64, 16, "none"),
                "ragged_24_to_136": (2, 8, 24, 136, "relu"),
                "rows_20_64_to_40": (3, 20, 64, 40, "none"),
                "wide_n_136": (1, 136, 16, 32, "relu")}


@pytest.fixture
def packed():
    """CONV5_PACKED on for the test, off again after it."""
    K.CONV5_PACKED = True
    yield
    K.CONV5_PACKED = False


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(PACKED_CASES))
def test_conv5_packed_matches_plain_and_k7(cuda, packed, case, dtype):
    """K11 against the plain version (f32 atol 1e-4, bf16 atol = rtol =
    1e-2), its ring exactly zero, and against K7 on the same inputs bit for
    bit: both sum each product in the engine's order. bfloat16 widths the
    wgmma window does not take (4C 24, 4Co 136) launch K7 by the width rule,
    and the old route (window_conv) equals K7 there."""
    dt = getattr(torch, dtype)
    b, n, c4, co4, mode = PACKED_CASES[case]
    _, _, plain, inputs, kwargs = _case("conv5", dict(b=b, n=n, c4=c4, co4=co4, mode=mode), dt,
                                        cuda)
    name = K.conv5_kernel_name(c4, co4, n, dt)
    other = ({"conv5x5_s2d_fused[packed]", "conv5x5_s2d_fused"} - {name}).pop()
    assert (name == "conv5x5_s2d_fused") == (dt == torch.bfloat16 and (c4 % 16 != 0 or co4 > 256))
    before = K.launches()
    out = K._conv5_impl(*inputs, **kwargs)
    torch.cuda.synchronize()
    after = K.launches()
    assert after[name] == before[name] + 1
    assert after[other] == before[other]
    torch.testing.assert_close(out.float(), plain(*inputs, **kwargs).float(), atol=TOL[dt],
                               rtol=TOL[dt])
    assert _ring_zero(out)
    if name == "conv5x5_s2d_fused":
        torch.testing.assert_close(probes.conv5x5_packed_mma_sync(*inputs, **kwargs), out,
                                   atol=0, rtol=0)
    K.CONV5_PACKED = False
    torch.testing.assert_close(out, K._conv5_impl(*inputs, **kwargs), atol=0, rtol=0)


@pytest.mark.gpu
def test_conv5_packed_gate_and_refusals(cuda, packed):
    """With the flag on, 4C <= 64 launches K11 and 4C = 128 launches K7;
    K11 refuses 4C or 4Co that are not multiples of 8 and never hands them
    to K7."""
    _, _, _, (x, w9, bias), _ = _case("conv5", dict(b=2, n=8, c4=128, co4=64, mode="relu"),
                                      torch.float32, cuda)
    before = K.launches()
    K._conv5_impl(x, w9, bias)
    after = K.launches()
    assert after["conv5x5_s2d_fused"] == before["conv5x5_s2d_fused"] + 1
    assert after["conv5x5_s2d_fused[packed]"] == before["conv5x5_s2d_fused[packed]"]
    x12 = K.pad_s2d(torch.randn(2, 8, 8, 12, device=cuda))
    with pytest.raises(ValueError, match="multiple of 8"):
        K._conv5_impl(x12, torch.zeros(3, 3, 12, 64, device=cuda), torch.zeros(64, device=cuda))
    x16 = K.pad_s2d(torch.randn(2, 8, 8, 16, device=cuda))
    with pytest.raises(ValueError, match="multiple of 8"):
        K._conv5_impl(x16, torch.zeros(3, 3, 16, 12, device=cuda), torch.zeros(12, device=cuda))
    assert K.launches() == after


@pytest.mark.gpu
def test_fused_critic_packed_on_cuda(cuda, packed):
    """FusedCritic's score and input gradient with CONV5_PACKED against the
    default path: 3 of the forward's 4 conv5 launches and 2 of the input
    gradient's 4 transposes take K11, and the results agree."""
    cfg = ModelConfig(image_size=32, first_fm=8)
    tree = flatten_tree(init_critic(cfg, seed=6)["params"])
    params = {k: torch.tensor(v, device=cuda) for k, v in tree.items()}
    x = torch.rand(2, 32, 32, 1, generator=torch.Generator(device=cuda).manual_seed(6),
                   device=cuda)
    before = K.launches()
    score, grad = FusedCritic(cfg, torch.float32).score_and_input_grad(params, x)
    after = K.launches()
    assert after["conv5x5_s2d_fused[packed]"] - before["conv5x5_s2d_fused[packed]"] == 5
    assert after["conv5x5_s2d_fused"] - before["conv5x5_s2d_fused"] == 3
    K.CONV5_PACKED = False
    ref_score, ref_grad = FusedCritic(cfg, torch.float32).score_and_input_grad(params, x)
    torch.testing.assert_close(score, ref_score, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(grad, ref_grad, atol=1e-5, rtol=1e-5)


def _anatomy_inputs(dtype, device, b=2, n=12, c4=64, co4=96, seed=4):
    g = torch.Generator(device=device).manual_seed(seed)
    x = K.pad_s2d(torch.randn(b, n, n, c4, generator=g, device=device)).to(dtype)
    w4 = (torch.randn(2, 2, c4, co4, generator=g, device=device) * (4 * c4) ** -0.5).to(dtype)
    return x, w4, torch.randn(co4, generator=g, device=device) * 0.1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("co4", [40, 96])
def test_kernel_anatomy_phases(cuda, dtype, co4):
    """P1: full (reps 1 and 3) and matmul_only equal K1 bit for bit, no_epi
    is the conv without bias or relu within K1's tolerances, and
    stage_only's sums are the gathered taps' sums per tile (float32 sums of
    up to 256 x 256 values: within 1e-5 of their absolute sum). bfloat16
    runs the wgmma mainloop, at n 8 (TMA boxes of 256 rows), 12 (cp.async)
    and 16; float32 the engine at n 12."""
    dt = getattr(torch, dtype)
    for n, c4 in ((8, 128), (12, 64), (16, 128)) if dt == torch.bfloat16 else ((12, 64),):
        x, w4, bias = _anatomy_inputs(dt, cuda, n=n, c4=c4, co4=co4)
        k1 = K._conv3x3_s2d_impl(x, w4, bias)
        a = probes.gathered_taps(x)
        for phase, reps in (("full", 1), ("full", 3), ("matmul_only", 1), ("matmul_only", 2)):
            before = K.launches()[f"kernel_anatomy[{phase}]"]
            torch.testing.assert_close(probes.kernel_anatomy(phase, x, w4, bias, reps, a), k1,
                                       atol=0, rtol=0)
            assert K.launches()[f"kernel_anatomy[{phase}]"] == before + 1
        no_epi = probes.kernel_anatomy("no_epi", x, w4, bias, 2)
        torch.testing.assert_close(no_epi.float(),
                                   probes.kernel_anatomy_plain("no_epi", x, w4, bias).float(),
                                   atol=TOL[dt], rtol=TOL[dt])
        assert _ring_zero(no_epi)
        sums = probes.kernel_anatomy("stage_only", x, w4, bias, 2)
        ref = probes.kernel_anatomy_plain("stage_only", x, w4, bias)
        rows = probes.stage_tile_rows(co4, dt, n, c4)
        scale = K._taps(x).abs().double().reshape(-1, 4 * x.shape[-1]).sum(-1)
        scale = torch.nn.functional.pad(scale, (0, -scale.shape[0] % rows)).reshape(-1, rows)
        assert sums.shape == ref.shape
        assert bool(((sums.double() - ref.double()).abs() <= 1e-5 * scale.sum(-1)).all())


# (b, n, 4C, 4Co, blocks) of each float32 case -> bfloat16's: the window
# takes 4C in multiples of 64.
_ROWBLK_BF16_SHAPE = {(2, 10, 32, 64, 3): (2, 10, 64, 64, 3),
                      (2, 10, 32, 64, 12): (2, 10, 64, 64, 12),
                      (2, 16, 64, 136, 6): (2, 16, 64, 136, 6),
                      (1, 22, 32, 32, 1): (1, 22, 128, 32, 1)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(_ROWBLK_BF16_SHAPE))
def test_conv3x3_rowblk_equals_k1(cuda, dtype, shape):
    """P2 against K1 on the same inputs, bit for bit, ring included. In
    bfloat16 the old route (window_conv) runs the float32 case's shape and
    the window its shape at 4C a multiple of 64."""
    b, n, c4, co4, blocks = shape
    dt = getattr(torch, dtype)
    if dt == torch.bfloat16:
        x, w4, bias = _anatomy_inputs(dt, cuda, b=b, n=n, c4=c4, co4=co4)
        assert torch.equal(probes.conv3x3_rowblk_window(x, w4, bias, blocks),
                           K._conv3x3_s2d_impl(x, w4, bias))
        b, n, c4, co4, blocks = _ROWBLK_BF16_SHAPE[shape]
    x, w4, bias = _anatomy_inputs(dt, cuda, b=b, n=n, c4=c4, co4=co4)
    before = K.launches()["conv3x3_rowblk"]
    out = probes.conv3x3_rowblk(x, w4, bias, blocks)
    assert K.launches()["conv3x3_rowblk"] == before + 1
    torch.testing.assert_close(out, K._conv3x3_s2d_impl(x, w4, bias), atol=0, rtol=0)
    assert _ring_zero(out)


@pytest.mark.gpu
def test_conv3x3_rowblk_wgmma_every_block_count(cuda):
    """bf16 P2 on the window equals K1 bit for bit at n 8, 12 and 16 with
    every block count that divides n+2 (units of ring rows alone, masked
    tail tiles), at two column blocks (4Co 384), at two B stages (4C 256),
    at a 128-row tile of 64 columns and at both production shapes; so does
    the old route, window_conv, which counts no launch."""
    cases = [(n, c4, co4, nb) for n, c4, co4 in ((8, 64, 64), (12, 128, 96), (16, 64, 256),
                                                  (16, 64, 384), (16, 256, 256), (16, 256, 64))
             for nb in range(1, n + 3) if (n + 2) % nb == 0]
    cases += [(128, 128, 128, 5), (128, 128, 128, 10), (64, 256, 256, 3), (64, 256, 256, 6)]
    for n, c4, co4, nb in cases:
        x, w4, bias = _anatomy_inputs(torch.bfloat16, cuda, b=2, n=n, c4=c4, co4=co4)
        k1 = K._conv3x3_s2d_impl(x, w4, bias)
        before = K.launches()["conv3x3_rowblk"]
        out = probes.conv3x3_rowblk(x, w4, bias, nb)
        old = probes.conv3x3_rowblk_window(x, w4, bias, nb)
        torch.cuda.synchronize()
        assert K.launches()["conv3x3_rowblk"] == before + 1
        diff = float((out.float() - k1.float()).abs().max())
        print(f"P2 n {n} {c4}->{co4} nb {nb}: max abs {diff:.3e} from K1")
        assert diff == 0.0 and torch.equal(old, k1) and _ring_zero(out)


@pytest.mark.gpu
def test_probe_wgmma_refusals_and_window_plan(cuda):
    """bf16 P2 refuses 4C not a multiple of 64 and P1 4Co above 128, never
    falling back; the library's P2 window equals ``ops/wgmma_plan.py``."""
    x, w4, bias = _anatomy_inputs(torch.bfloat16, cuda, n=10, c4=32, co4=64)
    with pytest.raises(ValueError, match="multiple of 64"):
        probes.conv3x3_rowblk(x, w4, bias, 3)
    x, w4, bias = _anatomy_inputs(torch.bfloat16, cuda, n=10, c4=64, co4=256)
    with pytest.raises(ValueError, match="4Co <= 128"):
        probes.kernel_anatomy("full", x, w4, bias)
    for n, c4, co4 in ((8, 64, 64), (12, 128, 96), (16, 256, 384), (64, 256, 256),
                       (128, 128, 128)):
        assert wgmma_plan.library_window(n, c4, co4) == wgmma_plan.window_ints(
            wgmma_plan.window(n, c4, co4))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deint_kernels_equal_plain(cuda, dtype):
    x = torch.randn(3, 5, 14, 16, device=cuda).to(getattr(torch, dtype))
    for kind in ("reshape_idx", "merge"):
        torch.testing.assert_close(probes.deint(x, kind), probes.deint_plain(x), atol=0, rtol=0)
    with pytest.raises(ValueError, match="16 bytes"):
        probes.deint(torch.randn(2, 4, 6, 3, device=cuda), "merge")
    with pytest.raises(ValueError, match="divide"):
        probes.conv3x3_rowblk(*_anatomy_inputs(torch.float32, cuda, n=10, c4=32, co4=32), 5)


# The bf16 wgmma mainloop (K1, K2, K3, K7) at the 4C -> 4Co widths of the
# serving forward and of the superstep's transposes, at small n: 8 (a
# 256-row tile spans four images), 12 (the cp.async route) and 16. K2 also
# at the generator's widths at first_fm 8 (4Co 32, 64: the quad's shuffles).
WGMMA_WIDTHS = {
    "relu 32->128": ((32,), 128, "relu"), "relu 128->128": ((128,), 128, "relu"),
    "film 128": ((128,), 128, "film"), "relu 128->256": ((128,), 256, "relu"),
    "relu 256->256": ((256,), 256, "relu"), "film 256": ((256,), 256, "film"),
    "none 128->128": ((128,), 128, "none"), "none 128->256": ((128,), 256, "none"),
    "none 256->128": ((256,), 128, "none"), "none 256->256": ((256,), 256, "none"),
    "none 256->384": ((256,), 384, "none"),
    "fused2 384+256->256": ((384, 256), 256, "relu"),
    "fused2 256+128->128": ((256, 128), 128, "relu"),
    "pool s2d 128->128": ((128,), 128, "s2d"), "pool pixel 256->256": ((256,), 256, "pixel"),
    "pool s2d 32->32": ((32,), 32, "s2d"), "pool pixel 64->64": ((64,), 64, "pixel"),
    "conv5 relu 16->64": ((16,), 64, "conv5 relu"), "conv5 relu 64->64": ((64,), 64, "conv5 relu"),
    "conv5 relu 64->128": ((64,), 128, "conv5 relu"),
    "conv5 relu 128->128": ((128,), 128, "conv5 relu"),
    "conv5 none 64->16": ((64,), 16, "conv5 none"), "conv5 none 64->64": ((64,), 64, "conv5 none"),
    "conv5 none 128->64": ((128,), 64, "conv5 none"),
    "conv5 none 128->128": ((128,), 128, "conv5 none"),
}
POOLED = ("s2d", "pixel")


def _wgmma_inputs(c4s, co4, mode, n, device, b=3, seed=5):
    g = torch.Generator(device=device).manual_seed(seed)
    taps = 9 if mode.startswith("conv5") else 4
    side = 3 if taps == 9 else 2
    xs = [K.pad_s2d(torch.randn(b, n, n, c4, generator=g, device=device)).bfloat16() for c4 in c4s]
    ws = [(torch.randn(side, side, c4, co4, generator=g, device=device)
           * (taps * sum(c4s)) ** -0.5).bfloat16() for c4 in c4s]
    bias = torch.randn(co4, generator=g, device=device) * 0.1
    film = ()
    if mode == "film":
        film = (torch.randn(b, co4, generator=g, device=device) * 0.3 + 1,
                torch.randn(b, co4, generator=g, device=device) * 0.3)
    return xs, ws, bias, film


def _wgmma_calls(c4s, mode, xs, ws, bias, film):
    """(launch counter name, kernel call, plain call, engine call, plan
    keywords) of one WGMMA_WIDTHS case."""
    if len(c4s) == 2:
        args = (xs[0], xs[1], ws[0], ws[1], bias)
        return ("conv3x3_s2d_fused2", lambda: K._conv2_impl(*args),
                lambda: K.conv3x3_s2d_fused2_plain(*args),
                lambda: probes.conv3x3_engine(xs[0], ws[0], bias, x2_padded=xs[1], w4_2=ws[1]),
                {})
    args = (xs[0], ws[0], bias)
    if mode in POOLED:
        return ("conv3x3_s2d_fused_pool", lambda: K.conv3x3_s2d_fused_pool(*args, pool=mode),
                lambda: K.conv3x3_s2d_fused_pool_plain(*args, pool=mode),
                lambda: probes.conv3x3_engine(*args, pool=mode), {"pool": mode})
    if mode.startswith("conv5"):
        m = mode.split()[1]
        return ("conv5x5_s2d_fused", lambda: K._conv5_impl(*args, mode=m),
                lambda: K.conv5x5_s2d_fused_plain(*args, mode=m),
                lambda: probes.conv5x5_engine(*args, mode=m), {"gather": "conv5x5"})
    name = "conv3x3_s2d_fused[none]" if mode == "none" else "conv3x3_s2d_fused"
    return (name, lambda: K._conv3x3_s2d_impl(*args, *film, mode=mode),
            lambda: K.conv3x3_s2d_fused_plain(*args, *film, mode=mode),
            lambda: probes.conv3x3_engine(*args, *film, mode=mode), {})


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(WGMMA_WIDTHS))
def test_wgmma_matches_plain_and_engine(cuda, case):
    """The wgmma mainloop against the plain version (bf16 tolerances, rings
    exactly zero on outputs whose memory held NaNs) and against the engine's
    kernel on the same inputs, bit for bit (K2 both its outputs): both sum
    each output in 16-deep steps in k order."""
    c4s, co4, mode = WGMMA_WIDTHS[case]
    for n in (8, 12, 16):
        xs, ws, bias, film = _wgmma_inputs(c4s, co4, mode, n, cuda)
        name, kernel, plain, engine, kind = _wgmma_calls(c4s, mode, xs, ws, bias, film)
        ref = plain()
        refs = ref if isinstance(ref, tuple) else (ref,)
        poison = [torch.full(r.shape, float("nan"), dtype=r.dtype, device=cuda) for r in refs]
        del poison  # the kernel's outputs likely reuse this NaN-filled memory
        before = K.launches()[name]
        out = kernel()
        torch.cuda.synchronize()
        assert K.launches()[name] == before + 1
        outs = out if isinstance(out, tuple) else (out,)
        eng = engine()
        engs = eng if isinstance(eng, tuple) else (eng,)
        diff = 0.0
        for j, (o, r, e) in enumerate(zip(outs, refs, engs)):
            torch.testing.assert_close(o.float(), r.float(), atol=1e-2, rtol=1e-2)
            if j == 0 or mode == "s2d":  # a padded plane
                assert _ring_zero(o)
            diff = max(diff, float((o.float() - e.float()).abs().max()))
        route = wgmma_plan.plan(n, c4s, co4, **kind).route
        print(f"{case} n {n} ({route}): max abs {diff:.3e} from the engine")
        assert diff == 0.0


@pytest.mark.gpu
def test_wgmma_library_plan_matches_python(cuda):
    """The library's own load plan equals ``ops/wgmma_plan.py`` at every
    width and at the production sides."""
    for c4s, co4, mode in WGMMA_WIDTHS.values():
        kind = ({"pool": mode} if mode in POOLED else
                {"gather": "conv5x5"} if mode.startswith("conv5") else {})
        for n in (8, 12, 16, 64, 128):
            assert wgmma_plan.library_plan(n, c4s, co4, **kind) == wgmma_plan.as_ints(
                wgmma_plan.plan(n, c4s, co4, **kind))


# bf16 K11 on the wgmma window against K7 at small n: (4C, 4Co, mode); at
# 4Co 256 all of B does not fit and streams through the B ring.
K11_WINDOW_WIDTHS = ((16, 64, "relu"), (16, 16, "none"), (64, 64, "relu"), (64, 128, "relu"),
                     (64, 16, "none"), (64, 128, "none"), (64, 256, "relu"))


@pytest.mark.gpu
@pytest.mark.parametrize("c4,co4,mode", K11_WINDOW_WIDTHS)
def test_conv5_window_equals_k7(cuda, packed, c4, co4, mode):
    """bf16 K11 (the wgmma window) against the plain version (bf16
    tolerances, rings exactly zero on outputs whose memory held NaNs) and
    against K7 on the same inputs, bit for bit, at n 8 (two tiles an image,
    rows past the plane), 12 (a tail tile) and 16; so does the old route
    (window_conv), which counts no launch. The library's window equals
    ``ops/wgmma_plan.py``."""
    for n in (8, 12, 16):
        xs, ws, bias, _ = _wgmma_inputs((c4,), co4, f"conv5 {mode}", n, cuda)
        args = (xs[0], ws[0], bias)
        ref = K.conv5x5_s2d_fused_plain(*args, mode=mode)
        poison = torch.full(ref.shape, float("nan"), dtype=ref.dtype, device=cuda)
        del poison  # the kernel's output likely reuses this NaN-filled memory
        before = K.launches()
        out = K._conv5_impl(*args, mode=mode)
        torch.cuda.synchronize()
        after = K.launches()
        assert after["conv5x5_s2d_fused[packed]"] == before["conv5x5_s2d_fused[packed]"] + 1
        torch.testing.assert_close(out.float(), ref.float(), atol=1e-2, rtol=1e-2)
        assert _ring_zero(out)
        old = probes.conv5x5_packed_mma_sync(*args, mode=mode)
        K.CONV5_PACKED = False
        k7 = K._conv5_impl(*args, mode=mode)
        K.CONV5_PACKED = True
        assert K.launches()["conv5x5_s2d_fused[packed]"] == after["conv5x5_s2d_fused[packed]"]
        diff = float((out.float() - k7.float()).abs().max())
        print(f"K11 window n {n} {c4}->{co4} {mode}: max abs {diff:.3e} from K7")
        assert diff == 0.0 and torch.equal(old, k7)
        assert wgmma_plan.library_conv5_window(n, c4, co4) == (
            wgmma_plan.conv5_window_ints(wgmma_plan.conv5_window(n, c4, co4)))


# bf16 K10 on the wgmma chain at small n, one case a site kind: (n, stage-0
# 4C, 4Cm, pool). m1's 4C 32 takes cp.async; n 14 at 4Cm 128 (T 12) and 10 or
# 12 at 4Cm 256 (T 8) leave tail tiles.
CHAIN_WGMMA_SITES = {"m1": (14, (32,), 128, "s2d"), "m2": (10, (128,), 256, "pixel"),
                     "p2": (12, (128, 64), 256, ""), "p1": (14, (64, 32), 128, ""),
                     "m2_one_tile": (8, (128,), 256, "pixel")}


@pytest.mark.gpu
@pytest.mark.parametrize("site", sorted(CHAIN_WGMMA_SITES))
def test_chain3_wgmma_equals_sequential(cuda, site):
    """bf16 K10 (the wgmma chain) against the plain version (bf16
    tolerances, rings exactly zero on outputs whose memory held NaNs) and
    against the sequential kernels on the same inputs (K1 or K3 -> K1 film
    -> K1 or K2 on the mainloop), bit for bit; so does the old route
    (s2d_chain), which counts no launch. The library's plan equals
    ``ops/wgmma_plan.py``."""
    n, c4s, c4m, pool = CHAIN_WGMMA_SITES[site]
    g = torch.Generator(device=cuda).manual_seed(11)

    def randn(*shape, std=1.0, mean=0.0):
        return torch.randn(shape, generator=g, device=cuda) * std + mean

    def w4(ci, co):
        return randn(2, 2, ci, co, std=(4 * ci) ** -0.5).bfloat16()

    xs = [K.pad_s2d(randn(2, n, n, c4)).bfloat16() for c4 in c4s]
    w0s = [w4(c4, c4m) for c4 in c4s]
    args = (xs[0], w0s[0], randn(c4m, std=0.1), w4(c4m, c4m), randn(c4m, std=0.1),
            randn(2, c4m, std=0.3, mean=1.0), randn(2, c4m, std=0.3), w4(c4m, c4m),
            randn(c4m, std=0.1))
    extra = dict(x2_padded=xs[1] if len(xs) > 1 else None,
                 w1b4=w0s[1] if len(xs) > 1 else None, pool=pool)
    ref = K.conv3x3_s2d_chain3_plain(*args, extra["x2_padded"], extra["w1b4"], pool)
    refs = ref if isinstance(ref, tuple) else (ref,)
    poison = [torch.full(r.shape, float("nan"), dtype=r.dtype, device=cuda) for r in refs]
    del poison
    before = K.launches()["conv3x3_s2d_chain3"]
    with torch.no_grad():
        out = K.conv3x3_s2d_chain3(*args, **extra)
        torch.cuda.synchronize()
        assert K.launches()["conv3x3_s2d_chain3"] == before + 1
        old = probes.conv3x3_chain3_wmma(*args, **extra)
        x, x2 = xs[0], extra["x2_padded"]
        h = (K._conv3x3_s2d_impl(x, *args[1:3]) if x2 is None
             else K._conv2_impl(x, x2, args[1], extra["w1b4"], args[2]))
        h = K._conv3x3_s2d_impl(h, *args[3:7], mode="film")
        seq = (K.conv3x3_s2d_fused_pool(h, *args[7:], pool=pool) if pool
               else K._conv3x3_s2d_impl(h, *args[7:]))
    assert K.launches()["conv3x3_s2d_chain3"] == before + 1
    outs, olds = (out, old) if pool else ((out,), (old,))
    seqs = seq if pool else (seq,)
    diff = 0.0
    for j, (o, r, q, o2) in enumerate(zip(outs, refs, seqs, olds)):
        torch.testing.assert_close(o.float(), r.float(), atol=1e-2, rtol=1e-2)
        if j == 0 or pool == "s2d":
            assert _ring_zero(o)
        diff = max(diff, float((o.float() - q.float()).abs().max()))
        assert torch.equal(o2, q)
    print(f"K10 wgmma {site} n {n} {c4s}->{c4m}: max abs {diff:.3e} from the sequential kernels")
    assert diff == 0.0
    assert wgmma_plan.library_chain_plan(n, c4s, c4m, c4m, pool) == wgmma_plan.chain_ints(
        wgmma_plan.chain_plan(n, c4s, c4m, c4m, pool))


# bf16 K4 on the wgmma deconv against the engine's K4: (batch, m, 4C, 4O):
# the serving and superstep shape (m 64, C 64) and its first_fm 8 widths
# (C 16, 4O 64), the card's ragged C = 8 at m 6 (2m = 12 of a 64-row tile),
# 4O past 256 (two column blocks of 192, then of 256), and the plan's
# fallbacks: one A tile (m 64, 4O 512), and one A tile with one staging
# buffer a consumer at C 96 (two k-tiles of B, three boxes a row).
DECONV_WGMMA = {"m64_256_256": (2, 64, 256, 256), "m64_64_64": (2, 64, 64, 64),
                "m6_32_64": (2, 6, 32, 64), "m8_128_320": (2, 8, 128, 320),
                "m5_32_512": (3, 5, 32, 512), "m64_256_512": (1, 64, 256, 512),
                "m48_384_384": (1, 48, 384, 384)}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(DECONV_WGMMA))
def test_deconv_wgmma_equals_engine(cuda, case):
    """bf16 K4 (the wgmma deconv) against the plain version (bf16
    tolerances, the ring exactly zero on an output whose memory held NaNs)
    and against the engine's K4 on the same inputs, bit for bit: both sum
    each output in 16-deep steps in k order. The library's plan equals
    ``ops/wgmma_plan.py``."""
    b, m, c4, o4 = DECONV_WGMMA[case]
    g = torch.Generator(device=cuda).manual_seed(7)
    x = K.pad_s2d(torch.randn(b, m, m, c4, generator=g, device=cuda)).bfloat16()
    w2 = (torch.randn(c4 // 4, o4, generator=g, device=cuda) * (c4 / 4) ** -0.5).bfloat16()
    bias = torch.randn(o4, generator=g, device=cuda) * 0.1
    ref = K.deconv_s2d_plain(x, w2, bias)
    poison = torch.full(ref.shape, float("nan"), dtype=ref.dtype, device=cuda)
    del poison  # the kernel's output likely reuses this NaN-filled memory
    before = K.launches()["deconv_s2d"]
    out = K._deconv_impl(x, w2, bias)
    torch.cuda.synchronize()
    assert K.launches()["deconv_s2d"] == before + 1
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2, rtol=1e-2)
    assert _ring_zero(out)
    engine = probes.deconv_engine(x, w2, bias)
    assert K.launches()["deconv_s2d"] == before + 1
    diff = float((out.float() - engine.float()).abs().max())
    print(f"K4 wgmma {case}: max abs {diff:.3e} from the engine")
    assert diff == 0.0
    assert wgmma_plan.library_deconv_plan(m, c4, o4) == wgmma_plan.deconv_ints(
        wgmma_plan.deconv_plan(m, c4, o4))


# bf16 K9 on the mainloop's head epilogue against the engine's K9: n 12
# (the cp.async route) and 128 (TMA boxes), 4C 128, 4Co 64, 128 and 256
# (tiles of 256 x 64, 256 x 128 and 128 x 256 rows x columns), h4 4 and 16.
HEAD_WGMMA = [(n, co4, h4) for n in (12, 128) for co4 in (64, 128, 256) for h4 in (4, 16)]


@pytest.mark.gpu
@pytest.mark.parametrize("n,co4,h4", HEAD_WGMMA)
def test_head_wgmma_equals_engine(cuda, n, co4, h4):
    """bf16 K9 (the head epilogue of the wgmma mainloop) against the plain
    version (bf16 atol = rtol = 1e-2) and against the engine's K9 on the same
    inputs, bit for bit: the conv sums in the engine's order, and the head
    chain adds the columns 0 .. 4Co - 1 in order."""
    g = torch.Generator(device=cuda).manual_seed(n + co4 + h4)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=g, device=cuda) * std

    args = (K.pad_s2d(randn(2, n, n, 128)).bfloat16(),
            randn(2, 2, 128, co4, std=512 ** -0.5).bfloat16(), randn(co4, std=0.1),
            randn(1, 1, co4, h4, std=co4 ** -0.5), randn(h4, std=0.1))
    before = K.launches()["conv3x3_s2d_fused_head"]
    out = K.conv3x3_s2d_fused_head(*args)
    torch.cuda.synchronize()
    assert K.launches()["conv3x3_s2d_fused_head"] == before + 1
    ref = K.conv3x3_s2d_fused_head_plain(*args)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    torch.testing.assert_close(out, ref, atol=1e-2, rtol=1e-2)
    engine = probes.conv3x3_head_engine(*args)
    assert K.launches()["conv3x3_s2d_fused_head"] == before + 1
    diff = float((out - engine).abs().max())
    route = wgmma_plan.plan(n, (128,), co4).route
    print(f"K9 wgmma n {n} ({route}) 128->{co4}->{h4}: max abs {diff:.3e} from the engine")
    assert diff == 0.0


@pytest.mark.gpu
def test_deconv_and_head_wgmma_refusals(cuda):
    """What the bf16 K4 kernel does not take goes to the engine, decided
    from the widths (``kernel_route``), counted as K4 and equal to it bit
    for bit; what K9 does not take raises and launches nothing; the
    library's own entry points refuse both."""
    before = K.launches()
    for m, c4, o4 in ((4, 1024, 1024),    # B does not fit beside its tiles
                      (257, 32, 64)):     # m past a box's 256
        x = K.pad_s2d(torch.randn(1, m, m, c4, device=cuda)).bfloat16()
        w2 = (0.1 * torch.randn(c4 // 4, o4, device=cuda)).bfloat16()
        b4 = torch.randn(o4, device=cuda)
        assert K.kernel_route("deconv_s2d", (m, c4, o4), x.dtype) == "engine"
        assert torch.equal(K._deconv_impl(x, w2, b4), probes.deconv_engine(x, w2, b4))
    assert K.launches()["deconv_s2d"] == before["deconv_s2d"] + 2
    before = K.launches()
    x = K.pad_s2d(torch.randn(2, 8, 8, 64, device=cuda)).bfloat16()
    with pytest.raises(ValueError, match="Ho4 <= 16"):
        K.conv3x3_s2d_fused_head(x, torch.zeros(2, 2, 64, 64, device=cuda).bfloat16(),
                                 torch.zeros(64, device=cuda),
                                 torch.zeros(1, 1, 64, 20, device=cuda),
                                 torch.zeros(20, device=cuda))
    assert K.launches() == before
    lib, s = K._cuda.library(), K._cuda.stream(cuda)
    out = torch.empty(2, 8, 8, 32, device=cuda)
    w4 = torch.zeros(2, 2, 64, 264, device=cuda).bfloat16()
    wh, bh = torch.zeros(264, 32, device=cuda).bfloat16(), torch.zeros(32, device=cuda)
    bias = torch.zeros(264, device=cuda)
    for co4, h4 in ((264, 4), (64, 17), (64, 0)):  # past one column block; past 16 head columns
        assert lib.depgan_conv3x3_s2d_fused_head(1, x.data_ptr(), w4.data_ptr(), bias.data_ptr(),
                                                 wh.data_ptr(), bh.data_ptr(), out.data_ptr(), 2,
                                                 8, 64, co4, h4, s) != 0
    assert lib.depgan_deconv_s2d(1, x.data_ptr(), w4.data_ptr(), bias.data_ptr(), out.data_ptr(),
                                 2, 300, 64, 64, s) != 0
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fit_fold_launches(cuda, dtype):
    """``GanTrainer.fit_fold`` at image 64, first_fm 32, batch 2, one epoch
    of 10 batches (supersteps of D 3, 2, 2, 2 and an epoch tail of one
    real row), validation every 2 generator iterations: the kernel
    launches are exactly ``chip_smoke.fit_launches``' (each superstep's by
    its n_valid, and 7 K8 a validation forward), and the logged values are
    finite."""
    import chip_smoke
    from depgan_tpu_torch.config import GanTrainConfig
    from depgan_tpu_torch.train.gan_trainer import GanTrainer
    from depgan_tpu_torch.train.state import Counters

    cfg = ModelConfig(image_size=64, first_fm=32, use_pallas=True, compute_dtype=dtype)
    train_cfg = GanTrainConfig(batch_size=2, n_epochs=1, d_iters=2, warmup_d_iters=3,
                               warmup_until=1, k_noise=2, validate_every=2,
                               metric_flush_every=3)
    trainer = GanTrainer(cfg, train_cfg, device=cuda)
    rng = np.random.default_rng(0)
    x, y = (rng.uniform(size=(21, 64, 64, 1)).astype(np.float32) for _ in range(2))
    logged = []

    class Log:
        def log_scalar(self, tag, value, step):
            logged.append(float(value))

        def log_images(self, *a):
            pass

        def log_graph(self, fn, args, max_nodes=5000):
            return fn(*args)

    K.reset_launch_counts()
    state, counters = trainer.fit_fold(trainer.init_state(0), Counters(), x[:20], y[:20],
                                       x[20:], y[20:], logger=Log())
    launches = K.launches()
    schedule = chip_smoke.fit_schedule(10, train_cfg)
    assert schedule == [(3, 3), (2, 2), (2, 2), (2, 2), (2, 1)]
    assert counters.gen_iterations == len(schedule) and counters.crit_iterations == 10
    assert launches == chip_smoke.fit_launches(schedule, 2, validations=3)
    assert logged and np.isfinite(logged).all()


@pytest.mark.gpu
def test_inference_benches(cuda):
    """``gen_inference_bench`` and ``uresnet_inference_bench`` at a small
    ``n_scan`` and batch: JAX's keys, a positive rate, and 8/2/2/1
    launches a forward."""
    from depgan_tpu_torch import benchmarks

    for bench in (benchmarks.gen_inference_bench, benchmarks.uresnet_inference_bench):
        result = bench(n_scan=2, batch=4)
        assert {"metric", "value", "unit", "vs_baseline"} <= result.keys()
        assert result["value"] > 0 and len(result["reps_ms"]) == 4
        launches = {k: v for k, v in result["launches"].items() if v}
        assert launches == {"conv3x3_s2d_fused": 16, "conv3x3_s2d_fused_pool": 4,
                            "conv3x3_s2d_fused2": 4, "deconv_s2d": 2}


@pytest.mark.gpu
def test_folded_generator_matches_generator(cuda):
    """The plain serving generator on BN-folded weights (``models/folded.py``,
    cuDNN's fused conv-bias-relu) against ``GenUNet2D``'s eval forward at
    the published widths (256, first_fm 32, one 42-slice subject, BatchNorm
    made non-trivial): within 1e-4 with float32 products; with the serving
    cells' TF32 convolutions each side rounds its own kernels, so the
    folded forward's gap to the float32 one may be at most twice the
    unfolded forward's. With ``use_pallas`` the folded forward runs its
    seven FiLM sites through K8, as the unfolded module does."""
    import dataclasses

    import chip_smoke
    from depgan_tpu_torch.models.folded import FoldedGenerator

    cfg = ModelConfig()
    variables = chip_smoke.randomized_variables(cfg, seed=18)
    module = load_flax_variables(GenUNet2D(cfg, device=cuda), variables).eval()
    folded = FoldedGenerator(cfg, variables, device=cuda)
    with_k8 = FoldedGenerator(dataclasses.replace(cfg, use_pallas=True), variables, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(18)
    x = torch.rand(42, 256, 256, 1, generator=g, device=cuda)
    z = torch.randn(42, cfg.noise_size, 1, generator=g, device=cuda)
    with torch.no_grad():
        exact = module(x, z)
        K.reset_launch_counts()
        gap = float((folded(x, z) - exact).abs().max())
        plain_launches = K.launches()["film_residual"]
        gap_k8 = float((with_k8(x, z) - exact).abs().max())
        k8_launches = K.launches()["film_residual"] - plain_launches
        torch.backends.cudnn.allow_tf32 = True
        tf32 = {"folded": float((folded(x, z) - exact).abs().max()),
                "unfolded": float((module(x, z) - exact).abs().max())}
    print(f"folded vs unfolded, float32: max abs {gap:.3e}, with K8 {gap_k8:.3e}; "
          f"TF32 vs float32: {tf32}")
    assert plain_launches == 0 and k8_launches == 7
    assert gap <= 1e-4 and gap_k8 <= 1e-4
    assert tf32["folded"] <= 2 * tf32["unfolded"], tf32
