"""The serving kernels' wrappers refuse what they cannot run: a device with
no kernel (meta tensors), and arguments of the wrong shape, dtype or mode.

Split from ``test_torch_ops.py`` so that each file stays small.
"""

import numpy as np
import pytest
import torch

from depgan_tpu_torch.ops import conv_s2d as K
from test_torch_ops import RNG_SEED, _conv_case, _t


def _meta_calls():
    """One call of every kernel wrapper on meta tensors: bias, gamma and
    beta in float32 like the rest, so only the device is wrong."""
    rng = np.random.default_rng(RNG_SEED)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to("meta")

    x, w4, bias = _conv_case(rng, 2, 8, 32, 32)
    x2, w42, _ = _conv_case(rng, 2, 8, 64, 32)
    gamma = rng.normal(1, 0.3, size=(2, 32))
    beta = rng.normal(0, 0.3, size=(2, 32))
    return {
        "relu": lambda: K.conv3x3_s2d_fused(t(x), t(w4), t(bias)),
        "film": lambda: K.conv3x3_s2d_fused(t(x), t(w4), t(bias), t(gamma), t(beta),
                                            mode="film"),
        "pool_s2d": lambda: K.conv3x3_s2d_fused_pool(t(x), t(w4), t(bias), pool="s2d"),
        "pool_pixel": lambda: K.conv3x3_s2d_fused_pool(t(x), t(w4), t(bias), pool="pixel"),
        "fused2": lambda: K.conv3x3_s2d_fused2(t(x), t(x2), t(w4), t(w42), t(bias)),
        "deconv": lambda: K.deconv_s2d(t(x), t(w4[0, 0, :8]), t(bias)),
    }


@pytest.mark.parametrize("call", ["relu", "film", "pool_s2d", "pool_pixel", "fused2", "deconv"])
def test_meta_tensors_raise(call):
    with pytest.raises(ValueError, match="no kernel for device meta"):
        _meta_calls()[call]()


def test_wrappers_reject_bad_arguments():
    rng = np.random.default_rng(RNG_SEED)
    x, w4, bias = (_t(a) for a in _conv_case(rng, 2, 8, 32, 64))
    with pytest.raises(ValueError, match="w4"):
        K.conv3x3_s2d_fused(x, w4.to(torch.bfloat16), bias)
    with pytest.raises(ValueError, match="bias4"):
        K.conv3x3_s2d_fused(x, w4, bias.double())
    with pytest.raises(ValueError, match="film mode"):
        K.conv3x3_s2d_fused(x, w4, bias, bias[None, :32], bias[None, :32], mode="film")
    with pytest.raises(ValueError, match="padded s2d plane"):
        K.conv3x3_s2d_fused(x[:, 1:], w4, bias)
    with pytest.raises(ValueError, match="unknown pool"):
        K.conv3x3_s2d_fused_pool(x, w4, bias, pool="max")
    with pytest.raises(ValueError, match="different devices"):
        K.deconv_s2d(x, w4[0, 0, :8], bias.to("meta"))
