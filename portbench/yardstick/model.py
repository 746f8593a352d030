"""The model's own shapes, operations and bytes: the yardstick of MFU and
of the kernels' roofline shares.

Everything here is worked out from a configuration file's sizes
(``portbench/configs/<name>.json``), never from the program: a layer is
counted once, whatever implements it, so a later change to the program
cannot move the yardstick.

The generator is the DEP-GAN FiLM-noise U-Net (febrianrachmadi/dep-gan-im,
``DEP-GAN_PROB_IM_twoCritics_training_4fold.py:350-495``): levels of n, 2n,
3n feature maps at H, H/2, H/4, a bottleneck of 4n at H/8, a decoder back
up, a FiLM site at every level, a 1x1 head. The critic is ``Dis_C2D_FCN1``
(:316-345). A FLOP is one multiply or one add: a convolution's FLOPs are
2 x its multiply-accumulates.
"""

from __future__ import annotations

# Sites of the generator in forward order: (site, channel multiple, side divisor).
SITES = (("m1", 1, 1), ("m2", 2, 2), ("m3", 3, 4), ("p4", 4, 8), ("p3", 3, 4),
         ("p2", 2, 2), ("p1", 1, 1))
# The critic: (name, features, kernel) or None for a 2x2 max-pool.
CRITIC = (("dis_0a", 16, 5), ("dis_0b", 16, 5), None, ("dis_1a", 32, 5), ("dis_1b", 32, 5),
          None, ("dis_2", 64, 3), ("dis_3", 64, 3), None, ("dis_4", 128, 3),
          ("dis_5", 128, 3), None, ("dis_6", 256, 3), ("dis_7", 256, 3), ("dis_8", 256, 3))

PEAK_BYTES = 3.35e12  # H100 SXM HBM3
# Dense, no sparsity. float32 is float32 storage with TF32 products, as every
# float32 mix states ("products": "tf32", set by drivers/common.set_products):
# their cuDNN convolutions run on the TF32 tensor cores, and their control is
# bfloat16, the next precision below. So the TF32 rate, 495 TFLOP/s, not the
# 67 TFLOP/s of float32 outside the tensor cores, is the fastest any of their
# FLOPs may run, and no share against it can pass 100%.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}


def conv_flops(side: int, cin: int, cout: int, k: int) -> float:
    return 2.0 * side * side * cin * cout * k * k


def generator_flops(cfg: dict) -> float:
    """FLOPs of one generator forward of one slice: every conv, deconv,
    dense and the head (BatchNorm, FiLM and activations are left out)."""
    n, h, nz = cfg["first_fm"], cfg["image_size"], cfg["noise_size"]
    total = 2.0 * nz * (1 * n + n * n)  # the two noise denses, per noise position
    for _, mult, _ in SITES:  # each site's gamma and beta denses over the flat noise
        total += 2 * 2.0 * nz * n * n * mult
    cin = cfg["n_input_channels"]
    for site, mult, div in SITES:
        side, f = h // div, n * mult
        if site.startswith("p") and site != "p4":  # decoder: the deconv, then the skip concat
            below = n * (mult + 1)
            total += 2.0 * (side // 2) ** 2 * below * 4 * below
            cin = below + f
        total += conv_flops(side, cin, f, 3) + 2 * conv_flops(side, f, f, 3)
        cin = f
    total += 2.0 * h * h * n * cfg["n_out"]
    return total


def critic_flops(cfg: dict) -> float:
    """FLOPs of one critic forward of one image."""
    side, cin, total = cfg["image_size"], 1, 0.0
    for layer in CRITIC:
        if layer is None:
            side //= 2
            continue
        _, f, k = layer
        total += conv_flops(side, cin, f, k)
        cin = f
    total += 2.0 * side * side * cin  # dis_9, 1x1 to one channel
    total += 2.0 * side * side  # dis_dense
    return total


def _unit(flops: float, elems_in: float, elems_out: float, weights: float, elem_bytes: int):
    return flops, (elems_in + elems_out + weights) * elem_bytes


def generator_kernel_units(cfg: dict, elem_bytes: int) -> list[tuple[str, float, float]]:
    """The generator's layers that the port's kernels carry at levels 1 and
    2, per slice, as (name, FLOPs, bytes): each conv with its bias and relu,
    each FiLM site's conv with its modulation and residual, each encoder
    conv_out with its 2x2 max-pool (both outputs written), each decoder
    entry conv over (up, skip), and the p2 -> p1 deconv. Bytes: each input
    read once, each output written once, the weights once."""
    n, h = cfg["first_fm"], cfg["image_size"]
    units = []
    for site, mult, div in SITES:
        if div > 2:
            continue
        side, f = h // div, n * mult
        px = side * side
        if site.startswith("m"):
            cin = cfg["n_input_channels"] if site == "m1" else n * (mult - 1)
            units.append((f"{site}.conv_in", *_unit(conv_flops(side, cin, f, 3), px * cin,
                                                   px * f, 9 * cin * f, elem_bytes)))
            units.append((f"{site}.film", *_unit(conv_flops(side, f, f, 3), px * f, px * f,
                                                9 * f * f + 2 * f, elem_bytes)))
            units.append((f"{site}.conv_out_pool", *_unit(conv_flops(side, f, f, 3), px * f,
                                                         px * f + px * f // 4, 9 * f * f,
                                                         elem_bytes)))
        else:
            below = n * (mult + 1)
            if site == "p1":
                up_c = n * (mult + 1)
                units.append(("p1.deconv", *_unit(2.0 * (px // 4) * up_c * 4 * up_c,
                                                 px // 4 * up_c, px * up_c, 4 * up_c * up_c,
                                                 elem_bytes)))
            cin = below + f
            units.append((f"{site}.conv_in2", *_unit(conv_flops(side, cin, f, 3), px * cin,
                                                    px * f, 9 * cin * f, elem_bytes)))
            units.append((f"{site}.film", *_unit(conv_flops(side, f, f, 3), px * f, px * f,
                                                9 * f * f + 2 * f, elem_bytes)))
            units.append((f"{site}.conv_out", *_unit(conv_flops(side, f, f, 3), px * f,
                                                    px * f, 9 * f * f, elem_bytes)))
    return units


def critic_kernel_units(cfg: dict, elem_bytes: int) -> list[tuple[str, float, float]]:
    """The critic's 5x5 levels, which the port's kernels carry: four convs,
    the second of each level with its 2x2 max-pool, per image."""
    side, cin, units = cfg["image_size"], 1, []
    for i, layer in enumerate(CRITIC[:6]):
        if layer is None:
            side //= 2
            continue
        name, f, k = layer
        px = side * side
        pooled = CRITIC[i + 1] is None
        out = px * f + (px * f // 4 if pooled else 0)
        units.append((name + ("_pool" if pooled else ""),
                      *_unit(conv_flops(side, cin, f, k), px * cin, out, k * k * cin * f,
                             elem_bytes)))
        cin = f
    return units


def film_site_units(cfg: dict, elem_bytes: int) -> list[tuple[str, float, float]]:
    """Each FiLM site's modulation and residual, ``trunk + relu(h * gamma +
    beta)``, per slice: h and the trunk read, the output written, 4 FLOPs
    an element."""
    n, h = cfg["first_fm"], cfg["image_size"]
    units = []
    for site, mult, div in SITES:
        elems = (h // div) ** 2 * n * mult
        units.append((f"{site}.film", 4.0 * elems, (3 * elems + 2 * n * mult) * elem_bytes))
    return units


def least_seconds(units, count: float, dtype: str) -> float:
    """Least time of ``count`` passes over ``units``: each unit the larger
    of its FLOPs over the dtype's peak and its bytes over HBM's."""
    peak = PEAK_FLOPS[dtype]
    return count * sum(max(flops / peak, nbytes / PEAK_BYTES) for _, flops, nbytes in units)


def gan_superstep_flops(cfg: dict, train: dict, n_valid: int) -> float:
    """Model FLOPs of one two-critic superstep with ``n_valid`` critic rows
    a critic. A pass with a parameter gradient counts 3 forwards (forward,
    input gradient, weight gradient); the gradient penalty counts its
    mixed forward and input gradient (2 forwards) and their gradient again
    (4 more); a forward whose input gradient only is needed counts 2."""
    b, k = train["batch_size"], train["k_noise"]
    fg, fc = generator_flops(cfg), critic_flops(cfg)
    critic_step = b * (fg + 2 * 3 * fc + 6 * fc)
    probe = k * b * (fg + 2 * fc)
    gen_step = b * (3 * fg + 2 * 2 * fc)
    return 2 * n_valid * critic_step + probe + gen_step


def uresnet_step_flops(cfg: dict, train: dict) -> float:
    """Model FLOPs of one supervised step: 3 forwards a slice."""
    return 3.0 * train["batch_size"] * generator_flops(cfg)


def gan_superstep_kernel_seconds(cfg: dict, train: dict, n_valid: int, dtype: str) -> float:
    """Least time of the layers the port's kernels carry in one superstep:
    the generator's level-1/2 layers over its forwards (one a critic row,
    k probes, the generator step) and its input gradient in the generator
    step; the critic's 5x5 levels over its forwards (real, fake and mixed a
    critic row, two critics in each probe and in the generator step) and
    its input gradients (the penalty's, and the generator step's through
    both critics). Weight gradients and the parameter gradients' backward
    are not counted, so this is a lower bound of the kernels' work."""
    b, k = train["batch_size"], train["k_noise"]
    nbytes = 4 if dtype == "float32" else 2
    gen_passes = (2 * n_valid + k + 2) * b
    critic_passes = (8 * n_valid + 2 * k + 4) * b
    return (least_seconds(generator_kernel_units(cfg, nbytes), gen_passes, dtype)
            + least_seconds(critic_kernel_units(cfg, nbytes), critic_passes, dtype))
