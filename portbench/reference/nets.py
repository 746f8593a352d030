"""Plain PyTorch reference of the DEP-GAN generator and critic.

Written from the published model (febrianrachmadi/dep-gan-im,
``DEP-GAN_PROB_IM_twoCritics_training_4fold.py:316-495``, Keras): channels
last, SAME convolutions with HWIO kernels, Keras BatchNormalization
(epsilon 1e-3, momentum 0.99), Conv2DTranspose(2, 2, strides 2) with its
(kh, kw, out, in) kernel, and a FiLM site at every U-Net level:
``trunk + relu(conv_bn(trunk) * gamma + beta)``, gamma and beta from the
noise z through two Dense+BN+ReLU layers and one Dense+BN pair per site.

Parameters are flat dicts keyed by the Keras layer path, the names the
benchmark uses for its weights (``block_gen_0.conv2d_gen_0.kernel``).
Nothing here imports the program under test. ``Precision`` sets how the
products are computed: ``float32`` (the reference), ``bfloat16`` (the
trunk stored and multiplied in bfloat16, as a bf16 program would), ``fp8``
(every product's operands rounded to float8 e4m3 with one scale a tensor,
accumulated in float32) or ``tf32`` (float32 with cuDNN's and matmul's
TF32 on): the last three are controls.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

BN_EPS, BN_MOMENTUM = 1e-3, 0.99
SITES = ("m1", "m2", "m3", "p4", "p3", "p2", "p1")
MULT = {"m1": 1, "m2": 2, "m3": 3, "p4": 4, "p3": 3, "p2": 2, "p1": 1}
ENCODER = (("m1", "gen_0", "gen_1"), ("m2", "gen_2", "gen_3"), ("m3", "gen_4", "gen_5"))
MIDDLE = ("p4", "gen_8", "gen_9")
DECODER = (("p3", "gen_10", "gen_11", "de_gen_9", "m3"),
           ("p2", "gen_14", "gen_15", "de_gen_11", "m2"),
           ("p1", "gen_16", "gen_17", "de_gen_15", "m1"))
# Training dropout (reference :399-485): 'a' after a site's first conv, 'b'
# on its FiLM conv's output; DEP-UResNet keeps only p3's 'a', named do_gen_1.
DROPOUT = {"m1": ("do_gen_a3", "do_gen_b3"), "m2": ("do_gen_a2", "do_gen_b2"),
           "m3": ("do_gen_a1", "do_gen_b1"), "p4": ("do_gen_0a", "do_gen_0b"),
           "p3": ("do_gen_1a", "do_gen_1b"), "p2": ("do_gen_2a", "do_gen_2b"),
           "p1": ("do_gen_3a", "do_gen_3b")}
CRITIC = (("dis_0a", 16, 5), ("dis_0b", 16, 5), None, ("dis_1a", 32, 5), ("dis_1b", 32, 5),
          None, ("dis_2", 64, 3), ("dis_3", 64, 3), None, ("dis_4", 128, 3),
          ("dis_5", 128, 3), None, ("dis_6", 256, 3), ("dis_7", 256, 3), ("dis_8", 256, 3))


def site_dense(kind: str, site: str) -> str:
    return f"noise_2_{kind}" if site == "p4" else f"noise_2_{kind}_{site}"


def dropout_layer(mode: str, name: str) -> str | None:
    if mode == "gan":
        return name
    if mode == "uresnet" and name == "do_gen_1a":
        return "do_gen_1"
    return None


# ---------------------------------------------------------------- layout

def generator_spec(cfg: dict) -> list[tuple[str, tuple[int, ...], str]]:
    """(name, shape, kind) of every generator parameter and BatchNorm
    statistic, kind one of conv, dense, deconv, bias, scale, beta, mean,
    var; in the model's layer order."""
    n, nz = cfg["first_fm"], cfg["noise_size"]
    spec = []

    def conv(path, cin, cout, k=3):
        spec.extend([(f"{path}.kernel", (k, k, cin, cout), "conv"),
                     (f"{path}.bias", (cout,), "bias")])

    def bn(path, c):
        spec.extend([(f"{path}.scale", (c,), "scale"), (f"{path}.bias", (c,), "beta")])

    def dense(path, cin, cout):
        spec.extend([(f"{path}.kernel", (cin, cout), "dense"), (f"{path}.bias", (cout,), "bias")])

    for name, cin in (("noise_1_add_f0", 1), ("noise_1_add_f1", n)):
        p = f"noise_encoder.{name}.block_{name}"
        dense(f"{p}.dense_{name}", cin, n)
        bn(f"{p}.dense_bn_{name}", n)
    for site in SITES:
        for kind in ("mul", "add"):
            d = site_dense(kind, site)
            dense(f"noise_encoder.{d}.dense_{d}", nz * n, n * MULT[site])
            bn(f"noise_encoder.{d}.dense_bn_{d}", n * MULT[site])

    def level(cin, site, a, b):
        f = n * MULT[site]
        conv(f"block_{a}.conv2d_{a}", cin, f)
        bn(f"block_{a}.bn_{a}", f)
        conv(f"film_{site}.block_gen_noise_{site}.conv2d_gen_noise_{site}", f, f)
        bn(f"film_{site}.block_gen_noise_{site}.bn_gen_noise_{site}", f)
        conv(f"block_{b}.conv2d_{b}", f, f)
        bn(f"block_{b}.bn_{b}", f)
        return f

    c = cfg["n_input_channels"]
    for site, a, b in ENCODER + (MIDDLE,):
        c = level(c, site, a, b)
    for site, a, b, de, _ in DECODER:
        spec.extend([(f"block_{de}.deconv2d_{de}.kernel", (2, 2, c, c), "deconv"),
                     (f"block_{de}.deconv2d_{de}.bias", (c,), "bias")])
        bn(f"block_{de}.bn_{de}", c)
        c = level(c + n * MULT[site], site, a, b)
    conv("gen_segmentation", n, cfg["n_out"], 1)
    stats = [(name.rsplit(".", 1)[0], shape) for name, shape, kind in spec if kind == "scale"]
    for path, shape in stats:
        spec.extend([(f"{path}.mean", shape, "mean"), (f"{path}.var", shape, "var")])
    return spec


def critic_spec(cfg: dict) -> list[tuple[str, tuple[int, ...], str]]:
    spec, cin = [], 1
    for layer in CRITIC:
        if layer is None:
            continue
        name, f, k = layer
        spec.extend([(f"block_{name}.conv2d_{name}.kernel", (k, k, cin, f), "conv"),
                     (f"block_{name}.conv2d_{name}.bias", (f,), "bias")])
        cin = f
    side = cfg["image_size"] // 16
    spec.extend([("dis_9.kernel", (1, 1, cin, 1), "dense"), ("dis_9.bias", (1,), "bias"),
                 ("dis_dense.kernel", (side * side, 1), "dense"), ("dis_dense.bias", (1,), "bias")])
    return spec


# ------------------------------------------------------------- precision

class Precision:
    """How products are computed: 'float32', 'bfloat16', 'fp8' or 'tf32'
    (float32 operands, TF32 products); or 'float64', a look at what
    float32's rounding does (``calibrate --look``), which wants the
    parameters in float64 too (``wide``)."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "bfloat16", "fp8", "tf32", "float64"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.store = {"bfloat16": torch.bfloat16, "float64": torch.float64}.get(name,
                                                                                torch.float32)

    def wide(self, leaves: dict) -> dict:
        """Leaves as this precision trains them: float64 for 'float64',
        else as they are."""
        if self.name != "float64":
            return leaves
        return {k: v.detach().double().requires_grad_(v.requires_grad) for k, v in leaves.items()}

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        """A product's operand as this precision feeds it."""
        if self.name == "fp8":
            scale = t.detach().abs().amax().clamp_min(1e-30) / 448.0
            q = (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
            return t + (q - t).detach()  # rounded forward, straight-through gradient
        return t.to(self.store)

    @contextlib.contextmanager
    def products(self):
        """cuDNN's and matmul's TF32 on for 'tf32' and off for the rest,
        put back as they were on leaving."""
        cudnn, matmul = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = \
            self.name == "tf32"
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = cudnn, matmul


def _wide(x: torch.Tensor) -> torch.Tensor:
    """float32, or float64 where x is."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def conv(x, w, b, prec: Precision):
    """SAME conv of NHWC x with HWIO w."""
    y = F.conv2d(prec.operand(x).permute(0, 3, 1, 2), prec.operand(w).permute(3, 2, 0, 1),
                 None, padding=w.shape[0] // 2).permute(0, 2, 3, 1)
    return y + b.to(y.dtype)


def dense(x, w, b, prec: Precision):
    y = prec.operand(x) @ prec.operand(w)
    return y + b.to(y.dtype)


def deconv2x2(x, w, b, prec: Precision):
    """Conv2DTranspose(2, 2, strides 2): out[2i+p, 2j+q, o] = sum_c
    x[i, j, c] w[p, q, o, c] + b[o]."""
    bsz, h, wd, c = x.shape
    o = w.shape[2]
    y = torch.einsum("bijc,pqoc->bipjqo", prec.operand(x), prec.operand(w))
    return y.reshape(bsz, 2 * h, 2 * wd, o) + b.to(y.dtype)


def max_pool(x):
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


class BatchNorms:
    """Keras BatchNormalization: moving statistics in inference; in
    training, the batch's mean and biased variance over every axis but the
    last, and the new moving statistics collected in ``updated``."""

    def __init__(self, params: dict, stats: dict, train: bool):
        self.params, self.stats, self.train = params, stats, train
        self.updated: dict[str, torch.Tensor] = {}

    def __call__(self, path: str, x: torch.Tensor) -> torch.Tensor:
        scale, beta = self.params[f"{path}.scale"], self.params[f"{path}.bias"]
        if not self.train:
            mean, var = self.stats[f"{path}.mean"], self.stats[f"{path}.var"]
            return (x - mean.to(x.dtype)) * (torch.rsqrt(var + BN_EPS) * scale).to(x.dtype) \
                + beta.to(x.dtype)
        xf = _wide(x)
        axes = tuple(range(x.ndim - 1))
        mean = xf.mean(axes)
        var = torch.clamp_min(xf.square().mean(axes) - mean.square(), 0.0)
        for key, new in (("mean", mean), ("var", var)):
            old = self.stats[f"{path}.{key}"]
            self.updated[f"{path}.{key}"] = BN_MOMENTUM * old + (1 - BN_MOMENTUM) * new.detach()
        return ((xf - mean) * (torch.rsqrt(var + BN_EPS) * scale) + beta).to(x.dtype)


# ----------------------------------------------------------------- models

def generator(params, stats, cfg, x, z, prec: Precision, train: bool = False, masks=None,
              head_hook=None):
    """x (B, H, W, C_in), z (B, noise_size, 1) -> (B, H, W, n_out) float32
    (float64 under 'float64') and the updated BatchNorm statistics (empty in inference). ``masks``
    maps a dropout layer's name to its keep mask (training only);
    ``head_hook`` (optional) is called with the head's logits."""
    P = params
    bn = BatchNorms(params, stats, train)
    rate = cfg["dropout_rate"]

    def drop(name, h):
        layer = dropout_layer(cfg["dropout_mode"], name) if train else None
        if layer is None:
            return h
        return torch.where(masks[layer], h / (1.0 - rate), h.new_zeros(()))

    def conv_bn(h, path, suffix):
        return bn(f"{path}.bn_{suffix}", conv(h, P[f"{path}.conv2d_{suffix}.kernel"],
                                             P[f"{path}.conv2d_{suffix}.bias"], prec))

    # Noise pathway.
    h = z.to(prec.store)
    for name in ("noise_1_add_f0", "noise_1_add_f1"):
        p = f"noise_encoder.{name}.block_{name}"
        d = dense(h, P[f"{p}.dense_{name}.kernel"], P[f"{p}.dense_{name}.bias"], prec)
        h = torch.relu(bn(f"{p}.dense_bn_{name}", d))
    h = h.reshape(h.shape[0], -1)
    mods = {}
    for site in SITES:
        pair = []
        for kind in ("mul", "add"):
            d = site_dense(kind, site)
            pair.append(bn(f"noise_encoder.{d}.dense_bn_{d}",
                           dense(h, P[f"noise_encoder.{d}.dense_{d}.kernel"],
                                 P[f"noise_encoder.{d}.dense_{d}.bias"], prec)))
        mods[site] = pair

    def level(h, site, a, b):
        t = torch.relu(conv_bn(h, f"block_{a}", a))
        name_a, name_b = DROPOUT[site]
        t = drop(name_a, t)
        f = drop(name_b, conv_bn(t, f"film_{site}.block_gen_noise_{site}", f"gen_noise_{site}"))
        gamma, beta = mods[site]
        t = t + torch.relu(f * gamma[:, None, None, :] + beta[:, None, None, :])
        return torch.relu(conv_bn(t, f"block_{b}", b))

    h = x.to(prec.store)
    skips = {}
    for site, a, b in ENCODER:
        skips[site] = level(h, site, a, b)
        h = max_pool(skips[site])
    h = level(h, *MIDDLE)
    for site, a, b, de, skip in DECODER:
        up = torch.relu(bn(f"block_{de}.bn_{de}",
                           deconv2x2(h, P[f"block_{de}.deconv2d_{de}.kernel"],
                                     P[f"block_{de}.deconv2d_{de}.bias"], prec)))
        h = level(torch.cat([up, skips[skip]], dim=-1), site, a, b)
    logits = _wide(conv(h, P["gen_segmentation.kernel"], P["gen_segmentation.bias"], prec))
    if head_hook is not None:
        head_hook(logits)
    out = torch.tanh(logits) if cfg["n_out"] == 1 else torch.softmax(logits, dim=-1)
    return out, bn.updated


def critic(params, cfg, x, prec: Precision):
    """(B, H, W, 1) -> (B, 1) float32 (float64 under 'float64') Wasserstein
    score."""
    h = x.to(prec.store)
    for layer in CRITIC:
        if layer is None:
            h = max_pool(h)
        else:
            name = layer[0]
            h = torch.relu(conv(h, params[f"block_{name}.conv2d_{name}.kernel"],
                                params[f"block_{name}.conv2d_{name}.bias"], prec))
    h = conv(h, params["dis_9.kernel"], params["dis_9.bias"], prec)
    return _wide(dense(h.reshape(h.shape[0], -1), params["dis_dense.kernel"],
                       params["dis_dense.bias"], prec))


class Adam:
    """Adam as Kingma and Ba state it, eps added after the bias-corrected
    square root: ``p -= lr / (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) + eps)``."""

    def __init__(self, params: dict, lr: float, b1: float, b2: float, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps, self.t = lr, b1, b2, eps, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, (1 - self.b2 ** self.t) ** 0.5
        for k, g in grads.items():
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            params[k].sub_(self.lr / c1 * self.m[k] / (self.v[k].sqrt() / c2 + self.eps))
