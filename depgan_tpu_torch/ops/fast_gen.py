"""FusedGenerator and FastGenerator — the fused forward of Gen_UNet2D.

Counterpart of ``depgan_tpu/ops/fast_gen.py`` in the configuration every
caller of the JAX package uses: ``pallas_levels=(1, 2)``. Semantically
``GenUNet2D.forward`` with frozen BatchNorm and no dropout, restructured:

- BatchNorm folded into the conv, dense and deconv weights (``fold_bn``);
- levels 1 and 2 (full and half resolution) run in padded s2d through the
  hand-written kernels of ``conv_s2d``: every conv with its bias/relu or
  FiLM epilogue, the 2x2 max-pool after each encoder level (fused into the
  last conv's kernel when serving, a pool kernel of its own when training),
  the decoder's first conv over (up, skip) without the concat, and the
  p2 -> p1 upsample;
- level 3, the bottleneck and the p3 decoder stay in the pixel domain
  (``F.conv2d``), as does the noise encoder, whose 14 site denses run as
  one matmul;
- the trunk computes in ``compute_dtype`` (bfloat16 on the card), the noise
  pathway, the FiLM vectors and the 1x1 head in float32.

``FusedGenerator`` is the training form: ``build_weights`` is torch ops on
the live parameter tensors, and every kernel of the forward is an autograd
op, so the generator's own gradient flows through the fold, the transforms
and the kernels' backward rules. ``FastGenerator`` is the serving form: the
weights built once, the fused pools, no gradient.

The width gate (the role of JAX's ``generator_pallas_supported``,
``fast_gen.py:82-118``): at construction ``site_routes`` decides, from the
widths alone, which kernel each site of the level-1/2 path runs
(``conv_s2d.kernel_route``). A site that no kernel takes (4C not a multiple
of 32, e.g. ``first_fm`` 20 or 28) runs its plain torch version, and a
generator built for a CUDA device warns, naming the site, its widths and
the rule. Where a fused kernel refuses but its parts are taken, the site
runs the parts: a pooled conv_out with 4Co above 256 as the conv and the
pool kernel, a chain the wgmma chain refuses as its sequential kernels, a
head the head kernel refuses as conv_out and the plain head.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..models.blocks import conv2d_same, max_pool_2x2
from ..models.film import site_suffix
from . import s2d_conv as S
from .conv_s2d import (
    conv3x3_s2d_chain3,
    conv3x3_s2d_fused,
    conv3x3_s2d_fused2,
    conv3x3_s2d_fused2_plain,
    conv3x3_s2d_fused_head,
    conv3x3_s2d_fused_head_plain,
    conv3x3_s2d_fused_plain,
    conv3x3_s2d_fused_pool,
    deconv_s2d,
    deconv_s2d_plain,
    entry_pack,
    kernel_route,
    pad_s2d,
    pool_s2d,
    pool_s2d_plain,
    pool_to_s2d,
    pool_to_s2d_plain,
    unpad_s2d,
)
from .fold_bn import fold_batch_norms

SITES_IN_ORDER = ("m1", "m2", "m3", "p4", "p3", "p2", "p1")
KERNEL_LEVELS = (1, 2)  # levels that run in padded s2d through the kernels
ENTRY_PAD_CIN = 8  # the entry conv's input channels are padded to this
# Sites with a route of their own only as an alternative: where no kernel
# takes one, its parts run (the conv and the pool, the sequential kernels,
# conv_out and the plain head).
ALTERNATIVES = (".conv_out_pool", ".chain", ".head")


def site_problems(cfg: ModelConfig) -> dict[str, tuple[str, tuple]]:
    """Every kernel site of the level-1/2 path, 'site.op' -> (the wrapper's
    launch name, its problem without the batch, as ``conv_s2d.SHAPES``
    counts it), the serving alternatives included. f = ``first_fm``; level 1
    runs at side image / 2, level 2 at image / 4: m1 4C_in -> 4f -> 4f, m2
    4f -> 8f -> 8f, p2 (12f + 8f) -> 8f, the p2 -> p1 deconv 8f -> 8f, p1
    (8f + 4f) -> 4f."""
    f, n1, n2 = 4 * cfg.first_fm, cfg.image_size // 2, cfg.image_size // 4
    c_in = cfg.n_input_channels
    c_entry = 4 * (ENTRY_PAD_CIN if c_in <= ENTRY_PAD_CIN else c_in)
    out = {}
    for site, n, c4s, co4, pool in (("m1", n1, (c_entry,), f, "s2d"),
                                    ("m2", n2, (f,), 2 * f, "pixel"),
                                    ("p2", n2, (3 * f, 2 * f), 2 * f, ""),
                                    ("p1", n1, (2 * f, f), f, "")):
        if len(c4s) == 2:
            out[f"{site}.conv_in"] = ("conv3x3_s2d_fused2", (n, *c4s, co4))
        else:
            out[f"{site}.conv_in"] = ("conv3x3_s2d_fused", (n, c4s[0], co4, "relu"))
        out[f"{site}.film"] = ("conv3x3_s2d_fused", (n, co4, co4, "film"))
        out[f"{site}.conv_out"] = ("conv3x3_s2d_fused", (n, co4, co4, "relu"))
        if pool:
            out[f"{site}.pool"] = ("pool_to_s2d" if pool == "s2d" else "pool_s2d", (n, co4))
            out[f"{site}.conv_out_pool"] = ("conv3x3_s2d_fused_pool", (n, co4, co4, pool))
        c4a, c4b = (*c4s, 0)[:2]
        out[f"{site}.chain"] = ("conv3x3_s2d_chain3", (n, c4a, c4b, co4, co4, pool))
    out["p1.deconv"] = ("deconv_s2d", (n2, 2 * f, 2 * f))
    out["p1.head"] = ("conv3x3_s2d_fused_head", (n1, f, f, 4 * cfg.n_out))
    return out


def site_routes(cfg: ModelConfig, dtype, backward: bool = False) -> dict[str, str | None]:
    """'site.op' -> the kernel route of each site of ``site_problems``
    (``conv_s2d.kernel_route``), None where no kernel takes its widths. With
    ``backward``, a conv site also needs a kernel for each transposed conv
    of its backward (4Co -> 4C, K1's 'none')."""
    routes = {}
    for key, (name, problem) in site_problems(cfg).items():
        route = kernel_route(name, problem, dtype)
        if route and backward and name in ("conv3x3_s2d_fused", "conv3x3_s2d_fused2"):
            n, *c4s, co4 = problem[:-1] if name == "conv3x3_s2d_fused" else problem
            if not all(kernel_route("conv3x3_s2d_fused[none]", (n, co4, c4, "none"), dtype)
                       for c4 in c4s):
                route = None
        routes[key] = route
    return routes


def gate_message(cfg: ModelConfig, routes: dict[str, str | None]) -> str | None:
    """The gate's warning for ``routes``: each site that no kernel takes and
    that has no kernel alternative, with its widths and the rule; None when
    every site has a kernel."""
    problems = site_problems(cfg)
    plain = [f"{key} ({problems[key][0]} {problems[key][1]})" for key, route in routes.items()
             if route is None and not key.endswith(ALTERNATIVES)]
    if not plain:
        return None
    return (f"no kernel takes these sites' widths at first_fm={cfg.first_fm}, image_size="
            f"{cfg.image_size}: {', '.join(plain)}. The kernels take 4C a multiple of 32 and 4Co "
            f"of 8 (n, 4C, 4Co in each problem); these sites run their plain torch versions.")


def taken_launches(cfg: ModelConfig, taken: dict[str, str]) -> dict[str, int]:
    """Kernel launches by name of one forward whose sites ran the routes
    ``taken`` (``FusedGenerator.taken``): one a site on a kernel, none a site
    on its plain version."""
    problems = site_problems(cfg)
    counts: dict[str, int] = {}
    for key, route in taken.items():
        if route != "plain":
            name = problems[key][0]
            counts[name] = counts.get(name, 0) + 1
    return counts


def deconv_w2(kernel):
    """Keras deconv kernel (2, 2, O, C) -> matmul form (C, 4O), columns in
    sub-pixel order (p, q, o)."""
    return kernel.permute(3, 0, 1, 2).reshape(kernel.shape[3], -1)


def to_tensors(tree, device):
    """Float32 tensors of a tree of arrays or tensors; tensors keep their
    autograd history."""
    if isinstance(tree, dict):
        return {k: to_tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(tree), dtype=torch.float32, device=device)


def noise_encoder_weights(enc: dict) -> tuple[dict[str, torch.Tensor], dict[str, tuple]]:
    """The BN-folded noise encoder ``enc`` in the form ``site_mods`` runs:
    its two shared denses, and the 14 per-site denses, which share their
    input, as one matmul with columns [mul, add] per site in
    SITES_IN_ORDER; and each site's (mul, add) column slices."""
    W: dict[str, torch.Tensor] = {}
    for name in ("noise_1_add_f0", "noise_1_add_f1"):
        d = enc[name][f"block_{name}"][f"dense_{name}"]
        W[f"{name}/kernel"], W[f"{name}/bias"] = d["kernel"], d["bias"]
    ks, bs, slices, off = [], [], {}, 0
    for site in SITES_IN_ORDER:
        pair = []
        for kind in ("mul", "add"):
            d = enc[site_suffix(kind, site)][f"dense_{site_suffix(kind, site)}"]
            ks.append(d["kernel"])
            bs.append(d["bias"])
            pair.append(slice(off, off + d["kernel"].shape[-1]))
            off = pair[-1].stop
        slices[site] = tuple(pair)
    W["site_mods/kernel"] = torch.cat(ks, dim=-1)
    W["site_mods/bias"] = torch.cat(bs, dim=-1)
    return W, slices


def site_mods(W: dict[str, torch.Tensor], z: torch.Tensor, slices: dict[str, tuple]):
    """The noise pathway on ``noise_encoder_weights``: {site: (gamma, beta)},
    each (B, C), in the dtype of z and W."""
    h = z
    for name in ("noise_1_add_f0", "noise_1_add_f1"):
        h = torch.relu(h @ W[f"{name}/kernel"] + W[f"{name}/bias"])
    all_mods = h.reshape(h.shape[0], -1) @ W["site_mods/kernel"] + W["site_mods/bias"]
    return {site: (all_mods[:, mul], all_mods[:, add]) for site, (mul, add) in slices.items()}


class FusedGenerator:
    """The fused-forward spec: level layout plus ``build_weights``/``forward``.

    ``build_weights`` turns a Flax-layout variable tree (numpy arrays or
    tensors, differentiably for tensors) into the flat dict ``forward``
    consumes, and records the column slices of each site's gamma/beta in the
    fused site-mods matmul. Trunk weights come out in ``compute_dtype``,
    rounded once from float32; the noise encoder, the kernels' biases and
    the head stay float32. ``fuse_pool`` (off here, on for serving) pools
    each encoder level inside its last conv's kernel, which has no gradient.
    Two more serving options select kernels without a gradient, off by
    default as in JAX: ``fuse_chain`` runs each level-1/2 site (conv_in or
    the two-operand conv, FiLM, conv_out [+ pool]) as one
    ``conv3x3_s2d_chain3`` launch, and ``fuse_head`` runs p1's conv_out with
    the 1x1 tanh head in its epilogue (``conv3x3_s2d_fused_head``; the tanh
    head only, p1 then stays sequential).
    """

    entry_pad_cin = ENTRY_PAD_CIN
    backward = True  # the training form: routes need kernels for the backward too
    enc_spec = (("m1", "gen_0", "gen_1", 1), ("m2", "gen_2", "gen_3", 2),
                ("m3", "gen_4", "gen_5", 3))
    mid_spec = ("p4", "gen_8", "gen_9", 4)
    dec_spec = (("p3", "gen_10", "gen_11", 3, "de_gen_9"),
                ("p2", "gen_14", "gen_15", 2, "de_gen_11"),
                ("p1", "gen_16", "gen_17", 1, "de_gen_15"))

    def __init__(self, cfg: ModelConfig, compute_dtype=torch.bfloat16, device=None):
        self.cfg = cfg
        self.dtype = compute_dtype
        self.fuse_pool = False
        self.fuse_head = False
        self.fuse_chain = False
        self._site_slices: dict[str, tuple[slice, slice]] = {}
        # The width gate, decided here from the widths alone (module doc).
        self.routes = site_routes(cfg, compute_dtype, self.backward)
        self.taken: dict[str, str] = {}  # 'site.op' -> the route the last forward ran
        message = gate_message(cfg, self.routes)
        if message and device is not None and torch.device(device).type == "cuda":
            warnings.warn(message, stacklevel=2)

    # ------------------------------------------------------------- weights

    def build_weights(self, variables: dict, device=None) -> dict[str, torch.Tensor]:
        """Fold BN, apply the s2d kernel transforms, cast the trunk."""
        dt = self.dtype
        p = fold_batch_norms(to_tensors(variables, device))["params"]
        W, self._site_slices = noise_encoder_weights(p["noise_encoder"])

        def put_conv(tag, block, lname, level, pad_cin=None, split_cup=None):
            if block.startswith("film_"):  # FilmSite nests its ConvBN one deeper
                leaf = p[block][lname.replace("conv2d_", "block_")][lname]
            else:
                leaf = p[block][lname]
            k, b = leaf["kernel"], leaf["bias"]
            if level not in KERNEL_LEVELS:
                W[f"{tag}/kernel"], W[f"{tag}/bias"] = k.to(dt), b.to(dt)
                return
            if split_cup is not None:
                # Decoder entry: conv(concat(up, skip), W) as two operands.
                k4u, W[f"{tag}/bias"] = S.conv3x3_to_s2d_kernel(k[:, :, :split_cup, :], b)
                k4s, _ = S.conv3x3_to_s2d_kernel(k[:, :, split_cup:, :])
                W[f"{tag}/kernel_up"], W[f"{tag}/kernel_skip"] = k4u.to(dt), k4s.to(dt)
                return
            if pad_cin is not None and k.shape[2] < pad_cin:
                k = F.pad(k, (0, 0, 0, pad_cin - k.shape[2]))
            k4, W[f"{tag}/bias"] = S.conv3x3_to_s2d_kernel(k, b)
            W[f"{tag}/kernel"] = k4.to(dt)

        for site, cin, cout, level in self.enc_spec + (self.mid_spec,):
            pad_cin = self.entry_pad_cin if cin == "gen_0" else None
            put_conv(cin, f"block_{cin}", f"conv2d_{cin}", level, pad_cin)
            put_conv(f"noise_{site}", f"film_{site}", f"conv2d_gen_noise_{site}", level)
            put_conv(cout, f"block_{cout}", f"conv2d_{cout}", level)
        for site, cin, cout, level, deconv in self.dec_spec:
            d = p[f"block_{deconv}"][f"deconv2d_{deconv}"]
            W[f"{deconv}/w2"] = deconv_w2(d["kernel"]).to(dt)
            W[f"{deconv}/bias4"] = d["bias"].to(dt).repeat(4)
            put_conv(cin, f"block_{cin}", f"conv2d_{cin}", level,
                     split_cup=d["kernel"].shape[2])
            put_conv(f"noise_{site}", f"film_{site}", f"conv2d_gen_noise_{site}", level)
            put_conv(cout, f"block_{cout}", f"conv2d_{cout}", level)

        seg = p["gen_segmentation"]
        W["gen_segmentation/kernel"], W["gen_segmentation/bias"] = S.conv1x1_to_s2d_kernel(
            seg["kernel"], seg["bias"])
        return {k: v.contiguous() for k, v in W.items()}

    # ------------------------------------------------------------- forward

    def _op(self, key, kernel, plain=None):
        """The function site ``key`` runs, recorded in ``taken``: the
        kernel's wrapper where a kernel takes its widths, else its plain
        version (the gate)."""
        route = self.routes[key]
        self.taken[key] = route or "plain"
        return kernel if route else plain

    def _chains(self, site):
        return self.fuse_chain and self.routes[f"{site}.chain"] is not None

    def _kernel_block(self, W, x_padded, site, cin, cout, mods, pool):
        """A level-1/2 encoder site in padded s2d: conv_in, FiLM, conv_out
        and its 2x2 max-pool ('s2d': the next level's padded plane, 'pixel':
        the pixel domain). Returns (conv_out, pooled)."""
        gamma, beta = (S.tile_channel_params(v) for v in mods[site])

        def pool_of(h):
            return self._op(f"{site}.pool", *((pool_to_s2d, pool_to_s2d_plain) if pool == "s2d"
                                              else (pool_s2d, pool_s2d_plain)))(h)

        if self._chains(site):
            out = self._op(f"{site}.chain", conv3x3_s2d_chain3)(
                x_padded, W[f"{cin}/kernel"], W[f"{cin}/bias"], W[f"noise_{site}/kernel"],
                W[f"noise_{site}/bias"], gamma, beta, W[f"{cout}/kernel"], W[f"{cout}/bias"],
                pool=pool if self.fuse_pool else "")
            return out if self.fuse_pool else (out, pool_of(out))

        def conv(op):
            return self._op(f"{site}.{op}", conv3x3_s2d_fused, conv3x3_s2d_fused_plain)

        h = conv("conv_in")(x_padded, W[f"{cin}/kernel"], W[f"{cin}/bias"])
        h = conv("film")(h, W[f"noise_{site}/kernel"], W[f"noise_{site}/bias"], gamma, beta,
                         mode="film")
        if self.fuse_pool and self.routes[f"{site}.conv_out_pool"] is not None:
            return self._op(f"{site}.conv_out_pool", conv3x3_s2d_fused_pool)(
                h, W[f"{cout}/kernel"], W[f"{cout}/bias"], pool=pool)
        h = conv("conv_out")(h, W[f"{cout}/kernel"], W[f"{cout}/bias"])
        return h, pool_of(h)

    def _kernel_block2(self, W, up, skip, site, cin, cout, mods, head=False):
        """A level-1/2 decoder site in padded s2d: the two-operand entry conv
        over (up, skip), FiLM, conv_out. ``head`` fuses the 1x1 tanh head
        into conv_out and returns its unpadded s2d output instead."""
        gamma, beta = (S.tile_channel_params(v) for v in mods[site])
        if self._chains(site) and not head:
            return self._op(f"{site}.chain", conv3x3_s2d_chain3)(
                up, W[f"{cin}/kernel_up"], W[f"{cin}/bias"], W[f"noise_{site}/kernel"],
                W[f"noise_{site}/bias"], gamma, beta, W[f"{cout}/kernel"], W[f"{cout}/bias"],
                x2_padded=skip, w1b4=W[f"{cin}/kernel_skip"])

        def conv(op):
            return self._op(f"{site}.{op}", conv3x3_s2d_fused, conv3x3_s2d_fused_plain)

        h = self._op(f"{site}.conv_in", conv3x3_s2d_fused2, conv3x3_s2d_fused2_plain)(
            up, skip, W[f"{cin}/kernel_up"], W[f"{cin}/kernel_skip"], W[f"{cin}/bias"])
        h = conv("film")(h, W[f"noise_{site}/kernel"], W[f"noise_{site}/bias"], gamma, beta,
                         mode="film")
        if head:
            return self._op(f"{site}.head", conv3x3_s2d_fused_head, conv3x3_s2d_fused_head_plain)(
                h, W[f"{cout}/kernel"], W[f"{cout}/bias"], W["gen_segmentation/kernel"],
                W["gen_segmentation/bias"])
        return conv("conv_out")(h, W[f"{cout}/kernel"], W[f"{cout}/bias"])

    def _pixel_block(self, W, x, site, cin, cout, mods):
        """A level-3/4 site in the pixel domain, convs in the compute dtype."""
        gamma, beta = (v.to(self.dtype) for v in mods[site])

        def conv(h, name):
            return conv2d_same(h, W[f"{name}/kernel"]) + W[f"{name}/bias"]

        h0 = torch.relu(conv(x, cin))
        hn = conv(h0, f"noise_{site}")
        s = h0 + torch.relu(hn * gamma[:, None, None, :] + beta[:, None, None, :])
        return torch.relu(conv(s, cout))

    def forward(self, W, x, z):
        """x (B, H, W, C_in), z (B, noise_size, 1) -> (B, H, W, n_out) f32."""
        dt = self.dtype
        self.taken = {}
        mods = site_mods(W, z.float(), self._site_slices)  # float32
        x = x.to(dt)

        # Level 1 -> pooled straight into level 2's padded s2d -> level 2 ->
        # pixel-domain pool for level 3.
        if x.shape[-1] <= self.entry_pad_cin:
            x_in = entry_pack(x, c_pad=self.entry_pad_cin)
        else:
            x_in = pad_s2d(S.s2d_unshifted(x))
        (site, cin, cout, _), enc2, enc3 = self.enc_spec
        skip1, h = self._kernel_block(W, x_in, site, cin, cout, mods, pool="s2d")
        skip2, h = self._kernel_block(W, h, *enc2[:3], mods, pool="pixel")
        skip3 = self._pixel_block(W, h, *enc3[:3], mods)
        h = self._pixel_block(W, max_pool_2x2(skip3), *self.mid_spec[:3], mods)

        # The Deconv2x2 upsample is a per-pixel matmul (C -> 4O) whose output
        # is the unshifted s2d of the finer level. p3 stays in pixels.
        site, cin, cout, _, deconv = self.dec_spec[0]
        up = S.d2s(torch.relu(h @ W[f"{deconv}/w2"] + W[f"{deconv}/bias4"]))
        h = self._pixel_block(W, torch.cat([up, skip3], dim=-1), site, cin, cout, mods)

        # p2: the upsample from the pixel domain lands in padded s2d.
        site, cin, cout, _, deconv = self.dec_spec[1]
        up = pad_s2d(torch.relu(h @ W[f"{deconv}/w2"] + W[f"{deconv}/bias4"]))
        h = self._kernel_block2(W, up, skip2, site, cin, cout, mods)

        # p1: the upsample kernel goes from padded s2d to padded s2d.
        site, cin, cout, _, deconv = self.dec_spec[2]
        up = self._op("p1.deconv", deconv_s2d, deconv_s2d_plain)(
            h, W[f"{deconv}/w2"], W[f"{deconv}/bias4"].float())
        head_fused = self.fuse_head and self.cfg.n_out == 1 and self.routes["p1.head"] is not None
        h = self._kernel_block2(W, up, skip1, site, cin, cout, mods, head=head_fused)
        if head_fused:  # the kernel applied the head and its tanh
            return S.d2s(h)

        # Head: 1x1 s2d conv in float32 on the interior, then d2s.
        kseg = W["gen_segmentation/kernel"]
        logits = unpad_s2d(h).float() @ kseg[0, 0] + W["gen_segmentation/bias"]
        logits = S.d2s(logits)
        if self.cfg.n_out == 1:
            return torch.tanh(logits)
        return torch.softmax(logits, dim=-1)


class FastGenerator(FusedGenerator):
    """Inference wrapper: builds the folded, transformed weights once on
    ``device`` and exposes ``__call__(x, z)`` with the fused pools.
    ``fuse_head`` and ``fuse_chain`` stay off, as in JAX; set them on the
    instance to serve through K9 / K10."""

    backward = False

    def __init__(self, cfg: ModelConfig, variables: dict, compute_dtype=torch.bfloat16,
                 device="cuda"):
        super().__init__(cfg, compute_dtype, device)
        self.fuse_pool = True
        self.weights = self.build_weights(variables, device)

    @torch.no_grad()
    def __call__(self, x, z):
        return self.forward(self.weights, x, z)
