"""What the drivers share: the program's model configuration of a cell, the
precision of its products, the generator's weights made from the seed, and
a wait for the device."""

from __future__ import annotations

import torch

from portbench.reference import nets
from portbench.yardstick import weights


def model_config(cell):
    """``depgan_tpu_torch``'s ``ModelConfig`` from the cell's configuration
    file and its mix's path (``compute_dtype``, ``use_pallas``)."""
    from depgan_tpu_torch.config import ModelConfig

    cfg, tr = cell.config, cell.traffic
    return ModelConfig(image_size=cfg["image_size"], noise_size=cfg["noise_size"],
                       first_fm=cfg["first_fm"], n_input_channels=cfg["n_input_channels"],
                       n_out=cfg["n_out"], dropout_mode=cfg["dropout_mode"],
                       dropout_rate=cfg["dropout_rate"], compute_dtype=tr["compute_dtype"],
                       use_pallas=tr["use_pallas"])


def set_products(cell) -> None:
    """Sets the program's products to the precision the mix states. A
    float32 mix states ``"products": "tf32"``: float32 storage, the cuDNN
    convolutions' products in TF32 on the tensor cores (``cudnn.allow_tf32``,
    torch's default), matmul at torch's default. The float32 peak of
    ``yardstick/model.py`` and the cells' bfloat16 control stand on it."""
    tr = cell.traffic
    if tr["compute_dtype"] != "float32":
        return
    if tr.get("products") != "tf32":
        raise ValueError(f"mix {cell.traffic_name}: a float32 mix states \"products\": \"tf32\"")
    torch.backends.cudnn.allow_tf32 = True


def generator_weights(cell, seed: int, device, x: torch.Tensor):
    """Generator parameters and statistics from the seed, the head
    calibrated over ``x`` with the reference."""
    cfg = cell.config
    spec = nets.generator_spec(cfg)
    params, stats = weights.split(weights.make(spec, seed, device), spec)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    z = torch.randn((x.shape[0], cfg["noise_size"], 1), generator=gen, device=device)
    logits, prec = [], nets.Precision()
    with torch.no_grad(), prec.products():
        nets.generator(params, stats, cfg, x, z, prec, head_hook=logits.append)
    weights.calibrate_head(params, logits[0])
    return params, stats


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
