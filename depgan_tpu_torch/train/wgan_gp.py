"""WGAN-GP losses for the two-critic DEP-GAN.

Counterpart of ``depgan_tpu/train/wgan_gp.py`` (reference
`...twoCritics_training_4fold.py:523-598`):

- Critic Y2 judges fake follow-up images ``y1 + G(x, z)``; critic DEM judges
  the generated evolution map against the real one ``y2 - y1``.
- Gradient penalty: per-example gradient of the critic score at
  ``eps * real + (1 - eps) * fake``, L2 norm over (H, W, C), weight 10.
  The per-example gradient is grad-of-sum: critic scores are independent
  across the batch.
- Generator loss ``-D_y2(fake) - D_dem(dem) + 100 L1 + 100 (volume diff)^2
  + Dice loss``, the volume and Dice terms thresholded with a hard ``>=``
  whose gradient is exactly zero (reference :581-589) under
  ``threshold_mode='hard'``, or a steep sigmoid under ``'soft'``.
"""

from __future__ import annotations

import torch

from ..config import GanTrainConfig


def wmh_mask(x, threshold: float, mode: str, tau: float):
    """Hard (zero-gradient, reference-faithful) or soft WMH thresholding."""
    if mode == "hard":
        return (x >= threshold).float()
    return torch.sigmoid((x - threshold) / tau)


def dice_coef(y_true, y_pred, smooth: float = 1e-7):
    """Soft Dice over the flattened batch (reference :153-157)."""
    inter = torch.sum(y_true * y_pred)
    return (2.0 * inter + smooth) / (torch.sum(y_true) + torch.sum(y_pred) + smooth)


def gradient_penalty(critic_fn, real, fake, eps, input_grad_fn=None):
    """mean((||d critic(mixed) / d mixed||_2 - 1)^2), eps (B, 1, 1, 1).

    ``input_grad_fn`` (optional) supplies d sum(critic(m)) / dm directly:
    the fused critic's hand-chained gradient (``ops/fast_critic``).
    Otherwise autograd takes it with ``create_graph``, so the penalty's
    gradient wrt the critic's parameters is the double backward."""
    mixed = eps * real + (1.0 - eps) * fake
    if input_grad_fn is not None:
        grad = input_grad_fn(mixed)
    else:
        if not mixed.requires_grad:
            mixed = mixed.detach().requires_grad_()
        (grad,) = torch.autograd.grad(critic_fn(mixed).sum(), mixed, create_graph=True)
    norm = torch.sqrt(torch.sum(torch.square(grad), dim=(1, 2, 3)))
    return torch.mean(torch.square(norm - 1.0))


def critic_step_loss(critic_fn, real, fake, eps, gp_weight: float, input_grad_fn=None):
    """Critic loss = E[D(fake)] - E[D(real)] + delta * GP (reference :547).

    Returns (loss, (loss_real, loss_fake)), the two scalars the reference
    logs (reference :550-552)."""
    loss_real = torch.mean(critic_fn(real))
    loss_fake = torch.mean(critic_fn(fake))
    gp = gradient_penalty(critic_fn, real, fake, eps, input_grad_fn)
    return loss_fake - loss_real + gp_weight * gp, (loss_real, loss_fake)


def generator_loss(cfg: GanTrainConfig, threshold: float, dem_fake, y1, y2_real,
                   critic_y2_fn, critic_dem_fn):
    """The five-term generator objective (reference :573-592).

    ``dem_fake`` is G(x, z), ``y1`` the baseline map (channel 0 of the
    generator input), ``y2_real`` the real follow-up, all (B, H, W, 1).
    Returns (loss, aux) with aux the reference's logged tuple (errG,
    errG_CY2, errG_DEM, errG_MSE, errG_VOL, errG_WMH).
    """
    y2_fake = y1 + dem_fake
    dem_real = y2_real - y1

    loss_cy2 = torch.mean(critic_y2_fn(y2_fake))
    loss_cdem = torch.mean(critic_dem_fn(dem_fake))
    loss_l1 = torch.mean(torch.abs(dem_fake - dem_real)) * cfg.l1_weight

    m_real = wmh_mask(y2_real, threshold, cfg.threshold_mode, cfg.soft_threshold_tau)
    m_fake = wmh_mask(y2_fake, threshold, cfg.threshold_mode, cfg.soft_threshold_tau)
    loss_dice = (1.0 - dice_coef(m_real, m_fake)) * cfg.dice_weight
    vol_real = torch.sum(m_real) / 1000.0
    vol_fake = torch.sum(m_fake) / 1000.0
    loss_vol = torch.square(vol_real - vol_fake) * cfg.vol_weight

    loss = -loss_cy2 - loss_cdem + loss_l1 + loss_vol + loss_dice
    aux = {"errG": loss, "errG_CY2": loss_cy2, "errG_DEM": loss_cdem, "errG_MSE": loss_l1,
           "errG_VOL": loss_vol, "errG_WMH": loss_dice}
    return loss, aux
