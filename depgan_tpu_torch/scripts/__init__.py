"""Probes of the port's kernels on the card: ``python -m
depgan_tpu_torch.scripts.<name> [batch]``, the counterparts of the JAX
package's ``scripts/kernel_anatomy.py``, ``rowblk_probe.py`` and
``packed_tap_probe.py``, and ``engine_registers`` (what ptxas allocated for
the GEMM engine's kernels)."""


def cuda_device():
    """The card, with TF32 off; the probes time kernels and have no CPU mode."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("the probes need a CUDA device (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")
