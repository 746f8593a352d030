"""Time K1's relu conv with a row-blocked output grid (P2) against K1.

Counterpart of the JAX package's ``scripts/rowblk_probe.py``: at the
generator's level-1 and level-2 relu-conv shapes, ``conv3x3_rowblk`` with
the JAX probe's block counts, each work unit staging its input rows once (a
window of row slots on K1's wgmma mainloop), first checked against K1 on the
same inputs (the same products in the same order: bit for bit), then timed
beside K1 and beside its route before the mainloop (``window_conv``,
``conv3x3_rowblk_window``). Device ms over launches captured in a CUDA
graph; bfloat16.

    python -m depgan_tpu_torch.scripts.rowblk_probe [batch]    # default 64
"""

from __future__ import annotations

import argparse

import torch

# (label, n, 4C, 4Co, block counts)
SHAPES = (("L1 conv (n=128, 4C=128->128)", 128, 128, 128, (5, 10)),
          ("L2 conv (n=64, 4C=256->256)", 64, 256, 256, (3, 6)))


def main(argv=None) -> dict:
    from depgan_tpu_torch.ops import conv_s2d as K
    from depgan_tpu_torch.ops.probes import conv3x3_rowblk, conv3x3_rowblk_window
    from depgan_tpu_torch.scripts import cuda_device
    from depgan_tpu_torch.utils.profiling import cuda_graph_ms

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("batch", type=int, nargs="?", default=64)
    args = parser.parse_args(argv)
    dev = cuda_device()
    b = args.batch
    g = torch.Generator(device=dev).manual_seed(0)
    print(f"rowblk_probe on {torch.cuda.get_device_name(dev)}: batch {b}, bfloat16")
    results = {}
    for label, n, c4, co4, blocks in SHAPES:
        x = K.pad_s2d(torch.randn((b, n, n, c4), generator=g, device=dev)).to(torch.bfloat16)
        w4 = (torch.randn((2, 2, c4, co4), generator=g, device=dev) * 0.05).to(torch.bfloat16)
        bias = torch.randn((co4,), generator=g, device=dev)
        ref = K._conv3x3_s2d_impl(x, w4, bias)
        t_ref = cuda_graph_ms(lambda: K._conv3x3_s2d_impl(x, w4, bias), iters=5)
        print(f"{label}: K1 {t_ref:8.4f} ms")
        for nb in blocks:
            err = float((conv3x3_rowblk(x, w4, bias, nb).float() - ref.float()).abs().max())
            t = cuda_graph_ms(lambda nb=nb: conv3x3_rowblk(x, w4, bias, nb), iters=5)
            t_old = cuda_graph_ms(lambda nb=nb: conv3x3_rowblk_window(x, w4, bias, nb), iters=5)
            same = "bit-identical to K1" if err == 0 else f"max abs {err:.3e} from K1"
            print(f"  rowblk nb={nb} ({(n + 2) // nb} rows/blk): {t:8.4f} ms "
                  f"({t_ref / t:5.3f}x K1's speed; window_conv {t_old:8.4f} ms)  [{same}]")
            results[label, nb] = {"ms": t, "k1_ms": t_ref, "old_ms": t_old,
                                  "max_abs_vs_k1": err}
    return results


if __name__ == "__main__":
    main()
