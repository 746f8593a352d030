"""Time the column deinterleave (P3) that a pixel-domain packed-tap design
needs at each pool and deconv boundary.

Counterpart of the JAX package's ``scripts/packed_tap_probe.py``:
(B, n, 2m, c) -> (B, n, m, 2c), even columns in [:c], odd in [c:], at the
level-1/2 and level-2/3 boundaries in bfloat16, through

  library      torch.cat((x[:, :, 0::2], x[:, :, 1::2]), -1) (the plain version)
  reshape_idx  the kernel that decodes each output vector's source
  merge        the kernel that copies the plane flat (the identity on memory)

each checked equal to the library call, and timed on the device (launches
captured in a CUDA graph) against the bound: each byte read once and
written once over the H100's 3.35 TB/s.

    python -m depgan_tpu_torch.scripts.packed_tap_probe [batch]    # default 256
"""

from __future__ import annotations

import argparse

import torch

PEAK_BYTES = 3.35e12  # H100 SXM HBM3
# (label, rows n, column pairs m, channels c)
SHAPES = (("L1->L2 boundary (256 rows, 128 col-pairs, c=32)", 256, 128, 32),
          ("L2->L3 boundary (128 rows, 64 col-pairs, c=64)", 128, 64, 64))


def main(argv=None) -> dict:
    from depgan_tpu_torch.ops.probes import deint, deint_plain
    from depgan_tpu_torch.scripts import cuda_device
    from depgan_tpu_torch.utils.profiling import cuda_graph_ms

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("batch", type=int, nargs="?", default=256)
    args = parser.parse_args(argv)
    dev = cuda_device()
    b = args.batch
    g = torch.Generator(device=dev).manual_seed(1)
    print(f"packed_tap_probe on {torch.cuda.get_device_name(dev)}: batch {b}, bfloat16")
    results = {}
    for label, n, m, c in SHAPES:
        x = torch.randn((b, n, 2 * m, c), generator=g, device=dev).to(torch.bfloat16)
        bound = 2 * x.numel() * x.element_size() / PEAK_BYTES * 1e3
        ref = deint_plain(x)
        row = {"bound_ms": bound, "library_ms": cuda_graph_ms(lambda: deint_plain(x), iters=5)}
        print(f"{label}: {x.numel() * x.element_size() / 2**30:.3f} GiB in, bound {bound:.4f} ms, "
              f"library {row['library_ms']:.4f} ms")
        for kind in ("reshape_idx", "merge"):
            if not torch.equal(deint(x, kind), ref):
                raise RuntimeError(f"deint {kind} differs from the library call at {label}")
            row[kind] = cuda_graph_ms(lambda kind=kind: deint(x, kind), iters=5)
            print(f"  {kind:12s} {row[kind]:8.4f} ms  ({bound / row[kind]:.3f} of the bound's "
                  f"speed)  [equal to the library call]")
        results[label] = row
        del x, ref
    return results


if __name__ == "__main__":
    main()
