"""Split the fused s2d conv kernel (K1, relu) into its phases and time each.

Counterpart of the JAX package's ``scripts/kernel_anatomy.py``. Each variant
is K1's bf16 wgmma mainloop with a probe phase (``s2d_wgmma``'s PHASE,
``csrc/wgmma_kernels.cu``), which repeats its phase ``reps`` times a tile
inside one launch:

  full         loads + products + bias/relu + store, per rep
  no_epi       loads + products + a raw store (no bias, no relu)
  matmul_only  products over the pre-gathered taps (2-d boxes of a dense A) + store
  stage_only   the producer's A loads alone

and each phase's cost is the marginal ``(t(reps=5) - t(reps=1)) / 4``, which
cancels what every launch pays once (the launch, the ring, the tail). A rep
re-reads its tile's boxes, which the first rep brought into L2, so the
marginals are L2-fed, not HBM-fed. The same phases on the GEMM engine
(``kernel_anatomy_engine``, the route before the mainloop) are timed beside.
Times are device ms over launches captured in a CUDA graph. At the level-1
shape (n 128, 4C = 4Co = 128, bfloat16).

    python -m depgan_tpu_torch.scripts.kernel_anatomy [batch]    # default 64
"""

from __future__ import annotations

import argparse

import torch

N, C4, CO4, REPS = 128, 128, 128, (1, 5)
PHASES = ("full", "no_epi", "matmul_only", "stage_only")


def main(argv=None) -> dict:
    from depgan_tpu_torch.ops import conv_s2d as K
    from depgan_tpu_torch.ops.probes import gathered_taps, kernel_anatomy, kernel_anatomy_engine
    from depgan_tpu_torch.scripts import cuda_device
    from depgan_tpu_torch.utils.profiling import cuda_graph_ms

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("batch", type=int, nargs="?", default=64)
    args = parser.parse_args(argv)
    dev = cuda_device()
    b = args.batch
    g = torch.Generator(device=dev).manual_seed(0)
    x = K.pad_s2d(torch.randn((b, N, N, C4), generator=g, device=dev)).to(torch.bfloat16)
    w4 = (torch.randn((2, 2, C4, CO4), generator=g, device=dev) * 0.05).to(torch.bfloat16)
    bias = torch.randn((CO4,), generator=g, device=dev)
    a_dense = gathered_taps(x)
    print(f"kernel_anatomy on {torch.cuda.get_device_name(dev)}: batch {b}, n {N}, "
          f"4C {C4} -> 4Co {CO4}, bfloat16, reps {REPS}")
    k1_ms = cuda_graph_ms(lambda: K._conv3x3_s2d_impl(x, w4, bias), iters=4)
    result = {"batch": b, "k1_ms": k1_ms}
    for route, fn in (("", kernel_anatomy), ("engine_", kernel_anatomy_engine)):
        times = {phase: {r: cuda_graph_ms(
            lambda r=r, phase=phase: fn(phase, x, w4, bias, r, a_dense), iters=4) for r in REPS}
            for phase in PHASES}
        marg = {p: (t[REPS[1]] - t[REPS[0]]) / (REPS[1] - REPS[0]) for p, t in times.items()}
        what = "the engine (old route)" if route else "the wgmma mainloop"
        for phase in PHASES:
            t = times[phase]
            print(f"  {what}: {phase:12s} reps=1 {t[1]:8.4f} ms  reps=5 {t[5]:8.4f} ms  "
                  f"marginal {marg[phase]:8.4f} ms/rep  (fixed {t[1] - marg[phase]:8.4f} ms)")
        print(f"PHASE TABLE, {what} (marginal ms/rep, each rep L2-fed): staging "
              f"{marg['stage_only']:.4f}  matmul+store {marg['matmul_only']:.4f}  epilogue "
              f"{marg['full'] - marg['no_epi']:.4f}  | full {marg['full']:.4f}  (stage+matmul sum "
              f"{marg['stage_only'] + marg['matmul_only']:.4f}); K1 itself {k1_ms:.4f} ms a launch")
        result[f"{route}ms"], result[f"{route}marginal_ms"] = times, marg
    return result


if __name__ == "__main__":
    main()
