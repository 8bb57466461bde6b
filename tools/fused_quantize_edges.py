"""Degenerate scales through the port's ``fused_quantize`` on one GPU.

    python3 tools/fused_quantize_edges.py [--src SRC]

Encodes rows whose Int8Quantizer scales are tiny — Int8Quantizer's floor
scale (1e-12/255) on one column or on every column, and rows of low rank,
whose trailing PCA columns hold rounding noise — with the kernel and with
its plain version (``fused_quantize_ref``), and prints, for each case, the
largest code difference, the share of codes that differ and how many
differ by more than 1 (repro's bar: at most 1, on fewer than 1%).  In such
columns the code is decided by the last bits of w, so an encode that is
not bit for bit the plain version's can differ by up to 255.  ``--src``
names the ``src`` directory whose ``repro_torch`` runs (default: this
checkout's), so that two versions of the kernel can be compared on the
same inputs.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))

    import torch
    from repro_torch.core import (CenterNorm, CompressionPipeline,
                                  Int8Quantizer, PCA)
    from repro_torch.kernels.fused_quantize.kernel import fused_quantize
    from repro_torch.kernels.fused_quantize.ops import params_from_pipeline
    from repro_torch.kernels.fused_quantize.ref import fused_quantize_ref

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(2)

    def case(n, d, d_out, rank=None):
        """Seeded rows off the origin (of rank ``rank``, if given) and the
        fused parameters of a pipeline fitted on the first 65,536."""
        if rank is None:
            x = torch.randn(n, d, device="cuda", generator=gen)
        else:
            x = torch.randn(n, rank, device="cuda", generator=gen) @ \
                torch.randn(rank, d, device="cuda", generator=gen)
        x += 3.0 * torch.randn(d, device="cuda", generator=gen)
        pipe = CompressionPipeline([CenterNorm(), PCA(d_out), CenterNorm(),
                                    Int8Quantizer()])
        pipe.fit(x[:65536])
        return x, params_from_pipeline(pipe)

    def report(tag, x, params):
        diff = (fused_quantize(x, *params).int()
                - fused_quantize_ref(x, *params).int()).abs()
        worst, share = int(diff.max()), float((diff > 0).float().mean())
        print(f"{tag}: max code diff {worst}, share differing {share:.3g}, "
              f"{int((diff > 1).sum())} of {diff.numel()} codes off by more "
              f"than 1; within the bar: {worst <= 1 and share < 0.01}; "
              f"smallest scale {float(params[3].min()):.3g}")

    floor = 1e-12 / 255
    for shape in ((500, 96, 40), (70000, 96, 40)):
        x, p = case(*shape)
        report(f"{shape} every column at the floor scale", x,
               (*p[:3], torch.full_like(p[3], floor), p[4]))
        x, p = case(*shape)
        scale = p[3].clone()
        scale[5] = floor
        report(f"{shape} column 5 at the floor scale", x,
               (*p[:3], scale, p[4]))
        x, p = case(*shape, rank=30)
        report(f"{shape} rows of rank 30, fitted scales", x, p)
    x, p = case(70000, 768, 128, rank=100)
    report("(70000, 768, 128) rows of rank 100, fitted scales", x, p)
    return 0


if __name__ == "__main__":
    sys.exit(main())
