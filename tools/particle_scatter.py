#!/usr/bin/env python3
"""Times the particle estimators' scatter-add on one CUDA card, in the
layouts it could take: the flux channel-first (C, W*H) with
`index_add_` along the cells (each particle's C values land in C
different rows), the flux cell-major (W*H, C) with `index_add_` along
dim 0 (each particle's values land in one row) from a contiguous source
or from the transposed view of a channel-first one, C one-channel
scatters, and `index_put_(accumulate=True)`. 4096^2 cells, one particle
a cell, C = 7 (the fluvial flux), with the cells drawn at random (the
births) and sorted (particles bunched into channels). Also one
elementwise op and one random gather over the particles, for scale.

    python3 tools/particle_scatter.py

Prints one JSON line: ms per call (CUDA events, 10 calls after one
warm-up), the largest difference between the two layouts' sums, and
the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys


def cuda_ms(fn, reps=10):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main(n=4096, C=7) -> int:
    import torch

    if not torch.cuda.is_available():
        print("particle_scatter: no CUDA device", file=sys.stderr)
        return 2
    dev = "cuda"
    N = n * n
    g = torch.Generator(device=dev).manual_seed(0)
    births = (torch.rand(N, generator=g, device=dev) * (n * n)).long()
    src_cf = torch.rand(C, N, generator=g, device=dev)
    src_pm = src_cf.T.contiguous()
    rows = torch.arange(C, device=dev)[:, None]
    out = {"cells": n * n, "particles": N, "channels": C}
    for name, idx in (("random", births),
                      ("sorted", torch.sort(births).values)):
        f_cf = torch.zeros(C, n * n, device=dev)
        f_pm = torch.zeros(n * n, C, device=dev)
        out[name] = {
            "channel_first_dim1": cuda_ms(
                lambda: f_cf.index_add_(1, idx, src_cf)),
            "cell_major_dim0_contiguous": cuda_ms(
                lambda: f_pm.index_add_(0, idx, src_pm)),
            "cell_major_dim0_from_transposed_view": cuda_ms(
                lambda: f_pm.index_add_(0, idx, src_cf.T)),
            "per_channel_1d": cuda_ms(
                lambda: [f_cf[c].index_add_(0, idx, src_cf[c])
                         for c in range(C)]),
            "index_put_accumulate": cuda_ms(
                lambda: f_cf.index_put_((rows, idx[None]), src_cf,
                                        accumulate=True)),
        }
        a = torch.zeros(C, n * n, device=dev).index_add_(1, idx, src_cf)
        b = torch.zeros(n * n, C, device=dev).index_add_(0, idx, src_pm).T
        out[name]["max_abs_diff_between_layouts"] = float(
            (a - b).abs().max())
    x = torch.rand(N, device=dev)
    out["elementwise_op_ms"] = cuda_ms(lambda: x * 2.0)
    out["random_gather_ms"] = cuda_ms(lambda: x[births])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(torch.cuda.current_device())],
        capture_output=True, text=True, timeout=30)
    out["device"] = smi.stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
