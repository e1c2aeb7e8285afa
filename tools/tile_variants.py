"""Variants of the tile kernels of the tiled accumulation
(soillib_tpu_torch/csrc/tile_accumulate.cu), timed on the card: the
schedules and geometries the design was chosen from.

Each variant is a text patch of the kernel source, built with the
package's nvcc flags into its own directory under
soillib_tpu_torch/_build/variants_tile/ and timed in its own process (a
process loads one build of the kernels), with CUDA events, minimum of
3 x 20 launches, per LAUNCH, on the DEM path's own inputs at 4096^2:
the seeded terrain of `chip_smoke.py`'s DEM phase (x 400 m, 90 m cells),
`fill_depressions`, the D8 `steepest` graph, and the arguments the tiled
accumulation hands the kernels in `accumulate` and `accumulate_decay`
(0.9999), captured from the plain tile solver together with its results.
Every variant is held against those results, bitwise, on all six calls
(the push in phases 1 and 4 of both accumulations, the trace of both).

  base     the kernel as it is: level-synchronous worklists, warp 0
           alone on levels of at most 32 cells, 1024 threads a tile
  jacobi   the Jacobi rounds alone, every tile (the levels switched
           off): the earlier design's loop in this source
  cont     the push by last-arrival continuation in place of the levels
  notail   every level shared by the whole block (WARP_TAIL = 0)
  tail64   warp 0 alone on the levels of at most 64 cells
  nt256    256 threads a tile (NT)
  nt512    512 threads a tile
  setup    the loads, masks, seeds and stores alone, no level
           (timing only)

--parent FILE adds the earlier kernel source, with the same C entries
(`git show e2cd9bd:soillib_tpu_torch/csrc/tile_accumulate.cu`: one block
of 1024 threads a tile iterating Jacobi rounds to bitwise convergence)
as the variant `parent`.

  python3 tools/tile_variants.py [--parent FILE] [names...]

Prints the card, each build's registers and spills, and one JSON line per
variant: ms per launch of the push (phase 1 of `accumulate`) and of the
trace, the bitwise checks and the tiles' depth (or Jacobi rounds).
"""

import argparse
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

KERNEL = os.path.join(ROOT, "soillib_tpu_torch", "csrc", "tile_accumulate.cu")
OUT = os.path.join(ROOT, "soillib_tpu_torch", "_build", "variants_tile")
INPUTS = os.path.join(OUT, "inputs.pt")
N = 4096

# The level schedule of each kernel, switched off: only the Jacobi branch
# runs.
NO_LEVELS = [("    run_levels<true>(", "    if (false) run_levels<true>("),
             ("    run_levels<false>(", "    if (false) run_levels<false>(")]
# ... and the tiles taken as finished: the loads, masks, seeds and stores.
SETUP = NO_LEVELS + [
    ("exact = head == end && end == t.nx * t.ny && depth <= cap;",
     "exact = true;"),
    ("exact = head == end && end - seeds == cnt[7] && depth <= cap;",
     "exact = true;")]
# The push's levels replaced by a last-arrival continuation: each thread
# walks down from its own leaves; the thread whose decrement brings a
# receiver's count to zero goes on with the receiver, no block barrier.
CONT_FROM = "    // Level l lists the cells of depth l; each solved cell appends the\n"
CONT_TO = "    exact = head == end && end == t.nx * t.ny && depth <= cap;\n"
CONTINUATION = """\
    int done = 0, deepest = 0;
    for (int k = 0; k < CPT; ++k) {
      const int li = tid + k * NT;
      if (!t.in_grid(li) || (meta[li] & 0xffu)) continue;
      int c = li;
      for (;;) {
        solve(c);
        const unsigned m = meta[c] & 0xffu;
        int h = 0;
        for (int d = 0; d < K; ++d)
          if (m & (1u << d)) h = max(h, aux[c - off_of(d)] + 1);
        aux[c] = (unsigned short)h;
        deepest = max(deepest, h);
        ++done;
        const unsigned s = code[c];
        if (s == NONE) break;
        const int r = c + off_of((int)s);
        __threadfence_block();
        if (!arrive(r)) break;
        __threadfence_block();
        c = r;
      }
    }
    done = __reduce_add_sync(0xffffffffu, done);
    deepest = __reduce_max_sync(0xffffffffu, deepest);
    if ((tid & 31) == 0) {
      atomicAdd(&cnt[1], done);
      atomicMax(&cnt[2], deepest);
    }
    __syncthreads();
    depth = cnt[2];
    exact = cnt[1] == t.nx * t.ny && depth <= cap;
"""
# name: (constants to set, text patches (old, new) applied to every
# occurrence, or (from, to, new): the span from..to replaced)
VARIANTS = {
    "base": ({}, []),
    "jacobi": ({}, NO_LEVELS),
    "cont": ({}, [(CONT_FROM, CONT_TO, CONTINUATION)]),
    "notail": ({"WARP_TAIL": 0}, []),
    "tail64": ({"WARP_TAIL": 64}, []),
    "nt256": ({"NT": 256}, []),
    "nt512": ({"NT": 512}, []),
    "setup": ({}, SETUP),
}
TIMING_ONLY = {"setup"}


def patched(src, variant):
    """The source with each `constexpr int NAME = v;` set and each text
    patch applied."""
    consts, texts = variant
    for name, value in consts.items():
        src, n = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {value};", src, count=1)
        if n != 1:
            raise ValueError(f"constant not found: {name}")
    for patch in texts:
        if len(patch) == 3:
            a, b, new = patch
            i = src.index(a)
            j = src.index(b, i) + len(b)
            src = src[:i] + new + src[j:]
            continue
        old, new = patch
        if old not in src:
            raise ValueError(f"patch target not found: {old!r}")
        src = src.replace(old, new)
    return src


def use(name, parent_file):
    """Writes the variant's source into its own directory and points the
    package's kernel loader at it; returns the loader module."""
    from soillib_tpu_torch import _native

    if name == "parent":
        src = open(parent_file).read()
    else:
        src = patched(open(KERNEL).read(), VARIANTS[name])
    d = os.path.join(OUT, name)
    os.makedirs(os.path.join(d, "csrc"), exist_ok=True)
    with open(os.path.join(d, "csrc", "tile_accumulate.cu"), "w") as f:
        f.write(src)
    _native.CSRC, _native.BUILD = os.path.join(d, "csrc"), d
    return _native


def capture_inputs():
    """The DEM path's tile-kernel calls at N^2 and the plain results,
    saved to INPUTS (the plain tile solver: no kernel is built here)."""
    import torch

    import chip_smoke as cs
    import soillib_tpu_torch as soil
    from soillib_tpu_torch.ops import graph, graph_tiled as gt

    h = cs.terrain(N, 17) * 400.0
    flow = soil.steepest(soil.fill_depressions(h), soil.d8)
    slot = graph.graph_to_slots(flow, soil.d8)
    rain = torch.ones((N, N), device="cuda")
    calls = {"local": [], "trace": []}
    with cs.Spy(gt, "local_fp_plain") as loc, \
            cs.Spy(gt, "trace_plain") as tr:
        for decay in (None, 0.9999):
            w = graph._edge_weights(flow, decay, soil.d8)
            gt.accumulate_tiled(slot, rain, w, soil.d8, tile_solver="plain")
    for (lslot, src, w, edge, iters), G in loc.calls:
        calls["local"].append(((lslot.contiguous(), src.contiguous(),
                                w.contiguous(), edge,
                                min(int(iters), gt.TILE ** 2)), (G,)))
    for (sl, _, _, w, edge, iters), (X, D) in tr.calls:
        calls["trace"].append(((sl.contiguous(), w.contiguous(), edge,
                                min(int(iters), gt.TILE ** 2)), (X, D)))
    os.makedirs(OUT, exist_ok=True)
    torch.save({k: [(tuple(a.cpu() if torch.is_tensor(a) else a
                           for a in args),
                     tuple(o.cpu() for o in outs)) for args, outs in v]
                for k, v in calls.items()}, INPUTS)
    return {k: len(v) for k, v in calls.items()}


def timed_kernels(name, parent_file):
    """One variant, in this process: ms per launch and the checks."""
    import torch

    import chip_smoke as cs
    from soillib_tpu_torch.ops import graph_tiled as gt

    use(name, parent_file)
    saved = torch.load(INPUTS)
    out = {"variant": name}
    for kind, fn in (("local", gt.local_fp_cuda), ("trace", gt.trace_cuda)):
        calls = [(tuple(a.cuda() if torch.is_tensor(a) else a for a in args),
                  tuple(o.cuda() for o in outs))
                 for args, outs in saved[kind]]
        equal = []
        for args, want in calls:
            got = fn(*args)
            equal.append(all(torch.equal(g, w) for g, w in zip(got, want)))
        args = calls[0][0]
        out[f"{kind}_ms"] = min(cs.cuda_ms(lambda: fn(*args), 20)
                                for _ in range(3))
        if name not in TIMING_ONLY:
            out[f"{kind}_bitwise"] = equal
        r0 = fn(*args)[-1].cpu()
        if name == "parent":
            out[f"{kind}_jacobi_rounds_mean"] = float(r0.float().mean())
        else:
            dep = r0[r0 >= 0].float()
            out[f"{kind}_depth_max"] = int(dep.max()) if len(dep) else None
            out[f"{kind}_depth_mean"] = float(dep.mean()) if len(dep) else None
            out[f"{kind}_jacobi_tiles"] = int((r0 < 0).sum())
        del calls, got
        torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="the earlier kernel source (see above)")
    ap.add_argument("--run", help=argparse.SUPPRESS)
    ap.add_argument("--build", help=argparse.SUPPRESS)
    ap.add_argument("names", nargs="*")
    a = ap.parse_args()
    if a.build:
        use(a.build, a.parent).build()
        return 0
    if a.run:
        print(json.dumps(timed_kernels(a.run, a.parent)), flush=True)
        return 0
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("tile_variants: no CUDA device", file=sys.stderr)
        return 2
    names = a.names or (list(VARIANTS) + (["parent"] if a.parent else []))
    print(cs.smi_line(), flush=True)
    extra = ["--parent", a.parent] if a.parent else []
    procs = [subprocess.Popen([sys.executable, __file__, "--build", nm,
                               *extra]) for nm in names]
    print(f"inputs: {capture_inputs()} calls", flush=True)
    if any(pr.wait() for pr in procs):
        return 1
    for nm in names:
        for line in use(nm, a.parent).build_log(
                "tile_accumulate").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {nm} ptxas {line.strip()}")
    rc = 0
    for nm in names:
        r = subprocess.run([sys.executable, __file__, "--run", nm, *extra],
                           capture_output=True, text=True)
        print(r.stdout.strip() or f"{nm}: failed\n{r.stderr[-2000:]}",
              flush=True)
        rc = rc or r.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
