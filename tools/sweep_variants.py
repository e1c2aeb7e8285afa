"""Variants of the transport sweep kernel (soillib_tpu_torch/csrc/
transport_sweep.cu), timed on the card: experiments that say what binds a
design, not designs.

Each variant is a text patch of a kernel source, built with the package's
nvcc flags into its own directory under
soillib_tpu_torch/_build/variants_sweep/ and timed in its own process (a
process loads one build of the kernels), with CUDA events, minimum of
3 x 20 launches, per ROUND, at the two shapes the port's paths give the
kernel: C = 1 at 4096^2 (`solve_uniform` on the DEM path) and C = 7 at
4096^2 (the field-static erosion step). The inputs
are seeded: E = |N(0, 1)|, att ~ U(0.3, 0.99), unit directions with a
zero direction every 9th row and 7th column.

Variants of this tree's kernel (the K-round design; timed at the most
rounds a launch, through `transport_rounds_cuda`, and held against the
plain rounds on the same inputs, bitwise, unless marked timing only):
  base     the kernel as it is
  k16      16 rounds a launch (SWEEP_K), owned tiles of 32 rows
  k16tx16  16 rounds a launch, owned tiles of 16 rows
  tx16     owned tiles of 16 rows (TX) at 8 rounds a launch
  onetile  one block a tile (no persistent blocks): each tile's window
           staged and waited for before its rounds, no overlap
  notma    every thread stages its own cells with 4-byte cp.async (the
           path for H not a multiple of 4), not the tensor maps
  nobar    the round's barrier dropped (timing only)
  nolds    every neighbour's payload from the thread's own registers, no
           shared loads in the gather (timing only)
  noround  the rounds' payloads and updates dropped: the window loads,
           the barriers and the owned stores alone

--parent FILE adds a kernel source with the one-round C entry
`transport_round_launch(G, E, att, vx, vy, out, C, W, H, stream)` (the
package's first design, one round per launch:
`git show 12403c3:soillib_tpu_torch/csrc/transport_sweep.cu`) and its
variants:
  parent           the one-round kernel as it is
  parent_nodiv     the weights' two divisions replaced by products
  parent_noweights the weights read as vx, vy are, no weight arithmetic
  parent_own       every donor term read at the cell itself (aligned,
                   no neighbour reads)
  parent_copy      out = G per channel, nothing else

  python3 tools/sweep_variants.py [--parent FILE] [names...]

Prints the card, each build's registers and spills, and one JSON line per
variant.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

KERNEL = os.path.join(ROOT, "soillib_tpu_torch", "csrc", "transport_sweep.cu")
OUT = os.path.join(ROOT, "soillib_tpu_torch", "_build", "variants_sweep")
N = 4096

# name: (patches (old, new), wrapper constants to set)
KP = "constexpr int SWEEP_K = 8;"
TP = "constexpr int TX = 32;"
VARIANTS = {
    "base": ([], ()),
    "k16": ([(KP, KP.replace("8", "16"))],
            (("SWEEP_K", 16), ("SWEEP_TILE", (32, 96)))),
    "k16tx16": ([(KP, KP.replace("8", "16")), (TP, TP.replace("32", "16"))],
                (("SWEEP_K", 16), ("SWEEP_TILE", (16, 96)))),
    "tx16": ([(TP, TP.replace("32", "16"))], (("SWEEP_TILE", (16, 112)),)),
    "onetile": ([("constexpr int BPS = 1;", "constexpr int BPS = 1 << 20;"),
                 ("__launch_bounds__(WY / CY * NTX, BPS)",
                  "__launch_bounds__(WY / CY * NTX, 1)")],
                (("SWEEP_BLOCKS_PER_SM", 1 << 20),)),
    "notma": ([("const bool aligned = H % 4 == 0 &&",
                "const bool aligned = false &&")], ()),
    "nobar": ([("""              sp[slot(j, row0 + i, l)] = p[i][j];
          }
        }
      }
      __syncthreads();""", """              sp[slot(j, row0 + i, l)] = p[i][j];
          }
        }
      }""")], ()),
    "nolds": ([("j > 0 ? p[i][j - 1] : sp[slot(CY - 1, row0 + i, l - 1)]",
                "j > 0 ? p[i][j - 1] : p[i][j]"),
               ("j < CY - 1 ? p[i][j + 1] : sp[slot(0, row0 + i, l + 1)]",
                "j < CY - 1 ? p[i][j + 1] : p[i][j]"),
               ("i > 0 ? p[i - 1][j] : sp[slot(j, row0 - 1, l)]",
                "i > 0 ? p[i - 1][j] : p[i][j]"),
               ("i < RX - 1 ? p[i + 1][j] : sp[slot(j, row0 + RX, l)]",
                "i < RX - 1 ? p[i + 1][j] : p[i][j]")], ()),
    "noround": ([("if (i >= plo && i <= phi && j >= s.cl && j < s.cn && "
                  "dy[j] <= dp) {",
                  "if (i >= plo && i <= phi && j >= s.cl && j < s.cn && "
                  "dy[j] <= dp && W < 0) {"),
                 ("if (i >= ulo && i <= uhi && j >= s.cl && j < s.cn && "
                  "dy[j] <= du) {",
                  "if (i >= ulo && i <= uhi && j >= s.cl && j < s.cn && "
                  "dy[j] <= du && W < 0) {")], ()),
}

PARENT_WEIGHTS = "const float wx = ax / denom, wy = ay / denom;"
PARENT_VARIANTS = {
    "parent": [],
    "parent_nodiv": [(PARENT_WEIGHTS,
                      "const float wx = ax * denom, wy = ay * denom;")],
    "parent_noweights": [
        ("round_weights(vx[i - H], vy[i - H]).xp", "vx[i - H]"),
        ("round_weights(vx[i + H], vy[i + H]).xn", "vx[i + H]"),
        ("round_weights(vx[i - 1], vy[i - 1]).yp", "vy[i - 1]"),
        ("round_weights(vx[i + 1], vy[i + 1]).yn", "vy[i + 1]")],
    "parent_own": [("(a[i - H] * (e[i - H] + g[i - H]))",
                    "(a[i] * (e[i] + g[i]))"),
                   ("(a[i + H] * (e[i + H] + g[i + H]))",
                    "(a[i] * (e[i] + g[i]))"),
                   ("(a[i - 1] * (e[i - 1] + g[i - 1]))",
                    "(a[i] * (e[i] + g[i]))"),
                   ("(a[i + 1] * (e[i + 1] + g[i + 1]))",
                    "(a[i] * (e[i] + g[i]))")],
    "parent_copy": [("  const bool hxm = x > 0,",
                     "  for (int c = 0; c < C; ++c) out[c * WH + i] = "
                     "G[c * WH + i];\n  if (W > 0) return;\n"
                     "  const bool hxm = x > 0,")],
}


def patched(src, patches):
    for old, new in patches:
        if old not in src:
            raise ValueError(f"patch target not found: {old!r}")
        src = src.replace(old, new, 1)
    return src


def variant_dir(name, parent_file):
    """Writes the variant's source into its own directory; returns it."""
    if name in PARENT_VARIANTS:
        src = patched(open(parent_file).read(), PARENT_VARIANTS[name])
    else:
        src = patched(open(KERNEL).read(), VARIANTS[name][0])
    d = os.path.join(OUT, name)
    os.makedirs(os.path.join(d, "csrc"), exist_ok=True)
    with open(os.path.join(d, "csrc", "transport_sweep.cu"), "w") as f:
        f.write(src)
    return d


def use(name, parent_file):
    """Points the package's kernel loader at the variant's build directory
    (and the wrapper at its constants); returns the loader module."""
    from soillib_tpu_torch import _native
    from soillib_tpu_torch.ops import sweep

    d = variant_dir(name, parent_file)
    _native.CSRC, _native.BUILD = os.path.join(d, "csrc"), d
    for attr, value in VARIANTS.get(name, ((), ()))[1]:
        setattr(sweep, attr, value)
    return _native


def inputs(C, seed):
    """Seeded (E, att, vx, vy) at C x N x N on the card."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    E = torch.randn((C, N, N), device="cuda", generator=g).abs_()
    att = torch.rand((C, N, N), device="cuda", generator=g) * 0.69 + 0.3
    d = torch.randn((2, N, N), device="cuda", generator=g)
    d[:, ::9, ::7] = 0.0
    n = torch.clamp(torch.sqrt(d[0] ** 2 + d[1] ** 2), min=1e-30)
    return E, att, (d[0] / n).contiguous(), (d[1] / n).contiguous()


def timed_kernels(name, parent_file):
    """{shape: ms per round} of one variant, in this process."""
    import torch

    import chip_smoke as cs
    from soillib_tpu_torch.ops import sweep

    parent = name in PARENT_VARIANTS
    out = {"variant": name}
    path = use(name, parent_file)._target("transport_sweep")
    if parent:
        fn = ctypes.CDLL(path).transport_round_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    for C in (1, 7):
        E, att, vx, vy = inputs(C, C)
        G = torch.rand_like(E)
        res = torch.empty_like(E)
        k = 1 if parent else sweep.SWEEP_K

        def go(rounds=k):
            ptrs = (G.data_ptr(), E.data_ptr(), att.data_ptr(),
                    vx.data_ptr(), vy.data_ptr(), res.data_ptr(), C, N, N)
            if parent:
                assert fn(*ptrs, stream) == 0
            else:
                sweep.transport_rounds_cuda(G, E, att, vx, vy, rounds, res)
            return res
        out[f"C{C}_ms_per_round"] = min(cs.cuda_ms(go, 20) / k
                                        for _ in range(3))
        if not parent and name not in ("nobar", "nolds", "noround"):
            got = go()
            want = sweep.transport_advance_reference(G, E, att, vx, vy, k)
            out[f"C{C}_bitwise"] = bool(torch.equal(got, want))
            del got, want
        del E, att, vx, vy, G, res
        torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a one-round kernel source (see above)")
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
        print("sweep_variants: no CUDA device", file=sys.stderr)
        return 2
    names = a.names or (list(VARIANTS) + (list(PARENT_VARIANTS)
                                          if a.parent else []))
    print(cs.smi_line(), flush=True)
    extra = ["--parent", a.parent] if a.parent else []
    procs = [subprocess.Popen([sys.executable, __file__, "--build", nm,
                               *extra]) for nm in names]
    if any(pr.wait() for pr in procs):
        return 1
    for nm in names:
        for line in use(nm, a.parent).build_log(
                "transport_sweep").splitlines():
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
