"""Variants of the cohort kernels (soillib_tpu_torch/csrc/cohort_round.cu),
timed on the card: experiments that say what binds a design, not designs.

Each variant is a text patch of a kernel source, built with the package's
nvcc flags into its own directory under soillib_tpu_torch/_build/variants/
and timed in its own process (a process loads one build of the kernels),
with CUDA events over 20 launches (10 for the node round), on the inputs
chip_smoke.py's paths give the kernels: the coupled step's two cohort
solves at 4096^2 (32 rounds, albedo on; per round, at the most rounds a
launch) and one 4096^2 color group of CohortClosure(nodes=4, colors=8)
(68 channels, one round).

Variants of this tree's kernel:
  base     the kernel as it is
  xg1      the one-node exchange one channel per barrier (XG = 1)
  cl8      node-round clusters of 8 blocks (CLN = 8)
  align1   one-node blocks of 20 x 36 cells: 16 x 32 owned, on 32-float
           boundaries (RX1, RY1)
  alignn   node-round blocks of 7 x 34 cells: 32 owned columns, on
           32-float boundaries (BXN, BYN)
  nophys   the round physics replaced by a copy of the state (both kernels)
  phys1    the one-node exchange dropped: the physics alone
  noout    the arrivals and output stores dropped (both kernels)

--parent FILE adds a kernel source with the one-round C entry
`cohort_round_launch(kind, albedo, nodes, params, st, aux, G, out, stream)`
(the package's first design, one round per launch on 8 x 32 blocks with a
1-cell ring: `git show 9c5229d:soillib_tpu_torch/csrc/cohort_round.cu`)
and its variants: parent_physics (no exchange or stores), parent_exchange
(the physics replaced by a copy) and parent_tile16 (16 x 32 blocks).

  python3 tools/cohort_variants.py [--parent FILE] [names...]

Prints the card, each build's registers and spills, and one line per
variant and kernel.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

KERNEL = os.path.join(ROOT, "soillib_tpu_torch", "csrc", "cohort_round.cu")
OUT = os.path.join(ROOT, "soillib_tpu_torch", "_build", "variants")
NODES_MARK = "cohort_round_nodes_kernel(CohortParams p"
ONE_MARK = "cohort_rounds_kernel(CohortParams p"
CALL = "round_payloads<KIND, ALBEDO>(p, stv, auxv, pay);"
CALL_N = "round_payloads<KIND, ALBEDO>(p, stv, auxv, pay, sh);"
COPY = ("for (int c = 0; c < P; ++c) for (int d = 0; d < 4; ++d) "
        "pay[c][d] = stv[c] + auxv[d];")
SKIP = " && p.Llen < 0.f"  # never true: the code stays, the work goes

# name: (patches (marker or None, old, new), wrapper constants to set)
VARIANTS = {
    "base": ([], ()),
    "xg1": ([(None, "constexpr int XG = 4;", "constexpr int XG = 1;")],
            (("EXCHANGE_CHANNELS", 1),)),
    "cl8": ([(None, "constexpr int CLN = 4;", "constexpr int CLN = 8;")],
            (("NODES_CLUSTER", 8),)),
    "nophys": ([(NODES_MARK, CALL_N, COPY),
                (ONE_MARK, CALL, COPY.replace("< P", "< S"))], ()),
    "phys1": ([(ONE_MARK,
                "#pragma unroll\n        for (int d = 0; d < 4; ++d)\n"
                "          b[((c - c0) * 4 + d) * NT1 + t] = pay[c][d];\n"
                "      }\n      __syncthreads();\n      if (arrive) {",
                "        stv[c] = ((pay[c][0] + pay[c][1]) + pay[c][2]) + "
                "pay[c][3];\n      }\n      if (arrive" + SKIP + ") {")],
              ()),
    "noout": ([(NODES_MARK, "  if (owner) {\n    // Face 0",
                "  if (owner" + SKIP + ") {\n    // Face 0"),
               (ONE_MARK, "      if (arrive) {",
                "      if (arrive" + SKIP + ") {")], ()),
    # Owned columns on 32-float boundaries: the ring's columns widen the
    # block instead of narrowing the owned tile.
    "align1": ([(None, "constexpr int RX1 = 24;", "constexpr int RX1 = 20;"),
                (None, "constexpr int RY1 = 32;", "constexpr int RY1 = 36;")],
               (("ONE_NODE_BLOCK", (20, 36)),)),
    "alignn": ([(None, "constexpr int BXN = 8;", "constexpr int BXN = 7;"),
                (None, "constexpr int BYN = 32;", "constexpr int BYN = 34;")],
               (("NODES_BLOCK", (7, 34)),)),
}

PARENT_EXCHANGE = (
    "  const bool owner = inside && tx >= 1 && tx < BY - 1 && ty >= 1 &&\n"
    "                     ty < BX - 1;\n#pragma unroll\n"
    "  for (int c = 0; c < S; ++c) {\n"
    "    float(*b)[BX][BY] = buf[c & 1];")
PARENT_VARIANTS = {
    "parent": [],
    "parent_physics": [(PARENT_EXCHANGE,
                        "// The payloads `_round_payloads` leaves out",
                        "  float acc = 0.f;\n#pragma unroll\n"
                        "  for (int c = 0; c < S; ++c)\n#pragma unroll\n"
                        "    for (int d = 0; d < 4; ++d) acc = acc + pay[c][d];"
                        "\n  if (acc == -7.25f * p.Llen) out[cell] = acc;\n"
                        "  (void)buf;\n}\n\n")],
    "parent_exchange": [(None,
                         "    round_payloads<KIND, ALBEDO>(p, stv, auxv, pay);"
                         "\n  } else {",
                         "#pragma unroll\n    for (int c = 0; c < S; ++c)\n"
                         "#pragma unroll\n      for (int d = 0; d < 4; ++d) "
                         "pay[c][d] = stv[c] + auxv[d];\n  } else {")],
    "parent_tile16": [(None, "constexpr int BX = 8;",
                       "constexpr int BX = 16;")],
}


def patched(src, patches, parent=False):
    for mark, old, new in patches:
        if parent and mark is not None:
            # Replace everything from `mark` up to `old` (exclusive).
            i = src.index(mark)
            j = src.index(old, i)
            src = src[:i] + new + src[j:]
            continue
        i = src.index(mark) if mark else 0
        j = src.index(old, i)
        src = src[:j] + new + src[j + len(old):]
    return src


def variant_dir(name, parent_file):
    """Writes the variant's source into its own directory; returns it."""
    if name in PARENT_VARIANTS:
        src = patched(open(parent_file).read(), PARENT_VARIANTS[name], True)
    else:
        src = patched(open(KERNEL).read(), VARIANTS[name][0])
    d = os.path.join(OUT, name)
    os.makedirs(os.path.join(d, "csrc"), exist_ok=True)
    with open(os.path.join(d, "csrc", "cohort_round.cu"), "w") as f:
        f.write(src)
    return d


def use(name, parent_file):
    """Points the package's kernel loader at the variant's build directory
    (and the wrapper at its geometry); returns the loader module."""
    from soillib_tpu_torch import _native
    from soillib_tpu_torch.ops import cohort

    d = variant_dir(name, parent_file)
    _native.CSRC, _native.BUILD = os.path.join(d, "csrc"), d
    for const in VARIANTS.get(name, ((), ()))[1]:
        setattr(cohort, *const)
    return _native


def parent_launch(name, parent_file):
    """The one-round C entry of a parent variant, built apart from the
    tree's kernels (which make its inputs)."""
    from soillib_tpu_torch import _native
    from soillib_tpu_torch.ops import cohort

    saved = _native.CSRC, _native.BUILD
    use(name, parent_file)
    path = _native._target("cohort_round")
    _native.CSRC, _native.BUILD = saved
    fn = ctypes.CDLL(path).cohort_round_launch
    fn.argtypes = [ctypes.c_int] * 3 + [
        ctypes.POINTER(cohort._CohortParams)] + [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    return fn


def timed_kernels(name, parent_file):
    """{kernel: ms} of one variant, in this process."""
    import torch

    import chip_smoke as cs
    import soillib_tpu_torch as soil
    from soillib_tpu_torch.ops import cohort

    parent = name in PARENT_VARIANTS
    if not parent:
        use(name, parent_file)
    n = 4096
    out = {"variant": name}
    stream = torch.cuda.current_stream().cuda_stream
    p = soil.ErosionParams()
    p.transportIterations = 32
    p.trackAlbedo = True
    sim = soil.ErosionSim((n, n), (0.1, 0.1, 4.0), p,
                          state=soil.ErosionState.zeros(
                              (n, n), height=cs.terrain(n, 7)))
    sim.step()
    cap = cs.capture_solves(sim)
    del sim
    torch.cuda.empty_cache()
    old = parent_launch(name, parent_file) if parent else None
    for kind in ("fluvial", "debris"):
        st, aux, rules, Llen = cap[kind]
        S, W, H = st.shape
        G = torch.zeros((S - cohort.NSTATE, W, H), device="cuda")
        res = torch.empty_like(st)
        prm = cohort._kernel_params(rules, W, H, Llen)
        k = 1 if parent else cohort.ROUNDS_PER_LAUNCH

        def go():
            if parent:
                assert old(cohort._RULE_KINDS[kind], 1, 1, ctypes.byref(prm),
                           st.data_ptr(), aux.data_ptr(), G.data_ptr(),
                           res.data_ptr(), stream) == 0
            else:
                cohort.cohort_rounds_cuda(st, aux, G, rules, Llen, k, out=res)
        out[f"{kind}_ms_per_round"] = min(cs.cuda_ms(go, 20) / k
                                          for _ in range(3))
        del G, res
    del cap
    torch.cuda.empty_cache()
    if parent and name != "parent":
        return out
    q = cs.quality_params(2)
    sim = soil.ErosionSim((n, n), (0.1, 0.1, 4.0), q,
                          state=soil.ErosionState.zeros(
                              (n, n), height=cs.terrain(n, 37)))
    with cs.CaptureFirstGroup(4 * 17) as c:
        sim.step()
    del sim
    torch.cuda.empty_cache()
    st, aux, rules, Llen = c.captured
    S, W, H = st.shape
    G = torch.zeros((S // 4 - cohort.NSTATE, W, H), device="cuda")
    res = torch.empty_like(st)
    prm = cohort._kernel_params(rules, W, H, Llen)

    def go():
        if parent:
            assert old(0, 1, 4, ctypes.byref(prm), st.data_ptr(),
                       aux.data_ptr(), G.data_ptr(), res.data_ptr(),
                       stream) == 0
        else:
            cohort.cohort_round_cuda(st, aux, G, rules, Llen, out=res, nodes=4)
    out["nodes4_ms"] = min(cs.cuda_ms(go, 10) for _ in range(3))
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
        print("cohort_variants: no CUDA device", file=sys.stderr)
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
        for line in use(nm, a.parent).build_log("cohort_round").splitlines():
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
