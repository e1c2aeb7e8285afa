"""Compare two builds of a kernel source kernel by kernel, in PTX.

    python3 tools/ptx_compare.py OLD NEW [-DNAME=VALUE ...]

OLD and NEW are CUDA sources (.cu), compiled here to PTX with the
package's nvcc flags (soillib_tpu_torch/_native.py NVCC_FLAGS, as PTX for
sm_90a, with the -D defines given), or PTX files (.ptx), read as they are.
Each text is split into its functions (.entry and .func); in each, the
virtual registers are renumbered in order of first use, and the branch
labels and the anonymous namespace's hash are made neutral, so that two
builds of the same instructions compare equal. Prints one line per
function: equal; the count of lines that differ, and whether they differ
in their registers only (equal once every register name is removed: the
same instructions, with another assignment of virtual registers); or
missing from one side. Exits 1 unless every function of OLD is in NEW
and equal.
"""

import argparse
import difflib
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# The flags that only concern linking a shared library or its log.
_LINK_FLAGS = {"-shared": 0, "-Xcompiler": 1, "-Xptxas": 1}

# The anonymous namespace's name carries the source's file name and a
# hash; in a mangled name it follows the length of both.
_ANON = re.compile(r"(?:_ZN\d+)?_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_"
                   r"[0-9a-f]{8}")
_LABEL = re.compile(r"\$L__BB\d+_")
_REG = re.compile(r"%([a-z]+)(\d+)\b")
_HEAD = re.compile(r"^(?:\.visible |\.weak )?\.(entry|func)\s+"
                   r"(?:\([^)]*\)\s*)?([\w$]+)")


def ptx_flags() -> list:
    """NVCC_FLAGS less those of the link and the log, as PTX for sm_90a."""
    from soillib_tpu_torch import _native

    flags, skip = [], 0
    it = iter(_native.NVCC_FLAGS)
    for f in it:
        if skip:
            skip -= 1
            continue
        if f in _LINK_FLAGS:
            skip = _LINK_FLAGS[f]
            continue
        if f == "-gencode":
            next(it)
            flags.append("-arch=sm_90a")
            continue
        flags.append(f)
    return flags + ["-ptx"]


def ptx_text(path, defines) -> str:
    """The PTX of `path`: read, or compiled from a .cu source."""
    if path.endswith(".ptx"):
        with open(path) as f:
            return f.read()
    from soillib_tpu_torch import _native

    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "k.ptx")
        subprocess.run([_native.nvcc_path(), *ptx_flags(), *defines, "-o",
                        out, path], check=True)
        with open(out) as f:
            return f.read()


def functions(text) -> dict:
    """{name: canonical lines} of every .entry and .func in the PTX."""
    out = {}
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        m = _HEAD.match(lines[i])
        if not m:
            i += 1
            continue
        body = []
        while i < len(lines):
            body.append(lines[i])
            i += 1
            if body[-1] == "}" or (body[-1].endswith(";") and
                                   "{" not in "".join(body)):
                break
        out[_ANON.sub("_ANON_", m[2])] = canonical(body)
    return out


def canonical(body) -> list:
    """The lines with registers renumbered per class in order of first
    use, labels and the anonymous namespace's hash made neutral."""
    seen = {}

    def reg(m):
        cls = m[1]
        key = (cls, m[2])
        if key not in seen:
            seen[key] = sum(1 for k in seen if k[0] == cls)
        return f"%{cls}{seen[key]}"

    return [_REG.sub(reg, _LABEL.sub("$L__BB_", _ANON.sub("_ANON_", ln)))
            for ln in body]


def unnamed(lines) -> list:
    """The lines with every register name replaced by its class."""
    return [_REG.sub(lambda m: f"%{m[1]}", ln) for ln in lines]


def changed(a, b) -> list:
    """The lines of a unified diff of a and b that differ."""
    return [ln for ln in difflib.unified_diff(a, b, lineterm="", n=0)
            if ln[:1] in "+-" and ln[:3] not in ("+++", "---")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 tools/ptx_compare.py")
    ap.add_argument("old")
    ap.add_argument("new")
    args, defines = ap.parse_known_args(argv)
    old = functions(ptx_text(args.old, defines))
    new = functions(ptx_text(args.new, defines))
    same = True
    for name in sorted(set(old) | set(new)):
        if name not in new or name not in old:
            where = "new" if name not in old else "old"
            print(f"{name}: only in the {where} build")
            same = same and name not in old
            continue
        diff = changed(old[name], new[name])
        if not diff:
            verdict = "equal"
        elif not changed(unnamed(old[name]), unnamed(new[name])):
            verdict = (f"{len(diff)} lines differ in their registers only "
                       f"(equal with every register name removed)")
        else:
            verdict = f"{len(diff)} lines differ"
        print(f"{name}: {len(old[name])} lines, {verdict}")
        same = same and not diff
    print(f"{len(old)} functions in the old build, {len(new)} in the new; "
          + ("every function of the old build is equal in the new"
             if same else "they differ"))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
