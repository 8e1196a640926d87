#!/usr/bin/env python3
"""Whether csrc/decode.cu's first form compiles to the same instructions
as another tree's, on a machine with the CUDA toolkit.

    python3 scripts/decode_first_form_sass.py --other DIR

DIR is another checkout of the repository (for example the parent
commit, unpacked with `git archive` into a git-ignored directory). Both
trees' csrc/decode.cu are compiled with the kernels' own nvcc flags
(`kernels.NVCC_FLAGS`, `-c`, side by side) into the git-ignored _build/,
and `cuobjdump -sass` lists each object's instructions. For every
instantiation of `decode_kernel` (the first form; its template arguments
MLP, LPK, PAD are matched by value, and a tree whose kernel takes a
fourth, GENERAL, gives its GENERAL = false ones) the script compares the
two instruction streams, addresses and encodings left out, and prints
per kernel the instruction counts and `identical`, `identical but for N
kernel parameters' offsets` (the operands `c[0x0][...]` masked: a
DecodeArgs of another size moves the parameters after it) or the first
line that differs. Exits 1 where a kernel differs otherwise or is
missing from either tree. Needs no card.
"""
from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

KERNEL = re.compile(r"decode_kernelI(Lb[01]E)(Li\d+E)(Lb[01]E)(Lb[01]E)?EE")
INSTRUCTION = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;")
PARAM = re.compile(r"c\[0x0\]\[0x[0-9a-f]+\]")


def sass(obj: Path) -> dict:
    """{(MLP, LPK, PAD) as mangled: [instruction, ...]} of obj's first
    form."""
    from vq_vae_transformer_arc_welding_tpu_torch import kernels
    cuobjdump = Path(kernels.nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(obj)], check=True,
                          capture_output=True, text=True).stdout
    out, current = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            m = KERNEL.search(line)
            first = m is not None and m.group(4) in (None, "Lb0E")
            current = (out.setdefault("".join(m.groups()[:3]), []) if first
                       else None)
        elif current is not None:
            m = INSTRUCTION.match(line)
            if m:
                current.append(m.group(1))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path, required=True)
    args = ap.parse_args()
    from vq_vae_transformer_arc_welding_tpu_torch import kernels
    kernels.BUILD_DIR.mkdir(exist_ok=True)
    trees = {"this": REPO, "other": args.other.resolve()}
    objs, procs = {}, []
    for name, tree in trees.items():
        objs[name] = kernels.BUILD_DIR / f"decode_sass_{name}.o"
        procs.append(subprocess.Popen(
            [kernels.nvcc(), *kernels.NVCC_FLAGS, "-c", "-o",
             str(objs[name]),
             str(tree / "vq_vae_transformer_arc_welding_tpu_torch" / "csrc"
                 / "decode.cu")]))
    if any(p.wait() != 0 for p in procs):
        print("nvcc failed", file=sys.stderr)
        return 1
    this, other = sass(objs["this"]), sass(objs["other"])
    same = bool(this) and this.keys() == other.keys()
    for key in sorted(this.keys() | other.keys()):
        a, b = this.get(key, []), other.get(key, [])
        masked = [PARAM.sub("c[0x0][param]", x) for x in a]
        first = next((i for i, (x, y) in enumerate(
            zip(masked, (PARAM.sub("c[0x0][param]", y) for y in b)))
            if x != y), None if len(a) == len(b) else min(len(a), len(b)))
        moved = [(x, y) for x, y in zip(a, b) if x != y]
        if first is None and a:
            pairs = sorted({(u, v) for x, y in moved for u, v in zip(
                PARAM.findall(x), PARAM.findall(y)) if u != v})
            verdict = "identical" if not moved else (
                f"identical but for {len(moved)} kernel parameters' "
                f"offsets (this, other: " + ", ".join(
                    f"{u[8:-1]} {v[8:-1]}" for u, v in pairs) + ")")
        else:
            at = first if first is not None else 0
            verdict = (f"differs at instruction {at}: this "
                       f"{a[at] if at < len(a) else '-'} | other "
                       f"{b[at] if at < len(b) else '-'}")
        same = same and verdict.startswith("identical")
        print(f"first form {key}: instructions this {len(a)}, other "
              f"{len(b)}, {verdict}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
