"""Compare the SASS of the port's CUDA sources between two trees.

    python3 sass_diff.py OLD_CSRC NEW_CSRC stage.cu smag.cu ...
    python3 sass_diff.py --opcode HMMA OLD_CSRC NEW_CSRC conv.cu

(from the root of the repository, beside `chip_smoke.py`)

compiles each named source of both `csrc` directories to a cubin with
the flags of `ins_tpu_torch/_build.py` (`nvcc -cubin`, sm_90a), each
from the same scratch path so that the names nvcc gives a file's
anonymous namespace differ only in their hashes (replaced by ``#``),
disassembles it with `cuobjdump -sass` and compares every kernel
instruction by instruction (addresses and encodings stripped). Prints
one line per kernel: its instruction count in each tree and whether the
two are identical (a kernel renamed by a new template flag is matched by
its code), or that it is new; with ``--opcode OP``, also how many of each
new-tree kernel's instructions have an opcode starting with OP, and their
forms (e.g. ``HMMA.16816.F32.BF16``: the tensor cores). A source the
old tree lacks counts as empty there (all its kernels new). Exits 1 if a
kernel of the old tree changed or went.
It needs `nvcc` and `cuobjdump` (the CUDA toolkit), so it runs on the
machine with the card.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

from ins_tpu_torch._build import NVCC_FLAGS

_FUNC = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;")


def _nvcc():
    for cand in ("/usr/local/cuda/bin/nvcc", "nvcc"):
        try:
            subprocess.run([cand, "--version"], capture_output=True, check=True)
            return cand
        except (OSError, subprocess.CalledProcessError):
            continue
    raise RuntimeError("nvcc not found")


_HASH = re.compile(r"[0-9a-f]{8,}")


def sass(csrc: Path, name: str, work: Path) -> dict:
    """{kernel: [instruction, ...]} of ``csrc/name`` compiled to a cubin
    from the scratch copy ``work/csrc``."""
    nvcc = _nvcc()
    src = work / "csrc"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(csrc, src)
    cubin = work / "out.cubin"
    flags = [f for f in NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    subprocess.run([nvcc, *flags, "-cubin", "-I", str(src), "-o", str(cubin),
                    str(src / name)], check=True, capture_output=True, text=True)
    cuobjdump = str(Path(nvcc).parent / "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(cubin)], check=True, capture_output=True,
                          text=True).stdout
    kernels, cur = {}, None
    for line in text.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = kernels.setdefault(_HASH.sub("#", m.group(1)), [])
            continue
        m = _INSTR.search(line)
        if m and cur is not None:
            cur.append(m.group(1))
    return kernels


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    opcode = None
    if args[:1] == ["--opcode"] and len(args) > 1:
        opcode, args = args[1], args[2:]
    if len(args) < 3:
        print(__doc__)
        return 2
    old_dir, new_dir, names = Path(args[0]), Path(args[1]), args[2:]
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            # a source the old tree lacks: every kernel of it is new
            old = sass(old_dir, name, Path(tmp)) if (old_dir / name).exists() else {}
            new = sass(new_dir, name, Path(tmp))
            # a kernel that gained a template flag keeps its code under a
            # new name: match it by its instructions
            added = [t for t in new if t not in old]
            twins = {k: next((t for t in added if new[t] == old[k]), None)
                     for k in old if k not in new}
            for k in sorted(old):
                if k in new:
                    same = old[k] == new[k]
                    ok &= same
                    print(f"[sass] {name} {k}: {len(old[k])} -> {len(new[k])} instructions, "
                          + ("identical" if same else "CHANGED"))
                elif twins[k] is None:
                    ok = False
                    print(f"[sass] {name} {k}: {len(old[k])} instructions, gone")
                else:
                    print(f"[sass] {name} {k}: {len(old[k])} instructions, identical to "
                          f"{twins[k]}")
            for t in sorted(set(added) - set(twins.values())):
                print(f"[sass] {name} {t}: new, {len(new[t])} instructions")
            if opcode:
                for k in sorted(new):
                    ops = [i.split()[1] if i.startswith("@") else i.split()[0] for i in new[k]]
                    hits = [o for o in ops if o.startswith(opcode)]
                    print(f"[sass] {name} {k}: {len(hits)} {opcode} instructions "
                          f"({', '.join(sorted(set(hits))) or 'none'})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
