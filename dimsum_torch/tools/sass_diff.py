"""Compare the SASS of two versions of one CUDA source, kernel by kernel:
what `nvcc -cubin` (the port's flags, sm_90a) makes of each, through
`cuobjdump -sass` and `cu++filt`.  A kernel of the old source is matched
to the new source's kernel of the same name and template arguments, or,
where there is none, to the one whose template arguments are the same
once the trailing `false` ones are left off both (compile-time switches
added, in their off position); its instructions, without addresses and
encodings, must be the same.

    python -m dimsum_torch.tools.sass_diff OLD.cu NEW.cu [--show N]

Prints one JSON line: the kernels compared, those with the same SASS,
those that differ or have no counterpart, and how many new kernels take
the switch on; with --show, also the first N lines of each differing
kernel's unified diff (`diffs`).  Needs the CUDA toolkit (the card's machine has it under
/usr/local/cuda/bin).
"""

from __future__ import annotations

import argparse
import difflib
import json
import os
import re
import subprocess
import sys
import tempfile
from typing import Dict, List

from dimsum_torch.ops.cuda_build import NVCC_FLAGS, _nvcc



def _tool(name: str) -> str:
    """A CUDA toolkit program beside nvcc."""
    return os.path.join(os.path.dirname(_nvcc()), name)


def _cubin_flags() -> List[str]:
    return [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                               "-fPIC", "-Xptxas", "-v")]


def kernel_sass(source: str) -> Dict[str, List[str]]:
    """{demangled kernel name without its parameter list: instructions}."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "k.cubin")
        subprocess.run([_nvcc(), *_cubin_flags(), "-cubin", "-o", out,
                        source], check=True)
        text = subprocess.run([_tool("cuobjdump"), "-sass",
                               out], check=True, capture_output=True,
                              text=True).stdout
    kernels, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            name = m.group(1)
            kernels[name] = []
        elif name and re.match(r"\s+/\*[0-9a-f]{4}\*/", line):
            kernels[name].append(re.sub(r"/\*[0-9a-f]+\*/", "", line)
                                 .split(";")[0].strip())
    names = subprocess.run([_tool("cu++filt")],
                           input="\n".join(kernels), capture_output=True,
                           text=True, check=True).stdout.splitlines()
    # the kernel's name and template arguments, without its parameters
    return {(plain[:plain.rindex(">") + 1] if ">" in plain
             else plain[:plain.rindex("(")]): code
            for plain, code in zip(names, kernels.values())}


_SWITCH = r", (?:{}|\(bool\){})>$"  # cu++filt writes false or (bool)0


def _switches_off(name: str) -> str:
    """The name without its trailing `false` template arguments."""
    off = _SWITCH.format("false", 0)
    while re.search(off, name):
        name = re.sub(off, ">", name)
    return name


def compare(old: str, new: str, show: int = 0) -> dict:
    before, after = kernel_sass(old), kernel_sass(new)
    # a new kernel with its trailing switches off stands for the old kernel
    off = {_switches_off(n): code for n, code in after.items()}
    same, differ, missing, diffs = [], [], [], {}
    for name, code in before.items():
        # the same name first; else the new kernel with its switches off
        code_new = after.get(name, off.get(_switches_off(name)))
        if code_new is None:
            missing.append(name)
        elif code_new == code:
            same.append(name)
        else:
            differ.append(name)
            if show:
                diffs[name] = list(difflib.unified_diff(
                    code, code_new, lineterm="", n=0))[:show]
    rec = {"old": old, "new": new, "old_kernels": len(before),
           "new_kernels": len(after), "same_sass": len(same),
           "differ": differ, "missing": missing,
           "switch_on": sum(bool(re.search(_SWITCH.format("true", 1), n))
                            for n in after)}
    return dict(rec, diffs=diffs) if show else rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("old")
    p.add_argument("new")
    p.add_argument("--show", type=int, default=0,
                   help="lines of each differing kernel's diff to print")
    args = p.parse_args(argv)
    rec = compare(args.old, args.new, args.show)
    print(json.dumps(rec))
    return 0 if not rec["differ"] and not rec["missing"] else 1


if __name__ == "__main__":
    sys.exit(main())
