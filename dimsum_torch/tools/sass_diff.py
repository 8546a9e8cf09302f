"""Compare the SASS of two versions of one CUDA source, kernel by kernel:
what `nvcc -cubin` (the port's flags, sm_90a) makes of each, through
`cuobjdump -sass` and `cu++filt`.  A kernel of the old source is matched
to the new source's kernel of the same name and template arguments, or,
where there is none, to one that carries one more trailing template
argument of `false` (a compile-time switch added, in its off position);
its instructions, without addresses and encodings, must be the same.

    python -m dimsum_torch.tools.sass_diff OLD.cu NEW.cu

Prints one JSON line: the kernels compared, those with the same SASS,
those that differ or have no counterpart, and how many new kernels take
the switch on.  Needs the CUDA toolkit (the card's machine has it under
/usr/local/cuda/bin).
"""

from __future__ import annotations

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


def compare(old: str, new: str) -> dict:
    before, after = kernel_sass(old), kernel_sass(new)
    # a new kernel with its trailing switch off stands for the old kernel
    off = {re.sub(_SWITCH.format("false", 0), ">", n): code
           for n, code in after.items()}
    same, differ, missing = [], [], []
    for name, code in before.items():
        # the same name first; else the new kernel with its switch off
        code_new = after.get(name, off.get(name))
        if code_new is None:
            missing.append(name)
        elif code_new == code:
            same.append(name)
        else:
            differ.append(name)
    return {"old": old, "new": new, "old_kernels": len(before),
            "new_kernels": len(after), "same_sass": len(same),
            "differ": differ, "missing": missing,
            "switch_on": sum(bool(re.search(_SWITCH.format("true", 1), n))
                             for n in after)}


def main(argv=None) -> int:
    old, new = (argv if argv is not None else sys.argv[1:])
    rec = compare(old, new)
    print(json.dumps(rec))
    return 0 if not rec["differ"] and not rec["missing"] else 1


if __name__ == "__main__":
    sys.exit(main())
