#!/usr/bin/env python3
"""Compare the SASS of each kernel in two builds of a CUDA source.

    python3 scripts/sass_diff.py OLD.so NEW.so [NAME_SUBSTRING ...]

Runs ``cuobjdump -sass`` (from ``$CUDA_HOME``, default ``/usr/local/cuda``)
on both shared libraries (e.g. a kernel built from an earlier copy of
``rwkv_tpu_torch/csrc`` and from the current one, both under ``_build/``)
and compares each function's instructions, addresses and encodings
dropped; the per-file tag of an anonymous namespace and bool / int
template arguments (``Lb0`` / ``Li0``) are made equal, so a kernel whose
template switch changed type still pairs up. Prints, per function (those
whose name holds one of the substrings, if given): identical, the count of
differing lines, or that it is in one build only. Needs the CUDA toolkit.
"""

import os
import re
import subprocess
import sys


def sass(path: str) -> dict:
    """{normalised function name: [instruction text, ...]} of a library."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    out = subprocess.run([tool, "-sass", path], capture_output=True, text=True, check=True).stdout
    funcs, cur = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+", "ANON", m.group(1))
            cur = funcs.setdefault(name.replace("Lb0", "Li0").replace("Lb1", "Li1"), [])
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if m and cur is not None:
            cur.append(" ".join(m.group(1).split()))
    return funcs


def main() -> int:
    if len(sys.argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    old, new = sass(sys.argv[1]), sass(sys.argv[2])
    subs = sys.argv[3:]
    for name in sorted(set(old) | set(new)):
        if subs and not any(sub in name for sub in subs):
            continue
        a, b = old.get(name), new.get(name)
        if a is None or b is None:
            print(f"{name}: only in {'new' if a is None else 'old'}")
            continue
        n = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
        print(f"{name}: {'identical' if n == 0 else f'{n} lines differ'} "
              f"({len(a)} / {len(b)} instructions)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
