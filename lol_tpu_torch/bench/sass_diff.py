"""Compare the SASS of two builds of the kernel library, kernel by kernel.

`cuobjdump -sass` of each build's `liblol_kernels.so`, split at its
`Function :` headers.  A kernel's name carries a hash of its translation
unit, which changes with any edit to the file, so names are compared
without it.  Two builds of a kernel whose instructions and control words
are equal run the same code: an edit to shared device code (such as
`csrc/ntt_rounds.cuh`) that leaves a kernel's SASS as it was cannot have
changed its speed.

Run where the CUDA toolkit is (cuobjdump under /usr/local/cuda/bin):

    python -m lol_tpu_torch.bench.sass_diff OLD/liblol_kernels.so NEW/liblol_kernels.so

One line per kernel: "same", "differs" (with both instruction counts), or
the one build that has it.  Exit code 1 if an old kernel differs or went.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys

CUOBJDUMP = "/usr/local/cuda/bin/cuobjdump"
_TU_HASH = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_(\d+_\w+?_cu)_[0-9a-f]{8}")


def kernels(sass: str) -> dict[str, list[str]]:
    """Kernel name (translation-unit hash dropped) -> its SASS lines
    (instruction and control words, whitespace squeezed)."""
    out: dict[str, list[str]] = {}
    body = None
    for line in sass.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            body = out.setdefault(_TU_HASH.sub(r"\1", head.group(1)), [])
        elif body is not None and line.strip().startswith("/*"):
            body.append(" ".join(line.split()))
    return out


def compare(old: dict[str, list[str]], new: dict[str, list[str]]) -> list[tuple[str, str]]:
    """(kernel, verdict) for every kernel of either build, sorted by name."""
    rows = []
    for name in sorted(old.keys() | new.keys()):
        if name not in new:
            rows.append((name, "only in the old build"))
        elif name not in old:
            rows.append((name, "only in the new build"))
        elif old[name] == new[name]:
            rows.append((name, "same"))
        else:
            rows.append((name, f"differs ({len(old[name])} -> {len(new[name])} lines)"))
    return rows


def _dump(lib: str) -> str:
    return subprocess.run([CUOBJDUMP, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("old")
    ap.add_argument("new")
    args = ap.parse_args()
    rows = compare(kernels(_dump(args.old)), kernels(_dump(args.new)))
    for name, verdict in rows:
        print(f"{verdict:30} {name}")
    return int(any(v.startswith(("differs", "only in the old")) for _, v in rows))


if __name__ == "__main__":
    sys.exit(main())
