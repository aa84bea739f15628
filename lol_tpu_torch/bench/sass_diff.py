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

`loop_mix` counts the instructions of a kernel's main loop by the pipe
that issues them on Hopper: what a build issues, to hold beside what the
function needs (`bench/roofline.PRNG_NEEDS` for the random draws):

    python -m lol_tpu_torch.bench.sass_diff --mix LIB prng_draw
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


# The Hopper pipe of each opcode (the mnemonic before its first dot) that
# `loop_mix` counts: "alu" the integer / logic / compare / select pipe (64
# lanes a clock an SM), "imad" the integer multiply-adds on the FMA pipe's
# heavy half (64), "fp32" the float adds, multiplies and FMAs on either half
# (128 with the IMADs), "xu" the transcendental and conversion unit (16).
# Every other instruction (memory, branches, uniform-datapath ops) counts
# toward issue alone.
PIPES = {
    "alu": ("IADD3", "LOP3", "SHF", "SHL", "SHR", "LEA", "ISETP", "FSETP", "SEL", "FSEL",
            "PRMT", "IMNMX", "FMNMX", "IABS", "PLOP3", "MOV", "VIADD", "FCHK", "IADD", "LOP",
            "FSET", "ISET"),
    "imad": ("IMAD", "IMUL", "IMADSP"),
    "fp32": ("FFMA", "FMUL", "FADD", "I2FP"),
    "xu": ("MUFU", "I2F", "F2I", "F2F", "F2IP", "FRND", "POPC", "FLO", "BREV"),
}
_PIPE_OF = {op: pipe for pipe, ops in PIPES.items() for op in ops}
_INSN = re.compile(r"/\*([0-9a-f]+)\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)([.A-Z0-9_]*)"
                   r"([^;]*);")


def functions(sass: str) -> dict[str, str]:
    """Kernel name (as `kernels` gives it) -> the raw SASS text of its body."""
    out: dict[str, str] = {}
    name = None
    for line in sass.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = _TU_HASH.sub(r"\1", head.group(1))
            out[name] = ""
        elif name is not None:
            out[name] += line + "\n"
    return out


def loop_mix(body: str) -> dict[str, int]:
    """Instructions of one kernel's main loop, by pipe (`PIPES`) and in
    all ("issue", NOPs left out): the loop is the span from a backward
    branch's target to the branch, the one that holds a 16-byte store
    (`STG.E.128`) if any does, else the longest."""
    insns, labels = [], {}
    for line in body.splitlines():
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if lab:
            labels[lab.group(1)] = len(insns)
        m = _INSN.search(line)
        if m:
            insns.append((int(m.group(1), 16), m.group(2), m.group(2) + m.group(3), m.group(4)))
    at = {addr: k for k, (addr, *_rest) in enumerate(insns)}
    loops = []
    for k, (_addr, op, full, args) in enumerate(insns):
        if op != "BRA":
            continue
        tgt = re.search(r"0x([0-9a-f]+)|(\.L_x_\d+)", args)
        j = (at.get(int(tgt.group(1), 16)) if tgt and tgt.group(1)
             else labels.get(tgt.group(2)) if tgt else None)
        if j is not None and j <= k:
            loops.append(insns[j:k + 1])
    if not loops:
        raise ValueError("loop_mix: no backward branch in the kernel")
    loop = max(loops, key=lambda ins: (any(f.startswith("STG.E.128") for _a, _o, f, _r in ins),
                                       len(ins)))
    mix = dict.fromkeys([*PIPES, "issue"], 0)
    for _addr, op, _full, _args in loop:
        if op == "NOP":
            continue
        mix["issue"] += 1
        if op in _PIPE_OF:
            mix[_PIPE_OF[op]] += 1
    return mix


def _dump(lib: str) -> str:
    return subprocess.run([CUOBJDUMP, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("old", nargs="?", help="the old build's library")
    ap.add_argument("new", nargs="?", help="the new build's library")
    ap.add_argument("--mix", nargs=2, metavar=("LIB", "NAME"),
                    help="print the main-loop pipe mix of each kernel of LIB whose name "
                         "holds NAME")
    args = ap.parse_args()
    if args.mix:
        lib, part = args.mix
        for name, body in functions(_dump(lib)).items():
            if part in name:
                print(name, loop_mix(body))
        return 0
    if not (args.old and args.new):
        ap.error("two libraries to compare, or --mix LIB NAME")
    rows = compare(kernels(_dump(args.old)), kernels(_dump(args.new)))
    for name, verdict in rows:
        print(f"{verdict:30} {name}")
    return int(any(v.startswith(("differs", "only in the old")) for _, v in rows))

if __name__ == "__main__":
    sys.exit(main())
