"""Time versions of `csrc/modmat.cu` against each other on the card.

    python -m lol_tpu_torch.bench.modmat_variants OUTDIR [SRC ...] [--probes]

Each source (by default this tree's `csrc/modmat.cu`) is built alone by
nvcc into `OUTDIR/lib_v<i>_<stem>.so`, seconds where the whole library takes
about a minute, and must export `lol_modmat_s8` with this tree's C
signature.  At the route's shapes (the 17-axis of m = 34816, (G, a, b, N)
= (1024, 16, 16, 1024); `mxu_ntt`'s stage A, 64 x 64 shared over 65536
columns, and stage B, 64 stacked 64 x 64 over 1024, at n = 4096, P = 64,
B = 1024; the phi = 6 axis of m = 18432, (1024, 6, 6, 1024)) each build's
output is checked == `modmat_ref`; then every build is timed on the device
alone (`time_ms(device_only=True)`) in two rounds, in order and reversed,
beside a `copy_` and a `fill_` of the 17-axis input (the bytes the call
moves, and its writes alone).

`--probes` adds two builds of the first source that drop one stream and
so give wrong results by design (timed, not checked): `reads`, its
16-byte stores of Y behind a condition that never holds, and `writes`,
its 16-byte copies of X likewise (`probe`): what each stream costs with
the product and the fold in place.

Prints one JSON line, also written to OUTDIR/result.json: the card's name
and power limit, each build's ptxas report (registers, stack bytes,
spilled bytes per kernel instance) and main-loop mix
(`sass_diff.loop_mix`), its median times per shape and each shape's bound
(`roofline.modmat_work`).  Refuses to run without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from . import card_line, require_cuda, roofline, sass_diff, time_ms
from .. import numtheory as nt
from ..ops import general as gen, ntt
from ..ops.cuda import build, modmat as mm
from . import mxu_ntt as mx

# (name, pattern of the statement kept out, its guard): a runtime false
# condition, so the compiler keeps the rest as it is
PROBES = (("reads", r"__stwb\(", "if (p.q == 0) __stwb("),
          ("writes", r"cp_async16\(dst,", "if (p.q == 0) cp_async16(dst,"))


def probe(src: str, name: str) -> str:
    """src with the statement of probe `name` guarded out (every one of
    its occurrences; at least one must exist)."""
    pattern, guarded = {n: (p, g) for n, p, g in PROBES}[name]
    out, n = re.subn(pattern, guarded, src)
    if not n:
        raise ValueError(f"probe {name}: no {pattern!r} in the source")
    return out


def _build(out: Path, sources: dict[str, str]) -> dict[str, str]:
    """Compile each source alone, all at once; returns each build's log."""
    nvcc = build._nvcc()
    jobs = {}
    for name, text in sources.items():
        (out / f"{name}.cu").write_text(text)
        cmd = [nvcc, *build.NVCC_FLAGS, "-shared", "-o", str(out / f"lib_{name}.so"),
               str(out / f"{name}.cu")]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
    logs = {name: p.communicate()[0] for name, p in jobs.items()}
    for name, p in jobs.items():
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{logs[name]}")
    return logs


def shapes(dev, g) -> dict:
    """name -> (M, x (G, b, N) int32 on dev, q) at the route's shapes."""
    def residues(shape, q):
        return torch.randint(0, q, shape, generator=g, device=dev, dtype=torch.int32)

    q17 = nt.ntt_primes(34816, 30, 1)[0]
    pl = ntt.ntt_plan(4096, nt.ntt_primes(8192, 30, 1)[0])
    M_A, M_B = mx.stage_matrices(pl, 64)
    q6 = nt.ntt_primes(18432, 30, 1)[0]
    return {"axis17": (gen.general_plan(34816, q17).axes[1].M, residues((1024, 16, 1024), q17),
                       q17),
            "stage_a": (M_A, residues((1, 64, 65536), pl.q), pl.q),
            "stage_b": (M_B, residues((64, 64, 1024), pl.q), pl.q),
            "phi6": (gen.general_plan(18432, q6).axes[1].M, residues((1024, 6, 1024), q6), q6)}


def run(out_dir: str, sources: list[str], probes: bool = False) -> dict:
    dev = require_cuda()
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    texts = {f"v{i}_{Path(s).stem}": Path(s).read_text() for i, s in enumerate(sources)}
    first = next(iter(texts.values()))
    checked = list(texts)
    if probes:
        texts.update({name: probe(first, name) for name, _, _ in PROBES})
    logs = _build(out, texts)
    res = {"card": card_line(), "sources": dict(zip(texts, sources)), "ptxas": {}, "mix": {},
           "ms": {}}
    libs = {}
    for name in texts:
        lib = ctypes.CDLL(str(out / f"lib_{name}.so"))
        lib.lol_modmat_s8.argtypes = ([ctypes.c_void_p, ctypes.c_longlong]
                                      + [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2
                                      + [ctypes.c_int] * 3 + [ctypes.c_uint32, ctypes.c_void_p])
        lib.lol_modmat_s8.restype = ctypes.c_int
        libs[name] = lib
        res["ptxas"][name] = {k: [r.get("registers"), r.get("stack"), r.get("spill_stores")]
                              for k, r in build.ptxas_report(logs[name]).items()
                              if "modmat_s8" in k}
        sass = subprocess.run([sass_diff.CUOBJDUMP, "-sass", str(out / f"lib_{name}.so")],
                              capture_output=True, text=True, check=True).stdout
        res["mix"][name] = {k: sass_diff.loop_mix(body)
                            for k, body in sass_diff.functions(sass).items() if "modmat_s8" in k}

    def call(name, prep, x3, q):
        G, b, N = x3.shape
        y = torch.empty((G, prep.a, N), dtype=torch.int32, device=dev)
        err = libs[name].lol_modmat_s8(
            prep.frag.data_ptr(), 0 if prep.shared else prep.frag[0].numel(), x3.data_ptr(),
            y.data_ptr(), G, N, prep.a, b, prep.nl, q, torch.cuda.current_stream().cuda_stream)
        build.check(err, f"modmat_s8 variant {name}")
        return y

    cases = shapes(dev, torch.Generator(device=dev).manual_seed(5))
    preps = {k: mm.prepare(M, q, dev) for k, (M, _x, q) in cases.items()}
    for k, (M, x, q) in cases.items():
        want = mm.modmat_ref(M, x, q, 1)
        for name in checked:
            if not torch.equal(call(name, preps[k], x, q), want):
                raise AssertionError(f"variant {name} != modmat_ref at {k}")
    x17 = cases["axis17"][1]
    buf = torch.empty_like(x17)
    res["copy_axis17_ms"] = time_ms(lambda: buf.copy_(x17), 20, device_only=True)[0]
    res["fill_axis17_ms"] = time_ms(lambda: buf.fill_(7), 20, device_only=True)[0]
    times = {name: {k: [] for k in cases} for name in texts}
    for order in (list(texts), list(texts)[::-1]):
        for name in order:
            for k, (_M, x, q) in cases.items():
                times[name][k].append(time_ms(lambda: call(name, preps[k], x, q), 20,
                                              device_only=True)[0])
    res["ms"] = times
    res["bound_ms"] = {
        k: roofline.bound(*roofline.modmat_work(x.shape[0], preps[k].a, x.shape[1], x.shape[2], q,
                                                preps[k].shared), roofline.INT8_OPS_PER_S)[0]
        for k, (_M, x, q) in cases.items()}
    (out / "result.json").write_text(json.dumps(res))
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir", help="directory for the builds and result.json")
    ap.add_argument("sources", nargs="*", help="versions of csrc/modmat.cu (default: this tree's)")
    ap.add_argument("--probes", action="store_true",
                    help="also time the first source with its stores, then its copies, left out")
    args = ap.parse_args()
    sources = args.sources or [str(build.CSRC / "modmat.cu")]
    print(json.dumps(run(args.out_dir, sources, args.probes)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
