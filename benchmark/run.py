"""Run one cell of the benchmark and print its result as one JSON line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (`setup_s`, from this file's first line to the first timed batch):
the program's kernels built or found built, the cell's inputs made on the
card from the seed, every shape warmed up.  Then the closed loop of
batches (`loop.py`) runs for --seconds.  With --trace 1 its first batches
run under torch.profiler (the device's activity and the CUDA runtime
calls) and the per-layer metrics are read from them in place of the
end-to-end ones.  Once the window has closed, a sample of
its answers drawn from the seed is checked against the plain reference
(`reference/`), after the peak memory is read and the program's state
freed.  The numbers compared, each beside its limit, are the last lines
of standard error and the last key of the result.

Without a card (or with fewer than the cell asks for) it prints nothing
on standard output and exits 3.  It exits 4, with no result, if JAX or
the JAX package was loaded by the time the window closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "lol_tpu")  # top-level module names, compared whole
LIMITS = {"words_wrong": 0, "answers_unchecked": 0}


def cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths.
    The program builds its CUDA library under lol_tpu_torch/_build/.
    Python's bytecode goes there too, also where the environment turns
    writing it off (PYTHONDONTWRITEBYTECODE) and site-packages holds
    none: compiling torch's modules from source again in every run cost
    about 2 s of set-up and much of its spread."""
    cache = ROOT / "benchmark" / ".cache"
    sys.pycache_prefix = str(cache / "pycache")
    sys.dont_write_bytecode = False
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ["USE_FLAX"] = "0"


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit, from nvidia-smi; "" where it fails."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def run(cell, seed: int, seconds: float, trace: bool, device, system: str = "program",
        t_start: float = T_START) -> dict:
    """One run of `cell` (`cells.Cell`) on `device`: the result's keys
    but `device`, and `checks`, the numbers compared with their limits.
    system: "program" (the port), or "control" (the reference in a lower
    precision, in the program's place)."""
    import torch

    from benchmark import loop, tracing

    mix = cell.mix
    t_kind = time.perf_counter()
    kind = cell.kind.Kind(cell.config, mix, seed, device, system=system)
    t_warm = time.perf_counter()
    # the warm-up keeps a larger sample than the window does, so that the
    # allocator holds every block the window's answers need before it opens
    sample = loop.Sample(seed, mix["checked_per_class"] + 2)
    keep = lambda k, a: sample.offer(kind.sample_class(k), k, a)  # noqa: E731
    loop.closed_loop(kind, device, mix["inflight"], keep, batches=mix["warmup"])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    print(f"run: set-up {setup_s:.3f} s: imports and context {t_kind - t_start:.3f}, inputs and "
          f"program {t_warm - t_kind:.3f}, warm-up {t_start + setup_s - t_warm:.3f}",
          file=sys.stderr)

    sample = loop.Sample(seed, mix["checked_per_class"])
    traced = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        # on the card the device's activity and the CUDA runtime calls only:
        # recording every host op as well slows the host's issue enough to
        # starve the card in a host-paced cell
        acts = [ProfilerActivity.CUDA if device.type == "cuda" else ProfilerActivity.CPU]
        n_tr = mix["traced_batches"]
        with profile(activities=acts) as prof:
            if device.type == "cuda":  # the profiler's first buffer, before the traced batches
                torch.cuda.synchronize(device)
            loop.closed_loop(kind, device, mix["inflight"], keep, batches=n_tr)
        traced = tracing.from_profiler(prof, n_tr, [w for k in range(n_tr) for w in kind.work(k)])
        del prof
        print(f"run: traced {n_tr} batches, {len(traced.kernels)} kernels: "
              f"{tracing.kernel_counts(traced)}", file=sys.stderr)
    gc0 = gc.get_stats()[2]["collections"]
    w = loop.closed_loop(kind, device, mix["inflight"], keep, seconds=seconds)
    w.setup_s = setup_s
    w.items = w.completed * kind.items_per_batch

    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    forbidden = loaded_forbidden()
    answers = sample.answers()
    kind.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    lat = sorted(w.latencies_ms)
    print(f"run: window {w.seconds:.3f} s, {w.completed} batches, latency median "
          f"{lat[len(lat) // 2]:.3f} ms, max {lat[-1]:.3f} ms, "
          f"{sum(x > 2 * lat[len(lat) // 2] for x in lat)} over twice the median; "
          f"{gc.get_stats()[2]['collections'] - gc0} full collections", file=sys.stderr)
    t_check = time.perf_counter()
    wrong = [kind.words_wrong(k, a) for k, a in answers]
    print(f"run: {len(answers)} answers checked in {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr)
    checks = {"words_wrong": sum(wrong), "answers_unchecked": 0 if answers else 1}

    out = {"correct": all(checks[k] <= LIMITS[k] for k in LIMITS),
           "attempted": w.issued, "failed": sum(1 for x in wrong if x), "metrics": {},
           "memory_peak_bytes": peak, "forbidden": forbidden,
           "checks": {k: {"value": v, "limit": LIMITS[k]} for k, v in checks.items()}}
    if trace:
        for name, (unit, mod) in cell.per_layer.items():
            v = mod.read(traced)
            if v is not None:
                out["metrics"][name] = {"value": v, "unit": unit}
        out["busy_s"] = traced.busy_us() * 1e-6
        out["window_s"] = traced.span_us() * 1e-6
        out["breakdown"] = tracing.breakdown(traced)
    else:
        for name, (unit, mod) in cell.e2e.items():
            out["metrics"][name] = {"value": mod.value(w), "unit": unit}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache_dirs()
    from benchmark import cells

    cell = cells.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"run: {args.workload} needs {cell.chips} CUDA device(s), found {have}",
              file=sys.stderr)
        return 3
    print(f"run: imports and CUDA check {time.perf_counter() - T_START:.3f} s", file=sys.stderr)
    device = torch.device("cuda", 0)
    res = run(cell, args.seed, args.seconds, bool(args.trace), device)
    print(f"run: {args.workload} seed {args.seed} on {card_line()}", file=sys.stderr)
    if res.pop("forbidden") or loaded_forbidden():
        print(f"run: modules of JAX or the JAX package loaded: {loaded_forbidden()}",
              file=sys.stderr)
        return 4
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": cell.chips,
           "memory_peak_bytes": res.pop("memory_peak_bytes")}
    for k in ("busy_s", "window_s"):
        if k in res:
            dev[k] = res.pop(k)
    checks = res.pop("checks")
    line = {**res, "device": dev, "checks": checks}
    for k, c in checks.items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
