"""The JAX package's five demos on the port: `she_demo`, `khprf_demo`,
`tunnel_demo`, `homomprf_demo` and `serving_demo`, each the reference demo
of `examples/` with `lol_tpu_torch` in place of `lol_tpu` and JAX, the
same rings, primes, seeds and printed lines.

Run one as `python -m lol_tpu_torch.examples.she_demo` (on the card) or
with `--device cpu` (the plain versions of the kernels); `main(device=)`
does the same from Python.
"""

import argparse


def cli(main, doc: str) -> None:
    """Parse `--device` (the card by default) and run main on it."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    main(device=ap.parse_args().device)
