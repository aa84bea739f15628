"""The port's demos against the JAX package's: `examples/she_demo.py`,
`khprf_demo.py`, `tunnel_demo.py` and `homomprf_demo.py` each run as the
reference runs them (imported from `examples/`, `main()` on JAX's CPU
backend) and as the port's `lol_tpu_torch.examples.<name>.main(device=
"cpu")` (the kernels' plain versions); the captured standard output must
be equal line for line.  The same rings, primes, seeds and draws (the
port's threefry twin) make every printed integer, and so the printed noise
bits and percentages, the same.  `serving_demo` has its own two files
(tests/test_torch_serving_demo*.py), by its legs: whole, it alone takes
about as long as these four.
"""

import contextlib
import importlib
import importlib.util
import io
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

torch.set_num_threads(2)


def reference_demo(name: str):
    """The JAX package's demo module, imported from examples/."""
    spec = importlib.util.spec_from_file_location(f"_ref_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def stdout_of(fn, **kw) -> list[str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(**kw)
    return buf.getvalue().splitlines()


def assert_same_output(name: str) -> list[str]:
    want = stdout_of(reference_demo(name).main)
    got = stdout_of(importlib.import_module(f"lol_tpu_torch.examples.{name}").main, device="cpu")
    assert want, f"examples/{name}.py printed nothing"
    assert got == want
    return got


@pytest.mark.parametrize("name", ["she_demo", "khprf_demo", "tunnel_demo", "homomprf_demo"])
def test_port_demo_prints_what_the_reference_demo_prints(name):
    lines = assert_same_output(name)
    assert not any("MISMATCH" in s or "False" in s for s in lines), lines
