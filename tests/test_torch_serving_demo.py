"""The port's serving demo against the JAX package's, in two files by
its legs (the JAX demo alone takes ~80-120 s here): `examples/
serving_demo.py`'s `main()` is cut into its three runs of statements (the
pipelines and encoding switches, printing lines 1-5; the serving ops,
lines 6-8; the rounding, lines 9-10), each run in the reference module's
namespace on JAX's CPU backend, and the port's `serving_demo.LEGS` (what
its `main` runs, in order) on the CPU must print the same lines.  This
file takes the first and the last leg, `test_torch_serving_demo_ops.py`
the middle one and the check that the three cover the reference's main.
"""

import ast
import contextlib
import inspect
import io

import numpy as np
import torch

from test_torch_examples import ROOT, reference_demo

torch.set_num_threads(2)

# the first statement of each leg after the first in examples/serving_demo.py's main()
LEG_STARTS = ("m, p, B = 256, 257, 4", "import tempfile")


def reference_main() -> tuple[str, ast.FunctionDef]:
    src = (ROOT / "examples" / "serving_demo.py").read_text()
    return src, next(n for n in ast.parse(src).body
                     if isinstance(n, ast.FunctionDef) and n.name == "main")


def reference_legs() -> list[tuple[list[ast.stmt], list[ast.stmt]]]:
    """main()'s body cut before each of LEG_STARTS: each leg's (imports of
    main it borrows from another leg so that it runs alone, own statements)."""
    src, main = reference_main()
    segs = [ast.get_source_segment(src, s) for s in main.body]
    cuts = [0] + [segs.index(s) for s in LEG_STARTS] + [len(main.body)]
    imports = [s for s in main.body if isinstance(s, (ast.Import, ast.ImportFrom))]
    owns = [main.body[lo:hi] for lo, hi in zip(cuts, cuts[1:])]
    return [([s for s in imports if s not in own], own) for own in owns]


def _stdout(fn, *args) -> list[str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue().splitlines()


def assert_leg_matches(i: int) -> list[str]:
    """Leg i of the reference's main and of the port's print the same."""
    from lol_tpu_torch.examples import serving_demo

    ref = reference_demo("serving_demo")
    borrowed, own = reference_legs()[i]
    code = compile(ast.Module(body=borrowed + own, type_ignores=[]),
                   str(ROOT / "examples" / "serving_demo.py"), "exec")
    want = _stdout(exec, code, dict(vars(ref)))
    got = _stdout(serving_demo.LEGS[i], "cpu")
    assert want and got == want
    assert not any("FAIL" in s or "False" in s for s in got), got
    return got


def test_pipelines_and_encoding_switches_print_what_the_reference_prints():
    assert len(assert_leg_matches(0)) == 5


def test_rounding_prints_what_the_reference_prints():
    lines = assert_leg_matches(2)
    assert len(lines) == 2 and "np.int32(" in lines[-1]  # numpy scalars, as the reference's


def test_pipeline_keeps_the_reference_parameters():
    """pipeline(m, p, encoding, B=8) as the reference's, plus device; a
    call at another batch decrypts."""
    from lol_tpu_torch.examples import serving_demo

    ref = inspect.signature(reference_demo("serving_demo").pipeline).parameters
    port = inspect.signature(serving_demo.pipeline).parameters
    assert list(port)[:len(ref)] == list(ref)
    assert all(port[k].default == ref[k].default for k in ref)
    assert port["device"].default == "cuda"
    bb, sk, (c0, c1), m1 = serving_demo.pipeline(m=64, p=257, encoding="msd", B=3, device="cpu")
    assert c0.shape == (3, 32, 3) and c0.device.type == "cpu" and m1.shape == (32, 3)
    dec = bb.build_decrypt(sk, encoding="msd")
    np.testing.assert_array_equal(dec(c0, c1).numpy(), m1)
