"""The serving demo's middle leg (the ext step, mod switch, linear key
switch and hoisted rotations: lines 6-8) against the JAX package's, and
the cut itself: the three legs of tests/test_torch_serving_demo.py cover
the reference's main() in order, and the port's main runs its LEGS."""

import ast
import inspect

import torch

from test_torch_serving_demo import assert_leg_matches, reference_legs, reference_main

torch.set_num_threads(2)


def test_serving_ops_print_what_the_reference_prints():
    assert len(assert_leg_matches(1)) == 3


def test_the_legs_cover_the_reference_main_in_order():
    """Leg by leg, the statements past the imports each leg borrows are
    main()'s body, whole and in order; the port's main runs LEGS in order."""
    from lol_tpu_torch.examples import serving_demo

    _src, main = reference_main()
    legs = reference_legs()
    assert len(legs) == len(serving_demo.LEGS) == 3
    assert [ast.dump(s) for _borrowed, own in legs for s in own] == \
        [ast.dump(s) for s in main.body]
    assert "for leg in LEGS" in inspect.getsource(serving_demo.main)
