"""The port's entry points (`lol_tpu_torch.entry`) against the JAX tree's
`__graft_entry__.py`, and `prng.fold_in` against `jax.random.fold_in`.

`entry()`'s step on the CPU takes the same inputs as the JAX entry's
(the same keys, draws and plaintexts through the threefry twin) and gives
its output bit for bit; `dryrun_multichip(4, device="cpu")` runs every leg
of the reference's dry run on a mesh of "cpu" entries, the ring leg's
kernel route included (its plain versions here; the card runs the kernels
in `chip_smoke.phase_3m`)."""

import sys

import jax
import numpy as np
import pytest
import torch

from test_torch_examples import ROOT

sys.path.insert(0, str(ROOT))

import __graft_entry__ as graft  # noqa: E402
from lol_tpu_torch import entry, prng  # noqa: E402
from lol_tpu_torch.parallel import sharding as sh  # noqa: E402

torch.set_num_threads(2)

KEYS = [0, 1, 42, 2**31, 2**32 - 1]
DATA = [0, 1, 3, 5, 7, 10, 2**16, 2**31 - 1, 2**31, 2**32 - 1]


def test_fold_in_is_jax_fold_in():
    """Every (seed, data) pair, the u32 extremes included, and a key made
    by split and fold_in itself."""
    keys = [(prng.PRNGKey(s), jax.random.PRNGKey(s)) for s in KEYS]
    keys.append((prng.split(prng.PRNGKey(9), 3)[2], jax.random.split(jax.random.PRNGKey(9), 3)[2]))
    keys.append((prng.fold_in(prng.PRNGKey(10), 3), jax.random.fold_in(jax.random.PRNGKey(10), 3)))
    for tk, jk in keys:
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk).astype(np.int64))
        for d in DATA:
            got = prng.fold_in(tk, d)
            assert got.dtype == torch.int64 and got.shape == (2,)
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(jax.random.fold_in(jk, d)).astype(np.int64))


def test_entry_step_is_the_jax_entry_step():
    """The same inputs, and the same step output, bit for bit."""
    jfn, jargs = graft.entry()
    jout = jfn(*jargs)
    fn, args = entry.entry(device="cpu")
    assert fn.__class__.__name__ == "BGVStep" and all(a.device.type == "cpu" for a in args)
    for a, b in zip(args, jargs):
        np.testing.assert_array_equal(a.numpy().astype(np.int64), np.asarray(b).astype(np.int64))
    out = fn(*args)
    assert len(out) == 2
    for a, b in zip(out, jout):
        assert a.dtype == torch.int32 and a.shape == b.shape
        np.testing.assert_array_equal(a.numpy().astype(np.int64), np.asarray(b).astype(np.int64))


@pytest.mark.parametrize("n, shape", [(2, "{'rns': 2, 'data': 1}"), (4, "{'rns': 2, 'data': 2}"),
                                      (8, "{'rns': 2, 'data': 4}")])
def test_dryrun_multichip_runs_on_cpu_entries(capsys, n, shape):
    entry.dryrun_multichip(n, device="cpu")
    out = capsys.readouterr().out
    assert out.startswith(f"dryrun_multichip ok: mesh {shape}")
    assert f"ring-sharded NTT n=64 over {n}-device 'ring' axis (plain and kernel routes)" in out


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    """The card by default: with none, the dry run's mesh refuses and the
    entry's first tensor on the card raises; nothing moves to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.dryrun_multichip(4)
    with pytest.raises((RuntimeError, AssertionError)):
        entry.entry()
    assert sh.make_mesh({"ring": 2}, ["cpu"] * 2).devices[1] == torch.device("cpu")
