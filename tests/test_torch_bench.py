"""The port's measurement instruments (`lol_tpu_torch/bench`), where the CPU
can reach them.

The chain kernel's plain version must equal the JAX `_chain_kernel` run
through `pl.pallas_call` in interpret mode; the roofline's work counts are
pinned at two (n, B); the steptime legs run on the CPU at m = 64 and the
`step` leg gives the step's own output; its pt_round and HomomPRF inputs
run on the CPU at m = 16 and decrypt right, and its built-once HomomPRF
program equals the serving entry point.  Timing needs a card: every
measurement entry point refuses to run without one.
"""

import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from lol_tpu.bench import mxu_ntt as jmx
from lol_tpu_torch import numtheory as nt, prf, sampling, serving, she
from lol_tpu_torch.bench import mxu_ntt as mx, ntt_ab, roofline, sass_diff, steptime
from lol_tpu_torch.ops.cuda import build
from lol_tpu_torch.she_batched import BatchedBGV

torch.set_num_threads(2)


@pytest.mark.parametrize("iters", [0, 1, 7])
def test_chain_ref_matches_pallas_interpret(iters, rng):
    x = rng.integers(0, 1 << 32, (16, 128), dtype=np.uint64).astype(np.uint32)
    x[0, :4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    kern = partial(jmx._chain_kernel, iters=iters)
    want = pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.uint32), interpret=True,
    )(jnp.asarray(x))
    got = mx.chain(torch.from_numpy(x.view(np.int32)), iters)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))
    assert torch.equal(got, mx.chain_ref(torch.from_numpy(x.view(np.int32)), iters))


def test_chain_rejects_bad_arguments():
    with pytest.raises(ValueError, match="int32"):
        mx.chain(torch.zeros(4, dtype=torch.int64), 3)
    with pytest.raises(ValueError, match="iters"):
        mx.chain(torch.zeros(4, dtype=torch.int32), -1)


@pytest.mark.parametrize("n,B", [(4096, 1024), (16384, 1000), (65536, 8)])
def test_roofline_work_counts(n, B):
    """Route B: GS's butterflies and one Shoup multiply (5 ops) a word for
    its scale, at every n (no twist: it is a cost of a factoring)."""
    k = n.bit_length() - 1
    butterflies = k * n // 2 * B
    for op in ("ntt_fwd", "ntt_inv_gs"):
        assert roofline.work(op, n, B) == (9 * butterflies, 8 * n * B)
    assert roofline.work("ntt_inv_dit", n, B) == (9 * butterflies + 5 * n * B, 8 * n * B)
    assert roofline.work("ct_mul", n, B) == (38 * n * B, 28 * n * B)
    assert roofline.work("mul_mod", n, B) == (9 * n * B, 12 * n * B)
    assert roofline.work("add_mod", n, B) == (2 * n * B, 12 * n * B)
    assert set(roofline.OPS) == {"ntt_fwd", "ntt_inv_gs", "ntt_inv_dit", "ct_mul",
                                 "mul_mod", "add_mod"}
    with pytest.raises(ValueError):
        roofline.work("ntt_radix4", n, B)
    # one channel of the BGV step moves 448 MiB through ct_mul
    assert roofline.work("ct_mul", 16384, 1024)[1] == 448 * 2 ** 20


@pytest.mark.parametrize("D", [2, 4, 8])
def test_roofline_ring_work_and_bound(D):
    n, B = 16384, 1024
    tS = n // D
    assert roofline.work("a2a", n, B, D) == (0, 8 * n * B)
    for op in ("ntt_fwd_gather", "ntt_inv_scatter"):  # D blocks of length tS
        assert roofline.work(op, n, B, D) == (9 * D * (tS.bit_length() - 1) * tS // 2 * B,
                                              8 * n * B)
    ms, by = roofline.bound(*roofline.work("a2a", n, B, D))
    assert by == "bytes" and ms == pytest.approx(8 * n * B / 3.35e12 * 1e3)
    ms, by = roofline.bound(*roofline.work("ntt_fwd", n, B))
    assert by == "operations" and ms == pytest.approx(9 * 14 * n // 2 * B / 16.7e12 * 1e3,
                                                      rel=2e-3)


def test_sass_diff_compares_kernels_without_the_unit_hash():
    def dump(unit_hash, body):
        return (f"\t\tFunction : _ZN38_GLOBAL__N__{unit_hash}_6_ntt_cu_eb13b50512ntt_fwd_passE\n"
                f"        /*0000*/ {body} ; /* 0x00 */\n"
                "                 /* 0x01 */\n"
                f"\t\tFunction : _ZN38_GLOBAL__N__{unit_hash}_6_ntt_cu_eb13b5053oneE\n"
                "        /*0000*/ EXIT ; /* 0x02 */\n")
    old = sass_diff.kernels(dump("875e145e", "IMAD R1, R2, R3, RZ"))
    assert list(old) == ["_ZN386_ntt_cu12ntt_fwd_passE", "_ZN386_ntt_cu3oneE"]
    assert len(old["_ZN386_ntt_cu12ntt_fwd_passE"]) == 2
    same = sass_diff.kernels(dump("50e3053c", "IMAD R1, R2, R3, RZ"))
    assert dict(sass_diff.compare(old, same)) == dict.fromkeys(old, "same")
    moved = sass_diff.kernels(dump("50e3053c", "IMAD R1, R2, R4, RZ"))
    assert dict(sass_diff.compare(old, moved))["_ZN386_ntt_cu12ntt_fwd_passE"].startswith("differs")
    del moved["_ZN386_ntt_cu3oneE"]
    assert dict(sass_diff.compare(old, moved))["_ZN386_ntt_cu3oneE"] == "only in the old build"


def test_ptxas_report_reads_registers_stack_and_spills():
    log = ("nvcc -c -o remote_ntt.o remote_ntt.cu\n"
           "ptxas info    : 0 bytes gmem\n"
           "ptxas info    : Compiling entry function '_Z4ringILi12EEv8RingArgs' for 'sm_90a'\n"
           "ptxas info    : Function properties for _Z4ringILi12EEv8RingArgs\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 62 registers, used 1 barriers, 496 bytes cmem[0]\n"
           "ptxas info    : Compiling entry function '_Z5spillv' for 'sm_90a'\n"
           "ptxas info    : Function properties for _Z5spillv\n"
           "    40 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads\n"
           "ptxas info    : Used 255 registers, 384 bytes cmem[0]\n")
    assert build.ptxas_report(log) == {
        "_Z4ringILi12EEv8RingArgs": {"registers": 62, "stack": 0, "spill_stores": 0,
                                     "spill_loads": 0},
        "_Z5spillv": {"registers": 255, "stack": 40, "spill_stores": 8, "spill_loads": 12}}


def test_roofline_row_from_a_measured_time():
    n, B, ms = 16384, 1024, 0.25
    ops, nbytes = roofline.work("ct_mul", n, B)
    r = roofline.row("ct_mul", n, B, ms, peak_gops=1000.0, peak_gbps=3000.0)
    assert r["gops"] == pytest.approx(ops / (ms * 1e6))
    assert r["gbps"] == pytest.approx(nbytes / (ms * 1e6))
    assert r["ops_per_byte"] == pytest.approx(ops / nbytes)
    assert r["pct_ops"] == pytest.approx(100 * r["gops"] / 1000.0)
    assert r["pct_bw"] == pytest.approx(100 * r["gbps"] / 3000.0)
    assert "pct_ops" not in roofline.row("ntt_fwd", n, B, ms)


def test_measurements_refuse_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "path", list(sys.path))  # ntt_ab puts the tree first
    for fn in (lambda: roofline.run(n=64, batch=8), lambda: mx.u32_ceiling(1, 8, 8, 1),
               lambda: mx.ceiling_input(8, 8, 1), lambda: steptime.run(m=64, B=2),
               lambda: steptime._tunnel_inputs(64, 3, 2, 0),
               lambda: steptime.call_time(None, *[torch.zeros(1, 2, 3)] * 2, "", ""),
               lambda: steptime.galois_ab(None, {}, *[torch.zeros(1, 2, 3)] * 2),
               lambda: steptime.odd_axis(None, (), None),
               lambda: steptime.mesh_inputs(64, 3, 4, 0), lambda: steptime.ab({}),
               lambda: steptime.copies(None, ()),
               lambda: ntt_ab.run(str(Path(__file__).resolve().parents[1]), "this tree")):
        with pytest.raises(RuntimeError, match="CUDA device"):
            fn()
    for leg in ("--pt-round", "--homom-prf", "--general-m", "--tunnel-general", "--galois",
                "--mesh"):
        monkeypatch.setattr(sys, "argv", ["steptime", leg, "--m", "16", "--batch", "2"])
        with pytest.raises(RuntimeError, match="CUDA device"):
            steptime.main()


def test_steptime_serving_inputs_on_cpu():
    """pt_round and HomomPRF legs' inputs at m = 16 on the CPU: the
    rounding chain decrypts to round-half-up(v / 4) mod 2, and the
    built-once HomomPRF program equals batched_homom_prf_component and
    decrypts to coefficient 0 of the clear PRF of the one key."""
    run, bb_out, f_out, sk, vals, cts = steptime.pt_round_inputs(16, 8, 5, 1, "cpu")
    got = bb_out.build_decrypt(she.SK(bb_out.params, sk.s_ints, 2.0), f=f_out)(*run(*cts))
    assert got[0].tolist() == ((2 * vals * 2 + 8) // 16 % 2).tolist() and not got[1:].any()
    fam, hints, bb, sk_out, s, cts = steptime.homom_prf_inputs(16, 8, 3, 2, "cpu")
    assert len(hints.tunnels) == 3 and bb.params.qs == tuple(nt.ntt_primes(16, 30, 7))
    run, bb_out, f_out = steptime.homom_prf_run(fam, hints, bb, (1, 0), 0)
    out = run(*cts)
    ref_bb, ref_f, ref = serving.batched_homom_prf_component(fam, hints, bb, *cts, (1, 0), 0)
    assert bb_out.params == ref_bb.params and f_out == ref_f
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    got = bb_out.build_decrypt(she.SK(bb_out.params, sk_out.s_ints, 2.0), f=f_out)(*out)
    want = prf.prf_ints(fam, s[:, 0].numpy(), (1, 0), 2)[0][0]
    assert got.tolist() == [[want] * 3]


def test_steptime_galois_inputs_on_cpu():
    """The galois leg's inputs at m = 32 on the CPU: the hoisted module
    covers k = 3, 5, 9 and equals each separate rotation bit for bit."""
    many, singles, sk, cts = steptime.galois_inputs(32, 3, 4, 5, device="cpu")
    assert list(singles) == list(steptime.GALOIS_KS) and many.ks == steptime.GALOIS_KS
    outs = many(*cts)
    for k, fn in singles.items():
        assert all(torch.equal(a, b) for a, b in zip(outs[k], fn(*cts)))


def test_steptime_legs_on_cpu_and_step_leg_equals_the_step():
    m, B = 64, 5
    params = she.SHEParams(m=m, p=257, qs=tuple(nt.ntt_primes(m, 30, 3)), var=2.0)
    g = torch.Generator().manual_seed(7)
    bb = BatchedBGV(params, "cpu")
    step = bb.build_step(bb.gen_ks_quad_hint(she.gen_sk(params, g), g))
    cts = [sampling.uniform_residues(params.qs, (params.ctx.n, B), g) for _ in range(4)]
    legs = steptime.build_legs(step, *cts)
    assert list(legs) == [*steptime.PARTS, "step"]
    out = {name: fn() for name, fn in legs.items()}
    for got, want in zip(out["step"], step(*cts)):
        assert torch.equal(got, want)
    assert out["intt"].shape == (3, m // 2, B)
    assert len(out["digits"]) == 3 and out["digits"][0].shape == (3, m // 2, B)
    assert all(e.shape == (2, m // 2, B) for e in out["rescale"])
    qv = step.qv
    c0, c1, d0, d1 = (t.long() for t in cts)
    e0, e1 = c0 * d0 % qv, (c0 * d1 + c1 * d0) % qv
    for i, di in enumerate(out["digits"]):
        e0 = (e0 + di.long() * step.h0[i]) % qv
        e1 = (e1 + di.long() * step.h1[i]) % qv
    assert torch.equal(out["hadamard"][0], e0) and torch.equal(out["hadamard"][1], e1)


def test_steptime_summary():
    times = {"intt": [1.0, 1.2, 1.1], "digits": [4.0, 4.0, 4.0],
             "hadamard": [3.0, 3.0, 3.0], "rescale": [2.0, 2.0, 2.0],
             "step": [10.1, 10.1, 10.1]}
    out = steptime.summarize(times, 16384, 3, 1024, "a card")
    assert out["device"] == "a card"
    assert out["parts_sum_ms"] == pytest.approx(10.1)
    assert out["pct_of_parts"]["digits"] == pytest.approx(100 * 4.0 / 10.1)
    assert out["overlap_dividend_pct"] == pytest.approx(0.0, abs=1e-9)
    assert out["step_ops_per_sec"] == pytest.approx(1024 / 10.1e-3)
