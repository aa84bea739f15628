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
from lol_tpu_torch import prng
from lol_tpu_torch import numtheory as nt, prf, sampling, serving, she
from lol_tpu_torch.bench import modmat_variants, mxu_ntt as mx, ntt_ab, roofline, sass_diff
from lol_tpu_torch.bench import steptime
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


@pytest.mark.parametrize("nd,k,n", [(3, 3, 16384), (3, 3, 6144), (7, 2, 512)])
def test_roofline_ks_inner_work(nd, k, n):
    """The inner products: e0, e1 and nd digits in, e0 and e1 out, 4 B a
    word each; two modmuls and two modadds a word and digit.  At the
    step's width (3 digits, (3, 16384, 1024)) 28 B a word, 1,409,286,144 B,
    which bytes bound."""
    B = 1024
    ops, nbytes = roofline.ks_inner_work(nd, k, n, B)
    assert (ops, nbytes) == (22 * nd * k * n * B, 4 * (4 + nd) * k * n * B)
    ms, by = roofline.bound(ops, nbytes)
    assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    if (nd, k, n) == (3, 3, 16384):
        assert nbytes == 1_409_286_144 and round(ms, 3) == 0.421


@pytest.mark.parametrize("k,n", [(2, 16384), (2, 6144), (1, 6144)])
def test_roofline_rescale_out_work(k, n):
    """The rescale's epilogue: the component and the transforms in, the
    result out, 12 B a word; two modmuls and a modsub a word.  At the
    step's width ((2, 16384, 1024)) 402,653,184 B a component, which bytes
    bound at 0.120 ms."""
    B = 1024
    ops, nbytes = roofline.rescale_out_work(k, n, B)
    assert (ops, nbytes) == (20 * k * n * B, 12 * k * n * B)
    ms, by = roofline.bound(ops, nbytes)
    assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    if (k, n) == (2, 16384):
        assert nbytes == 402_653_184 and round(ms, 3) == 0.120


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


_SASS = """\t\tFunction : _ZN38_GLOBAL__N__875e145e_7_prng_cu_eb13b5059prng_drawILi0ELb0ELb0EEEvNS_8PrngArgsE
        /*0000*/                   MOV R1, c[0x0][0x28] ;            /* 0x00000a0000017a02 */
                                                                     /* 0x000fe40000000f00 */
        /*0010*/                   S2R R0, SR_TID.X ;                /* 0x0000000000007919 */
        /*0020*/                   IADD3 R2, R0, 0x1, RZ ;           /* 0x0000000100027810 */
        /*0030*/                   SHF.L.W.U32.HI R3, R2, 0xd, R2 ;  /* 0x0000000d02037819 */
        /*0040*/                   LOP3.LUT R3, R3, R2, RZ, 0x3c, !PT ;
        /*0050*/                   IMAD.IADD R2, R2, 0x1, R3 ;
        /*0060*/                   FFMA R4, R4, R5, R6 ;
        /*0070*/                   MUFU.RCP R7, R4 ;
        /*0080*/                   STG.E.128 desc[UR4][R8.64], R12 ;
        /*0090*/                   ISETP.GE.U32.AND P0, PT, R2, R9, PT ;
        /*00a0*/              @!P0 BRA 0x20 ;
        /*00b0*/                   EXIT ;
        /*00c0*/                   BRA 0xc0 ;
        /*00d0*/                   NOP ;
"""


def test_sass_loop_mix_counts_the_main_loop_by_pipe():
    """The loop is the backward branch's span (the one with the 16-byte
    store, not the trailing self-branch), each opcode on its pipe."""
    funcs = sass_diff.functions(_SASS)
    assert list(funcs) == ["_ZN387_prng_cu9prng_drawILi0ELb0ELb0EEEvNS_8PrngArgsE"]
    mix = sass_diff.loop_mix(next(iter(funcs.values())))
    assert mix == {"alu": 4, "imad": 1, "fp32": 1, "xu": 1, "issue": 9}
    labelled = "\n".join(["        /*0000*/ S2R R0, SR_TID.X ;", ".L_x_0:",
                          "        /*0010*/ LOP3.LUT R3, R3, R2, RZ, 0x3c, !PT ;",
                          "        /*0020*/ IMAD.WIDE.U32 R4, R3, R5, RZ ;",
                          "        /*0030*/ @P0 BRA `(.L_x_0) ;", "        /*0040*/ EXIT ;"])
    assert sass_diff.loop_mix(labelled) == {"alu": 1, "imad": 1, "fp32": 0, "xu": 0, "issue": 3}
    with pytest.raises(ValueError, match="no backward branch"):
        sass_diff.loop_mix("        /*0000*/ EXIT ;")


def test_sass_diff_mix_takes_a_library_and_a_name(monkeypatch, capsys):
    """`--mix LIB NAME` prints the loop mix of LIB's kernels whose name
    holds NAME; without it two libraries are compared, and one is refused."""
    monkeypatch.setattr(sass_diff, "_dump", lambda lib: _SASS)
    monkeypatch.setattr(sys, "argv", ["sass_diff", "--mix", "lib.so", "prng_draw"])
    assert sass_diff.main() == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1 and out[0].startswith("_ZN387_prng_cu9prng_draw") and "'issue': 9" in out[0]
    monkeypatch.setattr(sys, "argv", ["sass_diff", "--mix", "lib.so", "ntt_fwd"])
    assert sass_diff.main() == 0 and capsys.readouterr().out == ""
    monkeypatch.setattr(sys, "argv", ["sass_diff", "old.so", "new.so"])
    assert sass_diff.main() == 0
    monkeypatch.setattr(sys, "argv", ["sass_diff", "old.so"])
    with pytest.raises(SystemExit):
        sass_diff.main()


def test_modmat_variants_probes_guard_one_statement_each():
    """`modmat_variants.probe` on this tree's csrc/modmat.cu: `reads`
    guards the 16-byte store of Y and `writes` the 16-byte copy of X, each
    once, behind a condition that never holds, and changes nothing else;
    a source without the statement is refused."""
    src = (build.CSRC / "modmat.cu").read_text()
    for name, kept in (("reads", "__stwb("), ("writes", "cp_async16(dst,")):
        out = modmat_variants.probe(src, name)
        changed = [(a, b) for a, b in zip(src.splitlines(), out.splitlines()) if a != b]
        assert len(changed) == 1 and out.count("\n") == src.count("\n"), name
        before, after = changed[0]
        assert after == before.replace(kept, "if (p.q == 0) " + kept), name
    with pytest.raises(ValueError, match="writes"):
        modmat_variants.probe("int main() {}", "writes")


def test_roofline_prng_counts_by_pipe():
    """The draws' bound: what each body needs a word by pipe
    (`PRNG_NEEDS`: the hash's 41 ALU ops and 32 adds, Barrett's 2 IMAD, 1
    add and 1 ALU op, the normal's one side of each branch by its share),
    the adds balanced between the ALU and the FMA pipe, the busiest pipe
    or issue in 64-lane slots, 4 bytes a word."""
    needs = roofline.PRNG_NEEDS
    assert needs["prng_bits"] == {"alu": 41, "add": 32, "imad": 0, "fp32": 0, "xu": 0}
    assert needs["prng_randint"] == {"alu": 42, "add": 33, "imad": 2, "fp32": 0, "xu": 0}
    assert needs["prng_randint2"] == {"alu": 85, "add": 67, "imad": 7, "fp32": 0, "xu": 0}
    p = (2 ** 0.5 - 1) ** 0.5  # |u| below it: log1p's rational side
    normal = needs["prng_normal"]
    assert normal["alu"] == pytest.approx(44 + 5 * (1 - p))
    assert normal["add"] == pytest.approx(33 - p)
    assert normal["fp32"] == pytest.approx(35 + 3 * p + 4 * 0.0033747, rel=1e-6)
    assert normal["xu"] == pytest.approx(1 + p + 0.0033747, rel=1e-6)
    pipes = {op: roofline.prng_slots(need) for op, need in needs.items()}
    assert {op: pipe for op, (_, pipe) in pipes.items()} == {
        "prng_bits": "alu", "prng_randint": "alu", "prng_randint2": "alu", "prng_normal": "issue"}
    assert [pipes[op][0] for op in ("prng_bits", "prng_randint", "prng_randint2")] == [41, 42, 85]
    assert pipes["prng_normal"][0] == pytest.approx(58.365, abs=1e-3)
    slots = roofline.prng_slots
    # the adds go to the ALU as far as it stays the less busy of the two
    assert slots({"alu": 10, "add": 6, "imad": 30, "fp32": 0, "xu": 0}) == (30, "imad")
    assert slots({"alu": 40, "add": 10, "imad": 2, "fp32": 0, "xu": 0}) == (40, "alu")
    assert slots({"alu": 10, "add": 30, "imad": 2, "fp32": 0, "xu": 0})[0] == 21
    assert slots({"alu": 30, "add": 4, "imad": 4, "fp32": 30, "xu": 1}) == (34.5, "issue")
    assert slots({"alu": 3, "add": 0, "imad": 4, "fp32": 0, "xu": 5}) == (20, "xu")
    n, B = 16384, 1024
    for op, need in needs.items():
        assert roofline.work(op, n, B) == (slots(need)[0] * n * B, 4 * n * B)
        assert roofline.bound(*roofline.work(op, n, B))[1] == "operations"
    ms, _ = roofline.bound(*roofline.work("prng_randint", n, 3 * B))
    assert ms == pytest.approx(42 * 3 * n * B / (132 * 64 * 1.98e9) * 1e3)  # 0.1264 ms
    assert roofline.bound(*roofline.work("prng_normal", n, B))[0] == pytest.approx(0.05854, rel=1e-3)


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
               lambda: ntt_ab.run(str(Path(__file__).resolve().parents[1]), "this tree"),
               lambda: ntt_ab.run(str(Path(__file__).resolve().parents[1]), "this tree",
                                  modmat_only=True),
               lambda: modmat_variants.run("unused", [])):
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
    g = prng.KeyChain(7)
    bb = BatchedBGV(params, "cpu")
    step = bb.build_step(bb.gen_ks_quad_hint(she.gen_sk(params, g(), "cpu"), g()))
    cts = [sampling.uniform_residues(params.qs, (params.ctx.n, B), g(), "cpu") for _ in range(4)]
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
        e0 = (e0 + di.long() * step.hint_sh[0, i, ..., None].long()) % qv
        e1 = (e1 + di.long() * step.hint_sh[2, i, ..., None].long()) % qv
    assert all(h.dtype == torch.int32 for h in out["hadamard"])
    assert torch.equal(out["hadamard"][0].long(), e0)
    assert torch.equal(out["hadamard"][1].long(), e1)


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
