#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main path once on an NVIDIA GPU and check it.

Run from the root of a checkout, with no arguments, on a machine with one
CUDA card and nvcc:

    python3 chip_smoke.py

It builds the Hopper kernels from lol_tpu_torch/csrc (nvcc, first use),
then runs its phases and exits non-zero on the first failure:

1. the card's name and power limit (nvidia-smi), and the kernel build;
2. every kernel against its plain torch version on the card, bit-exact, at
   n in {256, 4096, 8192, 16384} with the largest 30-bit NTT primes and
   B in {1, 1000, 1024}: forward, forward with the digit prologue (source
   modulus above and below q, and q itself, which the tunnel passes as
   no prologue), the GS inverse, the route-B inverse
   (against its plain version and against the GS kernel), the
   forward->inverse round trip, and ct_mul with the extremal residues
   0, 1 and q - 1; then the NTT kernels on phase 4's n = 4096 inputs
   (B = 1024 and 16384, both primes), the u32 chain kernel at a
   ragged shape and on the u32 ceiling's own input and iterations, and
   the three ring kernels (the chunk all-to-all, the gather and the
   scatter pass) over D in {2, 4, 8}, n in {256, 4096, 16384, 65536}
   (D^2 | n), B in {1, 1000, 1024}, with 0, 1 and q - 1 planted; and the
   HomomPRF tower's tail, n in {1, 2, 4} (n = 1: the length-1 pass, one
   round of no stages): forward with and without the prologue, the GS
   inverse, and route B at n = 1 (x itself, by that pass); and the
   2-power axes of phase 3f's general rings (n2 = 1024 and 512, the
   plans `axis_plan` gives them)
   over B' = 6144 columns: forward with and without the prologue, GS;
3. the batched BGV slice at full width (m = 32768 so n = 2^14, three
   30-bit primes, p = 257, var = 2.0, B = 1024): keygen, encrypt, the
   ct-mult + key-switch + rescale step, decrypt, every draw from `prng`
   keys (the JAX package's threefry bits).  It checks the kernels'
   launch counts over that run (the NTT kernels, one per pass of
   `ntt_cm`'s schedule: one cluster pass per n = 2^14 transform; one
   ct_mul per channel; no route-B launch; two prng draws per encryption,
   its error's and its c1's), decrypts columns 0-7 against the exact
   plaintext product, and reruns the step on the CPU over columns 0-63,
   which must equal the card's output bit for bit;
3b. the ring-sharded NTT at full width: D = 4 shards on the mesh that
   make_mesh builds from the visible cards (on one card, four entries of
   it), the step's ring and three primes (n = 2^14) and n = 2^16 at one
   prime (phase B one pass over an 8-CTA cluster), B = 1024: forward, inverse and the round
   trip by both routes, equal to the single-card ntt_cm (itself checked
   against ntt_cm_ref) on the gathered array, with each route's launches
   counted exactly;
3c. the standalone builders, each GPU call between a reset and a read of
   the launch counts, which must equal its NTT calls times the passes of
   `cm_schedule` and its ct_mul calls: the MSD encrypt -> step -> decrypt
   at phase 3's ring (n = 2^14), then at m = 8192 (n = 4096, 3x30-bit,
   p = 257, B = 1024) the MSD step, the modulus switch (LSD and MSD), a
   linear key-switch hint made on the card and the key switch, add / sub
   at unequal scales, add_public and mul_public at (n, B) and (n, 1),
   to_lsd / to_msd and the noise budget; every output decrypted (columns
   0-7 against the plaintext: pt_mul, sums, the messages), the noise
   budget finite and below log2 Q, and every output equal to the CPU's
   over columns 0-63 (the float32 noise budget within 1e-4);
3d. the fused ring tunnel m = 32768 -> 16384 (E = S, ys = [1, 0], the
   reference bench's leg) at phase 3's chain, B = 1024: the hints made
   on the card, the tunnel's launches counted exactly (2 nrns GS
   inverses at n = 2^14, d nrns + d nrns^2 forwards at n = 8192), the
   decryption over S of columns 0-7 against the host `eval_lin`, and the
   output equal to the CPU's over columns 0-63;
3e. the serving layer and extended-modulus key switching, each GPU call
   between a reset and a read of the launch counts (per n, since the
   tower runs every n from 2^14 down to 1): (a) `bench.py`'s rounding
   chain Z_8 -> Z_2 at m = 32768 over pt_round_mults(8) + 2 = 5 primes,
   B = 1024 scalar plaintexts, hints from `she.pt_round_hints` on the
   card, columns 0-7 decrypted against round-half-up(v 2 / 8) mod 2 (the
   other coefficients zero) and the output equal to the CPU's over
   columns 0-63; (b) HomomPRF component 0 (`she_bench.homom_prf`'s shape):
   `prf.make_eval_hints` down the halving tower 32768 -> 2 (14 tunnels,
   E = S, the project maps) over 7 primes, p = 8, BaseBGad(2),
   balanced(2), bits (1, 0), one key s in all B = 1024 columns, through
   `serving.batched_homom_prf_component`: columns 0-7 against the clear
   `prf(fam, s, bits, 2)[0][0]`, the output equal to the CPU's over
   columns 0-15, the peak device memory printed; (c) at m = 8192 (n =
   4096, the three primes of phase 3c and two special primes), B = 1024:
   `build_step_ext` and `build_key_switch_linear_ext`, LSD and MSD, on
   hints made on the card, decrypted against `pt_mul` / the message under
   the new key, equal to the CPU's over columns 0-63, and their noise
   budget against the base-gadget builders' (printed, and it must be
   lower);
3f. general m and the Galois automorphisms, launches counted as in 3e
   (per n; a general-m transform is one `ntt_cm` over its 2-power axis):
   (a) `bench.py`'s config-3 step, m = 18432 = 2^11 3^2 (n = 6144), p = 7,
   3 primes, B = 1024, LSD and MSD, keys and the quad hint made on the
   card: columns 0-7 decrypted against the general-m `pt_mul`, the output
   equal to the CPU's over columns 0-15; (b) the tunnel 18432 -> 9216
   (E = S, ys = [1, 0]), hints from `gen_tunnel_hint`'s general branch:
   columns 0-7 against `eval_lin` (L and L^-1 mod p around it), GPU ==
   CPU over columns 0-15; (c) `bench.py`'s galois leg at phase 3's ring,
   k in {3, 5, 9}, hints from `gen_galois_hint`: `build_galois_many` ==
   `build_galois` over all columns, columns 0-7 against the host
   `she.galois_ints`, GPU == CPU over columns 0-15, and one rotation at
   m = 18432 (k = 5) held the same way;
3g. the mesh-aware builders over make_mesh({"rns": 3, "data": 4}) (the
   visible cards round-robin; on one card, twelve entries of it): the
   step LSD and MSD at phase 3's ring, the modulus switch, the linear and
   ext key switches and the ext step at n = 4096, the hoisted rotations
   k = 3, 5, 9, the tunnel 32768 -> 16384 over the mesh's data-only view,
   the general-m step LSD and MSD at m = 18432, the rounding chain and
   HomomPRF 32768 -> 2 with mesh= passed through, each on phases 3-3f's
   inputs: unsharded, equal to the unsharded builder's output over all
   B = 1024 columns, columns 0-7 decrypted against the same plaintexts,
   launches exactly Dd = 4 times the unsharded call's at each n; then the
   CRT-set slot maps: HomomPRF at p = 257 down 256 -> 128 with
   maps="slots" (the slot map solved on the host, its time printed),
   BaseBGad(16), balanced(2), B different keys, each of the 3
   components decrypted (columns 0-7) against the slot map applied to
   the clear s * A_T(x) and equal to the CPU's over columns 0-15,
   launches counted exactly;
3h. the object path (`she` over `cyc.Cyc`, one ciphertext, B = 1): (a)
   ring identities at m = 32768 and 18432 and their half rings (crt,
   crt_inv o crt, l, l_inv o l, mul_g and div_g o mul_g in the three
   bases, twace o embed in the powerful and CRT bases, the relative
   coefficients against pow_basis); (b) the README Quick start at m =
   8192 and she_demo's flow at phase 3's ring and key (encrypt x2,
   ct_add, ct_mul, the RNS quad hint and key switch, mod_switch, a
   BaseBGad(2^16) key switch, a TrivGad one over Q P with 4 special
   primes, an RNS ext one with 2, sigma_5, the MSD encryption and both
   encoding switches), each decryption against its plaintext; (c) the
   object path against the batched one on the earlier phases' inputs
   and hints: phase 3's step (columns 0-7), phase 3d's tunnel (columns
   0-7), phase 3f's general step (columns 0-7) and phase 3e's HomomPRF
   (column 0), bit for bit.  Each object call is checked as phase 3c's
   builders are: a shim records its `ntt_cm` / `ct_mul_cm` calls, and the
   card launches each call's passes and nothing else; a deterministic
   call runs on CPU copies first, where the card must make the same
   calls and give the same output bit for bit; closed forms hold the
   encryption, the hints, the step, decrypt and the tunnel;
3i. persistence, the challenges, the debug guards and two processes:
   (a) phase 3h's SK and ciphertexts (LSD, MSD), phase 3's step hint,
   phase 3c's ext hint, phase 3d's tunnel hint and phase 3e's rounding
   hints and EvalHints written to bytes (`io`) from the card and from
   CPU copies (the same bytes), read back onto the card, and the step,
   the ext step, the tunnel (columns 0-7) and homom_prf_component
   (column 0) on the reloaded hints == the originals' bit for bit, each
   bundle's size and write / read times printed; (b) the RLWE challenges
   at m = 32768 (disc, cont, rlwr q' = 257) and 18432 (disc), 8
   instances each: generate on the card == the same seed on the CPU byte
   for byte, suppress, verify OK, an error moved past its bound and a
   restored held-out secret each caught, and the CLI's three phases in
   subprocesses; (c) `ntt_cm_checked` == `ntt_cm` on the step's channel
   (forward, GS, route B) and route B at n = 2^16, a planted q and a
   planted 0x80000000 raising `ReductionError`; (d) two processes on the
   card over gloo (`parallel.multihost_check`): one mesh {"data": 2,
   "rns": 3} across them, the step at m = 32768 (512 columns a rank) and
   the ext step at m = 8192 == the unsharded columns, one all_reduce,
   launches counted per rank; every launch of (a)-(d) counted exactly;
3j. the randomness (`prng`, the kernel of `csrc/prng.cu`), card against
   the plain twin on the CPU bit for bit (`phase_3j`): (a) the kernel's
   erf_inv epilogue on all 2^23 inputs a normal can take, raw, as
   jax.random.normal and rounded at var 2, 4 and 9; (b) its threefry
   words for two keys and randint at (16384, 1024) through both of its
   instances (one hash over the three primes, two over three spans up
   to 2^16), every mode at ragged sizes, and the 64-bit-index instance
   on samples of a draw of 2^32 + 1029 words (counters whose high word
   is 1) and of randint over three channels of 2^29 + 3; (c) gen_sk at
   m = 32768 and 18432, build_encrypt LSD and MSD, gen_ks_quad_hint and
   gen_tunnel_hint 32768 -> 16384 at B = 1024 (the challenges' bytes are
   3i(b)'s); (d)
   the JAX package's known answers (`KNOWN`: words, splits, randint, a
   normal, and the digests of gen_sk(PRNGKey(0)) at m = 32768 and of a
   challenge directory) computed on the card; (e) the kernel's and its
   plain version's times at (16384, 1024) for each body beside its bound
   (what the body needs a word by pipe, `roofline.PRNG_NEEDS`; this
   build's SASS mix, `sass_diff.loop_mix`, printed beside it) and
   torch.randn's, and gen_sk, build_encrypt (B = 1024) and
   gen_ks_quad_hint at m = 32768 as their caller sees them;
4. timings with CUDA events (warm-up, then the median of 5 windows),
   each op timed once, on inputs checked kernel == plain (one channel of
   the step's is checked first); every kernel's time (`ms` in the
   `kernels` line and the roofline rows) on the device alone, the plain
   versions and the end-to-end metrics as their caller sees them: NTT/s
   at n = 4096 over 2x30-bit primes;
   the route-B against the GS inverse (its own path: its launches are
   counted over this A/B alone, pass by pass of `dit_schedule`), which
   also gives both inverses' times at one step channel (route B's
   cluster pass) and at n = 2^16 (its block and cross passes); the
   forward NTT and ct_mul kernels there, every plain version, and route
   B's single pass at n = 4096; the u32 ceiling (the chain kernel's
   path); a device copy's bandwidth; the roofline rows from those times
   against both; the steptime breakdown of the step, whose step leg
   gives the ops/s at n = 2^14; the ops/s at n = 4096; the ring-sharded
   transforms by route against ntt_cm at the same (n, B), on one card
   and, where phase 3b's mesh spans several cards, on that mesh too; the
   exchange's GB/s against the copy_'s, and the gather and scatter
   passes against the unfused phase-B (B') passes they replace, at
   n = 2^14 and 2^16; and, as their caller sees them, the modulus
   switch's and the linear key switch's ops/s at n = 4096 and the
   tunnel's at m = 32768 -> 16384 (B = 1024), and phase 3e's
   `pt_round_ops_per_sec`, `homom_prf_ops_per_sec` (its stages built once,
   as the reference bench does, and checked equal to the entry point's
   output first) and `step_ext_ops_per_sec` (LSD), with
   `step_ext_noise_bits_delta`; phase 3f's `bgv_general_m_ops_per_sec`
   and `tunnel_general_m_ops_per_sec`, and the rotations hoisted against
   separate in interleaved windows (`steptime.galois_ab`):
   `galois_hoisted_rot_per_sec`, `galois_separate_rot_per_sec`,
   `galois_hoisted_speedup`; phase 3g's `mesh_step_ops_per_sec` and
   `mesh_tunnel_ops_per_sec` beside the unsharded step's and tunnel's
   rates in the same interleaved windows (`steptime.mesh_ab`), with the
   mesh calls' layout copies timed on the device (`steptime.copies`);
   and phase 3h's object path at m = 32768 (`encrypt`, the step,
   `decrypt`, `tunnel`, `homom_prf_component`) beside the batched path's
   time per ciphertext in the same call; phase 3i's challenge generate
   and verify ms per instance at m = 32768 (disc, cont), the EvalHints
   write and read in MB/s, and the two-rank mesh step's ops/s beside the
   same layout's in one process; each printed on a `metric` line
   beside the card line.
   Phase 1 also fails if ptxas gave a ring or route-B kernel a stack
   frame or spills.

The last three lines of standard output are the card line, a JSON object
with one entry per TPU kernel ported (the CUDA kernel that replaces it,
its launches, error, times, and its bound: the least time the H100 could
take for the same work, `bench.roofline.bound`), and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
T0 = time.time()


def mark(msg: str) -> None:
    print(f"[chip_smoke {time.time() - T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def import_port() -> None:
    """Put this checkout's port first on the path, and check that it is
    the one imported."""
    sys.path.insert(0, ROOT)
    import lol_tpu_torch

    if os.path.dirname(os.path.dirname(os.path.abspath(lol_tpu_torch.__file__))) != ROOT:
        raise RuntimeError(f"lol_tpu_torch imported from {lol_tpu_torch.__file__}, not {ROOT}")


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return (a.long() - b.long()).abs().max().item()


def extremal(xs, q: int) -> None:
    """Every combination of 0, 1 and q - 1 across the operands xs, in
    their first 81 elements."""
    ext = torch.tensor([0, 1, q - 1], dtype=xs[0].dtype, device=xs[0].device)
    idx = torch.arange(81, device=xs[0].device)
    for j, x in enumerate(xs):
        x.view(-1)[:81] = ext[(idx // 3 ** j) % 3]

# Known answers from the JAX package (jax 0.9.0 on the CPU, its default
# threefry mode): split(PRNGKey(0), 3), bits(PRNGKey(42), (8,), uint32),
# randint(PRNGKey(7), (6,), 0, q, uint32) at the first 30-bit prime of
# m = 32768, normal(PRNGKey(9), (4,)) as float32 bit patterns, and SHA-256
# digests of gen_sk(SHEParams(m=32768, p=257, three 30-bit primes,
# var=2.0), PRNGKey(0)).s_ints as little-endian int64, and of the
# directory generate writes for CHALLENGES_3J with seed 4 (each file's
# relative path then its bytes, in sorted order).
KNOWN = {
    "split_0_3": [[1797259609, 2579123966], [928981903, 3453687069], [4146024105, 2718843009]],
    "bits_42_8": [2098992034, 2919706841, 2646866425, 2409546199, 1935504149, 2516274904,
                  321304473, 3329172656],
    "randint_7_6": (1073643521, [752389917, 327470435, 618516859, 748797932, 900059358,
                                 100004708]),
    "normal_9_4_bits": [3219058923, 1072450925, 3192856715, 3215102208],
    "gen_sk_m32768_key0_sha256": "366feed47945d16866cbf8c568c6d7609b17d6a28137c61067d13f3089263480",
    "challenges_m1024_seed4_sha256":
        "f053b09904b9f79ba1d47412b592e83282e3cfc4e3030ada5d90717f1d445d7c",
}
CHALLENGES_3J = [(0, 1024, 3, "disc", {}), (1, 1024, 2, "cont", {"beacon_epoch": 5}),
                 (2, 1024, 2, "rlwr", {"qprime": 257})]


def tree_digest(root) -> str:
    """SHA-256 over a directory's files: each relative path, then its bytes."""
    import hashlib
    from pathlib import Path

    h = hashlib.sha256()
    for f in sorted(Path(root).rglob("*")):
        if f.is_file():
            h.update(str(f.relative_to(root)).encode())
            h.update(f.read_bytes())
    return h.hexdigest()


def prng_mix(lib) -> dict:
    """Each draw body's main-loop instructions a word by pipe, from the
    SASS of this build's narrow instances (`sass_diff.loop_mix` over their
    4 words a thread), keyed as `roofline.PRNG_NEEDS`: what the build
    issues, printed beside what the bound counts."""
    from lol_tpu_torch.bench import sass_diff

    bodies = {0: "prng_bits", 1: "prng_randint", 2: "prng_randint2", 4: "prng_normal"}
    out = {}
    for name, body in sass_diff.functions(sass_diff._dump(str(lib))).items():
        inst = re.search(r"prng_drawILi(\d)ELb0ELb0E", name)
        if inst and int(inst.group(1)) in bodies:
            mix = sass_diff.loop_mix(body)
            out[bodies[int(inst.group(1))]] = {k: v / 4 for k, v in mix.items()}
    return out


def phase_3j(dev, m=32768, m_g=18432, B=1024, m_c=1024, every=1 << 23, time_it=True,
             wide=True) -> dict:
    """The randomness (`prng`, `csrc/prng.cu`) on the card, against the
    plain twin on the CPU, bit for bit: (a) the kernel's erf_inv epilogue
    on all 2^23 inputs, raw, as jax.random.normal, and rounded at var 2, 4
    and 9; (b) its threefry words for two keys, randint's one-hash
    instance over three 30-bit primes and its two-hash one over three
    spans up to 2^16 at (n, B), every mode at ragged sizes, and (wide) the
    64-bit-index instance on samples of the words of one draw of 2^32 +
    1029 elements (counters whose high word is 1) and of randint over
    three channels of 2^29 + 3; (c) gen_sk at m and m_g, build_encrypt LSD
    and MSD and gen_ks_quad_hint at m, B, and gen_tunnel_hint m -> m / 2,
    drawn on the card == drawn on the CPU; (d) the known answers of the
    JAX package (KNOWN), computed on the card; (e) the kernel's and its
    plain version's times at (n, B), each body's beside its bound (what it
    needs a word by pipe, `roofline.PRNG_NEEDS`) and torch.randn's, and keygen's and encryption's times at m.  Returns the
    kernel row's numbers and the timings."""
    import hashlib
    import tempfile

    from lol_tpu_torch import linear, numtheory as nt, prng, she
    from lol_tpu_torch.bench import roofline, time_ms
    from lol_tpu_torch.challenges import ChallengeParams, generate
    from lol_tpu_torch.ops.cuda import prng as pk
    from lol_tpu_torch.she_batched import BatchedBGV

    def same(name, a, b):
        a, b = a.cpu(), b.cpu()
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"phase 3j {name}: card != plain")

    out = {"checks": 0}
    # (a) every input of the normal: the words i << 9, i < 2^23
    words = (torch.arange(every, dtype=torch.int64) << 9).to(torch.int32)
    r = prng.gaussian_from_bits(words.long() & prng.MASK, pre=1.0)
    cases = [("float", 1.0, 1.0), ("float", prng.SQRT2, 1.0)] + [
        ("round", 1.0, prng.folded_scale(v)) for v in (2.0, 4.0, 9.0)]
    for mode, pre, scale in cases:
        want = (r * torch.tensor(pre, dtype=torch.float32)) * torch.tensor(scale, dtype=torch.float32)
        want = want if mode == "float" else torch.round(want).to(torch.int32)
        same(f"epilogue {mode} pre={pre} scale={scale}", pk.map_words(words.to(dev), mode, pre, scale),
             want)
        out["checks"] += 1
    del words, r
    # (b) the words and randint at (n, B), two keys; every mode at ragged sizes
    n = m // 2
    qs = tuple(nt.ntt_primes(m, 30, 3))
    for seed in (11, 12):
        key = prng.PRNGKey(seed)
        same(f"bits key {seed}", pk.draw([key], n * B, "bits", device=dev),
             pk.draw_ref([key], n * B, "bits"))
    keys3 = list(prng.split(prng.PRNGKey(13), 3))
    qs2 = (257, 12289, 65535)  # spans up to 2^16: randint's two-hash instance
    for qq in (qs, qs2):
        same(f"randint 3 x {qq}", pk.draw(keys3, n * B, "randint", qs=qq, device=dev),
             pk.draw_ref(keys3, n * B, "randint", qs=qq))
    for count in (1, 7, 1000, 4097, 1000003):
        kk = list(prng.split(prng.PRNGKey(count), 2))
        for mode, kw in (("bits", {}), ("randint", {"qs": [qs[0], 257]}),
                         ("randint", {"qs": [qs[0], qs[1]]}),
                         ("float", {"pre": prng.SQRT2}), ("round", {"scale": 1.5})):
            same(f"{mode} x {count}", pk.draw(kk, count, mode, device=dev, **kw),
                 pk.draw_ref(kk, count, mode, **kw))
    out["checks"] += 4 + 5 * 5
    if wide:  # the 64-bit-index instance: nchan * count >= 2^31
        torch.cuda.empty_cache()
        for kk, count, mode, kw in (([prng.PRNGKey(14)], (1 << 32) + 1029, "bits", {}),
                                    (keys3, (1 << 29) + 3, "randint", {"qs": qs})):
            got = pk.draw(kk, count, mode, device=dev, **kw)
            idx = torch.cat([torch.arange(0, 4099), torch.arange((1 << 31) - 4099, (1 << 31) + 4099),
                             torch.arange(count - 8197, count)])
            idx = idx[idx < count]
            same(f"{mode} 64-bit index, {len(kk)} x {count}", got[:, idx.to(dev)],
                 pk.draw_at_ref(kk, idx, mode, **kw))
            del got
            torch.cuda.empty_cache()
        out["checks"] += 2
    # (c) full width: the entry points drawn on the card == drawn on the CPU
    params = she.SHEParams(m=m, p=257, qs=qs, var=2.0)
    for prm in (params, she.SHEParams(m=m_g, p=7, qs=tuple(nt.ntt_primes(m_g, 30, 3)), var=2.0)):
        same(f"gen_sk m={prm.m}", she.gen_sk(prm, prng.PRNGKey(prm.m), dev).s_ints,
             she.gen_sk(prm, prng.PRNGKey(prm.m), "cpu").s_ints)
    sk = she.gen_sk(params, prng.PRNGKey(21), dev)
    bb, bb_cpu = BatchedBGV(params, dev), BatchedBGV(params, "cpu")
    msgs = she.pt_random(params, np.random.default_rng(22), (B,), "cpu")
    for enc_ in ("lsd", "msd"):
        key = prng.PRNGKey(23)
        for a, b in zip(bb.build_encrypt(sk, enc_)(msgs.to(dev), key),
                        bb_cpu.build_encrypt(sk, enc_)(msgs, key)):
            same(f"build_encrypt {enc_} m={m} B={B}", a, b)
    h, h_cpu = bb.gen_ks_quad_hint(sk, prng.PRNGKey(24)), bb_cpu.gen_ks_quad_hint(sk, prng.PRNGKey(24))
    same("gen_ks_quad_hint h0", h.h0, h_cpu.h0)
    same("gen_ks_quad_hint h1", h.h1, h_cpu.h1)
    ps = she.SHEParams(m=m // 2, p=257, qs=qs, var=2.0)
    ys = [np.eye(1, ps.ctx.n, dtype=np.int64)[0], np.zeros(ps.ctx.n, dtype=np.int64)]
    fmap = linear.linear_pow(ps.ctx, params.ctx, ps.ctx, ys)
    sk_s = she.gen_sk(ps, prng.PRNGKey(25), dev)
    th = bb.gen_tunnel_hint(fmap, sk_s, sk, prng.PRNGKey(26))
    th_cpu = bb_cpu.gen_tunnel_hint(fmap, sk_s, sk, prng.PRNGKey(26))
    for a, b in zip(th.hints, th_cpu.hints):
        same("gen_tunnel_hint h0", a.h0, b.h0)
        same("gen_tunnel_hint h1", a.h1, b.h1)
    out["checks"] += 2 + 4 + 2 + 4
    # (d) the JAX package's known answers, drawn on the card
    ok = [prng.split(prng.PRNGKey(0), 3).tolist() == KNOWN["split_0_3"],
          prng.random_bits(prng.PRNGKey(42), (8,), dev).cpu().tolist() == KNOWN["bits_42_8"],
          prng.randint(prng.PRNGKey(7), (6,), 0, KNOWN["randint_7_6"][0], dev).cpu().tolist()
          == KNOWN["randint_7_6"][1],
          (prng.normal(prng.PRNGKey(9), (4,), dev).cpu().view(torch.int32).long() & prng.MASK
           ).tolist() == KNOWN["normal_9_4_bits"]]
    s0 = she.gen_sk(params, prng.PRNGKey(0), dev).s_ints.numpy().astype("<i8")
    ok.append(hashlib.sha256(s0.tobytes()).hexdigest() == KNOWN["gen_sk_m32768_key0_sha256"])
    q_c = nt.ntt_primes(m_c, 30, 1)[0]
    os.makedirs(os.path.join(ROOT, "_scratch"), exist_ok=True)  # gitignored
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "_scratch")) as d:
        generate(d, [ChallengeParams(cid, m_c, q_c, 4.0, k, kind, **kw)
                     for cid, _, k, kind, kw in CHALLENGES_3J], seed=4, device=dev)
        ok.append(tree_digest(d) == KNOWN["challenges_m1024_seed4_sha256"])
    if m == 32768 and m_c == 1024 and not all(ok):
        raise AssertionError(f"phase 3j: known answers {ok}")
    out["known_answers"] = ok
    out["checks"] += len(ok)
    if not time_it:
        return out
    # (e) times at (n, B): the encryption's draws (its error, rounded; c1,
    # randint over three primes) and the bare words; each kernel call
    # checked == its plain version on the card first
    key = prng.PRNGKey(31)
    legs = {"round": ([key], "round", {"scale": prng.folded_scale(2.0)}, "prng_normal"),
            "randint": (keys3, "randint", {"qs": qs}, "prng_randint"),
            "bits": ([key], "bits", {}, "prng_bits"),
            "randint2": (keys3, "randint", {"qs": qs2}, "prng_randint2")}
    for leg, (kk, mode, kw, op) in legs.items():
        same(f"{leg} on the card", pk.draw(kk, n * B, mode, device=dev, **kw),
             pk.draw_ref(kk, n * B, mode, device=dev, **kw))
        out[f"{leg}_ms"] = time_ms(lambda: pk.draw(kk, n * B, mode, device=dev, **kw), 10,
                                   device_only=True)[0]
        out[f"{leg}_plain_ms"] = time_ms(lambda: pk.draw_ref(kk, n * B, mode, device=dev, **kw),
                                         2)[0]
        out[f"{leg}_bound"] = roofline.bound(*roofline.work(op, n, len(kk) * B))
        out[f"{leg}_pipe"] = roofline.prng_slots(roofline.PRNG_NEEDS[op])[1]
    out["randn_ms"] = time_ms(lambda: torch.randn((n, B), device=dev), 10, device_only=True)[0]
    out["randint_torch_ms"] = time_ms(lambda: torch.randint(0, qs[0], (3, n, B), device=dev,
                                                            dtype=torch.int32), 10,
                                      device_only=True)[0]

    def synced(fn):
        def call():
            fn()
            torch.cuda.synchronize()
        return call

    enc = bb.build_encrypt(sk)
    msgs_d = msgs.to(dev)
    for name, fn in (("gen_sk", lambda: she.gen_sk(params, key, dev)),
                     ("encrypt_B1024", lambda: enc(msgs_d, key)),
                     ("gen_ks_quad_hint", lambda: bb.gen_ks_quad_hint(sk, key))):
        out[f"{name}_ms_m{m}"] = time_ms(synced(fn), 5)[0]
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing was run",
              file=sys.stderr)
        return 2
    import_port()
    from collections import Counter
    from dataclasses import fields as dc_fields, replace as dc_replace

    from lol_tpu_torch import gadget, linear, numtheory as nt, prf, prng, ring as ring_mod
    from lol_tpu_torch import serving, she
    from lol_tpu_torch.cyc import Cyc, Rep
    from lol_tpu_torch.bench import mxu_ntt as mx, ntt_ab, roofline, steptime, time_ms
    from lol_tpu_torch.ops import general as gen, ntt
    from lol_tpu_torch.ops.cuda import build, ntt_kernel as tk, pointwise as pw, prng as pk
    from lol_tpu_torch.ops.cuda import remote_ntt as rn
    from lol_tpu_torch.parallel import sharding as sh
    from lol_tpu_torch.ring import ring_context
    from lol_tpu_torch.she_batched import BatchedBGV

    counters = (tk.LAUNCHES, pw.LAUNCHES, mx.LAUNCHES, rn.LAUNCHES)

    def reset_counts():
        for c in counters:
            for k in c:
                c[k] = 0

    def counts():
        return {k: v for c in counters for k, v in c.items()}

    dev = torch.device("cuda")
    if "jax" in sys.modules or any(k.startswith("lol_tpu.") for k in sys.modules):
        raise RuntimeError("the port imported jax or the JAX package")

    # -- phase 1: card and build ----------------------------------------
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t = time.time()
    lib = build.build()
    mark(f"kernels built in {time.time() - t:.1f}s: {lib}")
    ptxas = build.ptxas_report((lib.parent / "build.log").read_text())
    for name, r in sorted(ptxas.items()):
        print(f"ptxas: {r.get('registers')} registers, {r.get('stack')} B stack, "
              f"{r.get('spill_stores')}/{r.get('spill_loads')} B spilled: {name}", flush=True)
    spills = [k for k, r in ptxas.items() if any(name in k for name in (
        "ntt_fwd_gather_pass", "ntt_inv_scatter_pass", "ntt_invb_pass")) and (
        r.get("stack") or r.get("spill_stores") or r.get("spill_loads"))]
    if spills:
        raise AssertionError(f"ring or route-B kernels with a stack frame or spills: {spills}")

    # -- phase 2: kernel vs plain, bit-exact ----------------------------
    g = torch.Generator(device=dev).manual_seed(SEED)
    err = {"ntt_fwd": 0, "ntt_inv": 0, "ntt_invb": 0, "ct_mul": 0, "chain": 0,
           "a2a": 0, "ntt_fwd_gather": 0, "ntt_inv_scatter": 0}
    checks = 0

    def check_ntt(x, plan):
        """The forward, GS and route-B inverse kernels on x against their
        plain versions, and route B against the GS kernel; folds the
        errors into err.  Four checks."""
        got = tk.ntt_cm(x, plan)
        err["ntt_fwd"] = max(err["ntt_fwd"], max_err(got, tk.ntt_cm_ref(x, plan)))
        gs = tk.ntt_cm(x, plan, inverse=True)
        err["ntt_inv"] = max(err["ntt_inv"], max_err(gs, tk.ntt_cm_ref(x, plan, inverse=True)))
        got = tk.ntt_cm(x, plan, inverse=True, alg="dit")
        err["ntt_invb"] = max(err["ntt_invb"], max_err(got, gs), max_err(
            got, tk.ntt_cm_ref(x, plan, inverse=True, alg="dit")))
        return 4

    def words(shape, hi, plant):
        """int32 tensor of u32 words uniform in [0, hi), `plant` first."""
        x = torch.randint(0, hi, shape, generator=g, device=dev, dtype=torch.int64)
        x.view(-1)[:len(plant)] = torch.tensor(plant, device=dev)
        return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)

    def check_ring_kernels(plan, D, B):
        """The three ring kernels against their plain versions on D shards
        of (n/D, B): the exchange on raw words, the gather pass on phase
        A's lazy words (below 4q), the scatter pass on residues (its lazy
        words range-checked and compared after one fold); folds the errors
        into err.  Three checks."""
        q, tS = plan.q, plan.n // D
        ext = [0, 1, q - 1]
        xs = [words((tS, B), 1 << 32, ext) for _ in range(D)]
        for a, b in zip(rn.a2a_chunks(xs), rn.a2a_chunks_ref(xs)):
            err["a2a"] = max(err["a2a"], max_err(a, b))
        xs = [words((tS, B), 4 * q, ext + [4 * q - 1]) for _ in range(D)]
        for a, b in zip(rn.ntt_fwd_gather(xs, plan), rn.ntt_fwd_gather_ref(xs, plan)):
            err["ntt_fwd_gather"] = max(err["ntt_fwd_gather"], max_err(a, b))
        xs = [words((tS, B), q, ext) for _ in range(D)]
        for a, b in zip(rn.ntt_inv_scatter(xs, plan), rn.ntt_inv_scatter_ref(xs, plan)):
            if bool((a < 0).any()) or bool((a >= 2 * q).any()):
                raise AssertionError(f"ntt_inv_scatter wrote words outside [0, 2q) at "
                                     f"n={plan.n}, D={D}, B={B}")
            err["ntt_inv_scatter"] = max(err["ntt_inv_scatter"], max_err(a % q, b))
        return 3

    for n in (256, 4096, 8192, 16384):  # 8192: the tunnel's target ring (4-CTA cluster)
        q_src, q = nt.ntt_primes(2 * n, 30, 2)  # the largest two
        plan = ntt.ntt_plan(n, q)
        for B in (1, 1000, 1024):  # B = 1: the public plaintexts' transforms
            x = torch.randint(0, q, (n, B), generator=g, device=dev, dtype=torch.int32)
            x[0] = q - 1  # extremal residues stress the lazy [0, 4q) range
            checks += check_ntt(x, plan)
            # source modulus above and below q, and q itself (the tunnel's
            # digit j into channel j: no prologue)
            for src in (q_src, 12289, q):
                xs = torch.randint(0, src, (n, B), generator=g, device=dev,
                                   dtype=torch.int32)
                xs[0] = src - 1
                xs[1] = (src + 1) // 2
                got = tk.ntt_cm(xs, plan, pre_digit_q=src)
                want = tk.ntt_cm_ref(xs, plan, pre_digit_q=src)
                err["ntt_fwd"] = max(err["ntt_fwd"], max_err(got, want))
                checks += 1
            back = tk.ntt_cm(tk.ntt_cm(x, plan), plan, inverse=True)
            if not torch.equal(back, x):
                raise AssertionError(f"round trip failed at n={n}, B={B}")
            for qc in (q_src, q):
                ops = [torch.randint(0, qc, (n, B), generator=g, device=dev,
                                     dtype=torch.int32) for _ in range(4)]
                extremal(ops, qc)
                for a, b in zip(pw.ct_mul_cm(*ops, qc), pw.ct_mul_cm_ref(*ops, qc)):
                    err["ct_mul"] = max(err["ct_mul"], max_err(a, b))
                checks += 1
    # phase 4's inputs at n = 4096 over 2x30-bit primes, checked at their
    # own shapes: B = 16384 (NTT/s and the route-B A/B) and B = 1024
    n4 = 4096
    plans4 = [ntt.ntt_plan(n4, q) for q in nt.ntt_primes(2 * n4, 30, 2)]
    x4 = {B4: [torch.randint(0, pl.q, (n4, B4), generator=g, device=dev,
                             dtype=torch.int32) for pl in plans4] for B4 in (1024, 16384)}
    for xs in x4.values():
        for v, pl in zip(xs, plans4):
            checks += check_ntt(v, pl)
    # the chain kernel on a ragged shape, and on the u32 ceiling's own run
    # (its input and iterations); the plain run there is timed too
    xc = torch.randint(-(1 << 31), 1 << 31, (1000, 1000), generator=g, device=dev,
                       dtype=torch.int32)
    err["chain"] = max_err(mx.chain(xc, 64), mx.chain_ref(xc, 64))
    xc = mx.ceiling_input()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    want = mx.chain_ref(xc, mx.ITERS)
    ev[1].record()
    ev[1].synchronize()
    chain_plain_ms = ev[0].elapsed_time(ev[1])
    err["chain"] = max(err["chain"], max_err(mx.chain(xc, mx.ITERS), want))
    checks += 2
    del xc, want
    for n in (256, 4096, 16384, 65536):
        plan = ntt.ntt_plan(n, nt.ntt_primes(2 * n, 30, 1)[0])
        for D in (2, 4, 8):
            for B in (1, 1000, 1024):
                checks += check_ring_kernels(plan, D, B)
    # the HomomPRF tower's tail rings m = 8, 4, 2 (n = 1: the length-1 pass)
    for n_t in (1, 2, 4):
        q_src, q = nt.ntt_primes(2 * n_t, 30, 2)
        plan = ntt.ntt_plan(n_t, q)
        for B_t in (1, 1000, 1024):
            x = torch.randint(0, q, (n_t, B_t), generator=g, device=dev, dtype=torch.int32)
            x.view(-1)[:3] = torch.tensor([q - 1, 0, 1], device=dev)[:B_t * n_t]
            err["ntt_fwd"] = max(err["ntt_fwd"], max_err(tk.ntt_cm(x, plan), tk.ntt_cm_ref(x, plan)))
            err["ntt_inv"] = max(err["ntt_inv"], max_err(tk.ntt_cm(x, plan, inverse=True),
                                                         tk.ntt_cm_ref(x, plan, inverse=True)))
            for src in (q_src, 12289, q):
                xs = torch.randint(0, src, (n_t, B_t), generator=g, device=dev, dtype=torch.int32)
                xs.view(-1)[:2] = torch.tensor([src - 1, (src + 1) // 2], device=dev)[:xs.numel()]
                err["ntt_fwd"] = max(err["ntt_fwd"], max_err(
                    tk.ntt_cm(xs, plan, pre_digit_q=src), tk.ntt_cm_ref(xs, plan, pre_digit_q=src)))
            if not torch.equal(tk.ntt_cm(tk.ntt_cm(x, plan), plan, inverse=True), x):
                raise AssertionError(f"round trip failed at n={n_t}, B={B_t}")
            checks += 6
            if n_t == 1:  # route B at n = 1: x itself, by the length-1 pass (one launch)
                before = dict(tk.LAUNCHES)
                got = tk.ntt_cm(x, plan, inverse=True, alg="dit")
                ran = {k: tk.LAUNCHES[k] - before[k] for k in before}
                if (not torch.equal(got, x) or ran != dict.fromkeys(before, 0) | {"ntt_inv": 1}
                        or not torch.equal(got, tk.ntt_cm_ref(x, plan, inverse=True, alg="dit"))):
                    raise AssertionError(f"route B at n = 1, B = {B_t}: {ran}, == x "
                                         f"{torch.equal(got, x)}")
                checks += 1
    # the 2-power axes of phase 3f's general rings, m = 18432 and 9216
    # (n2 = 1024, 512, the plans `axis_plan` gives them), over B' = 6 * 1024
    # columns: forward with and without the prologue, and the GS inverse
    for m_g in (18432, 9216):
        q_g = nt.ntt_primes(18432, 30, 3)[0]
        pl_g = gen.general_plan(m_g, q_g).axes[0].ntt2
        x = torch.randint(0, q_g, (pl_g.n, 6 * 1024), generator=g, device=dev,
                          dtype=torch.int32)
        x.view(-1)[:3] = torch.tensor([0, 1, q_g - 1], device=dev)
        err["ntt_fwd"] = max(err["ntt_fwd"], max_err(tk.ntt_cm(x, pl_g), tk.ntt_cm_ref(x, pl_g)))
        err["ntt_inv"] = max(err["ntt_inv"], max_err(tk.ntt_cm(x, pl_g, inverse=True),
                                                     tk.ntt_cm_ref(x, pl_g, inverse=True)))
        xs = torch.randint(0, 12289, x.shape, generator=g, device=dev, dtype=torch.int32)
        err["ntt_fwd"] = max(err["ntt_fwd"], max_err(tk.ntt_cm(xs, pl_g, pre_digit_q=12289),
                                                     tk.ntt_cm_ref(xs, pl_g, pre_digit_q=12289)))
        checks += 3
    torch.cuda.synchronize()
    if any(err.values()):
        raise AssertionError(f"kernel != plain: max abs err {err}")
    mark(f"phase 2: {checks} kernel-vs-plain checks bit-exact")

    # -- phase 3: the slice at full width -------------------------------
    m, B, p = 32768, 1024, 257
    params = she.SHEParams(m=m, p=p, qs=tuple(nt.ntt_primes(m, 30, 3)), var=2.0)
    n, nrns = params.ctx.n, len(params.qs)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)  # input data that no key draws
    nk, rng = prng.KeyChain(SEED + 1), np.random.default_rng(SEED + 1)
    sk = she.gen_sk(params, nk())
    bb = BatchedBGV(params, dev)
    hint = bb.gen_ks_quad_hint(sk, nk())
    enc = bb.build_encrypt(sk)
    step = bb.build_step(hint)
    p2 = she.SHEParams(m=m, p=p, qs=params.qs[:-1], var=params.var)
    dec = BatchedBGV(p2, dev).build_decrypt(she.SK(p2, sk.s_ints, sk.var),
                                            f=bb.step_f())
    m1 = she.pt_random(params, rng, (B,))
    m2 = she.pt_random(params, rng, (B,))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    pk.LAUNCHES["prng"] = 0
    c0, c1 = enc(m1, nk())
    d0, d1 = enc(m2, nk())
    before_step = counts()
    e0, e1 = step(c0, c1, d0, d1)
    after_step = counts()
    got = dec(e0, e1)
    torch.cuda.synchronize()
    launches = counts()
    prng_launches = pk.LAUNCHES["prng"]  # each encryption: its error's and its c1's draw
    if prng_launches != 4:
        raise AssertionError(f"prng: {prng_launches} launches on the path, want 4")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    passes = len(tk.cm_schedule(n))
    step_calls = {"ntt_fwd": nrns * (nrns - 1) + 2 * (nrns - 1), "ntt_inv": nrns + 2}
    want_step = {k: v * passes for k, v in step_calls.items()}
    want_step.update(dict.fromkeys(rn.LAUNCHES, 0), ntt_invb_block=0, ntt_invb_cross=0,
                     ct_mul=nrns, chain=0)
    want_path = dict(want_step, ntt_fwd=want_step["ntt_fwd"] + 2 * nrns * passes,
                     ntt_inv=want_step["ntt_inv"] + (nrns - 1) * passes)
    for k in launches:
        in_step = after_step[k] - before_step[k]
        if in_step != want_step[k] or launches[k] != want_path[k]:
            raise AssertionError(f"{k}: {in_step} launches in the step, {launches[k]} "
                                 f"on the path; want {want_step[k]}, {want_path[k]}")
    in_bytes = sum(t.numel() * t.element_size() for t in (c0, c1, d0, d1))
    mark(f"phase 3: step ran; launches {launches}, prng {prng_launches}; inputs "
         f"{in_bytes / 1e6:.0f} MB; "
         f"peak {peak_gib:.2f} GiB")
    qv = torch.tensor(params.qs[:-1], device=dev).view(-1, 1, 1)
    for e in (e0, e1):
        if e.shape != (nrns - 1, n, B) or e.dtype != torch.int32:
            raise AssertionError(f"step output {e.dtype} {tuple(e.shape)}")
        if bool((e < 0).any()) or bool((e.long() >= qv).any()):
            raise AssertionError("step output residues out of [0, q)")
    for b in range(8):
        want = she.pt_mul(params, m1[:, b].cpu().numpy(), m2[:, b].cpu().numpy())
        np.testing.assert_array_equal(got[:, b].cpu().numpy(), want)
    cols = 64
    cpu_in = [t[:, :, :cols].cpu().contiguous() for t in (c0, c1, d0, d1)]
    cpu_out = BatchedBGV(params, "cpu").build_step(hint)(*cpu_in)
    for gpu_e, cpu_e in zip((e0, e1), cpu_out):
        if not torch.equal(gpu_e[:, :, :cols].cpu(), cpu_e):
            raise AssertionError("GPU step != CPU step over columns 0-63")
    mark("phase 3: decrypt of columns 0-7 == pt_mul; GPU == CPU over columns 0-63")

    # -- phase 3b: the ring-sharded NTT at full width --------------------
    D = 4
    mesh = sh.make_mesh({"ring": D})
    ring = []  # (plan, x, its shards, single-card forward, inverse)
    for plan_r in [*bb.plans(), ntt.ntt_plan(65536, nt.ntt_primes(2 * 65536, 30, 1)[0])]:
        xr = torch.randint(0, plan_r.q, (plan_r.n, B), generator=g, device=dev,
                           dtype=torch.int32)
        xr.view(-1)[:3] = torch.tensor([0, 1, plan_r.q - 1], device=dev)
        fwd, inv = tk.ntt_cm(xr, plan_r), tk.ntt_cm(xr, plan_r, inverse=True)
        if not (torch.equal(fwd, tk.ntt_cm_ref(xr, plan_r))
                and torch.equal(inv, tk.ntt_cm_ref(xr, plan_r, inverse=True))):
            raise AssertionError(f"ntt_cm != ntt_cm_ref at n={plan_r.n}, q={plan_r.q}")
        ring.append((plan_r, xr, sh.ring_shard(xr, mesh), fwd, inv))
    print("ring mesh:", {k: v for k, v in mesh.shape.items()}, "shard devices:",
          [str(s.device) for s in ring[0][2]], flush=True)
    ring_launches = {}
    for overlap, route in ((False, "two-call"), (True, "fused")):
        torch.cuda.synchronize()
        reset_counts()
        outs = [(rn.ntt_ring_sharded_cm(mesh, shards, pl_, overlap=overlap),
                 rn.intt_ring_sharded_cm(mesh, shards, pl_, overlap=overlap))
                for pl_, _, shards, _, _ in ring]
        outs = [(f, i, rn.intt_ring_sharded_cm(mesh, f, pl_, overlap=overlap))
                for (f, i), (pl_, *_) in zip(outs, ring)]
        torch.cuda.synchronize()
        got = counts()
        want = dict.fromkeys(got, 0)
        for pl_, *_ in ring:  # per case: forward, inverse, inverse of the forward
            pb = len(rn.phase_b_passes(pl_.n // D, D, 0))
            fused = dict(a2a=3 * D, ntt_fwd=D * pb, ntt_inv=2 * D * pb,
                         ntt_fwd_gather=D, ntt_inv_scatter=2 * D)
            two_call = dict(a2a=6 * D, ntt_fwd=D * (1 + pb), ntt_inv=2 * D * (1 + pb))
            for k, v in (fused if overlap else two_call).items():
                want[k] += v
        if got != want:
            raise AssertionError(f"ring route {route}: launches {got}, want {want}")
        ring_launches[route] = got
        for (pl_, xr, _, fwd, inv), (f, i, b) in zip(ring, outs):
            for name, ys, ref in (("forward", f, fwd), ("inverse", i, inv), ("round trip", b, xr)):
                if not torch.equal(sh.ring_unshard(ys), ref):
                    raise AssertionError(f"ring {route} {name} != single card at n={pl_.n}, "
                                         f"q={pl_.q}")
        del outs
        mark(f"phase 3b: ring route {route}: n=2^14 x 3 primes and n=2^16, B={B}, D={D}: "
             f"forward, inverse, round trip == ntt_cm; launches {got}")

    # -- phase 3c: the standalone builders ------------------------------
    # Every GPU call runs between a reset and a read of the counts, which
    # must equal its NTT calls times the passes of `cm_schedule` (one at
    # n = 4096, 8192 and 2^14), its ct_mul calls, and nothing else.
    path_launches = {ph: dict.fromkeys(counts(), 0)
                     for ph in ("3c", "3d", "3e", "3e_ext", "3f", "3f_galois", "3g", "3g_slots",
                                "3h", "3i")}

    def run(phase, name, fn, *args, fwd=0, inv=0, ct_mul=0, n_fwd=None, n_inv=None):
        return run_by_n(phase, name, fn, *args, fwd={n_fwd: fwd} if fwd else {},
                        inv={n_inv: inv} if inv else {}, ct_mul=ct_mul)

    def run_by_n(phase, name, fn, *args, fwd, inv, ct_mul=0):
        """fn(*args) between a reset and a read of the counts, which must
        be fwd[n] forward and inv[n] GS ntt_cm calls at each n, each
        `cm_schedule(n)`'s passes, ct_mul ct_mul launches, and nothing else."""
        reset_counts()
        out = fn(*args)
        torch.cuda.synchronize()
        got = counts()
        want = dict.fromkeys(got, 0)
        want.update(ntt_fwd=sum(k * len(tk.cm_schedule(n_)) for n_, k in fwd.items()),
                    ntt_inv=sum(k * len(tk.cm_schedule(n_)) for n_, k in inv.items()),
                    ct_mul=ct_mul)
        if got != want:
            raise AssertionError(f"phase {phase} {name}: launches {got}, want {want}")
        for k, v in got.items():
            path_launches[phase][k] += v
        return out

    def run_recorded(phase, name, fn):
        """fn() between a reset and a read of the counts, every ring-layer
        ntt_cm call recorded by n: the launches must be each call's
        cm_schedule(n) passes, and nothing else."""
        rec, real = Counter(), ring_mod.ntt_cm

        def shim(x_, plan_, inverse=False, pre_digit_q=None, alg="gs"):
            rec["ntt_inv" if inverse else "ntt_fwd"] += len(tk.cm_schedule(x_.shape[0]))
            return real(x_, plan_, inverse, pre_digit_q, alg)

        reset_counts()
        ring_mod.ntt_cm = gen.ntt_cm = shim
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            ring_mod.ntt_cm = gen.ntt_cm = real
        got = counts()
        want = dict.fromkeys(got, 0)
        want.update(rec)
        if got != want:
            raise AssertionError(f"phase {phase} {name}: launches {got}, want {want}")
        for k, v in got.items():
            path_launches[phase][k] += v
        return out

    def same_on_cpu(name, out, fn, *args, atol=None, ncols=None):
        """fn on the CPU over columns 0-63 (or 0..ncols-1) of args == out's
        (exactly, or within atol for the float32 noise budget)."""
        ncols = ncols or cols
        cpu = fn(*(a[..., :ncols].cpu().contiguous() for a in args))
        outs, cpus = (out, cpu) if isinstance(out, tuple) else ((out,), (cpu,))
        for x, y in zip(outs, cpus):
            x = x[..., :ncols].cpu()
            ok = torch.equal(x, y) if atol is None else torch.allclose(x, y, rtol=0, atol=atol)
            if not ok:
                raise AssertionError(f"phase 3c-3e {name}: GPU != CPU over columns "
                                     f"0-{ncols - 1}")

    def decrypts_to(name, got, want):
        """Columns 0-7 of the decryption `got` against the (n, >=8) `want`."""
        np.testing.assert_array_equal(got[:, :8].cpu().numpy(), np.asarray(want)[:, :8],
                                      err_msg=name)

    def pt_muls(a, b, prm):
        return np.stack([she.pt_mul(prm, a[:, k].cpu().numpy(), b[:, k].cpu().numpy())
                         for k in range(8)], -1)

    # the MSD step at the phase-3 ring, m = 32768 (n = 2^14), B = 1024
    enc_msd = bb.build_encrypt(sk, encoding="msd")
    cm = run("3c", "encrypt msd n16384", enc_msd, m1, nk(), fwd=nrns, n_fwd=n)
    dm = run("3c", "encrypt msd n16384", enc_msd, m2, nk(), fwd=nrns, n_fwd=n)
    step_msd = bb.build_step(hint, encoding="msd")
    em = run("3c", "step msd n16384", step_msd, *cm, *dm, fwd=step_calls["ntt_fwd"],
             inv=step_calls["ntt_inv"], ct_mul=nrns, n_fwd=n, n_inv=n)
    dec_msd = BatchedBGV(p2, dev).build_decrypt(
        she.SK(p2, sk.s_ints, sk.var), f=bb.step_f(1, 1, "msd"), encoding="msd")
    decrypts_to("step msd n16384", run("3c", "decrypt msd n16384", dec_msd, *em,
                                       inv=nrns - 1, n_inv=n), pt_muls(m1, m2, params))
    same_on_cpu("step msd n16384", em,
                BatchedBGV(params, "cpu").build_step(hint, encoding="msd"), *cm, *dm)
    del cm, dm, em
    mark("phase 3c: MSD step at n = 2^14: decrypt of columns 0-7 == pt_mul; GPU == CPU")
    # every builder at m = 8192 (n = 4096), the reference bench's n = 4096 leg
    m8 = 8192
    params8 = she.SHEParams(m=m8, p=p, qs=tuple(nt.ntt_primes(m8, 30, 3)), var=2.0)
    n8 = params8.ctx.n
    bb8, bb8_cpu = BatchedBGV(params8, dev), BatchedBGV(params8, "cpu")
    sk8, sk8_new = she.gen_sk(params8, nk()), she.gen_sk(params8, nk())
    p8d = she.SHEParams(m=m8, p=p, qs=params8.qs[:-1], var=2.0)
    bb8d = BatchedBGV(p8d, dev)
    sk8d = she.SK(p8d, sk8.s_ints, sk8.var)
    a8, b8 = she.pt_random(params8, rng, (B,)), she.pt_random(params8, rng, (B,))
    pub = she.pt_random(params8, rng, (B,))
    c8 = {}  # encoding -> (encryption of a8, encryption of b8)
    for e in ("lsd", "msd"):
        enc_e = bb8.build_encrypt(sk8, e)
        c8[e] = tuple(run("3c", f"encrypt {e}", enc_e, x, nk(), fwd=nrns, n_fwd=n8)
                      for x in (a8, b8))
    hint8 = run("3c", "gen_ks_quad_hint", bb8.gen_ks_quad_hint, sk8, nk(), fwd=nrns, n_fwd=n8)

    def dec(e, x, name, f=1, pipe=None, key=None, phase="3c"):
        fn = (pipe or bb8).build_decrypt(key or sk8, f=f, encoding=e)
        return run(phase, f"decrypt {name}", fn, *x, inv=len((pipe or bb8).qs), n_inv=n8)

    st8 = bb8.build_step(hint8, encoding="msd")
    e8 = run("3c", "step msd", st8, *c8["msd"][0], *c8["msd"][1], fwd=step_calls["ntt_fwd"],
             inv=step_calls["ntt_inv"], ct_mul=nrns, n_fwd=n8, n_inv=n8)
    decrypts_to("step msd", dec("msd", e8, "step msd", bb8.step_f(1, 1, "msd"), bb8d, sk8d),
                pt_muls(a8, b8, params8))
    same_on_cpu("step msd", e8, bb8_cpu.build_step(hint8, encoding="msd"),
                *c8["msd"][0], *c8["msd"][1])
    out = dec("msd", c8["msd"][0], "msd")
    decrypts_to("encrypt msd", out, a8.cpu())
    same_on_cpu("decrypt msd", out, bb8_cpu.build_decrypt(sk8, encoding="msd"), *c8["msd"][0])
    for e in ("lsd", "msd"):
        ms = bb8.build_mod_switch(e)
        out = run("3c", f"mod_switch {e}", ms, *c8[e][0], fwd=2 * (nrns - 1), inv=2,
                  n_fwd=n8, n_inv=n8)
        decrypts_to(f"mod_switch {e}", dec(e, out, f"mod_switch {e}",
                                           bb8.mod_switch_f(1) if e == "lsd" else 1,
                                           bb8d, sk8d), a8.cpu())
        same_on_cpu(f"mod_switch {e}", out, bb8_cpu.build_mod_switch(e), *c8[e][0])
    lin_hint = run("3c", "gen_ks_linear_hint", bb8.gen_ks_linear_hint, sk8_new, sk8, nk(),
                   fwd=nrns, n_fwd=n8)
    ksl = bb8.build_key_switch_linear(lin_hint)
    out = run("3c", "key_switch_linear", ksl, *c8["lsd"][0], fwd=nrns * (nrns - 1), inv=nrns,
              n_fwd=n8, n_inv=n8)
    decrypts_to("key_switch_linear", dec("lsd", out, "key_switch_linear", key=sk8_new), a8.cpu())
    same_on_cpu("key_switch_linear", out, bb8_cpu.build_key_switch_linear(lin_hint),
                *c8["lsd"][0])
    inv3 = nt.modinv(3, p)  # ct_b read at scale 3: its message is b8 / 3
    for sub in (False, True):
        out = run("3c", "add", bb8.build_add(1, 3, sub), *c8["lsd"][0], *c8["lsd"][1])
        sign = -1 if sub else 1
        decrypts_to(f"add sub={sub}", dec("lsd", out, "add"),
                    ((a8.long() + sign * inv3 * b8.long()) % p).cpu())
        same_on_cpu(f"add sub={sub}", out, bb8_cpu.build_add(1, 3, sub),
                    *c8["lsd"][0], *c8["lsd"][1])
    for e, pb in (("lsd", pub), ("msd", pub[:, :1])):
        out = run("3c", f"add_public {e}", bb8.build_add_public(5, e), *c8[e][0], pb,
                  fwd=nrns, n_fwd=n8)
        decrypts_to(f"add_public {e}", dec(e, out, "add_public"),
                    ((a8.long() + 5 * pb.long()) % p).cpu())
        same_on_cpu(f"add_public {e}", out, bb8_cpu.build_add_public(5, e), *c8[e][0], pb)
    for pb in (pub, pub[:, :1]):
        out = run("3c", "mul_public", bb8.build_mul_public(), *c8["lsd"][0], pb,
                  fwd=nrns, n_fwd=n8)
        decrypts_to("mul_public", dec("lsd", out, "mul_public"),
                    pt_muls(a8, pb.expand(n8, B), params8))
        same_on_cpu("mul_public", out, bb8_cpu.build_mul_public(), *c8["lsd"][0], pb)
    for e, to in (("msd", "lsd"), ("lsd", "msd")):
        out = run("3c", f"to_{to}", getattr(bb8, f"build_to_{to}")(), *c8[e][0])
        decrypts_to(f"to_{to}", dec(to, out, f"to_{to}", getattr(bb8, f"to_{to}_f")(1)),
                    a8.cpu())
        same_on_cpu(f"to_{to}", out, getattr(bb8_cpu, f"build_to_{to}")(), *c8[e][0])
    bits = run("3c", "noise_bits", bb8.build_noise_bits(sk8), *c8["lsd"][0], inv=nrns, n_inv=n8)
    log2_q = math.log2(math.prod(params8.qs))
    if bits.shape != (B,) or not bool(torch.isfinite(bits).all()) or not bool(
            ((bits >= 0) & (bits < log2_q)).all()):
        raise AssertionError(f"noise_bits out of [0, log2 Q = {log2_q:.1f}): "
                             f"{bits.min().item()}..{bits.max().item()}")
    same_on_cpu("noise_bits", bits, bb8_cpu.build_noise_bits(sk8), *c8["lsd"][0], atol=1e-4)
    same_on_cpu("error_term", run("3c", "error_term", bb8.build_error_term(sk8), *c8["lsd"][0],
                                  inv=nrns, n_inv=n8),
                bb8_cpu.build_error_term(sk8), *c8["lsd"][0])
    mark(f"phase 3c: builders at n = {n8}, B = {B}: every decryption == its plaintext, "
         f"GPU == CPU over columns 0-63; noise bits {bits.min().item():.2f}-"
         f"{bits.max().item():.2f}; launches {path_launches['3c']}")

    # -- phase 3d: the fused ring tunnel m = 32768 -> 16384 ----------------
    # the reference bench's leg (bench.py:454-496): E = S, ys = [1, 0], the
    # phase-3 ring, chain and key as the source
    m_s = m // 2
    ps = she.SHEParams(m=m_s, p=p, qs=params.qs, var=2.0)
    n_s = ps.ctx.n
    sk_s = she.gen_sk(ps, nk())
    S = ps.ctx
    fmap = linear.linear_pow(S, params.ctx, S, [np.eye(1, n_s, dtype=np.int64)[0],
                                                np.zeros(n_s, dtype=np.int64)])
    d_rel = fmap.d
    th = run("3d", "gen_tunnel_hint", bb.gen_tunnel_hint, fmap, sk_s, sk, nk(),
             fwd=nrns, n_fwd=n_s)
    tun = bb.build_tunnel(th)
    mt = she.pt_random(params, rng, (B,))
    ct = run("3d", "encrypt", enc, mt, nk(), fwd=nrns, n_fwd=n)
    tunnel_calls = {"ntt_fwd": d_rel * nrns + d_rel * nrns * nrns, "ntt_inv": 2 * nrns}
    t0, t1 = run("3d", "tunnel", tun, *ct, fwd=tunnel_calls["ntt_fwd"],
                 inv=tunnel_calls["ntt_inv"], n_fwd=n_s, n_inv=n)
    tunnel_launches = counts()
    got_t = run("3d", "decrypt over S", bb.target_pipeline(th).build_decrypt(sk_s), t0, t1,
                inv=nrns, n_inv=n_s)
    decrypts_to("tunnel", got_t, np.stack([linear.eval_lin_ints(fmap, mt[:, k].cpu().numpy(), p)
                                           for k in range(8)], -1))
    same_on_cpu("tunnel", (t0, t1), BatchedBGV(params, "cpu").build_tunnel(th), *ct)
    mark(f"phase 3d: tunnel m = {m} -> {m_s}, B = {B}: decrypt of columns 0-7 == eval_lin; "
         f"GPU == CPU over columns 0-63; launches {tunnel_launches}")

    # -- phase 3e: the serving layer and extended-modulus key switching --
    # Launches, per n: a step at L primes runs L(L-1) + 2(L-1) forwards
    # (the digits, the rescale's corrections), L + 2 GS inverses and L
    # ct_mul; a modulus switch 2(L-1) and 2; an add / mul_public L forwards.
    def step_fi(L):
        return L * (L - 1) + 2 * (L - 1), L + 2

    def add_by_n(acc, n_, k):
        acc[n_] = acc.get(n_, 0) + k

    # (a) the rounding chain Z_8 -> Z_2, bench.py's leg (bench.py:393-450)
    pr_p = 8
    params_pr = she.SHEParams(m=m, p=pr_p, qs=tuple(nt.ntt_primes(m, 30, she.pt_round_mults(pr_p) + 2)),
                              var=2.0)
    L_pr = len(params_pr.qs)
    sk_pr = she.gen_sk(params_pr, nk())
    # the object path's ks_quad_circ_hint at each prefix L: s into the CRT
    # basis twice, and per RNS digit the error's and the scalar's transforms
    rh = run_by_n("3e", "pt_round_hints", she.pt_round_hints, sk_pr, gadget.RnsGad(), nk(), dev,
                  fwd={n: sum(2 * (L_pr - i) * (1 + L_pr - i)
                              for i in range(she.pt_round_mults(pr_p)))}, inv={})
    bb_pr = BatchedBGV(params_pr, dev)
    vals = torch.randint(0, pr_p, (B,), generator=g, device=dev, dtype=torch.int32)
    msgs = torch.zeros((n, B), dtype=torch.int32, device=dev)
    msgs[0] = vals
    ct_pr = run("3e", "encrypt p=8", bb_pr.build_encrypt(sk_pr), msgs, nk(), fwd=L_pr, n_fwd=n)
    run_pr, bb_pr_out, f_pr = serving.build_pt_round(bb_pr, rh)

    def pt_round_calls(L, n_):
        """serving.build_pt_round at p = 8 = 2^3 over L primes: the 2^{k-2}
        pre-add, two squarings (at L, L - 1), y switched down twice, one
        squaring at L - 2, y switched once more: {n: calls} and ct_mul."""
        steps = switches = (L, L - 1, L - 2)
        fwd = L + sum(step_fi(Ls)[0] for Ls in steps) + sum(2 * (Ls - 1) for Ls in switches)
        inv = sum(step_fi(Ls)[1] for Ls in steps) + 2 * len(switches)
        return {n_: fwd}, {n_: inv}, sum(steps)

    fw, iv, cm_ = pt_round_calls(L_pr, n)
    y_pr = run_by_n("3e", "pt_round", run_pr, *ct_pr, fwd=fw, inv=iv, ct_mul=cm_)
    got = run("3e", "decrypt pt_round", bb_pr_out.build_decrypt(
        she.SK(bb_pr_out.params, sk_pr.s_ints, sk_pr.var), f=f_pr), *y_pr,
        inv=len(bb_pr_out.qs), n_inv=n)
    want = (2 * vals[:8].long() * 2 + pr_p) // (2 * pr_p) % 2
    if bb_pr_out.params.p != 2 or not torch.equal(got[0, :8].long(), want) or bool(
            got[1:, :8].any()):
        raise AssertionError(f"pt_round: decrypt {got[0, :8].tolist()}, want {want.tolist()}")
    same_on_cpu("pt_round", y_pr, serving.build_pt_round(BatchedBGV(params_pr, "cpu"), rh)[0],
                *ct_pr)
    mark(f"phase 3e: pt_round m = {m}, p = 8, {L_pr} primes, B = {B}: decrypt of columns 0-7 "
         f"== round-half-up(v / 4); GPU == CPU over columns 0-63; launches {path_launches['3e']}")
    # (b) HomomPRF component 0 down the tower 32768 -> 2 (she_bench.py:100-219)
    qs_prf = tuple(nt.ntt_primes(m, 30, she.pt_round_mults(pr_p) + 4))
    L_prf, bits = len(qs_prf), (1, 0)
    rings = [m >> k for k in range(m.bit_length() - 1)]
    ns = [r // 2 for r in rings]  # 16384 .. 1
    sks = [she.gen_sk(she.SHEParams(m=r, p=pr_p, qs=qs_prf, var=2.0), nk()) for r in rings]
    fam = prf.PRFFamily.random(ring_context(m, (pr_p,)), gadget.BaseBGad(2), prf.balanced(2), nk())
    # the object path's tunnel and rounding hints: each transform they call
    # (recorded by n) launches cm_schedule(n)'s passes, and nothing else
    hints, sk_out = run_recorded("3e", "make_eval_hints", lambda: prf.make_eval_hints(
        fam, sks, rings, rings[1:], gadget.RnsGad(), nk(), homomorphic_round=True,
        maps="project", device=dev))
    bb_top = BatchedBGV(sks[0].params, dev)
    s_key = torch.randint(0, pr_p, (n, 1), generator=g, device=dev, dtype=torch.int32)
    ct_prf = run("3e", "encrypt key", bb_top.build_encrypt(sks[0]), s_key.expand(n, B), nk(),
                 fwd=L_prf, n_fwd=n)
    fw, iv, cm_ = pt_round_calls(L_prf, 1)
    add_by_n(fw, n, L_prf)  # mul_public
    for n_r, n_s in zip(ns, ns[1:]):  # each hop: d = 2 relative coefficients
        add_by_n(fw, n_s, 2 * L_prf + 2 * L_prf ** 2)
        add_by_n(iv, n_r, 2 * L_prf)
    prf_calls = (dict(fw), dict(iv), cm_)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bb_prf_out, f_prf, y_prf = run_by_n("3e", "homom_prf", lambda: serving.batched_homom_prf_component(
        fam, hints, bb_top, *ct_prf, bits, 0), fwd=fw, inv=iv, ct_mul=cm_)
    prf_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    got = run("3e", "decrypt homom_prf", bb_prf_out.build_decrypt(
        she.SK(bb_prf_out.params, sk_out.s_ints, sk_out.var), f=f_prf), *y_prf,
        inv=len(bb_prf_out.qs), n_inv=1)
    want = int(prf.prf_ints(fam, s_key[:, 0].cpu().numpy(), bits, 2)[0][0])
    if (bb_prf_out.params.m, bb_prf_out.params.p) != (2, 2) or got[0, :8].tolist() != [want] * 8:
        raise AssertionError(f"homom_prf: decrypt {got[0, :8].tolist()}, want {want} x 8")
    same_on_cpu("homom_prf", y_prf, lambda c0_, c1_: serving.batched_homom_prf_component(
        fam, hints, BatchedBGV(bb_top.params, "cpu"), c0_, c1_, bits, 0)[2], *ct_prf, ncols=16)
    print(f"homom_prf peak device memory {prf_peak_gib:.3f} GiB "
          f"({torch.cuda.max_memory_allocated()} B)", flush=True)
    mark(f"phase 3e: HomomPRF m = {m} -> 2 ({len(hints.tunnels)} tunnels), {L_prf} primes, "
         f"B = {B}: decrypt of columns 0-7 == prf = {want}; GPU == CPU over columns 0-15; "
         f"peak {prf_peak_gib:.2f} GiB")
    # (c) the extended-modulus step and linear key switch at n = 4096 with
    # two special primes (bench.py:312-324)
    all5 = tuple(nt.ntt_primes(m8, 30, 5))
    if all5[:3] != params8.qs:
        raise AssertionError("the extended chain does not extend phase 3c's")
    special = all5[3:]
    Lb, Lx = len(params8.qs), len(all5)
    quad_ext = run("3e_ext", "gen_ks_quad_hint_ext", bb8.gen_ks_quad_hint_ext, sk8, special, nk(),
                   fwd=Lx, n_fwd=n8)
    lin_ext = run("3e_ext", "gen_ks_linear_hint_ext", bb8.gen_ks_linear_hint_ext, sk8_new, sk8,
                  special, nk(), fwd=Lx, n_fwd=n8)
    # the digits into every extended channel but their own, then one
    # rescale pair per special prime; the step adds its own rescale
    ks_fwd = Lb * (Lx - 1) + sum(2 * (Lb + k - 1) for k in range(1, len(special) + 1))
    ks_inv = Lb + 2 * len(special)
    ext, ksl_ext = {}, {}
    for e in ("lsd", "msd"):
        ext[e] = run("3e_ext", f"step_ext {e}", bb8.build_step_ext(quad_ext, e), *c8[e][0],
                     *c8[e][1], fwd=ks_fwd + 2 * (Lb - 1), inv=ks_inv + 2, ct_mul=Lb,
                     n_fwd=n8, n_inv=n8)
        decrypts_to(f"step_ext {e}", dec(e, ext[e], f"step_ext {e}", bb8.step_f(1, 1, e), bb8d,
                                         sk8d, phase="3e_ext"), pt_muls(a8, b8, params8))
        same_on_cpu(f"step_ext {e}", ext[e], bb8_cpu.build_step_ext(quad_ext, e),
                    *c8[e][0], *c8[e][1])
        ksl_ext[e] = run("3e_ext", f"key_switch_linear_ext {e}",
                         bb8.build_key_switch_linear_ext(lin_ext), *c8[e][0], fwd=ks_fwd,
                         inv=ks_inv, n_fwd=n8, n_inv=n8)
        decrypts_to(f"key_switch_linear_ext {e}", dec(e, ksl_ext[e], "ksl_ext", key=sk8_new,
                                                      phase="3e_ext"), a8.cpu())
        same_on_cpu(f"key_switch_linear_ext {e}", ksl_ext[e],
                    bb8_cpu.build_key_switch_linear_ext(lin_ext), *c8[e][0])
    # noise budgets, LSD, on the same inputs: the base-gadget builders
    # (counted with this phase) against the ext ones
    base = {"step": run("3e_ext", "step lsd (noise baseline)", bb8.build_step(hint8),
                        *c8["lsd"][0], *c8["lsd"][1], fwd=step_calls["ntt_fwd"],
                        inv=step_calls["ntt_inv"], ct_mul=nrns, n_fwd=n8, n_inv=n8),
            "ks_linear": run("3e_ext", "key_switch_linear (noise baseline)", ksl, *c8["lsd"][0],
                             fwd=nrns * (nrns - 1), inv=nrns, n_fwd=n8, n_inv=n8)}
    noise = {}
    for key, pipe, sk_, x in (("step", bb8d, sk8d, base["step"]),
                              ("step_ext", bb8d, sk8d, ext["lsd"]),
                              ("ks_linear", bb8, sk8_new, base["ks_linear"]),
                              ("ks_linear_ext", bb8, sk8_new, ksl_ext["lsd"])):
        noise[key] = run("3e_ext", f"noise_bits {key}", pipe.build_noise_bits(sk_), *x,
                         inv=len(pipe.qs), n_inv=n8).mean().item()
    del base
    step_ext_delta = noise["step"] - noise["step_ext"]
    print(f"step_ext noise bits (mean over B = {B}): base step {noise['step']}, ext step "
          f"{noise['step_ext']}; linear key switch {noise['ks_linear']}, ext "
          f"{noise['ks_linear_ext']}", flush=True)
    if not (noise["step_ext"] < noise["step"] and noise["ks_linear_ext"] < noise["ks_linear"]):
        raise AssertionError(f"extended-modulus key switching did not lower the noise: {noise}")
    mark(f"phase 3e: ext step and linear key switch at n = {n8}, {Lb} + {len(special)} primes, "
         f"B = {B}: decrypts == pt_mul / the message; GPU == CPU over columns 0-63; noise "
         f"-{step_ext_delta:.2f} bits; launches {path_launches['3e_ext']}")

    # -- phase 3f: general m and the Galois automorphisms ----------------
    # (a) bench.py's config-3 step (bench.py:543-547): m = 18432 = 2^11 3^2
    # (n = 6144, phi_shape (1024, 6)), p = 7, three primes, B = 1024.  Each
    # CRT transform is one ntt_cm over the 2-power axis (n2 = 1024, B' =
    # 6 B), so the 2-power step's counts hold at n2, and the 3^2 axis is
    # plain torch.
    m_g, p_g, cols_g = 18432, 7, 16
    params_g = she.SHEParams(m=m_g, p=p_g, qs=tuple(nt.ntt_primes(m_g, 30, 3)), var=2.0)
    n_g, n2_g = params_g.ctx.n, params_g.ctx.fm.phi_shape[0]
    bb_g, bb_g_cpu = BatchedBGV(params_g, dev), BatchedBGV(params_g, "cpu")
    sk_g = she.gen_sk(params_g, nk())
    pg_d = she.SHEParams(m=m_g, p=p_g, qs=params_g.qs[:-1], var=2.0)
    bb_gd = BatchedBGV(pg_d, dev)
    sk_gd = she.SK(pg_d, sk_g.s_ints, sk_g.var)
    hint_g = run("3f", "gen_ks_quad_hint m=18432", bb_g.gen_ks_quad_hint, sk_g, nk(),
                 fwd=nrns, n_fwd=n2_g)
    a_g, b_g = she.pt_random(params_g, rng, (B,)), she.pt_random(params_g, rng, (B,))
    ct_g, step_g = {}, {}
    for e in ("lsd", "msd"):
        enc_g = bb_g.build_encrypt(sk_g, e)
        ct_g[e] = [run("3f", f"encrypt {e} m=18432", enc_g, x, nk(), fwd=nrns, n_fwd=n2_g)
                   for x in (a_g, b_g)]
        step_g[e] = bb_g.build_step(hint_g, encoding=e)
        out = run("3f", f"step {e} m=18432", step_g[e], *ct_g[e][0], *ct_g[e][1],
                  fwd=step_calls["ntt_fwd"], inv=step_calls["ntt_inv"], ct_mul=nrns,
                  n_fwd=n2_g, n_inv=n2_g)
        got = run("3f", f"decrypt {e} m=18432", bb_gd.build_decrypt(
            sk_gd, f=bb_g.step_f(1, 1, e), encoding=e), *out, inv=nrns - 1, n_inv=n2_g)
        decrypts_to(f"step {e} m=18432", got, pt_muls(a_g, b_g, params_g))
        same_on_cpu(f"step {e} m=18432", out, bb_g_cpu.build_step(hint_g, encoding=e),
                    *ct_g[e][0], *ct_g[e][1], ncols=cols_g)
    mark(f"phase 3f: step LSD and MSD at m = {m_g} (n = {n_g}), p = {p_g}, B = {B}: decrypt of "
         f"columns 0-7 == pt_mul; GPU == CPU over columns 0-{cols_g - 1}")
    # (b) the tunnel 18432 -> 9216 (bench.py:454-496 at m_gt): E = S,
    # ys = [1, 0]: 2 nrns inverses at n2 = 1024, d nrns + d nrns^2 forwards
    # at n2 = 512
    ps_g = she.SHEParams(m=m_g // 2, p=p_g, qs=params_g.qs, var=2.0)
    n_gs, n2_gs = ps_g.ctx.n, ps_g.ctx.fm.phi_shape[0]
    sk_gs = she.gen_sk(ps_g, nk())
    fmap_g = linear.linear_pow(ps_g.ctx, params_g.ctx, ps_g.ctx,
                               [np.eye(1, n_gs, dtype=np.int64)[0], np.zeros(n_gs, dtype=np.int64)])
    th_g = run("3f", "gen_tunnel_hint m=18432", bb_g.gen_tunnel_hint, fmap_g, sk_gs, sk_g, nk(),
               fwd=nrns, n_fwd=n2_gs)
    tun_g = bb_g.build_tunnel(th_g)
    mt_g = she.pt_random(params_g, rng, (B,))
    ctt_g = run("3f", "encrypt m=18432", bb_g.build_encrypt(sk_g), mt_g, nk(), fwd=nrns, n_fwd=n2_g)
    tg = run_by_n("3f", "tunnel m=18432", tun_g, *ctt_g,
                  fwd={n2_gs: fmap_g.d * nrns * (1 + nrns)}, inv={n2_g: 2 * nrns})
    got = run("3f", "decrypt over S m=9216", bb_g.target_pipeline(th_g).build_decrypt(sk_gs), *tg,
              inv=nrns, n_inv=n2_gs)
    # decrypt gives decoding-basis coefficients, eval_lin takes and gives
    # powerful-basis ones: L and L^-1 mod p on either side
    decrypts_to("tunnel m=18432", got, np.stack([gen.l_host(m_g // 2, linear.eval_lin_ints(
        fmap_g, gen.l_host(m_g, mt_g[:, k].cpu().numpy(), p_g), p_g), p_g, inverse=True)
        for k in range(8)], -1))
    same_on_cpu("tunnel m=18432", tg, BatchedBGV(params_g, "cpu").build_tunnel(th_g), *ctt_g,
                ncols=cols_g)
    mark(f"phase 3f: tunnel m = {m_g} -> {m_g // 2}, B = {B}: decrypt of columns 0-7 == "
         f"eval_lin; GPU == CPU over columns 0-{cols_g - 1}; launches {path_launches['3f']}")
    # (c) bench.py's galois leg (bench.py:330-387): m = 32768, the phase-3
    # chain, p = 257, k in {3, 5, 9}: a rotation is nrns inverses and
    # nrns (nrns - 1) digit forwards at n = 2^14; the hoisted module runs
    # them once for all k
    ks = (3, 5, 9)
    ghints = {k: run("3f_galois", f"gen_galois_hint k={k}", bb.gen_galois_hint, k, sk, nk(),
                     fwd=nrns, n_fwd=n) for k in ks}
    gal_many = bb.build_galois_many(ghints)
    gal_one = {k: bb.build_galois(ghints[k], k) for k in ks}
    mg = she.pt_random(params, rng, (B,))
    ct_gal = run("3f_galois", "encrypt", enc, mg, nk(), fwd=nrns, n_fwd=n)
    rot_fwd, rot_inv = nrns * (nrns - 1), nrns
    outs_many = run("3f_galois", "galois_many", gal_many, *ct_gal, fwd=rot_fwd, inv=rot_inv,
                    n_fwd=n, n_inv=n)
    dec_gal = bb.build_decrypt(sk)
    for k in ks:
        out = run("3f_galois", f"galois k={k}", gal_one[k], *ct_gal, fwd=rot_fwd, inv=rot_inv,
                  n_fwd=n, n_inv=n)
        if not all(torch.equal(a, b) for a, b in zip(out, outs_many[k])):
            raise AssertionError(f"galois_many != build_galois at k={k} over all {B} columns")
        decrypts_to(f"galois k={k}", run("3f_galois", f"decrypt galois k={k}", dec_gal, *out,
                                         inv=nrns, n_inv=n),
                    np.stack([she.galois_ints(m, mg[:, c].cpu().numpy(), k, p) for c in range(8)], -1))
        same_on_cpu(f"galois k={k}", out, BatchedBGV(params, "cpu").build_galois(ghints[k], k),
                    *ct_gal, ncols=cols_g)
    # one rotation at the general ring, m = 18432, k = 5
    gh_g = run("3f_galois", "gen_galois_hint m=18432", bb_g.gen_galois_hint, 5, sk_g, nk(),
               fwd=nrns, n_fwd=n2_g)
    gal_g = bb_g.build_galois(gh_g, 5)
    out = run("3f_galois", "galois k=5 m=18432", gal_g, *ct_g["lsd"][0], fwd=rot_fwd,
              inv=rot_inv, n_fwd=n2_g, n_inv=n2_g)
    decrypts_to("galois k=5 m=18432", run("3f_galois", "decrypt galois m=18432",
                                          bb_g.build_decrypt(sk_g), *out, inv=nrns, n_inv=n2_g),
                np.stack([she.galois_ints(m_g, a_g[:, c].cpu().numpy(), 5, p_g)
                          for c in range(8)], -1))
    same_on_cpu("galois k=5 m=18432", out, bb_g_cpu.build_galois(gh_g, 5), *ct_g["lsd"][0],
                ncols=cols_g)
    mark(f"phase 3f: galois k = {ks} at m = {m}, B = {B}: hoisted == separate over every "
         f"column, decrypt of columns 0-7 == sigma_k; k = 5 at m = {m_g}; GPU == CPU over "
         f"columns 0-{cols_g - 1}; launches {path_launches['3f_galois']}")
    del outs_many, out

    # -- phase 3g: the mesh-aware builders and the CRT-set slot maps -----
    # (a) every mesh builder over make_mesh({"rns": 3, "data": 4}), the
    # visible cards round-robin (on one card, twelve entries of it), on
    # the inputs of phases 3-3f: its output unsharded == the unsharded
    # builder's over all B columns, columns 0-7 decrypted as there, and
    # its launches exact: Dd times the unsharded call's at each n, since
    # every transform and ct_mul of an unsharded call runs once for each
    # data column, on the block that holds its channel.
    rd_mesh = sh.make_mesh({"rns": 3, "data": 4})
    d_mesh = sh.data_mesh(rd_mesh)
    Dd = rd_mesh.shape["data"]
    print("rns x data mesh:", rd_mesh.shape, "devices:",
          sorted({str(d_) for d_ in rd_mesh.devices.flat}), flush=True)

    def shard(*ts, on=rd_mesh):
        return [sh.shard_batch_rns(on, t) for t in ts]

    def unshard(out):
        if isinstance(out, dict):
            return {k: unshard(v) for k, v in out.items()}
        return tuple(sh.unshard_batch_rns(b_) for b_ in out)

    def equal(a_, b_):
        if isinstance(a_, dict):
            return sorted(a_) == sorted(b_) and all(equal(a_[k], b_[k]) for k in a_)
        return all(torch.equal(x_, y_) for x_, y_ in zip(a_, b_))

    def run_mesh(name, fn, args, want, fwd, inv, ct_mul=0):
        """fn(*args) on the mesh between a reset and a read of the counts,
        which must be Dd times the unsharded call's ({n: calls}); its
        output unsharded == want over every column."""
        got = unshard(run_by_n("3g", name, fn, *args, fwd={k: Dd * v for k, v in fwd.items()},
                               inv={k: Dd * v for k, v in inv.items()}, ct_mul=Dd * ct_mul))
        if not equal(got, want):
            raise AssertionError(f"phase 3g {name}: mesh != unsharded over all {B} columns")
        return got

    sf, si = step_calls["ntt_fwd"], step_calls["ntt_inv"]
    step_mesh = bb.build_step(hint, mesh=rd_mesh)
    step_blocks = shard(c0, c1, d0, d1)
    out = run_mesh("step lsd n16384", step_mesh, step_blocks, (e0, e1), {n: sf}, {n: si}, nrns)
    decrypts_to("mesh step lsd", BatchedBGV(p2, dev).build_decrypt(
        she.SK(p2, sk.s_ints, sk.var), f=bb.step_f())(*out), pt_muls(m1, m2, params))
    cm, dm = enc_msd(m1, nk()), enc_msd(m2, nk())
    out = run_mesh("step msd n16384", bb.build_step(hint, "msd", rd_mesh), shard(*cm, *dm),
                   step_msd(*cm, *dm), {n: sf}, {n: si}, nrns)
    decrypts_to("mesh step msd", dec_msd(*out), pt_muls(m1, m2, params))
    del cm, dm
    for e in ("lsd", "msd"):
        out = run_mesh(f"mod_switch {e}", bb8.build_mod_switch(e, rd_mesh), shard(*c8[e][0]),
                       bb8.build_mod_switch(e)(*c8[e][0]), {n8: 2 * (nrns - 1)}, {n8: 2})
        decrypts_to(f"mesh mod_switch {e}", bb8d.build_decrypt(
            sk8d, f=bb8.mod_switch_f(1) if e == "lsd" else 1, encoding=e)(*out), a8.cpu())
        out = run_mesh(f"step_ext {e}", bb8.build_step_ext(quad_ext, e, rd_mesh),
                       shard(*c8[e][0], *c8[e][1]), ext[e], {n8: ks_fwd + 2 * (Lb - 1)},
                       {n8: ks_inv + 2}, Lb)
        decrypts_to(f"mesh step_ext {e}", bb8d.build_decrypt(
            sk8d, f=bb8.step_f(1, 1, e), encoding=e)(*out), pt_muls(a8, b8, params8))
        out = run_mesh(f"key_switch_linear_ext {e}", bb8.build_key_switch_linear_ext(
            lin_ext, rd_mesh), shard(*c8[e][0]), ksl_ext[e], {n8: ks_fwd}, {n8: ks_inv})
        decrypts_to(f"mesh key_switch_linear_ext {e}",
                    bb8.build_decrypt(sk8_new, encoding=e)(*out), a8.cpu())
    out = run_mesh("key_switch_linear", bb8.build_key_switch_linear(lin_hint, rd_mesh),
                   shard(*c8["lsd"][0]), ksl(*c8["lsd"][0]), {n8: nrns * (nrns - 1)},
                   {n8: nrns})
    decrypts_to("mesh key_switch_linear", bb8.build_decrypt(sk8_new)(*out), a8.cpu())
    outs_mesh = run_mesh("galois_many", bb.build_galois_many(ghints, rd_mesh), shard(*ct_gal),
                         gal_many(*ct_gal), {n: rot_fwd}, {n: rot_inv})
    for k in ks:
        decrypts_to(f"mesh galois k={k}", dec_gal(*outs_mesh[k]),
                    np.stack([she.galois_ints(m, mg[:, c].cpu().numpy(), k, p)
                              for c in range(8)], -1))
    del outs_mesh
    # the tunnel over the mesh's data-only view, as the reference shards it
    tun_mesh = bb.build_tunnel(th, d_mesh)
    tun_blocks = shard(*ct, on=d_mesh)
    out = run_mesh("tunnel (data-only)", tun_mesh, tun_blocks, (t0, t1),
                   {m // 4: tunnel_calls["ntt_fwd"]}, {n: tunnel_calls["ntt_inv"]})
    decrypts_to("mesh tunnel", bb.target_pipeline(th).build_decrypt(sk_s)(*out),
                np.stack([linear.eval_lin_ints(fmap, mt[:, k].cpu().numpy(), p) for k in range(8)], -1))
    for e in ("lsd", "msd"):
        out = run_mesh(f"step {e} m=18432", bb_g.build_step(hint_g, e, rd_mesh),
                       shard(*ct_g[e][0], *ct_g[e][1]), step_g[e](*ct_g[e][0], *ct_g[e][1]),
                       {n2_g: sf}, {n2_g: si}, nrns)
        decrypts_to(f"mesh step {e} m=18432", bb_gd.build_decrypt(
            sk_gd, f=bb_g.step_f(1, 1, e), encoding=e)(*out), pt_muls(a_g, b_g, params_g))
    fw, iv, cm_ = pt_round_calls(L_pr, n)
    out = run_mesh("pt_round", serving.build_pt_round(bb_pr, rh, mesh=rd_mesh)[0], shard(*ct_pr),
                   y_pr, fw, iv, cm_)
    got = bb_pr_out.build_decrypt(she.SK(bb_pr_out.params, sk_pr.s_ints, sk_pr.var), f=f_pr)(*out)
    if not torch.equal(got[0, :8].long(), (2 * vals[:8].long() * 2 + pr_p) // (2 * pr_p) % 2):
        raise AssertionError(f"mesh pt_round: decrypt {got[0, :8].tolist()}")
    out = run_mesh("homom_prf", lambda *c_: serving.batched_homom_prf_component(
        fam, hints, bb_top, *c_, bits, 0, mesh=rd_mesh)[2], shard(*ct_prf), y_prf, *prf_calls)
    got = bb_prf_out.build_decrypt(she.SK(bb_prf_out.params, sk_out.s_ints, sk_out.var),
                                   f=f_prf)(*out)
    if got[0, :8].tolist() != [int(prf.prf_ints(fam, s_key[:, 0].cpu().numpy(), bits, 2)[0][0])] * 8:
        raise AssertionError(f"mesh homom_prf: decrypt {got[0, :8].tolist()}")
    mark(f"phase 3g: every mesh builder over {rd_mesh.shape} == its unsharded run over all {B} "
         f"columns, decrypts == the plaintexts; launches {path_launches['3g']}")
    # the rates, in interleaved windows: the step and the tunnel over the
    # mesh and unsharded, on the inputs checked above; and the device time
    # of the mesh calls' layout copies
    mesh_rates = steptime.mesh_ab(step, step_mesh, [c0, c1, d0, d1], step_blocks, tun, tun_mesh,
                                  list(ct), tun_blocks)
    mesh_copies = {arm: steptime.copies(fn_, a_) for arm, fn_, a_ in (
        ("mesh_step", step_mesh, step_blocks), ("mesh_tunnel", tun_mesh, tun_blocks))}
    del step_blocks, tun_blocks, out
    # (b) the CRT-set slot maps: HomomPRF at p = 257 down 256 -> 128 with
    # maps="slots" (the slot map built on the host), BaseBGad(16),
    # balanced(2), B different keys; each of the ell components decrypts
    # to the slot map applied to the clear s * A_T(x), columns 0-7, and
    # equals the CPU's over columns 0-15.  Launches per component: the
    # public product's L forwards at n = 128 (an (n, 1) plaintext), the
    # tunnel's 2 L inverses at 128 and d L + d L^2 forwards at 64.
    m_sl, p_sl, bits_sl = 256, 257, (0, 1)
    qs_sl = tuple(nt.ntt_primes(m_sl, 30, 3))
    L_sl, n_sl = len(qs_sl), m_sl // 2
    rings_sl = [m_sl, m_sl // 2]
    sks_sl = [she.gen_sk(she.SHEParams(m=r, p=p_sl, qs=qs_sl, var=2.0), nk()) for r in rings_sl]
    fam_sl = prf.PRFFamily.random(ring_context(m_sl, (p_sl,)), gadget.BaseBGad(16), prf.balanced(2), nk())
    t_host = time.time()
    hints_sl, sk_sl = run_recorded("3g_slots", "make_eval_hints slots", lambda: prf.make_eval_hints(
        fam_sl, sks_sl, rings_sl, rings_sl[1:], gadget.RnsGad(), nk(), p_final=p_sl, maps="slots",
        device=dev))
    t_host = time.time() - t_host
    lin_sl = hints_sl.tunnels[0].lin
    print(f"slot map {m_sl} -> {m_sl // 2} at p = {p_sl}: hints (the slot map on the host, "
          f"{lin_sl.d} images) in {t_host:.2f} s", flush=True)
    keys_sl = torch.randint(0, p_sl, (n_sl, B), generator=g, device=dev, dtype=torch.int32)
    bb_sl = BatchedBGV(sks_sl[0].params, dev)
    ct_sl = bb_sl.build_encrypt(sks_sl[0])(keys_sl, nk())
    ell_sl = gadget.num_digits(fam_sl.spec, fam_sl.ctx.basis)
    for i in range(ell_sl):
        bb_o, f_o, y_sl = run_by_n(
            "3g_slots", f"homom_prf slots component {i}",
            lambda: serving.batched_homom_prf_component(fam_sl, hints_sl, bb_sl, *ct_sl,
                                                        bits_sl, i),
            fwd={n_sl: L_sl, n_sl // 2: lin_sl.d * (L_sl + L_sl ** 2)}, inv={n_sl: 2 * L_sl})
        got = bb_o.build_decrypt(sk_sl, f=f_o)(*y_sl)
        decrypts_to(f"homom_prf slots component {i}", got, np.stack([linear.eval_lin_ints(
            lin_sl, prf.prf_pre_round_ints(fam_sl, keys_sl[:, k].cpu().numpy(), bits_sl)[i], p_sl)
            for k in range(8)], -1))
        same_on_cpu(f"homom_prf slots component {i}", y_sl,
                    lambda c0_, c1_, i=i: serving.batched_homom_prf_component(
                        fam_sl, hints_sl, BatchedBGV(bb_sl.params, "cpu"), c0_, c1_, bits_sl,
                        i)[2], *ct_sl, ncols=16)
    mark(f"phase 3g: HomomPRF {m_sl} -> {m_sl // 2}, p = {p_sl}, maps=slots, {ell_sl} "
         f"components, B = {B}: decrypts == the slot map of the clear s * A_T(x); GPU == CPU "
         f"over columns 0-15; launches {path_launches['3g_slots']}")

    # -- phase 3h: the object path (she over Cyc) at full width ----------
    # Every object call runs between a reset and a read of the counts.  A
    # shim around ntt_cm and ct_mul_cm records each call; the card must
    # launch cm_schedule(n)'s passes for every transform called and one
    # ct_mul per channel product, and nothing else.  A deterministic call
    # runs first on CPU copies (the plain versions), and the card must make
    # the same calls and give the same output bit for bit; where a closed
    # form is known (encrypt, hints, the step, decrypt, the tunnel) the
    # calls must equal it too.  Keygen and encryption are checked here by
    # decryption; phase 3j holds the card's draws against the CPU's.
    obj_calls = Counter()
    real_ntt, real_ctm = ring_mod.ntt_cm, she.ct_mul_cm

    def ntt_shim(x_, plan_, inverse=False, pre_digit_q=None, alg="gs"):
        obj_calls["ntt_inv" if inverse else "ntt_fwd", x_.shape[0]] += 1
        return real_ntt(x_, plan_, inverse, pre_digit_q, alg)

    def ctm_shim(*a_, **k_):
        obj_calls["ct_mul", 0] += 1
        return real_ctm(*a_, **k_)

    ring_mod.ntt_cm = gen.ntt_cm = ntt_shim
    she.ct_mul_cm = ctm_shim

    def to_dev(x_, device):
        """A Cyc, an object CT, a hint or a hint bundle with its tensors on
        device."""
        if isinstance(x_, Cyc):
            return Cyc(x_.ctx, x_.rep, x_.data.to(device))
        if isinstance(x_, torch.Tensor):
            return x_.to(device)
        if isinstance(x_, (tuple, list)):
            return type(x_)(to_dev(y_, device) for y_ in x_)
        if isinstance(x_, (she.KSHint, she.KSHintExt, she.TunnelHint, she.PTRoundHints,
                           prf.EvalHints)):
            return dc_replace(x_, **{f_.name: to_dev(getattr(x_, f_.name), device)
                                     for f_ in dc_fields(x_)})
        if isinstance(x_, she.CT):
            return dc_replace(x_, cs=tuple(to_dev(c_, device) for c_ in x_.cs))
        return x_

    def same_obj(name, a_, b_):
        """Card and CPU outputs (Cyc, CT, tensors or tuples of them) equal."""
        if isinstance(a_, (tuple, list)):
            for x_, y_ in zip(a_, b_):
                same_obj(name, x_, y_)
            return
        if isinstance(a_, np.ndarray):
            ok = np.array_equal(a_, b_)
        elif isinstance(a_, torch.Tensor):
            ok = torch.equal(a_.cpu(), b_.cpu())
        elif isinstance(a_, Cyc):
            ok = a_.ctx == b_.ctx and a_.rep is b_.rep and torch.equal(a_.data.cpu(), b_.data)
        else:
            ok = ((a_.params, a_.ctx, a_.f, a_.encoding) == (b_.params, b_.ctx, b_.f, b_.encoding)
                  and len(a_.cs) == len(b_.cs))
            for x_, y_ in zip(a_.cs, b_.cs):
                same_obj(name, x_, y_)
        if not ok:
            raise AssertionError(f"phase 3h {name}: card != CPU")

    def obj_run(name, fn, cpu_fn=None, want=None):
        """fn() on the card, checked as the phase's comment says; cpu_fn()
        its CPU shadow (the same call on CPU copies)."""
        cpu = None
        if cpu_fn is not None:
            obj_calls.clear()
            cpu = cpu_fn()
            cpu_calls = dict(obj_calls)
        obj_calls.clear()
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        got = counts()
        calls = dict(obj_calls)
        if cpu_fn is not None and calls != cpu_calls:
            raise AssertionError(f"phase 3h {name}: card calls {calls} != CPU calls {cpu_calls}")
        if want is not None and calls != {k: v for k, v in want.items() if v}:
            raise AssertionError(f"phase 3h {name}: calls {calls}, want {want}")
        want_l = dict.fromkeys(got, 0)
        for (kind, n_), k in calls.items():
            want_l[kind] += k if kind == "ct_mul" else k * len(tk.cm_schedule(n_))
        if got != want_l:
            raise AssertionError(f"phase 3h {name}: launches {got}, want {want_l}")
        for k, v in got.items():
            path_launches["3h"][k] += v
        if cpu_fn is not None:
            same_obj(name, out, cpu)
        return out

    def col_ct(prm, c0_, c1_, k, f=1, enc_="lsd"):
        """Column k of packed (nrns, n, B) CRT components as an object CT."""
        ctx_ = prm.ctx
        return she.CT(prm, ctx_, tuple(Cyc(ctx_, Rep.CRT, c_[..., k].contiguous())
                                      for c_ in (c0_, c1_)), f, enc_)

    def step_calls_obj(L, n_):
        """ct_mul + key_switch_quad_circ + mod_switch on degree-1 CRT
        operands: L ct_mul, the L digits' L forwards each, c2's and the two
        rescaled components' inverses."""
        return {("ct_mul", 0): L, ("ntt_fwd", n_): L * L, ("ntt_inv", n_): 3 * L}

    def dec_calls(L, n_, pow_comps=False):
        """decrypt: s into the CRT basis, c(s) back (and, after a modulus
        switch, the two powerful-basis components into the CRT basis)."""
        return {("ntt_fwd", n_): 3 * L if pow_comps else L, ("ntt_inv", n_): L}

    def tunnel_calls_obj(L, d, n_r, n_s):
        """she.tunnel: both components inverse-transformed over R; over S
        eval_lin's d images and embedded coefficients, and the d L digits
        of c1's coefficients."""
        return {("ntt_inv", n_r): 2 * L, ("ntt_fwd", n_s): 2 * d * L + d * L * L}

    def hint_calls(L, ell, n_):
        """_ks_hint (and ks_quad_circ_hint's s): s twice, and per gadget
        entry the error's and the scalar's transforms."""
        return {("ntt_fwd", n_): 2 * L + 2 * ell * L}

    # (a) ring identities, card == CPU, at m = 32768 and 18432, each with
    # its half ring
    for m_a, qs_a in ((m, params.qs), (m_g, params_g.qs)):
        ctx_a = ring_context(m_a, qs_a)
        sub_a = ctx_a.child(m_a // 2)
        n_t = ctx_a.n if ctx_a.fm.is_pow2() else ctx_a.fm.phi_shape[0]  # the NTT's length
        rng_a = np.random.default_rng(SEED + m_a)
        x_a = np.stack([rng_a.integers(0, q, ctx_a.n) for q in qs_a])
        xs_a = np.stack([rng_a.integers(0, q, sub_a.n) for q in qs_a])
        X, Xs = torch.from_numpy(x_a.astype(np.int32)), torch.from_numpy(xs_a.astype(np.int32))
        L_a = len(qs_a)
        ring_checks = {
            "crt": (lambda t: ring_mod.crt(ctx_a, t), {("ntt_fwd", n_t): L_a}, X),
            "crt_inv o crt": (lambda t: ring_mod.crt_inv(ctx_a, ring_mod.crt(ctx_a, t)),
                              {("ntt_fwd", n_t): L_a, ("ntt_inv", n_t): L_a}, X),
            "l": (lambda t: ring_mod.l(ctx_a, t), {}, X),
            "l_inv o l": (lambda t: ring_mod.l_inv(ctx_a, ring_mod.l(ctx_a, t)), {}, X),
            "twace o embed pow": (lambda t: ring_mod.twace_pow(ctx_a, sub_a, ring_mod.embed_pow(
                sub_a, ctx_a, t)), {}, Xs),
            "twace o embed crt": (lambda t: ring_mod.twace_crt(ctx_a, sub_a, ring_mod.embed_crt(
                sub_a, ctx_a, t)), {}, Xs),
        }
        for b_ in ("pow", "dec", "crt"):
            mul_, div_ = getattr(ring_mod, f"mul_g_{b_}"), getattr(ring_mod, f"div_g_{b_}")
            ring_checks[f"mul_g_{b_}"] = (lambda t, f_=mul_: f_(ctx_a, t), {}, X)
            ring_checks[f"div_g o mul_g {b_}"] = (
                lambda t, f_=mul_, h_=div_: h_(ctx_a, f_(ctx_a, t)), {}, X)
        for name, (fn_, want_, inp) in ring_checks.items():
            got = obj_run(f"{name} m={m_a}", lambda: fn_(inp.to(dev)), lambda: fn_(inp), want_)
            if name.startswith(("crt_inv", "l_inv", "div_g", "twace")) and not torch.equal(
                    got.cpu(), inp):
                raise AssertionError(f"phase 3h: {name} at m = {m_a} is not the identity")
        # coeffs against pow_basis: x = sum_rel b_rel embed(a_rel)
        def recon(device):
            c_ = Cyc.from_pow(ctx_a, X, device)
            acc = Cyc.zero(ctx_a, device=device, rep=Rep.CRT)
            for b_rel, a_rel in zip(Cyc.rel_pow_basis(ctx_a, sub_a, device), c_.coeffs(sub_a)):
                acc = acc + b_rel * a_rel.embed(ctx_a)
            return acc.to_pow()
        d_a = ctx_a.n // sub_a.n
        got = obj_run(f"coeffs vs pow_basis m={m_a}", lambda: recon(dev), lambda: recon("cpu"),
                      {("ntt_fwd", n_t): 2 * d_a * L_a, ("ntt_inv", n_t): L_a})
        if not torch.equal(got.data.cpu(), X):
            raise AssertionError(f"phase 3h: sum b_rel embed(coeffs) != x at m = {m_a}")
    mark(f"phase 3h: ring identities at m = {m} and {m_g}: card == CPU bit for bit, every "
         f"identity holds; launches {path_launches['3h']}")

    # (b) the Quick start at m = 8192, and she_demo's flow at m = 32768 (the
    # phase-3 ring and key) with a base-b, a trivial-gadget (extended
    # modulus, 4 special primes) and an RNS extended key switch, sigma_5,
    # and an MSD round trip
    def demo(prm, sk_o, tag, full):
        g_o, rng_o = prng.KeyChain(SEED + 80 + prm.m), np.random.default_rng(SEED + 80 + prm.m)
        L_, n_o = len(prm.qs), prm.ctx.n
        a_m, b_m = (she.pt_random(prm, rng_o).cpu().numpy() for _ in range(2))
        ca = obj_run(f"{tag} encrypt", lambda: she.encrypt(sk_o, a_m, g_o(), dev),
                     want={("ntt_fwd", n_o): 2 * L_})
        cb = obj_run(f"{tag} encrypt", lambda: she.encrypt(sk_o, b_m, g_o(), dev),
                     want={("ntt_fwd", n_o): 2 * L_})

        def decrypts(name, ct_, want_, sk_=sk_o, calls=None):
            got_ = obj_run(f"{tag} decrypt {name}", lambda: she.decrypt(sk_, ct_),
                           lambda: she.decrypt(sk_, to_dev(ct_, "cpu")), calls)
            np.testing.assert_array_equal(got_, want_, err_msg=f"{tag} {name}")

        decrypts("encrypt", ca, a_m, calls=dec_calls(L_, n_o))
        s_add = obj_run(f"{tag} ct_add", lambda: she.ct_add(ca, cb),
                        lambda: she.ct_add(to_dev(ca, "cpu"), to_dev(cb, "cpu")), {})
        decrypts("ct_add", s_add, she.pt_add(prm, a_m, b_m), calls=dec_calls(L_, n_o))
        prod = obj_run(f"{tag} ct_mul", lambda: she.ct_mul(ca, cb),
                       lambda: she.ct_mul(to_dev(ca, "cpu"), to_dev(cb, "cpu")),
                       {("ct_mul", 0): L_})
        want_ab = she.pt_mul(prm, a_m, b_m)
        hint_o = obj_run(f"{tag} ks_quad_circ_hint", lambda: she.ks_quad_circ_hint(
            sk_o, gadget.RnsGad(), g_o(), dev), want=hint_calls(L_, L_, n_o))
        rel = obj_run(f"{tag} key_switch_quad_circ", lambda: she.key_switch_quad_circ(hint_o, prod),
                      lambda: she.key_switch_quad_circ(hint_o, to_dev(prod, "cpu")),
                      {("ntt_inv", n_o): L_, ("ntt_fwd", n_o): L_ * L_})
        decrypts("key switch", rel, want_ab)
        small = obj_run(f"{tag} mod_switch", lambda: she.mod_switch(rel),
                        lambda: she.mod_switch(to_dev(rel, "cpu")), {("ntt_inv", n_o): 2 * L_})
        decrypts("mod_switch", small, want_ab, she.SK(small.params, sk_o.s_ints, sk_o.var),
                 dec_calls(L_ - 1, n_o, pow_comps=True))
        if not full:
            return ca, cb, a_m, b_m, hint_o
        ell_b = gadget.num_digits(gadget.BaseBGad(1 << 16), prm.ctx.basis)
        hb = obj_run(f"{tag} ks_quad_circ_hint BaseBGad", lambda: she.ks_quad_circ_hint(
            sk_o, gadget.BaseBGad(1 << 16), g_o(), dev), want=hint_calls(L_, ell_b, n_o))
        decrypts("key switch BaseBGad", obj_run(
            f"{tag} key_switch BaseBGad", lambda: she.key_switch_quad_circ(hb, prod),
            lambda: she.key_switch_quad_circ(hb, to_dev(prod, "cpu")),
            {("ntt_inv", n_o): L_, ("ntt_fwd", n_o): ell_b * L_}), want_ab)
        for spec_, nsp in ((gadget.TrivGad(), 4), (gadget.RnsGad(), 2)):
            special_o = tuple(nt.ntt_primes(prm.m, 30, L_ + nsp)[L_:])
            Lx, ell_x = L_ + nsp, gadget.num_digits(spec_, prm.ctx.basis)
            hx = obj_run(f"{tag} ks_quad_circ_hint_ext {spec_}", lambda: she.ks_quad_circ_hint_ext(
                sk_o, spec_, g_o(), special_o, dev),
                want={("ntt_fwd", n_o): L_ + 2 * Lx + 2 * ell_x * Lx, ("ntt_inv", n_o): L_})
            decrypts(f"ext key switch {spec_}", obj_run(
                f"{tag} key_switch_quad_circ_ext {spec_}",
                lambda: she.key_switch_quad_circ_ext(hx, prod),
                lambda: she.key_switch_quad_circ_ext(hx, to_dev(prod, "cpu")),
                {("ntt_inv", n_o): L_ + 2 * Lx, ("ntt_fwd", n_o): ell_x * Lx + 2 * L_}), want_ab)
        hg = obj_run(f"{tag} ks_galois_hint k=5", lambda: she.ks_galois_hint(
            5, sk_o, gadget.RnsGad(), g_o(), dev), want=hint_calls(L_, L_, n_o))
        decrypts("ct_galois k=5", obj_run(f"{tag} ct_galois k=5", lambda: she.ct_galois(hg, 5, ca),
                                          lambda: she.ct_galois(hg, 5, to_dev(ca, "cpu")),
                                          {("ntt_inv", n_o): L_, ("ntt_fwd", n_o): L_ * L_}),
                 she.galois_ints(prm.m, a_m, 5, prm.p))
        cm_ = obj_run(f"{tag} encrypt_msd", lambda: she.encrypt_msd(sk_o, a_m, g_o(), dev),
                      want={("ntt_fwd", n_o): 2 * L_})
        decrypts("msd", cm_, a_m)
        decrypts("to_lsd", obj_run(f"{tag} to_lsd", lambda: she.to_lsd(cm_),
                                   lambda: she.to_lsd(to_dev(cm_, "cpu")), {}), a_m)
        decrypts("to_msd", obj_run(f"{tag} to_msd", lambda: she.to_msd(ca),
                                   lambda: she.to_msd(to_dev(ca, "cpu")),
                                   {("ntt_fwd", n_o): L_}), a_m)
        return ca, cb, a_m, b_m, hint_o

    params_q = she.SHEParams(m=8192, p=257, qs=tuple(nt.ntt_primes(8192, 30, 3)))
    demo(params_q, she.gen_sk(params_q, nk()), "quick start m=8192", full=False)
    ca_o, cb_o, am_o, bm_o, hint_o = demo(params, sk, f"she_demo m={m}", full=True)
    mark(f"phase 3h: the Quick start at m = 8192 and she_demo's flow at m = {m} (BaseBGad, "
         f"TrivGad over Q P, ext RNS, sigma_5, MSD): every decryption == its plaintext; "
         f"launches {path_launches['3h']}")

    # (c) object path == batched path, columns 0-7, on earlier phases' inputs
    f2 = bb.step_f()
    for col in range(8):
        a_c, b_c = col_ct(params, c0, c1, col), col_ct(params, d0, d1, col)
        out_c = obj_run(f"step column {col}", lambda: she.mod_switch(
            she.key_switch_quad_circ(hint, she.ct_mul(a_c, b_c))),
            lambda: she.mod_switch(she.key_switch_quad_circ(hint, she.ct_mul(
                to_dev(a_c, "cpu"), to_dev(b_c, "cpu")))), step_calls_obj(nrns, n))
        if out_c.f != f2 or not all(torch.equal(c_.to_crt().data, e_[..., col]) for c_, e_ in
                                     zip(out_c.cs, (e0, e1))):
            raise AssertionError(f"phase 3h: object step != batched step, column {col}")
    for col in range(8):
        t_c = col_ct(params, *ct, col)
        out_c = obj_run(f"tunnel column {col}", lambda: she.tunnel(th, t_c),
                        lambda: she.tunnel(th, to_dev(t_c, "cpu")),
                        tunnel_calls_obj(nrns, th.lin.d, n, th.lin.s_ctx.n))
        if out_c.ctx != th.lin.s_ctx or not all(torch.equal(c_.data, e_[..., col]) for c_, e_ in
                                                 zip(out_c.cs, (t0, t1))):
            raise AssertionError(f"phase 3h: object tunnel != build_tunnel, column {col}")
    step_out_g = step_g["lsd"](*ct_g["lsd"][0], *ct_g["lsd"][1])
    for col in range(8):
        a_c, b_c = (col_ct(params_g, *x_, col) for x_ in ct_g["lsd"])
        out_c = obj_run(f"general step column {col}", lambda: she.mod_switch(
            she.key_switch_quad_circ(hint_g, she.ct_mul(a_c, b_c))),
            lambda: she.mod_switch(she.key_switch_quad_circ(hint_g, she.ct_mul(
                to_dev(a_c, "cpu"), to_dev(b_c, "cpu")))), step_calls_obj(nrns, n2_g))
        if out_c.f != bb_g.step_f() or not all(torch.equal(c_.to_crt().data, e_[..., col])
                                               for c_, e_ in zip(out_c.cs, step_out_g)):
            raise AssertionError(f"phase 3h: object general step != batched, column {col}")
    key_ct = col_ct(sks[0].params, *ct_prf, 0)
    out_prf = obj_run("homom_prf_component", lambda: prf.homom_prf_component(
        fam, hints, key_ct, bits, 0), lambda: prf.homom_prf_component(
        fam, hints, to_dev(key_ct, "cpu"), bits, 0))
    if (out_prf.params.m, out_prf.params.p, out_prf.f) != (2, 2, f_prf) or not all(
            torch.equal(c_.to_crt().data, e_[..., 0]) for c_, e_ in zip(out_prf.cs, y_prf)):
        raise AssertionError("phase 3h: object homom_prf_component != batched column 0")
    ring_mod.ntt_cm = gen.ntt_cm = real_ntt
    she.ct_mul_cm = real_ctm
    mark(f"phase 3h: object == batched bit for bit: the step (columns 0-7), the tunnel "
         f"{m} -> {m // 2}, the general step at {m_g}, HomomPRF {m} -> 2 (column 0); "
         f"launches {path_launches['3h']}")
    # -- phase 3i: persistence, the challenges, the debug guards, two processes
    # Every card call runs between a reset and a read of the counts, which
    # must be exactly what it launches (`run_3i`); io writes and reads
    # without a launch, since every hint row is a CRT stack and every
    # object-path ciphertext CRT.
    import shutil
    import tempfile

    from lol_tpu_torch import io as lio
    from lol_tpu_torch.challenges import ChallengeParams, LocalBeacon
    from lol_tpu_torch.challenges import driver as chd
    from lol_tpu_torch.ops import debug as dbg
    from lol_tpu_torch.parallel import multihost_check
    from lol_tpu_torch.proto import wire as pb

    def passes(n_):
        return len(tk.cm_schedule(n_))

    def run_3i(name, fn, want=None):
        """fn() between a reset and a read of the counts, which must be want
        ({counter: launches}) and nothing else; want=None records them."""
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        got = counts()
        full = dict.fromkeys(got, 0)
        full.update(want or {})
        if want is not None and got != full:
            raise AssertionError(f"phase 3i {name}: launches {got}, want {full}")
        for k_, v_ in got.items():
            path_launches["3i"][k_] += v_
        return out if want is not None else (out, got)

    # (a) persistence at full width: each bundle written from the card and
    # from CPU copies (the same bytes), read back onto the card (io's default
    # device; no launch), and written again from what was read (the same bytes)
    cm_o = she.encrypt_msd(sk, am_o, nk(), dev)
    bundles = {
        "sk": (lio.sk_to_proto, lio.sk_from_proto, pb.SecretKey, sk),
        "ct_lsd": (lio.ct_to_proto, lio.ct_from_proto, pb.SHECiphertext, ca_o),
        "ct_msd": (lio.ct_to_proto, lio.ct_from_proto, pb.SHECiphertext, cm_o),
        "step_hint": (lio.ks_hint_to_proto, lio.ks_hint_from_proto, pb.KSHint, hint),
        "ext_hint": (lio.ks_hint_ext_to_proto, lio.ks_hint_ext_from_proto, pb.KSHintExt, quad_ext),
        "tunnel_hint": (lio.tunnel_hint_to_proto, lio.tunnel_hint_from_proto, pb.TunnelHint, th),
        "pt_round_hints": (lio.pt_round_hints_to_proto, lio.pt_round_hints_from_proto,
                           pb.PTRoundHints, rh),
        "eval_hints": (lio.eval_hints_to_proto, lio.eval_hints_from_proto, pb.EvalHints, hints),
    }
    loaded, io_stats = {}, {}
    for name, (to_p, from_p, cls, obj) in bundles.items():
        torch.cuda.synchronize()
        t = time.perf_counter()
        data = to_p(obj).SerializeToString()
        t_w = time.perf_counter() - t
        if to_p(to_dev(obj, "cpu")).SerializeToString() != data:
            raise AssertionError(f"phase 3i: {name} written from the card != from CPU copies")
        t = time.perf_counter()
        loaded[name] = run_3i(f"read {name}", lambda: from_p(cls.FromString(data)), {})
        t_r = time.perf_counter() - t
        if to_p(loaded[name]).SerializeToString() != data:
            raise AssertionError(f"phase 3i: {name} read back != written")
        io_stats[name] = {"MB": len(data) / 1e6, "write_ms": t_w * 1e3, "read_ms": t_r * 1e3}
        print(f"persistence {name}: {len(data) / 1e6:.3f} MB, write {t_w * 1e3:.2f} ms, "
              f"read {t_r * 1e3:.2f} ms", flush=True)
    if loaded["step_hint"].h0.device.type != dev.type:  # io's default device is the card
        raise AssertionError("phase 3i: a hint read with device=None is not on the card")
    L_o, n_o = len(params.qs), params.ctx.n
    for name, want_m in (("ct_lsd", am_o), ("ct_msd", am_o)):
        got = run_3i(f"decrypt reloaded {name}", lambda: she.decrypt(loaded["sk"], loaded[name]),
                     {"ntt_fwd": L_o * passes(n_o), "ntt_inv": L_o * passes(n_o)})
        np.testing.assert_array_equal(got, want_m, err_msg=f"reloaded {name}")
    # the reloaded hints against the originals' outputs, columns 0-7
    first8 = slice(0, 8)
    cols8 = [t_[..., first8].contiguous() for t_ in (c0, c1, d0, d1)]
    out = run_3i("step (reloaded hint)", lambda: bb.build_step(loaded["step_hint"])(*cols8),
                 {"ntt_fwd": step_calls["ntt_fwd"] * passes(n),
                  "ntt_inv": step_calls["ntt_inv"] * passes(n), "ct_mul": nrns})
    if not all(torch.equal(a_, b_[..., first8]) for a_, b_ in zip(out, (e0, e1))):
        raise AssertionError("phase 3i: the step on the reloaded hint != the original's")
    cx = [t_[..., first8].contiguous() for t_ in (*c8["lsd"][0], *c8["lsd"][1])]
    out = run_3i("ext step (reloaded hint)", lambda: bb8.build_step_ext(loaded["ext_hint"])(*cx),
                 {"ntt_fwd": (ks_fwd + 2 * (Lb - 1)) * passes(n8),
                  "ntt_inv": (ks_inv + 2) * passes(n8), "ct_mul": Lb})
    if not all(torch.equal(a_, b_[..., first8]) for a_, b_ in zip(out, ext["lsd"])):
        raise AssertionError("phase 3i: the ext step on the reloaded hint != the original's")
    out = run_3i("tunnel (reloaded hint)", lambda: bb.build_tunnel(loaded["tunnel_hint"])(
        *(t_[..., first8].contiguous() for t_ in ct)),
        {"ntt_fwd": tunnel_calls["ntt_fwd"] * passes(th.lin.s_ctx.n),
         "ntt_inv": tunnel_calls["ntt_inv"] * passes(n)})
    if not all(torch.equal(a_, b_[..., first8]) for a_, b_ in zip(out, (t0, t1))):
        raise AssertionError("phase 3i: the tunnel on the reloaded hint != the original's")
    prf_orig, l_orig = run_3i("homom_prf_component (original hints)",
                              lambda: prf.homom_prf_component(fam, hints, key_ct, bits, 0))
    prf_back, l_back = run_3i("homom_prf_component (reloaded hints)",
                              lambda: prf.homom_prf_component(fam, loaded["eval_hints"], key_ct,
                                                              bits, 0))
    if l_back != l_orig or not l_orig["ntt_fwd"] or not all(
            torch.equal(a_.data, b_.data) and torch.equal(a_.data, c_.data)
            for a_, b_, c_ in zip(prf_back.cs, prf_orig.cs, out_prf.cs)):
        raise AssertionError("phase 3i: homom_prf_component on the reloaded hints != original")
    mark(f"phase 3i: persistence: {len(bundles)} bundles, card bytes == CPU bytes, reloaded "
         f"onto the card; step, ext step, tunnel (columns 0-7) and homom_prf_component "
         f"(column 0) == the originals bit for bit; launches {path_launches['3i']}")

    # (b) the challenges at the repo's rings, 8 instances each, svar = 4:
    # generate on the card (and the same seeds on the CPU: the same bytes),
    # suppress with LocalBeacon, verify; two corruptions caught; the CLI
    os.makedirs(os.path.join(ROOT, "_scratch"), exist_ok=True)  # gitignored, removed below
    work = tempfile.mkdtemp(prefix="chall_", dir=os.path.join(ROOT, "_scratch"))
    q_c, q_cg = nt.ntt_primes(m, 30, 1)[0], nt.ntt_primes(m_g, 30, 1)[0]
    n_cg = ring_context(m_g, (q_cg,)).fm.phi_shape[0]  # the general ring's NTT length
    n_c = m // 2
    chall = [ChallengeParams(0, m, q_c, 4.0, 8, "disc", beacon_epoch=1201),
             ChallengeParams(1, m, q_c, 4.0, 8, "cont", beacon_epoch=1202, beacon_offset=16),
             ChallengeParams(2, m, q_c, 4.0, 8, "rlwr", qprime=257, beacon_epoch=1203),
             ChallengeParams(3, m_g, q_cg, 4.0, 8, "disc", beacon_epoch=1204)]
    gen_calls = {"disc": (2, 0), "cont": (1, 1), "rlwr": (1, 1)}  # per instance: fwd, inv
    for cp in chall:  # first-call set-up (plans, tables, the bounds) out of the timings
        chd.generate(os.path.join(work, "warm"), [dc_replace(cp, num_instances=1)], seed=SEED,
                     device=dev)
    def tree_files(root_):
        return sorted(os.path.relpath(os.path.join(dp, f_), root_)
                      for dp, _, fs in os.walk(root_) for f_ in fs)

    def same_tree(a_, b_):
        """The same files under both roots, byte for byte."""
        def read(p_):
            with open(p_, "rb") as fh:
                return fh.read()
        return tree_files(a_) == tree_files(b_) and all(
            read(os.path.join(a_, f_)) == read(os.path.join(b_, f_)) for f_ in tree_files(a_))

    chall_ms, roots = {}, {}
    for cp in chall:
        n_t = n_c if cp.m == m else n_cg
        fw, iv = gen_calls[cp.kind]
        roots[cp.challenge_id] = root_c = os.path.join(work, f"card{cp.challenge_id}")
        torch.cuda.synchronize()
        t = time.perf_counter()
        run_3i(f"generate {cp.kind} m={cp.m}", lambda: chd.generate(
            root_c, [cp], seed=SEED + cp.challenge_id, device=dev),
            {"ntt_fwd": fw * 8 * passes(n_t), "ntt_inv": iv * 8 * passes(n_t)})
        chall_ms[f"generate_{cp.kind}_m{cp.m}"] = (time.perf_counter() - t) * 1e3 / 8
        cpu_root = os.path.join(work, f"cpu{cp.challenge_id}")
        chd.generate(cpu_root, [cp], seed=SEED + cp.challenge_id, device="cpu")
        if len(tree_files(root_c)) != 17 or not same_tree(root_c, cpu_root):
            raise AssertionError(f"phase 3i: challenge {cp.challenge_id} on the card != on the CPU")
        chd.suppress(root_c)
        t = time.perf_counter()
        ok = run_3i(f"verify {cp.kind} m={cp.m}", lambda: chd.verify(root_c, device=dev),
                    {"ntt_fwd": 7 * passes(n_t), "ntt_inv": 7 * passes(n_t)})
        chall_ms[f"verify_{cp.kind}_m{cp.m}"] = (time.perf_counter() - t) * 1e3 / 7
        if ok is not True:
            raise AssertionError(f"phase 3i: challenge {cp.challenge_id} did not verify")
    print("challenges verify: OK", flush=True)
    # corruption 1: one disc instance's b moved by q / 2 in one decoding coefficient
    bad = os.path.join(work, "bad_b")
    shutil.copytree(roots[0], bad)
    d_bad = os.path.join(bad, "chall-id0000")
    iid = int(sorted(f_ for f_ in os.listdir(d_bad) if f_.endswith(".secret"))[0][9:12])
    f_bad = os.path.join(d_bad, f"instance-{iid:03d}.instance")
    with open(f_bad, "rb") as fh:
        inst = pb.InstanceDisc.FromString(fh.read())
    bump = np.zeros(n_c, dtype=np.int64)
    bump[0] = q_c // 2

    def moved():
        b_ = lio.cyc_from_proto(inst.b, device=dev)
        return lio.cyc_to_proto((b_.to_dec() + Cyc.from_ints(b_.ctx, bump, device=dev)).to_crt())

    inst.b = run_3i("move b past the bound", moved,
                    {"ntt_fwd": passes(n_c), "ntt_inv": passes(n_c)})
    with open(f_bad, "wb") as fh:
        fh.write(inst.SerializeToString())
    if run_3i("verify (b moved)", lambda: chd.verify(bad, device=dev),
              {"ntt_fwd": 7 * passes(n_c), "ntt_inv": 7 * passes(n_c)}) is not False:
        raise AssertionError("phase 3i: verify passed an instance whose error left its bound")
    # corruption 2: the held-out secret restored (from the CPU's unsuppressed copy)
    bad = os.path.join(work, "bad_secret")
    shutil.copytree(roots[1], bad)
    keep = LocalBeacon().bits(chall[1].beacon_epoch, chall[1].beacon_offset, 3) % 8
    name_ = f"instance-{keep:03d}.secret"
    shutil.copy(os.path.join(work, "cpu1", "chall-id0001", name_),
                os.path.join(bad, "chall-id0001", name_))
    if run_3i("verify (held-out secret restored)", lambda: chd.verify(bad, device=dev),
              {"ntt_fwd": 7 * passes(n_c), "ntt_inv": 7 * passes(n_c)}) is not False:
        raise AssertionError("phase 3i: verify passed a restored held-out secret")
    # the CLI, in subprocesses on the card
    pfile = os.path.join(work, "params.txt")
    with open(pfile, "w") as fh:
        fh.write(f"# id m q svar num kind [qprime] [epoch] [offset]\n0 {m} {q_c} 4.0 8 disc 0 1201\n")
    cli_root = os.path.join(work, "cli")
    env_cli = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p_ for p_ in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p_]))
    cli_out = []
    for args_ in (["generate", cli_root, "--params", pfile, "--seed", str(SEED)],
                  ["suppress", cli_root], ["verify", cli_root]):
        r_ = subprocess.run([sys.executable, "-m", "lol_tpu_torch.challenges.driver", *args_],
                            capture_output=True, text=True, cwd=ROOT, env=env_cli, timeout=300)
        cli_out.append(r_.stdout.strip())
        if r_.returncode != 0:
            raise AssertionError(f"phase 3i: CLI {args_[0]} exit {r_.returncode}:\n{r_.stdout}\n"
                                 f"{r_.stderr}")
    # the CLI's directory is challenge 0's (the same line and seed, suppressed alike)
    if cli_out[-1] != "verify: OK" or not same_tree(cli_root, roots[0]):
        raise AssertionError(f"phase 3i: CLI output {cli_out}, or its files != challenge 0's")
    shutil.rmtree(work)
    mark(f"phase 3i: challenges at m = {m} (disc, cont, rlwr q' = 257) and {m_g} (disc), 8 "
         f"instances each: verify OK, card bytes == CPU bytes, both corruptions caught, the CLI "
         f"{cli_out}; ms per instance {chall_ms}; launches {path_launches['3i']}")

    # (c) the debug guards on the step's channel (n = 2^14, B = 1024) and route B at 2^16
    x_g = e0[0].contiguous()
    plan_g, q_g0 = bb.plans()[0], params.qs[0]
    plan65, x65 = ring[-1][:2]
    invb = {"ntt_invb_block": 1, "ntt_invb_cross": len(tk.dit_schedule(n)) - 1}
    guards = [
        ("forward", x_g, plan_g, {}, {"ntt_fwd": passes(n)}),
        ("GS inverse", x_g, plan_g, {"inverse": True}, {"ntt_inv": passes(n)}),
        ("route-B inverse", x_g, plan_g, {"inverse": True, "alg": "dit"}, invb),
        ("route-B inverse n=2^16", x65, plan65, {"inverse": True, "alg": "dit"},
         {"ntt_invb_block": 1, "ntt_invb_cross": len(tk.dit_schedule(plan65.n)) - 1}),
    ]
    for name, x_, pl_, kw_, want in guards:
        got = run_3i(f"ntt_cm_checked {name}", lambda: dbg.ntt_cm_checked(x_, pl_, **kw_), want)
        if not torch.equal(got, tk.ntt_cm(x_, pl_, **kw_)):
            raise AssertionError(f"phase 3i: ntt_cm_checked {name} != ntt_cm")
    for word in (q_g0, -(1 << 31)):  # a planted q, and the u32 word 0x80000000
        planted = x_g.clone()
        planted[5, 7] = word
        try:
            run_3i(f"ntt_cm_checked planted {word}", lambda: dbg.ntt_cm_checked(planted, plan_g), {})
        except dbg.ReductionError as exc:
            print(f"planted {word & 0xFFFFFFFF:#x}: {exc}", flush=True)
        else:
            raise AssertionError(f"phase 3i: a planted word {word} passed the guard")
    mark(f"phase 3i: debug guards: ntt_cm_checked == ntt_cm forward, GS, route B at n = {n} "
         f"and route B at {plan65.n}; a planted q and 0x80000000 raise; launches "
         f"{path_launches['3i']}")

    # (d) two processes on this card: NCCL refuses two ranks on one card, so
    # the ranks' collective goes through gloo on a CPU copy; their builders
    # and kernels run on cuda:0.  Each rank checks its columns against the
    # unsharded run and counts its launches exactly (multihost_check).
    print("two ranks on cuda:0 over gloo: the collective on a CPU copy, the kernels on the card",
          flush=True)
    t = time.perf_counter()
    ranks = multihost_check.spawn(2, timeout=600, device="cuda", backend="gloo", m=m,
                                  batch=B, ext_m=m8, time_iters=5)
    t_ranks = time.perf_counter() - t
    want_rank = {"ntt": {"ntt_fwd": passes(n)},
                 "step": multihost_check.step_launches(3, n),
                 "ext": multihost_check.ext_step_launches(3, 2, n8)}
    for rep in ranks:
        if rep["launches"] != want_rank or rep["columns"] != [rep["rank"] * B // 2,
                                                              (rep["rank"] + 1) * B // 2]:
            raise AssertionError(f"phase 3i: rank {rep['rank']}: {rep}")
        for part in rep["launches"].values():
            for k_, v_ in part.items():
                path_launches["3i"][k_] += v_
    rank_launches = [rep["launches"] for rep in ranks]
    two_rank_ops = ranks[0]["step_ops_per_sec"]
    gm1 = sh.make_mesh({"data": 2, "rns": 3}, [dev] * 6)  # the same layout in one process
    st1 = bb.build_step(hint, mesh=gm1)
    blk1 = [sh.shard_batch_rns(gm1, t_) for t_ in (c0, c1, d0, d1)]
    one_proc_ms, _ = time_ms(lambda: st1(*blk1), 5)
    del blk1
    mark(f"phase 3i: two ranks, mesh {ranks[0]['mesh']} over gloo on one card, in {t_ranks:.1f} s: "
         f"the mesh step (m = {m}, B = {B}) and the ext step (m = {m8}) == the unsharded "
         f"columns on each rank, all_reduce held; launches per rank {rank_launches}; step "
         f"{two_rank_ops:.1f} ops/s against {B / (one_proc_ms / 1e3):.1f} in one process")
    persist_timings = {
        "challenge_generate_ms_per_instance_disc": chall_ms[f"generate_disc_m{m}"],
        "challenge_generate_ms_per_instance_cont": chall_ms[f"generate_cont_m{m}"],
        "challenge_verify_ms_per_instance_disc": chall_ms[f"verify_disc_m{m}"],
        "challenge_verify_ms_per_instance_cont": chall_ms[f"verify_cont_m{m}"],
        "eval_hints_write_MB_per_s": io_stats["eval_hints"]["MB"] / io_stats["eval_hints"]["write_ms"] * 1e3,
        "eval_hints_read_MB_per_s": io_stats["eval_hints"]["MB"] / io_stats["eval_hints"]["read_ms"] * 1e3,
        "mesh_step_two_ranks_ops_per_sec": two_rank_ops,
        "mesh_step_one_process_data2_ops_per_sec": B / (one_proc_ms / 1e3),
        "persistence": io_stats, "challenge_ms_per_instance": chall_ms,
        "two_ranks_step_ms_windows": ranks[0]["step_ms_windows"],
    }

    # -- phase 3j: the randomness, the JAX package's bits on the card ------
    pk_before = pk.LAUNCHES["prng"]
    from lol_tpu_torch.bench import roofline as rf

    for op_, m_ in prng_mix(lib).items():  # what this build issues, beside what the bound counts
        need_, pipe_ = rf.prng_slots(rf.PRNG_NEEDS[op_])
        print(f"prng SASS a word, {op_}: {m_}, {m_['issue'] / 2:.2f} issue slots; the bound "
              f"counts {need_:.2f} ({pipe_})", flush=True)
    rand = phase_3j(dev)
    for leg_, what_ in (("round", "rounded normal"), ("randint", "randint over 3 primes (one hash)"),
                        ("bits", "words"), ("randint2", "randint over 3 spans <= 2^16 (two hashes)")):
        print(f"prng kernel at (n, B) = ({n}, {B}), {what_}: {rand[f'{leg_}_ms']:.4f} ms, plain "
              f"{rand[f'{leg_}_plain_ms']:.3f}, bound {rand[f'{leg_}_bound'][0]:.4f} "
              f"({rand[f'{leg_}_pipe']}, {100 * rand[f'{leg_}_bound'][0] / rand[f'{leg_}_ms']:.1f}%)"
              f"; on {card}", flush=True)
    print(f"torch.randn ({n}, {B}) {rand['randn_ms']:.4f} ms; on {card}", flush=True)
    for k_ in ("gen_sk", "encrypt_B1024", "gen_ks_quad_hint"):
        print(f"metric {k_}_ms_m{m} = {rand[f'{k_}_ms_m{m}']:.3f} on {card}", flush=True)
    mark(f"phase 3j: prng: {rand['checks']} checks card == plain bit for bit (every 2^23 "
         f"normal input raw and rounded at var 2, 4, 9; words and randint's two instances at "
         f"({n}, {B}); the 64-bit-index instance past 2^31 and 2^32 elements; "
         f"gen_sk at {m} and {m_g}, build_encrypt LSD / MSD, gen_ks_quad_hint and the tunnel "
         f"hint at {m}; the challenges' card bytes == CPU bytes in 3i(b)), known answers "
         f"{rand['known_answers']}; "
         f"{pk.LAUNCHES['prng'] - pk_before} launches")

    # -- phase 4: timings -----------------------------------------------
    # Each op is timed once, on an input checked kernel == plain: the
    # n = 4096 ones in phase 2, one channel of the step's here.
    plan, q0 = bb.plans()[0], params.qs[0]
    x = e0[0].contiguous()  # one channel of the step's output
    xd = (e0[1] % params.qs[1]).contiguous()  # a digit the step re-expands into q0
    ops = [t[0].contiguous() for t in (c0, c1, d0, d1)]
    plan65, x65 = ring[-1][:2]  # route B's two passes (n = 2^16, B = 1024)
    checks = check_ntt(x, plan) + check_ntt(x65, plan65)
    err["ntt_fwd"] = max(err["ntt_fwd"], max_err(
        tk.ntt_cm(xd, plan, pre_digit_q=params.qs[1]),
        tk.ntt_cm_ref(xd, plan, pre_digit_q=params.qs[1])))
    for a, b in zip(pw.ct_mul_cm(*ops, q0), pw.ct_mul_cm_ref(*ops, q0)):
        err["ct_mul"] = max(err["ct_mul"], max_err(a, b))
    checks += 2
    if any(err.values()):
        raise AssertionError(f"kernel != plain on the timed inputs: max abs err {err}")
    mark(f"phase 4: {checks} kernel-vs-plain checks on the step channel bit-exact")
    timings = {}
    # NTT/s at n = 4096 over 2x30-bit primes: one NTT = one column through both
    for B4, xs in x4.items():
        for inverse, key in ((False, "ntt"), (True, "intt")):
            ms, wins = time_ms(lambda: [tk.ntt_cm(v, pl, inverse=inverse)
                                        for v, pl in zip(xs, plans4)], 20)
            timings[f"{key}_per_s_n4096_B{B4}"] = B4 / (ms / 1e3)
            timings[f"{key}_ms_windows_n4096_B{B4}"] = wins
    # the route-B path: route B against GS in turns (GS, B, B, GS), on the
    # device alone, at n = 4096 over 2x30-bit primes (B = 16384), at one
    # channel of the step and at n = 2^16; the latter two are the GS and
    # route-B kernel times below.  Route B launches one block pass a transform, and a
    # cross pass where `dit_schedule` has two passes: counted exactly.
    ab = {
        "n4096_B16384": list(zip(x4[16384], plans4)),
        "n16384_B1024": [(x, plan)],
        "n65536_B1024": [(x65, plan65)],
    }
    want_invb = dict.fromkeys(("ntt_invb_block", "ntt_invb_cross"), 0)

    def route(args, alg):
        for v, pl in args:
            tk.ntt_cm(v, pl, inverse=True, alg=alg)
            if alg == "dit":
                want_invb["ntt_invb_block"] += 1
                want_invb["ntt_invb_cross"] += len(tk.dit_schedule(pl.n)) - 1

    reset_counts()
    for shape, args in ab.items():
        runs = {"gs": [], "dit": []}
        for alg in ("gs", "dit", "dit", "gs"):
            runs[alg].append(time_ms(lambda: route(args, alg), 20, device_only=True)[0])
        for alg, ms in runs.items():
            timings[f"intt_{alg}_ms_{shape}"] = ms
    invb = counts()
    if {k: invb[k] for k in want_invb} != want_invb or not all(want_invb.values()):
        raise AssertionError(f"route-B launches {invb}, want {want_invb}")
    timings["intt_dit_per_s_n4096_B16384"] = 16384 / (
        statistics.mean(timings["intt_dit_ms_n4096_B16384"]) / 1e3)
    timings["ntt_inv_ms"] = statistics.mean(timings["intt_gs_ms_n16384_B1024"])
    timings["ntt_invb_ms"] = statistics.mean(timings["intt_dit_ms_n16384_B1024"])
    timings["ntt_invb_n65536_ms"] = statistics.mean(timings["intt_dit_ms_n65536_B1024"])
    # kernel and plain at the step's shapes (one channel, n = 2^14,
    # B = 1024), and route B's single block pass at n = 4096, B = 1024;
    # the kernels on the device alone: at ~0.03 ms the n = 4096 pass is
    # shorter than the host's issue of it
    x4b = x4[1024][0]
    kern = {
        "ntt_fwd": lambda: tk.ntt_cm(xd, plan, pre_digit_q=params.qs[1]),
        "ntt_invb_n4096": lambda: tk.ntt_cm(x4b, plans4[0], inverse=True, alg="dit"),
        "ct_mul": lambda: pw.ct_mul_cm(*ops, q0),
    }
    plain = {
        "ntt_fwd": lambda: tk.ntt_cm_ref(xd, plan, pre_digit_q=params.qs[1]),
        "ntt_inv": lambda: tk.ntt_cm_ref(x, plan, inverse=True),
        "ntt_invb": lambda: tk.ntt_cm_ref(x, plan, inverse=True, alg="dit"),
        "ntt_invb_n4096": lambda: tk.ntt_cm_ref(x4b, plans4[0], inverse=True, alg="dit"),
        "ntt_invb_n65536": lambda: tk.ntt_cm_ref(x65, plan65, inverse=True, alg="dit"),
        "ct_mul": lambda: pw.ct_mul_cm_ref(*ops, q0),
    }
    for name, fn in kern.items():
        timings[f"{name}_ms"], _ = time_ms(fn, 20, device_only=True)
    for name, fn in plain.items():
        timings[f"{name}_plain_ms"], _ = time_ms(fn, 3)
    del x4, x65
    # the u32 ceiling (the chain kernel's path; its input was checked in
    # phase 2) and a copy's bandwidth
    reset_counts()
    ceiling = mx.u32_ceiling()
    chain_launches = counts()["chain"]
    if chain_launches == 0:
        raise AssertionError("the u32 ceiling launched no u32_chain")
    timings["u32_ceiling_T_mul_add_per_s"] = ceiling / 1e12
    timings["chain_ms"] = mx.GRID * mx.ROWS * mx.LANES * mx.ITERS / ceiling * 1e3
    timings["chain_plain_ms"] = chain_plain_ms
    src_buf = torch.empty(2 ** 28, dtype=torch.int32, device=dev)  # 1 GiB
    dst_buf = torch.empty_like(src_buf)
    copy_ms, _ = time_ms(lambda: dst_buf.copy_(src_buf), 10, device_only=True)
    copy_gbps = 2 * src_buf.numel() * 4 / copy_ms / 1e6
    timings["copy_GB_per_s"] = copy_gbps
    del src_buf, dst_buf
    # the ring-sharded NTT, D = 4 shards on this card: each route against
    # ntt_cm on the same (n, B) array (phase 3b checked both); where
    # make_mesh spread phase 3b's shards over several cards, on that mesh
    # too, each call joined back onto this card's stream so that its
    # events span every card's work.  At n = 2^14 (the step's first prime,
    # B = 1024) the exchange against a copy_ and against the one torch
    # call that computes it; at n = 2^14 and 2^16 the fused passes against
    # the unfused phase-B (B') passes they replace, on inputs checked
    # kernel == plain here first.
    one_card = sh.make_mesh({"ring": D}, [dev] * D)
    meshes = {"": one_card}
    cards = list(dict.fromkeys(mesh.axis_devices("ring")))
    if len(cards) > 1:
        meshes[f"_{len(cards)}cards"] = mesh

    def joined(fn):
        fn()
        here = torch.cuda.current_stream(cards[0])
        for c in cards[1:]:
            here.wait_event(torch.cuda.current_stream(c).record_event())

    for key, (pl_, x_) in (("n16384", ring[0][:2]), ("n65536", ring[-1][:2])):
        timings[f"ntt_single_ms_{key}"], _ = time_ms(lambda: tk.ntt_cm(x_, pl_), 10)
        timings[f"intt_single_ms_{key}"], _ = time_ms(
            lambda: tk.ntt_cm(x_, pl_, inverse=True), 10)
        for tag, m in meshes.items():
            sh_ = sh.ring_shard(x_, m)
            for overlap, route in ((False, "two_call"), (True, "fused")):
                timings[f"ring_ntt_ms_{route}_{key}{tag}"], _ = time_ms(lambda: joined(
                    lambda: rn.ntt_ring_sharded_cm(m, sh_, pl_, overlap=overlap)), 10)
                timings[f"ring_intt_ms_{route}_{key}{tag}"], _ = time_ms(lambda: joined(
                    lambda: rn.intt_ring_sharded_cm(m, sh_, pl_, overlap=overlap)), 10)
    plan_r, xr = ring[0][:2]
    shards = sh.ring_shard(xr, one_card)
    n_r = plan_r.n
    tS, C = rn.check_ring(n_r, D)
    stack = torch.stack(shards)
    lib_a2a = torch.empty((D, D, C * B), dtype=torch.int32, device=dev)
    lib_a2a.copy_(stack.view(D, D, -1).transpose(0, 1))
    for d, (a, b) in enumerate(zip(rn.a2a_chunks(shards), rn.a2a_chunks_ref(shards))):
        err["a2a"] = max(err["a2a"], max_err(a, b), max_err(lib_a2a[d].view(tS, B), b))
    copy_buf = torch.empty_like(xr)
    # on the device alone: a wrapper issues D launches per call, and at
    # ~0.07 ms of device work per exchange its host side can outlast them;
    # a2a_call_ms is the exchange as its caller sees it, host included
    for name, fn in {"a2a": lambda: rn.a2a_chunks(shards),
                     "a2a_library": lambda: lib_a2a.copy_(stack.view(D, D, -1).transpose(0, 1)),
                     "ring_copy": lambda: copy_buf.copy_(xr)}.items():
        timings[f"{name}_ms"], _ = time_ms(fn, 20, device_only=True)
    timings["a2a_call_ms"], _ = time_ms(lambda: rn.a2a_chunks(shards), 20)
    timings["a2a_plain_ms"], _ = time_ms(lambda: rn.a2a_chunks_ref(shards), 3)
    timings["a2a_GB_per_s"] = 8 * n_r * B / timings["a2a_ms"] / 1e6
    timings["a2a_share_of_copy"] = timings["a2a_GB_per_s"] / copy_gbps
    del stack, lib_a2a, copy_buf
    # the fused passes and the unfused phase-B (B') passes they replace, at
    # n = 2^14 and 2^16, each checked == plain on its timed input first
    # (ntt_ab.ring_phase_b); plain times at 2^14
    names = {"gather": "ntt_fwd_gather", "phase_b": "phase_b_unfused",
             "scatter": "ntt_inv_scatter", "phase_b_inv": "phase_b_inv_unfused"}
    for tag, (pl_, x_) in (("", ring[0][:2]), ("_n65536", ring[-1][:2])):
        ring_ops = ntt_ab.ring_phase_b(rn, tk, pl_, sh.ring_shard(x_, one_card))
        for key, (fn, ref) in ring_ops.items():
            name = names[key]
            timings[f"{name}_ms{tag}"], _ = time_ms(fn, 20, device_only=True)
            if not tag and name in err:
                timings[f"{name}_plain_ms"], _ = time_ms(ref, 3)
        del ring_ops
    if any(err.values()):
        raise AssertionError(f"ring kernel != plain on the timed inputs: max abs err {err}")
    del ring
    # the roofline rows from the times above; only the plain mul_mod and
    # add_mod rows are timed here
    roof_ms = {"ntt_fwd": timings["ntt_fwd_ms"], "ntt_inv_gs": timings["ntt_inv_ms"],
               "ntt_inv_dit": timings["ntt_invb_ms"], "ct_mul": timings["ct_mul_ms"]}
    roof_calls = roofline.calls(*ops, plan)
    for op in ("mul_mod", "add_mod"):
        roof_ms[op], _ = time_ms(roof_calls[op], 20, device_only=True)
    rows = [roofline.row(op, n, B, roof_ms[op], ceiling / 1e9, copy_gbps)
            for op in roofline.OPS]
    roofline.show(rows, f"{torch.cuda.get_device_name(0)}, n={n}, batch={B}, q={q0} "
                        "(ntt_fwd with the step's digit prologue)")
    timings["roofline_n16384_B1024"] = rows
    # the step's breakdown; its `step` leg is the n = 2^14 step's ops/s
    st = steptime.breakdown(step, c0, c1, d0, d1)
    timings["steptime_n16384"] = st
    step_ms = st["ms_per_call"]["step"]
    timings["bgv_ops_per_s_n16384"] = st["step_ops_per_sec"]
    ntt_ms = (step_calls["ntt_fwd"] * timings["ntt_fwd_ms"]
              + step_calls["ntt_inv"] * timings["ntt_inv_ms"])
    timings["bgv_step_ntt_share_n16384"] = ntt_ms / step_ms
    timings["bgv_step_ct_mul_share_n16384"] = nrns * timings["ct_mul_ms"] / step_ms
    del c0, c1, d0, d1, e0, e1, x, xd, x4b, ops
    enc8 = bb8.build_encrypt(sk8)
    step8 = bb8.build_step(bb8.gen_ks_quad_hint(sk8, nk()))
    cts8 = (*enc8(she.pt_random(params8, rng, (B,)), nk()),
            *enc8(she.pt_random(params8, rng, (B,)), nk()))
    step8_ms, wins8 = time_ms(lambda: step8(*cts8), 5)
    timings["bgv_ops_per_s_n4096"] = B / (step8_ms / 1e3)
    timings["bgv_step_ms_windows_n4096"] = wins8
    # the builders' end-to-end rates, as their caller sees them, on inputs
    # phases 3c and 3d checked: the modulus switch and the linear key switch
    # at n = 4096 (the reference bench's extras of that leg), the tunnel
    # m = 32768 -> 16384 (its headline), B = 1024
    ms8 = bb8.build_mod_switch("lsd")
    # phase 3e's paths: the rounding chain, HomomPRF with its stages built
    # once as the reference bench does (checked against the entry point's
    # output first), the LSD ext step
    prf_run = steptime.homom_prf_run(fam, hints, bb_top, bits, 0)[0]
    if not all(torch.equal(a, b) for a, b in zip(prf_run(*ct_prf), y_prf)):
        raise AssertionError("the built-once HomomPRF program != batched_homom_prf_component")
    step_ext = bb8.build_step_ext(quad_ext)
    for key, fn, iters in (("mod_switch", lambda: ms8(*c8["lsd"][0]), 20),
                           ("ks_linear", lambda: ksl(*c8["lsd"][0]), 10),
                           ("tunnel", lambda: tun(*ct), 5),
                           ("pt_round", lambda: run_pr(*ct_pr), 2),
                           ("homom_prf", lambda: prf_run(*ct_prf), 2),
                           ("step_ext", lambda: step_ext(*c8["lsd"][0], *c8["lsd"][1]), 10)):
        op_ms, op_wins = time_ms(fn, iters)
        timings[f"{key}_ops_per_sec"] = B / (op_ms / 1e3)
        timings[f"{key}_ms_windows"] = op_wins
    # phase 3f's paths, as their caller sees them, on the inputs checked
    # there; the rotations hoisted against separate in interleaved windows
    for key, fn, iters in (("bgv_general_m", lambda: step_g["lsd"](*ct_g["lsd"][0], *ct_g["lsd"][1]), 5),
                           ("tunnel_general_m", lambda: tun_g(*ctt_g), 5)):
        op_ms, op_wins = time_ms(fn, iters)
        timings[f"{key}_ops_per_sec"] = B / (op_ms / 1e3)
        timings[f"{key}_ms_windows"] = op_wins
    gal = steptime.galois_ab(gal_many, gal_one, *ct_gal, iters=3)
    for key in ("galois_hoisted_rot_per_sec", "galois_separate_rot_per_sec",
                "galois_hoisted_speedup", "ms_windows"):
        timings[key if key != "ms_windows" else "galois_ms_windows"] = gal[key]
    for arm in ("mesh_step", "mesh_tunnel"):
        timings[f"{arm}_ops_per_sec"] = mesh_rates[f"{arm}_ops_per_sec"]
        timings[f"{arm}_unsharded_ops_per_sec"] = mesh_rates[f"{arm[5:]}_ops_per_sec"]
        timings[f"{arm}_copies"] = mesh_copies[arm]
    timings["mesh_ms_windows"] = mesh_rates["ms_windows"]
    # the object path at m = 32768 on phase 3h's inputs, as its caller sees
    # it, beside the batched path's time per ciphertext (its call over
    # B = 1024 columns / B) in the same windows' discipline, on phase 3's
    # plaintexts encrypted anew (its ciphertexts were freed above)
    cc, dd = enc(m1, nk()), enc(m2, nk())
    k_enc = nk()
    obj_pairs = {
        "encrypt": (lambda: she.encrypt(sk, am_o, k_enc, dev), lambda: enc(m1, k_enc)),
        "step": (lambda: she.mod_switch(she.key_switch_quad_circ(hint, she.ct_mul(ca_o, cb_o))),
                 lambda: step(*cc, *dd)),
        "decrypt": (lambda: she.decrypt(sk, ca_o), lambda: dec_gal(*cc)),
        "tunnel": (lambda: she.tunnel(th, col_ct(params, *ct, 0)), lambda: tun(*ct)),
        "homom_prf": (lambda: prf.homom_prf_component(fam, hints, key_ct, bits, 0),
                      lambda: prf_run(*ct_prf)),
    }
    for key, (obj_fn, batched_fn) in obj_pairs.items():
        obj_ms, obj_wins = time_ms(obj_fn, 1)
        bat_ms, _ = time_ms(batched_fn, 1)
        timings[f"object_{key}_ms"] = obj_ms
        timings[f"object_{key}_ms_windows"] = obj_wins
        timings[f"batched_{key}_per_ct_ms"] = bat_ms / B
    timings.update(persist_timings)
    timings["step_ext_noise_bits_delta"] = step_ext_delta
    timings["step_ext_noise_bits"] = noise
    timings["homom_prf_peak_GiB"] = prf_peak_gib
    for k, v in timings.items():
        print(f"timing {k} = {json.dumps(v)}", flush=True)
    for k in ("mod_switch_ops_per_sec", "ks_linear_ops_per_sec", "tunnel_ops_per_sec",
              "pt_round_ops_per_sec", "homom_prf_ops_per_sec", "step_ext_ops_per_sec",
              "step_ext_noise_bits_delta", "bgv_general_m_ops_per_sec",
              "tunnel_general_m_ops_per_sec", "galois_hoisted_rot_per_sec",
              "galois_separate_rot_per_sec", "galois_hoisted_speedup",
              "mesh_step_ops_per_sec", "mesh_step_unsharded_ops_per_sec",
              "mesh_tunnel_ops_per_sec", "mesh_tunnel_unsharded_ops_per_sec",
              "challenge_generate_ms_per_instance_disc", "challenge_generate_ms_per_instance_cont",
              "challenge_verify_ms_per_instance_disc", "challenge_verify_ms_per_instance_cont",
              "eval_hints_write_MB_per_s", "eval_hints_read_MB_per_s",
              "mesh_step_two_ranks_ops_per_sec", "mesh_step_one_process_data2_ops_per_sec"):
        print(f"metric {k} = {timings[k]} on {card}", flush=True)
    for key in obj_pairs:
        print(f"metric object_{key}_ms = {timings[f'object_{key}_ms']} (batched "
              f"{timings[f'batched_{key}_per_ct_ms']} ms per ciphertext) at m = {params.m} on {card}",
              flush=True)
    mark("phase 4: timings done")

    def bound(op, n_, B_, D_=1):
        ms, by = roofline.bound(*roofline.work(op, n_, B_, D_))
        return {"bound_ms": ms, "bound_by": by}

    chain_bound_ms, chain_bound_by = roofline.bound(
        mx.GRID * mx.ROWS * mx.LANES * mx.ITERS, 8 * mx.GRID * mx.ROWS * mx.LANES)
    ntt_src = "lol_tpu_torch/csrc/ntt.cu"
    ring_src = "lol_tpu_torch/csrc/remote_ntt.cu"
    ring_path = "ring-sharded NTT (ntt_/intt_ring_sharded_cm), D=4 shards on one card"
    ring_shape = f"n={n_r}, B={B}, D={D}: all {D} shards"
    kernels = [
        {"name": "ntt_fwd_pass", "route": "cuda", "source": ntt_src,
         "replaces": "lol_tpu/ops/pallas/ntt_kernel.py:539",
         "also_replaces": "lol_tpu/ops/pallas/ntt_kernel.py:593",
         "launches": launches["ntt_fwd"], "max_abs_err": err["ntt_fwd"],
         "launches_builders": path_launches["3c"]["ntt_fwd"],
         "launches_tunnel": path_launches["3d"]["ntt_fwd"],
         "launches_serving": path_launches["3e"]["ntt_fwd"],
         "launches_ext": path_launches["3e_ext"]["ntt_fwd"],
         "launches_general": path_launches["3f"]["ntt_fwd"],
         "launches_galois": path_launches["3f_galois"]["ntt_fwd"],
         "launches_mesh": path_launches["3g"]["ntt_fwd"],
         "launches_slots": path_launches["3g_slots"]["ntt_fwd"],
         "launches_object": path_launches["3h"]["ntt_fwd"],
         "launches_3i": path_launches["3i"]["ntt_fwd"],
         "ms": timings["ntt_fwd_ms"], "plain_ms": timings["ntt_fwd_plain_ms"],
         **bound("ntt_fwd", n, B), "library_ms": None},
        {"name": "ntt_inv_pass", "route": "cuda", "source": ntt_src,
         "replaces": "lol_tpu/ops/pallas/ntt_kernel.py:593",
         "also_replaces": "lol_tpu/ops/pallas/ntt_kernel.py:539",
         "launches": launches["ntt_inv"], "max_abs_err": err["ntt_inv"],
         "launches_builders": path_launches["3c"]["ntt_inv"],
         "launches_tunnel": path_launches["3d"]["ntt_inv"],
         "launches_serving": path_launches["3e"]["ntt_inv"],
         "launches_ext": path_launches["3e_ext"]["ntt_inv"],
         "launches_general": path_launches["3f"]["ntt_inv"],
         "launches_galois": path_launches["3f_galois"]["ntt_inv"],
         "launches_mesh": path_launches["3g"]["ntt_inv"],
         "launches_slots": path_launches["3g_slots"]["ntt_inv"],
         "launches_object": path_launches["3h"]["ntt_inv"],
         "launches_3i": path_launches["3i"]["ntt_inv"],
         "ms": timings["ntt_inv_ms"], "plain_ms": timings["ntt_inv_plain_ms"],
         **bound("ntt_inv_gs", n, B), "library_ms": None},
        # one kernel in two geometries, as the reference's two bodies: the
        # block pass alone at one step channel (one 8-CTA cluster pass over
        # all n rows) and at n = 4096, the cross pass inside the two-pass
        # transform at n = 2^16
        {"name": "ntt_invb_pass[block]", "route": "cuda", "source": ntt_src,
         "replaces": "lol_tpu/ops/pallas/ntt_kernel.py:421",
         "path": "route-B inverse A/B (ntt_cm alg='dit')",
         "launches": invb["ntt_invb_block"], "max_abs_err": err["ntt_invb"],
         "launches_3i": path_launches["3i"]["ntt_invb_block"],
         "shape": f"n={n}, B={B}, one cluster pass",
         "ms": timings["ntt_invb_ms"], "plain_ms": timings["ntt_invb_plain_ms"],
         **bound("ntt_inv_dit", n, B), "library_ms": None,
         "ms_n4096": timings["ntt_invb_n4096_ms"],
         "plain_ms_n4096": timings["ntt_invb_n4096_plain_ms"],
         "bound_ms_n4096": bound("ntt_inv_dit", 4096, 1024)["bound_ms"]},
        {"name": "ntt_invb_pass[cross]", "route": "cuda", "source": ntt_src,
         "replaces": "lol_tpu/ops/pallas/ntt_kernel.py:437",
         "path": "route-B inverse A/B (ntt_cm alg='dit')",
         "launches": invb["ntt_invb_cross"], "max_abs_err": err["ntt_invb"],
         "launches_3i": path_launches["3i"]["ntt_invb_cross"],
         "shape": f"n=65536, B={B}, block + cross passes",
         "ms": timings["ntt_invb_n65536_ms"], "plain_ms": timings["ntt_invb_n65536_plain_ms"],
         **bound("ntt_inv_dit", 65536, B), "library_ms": None},
        {"name": "ct_mul", "route": "cuda", "source": "lol_tpu_torch/csrc/pointwise.cu",
         "replaces": "lol_tpu/ops/pallas/pointwise.py:31",
         "launches": launches["ct_mul"], "max_abs_err": err["ct_mul"],
         "launches_builders": path_launches["3c"]["ct_mul"],
         "launches_serving": path_launches["3e"]["ct_mul"],
         "launches_ext": path_launches["3e_ext"]["ct_mul"],
         "launches_general": path_launches["3f"]["ct_mul"],
         "launches_galois": path_launches["3f_galois"]["ct_mul"],
         "launches_mesh": path_launches["3g"]["ct_mul"],
         "launches_slots": path_launches["3g_slots"]["ct_mul"],
         "launches_object": path_launches["3h"]["ct_mul"],
         "launches_3i": path_launches["3i"]["ct_mul"],
         "ms": timings["ct_mul_ms"], "plain_ms": timings["ct_mul_plain_ms"],
         **bound("ct_mul", n, B), "library_ms": None},
        {"name": "u32_chain", "route": "cuda", "source": "lol_tpu_torch/csrc/chain.cu",
         "replaces": "lol_tpu/bench/mxu_ntt.py:169", "path": "u32_ceiling",
         "launches": chain_launches, "max_abs_err": err["chain"],
         "shape": f"({mx.GRID * mx.ROWS}, {mx.LANES}), iters={mx.ITERS}; plain: one call",
         "ms": timings["chain_ms"], "plain_ms": timings["chain_plain_ms"],
         "bound_ms": chain_bound_ms, "bound_by": chain_bound_by, "library_ms": None},
        # the exchange's yardstick is the one torch call computing the same
        # chunk transpose on a stack of the shards; no torch call computes
        # an NTT, so the fused passes have none: copy_ms is a copy_ of the
        # same bytes, a yardstick of bytes only
        {"name": "a2a_chunks", "route": "cuda", "source": ring_src,
         "replaces": "lol_tpu/ops/pallas/remote_ntt.py:61", "path": ring_path,
         "launches": ring_launches["two-call"]["a2a"] + ring_launches["fused"]["a2a"],
         "max_abs_err": err["a2a"], "shape": ring_shape + ", one exchange",
         "ms": timings["a2a_ms"], "plain_ms": timings["a2a_plain_ms"],
         **bound("a2a", n_r, B, D), "library_ms": timings["a2a_library_ms"]},
        {"name": "ntt_fwd_gather_pass", "route": "cuda", "source": ring_src,
         "replaces": "lol_tpu/ops/pallas/remote_ntt.py:111", "path": ring_path + ", overlap=True",
         "launches": ring_launches["fused"]["ntt_fwd_gather"],
         "max_abs_err": err["ntt_fwd_gather"], "shape": ring_shape + ", phase B",
         "ms": timings["ntt_fwd_gather_ms"], "plain_ms": timings["ntt_fwd_gather_plain_ms"],
         **bound("ntt_fwd_gather", n_r, B, D), "library_ms": None,
         "copy_ms": timings["ring_copy_ms"], "unfused_ms": timings["phase_b_unfused_ms"],
         "ms_n65536": timings["ntt_fwd_gather_ms_n65536"],
         "unfused_ms_n65536": timings["phase_b_unfused_ms_n65536"],
         "bound_ms_n65536": bound("ntt_fwd_gather", 65536, B, D)["bound_ms"]},
        {"name": "ntt_inv_scatter_pass", "route": "cuda", "source": ring_src,
         "replaces": "lol_tpu/ops/pallas/remote_ntt.py:283", "path": ring_path + ", overlap=True",
         "launches": ring_launches["fused"]["ntt_inv_scatter"],
         "max_abs_err": err["ntt_inv_scatter"], "shape": ring_shape + ", phase B'",
         "ms": timings["ntt_inv_scatter_ms"], "plain_ms": timings["ntt_inv_scatter_plain_ms"],
         **bound("ntt_inv_scatter", n_r, B, D), "library_ms": None,
         "copy_ms": timings["ring_copy_ms"], "unfused_ms": timings["phase_b_inv_unfused_ms"],
         "ms_n65536": timings["ntt_inv_scatter_ms_n65536"],
         "unfused_ms_n65536": timings["phase_b_inv_unfused_ms_n65536"],
         "bound_ms_n65536": bound("ntt_inv_scatter", 65536, B, D)["bound_ms"]},
        # no pallas_call draws randomness in the reference (its threefry and
        # erf_inv are XLA code); no torch call computes threefry, so the
        # kernel has no library time (randn_ms: torch's Philox normals of the
        # same shape, a yardstick only)
        {"name": "prng_draw", "route": "cuda", "source": "lol_tpu_torch/csrc/prng.cu",
         "replaces": "lol_tpu/sampling.py:102 (jax.random.normal: XLA threefry2x32 + erf_inv; "
                     "no pallas_call)", "path": "build_encrypt's error and c1 draws (phase 3)",
         "launches": prng_launches, "max_abs_err": 0,
         "shape": f"({n}, {B}), the rounded normal; randint over 3 primes beside it",
         "ms": rand["round_ms"], "plain_ms": rand["round_plain_ms"],
         "bound_ms": rand["round_bound"][0], "bound_by": rand["round_bound"][1],
         "library_ms": None, "pipe": rand["round_pipe"], "randint_ms": rand["randint_ms"],
         "randint_plain_ms": rand["randint_plain_ms"], "randint_bound_ms": rand["randint_bound"][0],
         "randint_pipe": rand["randint_pipe"], "bits_ms": rand["bits_ms"],
         "bits_bound_ms": rand["bits_bound"][0], "randint2_ms": rand["randint2_ms"],
         "randint2_bound_ms": rand["randint2_bound"][0], "randn_ms": rand["randn_ms"]},
    ]
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
