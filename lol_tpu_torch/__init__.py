"""lol_tpu_torch: the PyTorch + CUDA (H100) port of lol_tpu.

The JAX package `lol_tpu` is the reference; module names here mirror its
own (`numtheory`, `zq`, `factored`, `zmstar`, `ops/ntt`,
`ops/cuda/ntt_kernel` for `ops/pallas/ntt_kernel`, `ops/general`, `rns`,
`gadget`, `ring`, `cyc`, `sampling`, `gf`, `crtset`, `linear`, `rlwe`,
`rrq`, `complexfield`, `she`, `she_batched`, `prf`, `serving`,
`parallel/sharding`, `parallel/multihost`, `io` with `proto/`,
`challenges`, `ops/debug`), and every result is bit-identical to it.
This package imports torch and numpy, never jax, lol_tpu or a protobuf
runtime.

Residues are `torch.int32` tensors holding values in [0, q) with q < 2^30:
the batched pipeline's in the coefficient-major (nrns, n, B) layout, a
ring element's (`cyc.Cyc`) in the reference's (..., nrns, n).  CUDA
kernels live in `csrc/` and are built with nvcc at first use
(`ops/cuda/build.py`).
"""
