"""Tensor backends of the port.

The reference runs one generic Tensor interface over several backends and
takes their agreement as its oracle.  Here:

- the plain torch versions (`ops/ntt.py`'s networks, `ops/general.py`,
  `ring.py`) on CPU tensors;
- the hand-written CUDA kernels (`csrc/`) on the card;
- `cpp_backend`, the native C++ host backend (lol-cpp's role), over CPU
  tensors.

All three agree bit for bit (tests/test_torch_cpp_backend.py on the CPU;
the card against the C++ backend in `chip_smoke.py`).
"""
