"""The random draws' Hopper kernel: threefry2x32 words, `randint` residues
and (rounded) normals, bit for bit the JAX package's.

No Pallas kernel of the reference draws randomness (its threefry and
`erf_inv` are XLA code), so `csrc/prng.cu` replaces XLA's: one launch
fills nchan draws of `count` elements, channel c hashing its own key
(`prng.py` says how each mode maps a word).  `draw` launches it for a
CUDA device and raises on any build or launch error; for the CPU, and
only then, it runs the plain version `draw_ref`, which composes the
threefry twin of `lol_tpu_torch.prng` (randint as the reference defines
it, two words and `%`, which the kernel's one hash and Barrett
reductions must equal).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ... import prng as twin
from . import build

# One per kernel launch.  Reset by callers that check which kernels a path ran.
LAUNCHES = {"prng": 0}

MODES = {"bits": 0, "randint": 1, "float": 2, "round": 3}
MAX_CHANNELS = 32

_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_float, ctypes.c_float, ctypes.c_void_p]


_MAP_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                 ctypes.c_float, ctypes.c_float, ctypes.c_void_p]


def _lib() -> ctypes.CDLL:
    lib = build.load()
    if lib.lol_prng_draw.argtypes is None:
        lib.lol_prng_draw.argtypes = _ARGTYPES
        lib.lol_prng_draw.restype = ctypes.c_int
        lib.lol_prng_map.argtypes = _MAP_ARGTYPES
        lib.lol_prng_map.restype = ctypes.c_int
    return lib


def _dtype(mode: str) -> torch.dtype:
    return torch.float32 if mode == "float" else torch.int32


def _check(keys, count: int, mode: str, qs) -> None:
    if mode not in MODES:
        raise ValueError(f"prng draw: mode must be one of {tuple(MODES)}, got {mode!r}")
    if not (1 <= len(keys) <= MAX_CHANNELS):
        raise ValueError(f"prng draw: 1 to {MAX_CHANNELS} channels, got {len(keys)}")
    if count < 1:
        raise ValueError(f"prng draw: empty draw ({count} elements)")
    if mode == "randint" and (qs is None or len(qs) != len(keys)
                              or not all(0 < int(q) < (1 << 31) for q in qs)):
        raise ValueError(f"prng draw: randint needs one modulus in (0, 2^31) a channel, got {qs}")


def draw_at_ref(keys, idx: torch.Tensor, mode: str, qs=None, pre: float = 1.0,
                scale: float = 1.0) -> torch.Tensor:
    """The plain version's values at the flat element indices idx (int64,
    on any device) of each key's draw: (nchan, len(idx)), as `draw_ref`."""
    _check(keys, max(1, idx.numel()), mode, qs)
    rows = []
    for c, key in enumerate(keys):
        if mode == "bits":
            w = twin.bits_at(key, idx)
            rows.append(torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32))
        elif mode == "randint":
            rows.append(twin.randint_at(key, idx, 0, int(qs[c])).to(torch.int32))
        else:
            v = twin.gaussian_from_bits(twin.bits_at(key, idx), pre, scale)
            rows.append(v if mode == "float" else torch.round(v).to(torch.int32))
    return torch.stack(rows)


def draw_ref(keys, count: int, mode: str, qs=None, pre: float = 1.0, scale: float = 1.0,
             device="cpu") -> torch.Tensor:
    """Plain version of `draw`: (nchan, count), int32 words (bits as their
    u32 pattern), int32 residues, float32 or int32, computed with torch ops
    on `device` (the CPU, where the port takes it; the card too, to time
    it beside the kernel)."""
    _check(keys, count, mode, qs)
    return draw_at_ref(keys, torch.arange(count, device=device), mode, qs, pre, scale)


def draw(keys, count: int, mode: str, qs=None, pre: float = 1.0, scale: float = 1.0,
         device="cuda") -> torch.Tensor:
    """nchan = len(keys) draws of `count` elements, (nchan, count) on
    `device`: "bits" the u32 words (as int32), "randint" channel c's
    residues in [0, qs[c]) (int32), "float" erf_inv(u) * pre * scale
    (float32), "round" that rounded half to even (int32).  pre and scale
    are float32 values; jax.random.normal is pre = sqrt(2), scale = 1."""
    device = torch.device(device)
    keys = [twin.key_words(k) for k in keys]
    if device.type == "cpu":
        return draw_ref([torch.tensor(k) for k in keys], count, mode, qs, pre, scale)
    if device.type != "cuda":
        raise ValueError(f"prng draw: unsupported device {device}")
    _check(keys, count, mode, qs)
    ka = np.asarray(keys, dtype=np.uint32).reshape(-1)
    kb = q = mult = None
    if mode == "randint":  # each channel's words come from split(key)'s two keys
        pairs = [twin.split(torch.tensor(k)) for k in keys]
        ka = np.asarray([twin.key_words(p[0]) for p in pairs], dtype=np.uint32).reshape(-1)
        kb = np.asarray([twin.key_words(p[1]) for p in pairs], dtype=np.uint32).reshape(-1)
        q = np.asarray([int(x) for x in qs], dtype=np.uint32)
        mult = np.asarray([twin.randint_multiplier(int(x)) for x in qs], dtype=np.uint32)
    out = torch.empty((len(keys), count), dtype=_dtype(mode), device=device)
    ptr = (lambda a: None if a is None else a.ctypes.data_as(ctypes.c_void_p))
    with torch.cuda.device(device):
        err = _lib().lol_prng_draw(
            out.data_ptr(), count, len(keys), MODES[mode], ptr(ka), ptr(kb), ptr(q),
            ptr(mult), float(np.float32(pre)), float(np.float32(scale)),
            torch.cuda.current_stream(device).cuda_stream)
    build.check(err, f"prng {mode} ({len(keys)} x {count})")
    LAUNCHES["prng"] += 1
    return out


def map_words(words: torch.Tensor, mode: str, pre: float = 1.0, scale: float = 1.0) -> torch.Tensor:
    """The kernel's epilogue on given u32 words (int32 on the card, 1-D):
    what "float" / "round" draws make of each word, so that the card can be
    held against `twin.gaussian_from_bits` on every input.  For the CPU the
    plain version."""
    if mode not in ("float", "round") or words.dim() != 1 or words.dtype != torch.int32:
        raise ValueError("map_words: a 1-D int32 tensor of words, mode float or round")
    if words.device.type == "cpu":
        v = twin.gaussian_from_bits(words.long() & twin.MASK, pre, scale)
        return v if mode == "float" else torch.round(v).to(torch.int32)
    out = torch.empty(words.shape, dtype=_dtype(mode), device=words.device)
    with torch.cuda.device(words.device):
        err = _lib().lol_prng_map(words.contiguous().data_ptr(), out.data_ptr(), words.numel(),
                                  MODES[mode], float(np.float32(pre)), float(np.float32(scale)),
                                  torch.cuda.current_stream(words.device).cuda_stream)
    build.check(err, f"prng map {mode} ({words.numel()} words)")
    LAUNCHES["prng"] += 1
    return out
