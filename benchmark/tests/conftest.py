"""The tiny ring of each configuration that `bench_tiny.TINY_M` does not
name: the tests' copy of the benchmark cuts every configuration to one."""

import bench_tiny

bench_tiny.TINY_M.setdefault("tunnel_m32768", 64)  # R = Z[zeta_64] -> S = Z[zeta_32]
