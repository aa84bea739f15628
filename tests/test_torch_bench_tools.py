"""The port's bench tools (`bench.she_bench`, `micro`, `scaling`, `invgap`,
`smallb`, and `mxu_ntt.run`) on the CPU: each refuses to run without a
card, and each runs its checks and legs end to end at a tiny size when
the card, the CUDA-event timer and nvidia-smi are stood in for (the CPU
tensors take the plain versions).  No number here is a device number."""

import statistics
import sys
import time

import pytest
import torch

from lol_tpu_torch import bench
from lol_tpu_torch.bench import invgap, micro, mxu_ntt, scaling, she_bench, smallb
from lol_tpu_torch.ops.cuda import ntt_kernel as tk

torch.set_num_threads(2)
TOOLS = (bench, she_bench, micro, scaling, invgap, smallb, mxu_ntt)
RUNS = {
    "she_bench.run": lambda: she_bench.run(m=64, nrns=3, batch=16, iters=1),
    "she_bench.homom_prf": lambda: she_bench.homom_prf(m_top=16, batch=8, iters=1),
    "micro.run": lambda: micro.run(n=64, batch=8, nrns=2, iters=1, host_iters=1),
    "scaling.run": lambda: scaling.run(n=64, nrns=2, batch_per_dev=4, iters=1),
    "scaling.run_bgv": lambda: scaling.run_bgv(m=64, nrns=3, batch_per_dev=4, iters=1),
    "invgap.run": lambda: invgap.run(B=16, n=64, iters=1, windows=2),
    "smallb.run": lambda: smallb.run((16,), n=1024, iters=1, windows=1),
    "mxu_ntt.run": lambda: mxu_ntt.run(n=256, batch=32, P=16),
}


@pytest.mark.parametrize("name", RUNS)
def test_tool_refuses_to_run_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        RUNS[name]()


@pytest.fixture
def host_as_card(monkeypatch):
    """The CPU in place of the card: require_cuda gives it, time_ms times
    on the host clock, card_line names it, and `run_passes` (the pass
    kernels alone, which have no plain form) runs the plain transform."""
    cpu = torch.device("cpu")

    def host_ms(fn, iters, windows=5, device_only=False):
        fn()
        per = []
        for _ in range(windows):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            per.append((time.perf_counter() - t0) * 1e3 / iters)
        return statistics.median(per), per

    for mod in TOOLS:
        for name, val in (("require_cuda", lambda: cpu), ("time_ms", host_ms),
                          ("card_line", lambda: "the CPU, no card")):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, val)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "the CPU")
    monkeypatch.setattr(scaling, "_cards", lambda max_devices: [cpu])
    monkeypatch.setattr(tk, "run_passes",
                        lambda x, plan, passes, inverse: tk.ntt_cm_ref(x, plan, inverse=inverse))
    monkeypatch.setattr(sys, "path", list(sys.path))


@pytest.mark.parametrize("name", RUNS)
def test_tool_runs_its_checks_on_the_host(name, host_as_card, capsys):
    out = RUNS[name]()
    printed = capsys.readouterr().out
    assert "the CPU, no card" in printed
    if name.startswith("she_bench"):
        key = "mod_switch_ops_per_sec" if name.endswith("run") else "homom_prf_ops_per_sec"
        assert out[key] > 0
    elif name == "micro.run":
        ops = {(op, backend) for op, backend, _, _ in out}
        assert {("crt (fwd NTT)", "cpp"), ("mulG (pow)", "cpp"), ("denseDFT p96", "cuda modmat_s8"),
                ("twaceCRT", "torch")} <= ops
    elif name.startswith("scaling"):
        assert [line["vs_baseline"] for line in out] == [1.0]
    elif name == "invgap.run":
        assert set(out["results"]) == {"fwd", "inv", "inv_dit"}
    elif name == "smallb.run":
        assert set(out["results"][16]) == {"fwd, one pass", "inv gs, one pass",
                                           "fwd, two pass tS=512", "inv gs, two pass tS=512",
                                           "inv dit (route B)"}
    else:
        assert out["mxu_ntt_ms"] > 0
