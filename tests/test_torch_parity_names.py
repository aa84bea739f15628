"""Name parity: every public function, class and method of each module of
the JAX package has a same-named counterpart in the port's matching
module, and every parameter of it a same-named parameter there, so "the
port does all that the JAX package does" is a checked fact down to the
arguments a caller passes.

Both trees are parsed, not imported.  A module's names are its top-level
functions, classes and assignments; a class's are its methods and its
annotated fields, and the attributes its `__init__` assigns on self.  The
exceptions are three tables, names, arguments and constructor arguments,
each entry with its reason.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "lol_tpu", ROOT / "lol_tpu_torch"

# module of the JAX package -> the port's module that carries its names
MODULE_MAP = {
    # the Pallas kernels are ported as hand-written CUDA kernels with their wrappers
    "ops/pallas/__init__.py": "ops/cuda/__init__.py",
    "ops/pallas/ntt_kernel.py": "ops/cuda/ntt_kernel.py",
    "ops/pallas/pointwise.py": "ops/cuda/pointwise.py",
    "ops/pallas/remote_ntt.py": "ops/cuda/remote_ntt.py",
    # the generated protobuf bindings: the port's own wire codec, no protobuf runtime
    "proto/lol_pb2.py": "proto/wire.py",
}

# (module of the JAX package, name) -> the port's name, and why it differs
RENAMED = {
    ("ops/pallas/remote_ntt.py", "ntt_ring_sharded_pallas"):
        ("ntt_ring_sharded_cm", "the ring-sharded transform runs the CUDA kernels, not Pallas"),
    ("ops/pallas/remote_ntt.py", "intt_ring_sharded_pallas"):
        ("intt_ring_sharded_cm", "the same, inverse"),
    ("bench/mxu_ntt.py", "vpu_u32_ceiling"):
        ("u32_ceiling", "the card's integer ceiling: there is no VPU"),
}


# (module of the JAX package, function or method) -> (its parameters the
# port's counterpart does not take, why)
_PALLAS_KNOBS = ("the Pallas kernel's tiling and compile knobs: the CUDA kernels take "
                 "their schedule from `cm_schedule` / `dit_schedule`, and a CPU tensor runs "
                 "the plain version where the reference runs interpret mode")
_SHARDS = ("the port takes the shards (or blocks), one tensor a device of the mesh, in "
           "place of one sharded array x; interpret as for the other Pallas wrappers")
ARG_EXCEPTIONS = {
    ("ops/pallas/ntt_kernel.py", "ntt_cm"): (
        ("lanes", "interpret", "radix", "lazy", "full_tables", "window", "scale"),
        _PALLAS_KNOBS + "; scale (no 1/n) serves only invgap's wrong-result legs, which "
        "the port's invgap does not carry over"),
    ("ops/pallas/ntt_kernel.py", "ntt_batched"): (("interpret",), _PALLAS_KNOBS),
    ("ops/pallas/pointwise.py", "ct_mul_cm"): (("interpret",), _PALLAS_KNOBS),
    ("ops/pallas/remote_ntt.py", "ntt_ring_sharded_pallas"): (("x", "interpret"), _SHARDS),
    ("ops/pallas/remote_ntt.py", "intt_ring_sharded_pallas"): (("x", "interpret"), _SHARDS),
    ("parallel/sharding.py", "ntt_ring_sharded"): (("x",), _SHARDS),
    ("parallel/sharding.py", "batched_ntt_sharded"): (("x",), _SHARDS),
    ("bench/micro.py", "run"): (("use_tpu",), "the tool runs on the card; there is no TPU "
                                              "to choose"),
    ("bench/scaling.py", "run"): (("platform",), "the tool runs over the visible cards; "
                                                 "there is no JAX platform to choose"),
    ("bench/scaling.py", "run_bgv"): (("platform",), "the same"),
    ("ops/general.py", "crt_cm"): (("use_pallas",), "the port's 2-power axis is always "
                                   "`ntt_cm`: the kernel on the card and the plain version "
                                   "on the CPU, so the knob would do nothing"),
}


# (module of the JAX package, class) -> (its constructor arguments the port's
# class does not take, why).  Empty: every reference constructor argument has
# a counterpart (`BatchedBGV(use_pallas)`, `RingContext(fm)`, `RnsBasis(moduli)`,
# `PRFFamily(ctx)`, `KSHint(ctx)`, `KSHintExt(ctx_ext)` are taken by keyword).
CTOR_EXCEPTIONS: dict[tuple[str, str], tuple[tuple[str, ...], str]] = {}


def _jnp_form(name: str) -> bool:
    """The `*_jnp` forms are the JAX array versions of functions the port
    has once, over torch tensors (`matvec_mod_jnp` is `matvec_mod`,
    `RnsBasis.pos_mod_jnp` is `pos_mod`, ...)."""
    return name.rsplit(".", 1)[-1].endswith("_jnp")


def _targets(node) -> list[str]:
    out = []
    for t in (node.targets if isinstance(node, ast.Assign) else [node.target]):
        if isinstance(t, ast.Name):
            out.append(t.id)
        elif isinstance(t, ast.Tuple):
            out += [e.id for e in t.elts if isinstance(e, ast.Name)]
    return out


def names(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            out.update(_targets(node))
        elif isinstance(node, ast.ClassDef):
            out.add(node.name)
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out.add(f"{node.name}.{sub.name}")
                    if sub.name == "__init__":
                        for st in ast.walk(sub):
                            if isinstance(st, (ast.Assign, ast.AnnAssign)):
                                for t in (st.targets if isinstance(st, ast.Assign) else [st.target]):
                                    if (isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
                                            and t.value.id == "self"):
                                        out.add(f"{node.name}.{t.attr}")
                elif isinstance(sub, ast.AnnAssign) and isinstance(sub.target, ast.Name):
                    out.add(f"{node.name}.{sub.target.id}")
    return {n for n in out if not n.rsplit(".", 1)[-1].startswith("_")}


def _public(path: Path) -> set[str]:
    """The names the parity asks of the port: functions, classes, methods
    (assignments only where they are the module's functions, as the port's
    `ring.mul_g_pow = _g_op(...)` are; the reference's constants are not
    asked for)."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and not node.name.startswith("_"):
            out.add(node.name)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            out.add(node.name)
            out.update(f"{node.name}.{s.name}" for s in node.body
                       if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef))
                       and not s.name.startswith("_"))
    return out


def _arg_names(fn) -> list[str]:
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]


def params(path: Path) -> dict[str, list[str]]:
    """Each function's and method's parameter names; a name assigned from a
    factory of the module (`mul_g_pow = _g_op(gen.mul_g_pow)`) takes those
    of the function the factory returns."""
    tree = ast.parse(path.read_text())
    fns = {n.name: n for n in tree.body if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    out = {name: _arg_names(fn) for name, fn in fns.items()}
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            out.update((f"{node.name}.{s.name}", _arg_names(s)) for s in node.body
                       if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)))
        elif (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)
              and isinstance(node.value.func, ast.Name) and node.value.func.id in fns):
            factory = fns[node.value.func.id]
            returned = {r.value.id for r in ast.walk(factory)
                        if isinstance(r, ast.Return) and isinstance(r.value, ast.Name)}
            inner = [f for f in factory.body if isinstance(f, ast.FunctionDef) and f.name in returned]
            for t in _targets(node):
                if inner:
                    out[t] = _arg_names(inner[0])
    return out


def _is_dataclass(cls: ast.ClassDef) -> bool:
    for d in cls.decorator_list:
        f = d.func if isinstance(d, ast.Call) else d
        if (f.id if isinstance(f, ast.Name) else getattr(f, "attr", None)) == "dataclass":
            return True
    return False


def ctor_params(path: Path) -> dict[str, list[str]]:
    """Each public class's constructor arguments: its `__init__`'s
    parameters (self aside) where it writes one, else the fields of a
    dataclass or NamedTuple.  A class with neither (an enum, an abstract
    base, an exception) takes none the parity asks for."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if not isinstance(node, ast.ClassDef) or node.name.startswith("_"):
            continue
        init = [s for s in node.body if isinstance(s, ast.FunctionDef) and s.name == "__init__"]
        if init:
            out[node.name] = [a for a in _arg_names(init[0]) if a != "self"]
        elif _is_dataclass(node) or any(getattr(b, "id", None) == "NamedTuple" for b in node.bases):
            out[node.name] = [s.target.id for s in node.body
                              if isinstance(s, ast.AnnAssign) and isinstance(s.target, ast.Name)]
    return out


REF_MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


@pytest.mark.parametrize("module", REF_MODULES)
def test_every_public_name_has_a_counterpart(module):
    port_module = MODULE_MAP.get(module, module)
    port_path = PORT / port_module
    assert port_path.exists(), f"lol_tpu/{module}: no lol_tpu_torch/{port_module}"
    have = names(port_path)
    missing = []
    for name in sorted(_public(REF / module)):
        if _jnp_form(name):
            continue
        want = RENAMED.get((module, name), (name, None))[0]
        if want not in have:
            missing.append(name)
    assert not missing, f"lol_tpu/{module} names with no counterpart in " \
                        f"lol_tpu_torch/{port_module}: {missing}"


@pytest.mark.parametrize("module", REF_MODULES)
def test_every_public_argument_has_a_counterpart(module):
    """Every parameter of every public function and method of the
    reference (self aside) is a parameter of the port's counterpart, so a
    caller of the reference that passes it by keyword runs unchanged.  A
    reference property has no parameter to ask for."""
    port_module = MODULE_MAP.get(module, module)
    ref_params, port_params = params(REF / module), params(PORT / port_module)
    missing = []
    for name in sorted(_public(REF / module)):
        if _jnp_form(name) or name not in ref_params:
            continue
        want = [a for a in ref_params[name] if a not in ("self", "cls")]
        excused = ARG_EXCEPTIONS.get((module, name), ((), None))[0]
        have = port_params.get(RENAMED.get((module, name), (name, None))[0], [])
        missing += [f"{name}({a})" for a in want if a not in have and a not in excused]
    assert not missing, f"lol_tpu/{module} parameters with no counterpart in " \
                        f"lol_tpu_torch/{port_module}: {missing}"


@pytest.mark.parametrize("module", REF_MODULES)
def test_every_constructor_argument_has_a_counterpart(module):
    """Every argument of every public class's constructor in the reference
    (dataclass fields or `__init__` parameters) is one the port's class
    takes, so `BatchedBGV(params, use_pallas=False)` and the other
    reference constructions by keyword run unchanged."""
    port_module = MODULE_MAP.get(module, module)
    ref_ctors, port_ctors = ctor_params(REF / module), ctor_params(PORT / port_module)
    missing = []
    for cls, args in sorted(ref_ctors.items()):
        excused = CTOR_EXCEPTIONS.get((module, cls), ((), None))[0]
        have = port_ctors.get(RENAMED.get((module, cls), (cls, None))[0], [])
        missing += [f"{cls}({a})" for a in args if a not in have and a not in excused]
    assert not missing, f"lol_tpu/{module} constructor arguments with no counterpart in " \
                        f"lol_tpu_torch/{port_module}: {missing}"


def test_the_exception_table_is_live():
    """Every renamed entry names a reference name that exists and a port
    name that exists, and every argument exception names a parameter the
    reference takes and its counterpart does not: the tables hold no stale
    exception."""
    for (module, name), (port_name, why) in RENAMED.items():
        assert name in _public(REF / module), (module, name)
        assert port_name in names(PORT / MODULE_MAP.get(module, module)), (module, port_name)
        assert why
    for module, port_module in MODULE_MAP.items():
        assert (REF / module).exists() and (PORT / port_module).exists()
    for (module, name), (args, why) in ARG_EXCEPTIONS.items():
        port_name = RENAMED.get((module, name), (name, None))[0]
        ref_args = params(REF / module)[name]
        port_args = params(PORT / MODULE_MAP.get(module, module))[port_name]
        for a in args:
            assert a in ref_args and a not in port_args, (module, name, a)
        assert why
    for (module, cls), (args, why) in CTOR_EXCEPTIONS.items():
        port_cls = RENAMED.get((module, cls), (cls, None))[0]
        ref_args = ctor_params(REF / module)[cls]
        port_args = ctor_params(PORT / MODULE_MAP.get(module, module)).get(port_cls, [])
        for a in args:
            assert a in ref_args and a not in port_args, (module, cls, a)
        assert why
