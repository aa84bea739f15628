"""Name parity: every public function, class and method of each module of
the JAX package has a same-named counterpart in the port's matching
module, so "the port does all that the JAX package does" is a checked
fact.

Both trees are parsed, not imported.  A module's names are its top-level
functions, classes and assignments; a class's are its methods and its
annotated fields, and the attributes its `__init__` assigns on self.  The
exceptions are one table, each with its reason.
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


def test_the_exception_table_is_live():
    """Every renamed entry names a reference name that exists and a port
    name that exists: the table holds no stale exception."""
    for (module, name), (port_name, why) in RENAMED.items():
        assert name in _public(REF / module), (module, name)
        assert port_name in names(PORT / MODULE_MAP.get(module, module)), (module, port_name)
        assert why
    for module, port_module in MODULE_MAP.items():
        assert (REF / module).exists() and (PORT / port_module).exists()
