"""Every public name of the reference has a counterpart in the port.

For each module of ``src/repro/`` with a counterpart at the same path in
``src/repro_torch/``, every public top-level ``def`` and ``class`` of the
reference must be defined, assigned or imported at the top level of the
port's module, unless ``ALLOWED`` lists it with its reason:

* ``JAX-only``: the name exists for JAX's sake (threefry keys, ``jit``
  factories, ``NamedSharding``, ``lax.scan`` over stacked layers, TPU
  constants) and the port has no use for it;
* ``inlined``: the port does its work inside another function, named;
* ``queued``: the port still lacks it; ROADMAP.md names it
  (``QUEUED_ROW``).

The list is exact: a listed name the port now has fails the test too.
Modules without a counterpart are in ``NO_MODULE``, each with its reason.
The check reads the sources with ``ast`` and imports neither package.
"""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"
QUEUED_ROW = "Queue A 20"

NO_MODULE = {
    "kernels/ref.py": "inlined: each kernel module's plain version "
                      "(``abft_matmul_plain``, ``rollback_correct_plain``, "
                      "``drift_gemm_fused_plain``, ...)",
    "launch/hlo_analysis.py": "inlined: ``launch/op_analysis.py`` counts the "
                              "eager call's ops where the reference parses "
                              "compiled HLO",
}

ALLOWED = {
    ("core/abft.py", "tile_checksum_diff"):
        "inlined: ``kernels.abft_matmul.abft_matmul_plain`` and the kernels "
        "return the per-tile checksum differences",
    ("core/abft.py", "tile_error_mask"):
        "inlined: ``kernels.rollback_correct.rollback_correct_plain`` (the "
        "element mask) and ``abft.tile_flags``",
    ("core/exec_ctx.py", "clean_ctx"):
        "inlined: a model called without a context runs float_clean "
        "(``dit.forward(drift=None)``, ``transformer.forward``)",
    ("core/fault.py", "inject_int32"):
        "JAX-only: threefry draws; the port's ``FlipSource`` "
        "(``PhiloxFlipSource``, ``draw_flips``) and ``ExecContext`` xor",
    ("core/fault.py", "site_key"):
        "JAX-only: a threefry key chain; ``PhiloxFlipSource.seed_for``",
    ("core/quant.py", "int32_matmul"):
        "inlined: the int8 products of ``kernels.abft_matmul`` and "
        "``kernels.ops.drift_gemm_fused``",
    ("core/quant.py", "quantized_matmul"):
        "inlined: ``ExecContext.matmul`` and ``kernels.ops.drift_gemm``",
    ("core/rollback.py", "correct"):
        "inlined: ``rollback.effective_checkpoint`` and the rollback "
        "kernels' splice",
    ("core/rollback.py", "init_store_like"):
        "inlined: the stores are allocated whole "
        "(``dit.drift_store_spec``, ``sampler.init_stores``)",
    ("core/rollback.py", "update_store"):
        "inlined: ``ExecContext`` refreshes the store in place",
    ("diffusion/sampler.py", "make_sampler"):
        "JAX-only: a ``jit`` factory; the engine calls ``sample`` and "
        "``sample_stream``",
    ("distributed/constraints.py", "constrain"):
        "JAX-only: ``with_sharding_constraint``; ``constraints.gather`` "
        "and ``own_rows``",
    ("distributed/sharding.py", "shardings_for"):
        "JAX-only: ``NamedSharding``; ``sharding.param_specs`` and "
        "``shard_tree``",
    ("kernels/__init__.py", "tpu_compiler_params"):
        "JAX-only: Pallas TPU compiler parameters",
    ("launch/dryrun.py", "input_specs"):
        "JAX-only: ``ShapeDtypeStruct`` stand-ins; ``dryrun.input_batch`` "
        "on meta tensors",
    ("models/common.py", "scan_layers"):
        "JAX-only: ``lax.scan`` over stacked layers; the port loops over "
        "a list of layers",
    ("models/common.py", "stack_layer_params"):
        "JAX-only: stacked layers for ``lax.scan``",
    ("models/transformer.py", "init_layer"):
        "inlined: ``transformer.init_params`` draws every layer",
    ("perfmodel/hw.py", "TpuV5e"):
        "JAX-only: TPU constants; ``hw.H100_SXM`` for the card",
    ("serving/servable.py", "ServableModel"):
        "inlined: ``DiffusionServable`` and ``AutoregressiveServable`` "
        "carry the protocol without a base class",
    ("serving/servable.py", "build_servable"):
        "inlined: ``servable.servable_class(arch)(engine)``",
}

KINDS = ("JAX-only: ", "inlined: ", "queued: ")
REF_MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def public_defs(path: Path) -> set:
    """Public top-level ``def``/``class`` names."""
    return {n.name for n in _tree(path).body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)) and not n.name.startswith("_")}


def top_level_names(path: Path) -> set:
    """Every name bound at the top level: defs, classes, assignments and
    imports."""
    out = set()
    for n in _tree(path).body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            out.add(n.name)
        elif isinstance(n, (ast.Assign, ast.AnnAssign)):
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            out |= {t.id for t in targets if isinstance(t, ast.Name)}
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in n.names}
    return out


@pytest.mark.parametrize("module", REF_MODULES)
def test_module_names_have_counterparts(module):
    port = PORT / module
    if module in NO_MODULE:
        assert not port.exists(), f"{module} has a counterpart now"
        return
    assert port.exists(), f"no counterpart of src/repro/{module}"
    missing = public_defs(REF / module) - top_level_names(port)
    allowed = {n for m, n in ALLOWED if m == module}
    assert missing == allowed, (
        f"{module}: missing from the port {sorted(missing - allowed)}, "
        f"allowed but present {sorted(allowed - missing)}")


def test_allow_list_reasons():
    """Each entry names a module of the reference, a public name of it,
    and one of the three kinds of reason; ROADMAP.md names each queued
    name."""
    roadmap = (ROOT / "ROADMAP.md").read_text()
    for (module, name), reason in {**ALLOWED, **{
            (m, None): r for m, r in NO_MODULE.items()}}.items():
        assert module in REF_MODULES
        assert name is None or name in public_defs(REF / module)
        assert reason.startswith(KINDS), reason
        if reason.startswith("queued: "):
            assert f"`{name}`" in roadmap, name
