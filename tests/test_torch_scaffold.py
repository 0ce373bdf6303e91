"""The port package stands alone: importing it loads no jax, no module of
it (nor ``chip_smoke.py``) imports ``repro``, and the reference's source
lint (timing confinement and the rest) reports nothing on it."""
import ast
import os
import pathlib
import subprocess
import sys

from repro.analysis import lint_tree

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def test_import_leaves_jax_out():
    code = ("import sys, repro_torch, repro_torch.serve.engine, "
            "repro_torch.weights, repro_torch.kernels.paged_attention.ops, "
            "repro_torch.core.veceval, repro_torch.perf.measure, "
            "repro_torch.quantum.qsim, repro_torch.core.microbench, "
            "repro_torch.figures.fig9_qsim, repro_torch.figures.fig2_strided, "
            "repro_torch.figures.fig3_tail, "
            "repro_torch.kernels.qsim_gate.ops, "
            "repro_torch.kernels.strided.ops, "
            "repro_torch.kernels.tailmask.ops, "
            "repro_torch.kernels.flash_attention.ops, repro_torch.train, "
            "repro_torch.train.trainer, repro_torch.train.parity, "
            "repro_torch.launch.train, "
            "repro_torch.checkpoint, repro_torch.data, repro_torch.optim, "
            "repro_torch.kernels.ssd_scan.ops, repro_torch.models.mamba2, "
            "repro_torch.models.quant, repro_torch.launch.serve, "
            "repro_torch.serve.frontend, repro_torch.serve.arrivals, "
            "repro_torch.serve.slo, repro_torch.perf.report, "
            "repro_torch.core.costmodel, repro_torch.configs.shapes; "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'repro' "
            "or m.startswith('repro.')); print(bad); sys.exit(bool(bad))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imports(path):
    tree = ast.parse(path.read_text(encoding="utf-8"), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_reference_or_jax_imports():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imports(f)
           if m.split(".")[0] in ("repro", "jax", "jaxlib")]
    assert len(files) > 15 and not bad, bad
    # the scan is over the tree: the ssm slice's modules are in it
    names = {str(f.relative_to(PORT)) for f in files[:-1]}
    assert {"kernels/ssd_scan/ops.py", "kernels/ssd_scan/kernel.py",
            "kernels/ssd_scan/ref.py", "models/mamba2.py", "models/quant.py",
            "launch/serve.py", "configs/mamba2_780m.py"} <= names


def test_import_scan_catches_a_reference_import(tmp_path):
    """The AST scan sees an import of the reference however it is
    spelled, as a new module of the port would carry it."""
    f = tmp_path / "m.py"
    f.write_text("import os\nfrom repro.models import mamba2\n"
                 "def g():\n    import jax.numpy as jnp\n")
    assert {m.split(".")[0] for m in _imports(f)} == {"os", "repro", "jax"}


def test_reference_lint_is_clean_on_the_port():
    findings = [f for f in lint_tree(ROOT, subdirs=("src/repro_torch",))]
    assert not findings, "\n".join(f.format() for f in findings)
    assert "time" not in set(m for f in PORT.rglob("*.py")
                             for m in _imports(f))
