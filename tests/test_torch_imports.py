"""paffy_tpu_torch stands alone: an AST scan of every file of the port (and
of chip_smoke.py and bin/paffy-torch) finds no import of JAX or of
paffy_tpu, in any body, and no string that runs a paffy_tpu module in a
subprocess; and a run of each ported command in a fresh interpreter ends
with neither ``jax`` nor any ``paffy_tpu`` module loaded."""

import ast
import os
import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "paffy_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "bin" / "paffy-torch"]

# a command string that runs paffy_tpu: python -c "from paffy_tpu...",
# python -m paffy_tpu..., or one of its launchers as a program path
_RUNS_PAFFY_TPU = re.compile(
    r"(?:\bimport\s+|\bfrom\s+|-m\s+)paffy_tpu\b(?!_torch)"
    r"|^(?:\S*/)?bin/(?:paffy|faffy|paffy-py)(?:\s|$)")
_PAFFY_TPU_MODULE = re.compile(r"paffy_tpu(?:\.\w+)*")


def _imports(source: str, import_time_only: bool = False) -> set[str]:
    """Module names a source imports; with ``import_time_only``, only the
    statements that run when it is imported (function bodies skipped)."""
    found: set[str] = set()

    def visit(node):
        if import_time_only and isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return
        if isinstance(node, ast.Import):
            found.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            found.add(node.module)
            found.update(f"{node.module}.{a.name}" for a in node.names)
        for child in ast.iter_child_nodes(node):
            visit(child)
    visit(ast.parse(source))
    return found


def _is_jax(name: str) -> bool:
    return (name in ("jax", "jaxlib", "paffy_tpu.jaxconf")
            or name.startswith(("jax.", "jaxlib.")))


def _is_paffy_tpu(name: str) -> bool:
    return name == "paffy_tpu" or name.startswith("paffy_tpu.")


def _command_strings(source: str) -> list[str]:
    """String constants of a source that could name a command: every one
    but the docstrings."""
    tree = ast.parse(source)
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef,
                              ast.AsyncFunctionDef, ast.ClassDef))
            and n.body and isinstance(n.body[0], ast.Expr)
            and isinstance(n.body[0].value, ast.Constant)}
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


def _dash_m_modules(source: str) -> list[str]:
    """The string after each "-m" in a list or tuple of strings (the
    module a ``python -m`` argument list runs)."""
    out = []
    for n in ast.walk(ast.parse(source)):
        if isinstance(n, (ast.List, ast.Tuple)):
            for a, b in zip(n.elts, n.elts[1:]):
                if (isinstance(a, ast.Constant) and a.value == "-m"
                        and isinstance(b, ast.Constant)
                        and isinstance(b.value, str)):
                    out.append(b.value)
    return out


def _violations(source: str) -> list[str]:
    bad = sorted(n for n in _imports(source)
                 if _is_jax(n) or _is_paffy_tpu(n))
    bad += [s for s in _command_strings(source) if _RUNS_PAFFY_TPU.search(s)]
    bad += [s for s in _dash_m_modules(source)
            if _PAFFY_TPU_MODULE.fullmatch(s)]
    return bad


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_port_file_reaches_no_jax(path):
    bad = _violations(path.read_text())
    assert not bad, f"{path.name} imports or runs {bad}"


@pytest.mark.parametrize("source", [
    "def f():\n    from paffy_tpu import native\n",
    "def f():\n    import paffy_tpu.core.pafio as p\n",
    "import jax.numpy as jnp\n",
    'REF = "import sys; from paffy_tpu.cli import paffy_main"\n',
    'subprocess.run([sys.executable, "-m", "paffy_tpu.cli", "view"])\n',
    'subprocess.run(["python", "-m paffy_tpu.cli"])\n',
    'subprocess.run([os.path.join(REPO, "bin/paffy"), "view"])\n',
], ids=["import-in-body", "import-as", "jax", "command-string", "dash-m-arg",
        "dash-m-string", "launcher"])
def test_the_scan_sees_paffy_tpu_and_jax(source):
    assert _violations(source)


@pytest.mark.parametrize("source", [
    '"""Counterpart of paffy_tpu/ops/segments.py; from paffy_tpu import."""\n',
    "from paffy_tpu_torch import native\n",
    'subprocess.run(["bin/paffy-torch", "view"])\n',
    'sys.stderr.write(f"{cmd}: not ported; bin/paffy runs it on paffy_tpu")\n',
], ids=["docstring", "port-import", "port-launcher", "message"])
def test_the_scan_passes_the_port(source):
    assert not _violations(source)


def test_the_scan_sees_jax_modules():
    # the scan flags a paffy_tpu module that imports JAX at import time
    tiled = (REPO / "paffy_tpu" / "ops" / "tiled.py").read_text()
    assert any(_is_jax(n) for n in _imports(tiled, import_time_only=True))
    mm = (REPO / "paffy_tpu" / "ops" / "mismatch.py").read_text()
    assert not any(_is_jax(n) for n in _imports(mm, import_time_only=True))
    assert any(_is_paffy_tpu(n) for n in _imports(mm))


def test_port_view_runs_without_loading_jax(tmp_path):
    (tmp_path / "s.fa").write_text(">q\nACGTACGTAC\n>t\nACGTTCGTAC\n")
    (tmp_path / "in.paf").write_text(
        "q\t10\t0\t10\t-\tt\t10\t0\t10\t10\t10\t60\tcg:Z:10M\n")
    code = ("import sys\n"
            "from paffy_tpu_torch.cli import paffy_main\n"
            "rc = paffy_main(sys.argv[1:])\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n"
            "ref = [m for m in sys.modules if m == 'paffy_tpu'\n"
            "       or m.startswith('paffy_tpu.')]\n"
            "assert not ref, f'paffy_tpu modules were imported: {ref}'\n"
            "sys.exit(rc)\n")
    env = dict(os.environ, PAFFY_TPU_PLATFORM="cpu")
    r = subprocess.run(
        [sys.executable, "-c", code, "view", "-i", str(tmp_path / "in.paf"),
         "-s", "-t", str(tmp_path / "s.fa")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("Total-alignments:1\t")


@pytest.mark.parametrize("argv,first", [
    (["add_mismatches", "-i", "in.paf", "s.fa"], "cg:Z:4=1X5="),
    (["add_mismatches", "-a", "-i", "in.paf"], "cg:Z:10M"),
    (["tile", "-i", "in.paf"], "tl:i:1"),
    (["chain", "-i", "in.paf"], "cn:i:0\ts1:i:0\tcg:Z:10M"),
    (["trim", "-i", "in.paf"], "\t60\tAS:i:0\tcg:Z:10M"),
    (["trim", "-f", "-t", "0.2", "-i", "in.paf"],
     "\t1\t9\t+\tt\t10\t1\t9\t10\t10\t60\tAS:i:0\tcg:Z:8M"),
], ids=["add_mismatches", "add_mismatches-a", "tile", "chain", "trim",
        "trim-f"])
def test_port_commands_run_without_loading_jax(tmp_path, argv, first):
    (tmp_path / "s.fa").write_text(">q\nACGTACGTAC\n>t\nACGTTCGTAC\n")
    (tmp_path / "in.paf").write_text(
        "q\t10\t0\t10\t+\tt\t10\t0\t10\t10\t10\t60\tcg:Z:10M\n")
    code = ("import sys\n"
            "from paffy_tpu_torch.cli import paffy_main\n"
            "rc = paffy_main(sys.argv[1:])\n"
            "loaded = [m for m in sys.modules if m in ('jax', 'paffy_tpu')\n"
            "          or m.startswith(('jax.', 'paffy_tpu.'))]\n"
            "assert not loaded, f'modules were imported: {loaded}'\n"
            "sys.exit(rc)\n")
    env = dict(os.environ, PAFFY_TPU_PLATFORM="cpu")
    r = subprocess.run([sys.executable, "-c", code, *argv], cwd=tmp_path,
                       env=dict(env, PYTHONPATH=str(REPO)),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert first in r.stdout


def test_port_launcher_runs_without_paffy_tpu(tmp_path):
    (tmp_path / "s.fa").write_text(">q\nACGTACGTAC\n>t\nACGTTCGTAC\n")
    (tmp_path / "in.paf").write_text(
        "q\t10\t0\t10\t+\tt\t10\t0\t10\t10\t10\t60\tcg:Z:10M\n")
    env = dict(os.environ, PAFFY_TPU_PLATFORM="cpu",
               PYTHONVERBOSE="1")
    r = subprocess.run(
        [sys.executable, str(REPO / "bin" / "paffy-torch"), "view", "-i",
         str(tmp_path / "in.paf"), "-s", "-t", str(tmp_path / "s.fa")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.startswith("Total-alignments:1\t")
    loaded = re.findall(r"^import '((?:paffy_tpu|jax)(?:\.[\w.]+)?)'",
                        r.stderr, re.M)
    assert not loaded, loaded
