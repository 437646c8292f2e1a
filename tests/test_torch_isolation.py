"""The PyTorch port imports neither jax nor the JAX package.

Runs in a subprocess because this pytest process imports jax first
(tests/conftest.py)."""

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "signature_kmers_tpu_torch"
JAX_PACKAGE = re.compile(r"\bsignature_kmers_tpu\b(?!_torch)")
JAX_IMPORT = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b)", re.M)
IMPORT_LINE = re.compile(r"^\s*(import|from)\s.*$", re.M)

CHECK = r"""
import importlib, pkgutil, sys
import signature_kmers_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = [m for m in sys.modules
       if m == "jax" or m.startswith("jax.") or m == "jaxlib"
       or m == "signature_kmers_tpu" or m.startswith("signature_kmers_tpu.")]
assert not bad, bad
print(len(names))
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", CHECK], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 20  # every module was imported


def test_port_sources_never_name_the_jax_package():
    sources = sorted(PKG.rglob("*.py"))
    assert len(sources) > 20
    for path in sources:
        text = path.read_text()
        assert not JAX_PACKAGE.search(text), path
        assert not JAX_IMPORT.search(text), path


def test_chip_smoke_imports_nothing_of_jax():
    # its report names the JAX kernels it replaces, so only its import
    # statements are scanned
    text = "\n".join(m.group(0) for m in IMPORT_LINE.finditer(
        (ROOT / "chip_smoke.py").read_text()))
    assert "signature_kmers_tpu_torch" in text
    assert not JAX_PACKAGE.search(text)
    assert not JAX_IMPORT.search(text)


def test_regex_tells_the_packages_apart():
    assert JAX_PACKAGE.search("from signature_kmers_tpu.ops import probe")
    assert JAX_PACKAGE.search("import signature_kmers_tpu")
    assert not JAX_PACKAGE.search("from signature_kmers_tpu_torch.ops import x")
