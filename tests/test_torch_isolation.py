"""nkbx_torch stands alone: it imports neither JAX nor flax nor anything of
nkbx or of its experiments/ probes (it keeps its own copies of what it needs
from them), and its entry points run on a CUDA card unless asked for the
CPU."""

import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in (ROOT / "nkbx_torch").rglob("*.py"))

_PROBE = """
import importlib, json, sys
for name in {modules!r}:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "nkbx", "experiments",
                                    "pallas_fused_matmul_bn", "pallas_batch_norm")
             or m.startswith(("r3_", "r4_", "r5_")))
print(json.dumps(bad))
"""

# an import statement that would reach JAX, nkbx or the probes under experiments/
FORBIDDEN_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|nkbx|experiments|pallas_\w+"
                              r"|r[345]_\w+)\b", re.MULTILINE)


def _run(code):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)


def test_every_module_is_found():
    assert "nkbx_torch.ops.attention" in MODULES and "nkbx_torch.export.serving" in MODULES
    assert len(MODULES) >= 20


def test_port_imports_no_jax_flax_or_nkbx():
    proc = _run(_PROBE.format(modules=MODULES))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_port_sources_import_no_jax_flax_nkbx_or_experiments():
    """No import statement to them even on a path the import probe does not
    reach, and no reach into experiments/ through sys.path."""
    for path in sorted((ROOT / "nkbx_torch").rglob("*.py")):
        src = path.read_text()
        assert not FORBIDDEN_IMPORT.search(src) and "sys.path" not in src, path.name


def test_chip_smoke_imports_no_jax_flax_or_nkbx():
    src = (ROOT / "chip_smoke.py").read_text()
    assert not FORBIDDEN_IMPORT.search(src) and "sys.path" not in src
    for word in ("import jax", "from jax", "import flax", "from flax", "import nkbx ",
                 "from nkbx ", "from nkbx."):
        assert word not in src


def test_chip_smoke_fails_without_a_card_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_get_model_without_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from nkbx_torch.models import get_model

    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model({"model": "swin_tiny_patch4_window7_224"}, ["a", "b"])


def test_resolve_device_defaults_to_cuda():
    from nkbx_torch.core.runtime import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device()
