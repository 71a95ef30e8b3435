"""nkbx_torch stands alone: it imports neither JAX nor flax nor anything of
nkbx or of its experiments/ probes (it keeps its own copies of what it needs
from them), and its entry points run on a CUDA card unless asked for the
CPU."""

import json
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


# the one use of sys.path the port makes: the config loader puts a config's own
# directory there, as nkbx's loader does (nkbx/utils/config.py:145-147)
CONFIG_PATH_USE = ("if str(folder) not in sys.path:", "sys.path.append(str(folder))")


def test_port_sources_import_no_jax_flax_nkbx_or_experiments():
    """No import statement to them even on a path the import probe does not
    reach, and no reach into experiments/ through sys.path: no source names
    sys.path but the config loader, which adds only the config's directory."""
    for path in sorted((ROOT / "nkbx_torch").rglob("*.py")):
        src = path.read_text()
        assert not FORBIDDEN_IMPORT.search(src), path.name
        uses = [line.strip().split("  #")[0] for line in src.splitlines() if "sys.path" in line]
        if path.relative_to(ROOT).as_posix() == "nkbx_torch/utils/config.py":
            assert tuple(uses) == CONFIG_PATH_USE, uses
            assert "experiments" not in src
        else:
            assert not uses, path.name


_LAZY_PROBE = """
import json, sys
import nkbx_torch.logging, nkbx_torch.train, nkbx_torch.train.__main__, nkbx_torch.train.trainer
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0] in ("comet_ml", "yaml"))))
"""


def test_logging_and_train_load_neither_comet_ml_nor_yaml():
    """Comet ML and the side YAML's reader are imported inside
    get_comet_experiment only, when a config has a Comet section."""
    proc = _run(_LAZY_PROBE)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"
    src = (ROOT / "nkbx_torch/logging/experiment.py").read_text()
    assert "COMET_ERROR" not in src and src.count("import comet_ml") + src.count(
        "from comet_ml") == 1


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


_CONFIG_PROBE = """
import json, sys
{pre}
from nkbx_torch.utils import load_config
before = {{m: id(sys.modules[m]) for m in sys.modules if m == "nkbx" or m.startswith("nkbx.")}}
loaded, refused = [], []
for path in {paths!r}:
    try:
        cfg = load_config(path)
        pipes = [cfg.get(k) for k in ("train_pipeline", "val_pipeline", "inference_pipeline")]
        loaded.append(sorted({{type(p).__module__ for p in pipes if p is not None}}))
    except NotImplementedError as e:
        assert "A9" in str(e), e
        refused.append(path)
after = {{m: id(sys.modules[m]) for m in sys.modules if m == "nkbx" or m.startswith("nkbx.")}}
print(json.dumps([before == after, sorted(after), loaded, len(refused)]))
"""


@pytest.mark.parametrize("pre", ["", "import nkbx.transforms, nkbx.utils"])
def test_config_loader_leaves_sys_modules_as_it_found_it(pre):
    """Every shipped config runs in the port (``import nkbx.transforms as T``
    builds the port's transforms; a refusal would have to name A9, and none
    is left); afterwards no nkbx
    module is left where none was, and a process that imported the real
    nkbx keeps exactly its entries."""
    paths = sorted(str(p) for p in (ROOT / "configs").glob("*.py"))
    proc = _run(_CONFIG_PROBE.format(pre=pre, paths=paths))
    assert proc.returncode == 0, proc.stderr
    same, left, loaded, n_refused = json.loads(proc.stdout.strip().splitlines()[-1])
    assert same and (left if pre else not left)
    assert loaded and all(m == ["nkbx_torch.transforms.spec"] for m in loaded)
    assert len(loaded) + n_refused == len(paths)
    assert n_refused == 0  # heavy_augs_config.py loads too: every device op of nkbx is ported


# the command lines of the single-card tools: none reaches nkbx, and the one
# that runs on a device takes the card unless given --device cpu
TOOL_CLIS = ("nkbx_torch.models.convert", "nkbx_torch.utils.migrate", "nkbx_torch.save_augs",
             "nkbx_torch.core.profiling")

_CLI_PROBE = """
import importlib, json, sys
for name in {modules!r}:
    mod = importlib.import_module(name)
    try:
        mod.main(["--help"])
    except SystemExit:
        pass
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "nkbx"))))
"""


def test_tool_clis_import_no_jax_flax_or_nkbx():
    proc = _run(_CLI_PROBE.format(modules=TOOL_CLIS))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_save_augs_needs_a_card_unless_given_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run([sys.executable, "-m", "nkbx_torch.save_augs", "-cfg",
                           str(tmp_path / "config.py")], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr
    proc = subprocess.run([sys.executable, "-m", "nkbx_torch.save_augs", "-cfg",
                           str(tmp_path / "config.py"), "--device", "cpu"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "Config file not found" in proc.stderr
