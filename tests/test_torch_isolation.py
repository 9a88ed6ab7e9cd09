"""The port stands alone: no JAX, no ``ml_dtypes`` and nothing of
``repro`` in ``src/repro_torch`` or ``chip_smoke.py``, and its entry points
refuse to fall back to the CPU when a GPU was asked for."""
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|repro|ml_dtypes)(\.|\s|$)",
    re.MULTILINE)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path} imports {hits}"


def test_importing_the_port_loads_no_jax_or_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        "import repro_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_entry_points_raise_without_a_gpu(monkeypatch):
    from repro_torch.configs import build, get_config
    from repro_torch.device import resolve_device
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("deepseek-7b", "smoke")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--variant", "smoke", "--steps", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


def test_chip_smoke_fails_without_a_gpu():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, env=env,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no CUDA device" in proc.stderr
