"""The port stands alone: in a fresh interpreter whose import system refuses
`jax`, `hip_llama_tpu` and `hip_llama_tpu.*` (but not hip_llama_tpu_torch),
every module of hip_llama_tpu_torch and chip_smoke.py import."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, importlib.abc, pkgutil, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "hip_llama_tpu"):
            raise ImportError(f"refused import of {name}")
        return None

sys.meta_path.insert(0, Refuse())
import hip_llama_tpu_torch
names = ["hip_llama_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(hip_llama_tpu_torch.__path__, "hip_llama_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
assert not any(m.split(".")[0] in ("jax", "jaxlib", "hip_llama_tpu") for m in sys.modules)
print("imported", len(names), "modules and chip_smoke")
"""


def test_port_imports_without_jax_or_reference_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "and chip_smoke" in r.stdout
    # every module of the package was reached: one per .py file
    n_files = sum(f.endswith(".py") for _, _, fs in os.walk(
        os.path.join(REPO, "hip_llama_tpu_torch")) for f in fs)
    assert f"imported {n_files} modules" in r.stdout, r.stdout


def test_chip_smoke_fails_without_a_card():
    """With no CUDA device it exits non-zero and prints no result line."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
