"""The PyTorch port stands alone: no module of ``cpgisland_tpu_torch``, and
not ``chip_smoke.py``, imports ``jax`` or the JAX package — an H100 host need
not have JAX.  Checked in a fresh interpreter, since this test process has
already imported both."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import cpgisland_tpu_torch
names = [m.name for m in pkgutil.walk_packages(cpgisland_tpu_torch.__path__,
                                               "cpgisland_tpu_torch.")
         if not m.name.endswith("__main__")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "cpgisland_tpu")
             or m.startswith(("jax.", "jaxlib.", "cpgisland_tpu.")))
missing ={"cpgisland_tpu_torch.ops.viterbi_pallas",
           "cpgisland_tpu_torch.ops.islands_device",
           "cpgisland_tpu_torch.ops.fb_compose",
           "cpgisland_tpu_torch.tools.bench_compose"} - set(names)
print(len(names), bad, sorted(missing))
sys.exit(1 if bad or missing or len(names) < 12 else 0)
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
