"""The PyTorch port imports neither JAX nor anything of the JAX package."""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, importlib.util, pkgutil, sys
    sys.modules["jax"] = None  # any `import jax` now raises
    import cosa_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(cosa_tpu_torch.__path__, "cosa_tpu_torch.")]
    # Python modules only (a built native library also sits in the tree)
    names = [n for n in names if importlib.util.find_spec(n).origin.endswith(".py")]
    for name in names:
        importlib.import_module(name)
    bad = sorted(k for k in sys.modules if k == "cosa_tpu" or k.startswith("cosa_tpu."))
    bad += sorted(k for k in sys.modules if k.split(".")[0] in ("flax", "optax", "jaxlib"))
    assert not bad, bad
    print(len(names))
""")


def test_port_imports_without_jax_or_cosa_tpu():
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip().splitlines()[-1]) >= 30  # every module was imported
