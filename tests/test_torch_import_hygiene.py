"""The PyTorch port imports no jax, flax or HF tokenizers.

The machine with the GPU has none of them. A subprocess is needed: this
pytest process has imported jax already (tests/conftest.py).
"""
import os
import subprocess
import sys
import textwrap

import pytest
import torch

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# installs an import blocker for the modules the GPU machine lacks, then runs
# the code that follows it
BLOCKER = textwrap.dedent("""
    import sys

    BLOCKED = {"jax", "jaxlib", "flax", "tokenizers"}

    class Blocker:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Blocker())
    sys.path.insert(0, ROOT_DIR)
""").replace("ROOT_DIR", repr(ROOT))


def run_without_jax(code: str) -> subprocess.CompletedProcess:
    """Run ``code`` in a fresh interpreter in which jax, jaxlib, flax and
    tokenizers cannot be imported."""
    return subprocess.run([sys.executable, "-c", BLOCKER + textwrap.dedent(code)],
                          capture_output=True, text=True, timeout=120, cwd=ROOT)


@pytest.mark.parametrize("module", ["tortoise_tpu_torch.api", "tortoise_tpu_torch.api_fast",
                                    "chip_smoke"])
def test_port_imports_without_jax(module):
    proc = run_without_jax(f"""
        import {module}
        assert not any(m.split(".")[0] in BLOCKED for m in sys.modules), sorted(sys.modules)
        print("ok")
    """)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_blocker_really_blocks():
    proc = run_without_jax("import jax")
    assert proc.returncode != 0 and "blocked import of jax" in proc.stderr
