"""The PyTorch port imports no jax, flax, HF tokenizers, HF transformers or
JAX package.

The machine with the GPU has none of the first four, and the port keeps its
own copies of what it needs from the JAX package (``tortoise_tpu``), even of
its modules that import no jax. A subprocess is needed: this pytest process
has imported jax already (tests/conftest.py).
"""
import json
import os
import pkgutil
import subprocess
import sys
import textwrap

import pytest
import torch

import tortoise_tpu_torch

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# installs an import blocker for the modules the GPU machine lacks and for the
# JAX package (the exact top-level name: tortoise_tpu_torch passes), then runs
# the code that follows it
BLOCKER = textwrap.dedent("""
    import sys

    BLOCKED = {"jax", "jaxlib", "flax", "tokenizers", "transformers", "tortoise_tpu"}

    class Blocker:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Blocker())
    sys.path.insert(0, ROOT_DIR)
""").replace("ROOT_DIR", repr(ROOT))


def run_without_jax(code: str) -> subprocess.CompletedProcess:
    """Run ``code`` in a fresh interpreter in which jax, jaxlib, flax,
    tokenizers, transformers and the JAX package cannot be imported."""
    return subprocess.run([sys.executable, "-c", BLOCKER + textwrap.dedent(code)],
                          capture_output=True, text=True, timeout=120, cwd=ROOT)


# every module of the port (its CLIs included), found by walking the
# package, and chip_smoke.py
MODULES = sorted(m.name for m in pkgutil.walk_packages(tortoise_tpu_torch.__path__,
                                                       "tortoise_tpu_torch.")) + ["chip_smoke"]


@pytest.fixture(scope="module")
def imported() -> dict:
    """Each module imported in turn in one blocked interpreter: {module:
    "ok" or the error}. A module another one imported first passed the
    blocker then, so one interpreter shows what one per module would."""
    proc = run_without_jax(f"""
        import importlib, json, traceback
        result = {{}}
        for name in {MODULES!r}:
            try:
                importlib.import_module(name)
                bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
                result[name] = f"imported {{bad}}" if bad else "ok"
            except Exception:
                result[name] = traceback.format_exc()
        print(json.dumps(result))
    """)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_the_walk_finds_the_port():
    assert {"tortoise_tpu_torch.api", "tortoise_tpu_torch.api_fast",
            "tortoise_tpu_torch.apps.main", "tortoise_tpu_torch.ops.lvc",
            "tortoise_tpu_torch.native", "chip_smoke", "tortoise_tpu_torch.models.wav2vec2",
            "tortoise_tpu_torch.utils.wav2vec_alignment", "tortoise_tpu_torch.models.cvvp",
            "tortoise_tpu_torch.models.classifier", "tortoise_tpu_torch.apps.eval",
            "tortoise_tpu_torch.apps.is_this_from_tortoise", "tortoise_tpu_torch.parallel",
            "tortoise_tpu_torch.parallel.mesh", "tortoise_tpu_torch.parallel.sharding",
            "tortoise_tpu_torch.parallel.multihost", "tortoise_tpu_torch.apps.socket_server",
            "tortoise_tpu_torch.apps.socket_client",
            "tortoise_tpu_torch.models.simple_transformer",
            "tortoise_tpu_torch.tools.convert_checkpoints", "tortoise_tpu_torch.tools.bench_lvc",
            "tortoise_tpu_torch.tools.bench_fused_decode_step",
            "tortoise_tpu_torch.tools.check_fused_exactness",
            "tortoise_tpu_torch.tools.bench_fused_ab",
            "tortoise_tpu_torch.tools.measure_first_audio",
            "tortoise_tpu_torch.tools.profile_diffusion_step",
            "tortoise_tpu_torch.tools.fetch_weights", "tortoise_tpu_torch.tools.import_voice_pack",
            "tortoise_tpu_torch.tools.make_demo_voices",
            "tortoise_tpu_torch.tools.convert_tokenizer",
            "tortoise_tpu_torch.bench"} <= set(MODULES)


def test_port_bench_does_not_import_the_root_bench():
    """The root bench.py is the JAX package's program: the port's bench keeps
    its own copies of its constants."""
    proc = run_without_jax("""
        import sys
        import tortoise_tpu_torch.bench
        assert "bench" not in sys.modules, sorted(sys.modules)
    """)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("module", MODULES)
def test_port_imports_without_jax(module, imported):
    assert imported[module] == "ok", imported[module]


def test_blocker_really_blocks():
    proc = run_without_jax("import jax")
    assert proc.returncode != 0 and "blocked import of jax" in proc.stderr


def test_blocker_blocks_transformers():
    proc = run_without_jax("import transformers")
    assert proc.returncode != 0 and "blocked import of transformers" in proc.stderr


@pytest.mark.parametrize("name", ["tortoise_tpu", "tortoise_tpu.presets",
                                  "tortoise_tpu.utils.cleaners"])
def test_blocker_blocks_the_jax_package(name):
    proc = run_without_jax(f"import {name}")
    assert proc.returncode != 0 and "blocked import of tortoise_tpu" in proc.stderr


def test_blocker_lets_the_port_through():
    proc = run_without_jax("import tortoise_tpu_torch.presets; print('ok')")
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
