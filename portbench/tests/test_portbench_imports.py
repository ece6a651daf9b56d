"""Nothing the harness runs loads JAX or the JAX package, and the
reference imports nothing of the program."""
import ast
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.join(HERE, "..", "..")
FORBIDDEN = {"jax", "jaxlib", "flax", "tortoise_tpu"}

RUN_TINY = """
import sys
from portbench import control, counts, run
bench = {"configs": [{"name": "t", "file": "portbench/tests/tiny-fast.json"}]}
cell = {"name": "t", "config": "t", "traffic": "portbench/tests/tiny-stream.json", "chips": 1}
control.readings(bench, cell, 3, 0.5, device="cpu", options={"gpt_fused_step": True},
                  limits={"structure_off": 0})
print("loaded:" + ",".join(sorted(m for m in sys.modules if m.split(".")[0] in %r)))
""" % (FORBIDDEN,)


def test_a_tiny_run_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(ROOT))
    out = subprocess.run([sys.executable, "-c", RUN_TINY], cwd=ROOT, env=env, check=True,
                         capture_output=True, text=True, timeout=300)
    assert out.stdout.strip().splitlines()[-1] == "loaded:"


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    from portbench import run
    monkeypatch.setitem(sys.modules, "tortoise_tpu_torch_x", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "tortoise_tpu.api", object())
    assert run.forbidden_modules() == ["tortoise_tpu.api"]


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(HERE, "..", "reference")
    for name in os.listdir(ref):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(ref, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                tops = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not set(tops) & (FORBIDDEN | {"tortoise_tpu_torch"}), (name, tops)
