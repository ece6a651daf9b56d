"""Run one cell of the benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout holding ``BENCHMARK.json``. The cell names a
configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<mix>.json``); its limits are ``limits/<cell>.json`` and every
metric is read by ``metrics/<metric>.py``. The run builds the pipeline of
``tortoise_tpu_torch`` with weights made from the seed, answers the mix's
warm requests, then serves the mix as one closed-loop client: with ``--trace 0``
for ``--seconds`` (the window ends at the last completion), printing the
cell's end-to-end metrics; with ``--trace 1`` the mix's first
``trace_requests`` requests under ``torch.profiler``, printing its
per-layer metrics, the device's busy seconds and the traced window, and
the longest device operations and idle gaps. Then every request is held
to what it asked, the program is freed and the plain reference judges the
window's first ``check_requests`` requests (``check.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (``breakdown`` when
traced) and last ``checks``, each number compared beside its limit, which
also end standard error. Without a CUDA card (or with fewer than the cell
asks for) the run exits with 2 and prints no result; if the process holds
JAX or the JAX package once the window has closed, with 3.
"""
from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "tortoise_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is JAX's, Flax's or the
    JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def read_metric(name: str, ctx):
    """``metrics/<name>.py``'s ``read(ctx)``: a number, or None (nothing to read)."""
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  os.path.join(HERE, "metrics", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    value = module.read(ctx)
    return None if value is None else float(value)


def cell_metrics(bench: dict, cell: str, kind: str) -> list[dict]:
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def warm(driver, mix: dict, seed: int) -> None:
    """Set-up's warm requests: the kernels built and loaded, the shapes of
    the mix's sizes met once."""
    from portbench import traffic

    gen = traffic.requests(mix, int(seed) + 1)
    for _ in range(int(mix.get("warm_requests", 1))):
        driver.serve(next(gen))


def serve_window(driver, gen, mix, seconds: float, trace: bool):
    """Serve the window; returns (served, kept, (start, end), profiler or None)."""
    import torch

    served, kept = [], []
    check = int(mix["check_requests"])

    def one():
        req = next(gen)
        keep = len(kept) < check
        s = driver.serve(req, keep)
        served.append(s)
        if keep:
            kept.append(s)

    if not trace:
        # at least the judged requests, which a window of the cell's length
        # always holds (a short trial window may not)
        start = time.perf_counter()
        while time.perf_counter() - start < seconds or len(served) < check:
            one()
        return served, kept, (start, served[-1].done), None
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("portbench.window"):
            start = time.perf_counter()
            for _ in range(int(mix["trace_requests"])):
                one()
            torch.cuda.synchronize()
    return served, kept, (start, served[-1].done), prof


def run_cell(bench: dict, cell: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", options: dict | None = None,
             process_start: float = PROCESS_START,
             limits: dict | None = None) -> tuple[dict, list[str]]:
    """One run of ``cell``; returns (the result object, the check lines).
    ``device``, ``options`` (extra constructor arguments) and ``limits``
    let the tests run a tiny cell on the CPU."""
    import torch

    from portbench import check, traffic
    from portbench import trace as trace_lib
    from portbench.system import Driver, load_config

    name = cell["name"]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = load_config(cfg_entry["file"] if os.path.isabs(cfg_entry["file"])
                         else os.path.join(HERE, "..", cfg_entry["file"]))
    mix = traffic.load_mix(cell["traffic"])
    limits = limits or load_json(HERE, "limits", f"{name}.json")
    on_card = torch.device(device).type == "cuda"

    driver = Driver(config, mix, seed, device, options)
    warm(driver, mix, seed)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - process_start

    gen = traffic.requests(mix, seed)
    served, kept, window, prof = serve_window(driver, gen, mix, seconds, trace)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    ctx = types.SimpleNamespace(served=served, mix=mix, config=config, setup_s=setup_s,
                                window=window, peak_bytes=peak, trace=None)
    result = {"correct": False, "attempted": len(served), "failed": 0, "metrics": {}}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    if trace:
        dev, host = trace_lib.events(prof)
        span = [(s, e) for n, s, e in host if n == "portbench.window"]
        red = trace_lib.reduce(dev, host, span[0])
        ctx.trace = red
        device_info.update(busy_s=red["busy_s"], window_s=red["window_s"])
        result["breakdown"] = {"device_ops": red["device_ops"], "idle_gaps": red["idle_gaps"]}
        del prof, dev, host
    kind = "per_layer" if trace else "end_to_end"
    for m in cell_metrics(bench, name, kind):
        value = read_metric(m["name"], ctx)
        if value is not None:
            result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    result["device"] = device_info

    # what every request did against what it asked (exact), then, the
    # program freed, the reference judges what the window kept
    off, off_lines = check.structure(served, mix, config)
    program_specs = driver.specs
    driver.close()
    del driver, served, ctx
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    judge = check.Judge(config, seed, device)
    numbers = judge.numbers(kept, mix)
    numbers["structure_off"] = off
    correct, lines = check.decide(numbers, limits)
    lines = off_lines + lines
    for model, entries in judge.specs.items():
        if program_specs.get(model) != entries:
            correct = False
            lines.append(f"weights of {model}: the program's parameters differ from the "
                         "reference's FAIL")
    result["correct"] = bool(correct)
    result["checks"] = {k: {"value": numbers.get(k), "limit": v} for k, v in limits.items()}
    return result, lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = os.getcwd()
    bench = load_json(root, "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    # every build and kernel cache inside the checkout, at fixed paths
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_ext")):
        os.environ[var] = os.path.join(root, "build", sub)
    os.environ["USE_FLAX"] = "0"
    # one client in one process with one intra-op thread: the host work of
    # a request spreads least between runs so (fast-stream at 51 s, three
    # runs each, chip run PR 18: 21.14-21.82 audio_s/s against 20.53-21.22)
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, lines = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"the process holds {', '.join(found)} once the window has closed",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
