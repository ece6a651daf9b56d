"""Readings for the limits of ``correct``: the program's numbers and the
control's, seed by seed, in one process.

    python3 -m portbench.control --workload <cell> --seeds 11,12,13 --seconds 20 \
        [--out chiprun_out/control-<cell>.jsonl]

For each seed: the cell's pipeline with that seed's weights, the warm
requests, a closed-loop window of ``--seconds`` at the cell's own load, then
(the program freed) the reference judges the window's first requests twice:
as the benchmark does (the program's numbers, the lower readings) and with
the reference in the precision below the configuration's in the
program's place (the control's numbers, the upper readings:
``check.BELOW``). Each side is decided against the cell's limits
(``limits/<cell>.json``): the program has to come out correct, the control
not. One JSON line a seed, and a last line with the largest program reading
and the smallest control reading of each number. The benchmark's own runs
do not run this; it needs a CUDA card.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time


def readings(bench, cell, seed: int, seconds: float, device="cuda", options=None,
             limits: dict | None = None) -> dict:
    import torch

    from portbench import check, traffic
    from portbench.run import serve_window, warm
    from portbench.system import Driver, load_config

    here = os.path.dirname(os.path.abspath(__file__))
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    path = cfg_entry["file"]
    config = load_config(path if os.path.isabs(path) else os.path.join(here, "..", path))
    mix = traffic.load_mix(cell["traffic"])
    t0 = time.perf_counter()
    driver = Driver(config, mix, seed, device, options)
    warm(driver, mix, seed)
    served, kept, window, _ = serve_window(driver, traffic.requests(mix, seed), mix, seconds,
                                           False)
    off, _ = check.structure(served, mix, config)
    driver.close()
    del driver, served
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    judge = check.Judge(config, seed, device)
    program = judge.numbers(kept, mix)
    program["structure_off"] = off
    control = judge.numbers(kept, mix, control=True)
    if limits is None:
        with open(os.path.join(here, "limits", f"{cell['name']}.json")) as f:
            limits = json.load(f)
    # the control is decided on the numbers it reads (structure_off is the program's alone)
    program_ok, _ = check.decide(program, limits)
    control_ok, _ = check.decide(control, {k: v for k, v in limits.items() if k in control})
    return {"seed": seed, "judged": len(kept), "program": program, "control": control,
            "program_correct": program_ok, "control_correct": control_ok,
            "window_s": window[1] - window[0], "seconds": time.perf_counter() - t0}


def summary(rows: list[dict]) -> dict:
    names = sorted({k for r in rows for k in r["program"]})
    return {name: {"program_max": max(r["program"][name] for r in rows),
                   "control_min": min((r["control"][name] for r in rows if name in r["control"]),
                                      default=None)} for name in names}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("portbench.control needs a CUDA card", file=sys.stderr)
        return 2
    with open("BENCHMARK.json") as f:
        bench = json.load(f)
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        rows.append(readings(bench, cell, seed, args.seconds))
        print(json.dumps(rows[-1]), flush=True)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(rows[-1]) + "\n")
    print(json.dumps({"workload": args.workload, "summary": summary(rows),
                      "program_correct_on_every_seed": all(r["program_correct"] for r in rows),
                      "control_not_correct_on_every_seed":
                          not any(r["control_correct"] for r in rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
