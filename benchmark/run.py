#!/usr/bin/env python3
"""Run one cell of the benchmark of leclip_tpu_torch once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's entry in BENCHMARK.json names its configuration
(benchmark/configs/<config>.json) and its file of traffic parameters
(benchmark/workloads/<cell>.json), which names the driver that generates
that kind of traffic (benchmark/traffic/<driver>.py). Inputs and weights are
made from ``--seed``. The last line of standard output is one JSON object:
with ``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics (one reader each, benchmark/metrics/<metric>.py), the
device's busy time and a breakdown. Each number that decides ``correct`` is
printed beside its limit, as the last lines of standard error and under the
result's last key.

``--readings N`` instead reads, for N seeds from ``--seed`` on, the numbers
a cell's limits are set from (the program's against the reference, and the
control's), each held against the cell's limit as a run holds it, in one
process, and prints them as one JSON line."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


class Context:
    """One run: the cell, its configuration and traffic parameters, the
    seed, the window and the device."""

    def __init__(self, bench, entry, params, config, args, torch, device):
        self.bench, self.entry, self.params, self.config = bench, entry, params, config
        self.cell = entry["name"]
        self.seed, self.seconds, self.trace = args.seed, float(args.seconds), bool(args.trace)
        self.torch, self.device, self.t0 = torch, device, T0

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()


def fail(msg: str, code: int = 2):
    print(msg, file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--readings", type=int, default=0)
    ap.add_argument("--sweep", default="", help="a service cell: offered rates, comma "
                    "separated, each held for --seconds, to find the knee")
    args = ap.parse_args(argv)

    bench_path = os.path.join(ROOT, "BENCHMARK.json")
    if not os.path.exists(bench_path) or not os.path.isdir(os.path.join(ROOT,
                                                                        "leclip_tpu_torch")):
        fail("no BENCHMARK.json or no leclip_tpu_torch package beside benchmark/: "
             "nothing to measure")
    with open(bench_path) as f:
        bench = json.load(f)
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        fail(f"no workload {args.workload!r} in BENCHMARK.json")
    from benchmark import harness

    params = harness.load_json(os.path.join("workloads", entry["name"] + ".json"))
    config = harness.load_json(os.path.join("configs", entry["config"] + ".json"))

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        fail(f"{args.workload} needs {entry['chips']} CUDA device(s); "
             f"torch.cuda.is_available() = {torch.cuda.is_available()}")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    ctx = Context(bench, entry, params, config, args, torch, device)
    driver = importlib.import_module("benchmark.traffic." + params["driver"])

    if args.sweep:
        rows = driver.sweep(ctx, [float(r) for r in args.sweep.split(",")], args.seconds)
        print(json.dumps({"workload": args.workload, "card": torch.cuda.get_device_name(0),
                          "sweep": rows}), flush=True)
        return
    if args.readings:
        seeds = [args.seed + i for i in range(args.readings)]
        rows = driver.readings(ctx, seeds, args.seconds)
        print(json.dumps({"workload": args.workload, "card": torch.cuda.get_device_name(0),
                          "readings": rows}), flush=True)
        return

    out = driver.run(ctx)
    bad = harness.banned_modules()
    if bad:
        fail(f"modules of the JAX package or JAX loaded in this process: {bad}", 3)

    result = harness.result_line(bench, entry["name"], out, bool(args.trace))
    checks = out["checks"]
    for line in harness.compared_lines(checks):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
