"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. ``--trace 0`` reports the cell's end-to-end
metrics over ``--seconds``; ``--trace 1`` its per-layer metrics from a
profiled window of twice the traffic's ``trace_requests`` requests. The
last line of standard output is one JSON object; the last lines of
standard error give each number compared with the reference beside its
limit. Exits 0 only with a result; without the cell's cards, or with JAX
or the JAX package loaded, it prints no result and exits 3 or 4.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(
        os.path.abspath(__file__)):
    sys.path.pop(0)
sys.path.insert(0, ROOT)
# caches of kernels compiled at run time stay inside the checkout, at fixed
# paths, so that a checkout's later runs find them
CACHE = os.path.join(ROOT, ".bench_cache")
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(CACHE, "torch_extensions"))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="benchmark/run.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from benchmark.harness import registry, runner

    try:
        cell = registry.find_cell(args.workload, registry.load_spec(ROOT))
    except registry.UnknownName as err:
        print(f"benchmark: {err}", file=sys.stderr)
        return 2
    try:
        result = runner.run_cell(cell, args.seed, args.seconds,
                                 bool(args.trace), T0)
    except runner.NoDevice as err:
        print(f"benchmark: {err}; no result", file=sys.stderr)
        return 3
    loaded = runner.forbidden_modules()
    if loaded:
        print(f"benchmark: JAX or the JAX package is loaded: {loaded}; "
              "no result", file=sys.stderr)
        return 4
    checks = result.pop("checks")
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    line = {"correct": result["correct"], "attempted": result["attempted"],
            "failed": result["failed"], "metrics": result["metrics"],
            "device": result["device"]}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                      for c in checks}
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
