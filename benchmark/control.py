"""The control of a cell's comparison: the reference put in the program's
place and computed in the precision below the configuration's (bfloat16
for its float32), read as a run's check reads the program.

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13

Prints one JSON line per seed: the numbers a run compares, as the control
reads them. Not part of a run: it sets the upper end of each limit.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(
        os.path.abspath(__file__)):
    sys.path.pop(0)
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="benchmark/control.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)

    import torch

    from benchmark.harness import registry

    cell = registry.find_cell(args.workload, registry.load_spec(ROOT))
    kind = registry.load_module("kinds", cell.traffic["kind"])
    device = torch.device("cuda")
    for seed in args.seeds:
        t = time.time()
        readings = kind.control(cell.config, cell.traffic, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": {r["name"]: r["value"]
                                      for r in readings},
                          "seconds": time.time() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
