"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

(or ``python3 -m portbench.run ...``) from the root of a checkout. Needs a
CUDA device: without one, or with fewer than the cell asks for, it exits
with code 2 and prints no result. The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared beside its limit); the last lines of standard error give
the same checks.
"""

import time

T_START = time.perf_counter()  # set-up counts from here, before torch is imported

import os  # noqa: E402
import sys  # noqa: E402

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Compiled bytecode of every module the run imports (torch's too) is cached
# inside the checkout, at a fixed path, even where the environment says not
# to write bytecode: the first run in a checkout compiles and writes it, every
# later run loads it. Without it each run compiles torch's Python sources anew.
sys.dont_write_bytecode = False
sys.pycache_prefix = os.path.join(CHECKOUT, ".portbench_cache", "bytecode")

import argparse  # noqa: E402
import json  # noqa: E402

if __package__ in (None, ""):  # run as a script: the checkout's root holds both packages
    sys.path.insert(0, CHECKOUT)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Run one cell of the port's benchmark.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    marks = []  # set-up's parts, each to its end
    import torch
    marks.append(("import torch", time.perf_counter()))

    from portbench import harness
    marks.append(("portbench", time.perf_counter()))

    cells = {w["name"]: w for w in harness.load_json(harness.ROOT.parent / "BENCHMARK.json")["workloads"]}
    if args.workload not in cells:
        print(f"portbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2
    marks.append(("CUDA found", time.perf_counter()))
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T_START, marks=marks)
    if result is None:
        return 3
    for name, c in result["checks"].items():
        print(f"[portbench] check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
