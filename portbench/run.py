"""The benchmark of ``synapta_tpu_torch`` on NVIDIA GPUs: one run of one
cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Earlier lines: the card (name, power limit,
clocks), the host's CPU model and cores, the shelf's generation seconds,
the books and pages done and the pipeline's errors. The last line of
standard output is the result object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``; with ``--trace 1`` also
``breakdown``), its last key ``checks``: every number compared, with its
limit, also printed as the last lines of standard error. Exits 2, printing
no result, without a CUDA card (or with fewer than the cell asks for), and
1 when JAX or the JAX package is loaded once the window has closed.
"""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# every build and kernel cache at a fixed path inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(HERE, "_cache", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, "_cache", "triton")
os.environ.setdefault("SYNAPTA_LOG_LEVEL", "WARNING")


def main() -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="put the control, the reference in fp8, in the "
                         "program's place for the model comparisons, and "
                         "each comparison a configuration brings its own "
                         "control (a check of the comparison: it has to "
                         "read false)")
    ap.add_argument("--shelf", type=int, default=None,
                    help="make only the shelf's first N books (short runs "
                         "that read the comparison, not the metrics)")
    args = ap.parse_args()

    # the native PDF engine needs libjpeg.so.62: where the system has none
    # the process re-executes itself with Pillow's copy on the loader path
    from synapta_tpu_torch.hostlibs import ensure_native_engine

    ensure_native_engine([os.path.abspath(__file__), *sys.argv[1:]])
    from portbench import harness

    proc_start = harness.process_start_epoch()
    bench = harness.load_benchmark()
    cell = harness.cell_spec(bench, args.workload)
    import torch

    chips = int(cell["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, "
              f"count: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(harness.card_line(), flush=True)
    print(json.dumps(harness.host_line()), flush=True)
    result = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), device="cuda",
                              proc_start=proc_start, control=args.control,
                              shelf_books=args.shelf)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: loaded {found}", file=sys.stderr)
        return 1
    for name, row in result["checks"].items():
        print(f"check {name} {row['value']} limit {row['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
