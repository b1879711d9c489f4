"""Run one cell of the port's benchmark once and print its result.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

From the root of a checkout. Needs a CUDA card (as many as the cell asks
for): without one it prints why on standard error and exits 2, with no
result. `--trace 0` reports the end-to-end metrics (`setup_s`, `scene_s`,
`patches_per_s`); `--trace 1` runs the window under `torch.profiler` and
reports the per-layer metrics, the device's busy seconds and a breakdown.
The last line of standard output is the result, a JSON object; the numbers
the correctness check compared, each beside its limit, are the last lines
of standard error. A run that finds `jax`, `jaxlib`, `flax` or the JAX
package loaded once the window has closed names them and exits 3. A cell
of several cards runs as one job of a rank a card (`ranks.py`), started in
set-up; a rank that fails makes the run exit non-zero with its traceback.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device="cuda", bench_dir=None) -> int:
    """The run. `device` and `bench_dir` are for the CPU tests, which
    drive a run past the look for a card on a benchmark folder of their
    own."""
    args = parse_args(argv)
    from benchmark import harness

    bench_dir = bench_dir or harness.BENCH_DIR
    cell = harness.load_cell(args.workload, bench_dir)
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        print("no CUDA card: the benchmark measures the port on a card and "
              "has no CPU fallback", file=sys.stderr)
        return 2
    if device == "cuda" and torch.cuda.device_count() < cell["chips"]:
        print(f"cell {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} seen", file=sys.stderr)
        return 2
    if cell["chips"] > 1:
        from benchmark import ranks

        result, checks, found = ranks.run_job(
            cell, args.seed, args.seconds, bool(args.trace), device,
            T_PROCESS, bench_dir)
        found = sorted(set(found) | set(harness.forbidden_modules(
            sys.modules)))
    else:
        result, checks = harness.run_cell(
            cell, args.seed, args.seconds, bool(args.trace), device,
            T_PROCESS, readers=harness.metric_readers(bench_dir))
        found = harness.forbidden_modules(sys.modules)
    if found:
        print(f"loaded in the measured process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
