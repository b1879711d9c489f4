"""Run `benchmark/run.py`'s `main` in a fresh process, as a benchmark run
would, but on the CPU and on a benchmark folder of the test's own."""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SCRIPT = """
import sys
from pathlib import Path
sys.path.insert(0, {root!r})
from benchmark import run
sys.exit(run.main({argv!r}, device="cpu", bench_dir=Path({bench!r})))
"""


def run_main(bench: Path, argv, timeout=300):
    """(returncode, stdout lines, stderr lines) of one run."""
    code = SCRIPT.format(root=str(ROOT), argv=list(argv), bench=str(bench))
    env = dict(os.environ, OMP_NUM_THREADS="4")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)
    return (proc.returncode, proc.stdout.splitlines(),
            proc.stderr.splitlines())


def last_json(lines):
    return json.loads(lines[-1])
