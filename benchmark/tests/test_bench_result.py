"""A whole run on the CPU past the look for a card: the last line's keys,
the numbers compared as the last lines of standard error, and no module
of JAX or of the JAX package loaded in the process that prints the
result."""
import pytest

from benchmark import harness
from benchmark.tests import runner, tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def plain_run(tmp_path_factory):
    bench = tiny.write_bench(tmp_path_factory.mktemp("plain"))
    return runner.run_main(bench, ["--workload", "tiny-grid4", "--seed",
                                   str(2**31 + 5), "--seconds", "0",
                                   "--trace", "0"])


def test_last_line_keys_and_metrics(plain_run):
    rc, out, err = plain_run
    assert rc == 0, "\n".join(err[-20:])
    line = runner.last_json(out)
    assert list(line)[:5] == KEYS
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"setup_s", "scene_s", "patches_per_s"}
    assert line["metrics"]["patches_per_s"]["unit"] == "patches/s"
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["checks"]) == {"accuracy_px", "completeness",
                                   "photo_fail_share", "near_miss_share",
                                   "refine_gain"}
    for c in line["checks"].values():
        assert set(c) == {"value", "op", "limit"}


def test_checks_are_the_last_lines_of_stderr(plain_run):
    _, out, err = plain_run
    names = list(runner.last_json(out)["checks"])
    tail = err[-len(names):]
    assert [t.split()[1] for t in tail] == names
    assert all(t.startswith("[check] ") and t.endswith(" ok") for t in tail)


def test_no_jax_in_the_measured_process(plain_run):
    rc, out, err = plain_run
    # run.main exits 3, with no result, if it finds one loaded
    assert rc == 0 and not any("loaded in the measured" in e for e in err)


@pytest.mark.parametrize("names, found", [
    (["jax", "torch"], ["jax"]),
    (["jaxlib.xla_client", "numpy"], ["jaxlib.xla_client"]),
    (["flax.linen"], ["flax.linen"]),
    (["densepoints_tpu", "densepoints_tpu.ops.ncc"],
     ["densepoints_tpu", "densepoints_tpu.ops.ncc"]),
    (["densepoints_tpu_torch", "densepoints_tpu_torch.pmvs.pipeline",
      "jaxtyping", "benchmark.harness"], []),
])
def test_forbidden_by_whole_top_level_name(names, found):
    assert harness.forbidden_modules(names) == found
