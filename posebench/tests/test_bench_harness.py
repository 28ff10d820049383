"""The harness: every cell, configuration, traffic mix, driver and metric
of BENCHMARK.json found by its name; the result line; the import guard;
no result without a card."""

import json
import os
import subprocess
import sys

import pytest
import torch

from posebench import harness
from posebench.tests.tiny_cells import serve_b64, train_b32

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_is_found_by_name(name):
    cell = harness.find_cell(name)
    assert cell.config["name"] == cell.entry["config"]
    assert callable(harness.load_driver(cell.driver).run)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(harness.load_metric(m["name"]).read)
    assert set(cell.limits) and all(v >= 0 for v in cell.limits.values())


def test_a_cell_a_metric_and_a_config_added_by_entries_alone():
    """What a later PR adds: entries that name existing or new files; the
    harness reads them by name; a per-layer metric goes to the cells its
    `workloads` lists, and one without the key is refused."""
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(bench["configs"][0], name="another_cfg"))
    bench["workloads"].append(dict(bench["workloads"][0], name="another",
                                   config="another_cfg"))
    bench["end_to_end"][1]["workloads"].append("another")
    bench["per_layer"].append({"name": "serve.new_metric", "unit": "ms",
                               "better": "lower", "source": "device_trace",
                               "layer": "pose fit", "moves": "clouds_per_s",
                               "workloads": ["serve_b64_offline"]})
    with pytest.raises(FileNotFoundError):    # no workloads/another.json
        harness.find_cell("another", bench)
    unlisted = json.loads(json.dumps(bench))
    del unlisted["per_layer"][-1]["workloads"]
    with pytest.raises(KeyError):
        harness.find_cell("serve_b64_offline", unlisted)
    cell = harness.find_cell("serve_b64_offline", bench)
    assert "serve.new_metric" in [m["name"] for m in cell.per_layer]
    train = harness.find_cell("train_fused_b32", bench)
    assert "serve.new_metric" not in [m["name"] for m in train.per_layer]

    class Reader:
        @staticmethod
        def read(trace):
            return 2.5 if trace.get("kind") == "serve" else None

    got = harness.per_layer_metrics(
        cell, {"kind": "serve"},
        load=lambda n: Reader if n == "serve.new_metric" else
        type("Nothing", (), {"read": staticmethod(lambda t: None)}))
    assert got == {"serve.new_metric": {"value": 2.5, "unit": "ms"}}
    with pytest.raises(KeyError):
        harness.find_cell("no_such_cell")


def test_result_line_puts_the_checks_last():
    cell = harness.find_cell("serve_b64_offline")
    outcome = harness.Outcome(
        setup_s=12.5, e2e={"clouds_per_s": 1000.0}, attempted=64, failed=0,
        checks=harness.checks_of({"heads_ratio": 1.0, "fit_gap": 0.0,
                                  "counts_gap": 0.0}, cell.limits),
        memory_peak_bytes=123)
    line = json.loads(harness.result_line(
        cell, outcome, False, {"platform": "gpu"},
        harness.e2e_metrics(cell, outcome)))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True
    assert line["metrics"] == {
        "setup_s": {"value": 12.5, "unit": "s"},
        "clouds_per_s": {"value": 1000.0, "unit": "clouds/s"}}
    bad = harness.checks_of({"heads_ratio": float("nan"), "fit_gap": 0.0,
                             "counts_gap": 0.0}, cell.limits)
    assert not bad[0].ok


def _run_untraced_on_the_cpu():
    import time
    for cell in (serve_b64(), train_b32()):
        out = harness.load_driver(cell.driver).run(
            cell, seed=3, seconds=0.2, trace=False,
            t_start=time.perf_counter(), device="cpu")
        assert all(c.ok for c in out.checks), out.checks
        assert out.memory_peak_bytes == 0       # no card, no device peak


def test_plumbing_loads_no_jax():
    """Both drivers' runs at tiny widths in a fresh process, then its
    modules: none of JAX's or the JAX package's, by whole top-level
    name; the port's, whose name begins with the JAX package's, is
    there."""
    probe = ("import sys, time; sys.path.insert(0, '.');"
             "from posebench.tests.test_bench_harness import "
             "_run_untraced_on_the_cpu as r; r();"
             "from posebench import harness;"
             "print(harness.forbidden_modules(),"
             " 'articulated_pose_tpu_torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", probe], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_reference_imports_nothing_of_the_port():
    probe = ("import sys; sys.path.insert(0, '.');"
             "import posebench.reference.model, posebench.reference.train,"
             " posebench.reference.pipeline, posebench.reference.synthetic,"
             " posebench.reference.ops;"
             "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not tops & {"articulated_pose_tpu_torch", "articulated_pose_tpu",
                       "jax", "jaxlib", "flax"}


def test_no_result_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "posebench/run.py", "--workload",
         "serve_b64_offline", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, env=env,
        timeout=300)
    assert out.returncode == 3
    assert out.stdout.strip() == ""


def test_traced_run_needs_a_card():
    """A measurement path without a card fails: it never reads a device
    metric off the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    import time
    cell = serve_b64()
    with pytest.raises((RuntimeError, AssertionError, AttributeError)):
        harness.load_driver(cell.driver).run(
            cell, seed=3, seconds=0.1, trace=True,
            t_start=time.perf_counter(), device="cpu")
