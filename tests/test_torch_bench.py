"""The port's bench harnesses (``ray_tpu_torch/_private/*_bench.py`` and
``ray_perf.py``) on the CPU, against the JAX package's where a number of
one must equal the other's.

``serve_load_bench``: ``prefix_ab`` at the JAX harness's tiny config with
``device="cpu"`` gives the JAX harness's tokens and prefill counts (both
engines draw their weights from seed 0 through the same numpy converter);
``chunked_prefill_ab`` at a short prompt has the JAX row's keys; ``sse_load``
puts 8 streams over 2 CPU replicas through the HTTP proxy with none shed
and none cut.  ``pipeline_bench`` at one M has the JAX rows' keys and
theoretical bubble, and its critical path reconciles.  ``collective_bench``
at 1 MiB, world 2, moves the JAX harness's wire bytes per rank, its int8
error inside the ring's bound.  The JAX harnesses run in one child process
(on a JAX runtime for the collective row) while the port's run here.  ``ray_perf``, ``recovery_bench`` and ``rl_bench`` (one
round, the learner on the CPU) return their rows.  Without a card, the
harnesses' card paths raise.  The engines' card share
(``engine_kwargs["num_gpus"]``) is checked here too.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

import ray_tpu_torch
from ray_tpu_torch._private import pipeline_bench, serve_load_bench

REPO = pathlib.Path(__file__).resolve().parent.parent
LONG_LEN = 192  # the chunked arm's prompt on the CPU (4096 on the card)


# the JAX harnesses' rows, computed in one child process while the port's
# run here: prefix_ab's arms, chunked_prefill_ab, pipeline_bench at M 1
# and one round, and collective_bench at 1 MiB, world 2, on a JAX runtime
_JAX_ROWS = f"""
import json
import ray_tpu
from ray_tpu._private import collective_bench, pipeline_bench, serve_load_bench
out = {{"prefix_arms": {{str(e): serve_load_bench._run_prefix_arm(e)
                        for e in (False, True)}},
       "chunked": serve_load_bench.run_chunked_ab(long_len={LONG_LEN})}}
pipeline_bench.MICROS, pipeline_bench.ROUNDS = (1,), 1
out["pipeline"] = pipeline_bench.run_pipeline_bench()
ray_tpu.init(num_cpus=3)
try:
    out["collective"] = collective_bench.run_collective_bench(
        sizes=[1 << 20], worlds=[2])["rows"][0]
finally:
    ray_tpu.shutdown()
print("JAX_ROWS=" + json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def jax_rows():
    """The JAX harnesses' rows (``_JAX_ROWS``), started with the module and
    read by the first test that needs them."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    proc = subprocess.Popen([sys.executable, "-c", _JAX_ROWS], cwd=str(REPO),
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    holder = {}

    def result():
        if "rows" not in holder:
            out, err = proc.communicate(timeout=300)
            line = next((x for x in out.splitlines()
                         if x.startswith("JAX_ROWS=")), None)
            assert line is not None, err[-3000:]
            holder["rows"] = json.loads(line[len("JAX_ROWS="):])
        return holder["rows"]
    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def runtime():
    # one advertised card, so that a card share schedules; every engine and
    # learner here runs on the CPU
    ray_tpu_torch.init(num_cpus=6, num_gpus=1,
                       object_store_memory=512 * 1024 ** 2)
    yield
    ray_tpu_torch.shutdown()


# ================================================== the host harnesses

def test_ray_perf_rows_and_baseline(runtime):
    from ray_tpu._private import ray_perf as jax_perf
    from ray_tpu_torch._private import ray_perf

    assert ray_perf.BASELINE == jax_perf.BASELINE
    # the harness pins this thread, and so the threads it starts later, to
    # one core: give the rest of this process its cores back
    cores = os.sched_getaffinity(0)
    try:
        out = ray_perf.run_microbenchmarks(duration_s=0.05, large_put_mb=4)
    finally:
        os.sched_setaffinity(0, cores)
    for key in ray_perf.BASELINE:
        assert out[key] > 0, key
        assert f"{key}_vs_baseline" in out
    assert out["host_memcpy_gigabytes"] > 0
    assert "1MiB" in out["put_bandwidth_sweep_gigabytes"]
    assert ray_perf.host_cpu_count() >= 1


def test_recovery_bench_rows(runtime):
    from ray_tpu_torch._private.recovery_bench import run_recovery_bench

    out = run_recovery_bench()
    kill = out["worker_kill_sync"]
    assert sorted(kill) == ["baseline_task_ms", "killed_task_total_ms",
                            "recovery_ms"]
    assert kill["recovery_ms"] >= 0
    rank = out["rank_kill_allreduce_w4"]
    assert rank["detect_ms"] >= 0 and rank["rebuild_ms"] >= 0
    assert rank["slo"] in ("pass", "fail", "none")


def test_rl_bench_one_round_on_the_cpu(runtime):
    from ray_tpu_torch._private.rl_bench import run_rl_bench

    out = run_rl_bench(n_rounds=1, device="cpu")
    assert out["rounds"] == 1
    for arm in ("relaunch", "streaming", "sebulba"):
        assert out[arm]["env_steps"] > 0 and out[arm]["env_steps_per_s"] > 0
    assert out["sebulba"]["inference_requests"] > 0
    assert out["sebulba"]["inference_max_batch_occupancy"] >= 1
    assert out["streaming_speedup"] > 0


# ============================================================ serve_load

def test_sse_load_8_streams_over_2_cpu_replicas(runtime):
    out = serve_load_bench.run_sse_load(num_streams=8, num_replicas=2,
                                        max_tokens=6, metrics_wait_s=0.0,
                                        device="cpu")
    assert out["completed"] == 8, out
    assert out["half_streams"] == 0, out
    assert out["shed"] == 0, out
    assert out["replicas"] == 2
    assert out["goodput_tokens_per_s"] > 0


def test_engine_card_share(runtime):
    from ray_tpu_torch.llm.deployment import _engine_options

    kwargs = {"num_gpus": 0.5, "seed": 0}
    assert _engine_options(kwargs) == {"num_cpus": 0, "num_gpus": 0.5}
    assert kwargs == {"seed": 0}  # the share is not an engine argument
    assert _engine_options({}) == {"num_cpus": 0, "num_gpus": 1.0}
    assert _engine_options({"device": "cpu", "num_gpus": 0.5}) == \
        {"num_cpus": 0}
    for bad in (0, 1.5):
        with pytest.raises(ValueError, match="share of one card"):
            _engine_options({"num_gpus": bad})


# ============================================================== pipeline

def test_train_3d_bench_rows():
    """The (1, 1, 2) cell and the int8 (2, 1, 1) cell the harness always
    adds, at two steps (one timed), with the JAX rows' keys
    (``ray_tpu/_private/pipeline_bench.py`` ``_run_3d_config``)."""
    port = pipeline_bench.run_train_3d_bench(device="cpu",
                                             configs=((1, 1, 2),), steps=2)
    assert sorted(port) == ["batch", "configs", "host_cpus", "n_micro",
                            "seq", "steps_timed"]
    assert port["steps_timed"] == 1
    keys = ["comm_bucket_s", "dp", "overlap_fraction", "pp", "step_wall_s",
            "tp", "wire_bytes"]
    pp2, int8 = port["configs"]
    assert sorted(pp2) == keys and sorted(int8) == sorted(keys + ["quant"])
    assert (pp2["dp"], pp2["pp"], pp2["wire_bytes"]) == (1, 2, 0)
    assert int8["quant"] == "int8" and int8["wire_bytes"] > 0


def test_card_paths_raise_without_a_card():
    """No fallback: the default device is the card."""
    with pytest.raises(Exception, match="(?i)cuda|card|gpu"):
        serve_load_bench.run_prefix_ab()
    with pytest.raises(Exception, match="(?i)cuda|card|gpu"):
        serve_load_bench.run_chunked_ab(long_len=LONG_LEN)
    with pytest.raises(Exception, match="(?i)cuda|card|gpu"):
        pipeline_bench.run_pipeline_bench(micros=(1,), rounds=1)
    with pytest.raises(Exception, match="(?i)cuda|card|gpu"):
        pipeline_bench.run_train_3d_bench(configs=((1, 1, 2),))


# ================================= against the JAX harnesses' rows
# (last, so that the child computes them while the tests above run)

@pytest.fixture(scope="module")
def prefix_arms(jax_rows):
    arms = {("jax", e): jax_rows()["prefix_arms"][str(e)]
            for e in (False, True)}
    arms.update({("port", e): serve_load_bench._run_prefix_arm(e, "cpu")
                 for e in (False, True)})
    return arms


@pytest.mark.parametrize("enable", [False, True])
def test_prefix_arm_tokens_and_counts_equal_the_jax_harness(prefix_arms,
                                                            enable):
    port, ref = prefix_arms[("port", enable)], prefix_arms[("jax", enable)]
    assert port["outputs"] == ref["outputs"]
    assert len(port["outputs"]) == 16
    assert all(len(t) == 8 for t in port["outputs"])
    assert (port["prefilled_tokens"], port["prefix_hit_tokens"]) == \
        (ref["prefilled_tokens"], ref["prefix_hit_tokens"])


def test_prefix_ab_row_equals_the_jax_harness(prefix_arms):
    """The row as ``run_prefix_ab`` builds it from the arms, on both."""
    from ray_tpu._private import serve_load_bench as jax_bench

    rows = {}
    for pkg, bench in (("jax", jax_bench), ("port", serve_load_bench)):
        arms = {e: prefix_arms[(pkg, e)] for e in (False, True)}
        orig = bench._run_prefix_arm
        bench._run_prefix_arm = lambda enable, *a, **k: arms[enable]
        try:
            rows[pkg] = bench.run_prefix_ab()
        finally:
            bench._run_prefix_arm = orig
    assert rows["port"] == rows["jax"]
    assert rows["port"]["prefilled_tokens_on"] < \
        rows["port"]["prefilled_tokens_off"]
    assert rows["port"]["prefix_hit_tokens"] > 0


def test_chunked_prefill_ab_has_the_jax_rows_keys(jax_rows):
    port = serve_load_bench.run_chunked_ab(long_len=LONG_LEN, device="cpu")
    ref = jax_rows()["chunked"]
    assert sorted(port) == sorted(ref)
    for key in ("long_prompt_tokens", "decode_streams",
                "prefill_chunk_tokens"):
        assert port[key] == ref[key]
    assert port["max_itl_unchunked_ms"] > 0 and port["max_itl_chunked_ms"] > 0


def test_pipeline_bench_rows_match_the_jax_harness(jax_rows):
    port = pipeline_bench.run_pipeline_bench(device="cpu", micros=(1,),
                                             rounds=1)
    ref = jax_rows()["pipeline"]
    assert sorted(port) == sorted(ref)
    assert port["micros"] == ref["micros"] == [1]
    (row,), (ref_row,) = port["variants"], ref["variants"]
    assert sorted(row) == sorted(ref_row)
    assert row["bubble_fraction_theoretical"] == \
        ref_row["bubble_fraction_theoretical"] == 0.5
    (cp,), (ref_cp,) = port["critical_path"], ref["critical_path"]
    assert sorted(cp) == sorted(ref_cp), cp
    assert cp["buckets_sum_to_path"] is True
    assert 0.0 <= cp["bubble_fraction_cpath"] < 1.0


def test_collective_bench_wire_bytes_equal_the_jax_harness(runtime,
                                                           jax_rows):
    from ray_tpu_torch._private.collective_bench import run_collective_bench

    rec = run_collective_bench(sizes=[1 << 20], worlds=[2])
    (row,) = rec["rows"]
    ref = jax_rows()["collective"]
    assert sorted(row) == sorted(ref)
    for key in ("serial_fp32_wire_bytes", "pipelined_fp32_wire_bytes",
                "pipelined_int8_wire_bytes", "int8_wire_reduction"):
        assert row[key] == ref[key], key
    # the ring's requantization bound for uniform [-1, 1] inputs, world 2
    assert 0 < row["int8_max_err"] <= 2 * 3 / (2 * 254.0)
