"""The port's CLI (``python -m ray_tpu_torch``, ``scripts/cli.py``) and job
submission (``job_submission/``).

The cases of ``tests/test_cli_jobs.py`` on the port, and every
subcommand's ``--help`` text against the JAX CLI's under the rename
``ray_tpu`` -> ``ray_tpu_torch``, ``RAY_TPU_`` -> ``RAY_TPU_TORCH_``.

The workers import this module: it imports neither JAX nor the JAX package
at the top.
"""

import json
import os
import re
import subprocess
import sys
import time

import pytest

import ray_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def detached_cluster(tmp_path):
    """A cluster started via the CLI in a throwaway tmpdir."""
    env = dict(os.environ)
    env["RAY_TPU_TORCH_TMPDIR"] = str(tmp_path)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    ray_tpu_torch.shutdown()
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch", "start", "--head",
         "--num-cpus", "4"],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr + out.stdout
    rec = json.load(open(tmp_path / "current_cluster"))
    try:
        yield rec["address"], env
    finally:
        subprocess.run([sys.executable, "-m", "ray_tpu_torch", "stop"],
                       capture_output=True, text=True, env=env, timeout=60)
        ray_tpu_torch.shutdown()


def test_cli_start_status_stop(detached_cluster):
    address, env = detached_cluster
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch", "status"],
        capture_output=True, text=True, env=env, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "CPU: 4/4" in out.stdout

    # a driver can connect to the CLI-started cluster
    ray_tpu_torch.init(address=address)
    @ray_tpu_torch.remote
    def f():
        return "via-cli"

    assert ray_tpu_torch.get(f.remote(), timeout=60) == "via-cli"
    ray_tpu_torch.shutdown()


def test_job_submission_lifecycle(detached_cluster, tmp_path):
    address, env = detached_cluster
    from ray_tpu_torch.job_submission import JobStatus, JobSubmissionClient

    script = tmp_path / "job_script.py"
    script.write_text(
        "import ray_tpu_torch\n"
        "ray_tpu_torch.init()\n"  # picks up RAY_TPU_TORCH_ADDRESS
        "@ray_tpu_torch.remote\n"
        "def sq(x):\n"
        "    return x * x\n"
        "print('RESULT', sum(ray_tpu_torch.get("
        "[sq.remote(i) for i in range(5)])))\n"
        "ray_tpu_torch.shutdown()\n")

    client = JobSubmissionClient(address)
    try:
        sid = client.submit_job(
            entrypoint=f"{sys.executable} {script}",
            runtime_env={"env_vars": {"PYTHONPATH": REPO}},
            metadata={"owner": "test"})
        status = client.wait_until_finished(sid, timeout=120)
        logs = client.get_job_logs(sid)
        assert status == JobStatus.SUCCEEDED, logs
        assert "RESULT 30" in logs
        infos = {j.submission_id: j for j in client.list_jobs()}
        assert infos[sid].status == JobStatus.SUCCEEDED
        assert infos[sid].metadata == {"owner": "test"}

        # failing job reports FAILED with a nonzero return code
        bad = client.submit_job(entrypoint=f"{sys.executable} -c 'exit(3)'")
        assert client.wait_until_finished(bad, timeout=60) == JobStatus.FAILED
        assert client.get_job_info(bad).return_code == 3

        # long-running job can be stopped
        slow = client.submit_job(
            entrypoint=f"{sys.executable} -c 'import time; time.sleep(600)'")
        time.sleep(1)
        assert client.stop_job(slow)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if client.get_job_status(slow) in JobStatus.TERMINAL:
                break
            time.sleep(0.5)
        assert client.get_job_status(slow) in (JobStatus.STOPPED,
                                               JobStatus.FAILED)
    finally:
        client.close()


def _help(main, argv, capsys) -> str:
    with pytest.raises(SystemExit) as exit_:
        main(argv)
    assert exit_.value.code == 0, argv
    return capsys.readouterr().out


def _renamed(text: str) -> str:
    text = re.sub(r"\bray_tpu\b", "ray_tpu_torch", text)
    return re.sub(r"\bRAY_TPU_", "RAY_TPU_TORCH_", text)


def test_every_subcommands_help_is_the_jax_clis(capsys):
    """``main([cmd, ..., "--help"])`` of both CLIs, for every subcommand
    and every subcommand of those: the same text after the rename (line
    breaks aside, since the names' lengths move argparse's wrapping)."""
    from ray_tpu.scripts import cli as jax_cli
    from ray_tpu_torch.scripts import cli as port_cli

    seen, todo = [], [[]]
    while todo:
        argv = todo.pop(0)
        want = _renamed(_help(jax_cli.main, argv + ["--help"], capsys))
        got = _help(port_cli.main, argv + ["--help"], capsys)
        assert got.split() == want.split(), argv
        seen.append(" ".join(argv))
        # the subcommands this level offers: the usage line's {a,b,...}
        usage = want.split("\n\n")[0]
        choices = re.search(r"\{([\w,-]+)\}", usage)
        if choices and len(argv) < 2:
            todo += [argv + [c] for c in choices.group(1).split(",")]
    assert {"start", "stop", "status", "job", "job submit", "lint", "up",
            "down"} <= set(seen), seen
