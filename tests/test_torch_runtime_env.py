"""The port's isolated runtime environments: ``runtime_env/pip.py`` (a venv
per pip spec) and ``runtime_env/container.py`` (``image_uri`` workers).

The cases of ``tests/test_runtime_env_iso.py`` on the port's runtime, and
the fault they repair: ``RuntimeEnv(pip=...)``, a pip env's launch and an
``image_uri`` worker's launch imported modules the port did not have
(``ModuleNotFoundError``).  Offline by construction: the wheels are built in
tmp_path and installed with ``--no-index --find-links``.

The workers import this module: it imports neither JAX nor the JAX
package.
"""

import base64
import csv
import hashlib
import io
import os
import sys
import zipfile

import pytest

import ray_tpu_torch
from ray_tpu_torch.runtime_env import (RuntimeEnv, env_key,
                                       prepare_worker_launch)


def _make_wheel(dirpath, name, version):
    os.makedirs(dirpath, exist_ok=True)
    whl = os.path.join(dirpath, f"{name}-{version}-py3-none-any.whl")
    files = {
        f"{name}/__init__.py": f'__version__ = "{version}"\n',
        f"{name}-{version}.dist-info/METADATA":
            f"Metadata-Version: 2.1\nName: {name}\nVersion: {version}\n",
        f"{name}-{version}.dist-info/WHEEL":
            "Wheel-Version: 1.0\nGenerator: rtpu-test\n"
            "Root-Is-Purelib: true\nTag: py3-none-any\n",
    }
    rows = []
    with zipfile.ZipFile(whl, "w") as z:
        for path, content in files.items():
            data = content.encode()
            z.writestr(path, data)
            digest = base64.urlsafe_b64encode(
                hashlib.sha256(data).digest()).rstrip(b"=").decode()
            rows.append((path, f"sha256={digest}", str(len(data))))
        rec = f"{name}-{version}.dist-info/RECORD"
        buf = io.StringIO()
        w = csv.writer(buf)
        for r in rows:
            w.writerow(r)
        w.writerow((rec, "", ""))
        z.writestr(rec, buf.getvalue())
    return whl


def test_validation_and_env_key():
    with pytest.raises(ValueError):
        RuntimeEnv(conda={"dependencies": ["pip"]})
    with pytest.raises(ValueError):
        RuntimeEnv(pip=["a==1"], image_uri="img:1")  # mutually exclusive
    with pytest.raises(ValueError):
        RuntimeEnv(container_run_args=["--privileged"])  # needs image_uri
    # normalization: order-insensitive, deduped
    a = RuntimeEnv(pip=["b==2", "a==1", "a==1"])
    b = RuntimeEnv(pip=["a==1", "b==2"])
    assert a["pip"] == b["pip"] == ["a==1", "b==2"]
    assert env_key(a) == env_key(b) != ""
    # in-process-only envs share the default pool
    assert env_key({"env_vars": {"X": "1"}}) == ""
    assert env_key(None) == ""
    # image envs partition too
    assert env_key({"image_uri": "img:1"}) != env_key({"image_uri": "img:2"})


@pytest.fixture
def env_flags():
    """The runtime-env flags read afresh in this process, and forgotten
    after: a node started later hands this process's values to its
    nodelet."""
    from ray_tpu_torch._private.config import RayConfig

    names = ("runtime_env_pip_no_index", "runtime_env_pip_find_links",
             "runtime_env_container_runtime")
    for name in names:
        RayConfig.reset(name)
    yield
    for name in names:
        RayConfig.reset(name)


def test_isolation_envs_launch_on_the_port(tmp_path, monkeypatch,
                                           env_flags):
    """The repaired fault: each of these raised ModuleNotFoundError (no
    ``runtime_env.pip``, no ``runtime_env.container``).  A pip env's
    launch builds a venv over the system site-packages (so torch stays
    visible in it) from the offline wheel directory; the cases below build
    real ones.  An image worker's command goes through the container
    runtime, which adds no device flag of its own: the card reaches the
    container through the user's run arguments and the lease's
    CUDA_VISIBLE_DEVICES."""
    from ray_tpu_torch.runtime_env import container, pip

    wheels = str(tmp_path / "wheels")
    monkeypatch.setenv("RAY_TPU_TORCH_RUNTIME_ENV_PIP_NO_INDEX", "1")
    monkeypatch.setenv("RAY_TPU_TORCH_RUNTIME_ENV_PIP_FIND_LINKS", wheels)
    ran = []

    def run(cmd, timeout_s):
        ran.append(cmd)
        if cmd[1:3] == ["-m", "venv"]:
            os.makedirs(cmd[-1])

    monkeypatch.setattr(pip, "_run", run)
    env = RuntimeEnv(pip=["toydep==1.0"])
    launch = prepare_worker_launch(dict(env), str(tmp_path / "session"))
    env_dir = os.path.dirname(os.path.dirname(launch["python"]))
    assert launch["image"] is None and os.path.isfile(
        os.path.join(env_dir, "READY"))
    assert ran[0] == [sys.executable, "-m", "venv", "--system-site-packages",
                      env_dir]
    assert ran[1][:2] == [launch["python"], "-m"] and ran[1][-3:] == [
        "--no-index", f"--find-links={wheels}", "toydep==1.0"]

    img = RuntimeEnv(image_uri="registry/worker:1",
                     container_run_args=["--gpus", "device=0"])
    launch = prepare_worker_launch(dict(img), str(tmp_path / "session"))
    assert launch["image"] == "registry/worker:1"
    cmd = [sys.executable, "-m", "ray_tpu_torch._private.worker_main"]
    run, extra = container.DockerRuntime("docker").wrap(
        launch["image"], cmd, {"CUDA_VISIBLE_DEVICES": "0"},
        [str(tmp_path)], launch["image_args"])
    assert run[:5] == ["docker", "run", "--rm", "--network=host",
                       "--ipc=host"] and extra == {}
    assert "CUDA_VISIBLE_DEVICES=0" in run
    assert run[run.index("registry/worker:1") - 2:][:2] == [
        "--gpus", "device=0"]
    assert not any(a.startswith(("--device", "--privileged")) for a in run)
    monkeypatch.setenv("RAY_TPU_TORCH_RUNTIME_ENV_CONTAINER_RUNTIME", "fake")
    run, extra = container.wrap_worker_command(
        launch["image"], cmd, {}, str(tmp_path), launch["image_args"])
    assert run == cmd and extra == {
        "RAY_TPU_TORCH_CONTAINER_IMAGE": "registry/worker:1",
        "RAY_TPU_TORCH_CONTAINER_ARGS": "--gpus device=0"}


@pytest.fixture(scope="module")
def iso_cluster(tmp_path_factory):
    """A cluster whose nodelet sees the offline-pip + fake-container config
    (env vars propagate to the node subprocesses), shared by the cases
    below: each names its own pip spec or image, and a spec's venv, once
    built, is the session's cache for every later case."""
    wheel_dir = str(tmp_path_factory.mktemp("iso") / "wheels")
    _make_wheel(wheel_dir, "toydep", "1.0")
    _make_wheel(wheel_dir, "toydep", "2.0")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_TORCH_RUNTIME_ENV_PIP_NO_INDEX", "1")
        mp.setenv("RAY_TPU_TORCH_RUNTIME_ENV_PIP_FIND_LINKS", wheel_dir)
        mp.setenv("RAY_TPU_TORCH_RUNTIME_ENV_CONTAINER_RUNTIME", "fake")
        ray_tpu_torch.shutdown()
        ray_tpu_torch.init(num_cpus=2, num_gpus=0)
        yield wheel_dir
        ray_tpu_torch.shutdown()


def test_two_pinned_versions_one_cluster(iso_cluster):
    """Tasks in the same cluster run under different pinned package
    versions, and the driver process is untouched."""

    @ray_tpu_torch.remote
    def dep_version():
        import toydep

        return toydep.__version__, sys.executable

    v1 = dep_version.options(
        runtime_env={"pip": ["toydep==1.0"]}).remote()
    v2 = dep_version.options(
        runtime_env={"pip": ["toydep==2.0"]}).remote()
    (ver1, py1), (ver2, py2) = ray_tpu_torch.get([v1, v2], timeout=600)
    assert ver1 == "1.0" and ver2 == "2.0"
    assert py1 != py2, "both versions ran in the same interpreter"
    assert "runtime_envs/pip/" in py1 and "runtime_envs/pip/" in py2
    with pytest.raises(ImportError):
        import toydep  # noqa: F401  — driver env stays clean


def test_pip_env_cached_and_reused(iso_cluster):
    """Same spec twice -> same venv (hash-keyed cache), no rebuild."""

    @ray_tpu_torch.remote
    def exe():
        return sys.executable

    spec = {"pip": ["toydep==1.0"]}
    first = ray_tpu_torch.get(exe.options(runtime_env=spec).remote(),
                              timeout=600)
    second = ray_tpu_torch.get(exe.options(runtime_env=spec).remote(),
                               timeout=120)
    assert first == second


def test_pip_composes_with_working_dir_and_env_vars(iso_cluster, tmp_path):
    wd = tmp_path / "proj"
    wd.mkdir()
    (wd / "data.txt").write_text("payload-42")

    @ray_tpu_torch.remote
    def composed():
        import toydep

        with open("data.txt") as f:  # working_dir is the cwd
            data = f.read()
        return toydep.__version__, data, os.environ.get("MY_FLAG")

    out = ray_tpu_torch.get(composed.options(runtime_env={
        "pip": ["toydep==2.0"],
        "working_dir": str(wd),
        "env_vars": {"MY_FLAG": "on"},
    }).remote(), timeout=600)
    assert out == ("2.0", "payload-42", "on")


def test_pip_setup_failure_surfaces(iso_cluster):
    from ray_tpu_torch.exceptions import RuntimeEnvSetupError

    @ray_tpu_torch.remote
    def nope():
        return 1

    ref = nope.options(
        runtime_env={"pip": ["definitely-not-a-real-pkg==9.9"]}).remote()
    with pytest.raises(RuntimeEnvSetupError):
        ray_tpu_torch.get(ref, timeout=600)


def test_container_image_fake_runtime(iso_cluster):
    """image_uri workers are launched through the container runtime seam;
    the fake runtime proves the wrap (image + run args) reached the worker
    launch."""

    @ray_tpu_torch.remote
    def inside():
        return (os.environ.get("RAY_TPU_TORCH_CONTAINER_IMAGE"),
                os.environ.get("RAY_TPU_TORCH_CONTAINER_ARGS"))

    img, args = ray_tpu_torch.get(inside.options(runtime_env={
        "image_uri": "fake.registry/gpu-worker:1",
        "container_run_args": ["--privileged"],
    }).remote(), timeout=300)
    assert img == "fake.registry/gpu-worker:1"
    assert args == "--privileged"


def test_actor_env_setup_failure_is_terminal(iso_cluster):
    """A deterministically broken env must mark the actor DEAD (with the
    setup error), not retry the pip install forever."""
    from ray_tpu_torch.exceptions import RayActorError

    @ray_tpu_torch.remote
    class Broken:
        def ping(self):
            return 1

    a = Broken.options(
        runtime_env={"pip": ["definitely-not-a-real-pkg==9.9"]}).remote()
    with pytest.raises(RayActorError, match="runtime env setup failed"):
        ray_tpu_torch.get(a.ping.remote(), timeout=600)


def test_actor_in_pip_env(iso_cluster):
    @ray_tpu_torch.remote
    class Pinned:
        def version(self):
            import toydep

            return toydep.__version__

    a = Pinned.options(runtime_env={"pip": ["toydep==1.0"]}).remote()
    assert ray_tpu_torch.get(a.version.remote(), timeout=600) == "1.0"
    ray_tpu_torch.kill(a)
