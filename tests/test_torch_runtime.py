"""The port's runtime (``ray_tpu_torch``'s GCS, nodelet, workers and API) on
the CPU.

One port runtime for the module (``init(num_cpus=4,
object_store_memory=256 MB)``, advertising one GPU so that a ``num_gpus``
request schedules), shut down at the end: tasks, actors, ``put`` / ``get``
/ ``wait``; the torch tensor serializer (f32, bf16, int64, a non-contiguous
view, a nested state dict, a 64 MB tensor) through the object store and
through a worker, bit for bit with dtype and shape; the GPU manager's count
from ``CUDA_VISIBLE_DEVICES`` and from the driver's ``/proc`` entries;
``num_gpus`` as the ``GPU`` resource; no ``jax`` and no ``ray_tpu`` module
in a worker, ``ray_tpu_torch`` modules on the GCS's, the nodelet's and the
workers' command lines, and neither torch nor JAX mapped into the GCS or the
nodelet.  Without a runtime: no module of the port imports JAX or the JAX
package, the settings' prefix and session root are the port's own, and each
plain copy of a JAX-package runtime module is its counterpart under the
rename rule (``ray_tpu`` -> ``ray_tpu_torch``, ``RAY_TPU_`` ->
``RAY_TPU_TORCH_``), with a first docstring line naming it.

This file imports neither JAX nor the JAX package: a worker that runs one of
its functions imports it.
"""

import ast
import os
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch._private.ray_option_utils import (
    TASK_DEFAULTS,
    merge_options,
    resources_from_options,
)
from ray_tpu_torch.accelerators.gpu import GPUAcceleratorManager

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "ray_tpu_torch"

# The runtime modules copied from ray_tpu/ with the rename rule alone (and
# a first docstring line), and those whose copy differs in a few listed
# lines: (old, new) pairs applied after the rule.
PLAIN_COPIES = """exceptions.py actor.py remote_function.py runtime_context.py
_private/ids.py _private/task_spec.py _private/object_ref.py _private/rpc.py
_private/memory_store.py _private/reference_count.py _private/object_store.py
_private/metrics.py _private/profiler.py _private/fault_injection.py
_private/flight_recorder.py _private/incidents.py _private/introspect.py
_private/memory_monitor.py _private/bench_rig.py _private/race_detector.py
_private/sync_suppressions.py _private/metrics_view.py
_private/gcs/__init__.py _private/gcs/pg_manager.py
_private/gcs/storage.py runtime_env/__init__.py
util/__init__.py util/placement_group.py util/scheduling_strategies.py
air/__init__.py air/result.py train/_checkpoint.py train/storage.py
train/_session.py train/_metrics.py tune/_single_trial.py
accelerators/accelerator.py""".split()
# the session root: ``temp_root()``, under TMPDIR, in place of a fixed /tmp
CONFIG_IMPORT = ("from ray_tpu_torch._private.config import RayConfig\n",
                 "from ray_tpu_torch._private.config import RayConfig, "
                 "temp_root\n")
TEMP_ROOT = ('"/tmp/ray_tpu_torch"', "temp_root()")
# a GPU lease's cards: the nodelet takes them from its pool, gives them to
# the lease's worker (which refuses them when CUDA is up in it) and retires
# the worker when the lease ends
NODELET_CARDS = [
    ("leased | actor -> dead", "leased | actor | retiring -> dead"),
    ("""        self.resources_available = dict(self.resources_total)
""", """        self.resources_available = dict(self.resources_total)
        # a GPU lease's worker sees only the lease's cards
        from ray_tpu_torch.accelerators.gpu import CardPool, gpu_ids

        self.cards = CardPool(gpu_ids(int(self.resources_total.get("GPU", 0))))
"""),
    ("""                if w.state == "idle" and now - w.idle_since > reap_after:
""", """                if w.state == "retiring" or (
                        w.state == "idle" and now - w.idle_since > reap_after):
"""),
    ("""            w = await self._pop_worker(token, env_key)
        except _LeaseCancelled:
            self._release(resources, bundle)
            self._pump_queued_leases()  # freed capacity may unblock waiters
            return {"type": "cancelled"}
        except asyncio.CancelledError:
""", """            w, cards = await self._pop_worker_with_cards(resources, token,
                                                         env_key)
        except _LeaseCancelled:
            self._release(resources, bundle)
            self._pump_queued_leases()  # freed capacity may unblock waiters
            return {"type": "cancelled"}
        except BaseException:
"""),
    ("""        self.leases[lease_id] = {"resources": resources, "bundle": bundle, "worker": w}
""", """        self.leases[lease_id] = {"resources": resources, "bundle": bundle,
                                 "worker": w, "cards": cards}
"""),
    ("""    def _release_lease(self, lease_id: int):
        lease = self.leases.pop(lease_id, None)
        if lease is None:
            return
        self._release(lease["resources"], lease["bundle"])
        w = lease["worker"]
        if w.state == "leased":
""", '''    def _retire(self, w: WorkerHandle) -> None:
        """A worker that held cards, or could not take them, is not reused:
        CUDA may be up in it with other cards visible.  The reaper ends
        it."""
        w.state = "retiring"
        w.lease_id = None

    async def _pop_worker_with_cards(self, resources: Dict[str, float],
                                     token: Optional[str] = None,
                                     env_key: str = ""):
        """A worker for a lease, and the lease's card ids, which the
        worker's CUDA alone sees from then on.  A bundle's cancel returns
        its resources before its lease's worker is dead: the cards may
        come free a moment after the resources."""
        gpus = resources.get("GPU", 0.0)
        cards = self.cards.take(gpus)
        deadline = time.monotonic() + 30.0
        while cards is None:
            if time.monotonic() > deadline:
                raise RuntimeError(f"no card came free for a lease of "
                                   f"{gpus:g} GPU: {self.cards.held}")
            await asyncio.sleep(0.05)
            cards = self.cards.take(gpus)
        try:
            while True:
                w = await self._pop_worker(token, env_key)
                if not cards:
                    return w, cards
                try:
                    if await w.conn.call("assign_cards", {"ids": cards},
                                         timeout=30.0):
                        return w, cards
                except ConnectionError:
                    pass
                self._retire(w)
        except BaseException:
            self.cards.give_back(cards, gpus)
            raise

    def _release_lease(self, lease_id: int):
        lease = self.leases.pop(lease_id, None)
        if lease is None:
            return
        self._release(lease["resources"], lease["bundle"])
        self.cards.give_back(lease.get("cards", []),
                             lease["resources"].get("GPU", 0.0))
        w = lease["worker"]
        if w.state == "leased" and lease.get("cards"):
            self._retire(w)
        elif w.state == "leased":
'''),
    ("""        w = await self._pop_worker(env_key=env_key)
""", """        try:
            w, cards = await self._pop_worker_with_cards(spec.resources,
                                                         env_key=env_key)
        except BaseException:
            self._release(spec.resources, bundle)
            self._pump_queued_leases()
            raise
"""),
    ("""        self.leases[w.lease_id] = {"resources": spec.resources, "bundle": bundle, "worker": w}
""", """        self.leases[w.lease_id] = {"resources": spec.resources, "bundle": bundle,
                                   "worker": w, "cards": cards}
"""),
]
EDITED_COPIES = {
    "_private/config.py": [
        ("import os\nimport threading\n",
         "import os\nimport tempfile\nimport threading\n"),
        ('ENV_PREFIX = "RAY_TPU_TORCH_"\n', '''ENV_PREFIX = "RAY_TPU_TORCH_"


def temp_root() -> str:
    """Where the port's sessions live: ``RAY_TPU_TORCH_TMPDIR``, else
    ``ray_tpu_torch`` under the process's temp directory (``TMPDIR``)."""
    return os.environ.get(ENV_PREFIX + "TMPDIR", os.path.join(
        tempfile.gettempdir(), "ray_tpu_torch"))
''')],
    "_private/node.py": [
        CONFIG_IMPORT,
        ('os.environ.get("RAY_TPU_TORCH_TMPDIR", "/tmp/ray_tpu_torch")',
         "temp_root()")],
    "_private/gcs/server.py": [CONFIG_IMPORT, TEMP_ROOT],
    "_private/worker_main.py": [
        ("import sys\n\n\ndef main",
         "import sys\n\nfrom ray_tpu_torch._private.config import "
         "temp_root\n\n\ndef main"),
        TEMP_ROOT],
    "_private/nodelet.py": [CONFIG_IMPORT, TEMP_ROOT] + NODELET_CARDS,
    "_private/core_worker.py": [
        ("import random\nimport threading\n",
         "import random\nimport sys\nimport threading\n"),
        CONFIG_IMPORT, TEMP_ROOT,
        ("    async def rpc_lease_reclaim(self, conn, msg):\n", '''    async def rpc_assign_cards(self, conn, msg):
        """The nodelet gives this worker its lease's cards: CUDA in this
        process sees only them.  CUDA reads the variable once, when it
        starts, so a worker in which it is already up with other cards
        visible refuses (False) and the nodelet retires it."""
        ids = ",".join(msg["ids"])
        torch = sys.modules.get("torch")
        if torch is not None and torch.cuda.is_initialized() and \\
                os.environ.get("CUDA_VISIBLE_DEVICES") != ids:
            return False
        os.environ["CUDA_VISIBLE_DEVICES"] = ids
        return True

    async def rpc_lease_reclaim(self, conn, msg):
''')],
    "train/_backend_executor.py": [
        ("hooks (JaxConfig → jax.distributed bring-up)",
         "hooks (TorchConfig → torch.distributed bring-up)"),
        ("ray_tpu_torch.train.jax_config import",
         "ray_tpu_torch.train.torch_config import")],
    "train/base_trainer.py": [
        ("ray_tpu_torch.train.jax_config import",
         "ray_tpu_torch.train.torch_config import")],
    "_private/worker.py": [
        ("num_tpus: Optional[float]", "num_gpus: Optional[float]"),
        ("if num_tpus is not None:\n                res[\"TPU\"] = "
         "float(num_tpus)",
         "if num_gpus is not None:\n                res[\"GPU\"] = "
         "float(num_gpus)")],
}


def port_text(rel: str, original: str) -> str:
    """``ray_tpu/<rel>`` as the port copies it: every name ``ray_tpu`` and
    every ``RAY_TPU_`` variable renamed, a docstring line naming the
    counterpart first."""
    text = re.sub(r"\bray_tpu\b", "ray_tpu_torch", original)
    text = re.sub(r"\bRAY_TPU_", "RAY_TPU_TORCH_", text)
    line = f"Port of ``ray_tpu/{rel}``."
    if text.startswith('"""'):
        return '"""' + line + "\n\n" + text[3:]
    return '"""' + line + '"""\n' + ("\n" + text if text else "")


# ------------------------------------------------------------ no runtime
@pytest.mark.parametrize("rel", PLAIN_COPIES + sorted(EDITED_COPIES))
def test_copy_matches_its_counterpart(rel):
    want = port_text(rel, (REPO / "ray_tpu" / rel).read_text())
    for old, new in EDITED_COPIES.get(rel, []):
        assert old in want, (rel, old)
        want = want.replace(old, new)
    assert (PORT / rel).read_text() == want


def test_no_port_module_imports_jax_or_the_jax_package():
    banned = ("jax", "jaxlib", "flax", "optax", "ray_tpu")
    found = []
    for path in sorted(PORT.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module or ""]
            else:
                continue
            found += [f"{path.relative_to(REPO)}:{node.lineno} {n}"
                      for n in names if n.split(".")[0] in banned]
    assert found == []


def test_settings_and_sessions_are_the_ports_own(monkeypatch, tmp_path):
    import tempfile

    from ray_tpu_torch._private import config, node

    assert config.ENV_PREFIX == "RAY_TPU_TORCH_"
    monkeypatch.setenv("RAY_TPU_TMPDIR", str(tmp_path / "jax"))
    monkeypatch.setenv("RAY_TPU_TORCH_TMPDIR", str(tmp_path / "port"))
    assert node._session_dir().startswith(str(tmp_path / "port"))
    # without it, the port's own directory under the process's TMPDIR
    monkeypatch.delenv("RAY_TPU_TORCH_TMPDIR")
    monkeypatch.setenv("TMPDIR", str(tmp_path / "tmp"))
    (tmp_path / "tmp").mkdir()
    monkeypatch.setattr(tempfile, "tempdir", None)  # read TMPDIR again
    assert config.temp_root() == str(tmp_path / "tmp" / "ray_tpu_torch")
    assert node._session_dir().startswith(
        str(tmp_path / "tmp" / "ray_tpu_torch" / "session_"))
    # a JAX-package variable is not read as the port's flag
    flags = config._Config()
    flags.define("object_store_memory_bytes", int, 7)
    monkeypatch.setenv("RAY_TPU_OBJECT_STORE_MEMORY_BYTES", "1")
    assert flags.object_store_memory_bytes == 7
    flags.reset()
    monkeypatch.setenv("RAY_TPU_TORCH_OBJECT_STORE_MEMORY_BYTES", "3")
    assert flags.object_store_memory_bytes == 3


@pytest.mark.parametrize("value,count", [
    ("0,1,2,3", 4), ("2", 1), ("", 0), ("1,-1,2", 1), ("GPU-5a1b,GPU-77c0", 2),
])
def test_gpu_count_from_cuda_visible_devices(monkeypatch, tmp_path, value,
                                             count):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", value)
    # the variable wins over the driver's entries
    (tmp_path / "0000:18:00.0").mkdir()
    assert GPUAcceleratorManager(str(tmp_path)) \
        .get_current_node_num_accelerators() == count


@pytest.mark.parametrize("value,ids", [
    ("5,7", ["5", "7"]), ("0,1,2,3", ["0", "1"]), (None, ["0", "1"]),
    ("3", ["0", "1"]), ("GPU-5a1b,GPU-77c0", ["GPU-5a1b", "GPU-77c0"]),
])
def test_node_card_ids(monkeypatch, value, ids):
    """The ids the nodelet gives 2 advertised cards: the visible ones, else
    the indices."""
    from ray_tpu_torch.accelerators.gpu import gpu_ids

    if value is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", value)
    assert gpu_ids(2) == ids


def test_card_pool_gives_each_lease_its_cards():
    from ray_tpu_torch.accelerators.gpu import CardPool

    pool = CardPool(["5", "7", "9"])
    assert pool.take(0) == [] and pool.take(1) == ["5"]
    assert pool.take(2) == ["7", "9"]
    assert pool.take(1) is None  # none free
    pool.give_back(["7", "9"], 2)
    # fractions pack onto the fullest card with room
    assert [pool.take(0.5), pool.take(0.25), pool.take(0.5)] == \
        [["7"], ["7"], ["9"]]
    assert pool.take(0.25) == ["7"]
    assert pool.take(1) is None
    pool.give_back(["5"], 1)
    assert pool.held == {"5": 0.0, "7": 1.0, "9": 0.5}


def test_gpu_count_from_proc(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    for bus in ("0000:18:00.0", "0000:2a:00.0", "0000:3a:00.0"):
        (tmp_path / bus).mkdir()
        (tmp_path / bus / "information").write_text("Model: H100\n")
    manager = GPUAcceleratorManager(str(tmp_path))
    assert manager.get_resource_name() == "GPU"
    assert manager.get_current_node_num_accelerators() == 3
    assert manager.get_visible_accelerator_ids_env_var() == \
        "CUDA_VISIBLE_DEVICES"


def test_num_gpus_is_the_gpu_resource():
    opts = merge_options(TASK_DEFAULTS, {"num_gpus": 2})
    assert resources_from_options(opts) == {"CPU": 1.0, "GPU": 2.0}
    assert resources_from_options(
        merge_options(TASK_DEFAULTS, {"num_gpus": 0.5, "num_cpus": 0})) == \
        {"GPU": 0.5}
    with pytest.raises(ValueError, match="GPU request of 1.5"):
        resources_from_options(merge_options(TASK_DEFAULTS,
                                             {"num_gpus": 1.5}))
    with pytest.raises(ValueError, match="num_gpus"):
        resources_from_options(merge_options(TASK_DEFAULTS,
                                             {"resources": {"GPU": 1}}))
    with pytest.raises(ValueError, match="unknown option 'num_tpus'"):
        merge_options(TASK_DEFAULTS, {"num_tpus": 1})


# --------------------------------------------------------------- runtime
@pytest.fixture(scope="module")
def runtime():
    # two cards, "5" and "7", advertised whatever the machine has: the
    # nodelet gives GPU leases those ids
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = "5,7"
    try:
        ray_tpu_torch.init(num_cpus=4, num_gpus=2,
                           object_store_memory=256 * 1024 ** 2)
    finally:
        if visible is None:
            del os.environ["CUDA_VISIBLE_DEVICES"]
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = visible
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote
def _add(a, b):
    return a + b


@ray_tpu_torch.remote
def _echo(value):
    return value


@ray_tpu_torch.remote
def _process():
    with open("/proc/self/cmdline", "rb") as f:
        cmdline = f.read().split(b"\0")
    return sorted(sys.modules), [a.decode() for a in cmdline if a]


@ray_tpu_torch.remote
class _Counter:
    def __init__(self, start):
        self.n = start

    def add(self, k):
        self.n += k
        return self.n

    def pid(self):
        return os.getpid()

    def cards(self):
        return os.environ.get("CUDA_VISIBLE_DEVICES")


@ray_tpu_torch.remote
def _cards():
    return os.getpid(), os.environ.get("CUDA_VISIBLE_DEVICES")


def test_tasks_actors_put_get_wait(runtime):
    assert ray_tpu_torch.get(_add.remote(2, 3)) == 5
    refs = [_add.remote(i, i) for i in range(6)]
    assert ray_tpu_torch.get(refs) == [0, 2, 4, 6, 8, 10]
    ready, pending = ray_tpu_torch.wait(refs, num_returns=6, timeout=60)
    assert len(ready) == 6 and pending == []
    ref = ray_tpu_torch.put({"a": np.arange(5)})
    assert ray_tpu_torch.get(_echo.remote(ref))["a"].tolist() == \
        [0, 1, 2, 3, 4]
    counter = _Counter.remote(10)
    assert ray_tpu_torch.get([counter.add.remote(1),
                              counter.add.remote(2)]) == [11, 13]
    assert ray_tpu_torch.get(counter.pid.remote()) != os.getpid()
    ray_tpu_torch.kill(counter)


def test_num_gpus_schedules_on_the_gpu_resource(runtime):
    assert ray_tpu_torch.cluster_resources()["GPU"] == 2.0
    assert ray_tpu_torch.get(
        _add.options(num_gpus=1).remote(1, 1), timeout=60) == 2


def test_each_gpu_lease_sees_its_own_cards(runtime):
    """Two 1-GPU actors see different cards; a 2-GPU task sees both, in a
    worker that no GPU lease used before (one that held cards is not
    reused: CUDA may be up in it with those cards)."""
    actors = [_Counter.options(num_gpus=1).remote(0) for _ in range(2)]
    seen = ray_tpu_torch.get([a.cards.remote() for a in actors], timeout=60)
    assert sorted(seen) == ["5", "7"]
    for a in actors:
        ray_tpu_torch.kill(a)
    first = ray_tpu_torch.get(_cards.options(num_gpus=2).remote(), timeout=60)
    assert first[1] == "5,7"
    pid, cards = ray_tpu_torch.get(_cards.options(num_gpus=0.5).remote(),
                                   timeout=60)
    assert cards in ("5", "7") and pid != first[0]


def _tensor_cases():
    gen = torch.Generator().manual_seed(0)
    whole = torch.randn(6, 10, generator=gen)
    return {
        "f32": torch.randn(3, 1500, generator=gen),
        "bf16": torch.randn(4, 2048, generator=gen).to(torch.bfloat16),
        "int64": torch.randint(-2 ** 40, 2 ** 40, (700, 3), generator=gen),
        "view": whole[:, 2:9:3].t(),
        "state_dict": {"h": [{"w": torch.randn(64, 64, generator=gen),
                              "b": torch.zeros(64, dtype=torch.float16)}],
                       "step": torch.tensor(7), "name": "layer"},
        "64MB": torch.randn(4096, 4096, generator=gen),
    }


def _assert_same(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for key in want:
            _assert_same(got[key], want[key])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif torch.is_tensor(want):
        assert type(got) is torch.Tensor and got.device.type == "cpu"
        assert got.dtype == want.dtype and got.shape == want.shape
        # bit for bit: the integer views of the same bytes
        assert torch.equal(got.reshape(-1).view(torch.uint8),
                           want.reshape(-1).view(torch.uint8))
    else:
        assert got == want


@pytest.mark.parametrize("case", list(_tensor_cases()))
def test_tensor_serializer_round_trip(runtime, case):
    value = _tensor_cases()[case]
    ref = ray_tpu_torch.put(value)
    _assert_same(ray_tpu_torch.get(ref), value)
    # through a worker: it deserializes, then serializes again
    _assert_same(ray_tpu_torch.get(_echo.remote(ref), timeout=120), value)
    got = ray_tpu_torch.get(ref)
    leaf = got["h"][0]["w"] if case == "state_dict" else got
    leaf += 1  # torch owns what a get returns: the stored object is intact
    _assert_same(ray_tpu_torch.get(ref), value)


def test_worker_holds_no_jax_and_runs_the_ports_modules(runtime):
    modules, cmdline = ray_tpu_torch.get(_process.remote(), timeout=60)
    assert [m for m in modules if m.split(".")[0] in ("jax", "jaxlib",
                                                      "ray_tpu")] == []
    assert "ray_tpu_torch._private.core_worker" in modules
    assert cmdline[cmdline.index("-m") + 1] == \
        "ray_tpu_torch._private.worker_main"


def test_gcs_and_nodelet_run_the_ports_modules(runtime):
    from ray_tpu_torch._private import config
    from ray_tpu_torch._private import worker as worker_mod

    node = worker_mod.global_worker().node
    for proc, module in ((node.gcs_proc, "ray_tpu_torch._private.gcs.server"),
                         (node.nodelet_proc, "ray_tpu_torch._private.nodelet")):
        with open(f"/proc/{proc.pid}/cmdline", "rb") as f:
            args = [a.decode() for a in f.read().split(b"\0") if a]
        assert args[args.index("-m") + 1] == module
        assert node.session_dir.startswith(config.temp_root())
        # neither torch nor JAX is loaded there: no library of theirs is
        # mapped into the process
        with open(f"/proc/{proc.pid}/maps") as f:
            libs = {line.split()[-1] for line in f if ".so" in line}
        assert [lib for lib in libs if re.search(
            r"libtorch|libc10|xla_extension|jaxlib", lib)] == []
