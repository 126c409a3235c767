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
``RAY_TPU_TORCH_``), with a first docstring line naming it.  In a process
of its own: a driver whose GCS is killed under a queued actor call keeps
its IO loop answering, and its ``shutdown()`` ends the loop (C13).

This file imports neither JAX nor the JAX package: a worker that runs one of
its functions imports it.
"""

import ast
import os
import pathlib
import pickle
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
train/_metrics.py tune/_single_trial.py
accelerators/accelerator.py
serve/__init__.py serve/config.py serve/_metrics.py serve/batching.py
serve/multiplex.py serve/_streaming.py serve/handle.py serve/_replica.py
serve/_proxy.py llm/admission.py
util/collective/shm_channel.py util/collective/quantization.py
util/collective/topology.py experimental/__init__.py experimental/channel.py
dag/__init__.py dag/compiled.py train/pipeline/channels.py
rllib/_metrics.py rllib/algorithms/__init__.py rllib/core/__init__.py
rllib/env/__init__.py rllib/env/cartpole.py rllib/env/pendulum.py
rllib/podracer/__init__.py rllib/podracer/weights.py
rllib/podracer/stream.py
data/_executor.py data/_logical.py data/_metrics.py data/aggregate.py
data/datasource.py data/read_api.py
tune/search.py tune/schedulers.py tune/session.py tune/_trial_coordinator.py
tune/tuner.py""".split()
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
# a replica whose constructor still runs answers no ping: the health check
# waits on its first ping without a deadline instead of killing it
SERVE_STARTING = [
    ("""        self.last_health_check = 0.0
""", """        self.last_health_check = 0.0
        # replica actor id -> its first ping, which resolves once its
        # constructor has run: until then no health-check deadline applies
        self.starting: Dict[str, Any] = {}
"""),
    ("""        return ServeReplica.options(**opts).remote(
            d.spec["serialized_cls"], d.spec["init_args"],
            d.spec["init_kwargs"], d.config.max_ongoing_requests,
            app_name=app, deployment_name=d.name)
""", """        replica = ServeReplica.options(**opts).remote(
            d.spec["serialized_cls"], d.spec["init_args"],
            d.spec["init_kwargs"], d.config.max_ongoing_requests,
            app_name=app, deployment_name=d.name)
        d.starting[replica._actor_id.hex()] = replica.ping.remote()
        return replica
"""),
    ("""        for r in replicas:
            try:
                ray_tpu_torch.get(r.ping.remote(),
""", """        for r in replicas:
            ping = d.starting.get(r._actor_id.hex())
            if ping is None:
                ping = r.ping.remote()
            elif not ray_tpu_torch.wait([ping], timeout=0)[0]:
                continue  # its constructor still runs
            else:
                del d.starting[r._actor_id.hex()]
            try:
                ray_tpu_torch.get(ping,
"""),
]
# the engine actor owns a card unless its engine runs on the CPU; without a
# GPU in the cluster the deployment raises at once
LLM_ENGINE_CARD = [
    ("""        self._engine = InferenceEngine.options(num_cpus=0).remote(**kwargs)
""", """        self._engine = InferenceEngine.options(
            **_engine_options(kwargs)).remote(**kwargs)
"""),
    ("def llm_deployment(engine_kwargs", '''def _engine_options(engine_kwargs: dict) -> dict:
    """The engine actor owns a card, unless its engine runs on the CPU
    (``engine_kwargs["device"] == "cpu"``).  A cluster without a ``GPU``
    raises at once: nothing falls back to the CPU."""
    if str(engine_kwargs.get("device") or "cuda") == "cpu":
        return {"num_cpus": 0}
    if ray_tpu_torch.cluster_resources().get("GPU", 0) < 1:
        raise RuntimeError(
            "the LLM engine runs on a CUDA card, and the cluster has no "
            "GPU; pass engine_kwargs={'device': 'cpu'} to serve on the CPU")
    return {"num_cpus": 0, "num_gpus": 1}


def llm_deployment(engine_kwargs'''),
    ("""    dep = serve.deployment(
        LLMServer,""", """    if ray_tpu_torch.is_initialized():
        _engine_options(dict(engine_kwargs or {}))  # no card: raise now
    dep = serve.deployment(
        LLMServer,"""),
]
# C13: an actor call queued while the GCS connection is down retries after
# a pause instead of at once, and fails once the runtime has shut down
DRAIN_PACED = [
    ("""            except (rpc.ConnectionLost, ConnectionError):
                # connection dropped in the attach window: requeue in order
                # and retry (ensure_connected paces the loop via the GCS
                # wait_alive round-trip)
                with self._queue_lock:
                    self._queue.extendleft(reversed(items))
                continue
""", """            except (rpc.ConnectionLost, ConnectionError) as e:
                if self.cw._shut:
                    # the GCS connection is closed for good: fail the calls
                    for spec, holds in items:
                        self.cw.fail_task(spec, RayActorError(
                            self.actor_id, f"the runtime shut down before "
                            f"the call reached its actor: {e}"), holds)
                    continue
                # connection dropped in the attach window, or the GCS
                # connection is down: requeue in order and retry after a
                # pause.  A closed connection raises without awaiting, so
                # the pause is what lets the IO loop run anything else
                # (the GCS reconnect, shutdown) meanwhile.
                with self._queue_lock:
                    self._queue.extendleft(reversed(items))
                await asyncio.sleep(_DRAIN_RETRY_S)
                continue
"""),
    ("def _actor_death_msg(actor_id: ActorID, cause: str) -> str:",
     """# the pause between an actor submitter's retries while its connection, or
# the GCS's, is down
_DRAIN_RETRY_S = 0.05


def _actor_death_msg(actor_id: ActorID, cause: str) -> str:"""),
]
# C18: a worker loads a task's function under the process's unpickle lock,
# so two tasks running at once never import one package's submodules
# concurrently (serialization.UNPICKLE_LOCK)
UNPICKLE_ONE_AT_A_TIME = [
    ("""    SerializedObject,
    freeze_buffers,
    get_serialization_context,
)
""", """    UNPICKLE_LOCK,
    SerializedObject,
    freeze_buffers,
    get_serialization_context,
)
"""),
    ("""            if fn is None:
                fn = cloudpickle.loads(spec.function_blob)
""", """            if fn is None:
                with UNPICKLE_LOCK:
                    fn = cloudpickle.loads(spec.function_blob)
"""),
    ("""            fn = cloudpickle.loads(blob)
            self._fn_cache[key] = fn
""", """            with UNPICKLE_LOCK:
                fn = cloudpickle.loads(blob)
            self._fn_cache[key] = fn
""")]
# the host ring takes torch tensors: a CUDA one goes to the host at the
# op's entry and comes back on its device at the exit
COLLECTIVE_TENSORS = [
    ("import socket\nimport threading\n",
     "import socket\nimport sys\nimport threading\n"),
    ("""# ================================================================ public API
def init_collective_group(""", '''# ================================================================ public API
def _to_host(tensor):
    """A torch tensor crosses the host ring as a numpy array: a CUDA tensor
    is copied to the host at the op's entry (bf16, which numpy lacks, as
    f32), and ``back`` returns a result to the tensor's device and dtype at
    the exit.  Anything else passes as it is."""
    torch = sys.modules.get("torch")
    if torch is None or not isinstance(tensor, torch.Tensor):
        return tensor, lambda out: out
    device, dtype = tensor.device, tensor.dtype
    host = tensor.detach().cpu()
    if dtype == torch.bfloat16:
        host = host.float()

    def back(out):
        return torch.from_numpy(np.array(out)).to(device=device, dtype=dtype)

    return host.numpy(), back


def init_collective_group('''),
    ("""    contributions into the next quorum op (sum/mean only).\"\"\"
    return _group(group_name).allreduce(tensor, op, timeout_s=timeout_s,
                                        quant=quant, topology=topology,
                                        quorum=quorum)
""", """    contributions into the next quorum op (sum/mean only).\"\"\"
    tensor, back = _to_host(tensor)
    return back(_group(group_name).allreduce(tensor, op, timeout_s=timeout_s,
                                             quant=quant, topology=topology,
                                             quorum=quorum))
"""),
    ("""    return _group(group_name).allgather(tensor, timeout_s=timeout_s,
                                        quant=quant)
""", """    tensor, back = _to_host(tensor)
    return [back(x) for x in _group(group_name).allgather(
        tensor, timeout_s=timeout_s, quant=quant)]
"""),
    ("""    return _group(group_name).reducescatter(tensor, op, timeout_s=timeout_s,
                                            quant=quant)
""", """    tensor, back = _to_host(tensor)
    return back(_group(group_name).reducescatter(tensor, op,
                                                 timeout_s=timeout_s,
                                                 quant=quant))
"""),
    ("""    return _group(group_name).broadcast(tensor, root=src_rank,
                                        timeout_s=timeout_s, quant=quant,
                                        topology=topology)
""", """    tensor, back = _to_host(tensor)
    return back(_group(group_name).broadcast(tensor, root=src_rank,
                                             timeout_s=timeout_s, quant=quant,
                                             topology=topology))
"""),
    ("""    _group(group_name).send(tensor, dst_rank, tag, timeout_s=timeout_s)
""", """    _group(group_name).send(_to_host(tensor)[0], dst_rank, tag,
                            timeout_s=timeout_s)
"""),
]
# the stage hands DpGradSync its gradients as a dict of host arrays by
# parameter name, flattened in key order instead of jax.tree_util's
DP_SYNC_HOST = [
    ("""       fp32-accumulated grad tree is final.
    2. **launch** — :meth:`launch` flattens the tree in deterministic
       ``jax.tree_util`` order, packs leaves greedily into buckets of at""",
     """       fp32-accumulated grad tree is final.
    2. **launch** — :meth:`launch` flattens the tree (a dict of host
       arrays by parameter name) in its key order, packs leaves greedily
       into buckets of at"""),
    ("""        allreduces.  Returns the number of buckets launched.\"\"\"
        import jax

""", """        allreduces.  Returns the number of buckets launched.\"\"\"
"""),
    ("""        leaves, treedef = jax.tree_util.tree_flatten(grad_tree)
        meta = [(l.shape, np.dtype(l.dtype)) for l in leaves]
        flat32 = [np.asarray(jax.device_get(l)).astype(np.float32, copy=False)
                  for l in leaves]
""", """        treedef = list(grad_tree)
        leaves = [grad_tree[k] for k in treedef]
        meta = [(l.shape, np.dtype(l.dtype)) for l in leaves]
        flat32 = [np.asarray(l).astype(np.float32, copy=False)
                  for l in leaves]
"""),
    ("""        return the dp-mean grad tree in the original structure/dtypes.\"\"\"
        import jax

""", """        return the dp-mean grad tree in the original structure/dtypes.\"\"\"
"""),
    ("        return jax.tree_util.tree_unflatten(treedef, leaves)\n",
     "        return dict(zip(treedef, leaves))\n"),
]
# RL (rllib/): learners on the card take device= and num_gpus_per_learner=
# in place of platform=; the exports leave out what waits for later slices
RLLIB_LEARNERS = [
    ("        self.learner_platform: Optional[str] = None\n",
     "        self.learner_device: Optional[str] = None\n"
     "        self.num_gpus_per_learner: float = 1\n"),
    ("""    def learners(self, *, num_learners: Optional[int] = None,
                 platform: Optional[str] = None) -> "AlgorithmConfig":
        if num_learners is not None:
            self.num_learners = num_learners
        if platform is not None:
            self.learner_platform = platform
        return self
""", '''    def learners(self, *, num_learners: Optional[int] = None,
                 device: Optional[str] = None,
                 num_gpus_per_learner: Optional[float] = None
                 ) -> "AlgorithmConfig":
        """``device``: None (the card) or ``"cpu"``.  A learner actor on
        the card asks ``num_gpus_per_learner`` (default 1; a share
        0 < x < 1 is allowed, since a gang folds its gradients over the
        host ring, not in a torch.distributed group)."""
        if num_learners is not None:
            self.num_learners = num_learners
        if device is not None:
            self.learner_device = device
        if num_gpus_per_learner is not None:
            if num_gpus_per_learner <= 0:
                raise ValueError("num_gpus_per_learner must be > 0")
            self.num_gpus_per_learner = num_gpus_per_learner
        return self
''')]
RLLIB_PPO = [
    ("EnvRunner actors → JaxLearner → weight sync.",
     "EnvRunner actors → TorchLearner → weight sync."),
    ("math lives in the jitted learner (core/learner.py)",
     "math lives in the learner (core/learner.py)"),
    ("""            num_learners=config.num_learners, seed=config.seed,
            platform=config.learner_platform)
""", """            num_learners=config.num_learners, seed=config.seed,
            device=config.learner_device,
            num_gpus_per_learner=config.num_gpus_per_learner)
"""),
    ("""                              seed=config.seed + i,
                              platform=config.learner_platform)
""", """                              seed=config.seed + i,
                              device=config.learner_device,
                              num_gpus_per_learner=(
                                  config.num_gpus_per_learner))
""")]
RLLIB_IMPALA = [
    ("stale either way: the jitted\nlearner recomputes",
     "stale either way: the\nlearner recomputes"),
    ("""                platform=config.learner_platform,
""", """                device=config.learner_device,
                num_gpus_per_learner=config.num_gpus_per_learner,
"""),
    ("""                job=self._job, platform=config.learner_platform,
""", """                job=self._job, device=config.learner_device,
"""),
    ("# so the jitted update compiles ONCE (a variable-width concat would\n",
     "# so the update keeps ONE shape (a variable-width concat would\n")]
RLLIB_EXPORTS = [
    ("EnvRunner actors sample on CPU, a JAX Learner updates on device, the\n"
     "Algorithm is the Tune-trainable driver loop).\n",
     "EnvRunner actors sample on CPU, a torch Learner updates on the card, "
     "the\nAlgorithm is the Tune-trainable driver loop).  DQN and SAC wait "
     "for\nROADMAP.md A5b.\n"),
    ("from ray_tpu_torch.rllib.algorithms.dqn import DQN, DQNConfig\n", ""),
    ("from ray_tpu_torch.rllib.algorithms.sac import SAC, SACConfig\n", ""),
    ("""__all__ = ["Algorithm", "AlgorithmConfig", "BC", "BCConfig",
           "DQN", "DQNConfig", "FragmentStream", "IMPALA", "IMPALAConfig",
           "InferencePool", "LearnerGang", "MARWIL", "MARWILConfig",
           "PPO", "PPOConfig", "PodracerLearner", "SAC", "SACConfig",
           "WeightMailbox"]
""", """__all__ = ["Algorithm", "AlgorithmConfig", "BC", "BCConfig",
           "FragmentStream", "IMPALA", "IMPALAConfig", "InferencePool",
           "LearnerGang", "MARWIL", "MARWILConfig", "PPO", "PPOConfig",
           "PodracerLearner", "WeightMailbox"]
""")]
# Data (data/): the card's hand-off is iter_torch_batches(device=...), which
# the JAX package already has; iter_jax_batches goes
DATA_JAX_BATCHES = """    def iter_jax_batches(self, *, batch_size: Optional[int] = 256,
                         drop_last: bool = True, device=None, sharding=None,
                         prefetch: int = 2, dtypes=None) -> Iterator[Any]:
"""
DATA_ITERATOR = [
    ("""DataIterator: batched consumption of a Dataset, including the TPU path.

Reference: python/ray/data/iterator.py (DataIterator.iter_batches /
iter_torch_batches) and _internal/execution/streaming_split coordination.
The TPU-first addition is ``iter_jax_batches``: numeric columns go host ->
device with a prefetch queue so the next batch's transfer overlaps the
current step's compute, optionally placed under a ``jax.sharding`` for a
multi-device mesh.
""", """DataIterator: batched consumption of a Dataset, including the card path.

Reference: python/ray/data/iterator.py (DataIterator.iter_batches /
iter_torch_batches) and _internal/execution/streaming_split coordination.
The card path is ``iter_torch_batches(device=...)``: numeric columns become
tensors and go host -> device, one batch at a time, as the consumer asks.
"""),
    (DATA_JAX_BATCHES + """        import jax

        def put(batch: Block):
            batch = BlockAccessor.to_numpy_block(batch)
            out = {}
            for k, v in batch.items():
                if v.dtype.kind == "O":
                    out[k] = v          # leave object columns on host
                    continue
                if dtypes and k in dtypes:
                    v = v.astype(dtypes[k])
                if sharding is not None:
                    out[k] = jax.device_put(v, sharding)
                elif device is not None:
                    out[k] = jax.device_put(v, device)
                else:
                    out[k] = jax.device_put(v)
            return out

        # Depth-`prefetch` pipeline: device transfers for upcoming batches are
        # issued before the current batch is consumed, hiding host->HBM copy
        # behind step compute.
        queue: collections.deque = collections.deque()
        it = _rebatch(self._iter_blocks(), batch_size, drop_last, None, None)
        for batch in it:
            queue.append(put(batch))
            if len(queue) > prefetch:
                yield queue.popleft()
        while queue:
            yield queue.popleft()

""", ""),
    # a read-only column (an Arrow-backed block's) is copied: its tensor
    # owns its memory, and torch.from_numpy does not warn
    ("""        object columns stay numpy.\"\"\"
""", """        object columns stay numpy.  A read-only column (an Arrow-backed
        block's) is copied on the host first, so its tensor owns its
        memory; a writeable one passes zero-copy.\"\"\"
"""),
    ("""                t = torch.from_numpy(np.ascontiguousarray(v))
""", """                if not v.flags.writeable:
                    v = np.array(v)
                t = torch.from_numpy(np.ascontiguousarray(v))
"""),
    # what the card's checks ask of a coordinator: no CUDA, no JAX
    ("""    def _rebalance_equal(self):
""", '''    def process_facts(self) -> Dict[str, Any]:
        """The coordinator's process: its pid, whether CUDA is up in it,
        and the top-level packages it has loaded."""
        import os
        import sys

        torch = sys.modules.get("torch")
        return {"pid": os.getpid(),
                "cuda_initialized": bool(
                    torch is not None and torch.cuda.is_initialized()),
                "packages": sorted({m.split(".")[0]
                                    for m in list(sys.modules)})}

    def _rebalance_equal(self):
''')]
DATA_DATASET = [
    ("""feeds ``jax.device_put`` directly, which is the point: the terminal consumer
on this stack is a TPU training loop.
""", """feeds ``torch.from_numpy`` directly, which is the point: the terminal
consumer on this stack is a training loop on the card.
"""),
    (DATA_JAX_BATCHES + """        return self.iterator().iter_jax_batches(
            batch_size=batch_size, drop_last=drop_last, device=device,
            sharding=sharding, prefetch=prefetch, dtypes=dtypes)

""", "")]
DATA_BLOCK = [
    ("""- dict[str, np.ndarray] — the TPU hand-off layout: round-trips the
  shared-memory store zero-copy via pickle-5 buffers and feeds
  ``jax.device_put`` without a pivot;
""", """- dict[str, np.ndarray] — the card hand-off layout: round-trips the
  shared-memory store zero-copy via pickle-5 buffers and feeds
  ``torch.from_numpy`` without a pivot;
"""),
    ("(the jax hand-off / all-to-all pivot)",
     "(the torch hand-off / all-to-all pivot)"),
    ("the TPU-first canonical layout", "the card-first canonical layout")]
DATA_INIT = [
    ("""TPU-native counterpart of Ray Data (reference: python/ray/data/): the same
lazy logical-plan / streaming-executor architecture, with dict-of-numpy
blocks as the canonical format so data flows shared-memory store ->
``jax.device_put`` without row pivots, and ``iter_jax_batches`` /
``streaming_split`` feeding per-host TPU training loops.
""", """Counterpart of Ray Data (reference: python/ray/data/): the same lazy
logical-plan / streaming-executor architecture, with dict-of-numpy blocks
as the canonical format so data flows shared-memory store ->
``torch.from_numpy`` without row pivots, and ``iter_torch_batches`` /
``streaming_split`` feeding training loops on the cards.
""")]
EDITED_COPIES = {
    "util/collective/__init__.py": [
        # xla.py's in-program collectives are torch.distributed calls here
        ("quantization, topology, xla\n", "quantization, topology\n"),
        ('"quantization", "topology", "xla",\n',
         '"quantization", "topology",\n')],
    "util/collective/collective.py": COLLECTIVE_TENSORS,
    "train/pipeline/dp_sync.py": DP_SYNC_HOST,
    # the reference's docstring names its own history
    "llm/_metrics.py": [
        ("series ride, PR 1-3).", "series ride).")],
    "serve/_controller.py": SERVE_STARTING,
    "llm/deployment.py": LLM_ENGINE_CARD,
    "rllib/__init__.py": RLLIB_EXPORTS,
    "data/__init__.py": DATA_INIT,
    "data/block.py": DATA_BLOCK,
    "data/dataset.py": DATA_DATASET,
    "data/iterator.py": DATA_ITERATOR,
    "train/_session.py": [
        ("iter_batches/iter_jax_batches", "iter_batches/iter_torch_batches")],
    "rllib/algorithms/algorithm.py": RLLIB_LEARNERS,
    "rllib/algorithms/ppo.py": RLLIB_PPO,
    "rllib/algorithms/impala.py": RLLIB_IMPALA,
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
        CONFIG_IMPORT, TEMP_ROOT, *DRAIN_PACED, *UNPICKLE_ONE_AT_A_TIME,
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
         "ray_tpu_torch.train.torch_config import"),
        # C17: the split coordinators end with the fit that made them
        # (each holds a CPU; a _SplitIterator is in a reference cycle, so
        # its handle waits for the cyclic GC)
        ("""            metrics["gang_workers"].set(0, mlabels)
            executor.shutdown()
""", """            metrics["gang_workers"].set(0, mlabels)
            executor.shutdown()
            if dataset_shards is not None:
                import ray_tpu_torch

                for its in per_name.values():
                    ray_tpu_torch.kill(its[0]._coord)
""")],
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
    paths = sorted(PORT.rglob("*.py"))
    assert {PORT / "serve" / "_controller.py", PORT / "llm" / "deployment.py",
            PORT / "llm" / "admission.py"} <= set(paths)
    for path in paths:
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


# C13: a driver whose GCS connection closed for good, with an actor call
# queued for an actor it has not yet connected to.  Run in a process of its
# own: the GCS is killed there.
_GCS_GONE = """
import asyncio, json, time
import ray_tpu_torch as rt
from ray_tpu_torch._private import worker as wm

@rt.remote
class Probe:
    def ping(self):
        return 1

rt.init(num_cpus=2, num_gpus=0)
core = wm.global_worker_core()
late = Probe.remote()
# alive at the GCS, while this driver has not connected to it yet
core.gcs_call_sync("get_actor_info", {"actor_id": late._actor_id.binary(),
                                      "wait_alive": True, "timeout": 60})
wm._global_worker.node.kill_gcs()
ref = late.ping.remote()
time.sleep(0.5)
t0 = time.monotonic()
try:
    core.io.run(asyncio.sleep(0), timeout=5)
    loop_s = time.monotonic() - t0
except Exception:
    loop_s = None
t0 = time.monotonic()
rt.shutdown()
print(json.dumps({"loop_s": loop_s, "shutdown_s": time.monotonic() - t0,
                  "io_alive": core.io._thread.is_alive()}))
"""


def test_queued_actor_call_lets_the_io_loop_run_when_the_gcs_is_gone(
        tmp_path):
    """The submitter of a call queued while the GCS connection is closed
    retries after a pause: the IO loop keeps running other callbacks (the
    parent's copy spins in ``_drain`` without awaiting and answers
    nothing), and ``shutdown()`` stops the loop within a few seconds."""
    import json
    import subprocess

    env = dict(os.environ, PYTHONPATH=str(REPO),
               RAY_TPU_TORCH_TMPDIR=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", _GCS_GONE], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["loop_s"] is not None and got["loop_s"] < 1.0, got
    assert got["shutdown_s"] < 5.0, got
    assert got["io_alive"] is False, got


_IMPORT_RACE = """
import pickle, sys, threading
import ray_tpu_torch
from ray_tpu_torch._private import serialization
blobs = pickle.load(open(sys.argv[1], "rb"))
ctx = serialization.get_serialization_context()
bar = threading.Barrier(len(blobs))
errors = []
def load(blob):
    bar.wait()
    try:
        ctx.deserialize(serialization.SerializedObject(blob, []))
    except Exception as e:
        errors.append(repr(e))
threads = [threading.Thread(target=load, args=(b,)) for b in blobs]
for t in threads:
    t.start()
for t in threads:
    t.join(60)
print("errors", errors)
"""


def _import_race(tmp_path) -> list:
    """Two threads of a fresh process unpickle, at once, a class of
    ``ray_tpu_torch.data._executor`` and one of
    ``ray_tpu_torch.data.block``: each import of the data package begins
    with a different submodule.  The children's outputs."""
    import subprocess

    from ray_tpu_torch.data._executor import DataContext
    from ray_tpu_torch.data.block import BlockMetadata

    path = tmp_path / "blobs.pkl"
    with open(path, "wb") as f:
        pickle.dump([pickle.dumps(DataContext), pickle.dumps(BlockMetadata)],
                    f)
    outs = []
    for _ in range(4):
        out = subprocess.run(
            [sys.executable, "-c", _IMPORT_RACE, str(path)],
            env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True,
            text=True, timeout=120)
        outs.append(out.stdout.strip() or out.stderr[-2000:])
    return outs


def test_concurrent_unpickling_imports_one_payload_at_a_time(tmp_path):
    """C18: two tasks that a worker runs at once, each unpickling a payload
    that imports a different submodule of a package the process has not
    loaded, deadlocked in CPython's module locks (``_DeadlockError``,
    phase 6t's write tasks on the card).  A process unpickles one payload
    at a time (``serialization.UNPICKLE_LOCK``), so the race never
    starts."""
    assert _import_race(tmp_path) == ["errors []"] * 4
