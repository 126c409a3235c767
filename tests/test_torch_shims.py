"""The port's task libraries on the CPU: ``util/actor_pool.py``,
``util/queue.py``, ``util/multiprocessing.py``, ``util/joblib.py`` and
``workflow/`` (on the port's ``dag.DAGNode``).

On one port runtime for the module (``init(num_cpus=4)``, no GPU): the cases
of ``tests/test_shims.py``, ``tests/test_joblib.py`` and
``tests/test_workflow_dag.py``, one for one.  The joblib cases skip where
joblib is not installed, as the JAX package's do.

This file imports neither JAX nor the JAX package: the workers import it.
"""

import os

import pytest

import ray_tpu_torch
from ray_tpu_torch import workflow
from ray_tpu_torch.util.actor_pool import ActorPool
from ray_tpu_torch.util.queue import Empty, Full, Queue


@pytest.fixture(scope="module")
def runtime():
    ray_tpu_torch.init(num_cpus=4, num_gpus=0,
                       object_store_memory=256 * 1024 ** 2)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote
class Doubler:
    def double(self, x):
        return 2 * x


# ------------------------------------------------------------ actor pool
def test_actor_pool_ordered_and_unordered(runtime):
    actors = [Doubler.options(num_cpus=0.1).remote() for _ in range(2)]
    pool = ActorPool(actors)
    outs = list(pool.map(lambda a, v: a.double.remote(v), range(8)))
    assert outs == [2 * i for i in range(8)]
    outs = sorted(pool.map_unordered(lambda a, v: a.double.remote(v),
                                     range(8)))
    assert outs == sorted(2 * i for i in range(8))
    for a in actors:
        ray_tpu_torch.kill(a)


def test_actor_pool_submit_get(runtime):
    actor = Doubler.options(num_cpus=0.1).remote()
    pool = ActorPool([actor])
    pool.submit(lambda a, v: a.double.remote(v), 5)
    assert pool.has_next()
    assert pool.get_next(timeout=30) == 10
    assert not pool.has_next()
    ray_tpu_torch.kill(actor)


# ------------------------------------------------------------------ queue
def test_queue_basic(runtime):
    q = Queue(maxsize=2)
    q.put(1)
    q.put(2)
    assert q.qsize() == 2
    assert q.full()
    with pytest.raises(Full):
        q.put(3, block=False)
    assert q.get() == 1
    assert q.get() == 2
    assert q.empty()
    with pytest.raises(Empty):
        q.get_nowait()
    with pytest.raises(Empty):
        q.get(timeout=0.2)
    q.put_nowait_batch([7, 8])
    assert q.get_nowait_batch(2) == [7, 8]
    q.shutdown()


@ray_tpu_torch.remote
def _producer(q, n):
    for i in range(n):
        q.put(i)
    return True


def test_queue_cross_actor(runtime):
    q = Queue()
    ref = _producer.remote(q, 5)
    got = [q.get(timeout=30) for _ in range(5)]
    assert got == list(range(5))
    assert ray_tpu_torch.get(ref, timeout=30)
    q.shutdown()


# -------------------------------------------------------- multiprocessing
def _sq(x):
    return x * x


def _add(a, b):
    return a + b


def test_multiprocessing_pool(runtime):
    from ray_tpu_torch.util.multiprocessing import Pool

    with Pool(processes=2) as p:
        assert p.map(_sq, range(10)) == [i * i for i in range(10)]
        assert p.starmap(_add, [(1, 2), (3, 4)]) == [3, 7]
        assert p.apply(_add, (5, 6)) == 11
        r = p.map_async(_sq, range(4))
        assert r.get(timeout=30) == [0, 1, 4, 9]
        assert sorted(p.imap_unordered(_sq, range(6))) == \
            sorted(i * i for i in range(6))
        assert list(p.imap(_sq, range(6))) == [i * i for i in range(6)]


# ----------------------------------------------------------------- joblib
def _sq_pid(x):
    return x * x, os.getpid()


def test_joblib_parallel_over_cluster(runtime):
    joblib = pytest.importorskip("joblib")
    from ray_tpu_torch.util.joblib import register_ray

    register_ray()
    with joblib.parallel_config(backend="ray_tpu_torch", n_jobs=4):
        out = joblib.Parallel()(joblib.delayed(_sq_pid)(i)
                                for i in range(12))
    assert [v for v, _pid in out] == [i * i for i in range(12)]
    # batches actually left this process
    pids = {pid for _v, pid in out}
    assert os.getpid() not in pids
    assert pids, "no worker pids recorded"


def _explode(x):
    raise ValueError(f"boom-{x}")


def test_joblib_error_propagates(runtime):
    joblib = pytest.importorskip("joblib")
    from ray_tpu_torch.util.joblib import register_ray

    register_ray()
    with joblib.parallel_config(backend="ray_tpu_torch", n_jobs=2):
        with pytest.raises(Exception, match="boom"):
            joblib.Parallel()(joblib.delayed(_explode)(i) for i in range(3))


# ----------------------------------------------------- DAGs and workflows
@ray_tpu_torch.remote
def load(x):
    return list(range(x))


@ray_tpu_torch.remote
def square(xs):
    return [v * v for v in xs]


@ray_tpu_torch.remote
def total(a, b):
    return sum(a) + sum(b)


def test_dag_execute(runtime):
    data = load.bind(5)
    dag = total.bind(square.bind(data), data)  # diamond: data used twice
    ref = dag.execute()
    assert ray_tpu_torch.get(ref, timeout=60) == \
        sum(v * v for v in range(5)) + 10


def test_workflow_run_and_memoized_resume(runtime, tmp_path):
    calls = str(tmp_path / "calls")
    os.makedirs(calls)

    @ray_tpu_torch.remote
    def counted(x, tag):
        # one marker file per EXECUTION (not per logical step)
        import uuid

        open(os.path.join(calls, f"{tag}-{uuid.uuid4().hex[:6]}"), "w").close()
        return x * 2

    dag = counted.bind(counted.bind(21, "inner"), "outer")
    out = workflow.run(dag, workflow_id="wf-test", storage=str(tmp_path))
    assert out == 84
    assert workflow.get_status("wf-test", storage=str(tmp_path)) == \
        "SUCCEEDED"
    n_first = len(os.listdir(calls))
    assert n_first == 2
    # resume re-drives the persisted DAG; completed steps come from
    # storage, so NO new executions happen
    assert workflow.resume("wf-test", storage=str(tmp_path)) == 84
    assert len(os.listdir(calls)) == n_first


def test_workflow_resume_after_failure(runtime, tmp_path):
    marker = str(tmp_path / "fail-once")

    @ray_tpu_torch.remote
    def flaky(x):
        if not os.path.exists(marker):
            open(marker, "w").close()
            raise RuntimeError("first attempt dies")
        return x + 1

    @ray_tpu_torch.remote
    def base():
        return 10

    dag = flaky.bind(base.bind())
    with pytest.raises(Exception):
        workflow.run(dag, workflow_id="wf-fail", storage=str(tmp_path))
    assert workflow.get_status("wf-fail", storage=str(tmp_path)) == "FAILED"
    # resume: base() loads from storage, flaky reruns and succeeds
    assert workflow.resume("wf-fail", storage=str(tmp_path)) == 11
    wfs = {w["workflow_id"]: w for w in workflow.list_all(str(tmp_path))}
    assert wfs["wf-fail"]["status"] == "SUCCEEDED"
