"""The port's Serve and LLM deployment on the CPU, against the JAX package.

One port runtime for the module (``ray_tpu_torch.init(num_cpus=4)``, no
GPU), with one Serve controller, shut down at the end.

Parity with ``ray_tpu``: the ``InferenceEngine`` actor's ``generate``, its
dynamic-returns ``stream`` and its incremental ``next_output`` give the JAX
``EngineCore``'s greedy tokens from the same seed and config (cases of
``tests/test_llm.py:407``); 8 concurrent streams through ``llm_deployment``
on a cache small enough to preempt give the JAX engine's unpreempted tokens,
with continuous batching, no leaked page and the ``ray_tpu_llm_*`` series
folded by ``metrics_view.summarize_llm`` from the nodelet's scrape
(``:452``); a multiplexed adapter's logit bias gives the JAX engine's
tokens (``:530``); HTTP SSE streams the handle's tokens (``:559``); the
``AdmissionController`` admits, orders and sheds as the JAX one does on the
same script of admits, releases and clock steps
(``tests/test_llm_prefix.py:254-332``); a request's TTFT decomposition has
the JAX engine's keys, and ``_emit_cpath`` stamps it on the core worker's
event stream or does nothing without one.  Serve on its own: the cases of
``tests/test_serve.py`` that need no timing (deploy and handle, replicas
and methods, composition, the HTTP proxy, batching and the batcher's
cancelled caller, streaming deployments, multiplexing and its LRU), and a
replica whose constructor outlasts the health-check timeout.  Nothing falls
back: without a GPU in the cluster, ``llm_deployment()`` on the default
device raises at once.

Every engine runs with ``device="cpu"`` at ``GPT2Config.tiny()``.  JAX and
the JAX package are imported inside the tests only: the replicas and
engines never load them.
"""

import asyncio
import http.client
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.llm import InferenceEngine, llm_deployment

# the cache of tests/test_llm.py's streaming case: 14 pages of 4 slots for
# 8 requests of ~17 tokens, so requests overlap and preemption fires
STREAM_ENGINE = dict(num_pages=14, page_size=4, max_batch_tokens=128,
                     seed=0, engine_name="serve-e2e", step_delay_s=0.02,
                     device="cpu")
STREAM_PROMPTS = [[i + 1, i + 2, i + 3, i + 4, i + 5] for i in range(8)]
STREAM_TOKENS = 12


@pytest.fixture(scope="module")
def runtime():
    # the workers push their metrics to the nodelet every 0.5 s, not 5
    saved = os.environ.get("RAY_TPU_TORCH_METRICS_REPORT_INTERVAL_MS")
    os.environ["RAY_TPU_TORCH_METRICS_REPORT_INTERVAL_MS"] = "500"
    try:
        ray_tpu_torch.init(num_cpus=4, num_gpus=0,
                           object_store_memory=256 * 1024 ** 2)
    finally:
        if saved is None:
            del os.environ["RAY_TPU_TORCH_METRICS_REPORT_INTERVAL_MS"]
        else:
            os.environ["RAY_TPU_TORCH_METRICS_REPORT_INTERVAL_MS"] = saved
    yield ray_tpu_torch
    serve.shutdown()
    ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def llm_app(runtime):
    """One LLM deployment for the adapter and HTTP cases."""
    handle = serve.run(llm_deployment(engine_kwargs=dict(
        num_pages=32, page_size=8, seed=0, engine_name="mux-llm",
        device="cpu")), name="llmmux", route_prefix="/llmmux")
    yield handle
    serve.delete("llmmux")


def _jax_engine(**kw):
    from ray_tpu.llm import EngineCore

    return EngineCore(seed=0, **kw)


# ========================================================== engine actor

def test_engine_actor_matches_the_jax_engine(runtime):
    want = _jax_engine(num_pages=32, page_size=8)
    # a per-step floor keeps the incremental poll below from seeing the
    # whole request in one batch
    eng = InferenceEngine.options(num_cpus=0).remote(
        engine_name="actor-test", num_pages=32, page_size=8,
        step_delay_s=0.05, device="cpu")
    try:
        full = ray_tpu_torch.get(
            eng.generate.remote([1, 2, 3], {"max_tokens": 6}), timeout=120)
        assert full["tokens"] == \
            want.generate([1, 2, 3], {"max_tokens": 6})["tokens"]
        # the dynamic-generator machinery: one ref per token
        gen = eng.stream.options(num_returns="dynamic").remote(
            [1, 2, 3], {"max_tokens": 6})
        assert [ray_tpu_torch.get(r, timeout=60) for r in gen] == \
            full["tokens"]
        # the incremental long poll: tokens arrive before completion
        rid = ray_tpu_torch.get(
            eng.submit.remote([4, 5], {"max_tokens": 8}), timeout=60)
        seen, polls = [], 0
        while True:
            out = ray_tpu_torch.get(
                eng.next_output.remote(rid, len(seen), 10.0), timeout=60)
            seen += out["tokens"]
            polls += 1
            if out["finished"]:
                break
        assert polls >= 2 and seen == \
            want.generate([4, 5], {"max_tokens": 8})["tokens"]
        assert ray_tpu_torch.get(eng.result.remote(rid))["tokens"] == seen
        stats = ray_tpu_torch.get(eng.stats.remote())
        assert stats["process"]["device"] == "cpu"
        assert stats["kv_pages_free"] == stats["kv_pages_total"]
        assert not {"jax", "ray_tpu"} & set(stats["process"]["packages"])
    finally:
        ray_tpu_torch.kill(eng)


def test_ttft_decomposition_and_its_critical_path_event(monkeypatch):
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.llm import EngineCore
    from ray_tpu_torch.models import GPT2Config

    core = EngineCore(GPT2Config.tiny(), device="cpu", num_pages=16,
                      page_size=4, prefill_chunk_tokens=3)
    sent = []

    class Core:
        job_id = bytes.fromhex("0a0b")
        _node_id_hex = "n0"
        _worker_id_hex = "w0"

        def emit_raw_event(self, ev, *, terminal=False):
            sent.append((ev, terminal))

    # without a core worker, nothing is emitted and nothing raises
    monkeypatch.setattr(worker_mod, "global_worker_core", lambda: None)
    rid = core.submit([1, 2, 3, 4, 5, 6, 7], {"max_tokens": 2},
                      admission_wait_s=0.01)
    core.run_until_done([rid])
    assert sent == []
    monkeypatch.setattr(worker_mod, "global_worker_core", lambda: Core())
    rid = core.submit([1, 2, 3, 4, 5, 6, 7], {"max_tokens": 2})
    core.run_until_done([rid])
    decomp = core.ttft_decomposition(rid)
    [(ev, terminal)] = sent
    assert terminal and ev["state"] == "CPATH" and \
        ev["task_id"] == f"cpath-llm-{rid}"
    assert ev["cpath"]["decomposition"] == decomp
    # the JAX engine's decomposition of the same request has the same keys
    want = _jax_engine(num_pages=16, page_size=4, prefill_chunk_tokens=3)
    jrid = want.submit([1, 2, 3, 4, 5, 6, 7], {"max_tokens": 2})
    want.run_until_done([jrid])
    jdecomp = want.ttft_decomposition(jrid)
    assert sorted(decomp) == sorted(jdecomp)
    assert decomp["chunks"] == jdecomp["chunks"] >= 2
    parts = sum(decomp[k] for k in ("admission_wait_s", "queue_s",
                                    "prefill_exec_s", "preempt_wait_s"))
    assert parts == pytest.approx(decomp["ttft_s"], abs=1e-5)


# =========================================================== deployment

def test_serve_streaming_matches_the_jax_engine(runtime):
    from ray_tpu_torch._private import metrics_view as mv

    expected = [_jax_engine(num_pages=256, page_size=8).generate(
        p, {"max_tokens": STREAM_TOKENS})["tokens"] for p in STREAM_PROMPTS]
    h = serve.run(llm_deployment(engine_kwargs=STREAM_ENGINE),
                  name="llmapp", route_prefix="/llm")
    try:
        streams = [h.remote({"prompt_ids": p, "max_tokens": STREAM_TOKENS,
                             "stream": True}).result(120)
                   for p in STREAM_PROMPTS]
        results, errors = [None] * len(streams), []

        def consume(i, s):
            try:
                events = list(s)
                assert events[-1].get("done") is True
                results[i] = [e["token"] for e in events[:-1]]
            except Exception as e:
                errors.append((i, repr(e)))

        threads = [threading.Thread(target=consume, args=(i, s))
                   for i, s in enumerate(streams)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads) and not errors, errors
        assert results == expected
        stats = h.options(method_name="engine_stats").remote().result(60)
        assert stats["max_decode_batch"] > 1, stats
        assert stats["preemptions"] >= 1, stats
        assert stats["kv_pages_free"] == stats["kv_pages_total"]
        # the engine's series reach the nodelet's scrape (the engine's
        # worker pushes them) and fold as the JAX package's state view does
        deadline = time.monotonic() + 45
        view = {}
        while time.monotonic() < deadline:
            view = mv.summarize_llm(mv.collect_samples(
                [_nodelet_metrics_text()])).get("serve-e2e", {})
            if view.get("generated_tokens", 0) >= 8 * STREAM_TOKENS:
                break
            time.sleep(0.25)
        assert view.get("requests", 0) >= 8, view
        assert view.get("ttft_p50_s", 0) > 0, view
        assert view.get("tokens_per_second", 0) > 0, view
        assert view.get("generated_tokens", 0) >= 8 * STREAM_TOKENS, view
        assert view.get("preemptions", 0) >= 1, view
    finally:
        serve.delete("llmapp")


def _nodelet_metrics_text() -> str:
    """The node's merged metrics scrape, over the nodelet's RPC."""
    from ray_tpu_torch._private import rpc
    from ray_tpu_torch._private import worker as worker_mod

    addr = worker_mod.global_worker().node.nodelet_addr

    async def call():
        conn = await rpc.connect(*addr, name="test->nodelet")
        try:
            return await conn.call("get_metrics_text", None, timeout=30)
        finally:
            await conn.close()

    return worker_mod.global_worker_core().io.run(call())


def test_multiplexed_adapters_match_the_jax_engine(llm_app):
    want = _jax_engine(num_pages=32, page_size=8)
    body = {"prompt_ids": [1, 2, 3], "max_tokens": 4, "stream": False}
    got = {None: llm_app.remote(dict(body)).result(120)["tokens"]}
    for adapter in ("ad1", "ad1", "ad2"):
        out = llm_app.options(multiplexed_model_id=adapter).remote(
            dict(body)).result(120)
        assert got.setdefault(adapter, out["tokens"]) == out["tokens"]
    for adapter, tokens in got.items():
        params = {"max_tokens": 4, **({"adapter": adapter} if adapter
                                      else {})}
        assert tokens == want.generate([1, 2, 3], params)["tokens"]
    assert got["ad1"] != got[None] and got["ad1"] != got["ad2"]
    stats = llm_app.options(method_name="engine_stats").remote().result(60)
    assert set(stats["adapters"]) >= {"ad1", "ad2"}


def test_http_sse_streams_the_handles_tokens(llm_app):
    body = {"prompt_ids": [1, 2, 3], "max_tokens": 8}
    want = llm_app.remote({**body, "stream": False}).result(120)["tokens"]
    port = serve.start(http_port=0)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/llmmux", body=json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200
    assert resp.getheader("Content-Type") == "text/event-stream"
    events = []
    while True:
        line = resp.fp.readline()
        if not line or line.strip() == b"data: [DONE]":
            break
        if line.startswith(b"data:"):
            events.append(json.loads(line[len(b"data:"):]))
    conn.close()
    assert events[-1].get("done") is True
    assert [e["token"] for e in events[:-1]] == want and len(want) == 8


def test_no_card_raises_at_once(runtime):
    from ray_tpu_torch.llm.deployment import LLMServer

    assert ray_tpu_torch.cluster_resources().get("GPU", 0) == 0
    for kwargs in (None, {"device": "cuda"}, {"num_pages": 8}):
        with pytest.raises(RuntimeError, match="no GPU"):
            llm_deployment(engine_kwargs=kwargs)
    # the replica's own check, before it asks for an engine actor
    with pytest.raises(RuntimeError, match="no GPU"):
        LLMServer({"engine_name": "nocard"})
    assert llm_deployment(engine_kwargs={"device": "cpu"}) is not None


# ============================================================ admission

def _admission_trace(controller, shed_type, script, **kw):
    """Run ``script`` against ``controller(**kw)`` on a fake clock: each
    ("admit", tenant) parks a caller, ("release",) frees a slot, ("clock",
    dt) moves the clock, ("sleep", s) waits s seconds of real time.  The
    trace: each caller's outcome in the order it came (dispatched with its
    wait, or shed with reason and retry hint), and the final stats."""
    async def run():
        now = [0.0]
        ac = controller(clock=lambda: now[0], **kw)
        trace, tasks = [], []

        async def caller(i, tenant):
            try:
                wait = await ac.admit(tenant)
                trace.append(("admitted", i, tenant, wait))
            except shed_type as e:
                trace.append(("shed", i, tenant, e.reason, e.retry_after_s))

        for i, (op, *arg) in enumerate(script):
            if op == "admit":
                tasks.append(asyncio.ensure_future(caller(i, arg[0])))
            elif op == "release":
                ac.release()
            elif op == "clock":
                now[0] += arg[0]
            else:
                await asyncio.sleep(arg[0])
            await asyncio.sleep(0)
        stats = ac.stats()
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        return trace, stats

    return asyncio.run(run())


def _random_script(seed, n=300):
    rng = np.random.default_rng(seed)
    script = []
    for _ in range(n):
        r = rng.random()
        if r < 0.5:
            script.append(("admit", str(rng.choice(["a", "b", "c"]))))
        elif r < 0.8:
            script.append(("release",))
        else:
            script.append(("clock", float(rng.integers(1, 40))))
    return script


ADMISSION_CASES = {
    # weighted-fair dequeue, queue-full and projected-wait sheds, waits on
    # the fake clock (the real-time deadline is never reached)
    "random-0": (_random_script(0), dict(
        max_inflight=3, max_queue=3, queue_deadline_s=60.0,
        tenant_weights={"b": 2.0})),
    "random-1": (_random_script(1), dict(
        max_inflight=2, max_queue=4, queue_deadline_s=60.0)),
    # a flooding tenant and a light one alternate (stride scheduling)
    "fairness": ([("admit", "flood")] * 4 + [("admit", "flood")] * 40
                 + [("admit", "light")] * 10 + [("release",)] * 20, dict(
                     max_inflight=4, max_queue=128, queue_deadline_s=60.0)),
    # queue full at the door, then the parked caller's deadline
    "deadline": ([("admit", "t"), ("admit", "t"), ("admit", "t"),
                  ("sleep", 0.2)], dict(max_inflight=1, max_queue=1,
                                        queue_deadline_s=0.05)),
}


@pytest.mark.parametrize("case", list(ADMISSION_CASES))
def test_admission_matches_the_jax_controller(case):
    from ray_tpu.exceptions import RequestShed as JaxShed
    from ray_tpu.llm.admission import AdmissionController as JaxController

    from ray_tpu_torch.exceptions import RequestShed
    from ray_tpu_torch.llm.admission import AdmissionController

    script, kw = ADMISSION_CASES[case]
    got = _admission_trace(AdmissionController, RequestShed, script, **kw)
    want = _admission_trace(JaxController, JaxShed, script, **kw)
    assert got == want
    reasons = {e[3] for e in got[0] if e[0] == "shed"}
    assert reasons == {"random-0": {"queue_full", "saturated"},
                       "random-1": {"queue_full", "saturated"},
                       "fairness": set(),
                       "deadline": {"queue_full", "deadline"}}[case]


# ======================================================== Serve alone

def test_deploy_and_handle(runtime):
    @serve.deployment
    class Echo:
        def __call__(self, x):
            return {"echo": x}

    h = serve.run(Echo.bind(), name="echo-app")
    try:
        assert h.remote("hi").result(60) == {"echo": "hi"}
        assert serve.status()["echo-app"]["Echo"]["running"] == 1
    finally:
        serve.delete("echo-app")


def test_replicas_and_methods(runtime):
    @serve.deployment(num_replicas=2)
    class Counter:
        def __init__(self, start):
            self.start = start

        def __call__(self, x):
            return self.start + x

        def double(self, x):
            return 2 * x

    h = serve.run(Counter.bind(100), name="counter")
    try:
        assert [h.remote(i).result(60) for i in range(10)] == \
            [100 + i for i in range(10)]
        assert h.options(method_name="double").remote(21).result(60) == 42
        assert serve.status()["counter"]["Counter"] == \
            {"target": 2, "running": 2}
    finally:
        serve.delete("counter")


def test_composition(runtime):
    @serve.deployment
    class Preprocess:
        def __call__(self, x):
            return x * 10

    @serve.deployment
    class Model:
        def __init__(self, pre):
            self.pre = pre

        def __call__(self, x):
            return self.pre.remote(x).result(60) + 1

    h = serve.run(Model.bind(Preprocess.bind()), name="composed")
    try:
        assert h.remote(4).result(60) == 41
    finally:
        serve.delete("composed")


def test_http_proxy(runtime):
    @serve.deployment
    class Api:
        def __call__(self, body):
            return {"got": body}

    serve.run(Api.bind(), name="api", route_prefix="/api")
    try:
        port = serve.start(http_port=0)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/api", method="POST",
            data=json.dumps({"k": 1}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert json.loads(resp.read()) == {"got": {"k": 1}}
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope",
                                   timeout=60)
        assert err.value.code == 404
    finally:
        serve.delete("api")


def test_batching(runtime):
    @serve.deployment
    class Batched:
        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.2)
        async def __call__(self, xs):
            return [{"x": x, "batch": len(xs)} for x in xs]

    h = serve.run(Batched.bind(), name="batched")
    try:
        outs = [r.result(60) for r in [h.remote(i) for i in range(4)]]
        assert [o["x"] for o in outs] == list(range(4))
        assert max(o["batch"] for o in outs) >= 2
    finally:
        serve.delete("batched")


def test_batcher_cancelled_caller_does_not_poison_batch():
    from ray_tpu_torch.serve.batching import _Batcher

    ran = []

    async def fn(xs):
        ran.append(list(xs))
        await asyncio.sleep(0.05)
        return [x * 2 for x in xs]

    async def boom(xs):
        raise RuntimeError("model exploded")

    async def main():
        b = _Batcher(fn, max_batch_size=3, batch_wait_timeout_s=5.0)
        t0 = asyncio.ensure_future(b.submit(None, 0))
        t1 = asyncio.ensure_future(b.submit(None, 1))
        await asyncio.sleep(0)
        t0.cancel()
        t2 = asyncio.ensure_future(b.submit(None, 2))
        done = await asyncio.gather(t0, t1, t2, return_exceptions=True)
        assert isinstance(done[0], asyncio.CancelledError)
        assert done[1:] == [2, 4] and ran == [[0, 1, 2]]
        b2 = _Batcher(boom, max_batch_size=2, batch_wait_timeout_s=5.0)
        u0 = asyncio.ensure_future(b2.submit(None, 0))
        await asyncio.sleep(0)
        u0.cancel()
        u1 = asyncio.ensure_future(b2.submit(None, 1))
        out = await asyncio.gather(u0, u1, return_exceptions=True)
        assert isinstance(out[0], asyncio.CancelledError)
        assert isinstance(out[1], RuntimeError)

    asyncio.run(main())


@pytest.mark.parametrize("kind", ["sync", "async"])
def test_streaming_deployment(runtime, kind):
    """A generator (or async generator) result streams: the handle yields a
    ResponseStream, and the HTTP proxy renders it as SSE."""
    from ray_tpu_torch.serve._streaming import ResponseStream

    @serve.deployment
    class Gen:
        def __call__(self, n):
            def it():
                for i in range(int(n)):
                    yield {"i": i}
            return it()

    @serve.deployment
    class AGen:
        async def __call__(self, n):
            async def it():
                for i in range(int(n)):
                    await asyncio.sleep(0)
                    yield {"i": i}
            return it()

    app = (Gen if kind == "sync" else AGen).bind()
    h = serve.run(app, name=f"gen-{kind}", route_prefix=f"/gen-{kind}")
    try:
        out = h.remote(5).result(60)
        assert isinstance(out, ResponseStream)
        assert list(out) == [{"i": i} for i in range(5)]
        port = serve.start(http_port=0)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", f"/gen-{kind}", body=json.dumps(6),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.getheader("Content-Type") == "text/event-stream"
        events = []
        while True:
            line = resp.fp.readline()
            if not line:
                break
            if line.strip() == b"data: [DONE]":
                events.append("DONE")
                break
            if line.startswith(b"data:"):
                events.append(json.loads(line[len(b"data:"):]))
        conn.close()
        assert events == [{"i": i} for i in range(6)] + ["DONE"]
    finally:
        serve.delete(f"gen-{kind}")


def test_multiplexed_router_affinity(runtime):
    """Repeat requests for a model go to a replica that already holds it:
    each model is loaded once on the replica that serves it."""
    @serve.deployment(num_replicas=2, max_ongoing_requests=4)
    class Adapters:
        def __init__(self):
            self.loads = []

        @serve.multiplexed(max_num_models_per_replica=3)
        async def get_model(self, model_id: str):
            self.loads.append(model_id)
            return f"weights-{model_id}"

        async def __call__(self, _):
            model = await self.get_model(serve.get_multiplexed_model_id())
            return {"model": model, "loads": list(self.loads)}

    serve.run(Adapters.bind(), name="mux", route_prefix="/mux")
    try:
        h = serve.get_app_handle("mux")
        for m in ("m1", "m2", "m3"):
            out = h.options(multiplexed_model_id=m).remote(None).result(60)
            assert out["model"] == f"weights-{m}"
        # the replicas report their models to the controller, which pushes
        # the map to the router
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            with h._target.lock:
                mm = dict(h._target.model_map)
            if sum(len(v) for v in mm.values()) >= 3:
                break
            time.sleep(0.05)
        assert sum(len(v) for v in mm.values()) >= 3, mm
        for _ in range(3):
            for m in ("m1", "m2", "m3"):
                out = h.options(multiplexed_model_id=m).remote(None) \
                    .result(60)
                assert out["model"] == f"weights-{m}"
                assert out["loads"].count(m) == 1, (m, out["loads"])
    finally:
        serve.delete("mux")


def test_multiplexed_requires_model_id(runtime):
    @serve.deployment
    class M:
        @serve.multiplexed(max_num_models_per_replica=1)
        async def get_model(self, model_id):
            return model_id

        async def __call__(self, _):
            return await self.get_model()

    serve.run(M.bind(), name="muxerr", route_prefix="/muxerr")
    try:
        with pytest.raises(Exception, match="no model id"):
            serve.get_app_handle("muxerr").remote(None).result(60)
    finally:
        serve.delete("muxerr")


def test_model_cache_lru_semantics():
    from ray_tpu_torch.serve.multiplex import _ModelCache

    events = []

    async def loader(owner, model_id):
        events.append(model_id)
        await asyncio.sleep(0.01)
        return f"w-{model_id}"

    async def main():
        cache = _ModelCache(loader, max_models=2)
        assert await cache.get(None, "a") == "w-a"
        assert await cache.get(None, "b") == "w-b"
        await cache.get(None, "a")       # b is now the LRU victim
        await cache.get(None, "c")       # evicted before c loads
        assert list(cache.models) == ["a", "c"]
        assert events == ["a", "b", "c"]
        await cache.get(None, "b")
        assert list(cache.models) == ["c", "b"]
        events.clear()
        outs = await asyncio.gather(*[cache.get(None, "z")
                                      for _ in range(5)])
        assert outs == ["w-z"] * 5 and events == ["z"]  # one cold load

    asyncio.run(main())


def test_slow_constructor_is_not_killed_by_the_health_check(runtime):
    """A replica whose constructor outlasts the health-check timeout (an
    engine actor bringing a model up on its card) is waited for, not killed
    and replaced."""
    @serve.deployment(health_check_period_s=0.1, health_check_timeout_s=0.3)
    class Slow:
        def __init__(self):
            import os

            time.sleep(1.5)
            self.pid = os.getpid()

        def __call__(self, _):
            return self.pid

    h = serve.run(Slow.bind(), name="slow")
    try:
        pid = h.remote(None).result(60)
        assert h.remote(None).result(60) == pid
        assert serve.status()["slow"]["Slow"] == {"target": 1, "running": 1}
    finally:
        serve.delete("slow")
