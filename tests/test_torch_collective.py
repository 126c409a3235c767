"""The port's host collectives (``ray_tpu_torch.util.collective``) across
actor ranks of the port's runtime, against the JAX package.

One port runtime for the module (``ray_tpu_torch.init(num_cpus=4)``) and
four rank actors, each in its own worker process, reused by every test:
a test joins them (or some of them) to a group of its own name, and puts
back any setting it changed.  The cases are those of
``tests/test_collective.py`` without its ``xla`` class (in-program JAX
collectives, whose counterpart in the port is the ``torch.distributed``
calls of ``parallel/``): allreduce, allgather, reducescatter, broadcast,
barrier, p2p; timeouts that name the absent rank; int8 wire quantization
(bitwise equal to ``ray_tpu.util.collective.quantization`` on the same
seeded inputs), topology selection, hierarchical and quorum reduce, the
pipelined ring and the shared-memory arena.  The ranks take numpy arrays
and CPU tensors: a tensor comes back as a tensor of its dtype.

This file imports neither JAX nor the JAX package at module level: the rank
actors' workers import it.
"""

import time
import uuid

import numpy as np
import pytest
import torch

import ray_tpu_torch

WORLD = 4


@ray_tpu_torch.remote
class Member:
    """One collective rank living in its own worker process; it joins any
    number of groups, each test's own."""

    def __init__(self):
        from ray_tpu_torch.util import collective as col

        self.col = col
        self._group = None

    def join(self, name, world, rank):
        self.col.init_collective_group(world, rank, backend="cpu",
                                       group_name=name)
        self._group = name
        self.rank = rank
        return rank

    def use(self, name):
        """Point the ops at group ``name``, which this rank joined."""
        self._group = name
        return True

    def _g(self):
        return self._group

    def allreduce(self, value, op="sum"):
        return self.col.allreduce(value, group_name=self._g(), op=op)

    def allgather(self, value):
        return self.col.allgather(value, group_name=self._g())

    def reducescatter(self, value, op="sum"):
        return self.col.reducescatter(value, group_name=self._g(), op=op)

    def broadcast(self, value, src_rank=0):
        return self.col.broadcast(value, src_rank=src_rank,
                                  group_name=self._g())

    def barrier(self):
        self.col.barrier(group_name=self._g())
        return True

    def send_many(self, dst, values, tag=0):
        for v in values:
            self.col.send(np.asarray(v), dst, group_name=self._g(), tag=tag)
        return True

    def recv_many(self, src, n, tag=0):
        return [self.col.recv(src, group_name=self._g(), tag=tag)
                for _ in range(n)]

    def barrier_timeout(self, timeout_s):
        self.col.barrier(group_name=self._g(), timeout_s=timeout_s)
        return True

    def recv_timeout(self, src, timeout_s, tag=0):
        return self.col.recv(src, group_name=self._g(), tag=tag,
                             timeout_s=timeout_s)

    def group_progress(self):
        return self.col.get_group_progress(self._g())

    def allreduce_kw(self, value, kw):
        return self.col.allreduce(np.asarray(value), group_name=self._g(),
                                  **kw)

    def timed_allreduce(self, value, kw):
        t0 = time.perf_counter()
        out = self.col.allreduce(np.asarray(value), group_name=self._g(),
                                 **kw)
        return time.perf_counter() - t0, out

    def quorum_allreduce(self, value, quorum, delay=0.0, timeout_s=None):
        if delay:
            time.sleep(delay)
        return self.col.allreduce(np.asarray(value), group_name=self._g(),
                                  quorum=quorum, timeout_s=timeout_s)

    def broadcast_kw(self, value, src_rank, kw):
        return self.col.broadcast(np.asarray(value), src_rank=src_rank,
                                  group_name=self._g(), **kw)

    def allgather_kw(self, value, kw):
        return self.col.allgather(np.asarray(value), group_name=self._g(),
                                  **kw)

    def set_config(self, name, value):
        """Set a flag; returns its old value, to put back."""
        from ray_tpu_torch._private.config import RayConfig

        old = getattr(RayConfig, name)
        RayConfig.set(name, value)
        return old

    def set_ack_delay(self, delay_s):
        from ray_tpu_torch.util.collective import collective as ccore

        ccore._groups[self._g()]._ack_delay_s = delay_s
        return True

    def group_stats(self):
        from ray_tpu_torch.util.collective import collective as ccore

        g = ccore._groups[self._g()]
        return {"last_quant_error": g.last_quant_error,
                "last_quorum_late": g.last_quorum_late}

    def shm_stats(self):
        from ray_tpu_torch.util.collective import collective as ccore

        g = ccore._groups[self._g()]
        return {"tx_active": g._shm_tx is not None,
                "rx_attached": len(g._shm_rx._att)}

    def patch_nodes(self, node_of_rank):
        """Simulate a multi-node world on one host: override the
        rendezvous node map and count shm descriptors arriving from
        cross-node senders."""
        from ray_tpu_torch.util.collective import collective as ccore
        from ray_tpu_torch.util.collective import shm_channel as shm_ch

        g = ccore._groups[self._g()]
        g._member_nodes = {int(r): n for r, n in node_of_rank.items()}
        g._test_cross_descs = 0
        orig = g._on_message

        async def counting(conn, msg):
            if shm_ch.is_desc(msg.get("data")) and \
                    g._member_nodes.get(msg["src"]) != \
                    g._member_nodes.get(g.rank):
                g._test_cross_descs += 1
            return await orig(conn, msg)

        g.core.server.handlers[g._handler_name] = counting
        return True

    def cross_desc_count(self):
        from ray_tpu_torch.util.collective import collective as ccore

        return ccore._groups[self._g()]._test_cross_descs

    def op_capture_posted(self, op, value, kw):
        """Run one op with a spy on _post_send: snapshot every inline
        ndarray at post time, mutate the input right after the op
        returns, and report whether any posted buffer changed afterward."""
        import types

        from ray_tpu_torch.util.collective import collective as ccore

        g = ccore._groups[self._g()]
        posted = []
        orig = ccore.Group._post_send

        def spy(gself, rank, data, seq, tag=0):
            if isinstance(data, np.ndarray):
                posted.append((data, data.copy()))
            return orig(gself, rank, data, seq, tag)

        g._post_send = types.MethodType(spy, g)
        try:
            arr = np.asarray(value).copy()
            out = np.array(getattr(self.col, op)(
                arr, group_name=self._g(), **kw))
            arr.fill(-1e9)  # caller reuses its buffer right after return
            corrupted = sum(1 for obj, snap in posted
                            if not np.array_equal(obj, snap))
            return {"posted": len(posted), "corrupted": corrupted,
                    "out": out}
        finally:
            del g._post_send

    def allgather_then_churn(self, value, churn_value, rounds):
        got = self.col.allgather(np.asarray(value), group_name=self._g())
        for _ in range(rounds):
            self.col.allreduce(np.asarray(churn_value),
                               group_name=self._g())
        return got


@pytest.fixture(scope="module")
def ranks():
    ray_tpu_torch.init(num_cpus=4, num_gpus=0,
                       object_store_memory=256 * 1024 ** 2)
    try:
        actors = [Member.options(num_cpus=0.5).remote()
                  for _ in range(WORLD)]
        yield actors
    finally:
        ray_tpu_torch.shutdown()


def _group(actors, prefix):
    """A group of its own over ``actors`` (ranks in list order)."""
    name = f"{prefix}-{uuid.uuid4().hex[:6]}"
    ray_tpu_torch.get([a.join.remote(name, len(actors), r)
                       for r, a in enumerate(actors)], timeout=120)
    return actors


@pytest.fixture(scope="module")
def _shared_group(ranks):
    name = f"testgrp-{uuid.uuid4().hex[:6]}"
    ray_tpu_torch.get([a.join.remote(name, WORLD, r)
                       for r, a in enumerate(ranks)], timeout=120)
    return name


@pytest.fixture
def members(ranks, _shared_group):
    """The four ranks on the module's shared group (a test of its own group
    may have pointed them elsewhere)."""
    ray_tpu_torch.get([a.use.remote(_shared_group) for a in ranks])
    return ranks


class _Config:
    """Set a flag on some ranks and put the old values back on exit."""

    def __init__(self, actors, name, value):
        self.actors, self.name, self.value = actors, name, value

    def __enter__(self):
        self.old = ray_tpu_torch.get([a.set_config.remote(self.name,
                                                          self.value)
                                      for a in self.actors])

    def __exit__(self, *exc):
        ray_tpu_torch.get([a.set_config.remote(self.name, old)
                           for a, old in zip(self.actors, self.old)])


# ----------------------------------------------------------- basic ops
@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_allreduce_sum(members, kind):
    vals = [np.full((4,), float(i + 1)) for i in range(WORLD)]
    if kind == "tensor":
        vals = [torch.tensor(v, dtype=torch.float32) for v in vals]
    outs = ray_tpu_torch.get([a.allreduce.remote(vals[i])
                              for i, a in enumerate(members)])
    expect = np.full((4,), float(sum(range(1, WORLD + 1))))
    for o in outs:
        if kind == "tensor":
            assert isinstance(o, torch.Tensor) and o.dtype == torch.float32
            o = o.numpy()
        np.testing.assert_allclose(o, expect)


def test_allreduce_bf16_tensor_comes_back_bf16(members):
    vals = [torch.full((8,), 0.5 * (i + 1), dtype=torch.bfloat16)
            for i in range(WORLD)]
    outs = ray_tpu_torch.get([a.allreduce.remote(vals[i])
                              for i, a in enumerate(members)])
    for o in outs:
        assert o.dtype == torch.bfloat16
        assert torch.equal(o, torch.full((8,), 5.0, dtype=torch.bfloat16))


def test_allreduce_max(members):
    outs = ray_tpu_torch.get([a.allreduce.remote(np.array([float(i)]), "max")
                              for i, a in enumerate(members)])
    for o in outs:
        np.testing.assert_allclose(o, [float(WORLD - 1)])


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_allgather(members, kind):
    vals = [np.array([i * 10.0]) for i in range(WORLD)]
    if kind == "tensor":
        vals = [torch.from_numpy(v) for v in vals]
    outs = ray_tpu_torch.get([a.allgather.remote(vals[i])
                              for i, a in enumerate(members)])
    for o in outs:
        assert len(o) == WORLD
        np.testing.assert_allclose(np.concatenate([np.asarray(x) for x in o]),
                                   [0.0, 10.0, 20.0, 30.0])


def test_reducescatter(members):
    data = np.arange(WORLD, dtype=np.float64)
    outs = ray_tpu_torch.get([a.reducescatter.remote(data) for a in members])
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o, [r * WORLD])


def test_broadcast_nonzero_root(members):
    outs = ray_tpu_torch.get([
        a.broadcast.remote(torch.tensor([100.0 + i]), 2)
        for i, a in enumerate(members)])
    for o in outs:
        assert isinstance(o, torch.Tensor)
        np.testing.assert_allclose(o.numpy(), [102.0])


def test_barrier(members):
    assert all(ray_tpu_torch.get([a.barrier.remote() for a in members]))


def test_p2p_queue_same_tag(members):
    """Two sends with the same (src, tag) before any recv both arrive in
    order."""
    vals = [np.array([1.0]), np.array([2.0]), np.array([3.0])]
    send = members[1].send_many.remote(0, vals, 7)
    got, _ = ray_tpu_torch.get([members[0].recv_many.remote(1, 3, 7), send])
    np.testing.assert_allclose(np.concatenate(got), [1.0, 2.0, 3.0])


def test_reducescatter_2d_shape_parity(members):
    data = np.arange(float(WORLD * 2 * 3)).reshape(WORLD * 2, 3)
    outs = ray_tpu_torch.get([a.reducescatter.remote(data) for a in members])
    full = data * WORLD
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o, np.array_split(full, WORLD, axis=0)[r])
        assert o.shape == (2, 3)


# --------------------------------------------------- timeouts / stragglers
def test_barrier_timeout_names_absent_rank(ranks):
    from ray_tpu_torch.exceptions import CollectiveTimeout

    actors = _group(ranks[:3], "tmo-barrier")
    refs = [actors[0].barrier_timeout.remote(3.0),
            actors[1].barrier_timeout.remote(3.0)]
    for ref in refs:
        with pytest.raises(CollectiveTimeout, match="rank 2"):
            ray_tpu_torch.get(ref)
    prog = ray_tpu_torch.get(actors[0].group_progress.remote())
    assert prog[2]["seq"] < prog[0]["seq"]


def test_recv_timeout_raises_instead_of_blocking(ranks):
    from ray_tpu_torch.exceptions import CollectiveTimeout

    actors = _group(ranks[:2], "tmo-recv")
    with pytest.raises(CollectiveTimeout, match="rank 1"):
        ray_tpu_torch.get(actors[0].recv_timeout.remote(1, 2.0))


# ------------------------------------------- wire quantization (unit level)
def test_quantization_matches_the_jax_package_bitwise():
    """The port's block-scaled int8 record equals the JAX package's on the
    same seeded inputs, field by field, and dequantizes to the same bytes."""
    from ray_tpu.util.collective import quantization as jq

    from ray_tpu_torch.util.collective import quantization as tq

    rng = np.random.default_rng(3)
    for shape, block in [((1000,), 64), ((33, 7), 16), ((5,), 256),
                         ((4096,), 256), ((100,), 32)]:
        x = rng.uniform(-3.0, 3.0, size=shape).astype(np.float32)
        if shape == (100,):
            x[:40] = 0.0  # all-zero blocks
        want, werr = jq.quantize_blockwise(x, block=block)
        got, gerr = tq.quantize_blockwise(x, block=block)
        assert got.keys() == want.keys() and gerr == werr
        for key in want:
            assert np.array_equal(np.asarray(got[key]), np.asarray(want[key]))
        assert np.array_equal(tq.dequantize_blockwise(got),
                              jq.dequantize_blockwise(want))
        assert tq.wire_bytes(got) == jq.wire_bytes(want)
        assert tq.max_error_bound(got) == jq.max_error_bound(want)


def test_quantization_roundtrip_error_bound():
    from ray_tpu_torch.util.collective.quantization import (
        dequantize_blockwise, max_error_bound, quantize_blockwise,
        wire_bytes)

    rng = np.random.default_rng(7)
    for shape, block in [((1000,), 64), ((33, 7), 16), ((5,), 256),
                         ((4096,), 256)]:
        x = rng.uniform(-3.0, 3.0, size=shape).astype(np.float32)
        rec, err = quantize_blockwise(x, block=block)
        y = dequantize_blockwise(rec)
        assert y.shape == x.shape and y.dtype == np.float32
        measured = float(np.abs(y - x).max())
        assert measured <= max_error_bound(rec) + 1e-6
        assert abs(measured - err) <= 1e-6
        assert wire_bytes(rec) < x.nbytes / 2


def test_quantization_zero_blocks_safe():
    from ray_tpu_torch.util.collective.quantization import (
        dequantize_blockwise, quantize_blockwise)

    rec, err = quantize_blockwise(np.zeros(100, np.float32), block=32)
    assert err == 0.0
    assert np.all(dequantize_blockwise(rec) == 0.0)


def test_topology_selection():
    from ray_tpu_torch.util.collective import topology as topo

    two_nodes = {0: "a", 1: "a", 2: "b", 3: "b"}
    big, small = 1 << 20, 1024
    assert topo.select(4, two_nodes, big) == "hier"
    assert topo.select(4, two_nodes, small) == "ring"
    assert topo.select(4, {r: "a" for r in range(4)}, big) == "ring"
    assert topo.select(4, {0: "a", 1: "b", 2: "c", 3: "d"}, big) == "ring"
    assert topo.select(4, two_nodes, small, "hier") == "hier"
    p = topo.plan(2, 4, two_nodes, big)
    assert p.kind == "hier" and p.leaders == [0, 2]
    assert p.is_leader and p.members == [3]
    p1 = topo.plan(1, 4, two_nodes, big)
    assert not p1.is_leader and p1.leader == 0 and p1.members == []


# ----------------------------------------- quant / topology / quorum (e2e)
def test_allreduce_int8_error_bounded(members):
    rng = np.random.default_rng(11)
    data = [rng.uniform(-1.0, 1.0, 1024).astype(np.float32)
            for _ in range(WORLD)]
    exact = np.sum(data, axis=0)
    outs = ray_tpu_torch.get([a.allreduce_kw.remote(data[i],
                                                    {"quant": "int8"})
                              for i, a in enumerate(members)])
    bound = WORLD * (WORLD + 1) / (2 * 254) + 1e-3
    for o in outs:
        assert float(np.abs(o - exact).max()) <= bound
    stats = ray_tpu_torch.get([a.group_stats.remote() for a in members])
    for s in stats:
        assert 0.0 < s["last_quant_error"] <= bound


def test_broadcast_int8_single_stage(members):
    rng = np.random.default_rng(13)
    val = rng.uniform(-1.0, 1.0, 512).astype(np.float32)
    outs = ray_tpu_torch.get([a.broadcast_kw.remote(val, 1, {"quant": "int8"})
                              for a in members])
    for o in outs:
        assert float(np.abs(np.asarray(o, np.float32) - val).max()) \
            <= 1.0 / 254 + 1e-6
    recv_outs = [o for i, o in enumerate(outs) if i != 1]
    for o in recv_outs[1:]:
        np.testing.assert_array_equal(np.asarray(o), np.asarray(recv_outs[0]))


def test_allgather_int8_symmetric_across_ranks(members):
    rng = np.random.default_rng(37)
    data = [rng.uniform(-1.0, 1.0, 300).astype(np.float32)
            for _ in range(WORLD)]
    outs = ray_tpu_torch.get([a.allgather_kw.remote(data[i],
                                                    {"quant": "int8"})
                              for i, a in enumerate(members)])
    for o in outs:
        for r in range(WORLD):
            assert o[r].dtype == np.float32
            assert float(np.abs(o[r] - data[r]).max()) <= 1.0 / 254 + 1e-6
    for o in outs[1:]:
        for r in range(WORLD):
            np.testing.assert_array_equal(o[r], outs[0][r])


def test_allreduce_multichunk_exact(ranks):
    actors = _group(ranks[:2], "chunks")
    with _Config(actors, "collective_chunk_bytes", 1024):
        data = [np.arange(2000, dtype=np.float64) * (i + 1)
                for i in range(2)]
        outs = ray_tpu_torch.get([a.allreduce_kw.remote(data[i], {})
                                  for i, a in enumerate(actors)])
    for o in outs:
        np.testing.assert_array_equal(o, data[0] + data[1])


def test_hierarchical_matches_ring_bitwise(ranks):
    actors = _group(ranks, "hier")
    with _Config(actors, "collective_virtual_nodes", 2):
        rng = np.random.default_rng(17)
        data = [rng.integers(-8, 8, size=(64, 3)).astype(np.float32)
                for _ in range(WORLD)]
        ring = ray_tpu_torch.get([
            a.allreduce_kw.remote(data[i], {"topology": "ring"})
            for i, a in enumerate(actors)])
        hier = ray_tpu_torch.get([
            a.allreduce_kw.remote(data[i], {"topology": "hier"})
            for i, a in enumerate(actors)])
    expect = np.sum(data, axis=0)
    for r, h in zip(ring, hier):
        np.testing.assert_array_equal(r, expect)
        np.testing.assert_array_equal(h, expect)


def test_quorum_returns_early_then_folds_in(ranks):
    n = 3
    actors = _group(ranks[:n], "quorum")
    v = [np.full(8, float(10 ** i)) for i in range(n)]
    w = [np.full(8, 2.0 * (i + 1)) for i in range(n)]
    t0 = time.perf_counter()
    fast = [actors[0].quorum_allreduce.remote(v[0], 2),
            actors[1].quorum_allreduce.remote(v[1], 2)]
    late = actors[2].quorum_allreduce.remote(v[2], 2, delay=2.5)
    r0, r1 = ray_tpu_torch.get(fast)
    elapsed = time.perf_counter() - t0
    assert elapsed < 2.0, f"quorum waited for the straggler ({elapsed:.2f}s)"
    np.testing.assert_allclose(r0, v[0] + v[1])
    np.testing.assert_allclose(r1, v[0] + v[1])
    np.testing.assert_allclose(ray_tpu_torch.get(late), v[0] + v[1])
    assert ray_tpu_torch.get(actors[0].group_stats.remote())[
        "last_quorum_late"] == [2]
    outs = ray_tpu_torch.get([a.quorum_allreduce.remote(w[i], n)
                              for i, a in enumerate(actors)])
    round2 = w[0] + w[1] + w[2] + v[2]
    for o in outs:
        np.testing.assert_allclose(o, round2)
    np.testing.assert_allclose(r0 + outs[0], np.sum(v + w, axis=0))
    assert ray_tpu_torch.get(actors[0].group_stats.remote())[
        "last_quorum_late"] == []


def test_pipelined_ring_overlaps_delayed_acks(ranks):
    n = 3
    actors = _group(ranks[:n], "overlap")
    ray_tpu_torch.get(actors[1].set_ack_delay.remote(0.25))
    with _Config(actors, "collective_pipeline", False):
        serial = ray_tpu_torch.get([
            a.timed_allreduce.remote(np.full(8, float(i)), {})
            for i, a in enumerate(actors)])
    t_serial = max(t for t, _ in serial)
    piped = ray_tpu_torch.get([
        a.timed_allreduce.remote(np.full(8, float(i)), {})
        for i, a in enumerate(actors)])
    t_piped = max(t for t, _ in piped)
    ray_tpu_torch.get(actors[1].set_ack_delay.remote(0.0))
    expect = np.full(8, float(sum(range(n))))
    for _, o in serial + piped:
        np.testing.assert_allclose(o, expect)
    assert t_serial > 0.7, f"serial ring unexpectedly fast: {t_serial:.2f}s"
    assert t_piped < 0.4, f"pipelined ring stalled on ACKs: {t_piped:.2f}s"


def test_timeout_names_rank_under_new_paths(ranks):
    from ray_tpu_torch.exceptions import CollectiveTimeout

    actors = _group(ranks[:3], "tmo-hier")
    with _Config(actors[:2], "collective_virtual_nodes", 2):
        refs = [actors[0].allreduce_kw.remote(
                    np.ones(4), {"topology": "hier", "timeout_s": 3.0}),
                actors[1].allreduce_kw.remote(
                    np.ones(4), {"topology": "hier", "timeout_s": 3.0})]
        for ref in refs:
            with pytest.raises(CollectiveTimeout, match="rank 2"):
                ray_tpu_torch.get(ref)
    actors = _group(ranks[:2], "tmo-quorum")
    with pytest.raises(CollectiveTimeout, match="rank 1"):
        ray_tpu_torch.get(actors[0].quorum_allreduce.remote(
            np.ones(4), 2, timeout_s=2.0))


# ------------------------------------------ shared-memory chunk channel
def test_shm_arena_place_resolve_unit():
    import os

    from ray_tpu_torch.util.collective import shm_channel as shm_ch

    tx = shm_ch.TxArena(f"shmt-{os.getpid()}-{uuid.uuid4().hex[:6]}")
    rx = shm_ch.RxCache()
    try:
        a = np.arange(65536, dtype=np.float32)
        d1 = tx.place(a, seq=1, tag=5, min_bytes=1024)
        assert shm_ch.is_desc(d1) and shm_ch.desc_bytes(d1) == a.nbytes
        np.testing.assert_array_equal(rx.resolve(d1), a)
        assert tx.place(a, seq=1, tag=5, min_bytes=1024) is d1
        assert tx.place(np.ones(4, np.float32), seq=2, tag=5,
                        min_bytes=1024) is None
        b = a * 2.0
        d2 = tx.place(b, seq=3, tag=5, min_bytes=1024)
        assert d2["seg"] == d1["seg"]
        assert d2["bufs"][0][0] != d1["bufs"][0][0]
        c = a * 3.0
        d3 = tx.place(c, seq=4, tag=5, min_bytes=1024)
        assert d3["bufs"][0][0] == d1["bufs"][0][0]
        np.testing.assert_array_equal(rx.resolve(d3), c)
        big = np.ones(3 * 1024 * 1024, np.float32)
        d4 = tx.place(big, seq=5, tag=5, min_bytes=1024)
        assert d4["seg"] != d1["seg"]
        np.testing.assert_array_equal(rx.resolve(d4), big)
        shm_ch._attach(d1["seg"]).close()
        tx.place(a, seq=6, tag=5, min_bytes=1024)
        tx.place(a, seq=7, tag=5, min_bytes=1024)
        with pytest.raises(FileNotFoundError):
            shm_ch._attach(d1["seg"])
    finally:
        rx.close()
        tx.close()


def test_allreduce_large_shm_engages_and_matches_tcp(ranks):
    actors = _group(ranks[:2], "shm-ring")
    rng = np.random.default_rng(23)
    data = [rng.standard_normal(256 * 1024).astype(np.float32)
            for _ in range(2)]
    with_shm = ray_tpu_torch.get([a.allreduce_kw.remote(data[i], {})
                                  for i, a in enumerate(actors)])
    stats = ray_tpu_torch.get([a.shm_stats.remote() for a in actors])
    assert all(s["tx_active"] for s in stats), stats
    assert all(s["rx_attached"] >= 1 for s in stats), stats
    with _Config(actors, "collective_shm_min_bytes", 0):
        no_shm = ray_tpu_torch.get([a.allreduce_kw.remote(data[i], {})
                                    for i, a in enumerate(actors)])
    expect = data[0] + data[1]
    for w, t in zip(with_shm, no_shm):
        np.testing.assert_array_equal(w, expect)
        np.testing.assert_array_equal(t, expect)


def test_allgather_large_results_detached_from_arena(ranks):
    n = 3
    actors = _group(ranks[:n], "shm-ag")
    data = [np.full(64 * 1024, float(i + 1), np.float32) for i in range(n)]
    churn = np.ones(128 * 1024, np.float32)
    outs = ray_tpu_torch.get([
        a.allgather_then_churn.remote(data[i], churn, 3)
        for i, a in enumerate(actors)])
    for got in outs:
        assert len(got) == n
        for r in range(n):
            np.testing.assert_array_equal(got[r], data[r])


def test_hierarchical_large_shm_exact(ranks):
    actors = _group(ranks, "shm-hier")
    with _Config(actors, "collective_virtual_nodes", 2):
        rng = np.random.default_rng(29)
        data = [rng.integers(-8, 8, size=256 * 1024).astype(np.float32)
                for _ in range(WORLD)]
        outs = ray_tpu_torch.get([
            a.allreduce_kw.remote(data[i], {"topology": "hier"})
            for i, a in enumerate(actors)])
        stats = ray_tpu_torch.get([a.shm_stats.remote() for a in actors])
    expect = np.sum(data, axis=0)
    for o in outs:
        np.testing.assert_array_equal(o, expect)
    assert any(s["tx_active"] for s in stats), stats


def test_ring_relay_never_ships_desc_cross_node(ranks):
    actors = _group(ranks, "xnode")
    nodes = {0: "nodeA", 1: "nodeA", 2: "nodeB", 3: "nodeB"}
    ray_tpu_torch.get([a.patch_nodes.remote(nodes) for a in actors])
    rng = np.random.default_rng(31)
    data = [rng.integers(-8, 8, size=256 * 1024).astype(np.float32)
            for _ in range(WORLD)]
    outs = ray_tpu_torch.get([
        a.allreduce_kw.remote(data[i], {"topology": "ring"})
        for i, a in enumerate(actors)])
    expect = np.sum(data, axis=0)
    for o in outs:
        np.testing.assert_array_equal(o, expect)
    ag = ray_tpu_torch.get([a.allgather_kw.remote(data[i], {})
                            for i, a in enumerate(actors)])
    for got in ag:
        for r in range(WORLD):
            np.testing.assert_array_equal(got[r], data[r])
    counts = ray_tpu_torch.get([a.cross_desc_count.remote() for a in actors])
    assert all(c == 0 for c in counts), \
        f"descriptors crossed 'nodes': {counts}"
    stats = ray_tpu_torch.get([a.shm_stats.remote() for a in actors])
    assert any(s["tx_active"] for s in stats), stats


def test_pipelined_inflight_frames_own_their_bytes(ranks):
    actors = _group(ranks[:2], "detach")
    with _Config(actors, "collective_shm_min_bytes", 0):
        data = [np.full(64 * 1024, float(i + 1), np.float32)
                for i in range(2)]
        r0, _ = ray_tpu_torch.get([
            actors[0].op_capture_posted.remote("allreduce", data[0], {}),
            actors[1].allreduce_kw.remote(data[1], {})])
        np.testing.assert_array_equal(r0["out"], data[0] + data[1])
        assert r0["posted"] > 0
        assert r0["corrupted"] == 0
        r0, _ = ray_tpu_torch.get([
            actors[0].op_capture_posted.remote("broadcast", data[0], {}),
            actors[1].broadcast_kw.remote(data[1], 0, {})])
        assert r0["posted"] > 0
        assert r0["corrupted"] == 0
