"""The port's channels and compiled DAG (``ray_tpu_torch.experimental`` and
``ray_tpu_torch.dag``) on the CPU.

One port runtime for the module (``ray_tpu_torch.init(num_cpus=4)``) and
three stage actors reused by every compiled graph (a teardown frees them
for normal calls, and the next graph compiles over them).  The cases of
``tests/test_compiled_dag.py`` on the port's actors: the shm ring's round
trip, backpressure and close sentinel; a compiled chain reused for many
executes; errors riding the channels; the native futex channel
(``_native/channel.cpp``, the copy of the JAX package's source, built at
first use with g++ under ``ray_tpu_torch/_build/``) against the pure-Python
ring in both directions; multi-output graphs and an actor hosting two
nodes; ``execute_async``; the TCP channel's writer binding every interface.
A CPU tensor (bf16 included) crosses a ring as a tensor of its dtype.

Left out: ``test_compiled_beats_remote_chain_latency``, a wall-clock bar
(compiled at least 2x or 5x faster than a ``.remote()`` chain) that fails
on a loaded host, as it did on the JAX side under the tier-1 run's load,
and times the machine rather than the port; and the two cross-node cases,
which need ``cluster_utils.Cluster`` (not ported, ROADMAP.md A7).  The TCP
channel still carries a compiled-DAG frame here, between this driver and
an actor.

This file imports neither JAX nor the JAX package: the actors' workers
import it.
"""

import asyncio
import pathlib
import re

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.dag import InputNode, MultiOutputNode
from ray_tpu_torch.experimental.channel import ChannelClosed, ShmChannel

REPO = pathlib.Path(__file__).resolve().parent.parent


@ray_tpu_torch.remote
class _Stage:
    def __init__(self, k):
        self.k = k

    def add(self, x):
        return x + self.k

    def boom(self, x):
        raise ValueError("stage exploded")

    def tcp_write(self, name, value):
        """Open the writer end of a TCP channel and send ``value``."""
        from ray_tpu_torch.experimental.channel import TcpChannel

        ch = TcpChannel(name, role="w", depth=2)
        try:
            ch.write(value, timeout=30)
            ch.close_write()
        finally:
            ch.close()
        return True


@pytest.fixture(scope="module")
def stages():
    ray_tpu_torch.init(num_cpus=4, num_gpus=0,
                       object_store_memory=256 * 1024 ** 2)
    try:
        actors = [_Stage.options(num_cpus=0.1).remote(k)
                  for k in (1, 10, 100)]
        ray_tpu_torch.get([a.add.remote(0) for a in actors], timeout=120)
        yield actors
    finally:
        ray_tpu_torch.shutdown()


def test_native_channel_is_the_copied_source_built_in_the_build_dir():
    src = (REPO / "ray_tpu" / "_native" / "channel.cpp").read_text()
    assert (REPO / "ray_tpu_torch" / "_native" / "channel.cpp").read_text() \
        == re.sub(r"\bray_tpu\b", "ray_tpu_torch", src)
    from ray_tpu_torch._native import build, channel_lib

    lib = channel_lib()
    assert lib is not None
    path = build.channel_library_path()
    assert path.exists() and path.parent == REPO / "ray_tpu_torch" / "_build"
    assert lib._name == str(path)


def test_shm_channel_roundtrip():
    ch = ShmChannel(create=True, slot_size=1 << 16, depth=2)
    try:
        reader = ShmChannel(ch.name)
        ch.write({"a": np.arange(4)})
        out = reader.read(timeout=5)
        np.testing.assert_array_equal(out["a"], np.arange(4))
        ch.write(1)
        ch.write(2)
        assert reader.read(timeout=5) == 1
        ch.write(3)
        assert reader.read(timeout=5) == 2
        assert reader.read(timeout=5) == 3
        ch.close_write()
        with pytest.raises(ChannelClosed):
            reader.read(timeout=5)
        reader.close()
    finally:
        ch.close()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shm_channel_carries_tensors(dtype):
    ch = ShmChannel(create=True, slot_size=1 << 16, depth=2)
    try:
        reader = ShmChannel(ch.name)
        x = torch.randn(8, 16, generator=torch.Generator().manual_seed(0))
        ch.write(("0.a0", x.to(dtype)))
        tag, got = reader.read(timeout=5)
        assert tag == "0.a0" and got.dtype == dtype
        assert torch.equal(got, x.to(dtype))
        reader.close()
    finally:
        ch.close()


def test_compiled_chain_and_reuse(stages):
    a, b, c = stages
    with InputNode() as inp:
        dag = c.add.bind(b.add.bind(a.add.bind(inp)))
    compiled = dag.experimental_compile()
    try:
        for i in range(20):
            assert compiled.execute(i).get(timeout=30) == i + 111
        refs = [compiled.execute(i) for i in range(2)]
        assert [r.get(timeout=30) for r in refs] == [111, 112]
        t = torch.arange(4, dtype=torch.float32)
        assert torch.equal(compiled.execute(t).get(timeout=30), t + 111)
    finally:
        compiled.teardown()
    assert ray_tpu_torch.get(a.add.remote(5), timeout=60) == 6


def test_compiled_error_propagates(stages):
    a, b, _ = stages
    with InputNode() as inp:
        dag = b.add.bind(a.boom.bind(inp))
    compiled = dag.experimental_compile()
    try:
        with pytest.raises(ValueError, match="stage exploded"):
            compiled.execute(1).get(timeout=30)
        with pytest.raises(ValueError):
            compiled.execute(2).get(timeout=30)
    finally:
        compiled.teardown()


def test_native_channel_interop(monkeypatch):
    """The native futex channel and the pure-Python path speak the same
    ring: native writer -> python reader and vice versa, including the
    close sentinel."""
    from ray_tpu_torch._native import channel_lib
    from ray_tpu_torch.experimental import channel as chmod

    assert channel_lib() is not None
    monkeypatch.setenv("RAY_TPU_TORCH_NATIVE_CHANNEL", "1")
    native = chmod.ShmChannel(create=True, slot_size=1 << 16, depth=2)
    assert native._lib is not None
    monkeypatch.setenv("RAY_TPU_TORCH_NATIVE_CHANNEL", "0")
    pyside = chmod.ShmChannel(native.name)
    assert pyside._lib is None

    native.write({"a": np.arange(3)})
    out = pyside.read(timeout=10)
    np.testing.assert_array_equal(out["a"], np.arange(3))
    pyside.write(b"pong")
    assert native.read(timeout=10) == b"pong"
    native.write(1)
    native.write(2)
    assert pyside.read(timeout=10) == 1
    assert pyside.read(timeout=10) == 2
    native.close_write()
    with pytest.raises(ChannelClosed):
        pyside.read(timeout=10)
    pyside.close()
    native.close()


def test_tcp_channel_writer_binds_all_interfaces(stages):
    import pickle
    import socket

    from ray_tpu_torch._private.worker import require_core
    from ray_tpu_torch.experimental.channel import TcpChannel

    w = TcpChannel("nat-bind-test", role="w", advertise_host="203.0.113.7",
                   connect_timeout=10.0)
    try:
        blob = require_core().gcs_call_sync(
            "kv_get", {"ns": "_dagchan", "key": "nat-bind-test"})
        host, port = pickle.loads(blob)
        assert host == "203.0.113.7"
        s = socket.create_connection(("127.0.0.1", port), timeout=5)
        try:
            w._ensure_conn(5.0)
            w.write_bytes(b"through-the-nat")
            hdr = s.recv(8)
            n = int.from_bytes(hdr, "little")
            assert s.recv(n) == b"through-the-nat"
        finally:
            s.close()
    finally:
        w.close()


def test_tcp_channel_from_an_actor(stages):
    """A TCP edge's frame (an actor writes, this driver reads), as a
    compiled DAG's cross-node edge carries it: rendezvous by name through
    the GCS KV, a bf16 tensor out of band, then the close sentinel."""
    from ray_tpu_torch.experimental.channel import TcpChannel

    x = torch.randn(4, 8, generator=torch.Generator().manual_seed(1))
    done = stages[0].tcp_write.remote("dag-tcp-test", x.to(torch.bfloat16))
    reader = TcpChannel("dag-tcp-test", role="r", depth=2,
                        connect_timeout=30.0)
    try:
        got = reader.read(timeout=30)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, x.to(torch.bfloat16))
        with pytest.raises(ChannelClosed):
            reader.read(timeout=30)
    finally:
        reader.close()
    assert ray_tpu_torch.get(done, timeout=60)


def test_compiled_multi_output_and_shared_actor(stages):
    a, b, _ = stages
    with InputNode() as inp:
        first = a.add.bind(inp)
        left = b.add.bind(first)
        right = a.add.bind(left)
        dag = MultiOutputNode([left, right])
    compiled = dag.experimental_compile()
    try:
        for i in range(6):
            out = compiled.execute(i).get(timeout=60)
            assert out == [i + 11, i + 12], out
    finally:
        compiled.teardown()
    assert ray_tpu_torch.get(a.add.remote(1), timeout=60) == 2


def test_compiled_multi_output_error_propagates(stages):
    a, b, _ = stages
    with InputNode() as inp:
        ok = a.add.bind(inp)
        bad = b.boom.bind(inp)
        dag = MultiOutputNode([ok, bad])
    compiled = dag.experimental_compile()
    try:
        with pytest.raises(ValueError, match="stage exploded"):
            compiled.execute(1).get(timeout=60)
    finally:
        compiled.teardown()


def test_compiled_execute_async(stages):
    a, b, _ = stages
    with InputNode() as inp:
        dag = b.add.bind(a.add.bind(inp))
    compiled = dag.experimental_compile()
    try:
        async def serve_loop():
            refs = [await compiled.execute_async(i) for i in range(6)]
            return await asyncio.gather(*refs)

        out = asyncio.run(serve_loop())
        assert out == [i + 11 for i in range(6)]
    finally:
        compiled.teardown()
