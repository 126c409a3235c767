"""ray_tpu_torch's ring attention against ray_tpu's on the CPU.

The op: one gang of four gloo ranks, spawned once for the module, runs the
port's ``ring_attention`` on local shards (sp = 4 and sp = 2, causal and
not) and ``ring_attention_sharded`` on DTensors over a (tp, sp) mesh; JAX's
``ring_attention_sharded`` runs on its virtual CPU devices under the same
mesh, on the same numpy inputs (``tests/test_ops.py::TestRingAttention``'s
shapes).  The output and the gradients of sum(o²) agree within 1e-5.  Then,
in this process, the ring's schedule unrolled over every position (the
steps ``ring_attention`` runs on each rank, as ``chip_smoke.py`` runs them
on one card) against ``mha_reference`` and its autograd.
"""

import multiprocessing
import queue

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from ray_tpu.ops.attention import ring_attention_sharded as j_ring
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.ops import (
    mha_reference,
    ring_attention_bwd_unrolled,
    ring_attention_fwd_unrolled,
    ring_attention_sharded,
)

B, H, S, D = 1, 2, 256, 16
WORLD = 4
GANG_TIMEOUT_S = 120
# case: (sp, causal); each runs ring_attention on local shards, the sp = 2
# case in two rings of two ranks at once
LOCAL_CASES = {"sp4": (4, True), "sp2": (2, True),
               "sp4-noncausal": (4, False)}
# ring_attention_sharded on DTensors over a (tp, sp) = (2, 2) mesh: heads
# over tp, the sequence over sp
SHARDED_CASE = "tp2-sp2-sharded"


def _inputs():
    rng = np.random.default_rng(3)
    return [rng.standard_normal((B, H, S, D)).astype(np.float32)
            for _ in range(3)]


def _jax_ring(mesh_shape, names, causal, head_axis):
    """JAX's ring_attention_sharded on the virtual CPU devices: o and the
    gradients of sum(o²), as numpy."""
    devs = np.asarray(jax.devices()[:int(np.prod(mesh_shape))])
    mesh = Mesh(devs.reshape(mesh_shape), names)

    def f(q, k, v):
        return j_ring(q, k, v, mesh=mesh, causal=causal, batch_axes=(),
                      head_axis=head_axis)

    q, k, v = (jnp.asarray(x) for x in _inputs())
    o = jax.jit(f)(q, k, v)
    grads = jax.jit(jax.grad(lambda *a: jnp.sum(f(*a) ** 2),
                             argnums=(0, 1, 2)))(q, k, v)
    return [np.asarray(o)] + [np.asarray(g) for g in grads]


# --------------------------------------------------------------- gang
def _counting(fn, counts, key):
    def wrapped(*args, **kw):
        counts[key] += 1
        return fn(*args, **kw)
    return wrapped


def _local_case(sp, causal, group, pos):
    """``ring_attention`` at ring position ``pos`` of ``group``: this
    rank's o and gradient chunks, the chunk attentions and backward steps
    it ran, and the shapes the backward saved."""
    counts = {"fwd": 0, "bwd": 0}
    fwd, bwd = tattn._chunk_attention, tattn.flash_attention_bwd
    tattn._chunk_attention = _counting(fwd, counts, "fwd")
    tattn.flash_attention_bwd = _counting(bwd, counts, "bwd")
    try:
        c = S // sp
        q, k, v = (torch.from_numpy(x[:, :, pos * c:(pos + 1) * c].copy())
                   .requires_grad_() for x in _inputs())
        o = tattn.ring_attention(q, k, v, group=group, causal=causal)
        saved = [tuple(t.shape) for t in o.grad_fn.saved_tensors]
        (o ** 2).sum().backward()
    finally:
        tattn._chunk_attention, tattn.flash_attention_bwd = fwd, bwd
    return {"pos": pos, "out": [t.detach().numpy()
                                for t in (o, q.grad, k.grad, v.grad)],
            "counts": counts, "saved": saved}


def _sharded_case():
    """``ring_attention_sharded`` on replicated DTensors of the whole
    inputs over a (tp, sp) mesh: the output and gradients put together;
    and what ``flash_attention`` says to the same DTensors."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    mesh = DeviceMesh("cpu", torch.arange(WORLD).reshape(2, 2),
                      mesh_dim_names=("tp", "sp"))
    q, k, v = (distribute_tensor(torch.from_numpy(x), mesh,
                                 [Replicate(), Replicate()]).requires_grad_()
               for x in _inputs())
    o = ring_attention_sharded(q, k, v, causal=True)
    placements = [str(p) for p in o.placements]
    (o ** 2).sum().backward()
    try:
        tattn.flash_attention(q, k, v)
        refused = None
    except NotImplementedError as err:
        refused = str(err)
    return {"out": [t.full_tensor().detach().numpy()
                    for t in (o, q.grad, k.grad, v.grad)],
            "placements": placements, "refused": refused}


def _gang_rank(rank, init_file, results):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=WORLD)
    try:
        # every rank creates every group, in the same order
        rings = {2: [dist.new_group([0, 1]), dist.new_group([2, 3])],
                 4: [dist.group.WORLD]}
        out = {}
        for case, (sp, causal) in LOCAL_CASES.items():
            out[case] = _local_case(sp, causal, rings[sp][rank // sp],
                                    rank % sp)
        out[SHARDED_CASE] = _sharded_case()
        results.put((rank, out))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """Four gloo ranks, spawned once, run every case; killed, and every
    case failed, after GANG_TIMEOUT_S."""
    import time

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init_file = tmp_path_factory.mktemp("ring") / "rendezvous"
    procs = [ctx.Process(target=_gang_rank,
                         args=(r, str(init_file), results), daemon=True)
             for r in range(WORLD)]
    for p in procs:
        p.start()
    got, deadline = {}, time.monotonic() + GANG_TIMEOUT_S
    try:
        while len(got) < WORLD and time.monotonic() < deadline:
            try:
                rank, out = results.get(timeout=2)
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                continue
            got[rank] = out
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if len(got) < WORLD or any(p.exitcode != 0 for p in procs):
        pytest.fail(f"the gloo gang gave results from ranks {sorted(got)}, "
                    f"exit codes {[p.exitcode for p in procs]}")
    return got


@pytest.mark.parametrize("case", list(LOCAL_CASES))
def test_ring_attention_matches_jax(case, gang):
    sp, causal = LOCAL_CASES[case]
    want = _jax_ring((sp,), ("sp",), causal, "_none")
    c = S // sp
    # every ring of the gang (two of two ranks at sp = 2) gives the whole
    for ring in range(WORLD // sp):
        recs = [gang[r][case] for r in range(ring * sp, (ring + 1) * sp)]
        assert [rec["pos"] for rec in recs] == list(range(sp))
        for i, name in enumerate(("o", "dq", "dk", "dv")):
            got = np.concatenate([rec["out"][i] for rec in recs], axis=2)
            np.testing.assert_allclose(got, want[i], atol=1e-5, rtol=1e-5,
                                       err_msg=name)
        for rec in recs:
            # a step that causality hides entirely launches nothing
            steps = rec["pos"] + 1 if causal else sp
            assert rec["counts"] == {"fwd": steps, "bwd": steps}
            # the backward keeps this rank's chunk only: q, k, v, o, lse
            assert rec["saved"] == [(B, H, c, D)] * 4 + [(B, H, c)]


def test_ring_attention_sharded_matches_jax(gang):
    want = _jax_ring((2, 2), ("tp", "sp"), True, "tp")
    for rank in range(WORLD):
        rec = gang[rank][SHARDED_CASE]
        for i, name in enumerate(("o", "dq", "dk", "dv")):
            np.testing.assert_allclose(rec["out"][i], want[i], atol=1e-5,
                                       rtol=1e-5, err_msg=name)
        # heads over tp, the sequence over sp
        assert rec["placements"] == ["S(1)", "S(2)"]
        # flash attention over a sequence split names the ring
        assert rec["refused"] and "attention_impl=\"ring\"" in rec["refused"]


# ------------------------------------------------- the unrolled schedule
@pytest.mark.parametrize("sp", [1, 2, 4, 8])
@pytest.mark.parametrize("causal", [True, False])
def test_unrolled_ring_matches_reference(sp, causal):
    """Every position's steps, in the ring's order, against mha_reference
    and its autograd: o, lse against the flash forward of the whole
    sequence, and the gradients of a seeded output gradient."""
    rng = np.random.default_rng(4)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((2, 3, 128, 16))
                                   .astype(np.float32)) for _ in range(4))
    o, lse = ring_attention_fwd_unrolled(q, k, v, sp=sp, causal=causal)
    lq, lk, lv = (t.clone().requires_grad_() for t in (q, k, v))
    ref = mha_reference(lq, lk, lv, causal=causal)
    np.testing.assert_allclose(o, ref.detach(), atol=1e-5, rtol=1e-5)
    _, lse_ref = tattn.flash_attention_fwd(q, k, v, causal=causal)
    np.testing.assert_allclose(lse, lse_ref, atol=1e-5, rtol=1e-5)
    grads = ring_attention_bwd_unrolled(q, k, v, o, lse, g, sp=sp,
                                        causal=causal)
    for got, want in zip(grads, torch.autograd.grad(ref, (lq, lk, lv), g)):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_online_merge_keeps_dead_rows_dead():
    """A row dead in both partials stays o = 0, lse = -1e30 (the flash
    kernel's convention); a dead partial leaves the live one as it is."""
    rng = np.random.default_rng(5)
    live_o = torch.from_numpy(rng.standard_normal((1, 2, 4, 8))
                              .astype(np.float32))
    live_lse = torch.from_numpy(rng.standard_normal((1, 2, 4))
                                .astype(np.float32))
    dead_o = torch.zeros(1, 2, 4, 8)
    dead_lse = torch.full((1, 2, 4), tattn.NEG_INF)
    o, lse = tattn._online_merge(dead_o, dead_lse, dead_o, dead_lse)
    assert bool((o == 0).all()) and bool((lse == tattn.NEG_INF).all())
    for pair in ((dead_o, dead_lse, live_o, live_lse),
                 (live_o, live_lse, dead_o, dead_lse)):
        o, lse = tattn._online_merge(*pair)
        assert torch.equal(o, live_o) and torch.equal(lse, live_lse)


def test_ring_attention_sharded_needs_dtensors():
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="DTensors"):
        ring_attention_sharded(q, q, q)
