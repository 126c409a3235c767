"""The port's lint (``ray_tpu_torch._lint`` and its eight checkers) on the
CPU, against the JAX package's.

Every fixture of ``tests/test_lint.py`` runs through both packages: the
JAX package's checker on the fixture, the port's on the same fixture under
the rename rule (``ray_tpu`` -> ``ray_tpu_torch``, ``RAY_TPU_`` ->
``RAY_TPU_TORCH_``, which moves no line).  The port's findings must be what
the JAX test asserts, and the same (rule family, line) pairs as the JAX
checker's.  The JAX package's ``jax-tracer-hygiene`` is the port's
``graph-capture-hygiene`` (the functions a ``CudaGraphStep`` captures),
with fixtures of its own.  Then the framework (suppressions, baseline,
fingerprints, CLI), the wire contract, the metrics rules of
``tests/test_metrics_hygiene.py`` on the port's tree and registry, and the
tree gate: all eight checkers over ``ray_tpu_torch/`` with zero findings
against the empty baseline, twice byte for byte, and ``python -m
ray_tpu_torch lint`` exiting 0.
"""

import dataclasses
import importlib
import json
import os
import pathlib
import re
import subprocess
import sys
from typing import List, Tuple

import pytest

from ray_tpu_torch import _lint
from ray_tpu_torch._lint import (
    FileCtx,
    fingerprints,
    lint_source,
    load_baseline,
    render_json,
    run_lint,
    save_baseline,
)

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_DIR = str(REPO / "ray_tpu_torch")
PKGS = ("ray_tpu", "ray_tpu_torch")
CHECKERS = ["async-blocking", "collective-timeout", "config-drift",
            "graph-capture-hygiene", "lock-discipline", "metrics-hygiene",
            "no-flatten", "wire-contract"]


def rules_of(findings):
    return [f.rule for f in findings]


def _ren(text: str, pkg: str) -> str:
    """A fixture as package ``pkg`` sees it: the JAX package's as written,
    the port's under the rename rule."""
    if pkg == "ray_tpu":
        return text
    text = re.sub(r"\bray_tpu\b", "ray_tpu_torch", text)
    return re.sub(r"\bRAY_TPU_", "RAY_TPU_TORCH_", text)


@pytest.fixture(scope="module")
def port_files():
    """The port's tree, parsed once for the module."""
    return _lint.collect_files([PORT_DIR])


@pytest.fixture(scope="module")
def tree_runs(port_files):
    """Two runs of every checker over the port's tree against the default
    (empty) baseline: one from the disk, one over the parsed files."""
    return run_lint(paths=[PORT_DIR]), run_lint(files=port_files)


# ============================================ fixtures through both packages

@dataclasses.dataclass
class Case:
    id: str
    checker: str
    files: List[Tuple[str, str]]  # (relpath, source), as the JAX test has them
    want: List[str]               # the port's rules, as the JAX test asserts
    messages: Tuple[Tuple[int, str], ...] = ()  # (finding, substring)
    sort: bool = False            # the JAX test compares sorted rules


_CONFIG = ("ray_tpu/_private/config.py", '''
RayConfig = object()
def _d(name, typ, default, doc=""):
    pass
_d("wired_flag", int, 1, "used below")
_d("dead_flag", int, 2, "nothing reads this")
''')

_WIRE_SERVER = '''
class GcsServer:
    async def rpc_ping(self, conn, msg):
        node = msg["node_id"]
        verbose = msg.get("verbose")
        return {"ok": True}
'''

CASES = [
    Case("async_blocking_positives", "async-blocking", [("snippet.py", '''
import time, subprocess
async def handler(self):
    time.sleep(1)
    x = fut.result()
    self._lock.acquire()
    subprocess.run(["ls"])
    y = conn.call_sync("m")
''')], ["async-blocking"] * 5),
    Case("async_blocking_negatives", "async-blocking", [("snippet.py", '''
import asyncio, time
def sync_fn():
    time.sleep(1)          # sync context: blocking is legal
async def handler(self):
    await asyncio.sleep(1)
    await self._sem.acquire()            # awaited = async acquire
    self._lock.acquire(timeout=5)        # bounded
    self._lock.acquire(False)            # non-blocking probe
    out = await loop.run_in_executor(None, lambda: time.sleep(1))
    def helper():
        return fut.result()  # nested def runs on an executor thread
''')], []),
    Case("async_blocking_runtime_get", "async-blocking", [("snippet.py", '''
import ray_tpu
async def handler(self, ref):
    return ray_tpu.get(ref)
''')], ["async-blocking"]),
    Case("lock_unguarded_write", "lock-discipline", [("snippet.py", '''
import threading
class C:
    def __init__(self):
        self._lock = threading.Lock()
        self.n = 0          # constructor writes are exempt
    def inc(self):
        with self._lock:
            self.n += 1
    def reset(self):
        self.n = 0          # BAD: bare write to a lock-guarded attr
    def untracked(self):
        self.other = 1      # never guarded anywhere: not flagged
''')], ["lock-discipline.unguarded-write"], ((0, "C.n"),)),
    Case("lock_order_inversion", "lock-discipline", [("snippet.py", '''
import threading
class D:
    def __init__(self):
        self.a = threading.Lock()
        self.b = threading.Lock()
    def one(self):
        with self.a:
            with self.b:
                pass
    def two(self):
        with self.b:
            with self.a:
                pass
''')], ["lock-discipline.order"]),
    Case("lock_order_consistent", "lock-discipline", [("snippet.py", '''
import threading
class D:
    def __init__(self):
        self.a = threading.Lock()
        self.b = threading.Lock()
    def one(self):
        with self.a:
            with self.b:
                pass
    def two(self):
        with self.a:
            with self.b:
                pass
''')], []),
    Case("blocking_call_under_lock", "lock-discipline", [("snippet.py", '''
import threading, time
class C:
    def __init__(self):
        self._lock = threading.Lock()
    def slow(self):
        with self._lock:
            time.sleep(0.1)
            x = conn.call_sync("m")
    def ok(self):
        with self._lock:
            d = {}.get("key")        # dict .get is not ray_tpu.get
        time.sleep(0.1)              # lock released: fine
''')], ["lock-discipline.blocking-call"] * 2),
    Case("condition_wait_under_lock", "lock-discipline", [("snippet.py", '''
import threading
class C:
    def __init__(self):
        self._cv = threading.Condition()
    def waiter(self):
        with self._cv:
            self._cv.wait(1.0)   # releases the lock while waiting
''')], []),
    Case("config_drift_unregistered_env_and_dead_flag", "config-drift",
         [_CONFIG, ("ray_tpu/user.py", '''
import os
a = os.environ.get("RAY_TPU_NOT_A_FLAG")
b = RayConfig.wired_flag
''')], ["config-drift.dead-flag", "config-drift.unregistered-env"],
         ((0, "dead_flag"), (1, "RAY_TPU_TORCH_NOT_A_FLAG")), sort=True),
    Case("config_drift_flag_env_and_allowlist", "config-drift",
         [_CONFIG, ("ray_tpu/user.py", '''
import os
a = os.environ.get("RAY_TPU_WIRED_FLAG")     # maps to wired_flag
b = os.environ.get("RAY_TPU_ADDRESS")        # allowlisted bootstrap key
c = RayConfig.dead_flag                      # now referenced
''')], []),
    Case("collective_timeout_def", "collective-timeout",
         [("ray_tpu/util/collective/collective.py", '''
def recv(src_rank, tag=0):
    pass
def barrier(group_name="default", timeout_s=None):
    pass
''')], ["collective-timeout.def"], ((0, "`recv`"),)),
    Case("collective_timeout_call_sites", "collective-timeout",
         [("ray_tpu/train/_session.py", '''
from ray_tpu.util import collective
from ray_tpu.util.collective import recv
collective.barrier("g")                      # BAD: no defaulted def seen
recv(0, timeout_s=5.0)                       # explicit timeout: fine
x = {}.get("recv")                           # unrelated name: fine
sock.recv(1024)                              # not a collective alias: fine
''')], ["collective-timeout.call"], ((0, "`barrier`"),)),
    Case("collective_timeout_def_compound", "collective-timeout",
         [("ray_tpu/util/collective/collective.py", '''
def quorum_allreduce(value, quorum):          # BAD: unbounded entry point
    pass
def hier_broadcast(value, root=0):            # BAD: unbounded entry point
    pass
def allreduce_int8(value, timeout_s=None):    # bounded: fine
    pass
def _rs_flat(flats, op, seq, deadline):       # private helper: exempt
    pass
def quantize_blockwise(arr, block=0):         # no op token: fine
    pass
''')], ["collective-timeout.def"] * 2,
         ((0, "`quorum_allreduce`"), (1, "`hier_broadcast`"))),
    Case("collective_timeout_call_compound_alias", "collective-timeout",
         [("ray_tpu/train/_session.py", '''
from ray_tpu.util.collective import quorum_allreduce
quorum_allreduce(x, 2)                  # BAD: no bounded def seen
quorum_allreduce(x, 2, timeout_s=5.0)   # explicit timeout: fine
''')], ["collective-timeout.call"]),
    Case("collective_timeout_call_inherits_default", "collective-timeout",
         [("ray_tpu/util/collective/collective.py", '''
def barrier(group_name="default", timeout_s=None):
    pass
'''), ("ray_tpu/train/_session.py", '''
from ray_tpu.util import collective
collective.barrier("g")    # inherits the def's bounded default
''')], []),
    Case("collective_timeout_wait_is_an_op_token", "collective-timeout",
         [("ray_tpu/util/collective/collective.py", '''
def wait_all(handles):                        # BAD: unbounded barrier
    pass
def wait_all_bounded(handles, timeout_s=None):  # bounded: fine
    pass
''')], ["collective-timeout.def"], ((0, "`wait_all`"),)),
    Case("collective_timeout_pipeline_wait_defs", "collective-timeout",
         [("ray_tpu/train/pipeline/dp_sync.py", '''
def wait_all(self, timeout_s=None):           # bounded barrier: fine
    pass
def bucket_wait(handle):                      # BAD: unbounded stage wait
    pass
def _drain_wait(handle):                      # private: exempt
    pass
h.wait()                                      # call level: def-side-only
''')], ["collective-timeout.def"], ((0, "`bucket_wait`"),)),
    Case("collective_timeout_pipeline_defs", "collective-timeout",
         [("ray_tpu/train/pipeline/channels.py", '''
def recv(tag):                                 # BAD: unbounded stage wait
    pass
def wait_endpoint(job, stage):                 # BAD: unbounded rendezvous
    pass
def send(tag, payload, timeout_s=None):        # bounded default: fine
    pass
def connect_links(job, stage, timeout_s=60.0): # bounded default: fine
    pass
def _wait_kv(key, deadline):                   # private helper: exempt
    pass
def stage_ranges(n, s):                        # not a wait: fine
    pass
''')], ["collective-timeout.def"] * 2,
         ((0, "`recv`"), (0, "PipelineStageDied"), (1, "`wait_endpoint`"))),
    Case("collective_timeout_pipeline_calls_and_raw_channel_waits",
         "collective-timeout", [("ray_tpu/train/pipeline/schedule.py", '''
def recv(tag, timeout_s=None):                 # bounded def in scope
    pass
link.recv("0.a0")                              # fine: def above is bounded
link.send("0.g0", payload, timeout_s=5.0)      # explicit: fine
ch.read()                                      # BAD: unbounded ring wait
self._ch.write(frame)                          # BAD: unbounded ring wait
chan.read(timeout=0.25)                        # bounded primitive: fine
f.write(data)                                  # file handle: not a channel
''')], ["collective-timeout.call"] * 2, ((0, ".read"), (1, ".write"))),
    Case("collective_timeout_pipeline_unresolved_recv", "collective-timeout",
         [("ray_tpu/train/pipeline/loop.py", '''
links["act_in"].recv("0.a0")
''')], ["collective-timeout.call"], ((0, "`recv`"),)),
    Case("metrics_hygiene_positives", "metrics-hygiene",
         [("pkg/metrics_defs.py", '''
c = Counter("bad name", "help")
g = Gauge("ray_tpu_prefixed", "help")
h = Histogram("no_help", "")
k1 = Counter("kind_clash", "a")
k2 = Gauge("kind_clash", "b")
''')], ["metrics-hygiene.help", "metrics-hygiene.kind",
        "metrics-hygiene.name", "metrics-hygiene.prefix"], sort=True),
    Case("metrics_hygiene_negative", "metrics-hygiene",
         [("pkg/metrics_defs.py", '''
c = Counter("requests_total", "requests served")
g = Gauge("queue_depth", "queued requests")
''')], []),
    Case("inline_suppression", "async-blocking", [("snippet.py", '''
import time
async def handler():
    time.sleep(1)  # lint: disable=async-blocking
    time.sleep(2)
''')], ["async-blocking"]),
    Case("file_level_suppression", "async-blocking", [("snippet.py", '''
# lint: disable-file=async-blocking
import time
async def handler():
    time.sleep(1)
''')], []),
    Case("suppression_of_sub_rule_family", "lock-discipline",
         [("snippet.py", '''
import threading
class C:
    def __init__(self):
        self._lock = threading.Lock()
    def a(self):
        with self._lock:
            self.x = 1
    def b(self):
        self.x = 2  # lint: disable=lock-discipline
''')], []),
    Case("no_flatten_positives", "no-flatten",
         [("ray_tpu/_private/snippet.py", '''
import pickle

def ship(arr, ser):
    a = pickle.dumps(arr)                       # flatten: no buffer_callback
    b = arr.tobytes()                           # full-buffer copy
    c = ser.to_bytes()                          # frame flatten
    return a, b, c
''')], ["no-flatten.dumps", "no-flatten.tobytes", "no-flatten.to_bytes"]),
    Case("no_flatten_negatives", "no-flatten",
         [("ray_tpu/_private/snippet.py", '''
import pickle

def ship(arr, ser, dest, n):
    bufs = []
    a = pickle.dumps(arr, protocol=5, buffer_callback=bufs.append)
    ser.write_into(dest)                        # scatter-gather: the point
    hdr = n.to_bytes(8, "little")               # int wire framing: fine
    hdr2 = n.to_bytes(length=8, byteorder="little")
    return a, hdr, hdr2
''')], []),
    Case("no_flatten_suppression", "no-flatten",
         [("ray_tpu/_private/x.py", '''
import pickle
rec = pickle.dumps({"k": "v"})  # lint: disable=no-flatten (KV record)
''')], []),
    Case("wire_contract_unknown_method", "wire-contract",
         [("snippet.py", _WIRE_SERVER + '''
async def client(conn):
    await conn.call_sync("pingg", {"node_id": b"x"})
''')], ["wire-contract.unknown-method"], ((0, "pingg"),)),
    Case("wire_contract_unknown_method_notify", "wire-contract",
         [("snippet.py", _WIRE_SERVER + '''
async def client(conn):
    await conn.notify("pnig", {"node_id": b"x"})
''')], ["wire-contract.unknown-method"], ((0, "silently"),)),
    Case("wire_contract_batch_and_known_methods", "wire-contract",
         [("snippet.py", _WIRE_SERVER + '''
async def client(conn):
    await conn.call("ping", {"node_id": b"x", "verbose": True})
    await conn.call("__batch__", {"items": []})
''')], []),
    Case("wire_contract_caller_sends_unread_key", "wire-contract",
         [("snippet.py", _WIRE_SERVER + '''
async def client(conn):
    await conn.call("ping", {"node_id": b"x", "stale_field": 1})
''')], ["wire-contract.key-mismatch"], ((0, "stale_field"),)),
    Case("wire_contract_handler_requires_unsent_key", "wire-contract",
         [("snippet.py", '''
class Srv:
    async def rpc_ping(self, conn, msg):
        return {"a": msg["node_id"], "b": msg["epoch"]}

async def client(conn):
    await conn.call("ping", {"node_id": b"x"})
''')], ["wire-contract.key-mismatch"], ((0, "epoch"),)),
    Case("wire_contract_dynamic_payload", "wire-contract", [("snippet.py", '''
class Srv:
    async def rpc_sweep(self, conn, msg):
        for item in msg:
            handle(item)

async def client(conn, payload):
    await conn.notify("sweep", payload)
''')], []),
    Case("wire_contract_conditional_read", "wire-contract", [("snippet.py", '''
class Srv:
    async def rpc_release(self, conn, msg):
        oids = msg.get("oids")
        if oids is None:
            oids = [msg["oid"]]
        return len(oids)

async def a(conn):
    await conn.call("release", {"oids": [b"x"]})
async def b(conn):
    await conn.call("release", {"oid": b"x"})
''')], []),
    Case("wire_contract_suppression", "wire-contract",
         [("snippet.py", _WIRE_SERVER + '''
async def client(conn):
    await conn.notify("pingg", {"node_id": b"x"})  # lint: disable=wire-contract.unknown-method (probing a future server)
''')], []),
]


def _family(rule: str) -> str:
    return rule.split(".", 1)[0]


def _run_case(case: Case, pkg: str):
    lint = importlib.import_module(f"{pkg}._lint")
    files = [lint.FileCtx(_ren(rel, pkg), _ren(src, pkg))
             for rel, src in case.files]
    return lint.run_lint(files=files, checkers=[case.checker],
                         baseline=None).findings


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_fixture_findings_match_the_jax_checker(case):
    port = _run_case(case, "ray_tpu_torch")
    jax_side = _run_case(case, "ray_tpu")
    got = rules_of(port)
    assert (sorted(got) if case.sort else got) == case.want
    by_rule = sorted(port, key=lambda f: f.rule) if case.sort else port
    for i, sub in case.messages:
        assert sub in by_rule[i].message, (sub, by_rule[i].message)
    assert [(_family(f.rule), f.line) for f in port] == \
        [(_family(f.rule), f.line) for f in jax_side]


def test_inline_suppression_keeps_the_other_line():
    case = next(c for c in CASES if c.id == "inline_suppression")
    assert [f.line for f in _run_case(case, "ray_tpu_torch")] == [5]


@pytest.mark.parametrize("scoped,flagged", [
    ("ray_tpu/_private/x.py", True), ("ray_tpu/dag/x.py", True),
    ("ray_tpu/experimental/x.py", True), ("ray_tpu/util/collective/x.py", True),
    ("ray_tpu/serve/x.py", False), ("ray_tpu/train/x.py", False),
    ("tests/x.py", False)])
def test_no_flatten_scoped_to_data_plane_dirs(scoped, flagged):
    src = '''
import pickle
payload = pickle.dumps({"x": 1})
'''
    case = Case("scope", "no-flatten", [(scoped, src)],
                ["no-flatten.dumps"] if flagged else [])
    assert rules_of(_run_case(case, "ray_tpu_torch")) == case.want
    assert rules_of(_run_case(case, "ray_tpu")) == case.want


@pytest.mark.parametrize("pkg", PKGS)
def test_known_synchronized_list_silences_static_checker(pkg):
    """One entry of the shared sync_suppressions list covers the static
    checker (and the race detector) in either package."""
    sync = importlib.import_module(f"{pkg}._private.sync_suppressions")
    lint = importlib.import_module(f"{pkg}._lint")
    src = '''
import threading
class CrossLinked:
    def __init__(self):
        self._lock = threading.Lock()
    def a(self):
        with self._lock:
            self.state = 1
    def b(self):
        self.state = 2
'''
    assert rules_of(lint.lint_source(src, ["lock-discipline"])) \
        == ["lock-discipline.unguarded-write"]
    sync.KNOWN_SYNCHRONIZED.add("CrossLinked.state")
    try:
        assert lint.lint_source(src, ["lock-discipline"]) == []
    finally:
        sync.KNOWN_SYNCHRONIZED.discard("CrossLinked.state")


# ================================================== graph-capture-hygiene

def test_graph_capture_positives():
    src = '''
import time
import numpy as np
import torch
from ray_tpu_torch.rllib.core.learner import CudaGraphStep

def step(mb):
    loss = mb["x"].sum()
    v = float(loss)
    a = np.asarray(loss)
    h = loss.cpu()
    n = loss.numpy()
    t = loss.tolist()
    torch.cuda.synchronize()
    print("captured once")
    t0 = time.perf_counter()
    return loss.item()

graphed = CudaGraphStep(step)
'''
    findings = lint_source(src, ["graph-capture-hygiene"])
    assert rules_of(findings) == ["graph-capture-hygiene"] * 9
    assert all("`step`" in f.message for f in findings)


def test_graph_capture_partial_alias_and_negatives():
    """``step = functools.partial(fn, ...)`` then ``CudaGraphStep(step)``
    marks ``fn`` (the DQN and SAC learners' shape); host code outside the
    captured function, and numpy on literals inside it, are not flagged."""
    src = '''
import functools
import numpy as np
from ray_tpu_torch.rllib.core.learner import CudaGraphStep

def minibatch(module, mb, *, tau):
    loss = module(mb["x"]).mean()
    return loss * np.asarray([1.0, 2.0])   # literal: a host constant

class Learner:
    def __init__(self, module, card):
        step = functools.partial(minibatch, module, tau=0.5)
        self._step = CudaGraphStep(step) if card else step

    def update(self, mb):
        return float(self._step(mb))        # host code after the replay
'''
    assert lint_source(src, ["graph-capture-hygiene"]) == []
    flagged = src.replace("return loss * np.asarray([1.0, 2.0])",
                          "return loss * loss.item()")
    findings = lint_source(flagged, ["graph-capture-hygiene"])
    assert rules_of(findings) == ["graph-capture-hygiene"]
    assert "`minibatch`" in findings[0].message


def test_graph_capture_flags_local_captured_method_and_decorator():
    src = '''
from ray_tpu_torch.rllib.core import learner

class Trainer:
    def __init__(self):
        self._step = learner.CudaGraphStep(self._train_step)

    def _train_step(self, mb):
        return int(mb["n"]) + 1

@learner.CudaGraphStep
def decorated(mb):
    print(mb)
'''
    findings = lint_source(src, ["graph-capture-hygiene"])
    assert rules_of(findings) == ["graph-capture-hygiene"] * 2
    assert "_train_step" in findings[0].message
    assert "decorated" in findings[1].message


def test_graph_capture_other_objects_method_not_confused():
    # CudaGraphStep(self.learner.update) captures the LEARNER's method: a
    # same-named method on this class must not be flagged
    src = '''
import numpy as np
from ray_tpu_torch.rllib.core.learner import CudaGraphStep

class Runner:
    def __init__(self):
        self._update = CudaGraphStep(self.learner.update)

    def update(self, mb):
        return np.asarray(self._update(mb))
'''
    assert lint_source(src, ["graph-capture-hygiene"]) == []


def test_graph_capture_ignores_jit_and_jax_ignores_capture():
    """A jitted JAX function is no graph capture, and a captured function
    is no jit: each package's rule sees its own compiler only."""
    from ray_tpu._lint import lint_source as jax_lint_source

    jitted = '''
import jax
@jax.jit
def step(x):
    return x.item()
'''
    captured = '''
from ray_tpu_torch.rllib.core.learner import CudaGraphStep
def step(x):
    return x.item()
graphed = CudaGraphStep(step)
'''
    assert lint_source(jitted, ["graph-capture-hygiene"]) == []
    assert jax_lint_source(captured, ["jax-tracer-hygiene"]) == []
    assert rules_of(jax_lint_source(jitted, ["jax-tracer-hygiene"])) == \
        ["jax-tracer-hygiene"]


def test_graph_capture_follows_the_module_functions_it_calls():
    src = '''
from ray_tpu_torch.rllib.core.learner import CudaGraphStep

def _loss(mb):
    return mb["x"].mean().item()

def helper_unused(mb):
    return float(mb["x"])

def step(mb):
    return _loss(mb)

graphed = CudaGraphStep(step)
'''
    findings = lint_source(src, ["graph-capture-hygiene"])
    assert rules_of(findings) == ["graph-capture-hygiene"]
    assert "`_loss`" in findings[0].message and findings[0].line == 5


@pytest.mark.parametrize("rel,step,callees,anchor", [
    ("rllib/algorithms/dqn.py", "dqn_minibatch", {"polyak_"},
     "One minibatch's update (reference"),
    ("rllib/algorithms/sac.py", "sac_minibatch",
     {"sac_losses", "_frozen_q"},
     "One minibatch's update: the three")])
def test_graph_capture_finds_the_learners_step_defs_clean(rel, step,
                                                          callees, anchor):
    from ray_tpu_torch._lint.checkers.tracer_hygiene import (
        _captured_local_names, _with_callees)

    path = REPO / "ray_tpu_torch" / rel
    ctx = FileCtx(f"ray_tpu_torch/{rel}", path.read_text())
    assert step in _captured_local_names(ctx.tree)
    assert _with_callees(ctx.tree, {step}) == {step} | callees
    assert run_lint(files=[ctx], checkers=["graph-capture-hygiene"],
                    baseline=None).findings == []
    # the same file with a host sync in the step is flagged there
    src = ctx.source.replace(f'    """{anchor}',
                             f"    mb['x'].item()\n    \"\"\"{anchor}", 1)
    assert src != ctx.source
    bad = run_lint(files=[FileCtx(ctx.relpath, src)],
                   checkers=["graph-capture-hygiene"], baseline=None)
    assert [f"`{step}`" in f.message for f in bad.findings] == [True]


# =========================================== suppressions and baseline

def test_baseline_round_trip(tmp_path):
    src = '''
import time
async def handler():
    time.sleep(1)
'''
    ctx = FileCtx("pkg/mod.py", src)
    fresh = run_lint(files=[ctx], checkers=["async-blocking"], baseline=None)
    assert len(fresh.findings) == 1

    path = str(tmp_path / "baseline.json")
    save_baseline(path, fresh.findings, notes={})
    assert len(load_baseline(path)) == 1

    again = run_lint(files=[FileCtx("pkg/mod.py", src)],
                     checkers=["async-blocking"], baseline=path)
    assert again.findings == [] and len(again.baselined) == 1
    assert again.ok

    # a NEW second violation is not absorbed by the old baseline
    third = run_lint(files=[FileCtx("pkg/mod.py",
                                    src + "    time.sleep(2)\n")],
                     checkers=["async-blocking"], baseline=path)
    assert len(third.findings) == 1 and len(third.baselined) == 1


def test_baseline_fingerprints_survive_line_drift(tmp_path):
    src = "import time\nasync def f():\n    time.sleep(1)\n"
    path = str(tmp_path / "b.json")
    first = run_lint(files=[FileCtx("m.py", src)],
                     checkers=["async-blocking"], baseline=None)
    save_baseline(path, first.findings)
    shifted = "import time\n\n\n# comment\nasync def f():\n    time.sleep(1)\n"
    again = run_lint(files=[FileCtx("m.py", shifted)],
                     checkers=["async-blocking"], baseline=path)
    assert again.findings == [] and len(again.baselined) == 1


def test_duplicate_findings_fingerprint_distinctly():
    src = "import time\nasync def f():\n    time.sleep(1)\n    time.sleep(1)\n"
    findings = lint_source(src, ["async-blocking"])
    assert len(findings) == 2
    assert len(set(fingerprints(findings))) == 2


def test_checked_in_baseline_is_the_empty_one():
    assert load_baseline(_lint.DEFAULT_BASELINE) == {}
    with open(_lint.DEFAULT_BASELINE) as fh:
        assert json.load(fh) == {"entries": {}, "version": 1}


def test_unknown_checker_rejected():
    with pytest.raises(ValueError, match="unknown checker"):
        run_lint(files=[FileCtx("m.py", "x = 1\n")],
                 checkers=["no-such-rule"], baseline=None)


def test_registration_order_is_the_references():
    """Eight checkers, registered in the reference's import order, the
    tracer rule under the port's name."""
    from ray_tpu._lint import all_checkers as jax_checkers

    jax_order = [n.replace("jax-tracer-hygiene", "graph-capture-hygiene")
                 for n in jax_checkers()]
    assert list(_lint.all_checkers()) == jax_order
    assert sorted(jax_order) == CHECKERS


# ========================================================== cli plumbing

def test_cli_lint_clean_tree_exits_zero(capsys):
    from ray_tpu_torch.scripts.cli import main

    rc = main(["lint", PORT_DIR])
    out = capsys.readouterr().out
    assert rc == 0
    assert "0 finding(s)" in out and "8 checkers" in out


def test_cli_lint_json_and_nonzero_exit(tmp_path, capsys):
    from ray_tpu_torch.scripts.cli import main

    bad = tmp_path / "bad.py"
    bad.write_text("import time\nasync def f():\n    time.sleep(1)\n")
    rc = main(["lint", str(bad), "--json", "--no-baseline"])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert payload["ok"] is False
    assert payload["findings"][0]["rule"] == "async-blocking"


def test_cli_list_rules(capsys):
    from ray_tpu_torch.scripts.cli import main

    rc = main(["lint", "--list-rules"])
    out = capsys.readouterr().out
    assert rc == 0
    for name in CHECKERS:
        assert name in out


def test_module_lint_exits_zero_on_the_tree():
    """``python -m ray_tpu_torch lint``, as a user runs it from the
    repository's root."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-m", "ray_tpu_torch", "lint"],
                          cwd=str(REPO), env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s)" in proc.stdout


# ========================================================= wire contract

_WIRE_RPC_FIXTURE = '''
PROTOCOL_VERSION = 1
MIN_COMPATIBLE_VERSION = 1

class Srv:
    async def rpc_ping(self, conn, msg):
        return {"ok": msg["x"]}

async def client(conn):
    await conn.call("ping", {"x": 1})
'''


def test_wire_contract_drift_gate(tmp_path, monkeypatch):
    from ray_tpu_torch._lint import wire_contract as wc
    from ray_tpu_torch._lint.checkers.wire_contract import (
        WireContractChecker)

    def files(src):
        return [FileCtx("ray_tpu_torch/_private/rpc.py", src)]

    snap = tmp_path / "snap.json"
    wc.save_snapshot(wc.extract_contract(files(_WIRE_RPC_FIXTURE)),
                     str(snap))
    monkeypatch.setattr(WireContractChecker, "snapshot_path", str(snap))
    assert run_lint(files=files(_WIRE_RPC_FIXTURE),
                    checkers=["wire-contract"], baseline=None).findings == []
    edited = _WIRE_RPC_FIXTURE.replace('"ok":', '"renamed":')
    r = run_lint(files=files(edited), checkers=["wire-contract"],
                 baseline=None)
    assert rules_of(r.findings) == ["wire-contract.drift"]
    assert "PROTOCOL_VERSION" in r.findings[0].message
    assert r.findings[0].path == "ray_tpu_torch/_private/rpc.py"
    assert len(fingerprints(r.findings)) == 1
    bumped = edited.replace("PROTOCOL_VERSION = 1", "PROTOCOL_VERSION = 2")
    assert run_lint(files=files(bumped), checkers=["wire-contract"],
                    baseline=None).findings == []


def test_wire_contract_extraction_deterministic(port_files):
    from ray_tpu_torch._lint import wire_contract as wc

    c1 = wc.extract_contract(port_files)
    c2 = wc.extract_contract(_lint.collect_files([PORT_DIR]))
    assert wc.contract_json(c1) == wc.contract_json(c2)
    assert wc.contract_markdown(c1) == wc.contract_markdown(c2)


def test_wire_contract_tree_gate(port_files):
    r = run_lint(files=port_files, checkers=["wire-contract"], baseline=None)
    assert r.findings == [], [f"{f.path}:{f.line}: {f.message}"
                              for f in r.findings]


def test_wire_contract_snapshot_is_loadable_json():
    from ray_tpu_torch._lint import wire_contract as wc

    snap = wc.load_snapshot()
    assert snap["protocol"]["version"] >= 1
    assert len(snap["methods"]) >= 100
    servers = set()
    for m in snap["methods"].values():
        servers.update(m["servers"])
    assert {"GcsServer", "Nodelet", "CoreWorker"} <= servers


def test_cli_lint_contract_in_sync(capsys):
    from ray_tpu_torch.scripts.cli import main

    rc = main(["lint", "--contract"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "in sync with snapshot" in out and "methods" in out


def test_cli_lint_contract_json_is_the_snapshot(capsys):
    from ray_tpu_torch._lint import wire_contract as wc
    from ray_tpu_torch.scripts.cli import main

    rc = main(["lint", "--contract", "--json"])
    assert rc == 0
    assert json.loads(capsys.readouterr().out) == wc.load_snapshot()


# ======================================================= metrics hygiene

def _metric_messages(files, sub_rules):
    result = run_lint(files=files, checkers=["metrics-hygiene"],
                      baseline=None)
    return [f"{f.path}: {f.message}" for f in result.findings
            if f.rule in sub_rules]


def test_metrics_source_walk_finds_the_known_definition_sites(port_files):
    from ray_tpu_torch._lint.checkers.metrics_hygiene import collect_metrics

    names = {name for _c, _l, _k, name, _d in collect_metrics(port_files)}
    for expected in ("serve_request_latency_seconds", "data_rows_output_total",
                     "train_report_total", "node_resources_total",
                     "task_phase_seconds", "suspected_hung_tasks",
                     "collective_op_seq", "train_rank_step",
                     "train_gang_step_skew", "llm_requests_total"):
        assert expected in names, f"walker missed {expected}"


def test_every_port_metric_is_in_the_architecture_doc(port_files):
    """The copy reads ``docs/ARCHITECTURE.md`` (the JAX package's doc: the
    port exports its series under the same names)."""
    from ray_tpu_torch._lint.checkers import metrics_hygiene

    assert metrics_hygiene._architecture_md(port_files)
    assert _metric_messages(port_files, ("metrics-hygiene.docs",)) == []


def test_port_metric_definitions_are_hygienic(port_files):
    assert _metric_messages(port_files, (
        "metrics-hygiene.name", "metrics-hygiene.prefix",
        "metrics-hygiene.help", "metrics-hygiene.kind")) == []


def test_port_runtime_registry_is_hygienic():
    from ray_tpu_torch._private import metrics as M
    from ray_tpu_torch.data._metrics import data_metrics
    from ray_tpu_torch.llm._metrics import llm_metrics
    from ray_tpu_torch.serve._metrics import serve_metrics
    from ray_tpu_torch.train._metrics import train_metrics

    serve_metrics()
    data_metrics()
    train_metrics()
    llm_metrics()
    assert M.validate_registry(M.default_registry) == []


def test_conflicting_kind_registration_raises():
    from ray_tpu_torch._private import metrics as M

    reg = M.Registry()
    M.Counter("dup_kind_metric", "a counter", registry=reg)
    with pytest.raises(ValueError, match="already registered"):
        M.Gauge("dup_kind_metric", "now a gauge", registry=reg)


def test_same_kind_reregistration_adopts_storage():
    from ray_tpu_torch._private import metrics as M

    reg = M.Registry()
    a = M.Counter("rereg_metric", "c", registry=reg)
    a.inc(2)
    M.Counter("rereg_metric", "c", registry=reg).inc(3)
    assert dict(a.samples()) == {(): 5.0}


def test_validate_registry_flags_violations():
    from ray_tpu_torch._private import metrics as M

    reg = M.Registry()
    M.Counter("ok_metric", "fine", registry=reg)
    M.Counter("bad metric name", "desc", registry=reg)
    M.Counter("ray_tpu_prefixed", "desc", registry=reg)
    M.Gauge("no_help_text", "", registry=reg)
    problems = "\n".join(M.validate_registry(reg))
    assert "bad metric name" in problems
    assert "ray_tpu_prefixed" in problems
    assert "no_help_text" in problems
    assert "ok_metric" not in problems


# ============================================================ tree gate

def test_full_tree_is_clean(tree_runs):
    """All eight checkers over ray_tpu_torch/ against the empty baseline:
    zero findings."""
    result = tree_runs[0]
    assert sorted(result.checkers_run) == CHECKERS
    msgs = "\n".join(f"{f.path}:{f.line}: [{f.rule}] {f.message}"
                     for f in result.findings)
    assert result.ok and not result.baselined, msgs


def test_full_tree_runs_are_byte_identical(tree_runs):
    a, b = (render_json(r) for r in tree_runs)
    assert a == b
    assert json.loads(a)["ok"] is True
