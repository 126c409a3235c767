"""Port of ``ray_tpu/dag/__init__.py``.

Task DAGs: lazy ``.bind()`` graphs executed over the task runtime.

Reference: python/ray/dag/ (DAGNode, dag_node.py; FunctionNode bind API).
``fn.bind(*args)`` builds the graph lazily; ``node.execute()`` submits every
task with its upstream refs as arguments, so the runtime's normal dependency
resolution drives execution order — no extra scheduler.  This is also the
substrate the workflow layer persists (reference: workflows run DAGs with
durable step results).

Actor-method graphs additionally support ``experimental_compile()``
(reference: dag/compiled_dag_node.py:480): the graph's edges become
persistent shared-memory channels and each actor runs a channel-driven loop,
so repeated executes bypass the per-call lease/RPC path entirely — see
``ray_tpu_torch.dag.compiled``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import ray_tpu_torch


class DAGNode:
    """One lazy task invocation in a graph."""

    def __init__(self, remote_fn, args: Tuple, kwargs: Dict[str, Any]):
        self._remote_fn = remote_fn
        self._bound_args = args
        self._bound_kwargs = kwargs

    # ------------------------------------------------------------- execute
    def execute(self) -> Any:
        """Submit the whole graph; returns the root's ObjectRef.  Shared
        nodes (diamonds) submit once."""
        return self._submit(memo={})

    def _submit(self, memo: Dict[int, Any]):
        key = id(self)
        if key in memo:
            return memo[key]
        args = [a._submit(memo) if isinstance(a, DAGNode) else a
                for a in self._bound_args]
        kwargs = {k: (v._submit(memo) if isinstance(v, DAGNode) else v)
                  for k, v in self._bound_kwargs.items()}
        ref = self._remote_fn.remote(*args, **kwargs)
        memo[key] = ref
        return ref

    # ----------------------------------------------------------- traversal
    def upstream(self) -> List["DAGNode"]:
        out = [a for a in self._bound_args if isinstance(a, DAGNode)]
        out += [v for v in self._bound_kwargs.values()
                if isinstance(v, DAGNode)]
        return out

    def fn_name(self) -> str:
        fn = getattr(self._remote_fn, "_function", None)
        return getattr(fn, "__name__", "task")

    def experimental_compile(self, max_buf: int = 1 << 20, depth: int = 2):
        """Compile this graph into persistent channels + actor loops
        (valid for actor-method graphs: ClassMethodNode/MultiOutputNode
        roots — the compiler validates node kinds)."""
        from ray_tpu_torch.dag.compiled import CompiledDAG

        return CompiledDAG(self, max_buf=max_buf, depth=depth)

    def __repr__(self):
        return f"DAGNode({self.fn_name()})"


class InputNode(DAGNode):
    """Placeholder for the value supplied at ``compiled.execute(value)``
    (reference: dag/input_node.py).  Usable as a context manager for API
    parity: ``with InputNode() as inp: ...``."""

    def __init__(self):
        super().__init__(None, (), {})

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def _submit(self, memo):
        raise TypeError("a DAG containing InputNode must be compiled with "
                        "experimental_compile() and run via execute(value)")

    def __repr__(self):
        return "InputNode()"


class ClassMethodNode(DAGNode):
    """A bound actor-method invocation (reference: dag/class_node.py)."""

    def __init__(self, actor_method, args: Tuple, kwargs: Dict[str, Any]):
        super().__init__(None, args, kwargs)
        self._actor_method = actor_method

    def _submit(self, memo: Dict[int, Any]):
        key = id(self)
        if key in memo:
            return memo[key]
        args = [a._submit(memo) if isinstance(a, DAGNode) else a
                for a in self._bound_args]
        kwargs = {k: (v._submit(memo) if isinstance(v, DAGNode) else v)
                  for k, v in self._bound_kwargs.items()}
        ref = self._actor_method.remote(*args, **kwargs)
        memo[key] = ref
        return ref


    def fn_name(self) -> str:
        return self._actor_method._name

    def __repr__(self):
        return f"ClassMethodNode({self.fn_name()})"


class MultiOutputNode(DAGNode):
    """Bundle several graph leaves into one compiled output: ``execute()``
    results arrive as a list, one element per member (reference:
    dag/output_node.py MultiOutputNode)."""

    def __init__(self, outputs: List[DAGNode]):
        super().__init__(None, tuple(outputs), {})
        if not outputs or not all(isinstance(o, ClassMethodNode)
                                  for o in outputs):
            raise ValueError("MultiOutputNode takes a non-empty list of "
                             "actor-method nodes")
        self.outputs = list(outputs)

    def _submit(self, memo: Dict[int, Any]):
        return [o._submit(memo) for o in self.outputs]


    def fn_name(self) -> str:
        return "MultiOutput"

    def __repr__(self):
        return f"MultiOutputNode({len(self.outputs)} outputs)"
