"""Port of ``ray_tpu/_lint/wire_contract.py``.

Wire-contract extraction: reconstruct the IDL the frame protocol never had.

The reference pins its cross-process surface to 24 ``.proto`` files; this
runtime deliberately runs an IDL-less msgpack frame protocol
(``_private/rpc.py``) where every RPC is a string method name dispatched
against a handler dict.  A typo'd ``call_sync("plasma_sael", ...)`` or a
payload key the handler never reads fails only at runtime — or hangs, for a
``notify``.  This module walks the package AST and rebuilds the missing
contract statically:

- **Servers**: every ``async def rpc_<name>`` method on a class
  (GcsServer / Nodelet / CoreWorker register these via a ``dir()`` sweep),
  every nested handler wired through ``handlers.update(name=func)``
  (the plasma store surface), and every explicit
  ``handlers["name"] = self._fn`` / ``{"name": self._fn}`` registration
  into a ``*handlers*``-named table (the pub/sub push surface).
- **Request schema**: the keys each handler reads from its payload —
  ``msg["k"]`` (required), ``msg.get("k")`` or a conditional ``msg["k"]``
  (optional).  A handler that uses its payload any other way (forwards it
  whole, iterates it) is *dynamic*: its request schema is unknowable
  statically and key checks are skipped for it.
- **Reply schema**: the constant keys of every ``return {...}`` dict
  literal; any other non-``None`` return marks the reply *opaque*.
- **Call sites**: every ``call`` / ``call_sync`` / ``call_async`` /
  ``call_pipelined`` / ``notify`` / ``notify_sync`` / ``notify_coalesced``
  / ``notify_coalesced_threadsafe`` invocation with a constant method name,
  plus the thin wrappers that forward one (``gcs_call``, ``gcs_call_sync``,
  ``_gcs_call``, ``_kv_call``).  Dict-literal payloads contribute their
  keys; anything else is a *dynamic* payload.
- **Protocol constants**: ``PROTOCOL_VERSION`` / frame-type codes from
  ``_private/rpc.py`` and the ``0x93`` data-plane frame magic from
  ``experimental/channel.py``.

Two deterministic artifacts render from the extraction (byte-identical
across runs — no timestamps, no line numbers, sorted everything):

- ``ray_tpu_torch/_lint/wire_contract.json`` — the checked-in snapshot the
  ``wire-contract.drift`` rule gates PRs against, and
- ``docs/WIRE_CONTRACT.md`` — the generated human-readable IDL.

Regenerate both with ``python -m ray_tpu_torch lint --update-contract``.
The enforcement rules live in ``checkers/wire_contract.py``.
"""

from __future__ import annotations

import ast
import json
import os
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._lint.core import FileCtx

# Connection methods that issue an RPC with (method, payload) leading args.
CALL_KINDS = (
    "call", "call_sync", "call_async", "call_pipelined",
    "notify", "notify_sync", "notify_coalesced",
    "notify_coalesced_threadsafe",
)
# Notify-flavored kinds never wait for a reply: an unknown method HANGS the
# caller-visible effect instead of raising — called out in finding messages.
NOTIFY_KINDS = frozenset(
    k for k in CALL_KINDS if k.startswith("notify"))

# Thin wrappers that forward a constant method name + payload to a
# Connection.  The method is the first constant-string positional among the
# leading two args (``_gcs_call(address, "method", msg)`` in the CLI puts it
# second); the payload is the next positional after it — or, for the
# kwargs-style wrappers (``self._kv("kv_put", ns=..., key=...)``), the
# keyword arguments themselves.
WRAPPER_KINDS = frozenset({"gcs_call", "gcs_call_sync", "_gcs_call",
                           "_kv_call", "_kv"})

# Functions that build a handler table from nested ``async def``s and
# register it into a server elsewhere -> the server that mounts them.
NESTED_REGISTRY_SERVERS = {"register_store_handlers": "Nodelet"}

# Frame-level machinery that is not a dispatchable application method.
INTERNAL_METHODS = frozenset({"__batch__", "__hello__"})

# Module-level constants folded into the contract, keyed by the file that
# owns them (suffix-matched on the repo-relative path).
_PROTOCOL_CONST_FILES = {
    "_private/rpc.py": ("PROTOCOL_VERSION", "MIN_COMPATIBLE_VERSION",
                        "PROTOCOL_FEATURES", "T_REQ", "T_RES", "T_ERR",
                        "T_NOTIFY", "T_HELLO", "_BATCH_METHOD"),
    "experimental/channel.py": ("_SER_FRAME_MAGIC",),
}

DEFAULT_SNAPSHOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "wire_contract.json")


# ----------------------------------------------------------------- model


class HandlerInfo:
    """One server-side handler registration (with AST anchors for
    findings; the canonical contract strips lines)."""

    def __init__(self, method: str, server: str, path: str, func: str,
                 line: int):
        self.method = method
        self.server = server
        self.path = path
        self.func = func
        self.line = line
        self.required: List[str] = []
        self.optional: List[str] = []
        self.dynamic = False          # payload used beyond key reads
        self.reply_keys: List[str] = []
        self.reply_opaque = False     # some return is not a dict literal


class CallSite:
    """One client-side call site naming a method with a constant string."""

    def __init__(self, method: str, kind: str, path: str, line: int,
                 col: int, keys: List[str], dynamic: bool, node: ast.AST):
        self.method = method
        self.kind = kind
        self.path = path
        self.line = line
        self.col = col
        self.keys = keys
        self.dynamic = dynamic       # payload is not a plain dict literal
        self.node = node


class WireModel:
    """Full extraction result: handlers + call sites + protocol constants,
    with AST anchors.  ``contract_from_model`` derives the canonical,
    line-free contract dict from this."""

    def __init__(self):
        self.handlers: Dict[str, List[HandlerInfo]] = {}
        self.calls: Dict[str, List[CallSite]] = {}
        self.constants: Dict[str, Any] = {}
        # FileCtx + AST node of the PROTOCOL_VERSION assignment (drift
        # findings anchor here); None when the tree has no rpc.py.
        self.version_anchor: Optional[Tuple[FileCtx, ast.AST]] = None

    def add_handler(self, h: HandlerInfo) -> None:
        self.handlers.setdefault(h.method, []).append(h)

    def add_call(self, c: CallSite) -> None:
        self.calls.setdefault(c.method, []).append(c)


# ------------------------------------------------- handler key extraction


def _analyze_handler(fn: ast.AST, h: HandlerInfo) -> None:
    """Fill request/reply schema from one handler function body."""
    args = getattr(fn, "args", None)
    params = args.args if args else []
    if not params:
        return
    payload = params[-1].arg
    if payload in ("self", "conn"):
        return  # no payload parameter at all
    required: set = set()
    optional: set = set()

    class V:
        """Parent-aware walk: conditional ``msg["k"]`` reads demote to
        optional (the plasma_release ``{"oid"} | {"oids"}`` shape); any use
        of the payload outside a key read marks the request dynamic."""

        def visit(self, node: ast.AST, cond: bool) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node is not fn:
                # nested defs close over the payload: a key read inside one
                # still counts, conditionally (the closure may never run)
                cond = True
            if isinstance(node, ast.Subscript) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id == payload \
                    and isinstance(node.slice, ast.Constant) \
                    and isinstance(node.slice.value, str):
                (optional if cond else required).add(node.slice.value)
                self.generic(node.slice, cond)
                return
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "get" \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id == payload \
                    and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                optional.add(node.args[0].value)
                for a in node.args[1:]:
                    self.visit(a, cond)
                return
            if isinstance(node, ast.Assign) \
                    and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and node.targets[0].id == payload \
                    and isinstance(node.value, ast.BoolOp) \
                    and isinstance(node.value.values[0], ast.Name) \
                    and node.value.values[0].id == payload:
                # ``msg = msg or {}``: the None-tolerant guard, not a real
                # rebind — later key reads stay statically knowable
                for sub in node.value.values[1:]:
                    self.visit(sub, True)
                return
            if isinstance(node, ast.Name) and node.id == payload:
                # bare payload use: forwarded / iterated / rebound — the
                # schema is not statically knowable
                h.dynamic = True
                return
            if isinstance(node, (ast.If, ast.IfExp)):
                self.visit(node.test, cond)
                for sub in node.body if isinstance(node.body, list) \
                        else [node.body]:
                    self.visit(sub, True)
                orelse = node.orelse if isinstance(node.orelse, list) \
                    else [node.orelse]
                for sub in orelse:
                    self.visit(sub, True)
                return
            if isinstance(node, ast.Try):
                for sub in ast.iter_child_nodes(node):
                    self.visit(sub, True)
                return
            if isinstance(node, ast.BoolOp):
                self.visit(node.values[0], cond)
                for sub in node.values[1:]:
                    self.visit(sub, True)  # short-circuit: may not evaluate
                return
            if isinstance(node, ast.Return):
                self._ret(node)
                if node.value is not None:
                    self.visit(node.value, cond)
                return
            self.generic(node, cond)

        def generic(self, node: ast.AST, cond: bool) -> None:
            for child in ast.iter_child_nodes(node):
                self.visit(child, cond)

        def _ret(self, node: ast.Return) -> None:
            v = node.value
            if v is None or (isinstance(v, ast.Constant) and v.value is None):
                return
            if isinstance(v, ast.Dict) and all(
                    isinstance(k, ast.Constant) and isinstance(k.value, str)
                    for k in v.keys):
                for k in v.keys:
                    if k.value not in h.reply_keys:
                        h.reply_keys.append(k.value)
                return
            h.reply_opaque = True

    v = V()
    for stmt in fn.body:
        v.visit(stmt, False)
    h.required = sorted(required - optional)
    h.optional = sorted(optional)
    h.reply_keys = sorted(h.reply_keys)


def _resolve_local_func(name: str, cls: Optional[ast.ClassDef],
                        module: ast.Module) -> Optional[ast.AST]:
    """Find ``name`` among the class's methods, else module functions."""
    scopes = ([cls.body] if cls is not None else []) + [module.body]
    for body in scopes:
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name == name:
                return node
    return None


def _registration_value_name(value: ast.AST) -> Optional[str]:
    """``self._on_publish`` / ``_on_publish`` -> the function name."""
    if isinstance(value, ast.Attribute) \
            and isinstance(value.value, ast.Name) \
            and value.value.id == "self":
        return value.attr
    if isinstance(value, ast.Name):
        return value.id
    return None


def _is_handler_table_target(target: ast.AST) -> bool:
    """True for assignment targets whose name contains 'handlers' —
    ``handlers["publish"] = ...`` / ``self._gcs_handlers = {...}``."""
    base = target
    if isinstance(base, ast.Subscript):
        base = base.value
    if isinstance(base, ast.Attribute):
        return "handlers" in base.attr
    if isinstance(base, ast.Name):
        return "handlers" in base.id
    return False


def _extract_class_handlers(ctx: FileCtx, cls: ast.ClassDef,
                            model: WireModel) -> None:
    # rpc_* methods: registered by the servers' dir() sweep
    for node in cls.body:
        if isinstance(node, (ast.AsyncFunctionDef, ast.FunctionDef)) \
                and node.name.startswith("rpc_"):
            h = HandlerInfo(node.name[4:], cls.name, ctx.relpath,
                            node.name, node.lineno)
            _analyze_handler(node, h)
            model.add_handler(h)
    # explicit registrations inside methods:
    #   handlers["publish"] = self._on_publish
    #   self._gcs_handlers = {"publish": self._on_publish, **handlers}
    for meth in cls.body:
        if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for node in ast.walk(meth):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            target = node.targets[0]
            if not _is_handler_table_target(target):
                continue
            pairs: List[Tuple[str, ast.AST]] = []
            if isinstance(target, ast.Subscript) \
                    and isinstance(target.slice, ast.Constant) \
                    and isinstance(target.slice.value, str):
                pairs.append((target.slice.value, node.value))
            elif isinstance(node.value, ast.Dict):
                for k, val in zip(node.value.keys, node.value.values):
                    if isinstance(k, ast.Constant) \
                            and isinstance(k.value, str):
                        pairs.append((k.value, val))
            for method_name, val in pairs:
                fname = _registration_value_name(val)
                if fname is None:
                    continue
                fn = _resolve_local_func(fname, cls, ctx.tree)
                h = HandlerInfo(method_name, cls.name, ctx.relpath, fname,
                                getattr(fn, "lineno", node.lineno))
                if fn is not None:
                    _analyze_handler(fn, h)
                else:
                    h.dynamic = True
                model.add_handler(h)


def _extract_nested_registry(ctx: FileCtx, fn: ast.FunctionDef,
                             model: WireModel) -> None:
    """``handlers.update(plasma_get=plasma_get, ...)`` over nested defs."""
    server = NESTED_REGISTRY_SERVERS.get(fn.name, fn.name)
    nested = {n.name: n for n in fn.body
              if isinstance(n, (ast.AsyncFunctionDef, ast.FunctionDef))}
    for node in ast.walk(fn):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "update"
                and node.keywords):
            continue
        for kw in node.keywords:
            if kw.arg is None:
                continue
            fname = _registration_value_name(kw.value) or kw.arg
            target = nested.get(fname)
            h = HandlerInfo(kw.arg, server, ctx.relpath, fname,
                            getattr(target, "lineno", node.lineno))
            if target is not None:
                _analyze_handler(target, h)
            else:
                h.dynamic = True
            model.add_handler(h)


# --------------------------------------------------- call-site extraction


def _payload_keys(node: Optional[ast.AST]) -> Tuple[List[str], bool]:
    """(constant keys, dynamic?) of a call-site payload expression."""
    if node is None or (isinstance(node, ast.Constant)
                        and node.value is None):
        return [], False
    if isinstance(node, ast.Dict):
        keys, dynamic = [], False
        for k in node.keys:
            if isinstance(k, ast.Constant) and isinstance(k.value, str):
                keys.append(k.value)
            else:
                dynamic = True  # **spread or computed key
        return sorted(keys), dynamic
    return [], True


def _match_call_site(node: ast.Call) -> Optional[Tuple[str, ast.AST,
                                                       Optional[ast.AST]]]:
    """(kind, method-arg node, payload node) when this Call is an RPC."""
    func = node.func
    name = getattr(func, "attr", None) or getattr(func, "id", None)
    if name in CALL_KINDS and isinstance(func, ast.Attribute):
        method = node.args[0] if node.args else None
        payload = node.args[1] if len(node.args) > 1 else None
        if payload is None:
            for kw in node.keywords:
                if kw.arg == "obj":
                    payload = kw.value
        return (name, method, payload)
    if name in WRAPPER_KINDS:
        # method = first constant string among the leading two positionals
        for i, arg in enumerate(node.args[:2]):
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                payload = node.args[i + 1] if len(node.args) > i + 1 else None
                return (name, arg, payload)
        return None
    return None


def _kwarg_keys(node: ast.Call) -> Tuple[List[str], bool]:
    """Keys of a kwargs-style wrapper payload; ``**spread`` is dynamic."""
    keys, dynamic = [], False
    for kw in node.keywords:
        if kw.arg is None:
            dynamic = True
        else:
            keys.append(kw.arg)
    return sorted(keys), dynamic


def _extract_calls(ctx: FileCtx, model: WireModel) -> None:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        matched = _match_call_site(node)
        if matched is None:
            continue
        kind, method_arg, payload = matched
        if not (isinstance(method_arg, ast.Constant)
                and isinstance(method_arg.value, str)):
            continue  # dynamic dispatch (the wrapper defs themselves)
        if payload is None and kind in WRAPPER_KINDS and node.keywords:
            keys, dynamic = _kwarg_keys(node)
        else:
            keys, dynamic = _payload_keys(payload)
        model.add_call(CallSite(method_arg.value, kind, ctx.relpath,
                                node.lineno, node.col_offset, keys,
                                dynamic, node))


# ------------------------------------------------------------- constants


def _extract_constants(ctx: FileCtx, names: Tuple[str, ...],
                       model: WireModel) -> None:
    for node in ctx.tree.body:
        if not isinstance(node, ast.Assign):
            continue
        targets = node.targets[0]
        pairs: List[Tuple[str, ast.AST]] = []
        if isinstance(targets, ast.Name):
            pairs.append((targets.id, node.value))
        elif isinstance(targets, ast.Tuple) \
                and isinstance(node.value, ast.Tuple) \
                and len(targets.elts) == len(node.value.elts):
            for t, v in zip(targets.elts, node.value.elts):
                if isinstance(t, ast.Name):
                    pairs.append((t.id, v))
        for name, value in pairs:
            if name not in names:
                continue
            try:
                model.constants[name] = ast.literal_eval(value)
            except ValueError:
                continue
            if name == "PROTOCOL_VERSION":
                model.version_anchor = (ctx, node)


# ------------------------------------------------------------ extraction


def extract_model(files: List[FileCtx]) -> WireModel:
    """Walk the tree once and build the full wire model."""
    model = WireModel()
    for ctx in sorted(files, key=lambda c: c.relpath):
        if ctx.relpath.startswith("ray_tpu_torch/_lint/"):
            continue  # the analysis layer is not part of the wire surface
        for suffix, names in _PROTOCOL_CONST_FILES.items():
            if ctx.relpath.endswith(suffix):
                _extract_constants(ctx, names, model)
        for node in ctx.tree.body:
            if isinstance(node, ast.ClassDef):
                _extract_class_handlers(ctx, node, model)
            elif isinstance(node, ast.FunctionDef):
                _extract_nested_registry(ctx, node, model)
        _extract_calls(ctx, model)
    return model


def contract_from_model(model: WireModel) -> Dict[str, Any]:
    """The canonical contract: line-free, fully sorted, deterministic.
    The ``protocol`` + ``methods`` sections are what ``wire-contract.drift``
    gates; ``callers`` regenerates alongside them for the doc."""
    consts = model.constants
    frame_types = {}
    for label, const in (("REQ", "T_REQ"), ("RES", "T_RES"),
                         ("ERR", "T_ERR"), ("NOTIFY", "T_NOTIFY"),
                         ("HELLO", "T_HELLO")):
        if const in consts:
            frame_types[label] = consts[const]
    if "_SER_FRAME_MAGIC" in consts:
        # the zero-copy data plane's channel frame magic (not an RPC frame:
        # SER frames ride Shm/Tcp channels between DAG/pipeline endpoints)
        frame_types["DATA_SER"] = f"0x{consts['_SER_FRAME_MAGIC']:02x}"
    protocol: Dict[str, Any] = {
        "version": consts.get("PROTOCOL_VERSION"),
        "min_compatible": consts.get("MIN_COMPATIBLE_VERSION"),
        "features": sorted(consts.get("PROTOCOL_FEATURES") or ()),
        "frame_types": frame_types,
    }
    if "_BATCH_METHOD" in consts:
        protocol["batch_method"] = consts["_BATCH_METHOD"]

    methods: Dict[str, Any] = {}
    for method, hs in model.handlers.items():
        required = sorted(set().union(*[set(h.required) for h in hs]))
        optional = sorted(set().union(*[set(h.optional) for h in hs])
                          - set(required))
        reply = sorted(set().union(*[set(h.reply_keys) for h in hs]))
        methods[method] = {
            "servers": sorted({h.server for h in hs}),
            "handlers": sorted(f"{h.path}::{h.func}" for h in hs),
            "request": {
                "required": required,
                "optional": optional,
                "dynamic": any(h.dynamic for h in hs),
            },
            "reply": {
                "keys": reply,
                "opaque": any(h.reply_opaque for h in hs),
            },
        }

    callers: Dict[str, Any] = {}
    for method, sites in model.calls.items():
        rows = {(s.path, s.kind, tuple(s.keys), s.dynamic) for s in sites}
        callers[method] = [
            {"path": p, "kind": k, "keys": list(keys), "dynamic": dyn}
            for p, k, keys, dyn in sorted(rows)
        ]
    return {"protocol": protocol, "methods": methods, "callers": callers}


def extract_contract(files: List[FileCtx]) -> Dict[str, Any]:
    return contract_from_model(extract_model(files))


# ------------------------------------------------------- snapshot + diff


def contract_json(contract: Dict[str, Any]) -> str:
    return json.dumps(contract, indent=1, sort_keys=True) + "\n"


def load_snapshot(path: str = DEFAULT_SNAPSHOT) -> Optional[Dict[str, Any]]:
    try:
        with open(path, encoding="utf-8") as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


def save_snapshot(contract: Dict[str, Any],
                  path: str = DEFAULT_SNAPSHOT) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(contract_json(contract))


def diff_contract(old: Dict[str, Any],
                  new: Dict[str, Any]) -> List[str]:
    """Human-readable drift lines over the gated sections (protocol +
    methods).  Empty list == in sync.  Deterministic ordering."""
    out: List[str] = []
    op, np_ = old.get("protocol") or {}, new.get("protocol") or {}
    for key in sorted(set(op) | set(np_)):
        if op.get(key) != np_.get(key):
            out.append(f"protocol.{key}: {op.get(key)!r} -> {np_.get(key)!r}")
    om, nm = old.get("methods") or {}, new.get("methods") or {}
    for m in sorted(set(om) - set(nm)):
        out.append(f"method removed: {m} (was served by "
                   f"{', '.join(om[m].get('servers') or ['?'])})")
    for m in sorted(set(nm) - set(om)):
        out.append(f"method added: {m} (served by "
                   f"{', '.join(nm[m].get('servers') or ['?'])})")
    for m in sorted(set(om) & set(nm)):
        if om[m] == nm[m]:
            continue
        for section in ("servers", "handlers", "request", "reply"):
            if om[m].get(section) != nm[m].get(section):
                out.append(f"method {m}.{section}: "
                           f"{om[m].get(section)!r} -> "
                           f"{nm[m].get(section)!r}")
    return out


# ------------------------------------------------------------- rendering


def _fmt_keys(req: List[str], opt: List[str], dynamic: bool) -> str:
    parts = [k for k in req] + [f"{k}?" for k in opt]
    body = ", ".join(parts) if parts else "(none)"
    if dynamic:
        body += "  *dynamic*"
    return body


def contract_markdown(contract: Dict[str, Any]) -> str:
    """docs/WIRE_CONTRACT.md — the generated IDL.  Deterministic."""
    p = contract.get("protocol") or {}
    lines = [
        "# Wire contract (generated)",
        "",
        "<!-- GENERATED by `python -m ray_tpu_torch lint --update-contract` —",
        "     do not edit by hand.  The `wire-contract.drift` lint rule",
        "     gates this file's JSON twin against the tree. -->",
        "",
        "This is the statically extracted IDL of the msgpack frame",
        "protocol (`ray_tpu_torch/_private/rpc.py`): every RPC method any server",
        "registers, the request keys its handler reads, the reply keys it",
        "returns, and every static call site.  The reference runtime pins",
        "this surface with `.proto` files; here the contract is",
        "reconstructed from the code on every lint run.",
        "",
        "## Protocol",
        "",
        f"- version: **{p.get('version')}** "
        f"(min compatible: {p.get('min_compatible')})",
        f"- features: {', '.join(p.get('features') or ()) or '(none)'}",
        f"- batch method: `{p.get('batch_method', '__batch__')}`",
        "",
        "### Frame types",
        "",
        "| frame | code | plane |",
        "|---|---|---|",
    ]
    frame_doc = {
        "REQ": "RPC — request; `m` names a handler on the peer",
        "RES": "RPC — response (same id)",
        "ERR": "RPC — error response (same id)",
        "NOTIFY": "RPC — fire-and-forget request (id 0, no response)",
        "HELLO": "RPC — version/feature negotiation at connect",
        "DATA_SER": "data plane — zero-copy SER frame magic on "
                    "Shm/Tcp channels (not an RPC frame)",
    }
    for label, code in sorted(
            (p.get("frame_types") or {}).items(),
            key=lambda kv: (isinstance(kv[1], str), str(kv[1]))):
        lines.append(f"| {label} | `{code}` | {frame_doc.get(label, '')} |")
    methods = contract.get("methods") or {}
    callers = contract.get("callers") or {}
    lines += [
        "",
        f"## Methods ({len(methods)})",
        "",
        "`key` = required, `key?` = read optionally/conditionally,",
        "*dynamic* = schema not statically knowable (payload forwarded or",
        "iterated whole).  Reply `(opaque)` = at least one return is not a",
        "dict literal.",
        "",
    ]
    for method in sorted(methods):
        m = methods[method]
        req = m["request"]
        reply_bits = list(m["reply"]["keys"])
        reply = ", ".join(reply_bits) if reply_bits else ""
        if m["reply"]["opaque"]:
            reply = (reply + "  " if reply else "") + "(opaque)"
        lines.append(f"### `{method}`")
        lines.append("")
        lines.append(f"- served by: {', '.join(m['servers'])} "
                     f"({'; '.join(m['handlers'])})")
        lines.append(f"- request: {_fmt_keys(req['required'], req['optional'], req['dynamic'])}")
        lines.append(f"- reply: {reply or '(none)'}")
        sites = callers.get(method) or []
        if sites:
            lines.append("- callers:")
            for s in sites:
                keys = ", ".join(s["keys"]) if s["keys"] else "(no keys)"
                if s["dynamic"]:
                    keys += "  *dynamic*"
                lines.append(f"  - `{s['kind']}` from {s['path']} — {keys}")
        else:
            lines.append("- callers: (none found statically — dynamic "
                         "dispatch or external)")
        lines.append("")
    uncontracted = sorted(set(callers) - set(methods) - INTERNAL_METHODS)
    if uncontracted:
        lines.append("## Call sites with no registered handler")
        lines.append("")
        for method in uncontracted:
            for s in callers[method]:
                lines.append(f"- `{method}` ({s['kind']}) from {s['path']}")
        lines.append("")
    return "\n".join(lines).rstrip() + "\n"
