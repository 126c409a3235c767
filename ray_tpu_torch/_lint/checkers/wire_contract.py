"""Port of ``ray_tpu/_lint/checkers/wire_contract.py``.

wire-contract — static verification of the IDL-less RPC plane.

The msgpack frame protocol dispatches every RPC by string method name
against a handler dict; nothing checks at rest that the name exists or
that the payload keys line up.  These rules enforce the contract that
``ray_tpu_torch._lint.wire_contract`` extracts from the tree:

- **wire-contract.unknown-method** — a ``call*``/``notify*`` site names a
  method no server registers.  A typo here raises ``Unknown method`` at
  runtime for a call — and vanishes silently for a notify.
- **wire-contract.key-mismatch** — a caller sends payload keys the
  handler never reads (dead weight on the wire, usually a renamed field),
  or a handler requires (unconditional ``msg["k"]``) a key that no static
  caller sends (a guaranteed ``KeyError`` on that path).
- **wire-contract.drift** — the extracted contract's gated sections
  (protocol constants + per-method schemas) differ from the checked-in
  snapshot (``ray_tpu_torch/_lint/wire_contract.json``) without a
  ``PROTOCOL_VERSION`` bump.  Changing the wire surface is allowed — but
  only deliberately: either bump the version (mixed-version clusters will
  negotiate it at ``T_HELLO``) or regenerate the snapshot + docs with
  ``python -m ray_tpu_torch lint --update-contract`` so the diff shows up in
  review.

Deliberately dynamic payloads (whole-dict forwarding, list payloads) are
modeled as *dynamic* and skip key checks; a call site that must stay
exempt for another reason carries
``# lint: disable=wire-contract.key-mismatch`` with a justification.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

from ray_tpu_torch._lint import wire_contract as wc
from ray_tpu_torch._lint.core import Checker, Finding, FileCtx, register


def _fmt(keys) -> str:
    return ", ".join(sorted(keys))


@register
class WireContractChecker(Checker):
    name = "wire-contract"
    description = ("extract the wire contract (every RPC handler + call "
                   "site) and flag unknown methods, key mismatches, and "
                   "undeclared contract drift vs the snapshot")

    # class attribute so tests can point the drift gate at a fixture
    # snapshot; None = wc.DEFAULT_SNAPSHOT
    snapshot_path: str = None

    def check_tree(self, files: List[FileCtx]) -> Iterable[Finding]:
        model = wc.extract_model(files)
        contract = wc.contract_from_model(model)
        out: List[Finding] = []
        out.extend(self._unknown_methods(model, contract))
        out.extend(self._key_mismatches(model, contract))
        out.extend(self._drift(model, contract))
        return out

    # ------------------------------------------------- unknown-method

    def _unknown_methods(self, model: wc.WireModel,
                         contract: Dict) -> Iterable[Finding]:
        methods = contract["methods"]
        for method, sites in sorted(model.calls.items()):
            if method in methods or method in wc.INTERNAL_METHODS:
                continue
            for s in sites:
                hang = (" — a notify gets no error back; this vanishes "
                        "silently" if s.kind in wc.NOTIFY_KINDS else "")
                yield Finding(
                    rule="wire-contract.unknown-method", path=s.path,
                    line=s.line, col=s.col,
                    message=f"{s.kind}({method!r}) names a method no "
                            f"server registers{hang}")

    # -------------------------------------------------- key-mismatch

    def _key_mismatches(self, model: wc.WireModel,
                        contract: Dict) -> Iterable[Finding]:
        methods = contract["methods"]
        # caller side: keys sent that no handler of that name reads
        for method, sites in sorted(model.calls.items()):
            spec = methods.get(method)
            if spec is None or spec["request"]["dynamic"]:
                continue
            known = set(spec["request"]["required"]) \
                | set(spec["request"]["optional"])
            for s in sites:
                extra = sorted(set(s.keys) - known)
                if not extra:
                    continue
                yield Finding(
                    rule="wire-contract.key-mismatch", path=s.path,
                    line=s.line, col=s.col,
                    message=f"{s.kind}({method!r}) sends key(s) "
                            f"{_fmt(extra)} that no handler reads "
                            f"(handler reads: "
                            f"{_fmt(known) or '(none)'})")
        # handler side: required keys no static caller sends
        for method, handlers in sorted(model.handlers.items()):
            sites = model.calls.get(method) or []
            if not sites or any(s.dynamic for s in sites):
                continue
            sent = set()
            for s in sites:
                sent.update(s.keys)
            for h in handlers:
                missing = sorted(set(h.required) - sent)
                if not missing:
                    continue
                yield Finding(
                    rule="wire-contract.key-mismatch", path=h.path,
                    line=h.line, col=0,
                    message=f"handler {h.func} ({method!r}) requires "
                            f"key(s) {_fmt(missing)} that no caller "
                            f"sends (callers send: "
                            f"{_fmt(sent) or '(none)'})")

    # --------------------------------------------------------- drift

    def _drift(self, model: wc.WireModel,
               contract: Dict) -> Iterable[Finding]:
        if model.version_anchor is None:
            return  # no rpc.py in this file set (fixture runs)
        snapshot = wc.load_snapshot(self.snapshot_path
                                    or wc.DEFAULT_SNAPSHOT)
        if snapshot is None:
            return  # no snapshot yet: --update-contract creates it
        diff = wc.diff_contract(snapshot, contract)
        if not diff:
            return
        old_v = (snapshot.get("protocol") or {}).get("version")
        new_v = (contract.get("protocol") or {}).get("version")
        if old_v is not None and new_v is not None and new_v > old_v:
            return  # declared: the version bump announces the change
        ctx, node = model.version_anchor
        shown = "; ".join(diff[:3])
        more = f" (+{len(diff) - 3} more)" if len(diff) > 3 else ""
        yield ctx.finding(
            "wire-contract.drift", node,
            f"wire contract drifted from snapshot without a "
            f"PROTOCOL_VERSION bump: {shown}{more} — bump the version or "
            f"run `python -m ray_tpu_torch lint --update-contract`")
