"""Port of ``ray_tpu/_private/sync_suppressions.py``.

Known-synchronized shared attributes — the ONE list both analyses read.

``"ClassName.attr"`` entries name instance attributes that look like
unguarded shared state to the analyzers but are synchronized by other means
(loop confinement, single-writer-thread protocols, monotonic flags).  The
static lock-discipline checker (ray_tpu_torch/_lint/checkers/lock_discipline.py)
skips them, and the dynamic race detector (_private/race_detector.py) seeds
its suppression set from them — so a justification stated once here covers
both, and neither analysis can drift ahead of the other.

Every entry MUST carry a why; an entry without one is a bug hidden twice.
"""

# ClassName.attr -> why it is safe without the class's lock
KNOWN_SYNCHRONIZED = {
    # serve/_replica.py ServeReplica: these are only touched from the
    # replica's asyncio loop (handle_request/stream_* all run there); the
    # class's only lock (_mux_seq_lock) exists for the mux-report threads,
    # which never touch these attrs.
    "ServeReplica._ongoing",
    "ServeReplica._total",
    "ServeReplica._streams",
    # object_store.py PlasmaClient: _evict_write_cache_locked follows the
    # "_locked" suffix convention — every caller already holds
    # _write_lock (the static checker analyzes one method at a time and
    # cannot see the callers' `with self._write_lock:` frames).
    "PlasmaClient._write_cache_bytes",
}
