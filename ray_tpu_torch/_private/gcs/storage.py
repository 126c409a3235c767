"""Port of ``ray_tpu/_private/gcs/storage.py``.

GCS storage backends: the StoreClient seam.

Counterpart of the reference's pluggable GCS persistence (reference:
src/ray/gcs/store_client/store_client.h:33 StoreClient,
in_memory_store_client.h:31, redis_store_client.h:33).  Two backends:

- InMemoryStoreClient — default; state dies with the process (reference
  default when GCS FT is off).
- SqliteStoreClient  — file-backed, transactional; enables GCS restart
  fault tolerance without an external Redis (the reference's RedisStoreClient
  role).  sqlite in WAL mode: single-writer (the GCS event loop) with
  millisecond commits for the small control-plane records written here.

Tables are logical namespaces over one physical (table, key, value) relation.
Values are opaque bytes: callers serialize (GCS uses pickle for rich records,
raw bytes for KV).
"""

from __future__ import annotations

import logging
import os
import sqlite3
import threading
import time
from typing import Dict, Iterator, Optional, Tuple

logger = logging.getLogger(__name__)


class StoreClient:
    """Interface (reference: store_client.h:33 — AsyncPut/AsyncGet/
    AsyncGetAll/AsyncDelete condensed to sync calls; the GCS event loop is
    the single writer and records are tiny)."""

    persistent = False

    def put(self, table: str, key: str, value: bytes) -> None:
        raise NotImplementedError

    def get(self, table: str, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def get_all(self, table: str) -> Dict[str, bytes]:
        raise NotImplementedError

    def delete(self, table: str, key: str) -> None:
        raise NotImplementedError

    def delete_all(self, table: str) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class InMemoryStoreClient(StoreClient):
    def __init__(self):
        self._tables: Dict[str, Dict[str, bytes]] = {}

    def put(self, table: str, key: str, value: bytes) -> None:
        self._tables.setdefault(table, {})[key] = value

    def get(self, table: str, key: str) -> Optional[bytes]:
        return self._tables.get(table, {}).get(key)

    def get_all(self, table: str) -> Dict[str, bytes]:
        return dict(self._tables.get(table, {}))

    def delete(self, table: str, key: str) -> None:
        self._tables.get(table, {}).pop(key, None)

    def delete_all(self, table: str) -> None:
        self._tables.pop(table, None)


class SqliteStoreClient(StoreClient):
    """Writes are handed to a dedicated writer thread: every put/delete is
    called from GCS asyncio handlers, and a synchronous WAL commit on the
    event loop would stall heartbeats under actor/kv churn.  The queue keeps
    write ORDER; reads happen only at boot (before any writes) and in tests,
    so they just drain the queue first."""

    persistent = True

    def __init__(self, path: str):
        import queue

        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._path = path
        self._lock = threading.Lock()
        # Flipped on the first write failure: the cluster keeps running, but
        # FT restore may be stale — health endpoints surface this.
        self.degraded = False
        self._last_error_log = 0.0
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA synchronous=NORMAL")
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS gcs (tbl TEXT NOT NULL, "
            "key TEXT NOT NULL, value BLOB NOT NULL, "
            "PRIMARY KEY (tbl, key))")
        self._conn.commit()
        self._queue: "queue.Queue" = queue.Queue()
        self._writer = threading.Thread(target=self._write_loop, daemon=True,
                                        name="gcs-store-writer")
        self._writer.start()

    # ------------------------------------------------------------ writer
    def _write_loop(self):
        while True:
            op = self._queue.get()
            if op is None:
                self._queue.task_done()
                return
            try:
                with self._lock:
                    self._conn.execute(*op)
                    # coalesce: commit once per drained burst
                    if self._queue.empty():
                        self._conn.commit()
            except sqlite3.Error as e:
                # Persistence must never take down the control plane, but a
                # silent stop (disk full, corrupt WAL) would let a later GCS
                # restart restore stale state with no prior warning.
                self.degraded = True
                now = time.monotonic()
                if now - self._last_error_log > 10.0:
                    self._last_error_log = now
                    logger.error(
                        "GCS persistence write failed (%s): durability is "
                        "degraded; a restart may restore stale state", e)
            finally:
                self._queue.task_done()

    def _drain(self):
        self._queue.join()
        with self._lock:
            self._conn.commit()

    def put(self, table: str, key: str, value: bytes) -> None:
        self._queue.put((
            "INSERT INTO gcs (tbl, key, value) VALUES (?, ?, ?) "
            "ON CONFLICT (tbl, key) DO UPDATE SET value = excluded.value",
            (table, key, sqlite3.Binary(value))))

    def get(self, table: str, key: str) -> Optional[bytes]:
        self._drain()
        with self._lock:
            row = self._conn.execute(
                "SELECT value FROM gcs WHERE tbl = ? AND key = ?",
                (table, key)).fetchone()
        return bytes(row[0]) if row else None

    def get_all(self, table: str) -> Dict[str, bytes]:
        self._drain()
        with self._lock:
            rows = self._conn.execute(
                "SELECT key, value FROM gcs WHERE tbl = ?", (table,)).fetchall()
        return {k: bytes(v) for k, v in rows}

    def delete(self, table: str, key: str) -> None:
        self._queue.put((
            "DELETE FROM gcs WHERE tbl = ? AND key = ?", (table, key)))

    def delete_all(self, table: str) -> None:
        self._queue.put(("DELETE FROM gcs WHERE tbl = ?", (table,)))

    def close(self) -> None:
        self._drain()
        self._queue.put(None)
        self._writer.join(timeout=5)
        with self._lock:
            self._conn.commit()
            self._conn.close()


def make_store(path: Optional[str]) -> StoreClient:
    if path:
        return SqliteStoreClient(path)
    return InMemoryStoreClient()
