"""KeyValueDB: the metadata store abstraction (port of
ceph_tpu/kv/__init__.py).

Reference parity: KeyValueDB (the reference's src/kv/KeyValueDB.h) — a
prefix(column-family)-organized KV store with atomic write batches and
ordered iteration, backed by RocksDB in the reference.  Backends here:
MemDB (tests; reference src/kv/MemDB) and SQLiteDB (the persistent
RocksDB-role backend — sqlite3 is the battle-tested embedded KV engine in
this image; WAL-mode journaling plays RocksDB's WAL role).
"""

from __future__ import annotations

import os
import sqlite3
import threading
from typing import Dict, Iterator, List, Optional, Tuple


class Transaction:
    """A write batch: applied atomically by submit_transaction."""

    def __init__(self) -> None:
        self.ops: List[Tuple[str, str, bytes, Optional[bytes]]] = []

    def set(self, prefix: str, key: bytes, value: bytes) -> None:
        self.ops.append(("set", prefix, bytes(key), bytes(value)))

    def rmkey(self, prefix: str, key: bytes) -> None:
        self.ops.append(("rm", prefix, bytes(key), None))

    def rmkeys_by_prefix(self, prefix: str) -> None:
        self.ops.append(("rm_prefix", prefix, b"", None))

    def rm_range_keys(self, prefix: str, start: bytes, end: bytes) -> None:
        """Delete keys in [start, end)."""
        self.ops.append(("rm_range", prefix, bytes(start), bytes(end)))


class KeyValueDB:
    """Durability contract (what the crash model in os/faultstore.py
    assumes, and what SQLite WAL actually provides): batches are
    ATOMIC (never torn) and PREFIX-durable — a power cut may lose
    recently submitted batches, but only from the tail, never out of
    order.  `submit_transaction` survives process death;
    `submit_transaction_sync` is the power-cut barrier — it and every
    batch before it survive the plug being pulled.  Stores must place
    their commit point (the op that lets on_commit fire) behind the
    sync form."""

    def create_and_open(self) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def get_transaction(self) -> Transaction:
        return Transaction()

    def submit_transaction(self, t: Transaction) -> None:
        raise NotImplementedError

    def submit_transaction_sync(self, t: Transaction) -> None:
        self.submit_transaction(t)

    def get(self, prefix: str, key: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def get_iterator(self, prefix: str, start: bytes = b"",
                     end: Optional[bytes] = None
                     ) -> Iterator[Tuple[bytes, bytes]]:
        """Ordered (key, value) pairs in [start, end)."""
        raise NotImplementedError


class MemDB(KeyValueDB):
    def __init__(self) -> None:
        self._data: Dict[str, Dict[bytes, bytes]] = {}
        self._lock = threading.Lock()

    def create_and_open(self) -> None:
        pass

    def submit_transaction(self, t: Transaction) -> None:
        with self._lock:
            for op, prefix, key, value in t.ops:
                table = self._data.setdefault(prefix, {})
                if op == "set":
                    table[key] = value
                elif op == "rm":
                    table.pop(key, None)
                elif op == "rm_prefix":
                    table.clear()
                elif op == "rm_range":
                    for k in [k for k in table if key <= k < value]:
                        del table[k]

    def get(self, prefix: str, key: bytes) -> Optional[bytes]:
        with self._lock:
            return self._data.get(prefix, {}).get(bytes(key))

    def get_iterator(self, prefix: str, start: bytes = b"",
                     end: Optional[bytes] = None):
        with self._lock:
            items = sorted(self._data.get(prefix, {}).items())
        for key, value in items:
            if key < start:
                continue
            if end is not None and key >= end:
                break
            yield key, value


class SQLiteDB(KeyValueDB):
    """RocksDB-role persistent backend (WAL journaling, atomic batches)."""

    def __init__(self, path: str):
        self.path = path
        self._conn: Optional[sqlite3.Connection] = None
        self._lock = threading.Lock()

    def create_and_open(self) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._conn = sqlite3.connect(self.path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA synchronous=NORMAL")
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS kv ("
            " prefix TEXT NOT NULL, key BLOB NOT NULL, value BLOB,"
            " PRIMARY KEY (prefix, key))")
        self._conn.commit()

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def submit_transaction(self, t: Transaction) -> None:
        with self._lock:
            cur = self._conn.cursor()
            for op, prefix, key, value in t.ops:
                if op == "set":
                    cur.execute(
                        "INSERT OR REPLACE INTO kv (prefix, key, value)"
                        " VALUES (?, ?, ?)", (prefix, key, value))
                elif op == "rm":
                    cur.execute(
                        "DELETE FROM kv WHERE prefix = ? AND key = ?",
                        (prefix, key))
                elif op == "rm_prefix":
                    cur.execute("DELETE FROM kv WHERE prefix = ?",
                                (prefix,))
                elif op == "rm_range":
                    cur.execute(
                        "DELETE FROM kv WHERE prefix = ? AND key >= ?"
                        " AND key < ?", (prefix, key, value))
            self._conn.commit()

    def submit_transaction_sync(self, t: Transaction) -> None:
        """Really-durable commit: synchronous=FULL for this transaction
        so a machine crash cannot forget state a caller already
        published (the mon's Paxos-commit requirement AND TPUStore's
        transaction commit point; WAL+NORMAL only survives process
        death)."""
        with self._lock:
            self._conn.execute("PRAGMA synchronous=FULL")
            try:
                cur = self._conn.cursor()
                for op, prefix, key, value in t.ops:
                    if op == "set":
                        cur.execute(
                            "INSERT OR REPLACE INTO kv"
                            " (prefix, key, value) VALUES (?, ?, ?)",
                            (prefix, key, value))
                    elif op == "rm":
                        cur.execute(
                            "DELETE FROM kv WHERE prefix = ?"
                            " AND key = ?", (prefix, key))
                    elif op == "rm_prefix":
                        cur.execute("DELETE FROM kv WHERE prefix = ?",
                                    (prefix,))
                    elif op == "rm_range":
                        cur.execute(
                            "DELETE FROM kv WHERE prefix = ?"
                            " AND key >= ? AND key < ?",
                            (prefix, key, value))
                self._conn.commit()
            finally:
                self._conn.execute("PRAGMA synchronous=NORMAL")

    def get(self, prefix: str, key: bytes) -> Optional[bytes]:
        with self._lock:
            row = self._conn.execute(
                "SELECT value FROM kv WHERE prefix = ? AND key = ?",
                (prefix, bytes(key))).fetchone()
        return row[0] if row else None

    def get_iterator(self, prefix: str, start: bytes = b"",
                     end: Optional[bytes] = None):
        with self._lock:
            if end is None:
                rows = self._conn.execute(
                    "SELECT key, value FROM kv WHERE prefix = ? AND"
                    " key >= ? ORDER BY key", (prefix, bytes(start))
                ).fetchall()
            else:
                rows = self._conn.execute(
                    "SELECT key, value FROM kv WHERE prefix = ? AND"
                    " key >= ? AND key < ? ORDER BY key",
                    (prefix, bytes(start), bytes(end))).fetchall()
        yield from rows
