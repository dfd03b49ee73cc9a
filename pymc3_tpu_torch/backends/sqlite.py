"""SQLite trace backend (cf. ``pymc3_tpu/backends/sqlite.py``, whose layout
this keeps): one table row per (chain, variable, draw) holding the value's
raw bytes, and a table of each variable's shape and dtype.

The schema does not depend on the variables' shapes, values read back bit
for bit, and ``load`` restores shapes and dtypes from the file. Writes are
buffered and committed in one transaction per block of draws. Uses only the
standard library's ``sqlite3``.
"""
from __future__ import annotations

import json
import sqlite3
from typing import Dict

import numpy as np

from ..model import modelcontext
from .base import BaseTrace, MultiTrace
from .ndarray import NDArray

__all__ = ["SQLite", "load"]

_SCHEMA = """
CREATE TABLE IF NOT EXISTS trace_vars (
    var     TEXT PRIMARY KEY,
    shape   TEXT NOT NULL,
    dtype   TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS trace_draws (
    chain   INTEGER NOT NULL,
    var     TEXT NOT NULL,
    draw    INTEGER NOT NULL,
    val     BLOB NOT NULL,
    PRIMARY KEY (chain, var, draw)
);
"""

# Writes accumulate in memory and flush in one transaction once this many
# rows are pending: per-draw transactions serialize on fsync and lock the
# database for concurrent readers.
_FLUSH_ROWS = 5000


class _Database:
    """Lazily-opened connection shared by the chain traces of one file."""

    def __init__(self, path):
        self.path = path
        self._con = None

    def cursor(self):
        if self._con is None:
            self._con = sqlite3.connect(self.path)
            self._con.executescript(_SCHEMA)
        return self._con.cursor()

    def commit(self):
        if self._con is not None:
            self._con.commit()

    def close(self):
        if self._con is not None:
            self._con.commit()
            self._con.close()
            self._con = None


class SQLite(BaseTrace):
    """On-disk trace in a SQLite file; one row per (chain, var, draw)."""

    supports_sampler_stats = False

    def __init__(self, name, model=None, vars=None, test_point=None):
        super().__init__(name, model, vars, test_point)
        self.db = _Database(name)
        self.draw_idx = 0
        self._pending = []
        self._is_setup = False
        self._len = None

    # -- sampling API --------------------------------------------------------
    def setup(self, draws, chain, sampler_vars=None):
        if sampler_vars is not None:
            raise ValueError("SQLite backend does not support sampler stats.")
        super().setup(draws, chain, sampler_vars=None)
        self.chain = chain
        cur = self.db.cursor()
        cur.executemany(
            "INSERT OR REPLACE INTO trace_vars (var, shape, dtype) "
            "VALUES (?, ?, ?)",
            [(v, json.dumps(list(self.var_shapes[v])),
              np.dtype(self.var_dtypes[v]).str)
             for v in self.varnames])
        # continue numbering after any draws already stored for this chain
        cur.execute("SELECT MAX(draw) FROM trace_draws WHERE chain = ?",
                    (chain,))
        (last,) = cur.fetchone()
        self.draw_idx = 0 if last is None else last + 1
        self.db.commit()
        self._is_setup = True

    def _enqueue(self, varname, value):
        raw = np.ascontiguousarray(
            value, dtype=self.var_dtypes[varname]).tobytes()
        self._pending.append((self.chain, varname, self.draw_idx, raw))

    def record(self, point, sampler_stats=None):
        if sampler_stats is not None:
            raise ValueError("SQLite backend does not support sampler stats.")
        for varname, value in zip(self.varnames, self._fn(point)):
            self._enqueue(varname, value)
        self.draw_idx += 1
        if len(self._pending) >= _FLUSH_ROWS:
            self._flush()

    def record_batch(self, var_values, n, stats_batch=None):
        for i in range(n):
            for varname in self.varnames:
                self._enqueue(varname, var_values[varname][i])
            self.draw_idx += 1
        self._flush()

    def _flush(self):
        if not self._pending:
            return
        cur = self.db.cursor()
        cur.executemany(
            "INSERT OR REPLACE INTO trace_draws (chain, var, draw, val) "
            "VALUES (?, ?, ?, ?)", self._pending)
        self.db.commit()
        self._pending.clear()
        self._len = None

    def close(self):
        if self._is_setup:
            self._flush()
        self.db.close()

    # -- selection -----------------------------------------------------------
    def __len__(self):
        if not self._is_setup:
            return 0
        if self._len is None:
            cur = self.db.cursor()
            cur.execute(
                "SELECT COUNT(*) FROM trace_draws WHERE chain = ? "
                "AND var = ?", (self.chain, self.varnames[0]))
            (self._len,) = cur.fetchone()
        return self._len

    def _decode(self, varname, blobs):
        dtype = np.dtype(self.var_dtypes[varname])
        shape = tuple(self.var_shapes[varname])
        if not blobs:
            return np.empty((0,) + shape, dtype)
        out = np.stack([np.frombuffer(b, dtype).reshape(shape)
                        for b in blobs])
        return out

    def get_values(self, varname, burn=0, thin=1):
        if burn < 0:
            raise ValueError("Negative burn values not supported.")
        if thin < 1:
            raise ValueError("Only positive thin values are supported.")
        varname = str(varname)
        cur = self.db.cursor()
        # the primary key streams rows back already draw-ordered; burn is
        # an OFFSET so discarded draws never leave the database, and thin
        # is a host-side stride
        cur.execute(
            "SELECT val FROM trace_draws WHERE chain = ? AND var = ? "
            "ORDER BY draw LIMIT -1 OFFSET ?",
            (self.chain, varname, burn))
        blobs = [row[0] for row in cur.fetchall()][::thin]
        return self._decode(varname, blobs)

    def point(self, idx) -> Dict[str, np.ndarray]:
        idx = int(idx)
        if idx < 0:
            idx = len(self) + idx
        cur = self.db.cursor()
        point = {}
        for varname in self.varnames:
            cur.execute(
                "SELECT val FROM trace_draws WHERE chain = ? AND var = ? "
                "ORDER BY draw LIMIT 1 OFFSET ?",
                (self.chain, varname, idx))
            row = cur.fetchone()
            if row is not None:
                point[varname] = np.frombuffer(
                    row[0], np.dtype(self.var_dtypes[varname])).reshape(
                        self.var_shapes[varname])
        return point

    def _slice(self, idx):
        nd = NDArray(model=self.model, vars=self.vars)
        nd.chain = self.chain
        nd.samples = {v: self.get_values(v) for v in self.varnames}
        nd.draw_idx = len(self)
        return nd._slice(idx)


def load(name, model=None) -> MultiTrace:
    """Restore a MultiTrace from a SQLite trace file."""
    db = _Database(name)
    cur = db.cursor()
    cur.execute("SELECT var, shape, dtype FROM trace_vars")
    meta = cur.fetchall()
    if not meta:
        raise ValueError(f"Can not get variable list for database {name}")
    cur.execute("SELECT DISTINCT chain FROM trace_draws ORDER BY chain")
    chains = [row[0] for row in cur.fetchall()]

    model = modelcontext(model)
    straces = []
    for chain in chains:
        strace = SQLite(name, model=model)
        strace.varnames = [v for v, _, _ in meta]
        strace.var_shapes = {v: tuple(json.loads(s)) for v, s, _ in meta}
        strace.var_dtypes = {v: np.dtype(d) for v, _, d in meta}
        strace.chain = chain
        strace._is_setup = True
        strace.db = db  # one shared connection across the chain traces
        straces.append(strace)
    return MultiTrace(straces)
