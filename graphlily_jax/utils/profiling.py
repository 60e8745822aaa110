"""Profiling and load-balance analysis.

Counterpart of the reference's benchmark/analyze_load_balance_spmv.py (cyclic
row->PE imbalance factor) plus host-side phase timing (app/bfs.h:222-347).
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class PhaseTimer:
    """Accumulating phase timer (reference: pull_push_time_breakdown)."""

    times_ms: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        yield
        self.times_ms[name] = self.times_ms.get(name, 0.0) + (
            time.perf_counter() - t0) * 1e3

    def report(self) -> str:
        total = sum(self.times_ms.values())
        lines = [f"{k}: {v:.2f} ms" for k, v in self.times_ms.items()]
        lines.append(f"total: {total:.2f} ms")
        return "\n".join(lines)


def analyze_row_balance(csr, granularity: int = 128) -> dict:
    """Row-window nnz imbalance (reference analyze_load_balance_spmv.py:10-16
    computes max/avg over cyclic PE assignment; here over row windows)."""
    counts = np.diff(csr.adj_indptr.astype(np.int64))
    nwin = (csr.num_rows + granularity - 1) // granularity
    win = np.zeros(nwin, np.int64)
    np.add.at(win, np.arange(csr.num_rows) // granularity, counts)
    return {
        "windows": int(nwin),
        "avg_nnz": float(win.mean()),
        "max_nnz": int(win.max()),
        "imbalance_factor": float(win.max() / max(win.mean(), 1e-9)),
    }
