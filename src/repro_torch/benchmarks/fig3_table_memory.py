"""Paper Figure 3: memoization-table memory against thread count (port of
`benchmarks/fig3_table_memory.py`).

Per-thread tables grow linearly with the number of logical threads and
exhaust a GPU's memory (the paper: 5-entry, 36-byte tables a thread).
HPAC-Offload sizes the state by resident execution slots instead; in the
port that is K3's schedule (`kernels/iact_memo.py`), whose memo table of a
block lives in shared memory and has the same size whatever the number of
rows: `schedule_smem(BLOCK_ROWS, TABLE_ENTRIES)` bytes against the
232,448 bytes of shared memory a Hopper block may use.

The machine-independent columns (`n_threads`, `per_thread_tables_bytes`)
equal the JAX rows; `check` states that comparison. The device-memory
share is taken against the card's `total_memory` when the run is on the
card, else against `H100_TOTAL_MEMORY`, read on an NVIDIA H100 80GB HBM3
(700.00 W) by `chip_smoke.py`.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig3_table_memory \\
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, List

import torch

from .. import device as device_mod
from ..kernels import iact_memo
from .fig6_best_speedup import _report

ENTRY_BYTES = 36
TABLE_ENTRIES = 5
BLOCK_ROWS = 128  # K3's resident decision slots a block (`block_rows`)
# torch.cuda.get_device_properties(0).total_memory on an NVIDIA H100 80GB
# HBM3, power limit 700.00 W (chip_smoke.py's fig3 row)
H100_TOTAL_MEMORY = 85_017_493_504


def device_memory(dev: torch.device) -> Dict:
    """The global memory the shares are taken against, and its source."""
    if dev.type == "cuda":
        return {"bytes": torch.cuda.get_device_properties(dev).total_memory,
                "of": device_mod.name(dev)}
    return {"bytes": H100_TOTAL_MEMORY,
            "of": "NVIDIA H100 80GB HBM3 (committed reading)"}


def rows(memory_bytes: int) -> List[Dict]:
    per_thread = TABLE_ENTRIES * ENTRY_BYTES
    table = iact_memo.schedule_smem(BLOCK_ROWS, TABLE_ENTRIES)
    out = []
    for log2_threads in range(16, 33, 2):
        n = 2 ** log2_threads
        out.append({
            "n_threads": n,
            "per_thread_tables_bytes": n * per_thread,
            "pct_of_device_memory": 100.0 * n * per_thread / memory_bytes,
            "block_table_bytes": table,
            "pct_of_block_smem": 100.0 * table / iact_memo._SMEM_LIMIT,
        })
    return out


def main(report: Callable[..., None] = _report, device=None) -> Dict:
    """Report and return the rows, with the memory they are shares of."""
    dev = device_mod.resolve(device)
    mem = device_memory(dev)
    out = rows(mem["bytes"])
    for r in out:
        report("fig3_table_memory",
               f"threads=2^{r['n_threads'].bit_length() - 1}",
               f"per_thread={r['pct_of_device_memory']:.1f}%GPU,"
               f"ours={r['pct_of_block_smem']:.2f}%SMEM")
    return {"memory": mem, "rows": out}


def check(result: Dict, reference: Dict) -> List[str]:
    """Where `result` departs from the JAX rows of `reference["fig3"]`:
    the same thread counts and per-thread table bytes. Returns the
    failures."""
    want = [(r["n_threads"], r["per_thread_tables_bytes"])
            for r in reference["fig3"]["rows"]]
    got = [(r["n_threads"], r["per_thread_tables_bytes"])
           for r in result["rows"]]
    return [] if got == want else [f"fig3 rows {got} vs {want}"]


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    print(json.dumps(main(device=a.device)["memory"]))
