"""The three helpers the TPC-H plans take from ``repro.relational.queries``.

The plans finalize on the host, on the fetched numpy result; the f32
arithmetic mirrors the reference's.
"""

from __future__ import annotations

import numpy as np


def q1_finalize(partials: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    cnt = np.maximum(partials["count_order"].astype(np.float32), np.float32(1.0))
    return {
        **partials,
        "avg_qty": partials["sum_qty"] / cnt,
        "avg_price": partials["sum_base_price"] / cnt,
        "avg_disc": partials["sum_disc"] / cnt,
    }


def q14_finalize(promo_rev, total_rev):
    return np.float32(100.0) * promo_rev / np.maximum(total_rev, np.float32(1e-9))


Q19_TERMS = (
    # (brand, container_lo, container_hi, qty_lo, qty_hi, size_hi)
    (12, 0, 10, 1, 11, 5),
    (14, 10, 25, 10, 20, 10),
    (15, 25, 40, 20, 30, 15),
)


__all__ = ["q1_finalize", "q14_finalize", "Q19_TERMS"]
