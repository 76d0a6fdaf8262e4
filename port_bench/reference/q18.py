"""Plain NumPy reference of TPC-H Q18's inner block, in float64: every
order's lineitem quantity sum and line count, the orders whose sum
passes the threshold, their prices from ``orders``, and the sums the
query reduces.  It imports nothing of the program.  ``bf16=True``
computes the same in bfloat16 (the quantities summed into a bfloat16
accumulator, the prices rounded to bfloat16): the lower-precision control
of a float32 configuration."""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def _bf16(x: np.ndarray) -> np.ndarray:
    """Round float64 values to the nearest bfloat16 (ties to even)."""
    f = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    r = ((f + 0x7FFF + ((f >> 16) & 1)) >> 16) << 16
    return r.astype(np.uint32).view(np.float32).astype(np.float64)


def query(shards: List[Dict[str, np.ndarray]], cfg: Dict, bf16: bool = False) -> Dict:
    okey = np.concatenate([s["o_orderkey"] for s in shards]).astype(np.int64)
    price = np.concatenate([s["o_totalprice"] for s in shards]).astype(np.float64)
    lkey = np.concatenate([s["l_orderkey"] for s in shards]).astype(np.int64)
    qty = np.concatenate([s["l_quantity"] for s in shards]).astype(np.float64)
    top = int(max(okey.max(), lkey.max())) + 1
    count = np.bincount(lkey, minlength=top)
    if bf16:
        import torch

        acc = torch.zeros(top, dtype=torch.bfloat16)
        acc.index_add_(0, torch.from_numpy(lkey), torch.from_numpy(qty).to(torch.bfloat16))
        sums = acc.double().numpy()
    else:
        sums = np.bincount(lkey, weights=qty, minlength=top)
    qual = np.nonzero(sums > cfg["having_quantity_over"])[0]
    price_of = np.zeros(top)
    price_of[okey] = _bf16(price) if bf16 else price
    sel = price_of[qual]
    total = float(_bf16(np.array([sel.sum()]))[0]) if bf16 else float(sel.sum())
    return {"o_totalprice": total, "l_quantity": float(sums[qual].sum()),
            "_count": float(count[qual].sum()), "o_orderkey": float(qual.sum()),
            "orders": int(len(qual))}
