"""Batched multi-LoRA application (paper §4.5): one forward pass serves rows
belonging to *different* tenants, each with its own adapter (port of
``repro.lora.multilora``).

`multi_lora_delta` computes   y[i] += s · (x[i] @ A[g_i]) @ B[g_i]
for per-row task ids g. Two code paths, chosen by where the tensors lie:

- on the card: the hand-written SGMV kernel (kernels/sgmv), rows grouped
  by adapter through a segment table;
- on the CPU: ``multi_lora_delta_ref``, masked accumulation over tasks —
  O(T) dense matmuls, exact, the oracle the tests hold the port to.

The model's projections do not call it on the card: the batched
``LoraCtx`` adds the delta into the projection's output in place
(``kernels.sgmv.sgmv_add_``), one launch a projection.

``AdapterResidency`` (a copy of the JAX package's, plain Python) maps
tenants to the slots of a fixed-capacity stacked-LoRA buffer, LRU.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.kernels.boundary import is_dtensor, on_replicas, plain
from repro_torch.kernels.sgmv import sgmv, sgmv_table


def multi_lora_delta(x, a, b, row_task_ids, scaling: float):
    """x: [B, d] or [B, S, d]; a: [T, d, r]; b: [T, r, dout]; ids: [B]."""
    if plain(x):
        return multi_lora_delta_ref(x, a, b, row_task_ids, scaling)
    if is_dtensor(x):
        return on_replicas(multi_lora_delta, x, a, b, row_task_ids, scaling)
    x3 = x[:, None, :] if x.dim() == 2 else x
    B, S, d = x3.shape
    table = sgmv_table(row_task_ids, a.shape[0], S)
    out = sgmv(x3.reshape(B * S, d).contiguous(), a, b, table.ids,
               table=table)
    out = out.reshape(B, S, -1) * scaling
    return (out[:, 0] if x.dim() == 2 else out).to(x.dtype)


def multi_lora_delta_ref(x, a, b, row_task_ids, scaling: float):
    """Masked-accumulation oracle. Exact; O(T) matmuls."""
    T = a.shape[0]
    xf = x.float()
    out = None
    for t in range(T):
        h = (xf @ a[t].float()) @ b[t].float()
        mask = (row_task_ids == t).float()
        mask = mask.reshape(mask.shape + (1,) * (x.dim() - 1))
        contrib = h * mask
        out = contrib if out is None else out + contrib
    return (out * scaling).to(x.dtype)


def sort_rows_by_task(row_task_ids, num_tasks: int):
    """Stable sort order of the rows by task, and int32 offsets [T + 1]:
    the rows of task t are ``order[offsets[t]:offsets[t + 1]]``."""
    order = torch.sort(row_task_ids, stable=True).indices
    counts = torch.bincount(row_task_ids, minlength=num_tasks)[:num_tasks]
    offsets = torch.zeros(num_tasks + 1, dtype=torch.int32,
                          device=row_task_ids.device)
    offsets[1:] = torch.cumsum(counts, 0)
    return order, offsets


class AdapterResidency:
    """LRU tenant→slot map over a fixed-capacity stacked-LoRA buffer.

    The buffer itself lives wherever `install_fn(slot, tree)` writes it
    (the continuous engine's `set_adapters`, a plain buffer in tests).
    `acquire` returns the tenant's slot, installing on miss — evicting the
    least-recently-used tenant for which `in_use(tenant)` is False when the
    buffer is full. Tenants with rows resident or queued in the engine must
    be reported in-use by the caller, so queued requests never decode under
    a foreign adapter. Returns None when every slot is pinned (caller backs
    off and retries as rows complete)."""

    def __init__(self, capacity: int,
                 install_fn: Callable[[int, object], None],
                 on_evict: Optional[Callable[[str, int], None]] = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.install_fn = install_fn
        self.on_evict = on_evict
        self._slot_of: Dict[str, int] = {}
        self._last_use: Dict[str, int] = {}     # tenant -> logical use time
        self._free = list(range(capacity))
        self._tick = 0
        self.installs = 0
        self.evictions = 0
        self.hits = 0

    def __contains__(self, tenant: str) -> bool:
        return tenant in self._slot_of

    def slot_of(self, tenant: str) -> Optional[int]:
        return self._slot_of.get(tenant)

    def resident(self) -> Dict[str, int]:
        return dict(self._slot_of)

    def touch(self, tenant: str):
        if tenant in self._slot_of:
            self._tick += 1
            self._last_use[tenant] = self._tick

    def evict(self, tenant: str) -> Optional[int]:
        """Explicitly drop a tenant (e.g. task finished); returns its slot."""
        slot = self._slot_of.pop(tenant, None)
        if slot is None:
            return None
        self._last_use.pop(tenant, None)
        self._free.append(slot)
        self.evictions += 1
        if self.on_evict:
            self.on_evict(tenant, slot)
        return slot

    def acquire(self, tenant: str, tree,
                in_use: Callable[[str], bool] = lambda t: False
                ) -> Optional[int]:
        if tenant in self._slot_of:
            self.hits += 1
            self.touch(tenant)
            return self._slot_of[tenant]
        if self._free:
            slot = self._free.pop(0)
        else:
            # LRU among evictable tenants; tie-break on name (deterministic)
            victims = sorted(
                (t for t in self._slot_of if not in_use(t)),
                key=lambda t: (self._last_use.get(t, 0), t))
            if not victims:
                return None
            slot = self.evict(victims[0])
            self._free.remove(slot)
        self._slot_of[tenant] = slot
        self.touch(tenant)
        self.install_fn(slot, tree)
        self.installs += 1
        return slot
