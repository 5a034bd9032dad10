"""Roofline terms on the card (port of ``repro.launch.roofline``, whose
constants are a TPU's):

  compute term    = FLOPs / (chips × peak FLOP/s)
  memory term     = HBM bytes / (chips × HBM bytes/s)
  collective term = collective bytes / (chips × link bytes/s)

The peaks are the data sheet's dense rates (no sparsity), looked up by the
card's name as ``torch.cuda.get_device_name`` gives it (``peaks_for``); a
card the table does not know raises, there is no default. H100 SXM: 989e12
FLOP/s in bf16, 67e12 in fp32, 3.35e12 B/s of HBM3 and 900 GB/s of NVLink.
The NVLink figure counts both directions together; the collective term
divides by ONE direction (``Peaks.link_bytes_per_s``, 450 GB/s), since its
bytes are those each chip sends under the ring algorithms of
``launch.analytic`` (a chip receives as much at the same time, over the
other direction).

A card may run below its data sheet under a power limit below the maximum
(700 W for the H100 SXM): keep ``card_line()`` (``nvidia-smi``'s name and
power limit) beside every share of peak; ``RooflineTerms.card`` carries it.

Where the JAX package reads collective traffic out of XLA's HLO text
(``parse_collectives``), the port counts the collectives DTensor issues
while a step runs (``collective_counter``), with the same per-chip ring
formulas (``ring_traffic``) into the same ``CollectiveStats``:

  all-gather       result_bytes · (g-1)/g          per chip
  reduce-scatter   input_bytes  · (g-1)/g  = result·(g-1)
  all-reduce       2 · bytes · (g-1)/g             (RS + AG)
  all-to-all       bytes · (g-1)/g
  collective-permute  bytes
"""
from __future__ import annotations

import subprocess
import sys
from dataclasses import dataclass, field
from typing import Dict


@dataclass(frozen=True)
class Peaks:
    name: str                     # the data sheet's product
    flops: Dict[str, float]       # dense FLOP/s by dtype name
    hbm_bytes_per_s: float
    nvlink_bytes_per_s: float     # both directions together (data sheet)

    @property
    def link_bytes_per_s(self) -> float:
        """NVLink bytes/s in one direction: what the collective term divides
        by."""
        return self.nvlink_bytes_per_s / 2


H100_SXM = Peaks("H100 SXM", {"bfloat16": 989e12, "float32": 67e12},
                 hbm_bytes_per_s=3.35e12, nvlink_bytes_per_s=900e9)

# (substring of torch.cuda.get_device_name, peaks); the H100 SXM5 reports
# itself as "NVIDIA H100 80GB HBM3"
_BY_NAME = (("H100 80GB HBM3", H100_SXM), ("H100 SXM", H100_SXM))


def peaks_for(device_name: str) -> Peaks:
    """The data sheet's peaks of the card named `device_name`; raises
    KeyError for a card the table does not hold."""
    for key, peaks in _BY_NAME:
        if key in device_name:
            return peaks
    raise KeyError(f"no data-sheet peaks for the card {device_name!r} "
                   f"(have {[k for k, _ in _BY_NAME]})")


def device_peaks(index: int = 0) -> Peaks:
    """The peaks of CUDA device `index`."""
    import torch
    return peaks_for(torch.cuda.get_device_name(index))


def card_line(index: int = 0) -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``'s
    line for device `index`: the card and its power limit."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[index]


def share_of_peak(flops: float, seconds: float, peaks: Peaks,
                  dtype: str = "bfloat16") -> float:
    """flops done in `seconds` as a share of the card's dense peak."""
    return flops / seconds / peaks.flops[dtype]


@dataclass
class CollectiveStats:
    """Collective bytes a chip moves in one step, in all and by kind
    ("all-gather", "reduce-scatter", "all-reduce", "all-to-all", ...), and
    the number of collectives of each kind."""
    per_op: Dict[str, float] = field(default_factory=dict)   # kind -> bytes/chip
    count: Dict[str, int] = field(default_factory=dict)
    total_per_chip: float = 0.0

    def add(self, kind: str, traffic: float):
        self.per_op[kind] = self.per_op.get(kind, 0.0) + traffic
        self.count[kind] = self.count.get(kind, 0) + 1
        self.total_per_chip += traffic


def ring_traffic(kind: str, bytes_: float, g: int) -> float:
    """Bytes one chip sends for a collective over a group of `g` under the
    ring algorithms; `bytes_` is the result's size (the whole tensor for an
    all-gather, one shard for a reduce-scatter), as in the HLO the JAX
    package parses."""
    ring = (g - 1) / g
    if kind == "all-gather":
        return bytes_ * ring
    if kind == "reduce-scatter":
        return bytes_ * (g - 1)
    if kind == "all-reduce":
        return 2 * bytes_ * ring
    if kind == "all-to-all":
        return bytes_ * ring
    return bytes_                                  # collective-permute


# DTensor's collectives: (namespace, op) -> kind
_KINDS = {
    ("_c10d_functional", "all_gather_into_tensor"): "all-gather",
    ("_c10d_functional", "reduce_scatter_tensor"): "reduce-scatter",
    ("_c10d_functional", "all_reduce"): "all-reduce",
    ("_c10d_functional", "all_to_all_single"): "all-to-all",
    ("_dtensor", "shard_dim_alltoall"): "all-to-all",
}


def _group_size(group_name) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(group_name).size()


def _in_cpu_alltoall() -> bool:
    """True inside DTensor's ``shard_dim_alltoall`` (called by a frame of
    the stack): on a "cpu" mesh it runs an all-to-all as an all-gather and
    a chunk, since gloo has no all-to-all."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name == "shard_dim_alltoall":
            return True
        f = f.f_back
    return False


def collective_counter():
    """A ``TorchDispatchMode`` whose ``stats`` (``CollectiveStats``) count
    every collective DTensor issues inside it, by kind, with its per-chip
    ring traffic (``ring_traffic``) from its bytes and group size;
    ``records`` keeps (kind, result bytes, group size) of each. It counts
    what DTensor asks for, whatever the mesh's device type: an all-to-all
    that a "cpu" mesh runs as an all-gather and a chunk counts as the
    all-to-all. Ops on DTensors pass through: the mode defers to DTensor,
    then sees the collectives it issues on the local tensors (as torch's
    ``CommDebugMode`` does)."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    class CollectiveCounter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.stats = CollectiveStats()
            self.records = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if isinstance(func, torch._ops.HigherOrderOperator):
                return func(*args, **kwargs)
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            kind = _KINDS.get((getattr(func, "namespace", ""),
                               getattr(func, "_opname", "")))
            if kind is not None:
                self._record(kind, args)
            return func(*args, **kwargs)

        def _record(self, kind, args):
            x = args[0]
            nbytes = x.numel() * x.element_size()
            if kind == "all-gather":
                g = int(args[1])
                if _in_cpu_alltoall():
                    kind = "all-to-all"          # its result is x's size
                else:
                    nbytes *= g                  # the gathered result
            elif kind == "reduce-scatter":
                g = int(args[2])
                nbytes //= g                     # the shard
            else:
                g = _group_size(args[-1])
            if g > 1:
                self.records.append((kind, nbytes, g))
                self.stats.add(kind, ring_traffic(kind, nbytes, g))

    return CollectiveCounter()


@dataclass
class RooflineTerms:
    flops: float
    bytes_accessed: float
    collective_bytes: float          # total across chips (per formula)
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_ratio: float
    card: str = ""                   # name and power limit of the card

    def as_dict(self) -> Dict:
        return dict(flops=self.flops, bytes_accessed=self.bytes_accessed,
                    collective_bytes=self.collective_bytes, chips=self.chips,
                    compute_s=self.compute_s, memory_s=self.memory_s,
                    collective_s=self.collective_s, dominant=self.dominant,
                    model_flops=self.model_flops,
                    useful_ratio=self.useful_ratio, card=self.card)


def roofline(cost: Dict, coll: CollectiveStats, chips: int,
             model_flops: float, *, peaks: Peaks, dtype: str = "bfloat16",
             card: str = "") -> RooflineTerms:
    """The three terms of one step on cards of `peaks` (``device_peaks()``,
    or ``peaks_for(name)`` for another card). `cost` is per device
    ({"flops", "bytes accessed"}: e.g. ``analytic_terms``' totals over
    `chips`); it is scaled to the whole step so that the terms divide back by
    `chips` uniformly, as in the JAX package. `card`: ``card_line()`` of the
    run the terms describe."""
    flops = float(cost.get("flops", 0.0)) * chips
    bytes_accessed = float(cost.get("bytes accessed", 0.0)) * chips
    coll_total = coll.total_per_chip * chips
    compute_s = flops / (chips * peaks.flops[dtype])
    memory_s = bytes_accessed / (chips * peaks.hbm_bytes_per_s)
    collective_s = coll_total / (chips * peaks.link_bytes_per_s)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    return RooflineTerms(
        flops=flops, bytes_accessed=bytes_accessed,
        collective_bytes=coll_total, chips=chips, compute_s=compute_s,
        memory_s=memory_s, collective_s=collective_s, dominant=dominant,
        model_flops=model_flops,
        useful_ratio=(model_flops / flops) if flops else 0.0, card=card)


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference), N = active params."""
    N = cfg.active_param_count()
    if shape.kind == "train":
        D = shape.global_batch * shape.seq_len
        return 6.0 * N * D
    if shape.kind == "prefill":
        D = shape.global_batch * shape.seq_len
        return 2.0 * N * D
    D = shape.global_batch                     # decode: one token per row
    return 2.0 * N * D
