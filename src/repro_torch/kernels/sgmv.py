"""SGMV — the batched multi-LoRA delta, the rollout hot spot of multi-tenant
serving (paper §4.5; port of ``repro.kernels.sgmv``).

Two entry points share one CUDA kernel (``csrc/sgmv.cu``), one launch a call:

- ``sgmv(rows, a, b, ids)`` returns ``y[i] = rows[i] @ a[ids[i]] @ b[ids[i]]``
  in fp32, as the TPU kernel does;
- ``sgmv_add_(y, rows, a, b, table, scaling)`` adds ``scaling`` times that
  product, rounded to ``rows.dtype``, to ``y`` in place: what
  ``y + (scaling * sgmv(...)).to(rows.dtype)`` gives, to the bit. The
  batched ``LoraCtx`` calls it for every adapted projection.

Rows are grouped by adapter slot through a segment table (``sgmv_table``),
which the batched ``LoraCtx`` builds once a forward on the card;
``sgmv_plan`` cuts the work into row tiles, column tiles and clusters. For
tensors on the CPU both entry points run their plain versions (``sgmv_ref``,
``sgmv_add_ref`` in ``kernels/ref.py``). A CUDA tensor the kernel does not
take raises, and so does a card call whose operands autograd tracks: the
kernel has no backward.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build
from .boundary import is_dtensor, on_replicas, plain
from .ref import sgmv_add_ref, sgmv_ref

__all__ = ["sgmv", "sgmv_add_", "sgmv_ref", "sgmv_add_ref", "sgmv_plan",
           "sgmv_table", "SgmvPlan", "SgmvTable", "check_adapters", "RANKS",
           "LAUNCHES", "CUDA_LAUNCHES"]

_X_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
RANKS = (4, 8, 16, 32)        # the kernel's instantiations (csrc/sgmv.cu)
# mirrors of csrc/sgmv.cu's constants
_THREADS, _STAGES, _MAX_CLUSTER = 256, 4, 8
_MAX_KC = 128                 # d elements of a ring stage, at most
_ROW_TILES = (16, 32, 64)
_COL_TILES = (1024, 512, 256, 128, 64)
_MAX_B_TILE = 64 * 1024       # bytes of a block's B tile, at most
_TILE_BLOCKS = 16             # column tiles a row tile aims for
_WAVE = 132                   # an H100's SMs
_TWO_A_SM = 113 * 1024        # shared memory of a block that leaves room for two
_MAX_GRID_Y = 65535

# calls that launched the kernel, and the CUDA kernels those calls launched
# (as the C launcher counts them: one a call)
LAUNCHES = _build.LaunchCount()
CUDA_LAUNCHES = _build.LaunchCount()


class SgmvPlan(NamedTuple):
    """How one call cuts its work (see ``sgmv_plan``)."""
    bm: int             # rows of one adapter a row tile holds
    bn: int             # dout columns a block owns
    kc: int             # d elements of one stage of the shrink's ring
    cluster: int        # blocks sharing one row tile's shrink
    row_tiles: int      # the grid's static bound on row tiles
    col_groups: int     # clusters a row tile takes, side by side along dout
    grid: tuple         # (col_groups * cluster, row_tiles)
    smem_bytes: int     # dynamic shared memory a block


class SgmvTable(NamedTuple):
    """Rows grouped by adapter slot, built on the card (``sgmv_table``)."""
    ids: torch.Tensor       # [R] int32, each row's slot
    order: torch.Tensor     # [R] int32, the rows in stable order of slot
    tmap: torch.Tensor      # [row_tiles, bm + 2] int32: per row tile its slot
                            # (-1: no rows), its live rows, then the rows:
                            # slot u's rows order[seg[u]:seg[u + 1]] cut into
                            # tiles of bm, its tiles after those of slots < u
    slots: int              # T
    bm: int                 # rows a row tile holds


def ring_stages(dc: int, kc: int) -> int:
    """Stages of the shrink's ring (csrc/sgmv.cu::ring_stages): _STAGES, or
    as many as the d slice has chunks when fewer."""
    return max(1, min(_STAGES, -(-dc // kc)))


def smem_bytes(bm: int, bn: int, kc: int, stages: int, r: int, x_bytes: int,
               cluster: int) -> int:
    """Dynamic shared memory of one block (csrc/sgmv.cu::layout): the B
    tile, the ring of x and A chunks, the cluster's partials of h, the
    merged h, and the shares' sums."""
    pairs = bm * (r // 4)
    return (r * bn * 4 + stages * bm * (kc * x_bytes + 16)
            + stages * kc * r * 4 + (cluster + 1) * pairs * 16
            + max(pairs, _THREADS) * 16)


def row_tile(R: int, T: int) -> int:
    """BM: the smallest row tile that holds an adapter's mean share of the
    rows (16 in decode), at most 64."""
    share = -(-R // max(T, 1))
    return next((bm for bm in _ROW_TILES if share <= bm), _ROW_TILES[-1])


def row_tiles(R: int, T: int, bm: int) -> int:
    """The static bound on live row tiles: sum over slots of
    ceil(rows / bm) <= R // bm + (slots with rows) <= R // bm + min(T, R)."""
    return R // bm + min(T, R)


def cluster_for(tiles_n: int) -> int:
    """Blocks a cluster: the largest divisor of the column tiles in 2..8 (no
    block without columns), else as many as the tiles allow, at least 2."""
    for c in range(_MAX_CLUSTER, 1, -1):
        if tiles_n % c == 0:
            return c
    return max(2, min(_MAX_CLUSTER, tiles_n))


def _stage(bm, bn, r, x_bytes, cluster, dc):
    """KC: the whole d slice in one chunk (one stage, one load round trip)
    where two blocks still share a SM; else the least multiple of 16 that
    takes it in _STAGES - 1 chunks (all issued before the first is waited
    for), at most _MAX_KC, halved (to a multiple of 16, at least 16) while
    two blocks would not share a SM."""
    kc = max(16, -(-dc // 16) * 16)
    if smem_bytes(bm, bn, kc, 1, r, x_bytes, cluster) <= _TWO_A_SM:
        return kc
    kc = min(_MAX_KC, max(16, -(-dc // (_STAGES - 1) // 16) * 16))
    while kc > 16 and smem_bytes(bm, bn, kc, ring_stages(dc, kc), r, x_bytes,
                                 cluster) > _TWO_A_SM:
        kc = max(16, kc // 32 * 16)
    return kc


@functools.lru_cache(maxsize=None)
def sgmv_plan(R: int, T: int, d: int, dout: int, *, r: int = 16,
              x_bytes: int = 2) -> SgmvPlan:
    """BM from the rows an adapter holds on average. BN: about
    _TILE_BLOCKS column tiles a row tile (a power of two, 64 up to a B tile
    of 64 KB), doubled while the live row tiles expected (min(T, R) when an
    adapter's rows fit one tile) would need more than two blocks a SM. C:
    BN's column tiles' largest divisor up to 8; KC from C's d slices.
    Depends on static shapes only. (chip_smoke.py phase 3 prints each
    case's plan; the choices come from sweeps of BN and C on the card,
    PERF.md.)"""
    bm = row_tile(R, T)
    tiles_m = row_tiles(R, T, bm)
    if tiles_m > _MAX_GRID_Y:
        raise ValueError(f"sgmv: {R} rows need {tiles_m} row tiles, more than "
                         f"the grid's {_MAX_GRID_Y}")
    live = min(T, R) if -(-R // max(T, 1)) <= bm else -(-R // bm)
    bn_max = min(_COL_TILES[0], _MAX_B_TILE // (4 * r))
    bn = _COL_TILES[-1]
    while bn < bn_max and bn * 2 * _TILE_BLOCKS <= dout:
        bn *= 2

    def blocks(bn):
        tiles_n = -(-dout // bn)
        c = cluster_for(tiles_n)
        return c, -(-tiles_n // c)

    c, groups = blocks(bn)
    while bn < bn_max and bn < dout and live * c * groups > 2 * _WAVE:
        bn *= 2
        c, groups = blocks(bn)
    dc = slice_of(d, c)
    kc = _stage(bm, bn, r, x_bytes, c, dc)
    return SgmvPlan(bm, bn, kc, c, tiles_m, groups, (groups * c, tiles_m),
                    smem_bytes(bm, bn, kc, ring_stages(dc, kc), r, x_bytes, c))


def slice_of(d: int, cluster: int) -> int:
    """The d elements one cluster rank reduces (csrc/sgmv.cu's dc): d / C
    rounded up to a multiple of 8."""
    return (-(-d // cluster) + 7) // 8 * 8


def sgmv_table(ids, T: int, S: int = 1) -> SgmvTable:
    """The segment table of per-sequence slot ids [B] with S rows each (row
    b * S + s belongs to sequence b), for adapters of T slots. Built on the
    ids' device with torch ops and no host sync; ids must lie in [0, T)."""
    ids = ids.to(torch.int32)
    if S > 1:
        ids = ids[:, None].expand(-1, S).reshape(-1)
    R = ids.shape[0]
    bm = row_tile(R, T)
    srt, order = torch.sort(ids, stable=True)
    order = order.to(torch.int32)
    seg = torch.searchsorted(srt, torch.arange(T + 1, dtype=torch.int32,
                                               device=ids.device),
                             out_int32=True)
    count = seg[1:] - seg[:-1]
    per = torch.div(count + (bm - 1), bm, rounding_mode="floor")
    tiles = torch.cumsum(torch.cat((seg[:1] * 0, per)), 0, dtype=torch.int32)
    # each sorted row's tile and lane: its rank within its slot, cut by bm
    srt_l = srt.long()
    k = torch.arange(R, device=ids.device, dtype=torch.int32) - seg[srt_l]
    tile = (tiles[srt_l] + torch.div(k, bm, rounding_mode="floor")).long()
    lane = k % bm
    tmap = torch.full((row_tiles(R, T, bm), bm + 2), -1, dtype=torch.int32,
                      device=ids.device)
    tmap[tile, 0] = srt
    tmap[tile, 1] = torch.clamp(count[srt_l] - (k - lane), max=bm)
    tmap[tile, (lane + 2).long()] = order
    return SgmvTable(ids, order, tmap, T, bm)


def check_adapters(a, b):
    """The adapters the kernel takes: float32 a [..., T, d, r] and b [..., T,
    r, dout] (a stacked tree's leaves, or one layer's), contiguous and
    16-byte aligned, r in RANKS, d % 8 == 0, dout % 4 == 0. Every layer
    slice of a stacked leaf is then aligned too."""
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"sgmv: adapters must be float32, got {a.dtype}, "
                         f"{b.dtype}")
    if a.dim() < 3 or a.dim() != b.dim() or a.shape[:-2] != b.shape[:-2] \
            or a.shape[-1] != b.shape[-2]:
        raise ValueError(f"sgmv: adapters a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)} do not fit [..., T, d, r] / "
                         f"[..., T, r, dout]")
    d, r, dout = a.shape[-2], a.shape[-1], b.shape[-1]
    if r not in RANKS or d % 8 or dout % 4:
        raise ValueError(f"sgmv: rank {r} (takes {RANKS}), d {d} (a multiple "
                         f"of 8) and dout {dout} (a multiple of 4)")
    for name, t in (("a", a), ("b", b)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"sgmv: {name} must be contiguous and 16-byte "
                             f"aligned")
    if a.device != b.device:
        raise ValueError("sgmv: a and b must share the card")


def _refuse_grad(*ts):
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError("sgmv: the CUDA kernel has no backward; call it "
                           "under torch.no_grad() or inference_mode(), or on "
                           "the CPU, where the plain version differentiates")


def _check_call(out, rows, a, b, table):
    """What changes from call to call, in attribute reads only (168 calls a
    forward): the rows [..., d] and the output [..., dout] against the
    adapters' shapes and the table. Returns (R, the card's index, the rows'
    and the output's addresses)."""
    if rows.dtype not in _X_DTYPE_CODE:
        raise ValueError(f"sgmv: rows dtype {rows.dtype}; the kernel takes "
                         f"float32 or bfloat16")
    T, d, _ = a.shape
    dout = b.shape[2]
    R = table.order.shape[0]
    if rows.shape[-1] != d or out.shape[-1] != dout or rows.numel() != R * d \
            or out.numel() != R * dout or table.slots != T:
        raise ValueError(f"sgmv: rows {tuple(rows.shape)}, out "
                         f"{tuple(out.shape)}, table of {R} rows and "
                         f"{table.slots} slots do not fit a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}")
    x_ptr, out_ptr = rows.data_ptr(), out.data_ptr()
    if not (rows.is_contiguous() and out.is_contiguous()) \
            or x_ptr % 16 or out_ptr % 16:
        raise ValueError("sgmv: rows and out must be contiguous and 16-byte "
                         "aligned")
    dev = a.get_device()
    if rows.get_device() != dev or out.get_device() != dev \
            or table.tmap.get_device() != dev:
        raise ValueError("sgmv: rows, out, adapters and table must share the "
                         "card")
    return R, dev, x_ptr, out_ptr


@functools.lru_cache(maxsize=None)
def _plan_args(R, T, d, r, dout, x_bytes):
    """The launcher's shape arguments, per shape (the hot path's lookup)."""
    p = sgmv_plan(R, T, d, dout, r=r, x_bytes=x_bytes)
    return (R, d, r, dout), (p.bm, p.bn, p.kc, p.cluster, p.row_tiles)


def _launch(rows, a, b, table, scaling, add, checked):
    """One launch; `checked` is _check_call's result for these operands."""
    R, dev, x_ptr, out_ptr = checked
    T, d, r = a.shape
    shape, plan = _plan_args(R, T, d, r, b.shape[2], rows.element_size())
    launched = ctypes.c_int(0)
    err = _build.library("sgmv").sgmv_launch(
        x_ptr, a.data_ptr(), b.data_ptr(), table.tmap.data_ptr(), out_ptr,
        *shape, _X_DTYPE_CODE[rows.dtype], int(add), float(scaling), *plan,
        torch._C._cuda_getCurrentRawStream(dev), ctypes.addressof(launched))
    CUDA_LAUNCHES.add(launched.value)
    _build.check(err, "sgmv")
    LAUNCHES.add(1)


def sgmv(rows, a, b, ids, *, table: SgmvTable = None):
    """rows: [R, d]; a: [T, d, r]; b: [T, r, dout]; ids: [R] in [0, T) (or
    `table`, ids' segment table, already built). Returns [R, dout] float32.
    DTensors on the card go through ``boundary.on_replicas``."""
    if plain(rows):
        return sgmv_ref(rows, a, b, ids if table is None else table.ids)
    if is_dtensor(rows):
        return on_replicas(sgmv, rows, a, b, ids, table=table)
    if not rows.is_cuda:
        raise ValueError(f"sgmv: no kernel for device {rows.device}")
    _refuse_grad(rows, a, b)
    check_adapters(a, b)
    if a.dim() != 3 or rows.dim() != 2:
        raise ValueError(f"sgmv: rows {tuple(rows.shape)}, a {tuple(a.shape)} "
                         f"are not [R, d], [T, d, r]")
    if table is None:
        if ids.dtype not in (torch.int32, torch.int64) or ids.shape != rows.shape[:1]:
            raise ValueError(f"sgmv: ids {ids.dtype} {tuple(ids.shape)} are not "
                             f"[R] integers")
        table = sgmv_table(ids, a.shape[0])
    out = torch.empty((rows.shape[0], b.shape[2]), dtype=torch.float32,
                      device=rows.device)
    _launch(rows, a, b, table, 1.0, False, _check_call(out, rows, a, b, table))
    return out


def sgmv_add_(y, rows, a, b, table: SgmvTable, scaling: float, *,
              checked: bool = False):
    # step: the LoRA delta; tensors=y,rows,a,b
    """y += (scaling * rows @ a[id] @ b[id]).to(rows.dtype), in place, for
    rows [..., d] and y [..., dout] in rows' dtype holding the table's R
    rows; `table` from ``sgmv_table``. `checked`: the caller has passed a
    and b (or their stacked leaves) through ``check_adapters``, as the
    batched ``LoraCtx`` does once a forward. Allocates nothing. Returns y.
    DTensors on the card go through ``boundary.on_replicas``: the add is
    then made in y's replica, so use the returned DTensor (y's own storage
    only where y was replicated already)."""
    if plain(rows):
        return sgmv_add_ref(y, rows, a, b, table.ids, scaling)
    if is_dtensor(rows):
        return on_replicas(sgmv_add_, y, rows, a, b, table, scaling,
                           checked=checked)
    if not rows.is_cuda:
        raise ValueError(f"sgmv_add_: no kernel for device {rows.device}")
    _refuse_grad(y, rows, a, b)
    if not checked:
        check_adapters(a, b)
    if a.dim() != 3 or y.dtype != rows.dtype:
        raise ValueError(f"sgmv_add_: a {tuple(a.shape)} is not [T, d, r], or "
                         f"y's dtype {y.dtype} is not the rows' {rows.dtype}")
    _launch(rows, a, b, table, scaling, True, _check_call(y, rows, a, b, table))
    return y
