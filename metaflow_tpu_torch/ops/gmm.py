"""Grouped matrix multiply: the dropless-MoE op and its kernels K5, K6.

`y[i] = x[i] @ w[g(i)]` where the rows of x are grouped: sorted by group
and padded so that every `block_s`-row tile belongs to ONE group
(`make_group_layout`). `gmm` is a torch.autograd.Function (the JAX
package's custom_vjp): its forward and its dx are the hand-written Hopper
kernel K5 of csrc/gmm.cu (replacing the TPU kernel `_gmm_fwd_kernel`; wgmma
fed by TMA, or by cp.async where an operand is not 16-byte aligned, see
_gmm_producer; dx reads the stored weights transposed, with no transposed
copy), its dw the kernel K6 (replacing `_gmm_dw_kernel`; wgmma with the
same two producers), which sums each (group, output block) over the
group's tiles in one work item and writes w's dtype, the f32 sum rounded
once. Each kernel's plain PyTorch version
sits beside it: a CPU tensor takes the plain version, a CUDA tensor
launches the kernel or raises.

Nothing on the path reads a value back to the host: the layout is built
with scatter_add_, a stable argsort and searchsorted at static shapes, and
the kernels read the tile tables from device memory.
"""

import ctypes

import torch

from . import _build
from .launches import LAUNCHES

# The kernels' row tile, which is also the grouped layout's padding quantum.
# The block defaults the JAX package's refusals test against are the same
# 128 (its TPUFLOW_GMM_BLOCK_* defaults); K5 and K6 mask any D or F tail,
# so no other tiling is offered.
KERNEL_TILE = 128
BLOCK_S = BLOCK_F = BLOCK_D = KERNEL_TILE

# How far K5's bf16 output (y, and dx on the transposed weights) and K6's
# f32 dw may stray from their plain versions when the operands are bf16, in
# attention.flash_out_error's unit (2^-8 of the row's largest element,
# about one bf16 ulp of it). Both sides take the same bf16 products exactly
# and sum them in f32 in another order. K5 then rounds once to bf16, so a
# row differs by at most one ulp of an element; K6's f32 dw differs by the
# sums' order alone, and its bf16 dw, held to GMM_FWD_ROW_LIMIT as any
# output rounded to bf16, is its f32 dw rounded once. On an H100 the sound
# kernels read at most 1.97 (K5), 0.0050 (K6's f32 dw) and 1.77 (K6's bf16
# dw against the plain sum rounded once) at chip_smoke.py's phase-6 cases;
# faults planted in the wgmma bodies by ops/fault_check.py read 18.4 to
# 19.7 (K5 summing in bf16, at the training shapes), 261 to 7e6 (a stage
# released before its wgmma wait, a transpose bit, the group, the last k
# slice, K6 adding an inactive tile or the next group's rows) and inf (an
# inactive tile left unwritten, a phase bit not flipped: the watchdog's
# trap). Each limit sits between its kernel's sound readings and its
# weakest fault.
GMM_FWD_ROW_LIMIT = 4.0
GMM_DW_ROW_LIMIT = 0.5



def bf16_ulps(got, want):
    """|got - bf16(want)| in bf16 ulps of bf16(want), elementwise: K6's bf16
    output (got) against its plain version's f32 sum (want) rounded once.
    Both round the same f32 products summed in another order, so a sound
    kernel reads 0 or 1 (a sum that lands on the other side of a rounding
    boundary)."""
    ref = want.to(torch.bfloat16).float()
    ulp = torch.ldexp(torch.ones_like(ref), torch.frexp(ref).exponent - 8)
    return (got.float() - ref).abs() / ulp

# ---------------------------------------------------------------------------
# grouped layout: sort slots by group, pad each group to a block_s multiple
# ---------------------------------------------------------------------------


def make_group_layout(group_ids, num_groups, block_s=BLOCK_S,
                      row_valid=None):
    """Static-shape grouped layout for `gmm`.

    group_ids: [n] int, the group of each row.
    row_valid: optional [n] int/bool; rows marked 0 are padding the caller
      carries at static shape. They get layout positions after their
      group's valid rows but never mark a tile active, so the kernels skip
      them.
    Returns a dict:
      dest        [n] int64       destination row of each input row
      tile_group  [n_tiles] int32 group id of every block_s-row tile
      tile_active [n_tiles] int32 1 iff the tile holds >= 1 valid row
      padded_len  int             static total rows (multiple of block_s)

    Every group's rows land contiguously at a block_s-aligned offset, so
    each tile belongs to exactly one group; tiles past every group clamp to
    the last group and hold only zero rows.
    """
    gid = torch.as_tensor(group_ids).long()
    device, n = gid.device, gid.shape[0]
    zeros = torch.zeros(num_groups, dtype=torch.long, device=device)
    # counts by scatter_add_: torch.bincount reads its max back to the host
    counts = zeros.scatter_add(0, gid, torch.ones_like(gid))
    if row_valid is None:
        valid = torch.ones_like(gid)
        counts_valid = counts
    else:
        valid = torch.as_tensor(row_valid, device=device).long()
        counts_valid = zeros.scatter_add(0, gid, valid)
    padded = (counts + block_s - 1) // block_s * block_s
    ends = torch.cumsum(padded, 0)
    offsets = ends - padded
    # rank of each row within its group by a stable argsort; each group's
    # valid rows sort first, so they form a prefix of its tiles
    order = torch.argsort(gid * 2 + (1 - valid), stable=True)
    excl = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(gid).scatter_(
        0, order, torch.arange(n, device=device) - excl[gid[order]])
    dest = offsets[gid] + rank

    padded_len = -(-n // block_s) * block_s + num_groups * block_s
    n_tiles = padded_len // block_s
    tile_start = torch.arange(n_tiles, device=device) * block_s
    tile_group = torch.clamp(
        torch.searchsorted(ends, tile_start, right=True), max=num_groups - 1)
    tile_active = tile_start < (offsets + counts_valid)[tile_group]
    return {"dest": dest, "tile_group": tile_group.to(torch.int32),
            "tile_active": tile_active.to(torch.int32),
            "padded_len": padded_len}


def scatter_rows(rows, layout):
    """[n, D] -> padded [padded_len, D] grouped layout (zeros elsewhere)."""
    out = rows.new_zeros((layout["padded_len"], rows.shape[1]))
    return out.index_copy(0, layout["dest"], rows)


def gather_rows(padded, layout):
    return padded.index_select(0, layout["dest"])


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _live_tiles(tile_group, tile_active, g):
    return torch.nonzero((tile_active != 0) & (tile_group == g)).flatten()


def _gmm_fwd_plain(x, w, tile_group, tile_active, w_transposed=False):
    """The plain version of K5: per group, its active tiles' rows times
    w[g] (or w[g]^T) with f32 products and sums, rounded once to x's
    dtype; inactive tiles give zeros. Loops over the groups: no per-tile
    weight gather."""
    S, K = x.shape
    n_tiles = tile_group.shape[0]
    bs = S // n_tiles
    N = w.shape[1] if w_transposed else w.shape[2]
    y = torch.zeros(S, N, dtype=x.dtype, device=x.device)
    x_tiles, y_tiles = x.reshape(n_tiles, bs, K), y.view(n_tiles, bs, N)
    for g in range(w.shape[0]):
        idx = _live_tiles(tile_group, tile_active, g)
        if idx.numel() == 0:
            continue
        wg = (w[g].t() if w_transposed else w[g]).float()
        rows = x_tiles[idx].reshape(-1, K).float()
        y_tiles[idx] = (rows @ wg).to(x.dtype).reshape(-1, bs, N)
    return y


def _gmm_dw_plain(x, dy, tile_group, tile_active, num_groups,
                  out_dtype=torch.float32):
    """The plain version of K6: dw[g] = the sum over group g's active
    tiles of x[tile]^T dy[tile], f32 products and sums; a group with no
    active tile gives zeros. Returns [G, D, F] in out_dtype, the f32 sum
    rounded once."""
    S, D = x.shape
    F = dy.shape[1]
    n_tiles = tile_group.shape[0]
    bs = S // n_tiles
    dw = torch.zeros(num_groups, D, F, dtype=torch.float32, device=x.device)
    x_tiles, dy_tiles = x.reshape(n_tiles, bs, D), dy.reshape(n_tiles, bs, F)
    for g in range(num_groups):
        idx = _live_tiles(tile_group, tile_active, g)
        if idx.numel():
            dw[g] = (x_tiles[idx].reshape(-1, D).float().t()
                     @ dy_tiles[idx].reshape(-1, F).float())
    return dw.to(out_dtype)


# ---------------------------------------------------------------------------
# K5, K6 on the card
# ---------------------------------------------------------------------------


def _tile_tables(x, tile_group, tile_active):
    """tile_group and tile_active as contiguous int32 on x's device, one
    entry per KERNEL_TILE rows of x; raises on what the kernels do not
    take."""
    S = x.shape[0]
    if S % KERNEL_TILE or tile_group.shape != (S // KERNEL_TILE,) or \
            tile_active.shape != tile_group.shape:
        raise ValueError(
            "gmm kernel: x needs S %% %d == 0 rows and one tile_group and "
            "tile_active entry per %d rows (S=%d, tiles %s, %s)"
            % (KERNEL_TILE, KERNEL_TILE, S, tuple(tile_group.shape),
               tuple(tile_active.shape)))
    return tuple(t.to(device=x.device, dtype=torch.int32).contiguous()
                 for t in (tile_group, tile_active))


def _check_operands(named, dtype, device):
    for name, t in named:
        if t.device != device or t.device.type != "cuda":
            raise ValueError("gmm kernel: %s must be a CUDA tensor on %s, "
                             "got %s" % (name, device, t.device))
        if t.dtype != dtype:
            raise ValueError("gmm kernel: operand dtypes differ (%s)"
                             % ", ".join("%s %s" % (n, u.dtype)
                                         for n, u in named))
        if t.stride(-1) != 1:
            raise ValueError("gmm kernel: %s's last dim must be contiguous"
                             % name)
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("gmm kernel takes bfloat16 or float32, got %s"
                         % dtype)


def _gmm_producer(*operands):
    """Which producer K5 (operands x, w) or K6 (x, dy) runs in bf16: "tma"
    when TMA tensor maps can describe every operand (base addresses
    16-byte aligned, every stride but the last a multiple of 16 bytes),
    else "cp_async", which copies the same stages with cp.async and element
    by element at the ragged edge. Decided from pointers and strides alone,
    the same for w as stored or transposed."""
    aligned = all(t.data_ptr() % 16 == 0
                  and all(st * t.element_size() % 16 == 0
                          for st in t.stride()[:-1])
                  for t in operands)
    return "tma" if aligned else "cp_async"


def _gmm_fwd_cuda(x, w, tile_group, tile_active, w_transposed=False):
    """Launch K5 on the card. Same contract as _gmm_fwd_plain."""
    _check_operands((("x", x), ("w", w)), x.dtype, x.device)
    S, K = x.shape
    G, A, B = w.shape
    N, Kw = (A, B) if w_transposed else (B, A)
    if Kw != K:
        raise ValueError("gmm kernel: x %s and w %s (transposed=%s) do not "
                         "multiply" % (tuple(x.shape), tuple(w.shape),
                                       w_transposed))
    tg, ta = _tile_tables(x, tile_group, tile_active)
    y = torch.empty(S, N, dtype=x.dtype, device=x.device)
    fn = _build.load("gmm").gmm_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), tg.data_ptr(),
             ta.data_ptr(), S, K, N, G, x.stride(0), y.stride(0), w.stride(0),
             w.stride(1), int(bool(w_transposed)),
             int(_gmm_producer(x, w) == "tma"),
             1 if x.dtype == torch.bfloat16 else 0, _build.device_index(x),
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError("gmm_fwd kernel launch failed: CUDA error %d"
                           % err)
    LAUNCHES["gmm_fwd"] += 1
    return y


def _gmm_dw_cuda(x, dy, tile_group, tile_active, num_groups,
                 out_dtype=torch.float32):
    """Launch K6 on the card. Same contract as _gmm_dw_plain; a bf16
    out_dtype needs bf16 operands."""
    _check_operands((("x", x), ("dy", dy)), x.dtype, x.device)
    S, D = x.shape
    F = dy.shape[1]
    if dy.shape[0] != S:
        raise ValueError("gmm kernel: x %s and dy %s differ in rows"
                         % (tuple(x.shape), tuple(dy.shape)))
    if out_dtype not in (torch.float32, x.dtype):
        raise ValueError("gmm_dw kernel writes float32 or the operands' "
                         "dtype, not %s" % out_dtype)
    lib = _build.load("gmm")
    if x.dtype == torch.bfloat16 and num_groups > lib.gmm_dw_max_groups():
        raise ValueError("gmm_dw kernel ranks at most %d groups, got %d"
                         % (lib.gmm_dw_max_groups(), num_groups))
    tg, ta = _tile_tables(x, tile_group, tile_active)
    dw = torch.empty(num_groups, D, F, dtype=out_dtype, device=x.device)
    fn = lib.gmm_dw
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    err = fn(x.data_ptr(), dy.data_ptr(), dw.data_ptr(), tg.data_ptr(),
             ta.data_ptr(), S, D, F, num_groups, x.stride(0), dy.stride(0),
             int(_gmm_producer(x, dy) == "tma"),
             int(out_dtype == torch.bfloat16),
             1 if x.dtype == torch.bfloat16 else 0, _build.device_index(x),
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError("gmm_dw kernel launch failed: CUDA error %d"
                           % err)
    LAUNCHES["gmm_dw"] += 1
    return dw


def _gmm_fwd(x, w, tile_group, tile_active, w_transposed=False):
    """K5: a CPU tensor takes the plain version; any other device launches
    the kernel or raises."""
    if x.device.type == "cpu":
        return _gmm_fwd_plain(x, w, tile_group, tile_active, w_transposed)
    return _gmm_fwd_cuda(x, w, tile_group, tile_active, w_transposed)


def _gmm_dw(x, dy, tile_group, tile_active, num_groups,
            out_dtype=torch.float32):
    """K6, dispatched as _gmm_fwd is."""
    if x.device.type == "cpu":
        return _gmm_dw_plain(x, dy, tile_group, tile_active, num_groups,
                             out_dtype)
    return _gmm_dw_cuda(x, dy, tile_group, tile_active, num_groups,
                        out_dtype)


# ---------------------------------------------------------------------------
# public op with its gradient
# ---------------------------------------------------------------------------


class _GroupedMatmul(torch.autograd.Function):
    """gmm with its gradient, as the JAX package's custom_vjp: the forward
    (K5) saves x, w and the tile tables; the backward runs K5 on the
    output gradient against w[g]^T for dx and K6 for dw in w's dtype, its
    f32 sum rounded once (the JAX backward's cast of its f32 dw). K6
    writes zeros for a group with no active tile, which the JAX backward
    gets from its `visited` mask."""

    @staticmethod
    def forward(ctx, x, w, tile_group, tile_active):
        ctx.save_for_backward(x, w, tile_group, tile_active)
        return _gmm_fwd(x, w, tile_group, tile_active)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, w, tile_group, tile_active = ctx.saved_tensors
        if dy.stride(-1) != 1:  # the kernels read rows with a unit stride
            dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _gmm_fwd(dy, w, tile_group, tile_active,
                          w_transposed=True).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = _gmm_dw(x, dy, tile_group, tile_active, w.shape[0],
                         out_dtype=w.dtype)
        return dx, dw, None, None


def gmm(x, w, tile_group, *, tile_active=None, block_s=BLOCK_S,
        block_f=BLOCK_F):
    """y[i·bs:(i+1)·bs] = x[i·bs:(i+1)·bs] @ w[tile_group[i]].

    x: [S, D] grouped and padded rows (S % block_s == 0, make_group_layout);
    w: [G, D, F]; tile_group: [S // block_s] int, non-decreasing (as
    make_group_layout builds it); tile_active: [S // block_s] int, tiles
    marked 0 hold only padding and skip their products in the forward, dx
    and dw. None treats every tile as active.

    tile_active, block_s and block_f are keyword-only, as in the JAX
    package: a stale positional caller `gmm(x, w, tg, 64)` gets a
    TypeError instead of having 64 taken as the tile mask. On the card the
    row tile is KERNEL_TILE and block_s must equal it.
    """
    if tile_active is None:
        tile_active = torch.ones_like(tile_group)
    _check_bwd_blocks(w, block_f)
    S, F = x.shape[0], w.shape[2]
    bf = min(block_f, F)
    if S % block_s or F % bf:
        raise ValueError(
            "gmm needs S %% block_s == 0 and F %% block_f == 0 "
            "(S=%d bs=%d, F=%d bf=%d)" % (S, block_s, F, bf))
    if x.device.type != "cpu" and block_s != KERNEL_TILE:
        raise ValueError("the gmm kernels tile rows by %d; got block_s=%d"
                         % (KERNEL_TILE, block_s))
    return _GroupedMatmul.apply(x, w, tile_group, tile_active)


def _check_bwd_blocks(w, block_f):
    """The backward tiles D as a feature dim (dx) and as a reduced dim
    (dw); misconfigured shapes fail at forward time, not when gradients
    are first taken (the JAX package's refusals)."""
    D = w.shape[1]
    if D % min(block_f, D):
        raise ValueError(
            "gmm needs D %% min(block_f, D) == 0 (D=%d, block_f=%d): the "
            "dx backward kernel tiles D with that block" % (D, block_f))
    if D % min(BLOCK_D, D):
        raise ValueError(
            "gmm needs D %% min(%d, D) == 0 (D=%d): the dw backward "
            "kernel tiles D with that block" % (BLOCK_D, D))
