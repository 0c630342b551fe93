"""Attention: the plain PyTorch path and the flash kernels K1, K2, K3, K4.

`attention(q, k, v, causal=..., impl='auto')` takes [B, S, H, D] queries
and [B, S, KV, D] keys/values (KV may divide H). The flash path is a
torch.autograd.Function (the JAX package's custom_vjp): its forward is the
hand-written Hopper kernel K1 of csrc/flash_fwd.cu (replacing the TPU kernel
`_flash_fwd_kernel`), its backward the kernels K2 (dq) and K3 (dk, dv) of
csrc/flash_bwd.cu (replacing `_flash_bwd_dq_kernel` and
`_flash_bwd_dkv_kernel`), which recompute the probabilities from the saved
lse. `flash_block_fwd` and `flash_block_bwd` are one ring-attention hop's
forward and backward (ops/ring_attention.py): the forward is the kernel K4
of csrc/flash_fwd.cu (replacing `_flash_block_fwd_kernel`), K1's loop
without the normalization, the backward K2 and K3 given the global lse.
Each kernel's plain PyTorch version sits beside it: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises.
"""

import ctypes
import math

import torch

from .. import knobs
from . import _build
from .launches import LAUNCHES

BLOCK_Q = knobs.get_int("TPUFLOW_FLASH_BLOCK_Q")
BLOCK_K = knobs.get_int("TPUFLOW_FLASH_BLOCK_K")
NEG_INF = -1e30
FLASH_HEAD_DIMS = (64, 128)


def _broadcast_gqa(k, num_q_heads):
    """[B, S, Hkv, D] -> [B, S, Hq, D] by repeating kv heads."""
    num_kv = k.shape[-2]
    if num_kv == num_q_heads:
        return k
    return k.repeat_interleave(num_q_heads // num_kv, dim=-2)


def reference_attention(q, k, v, causal=True, scale=None):
    """Plain attention in [B, S, H, D] layout: f32 scores, softmax, the
    probabilities rounded to the input dtype before the P.V product."""
    B, Sq, H, D = q.shape
    k = _broadcast_gqa(k, H)
    v = _broadcast_gqa(v, H)
    scale = scale or (1.0 / math.sqrt(D))
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        Sk = k.shape[1]
        mask = torch.ones(Sq, Sk, dtype=torch.bool,
                          device=q.device).tril(Sk - Sq)
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


# ---------------------------------------------------------------------------
# K1: flash forward
# ---------------------------------------------------------------------------


def _flash_forward_plain(q, k, v, causal, scale):
    """The plain version of K1: the same function in one pass over the
    whole key range. f32 scores scaled after the product, unnormalized
    probabilities rounded to the input dtype before P.V, the sum in f32
    divided by the f32 denominator. Returns (out [B, S, H, D] in q's dtype,
    lse [B*H, S] f32)."""
    B, S, H, D = q.shape
    k = _broadcast_gqa(k, H)
    v = _broadcast_gqa(v, H)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    out = (acc / l).to(q.dtype).transpose(1, 2)
    lse = (m + torch.log(l)).reshape(B * H, S)
    return out, lse


# How far K1's bf16 output may stray from its plain version, in units of
# 2^-8 max|O_row| (half to one bf16 ulp of the row's largest element): each
# side rounds O to bf16 once (up to one ulp apart), and each rounds the
# probabilities to bf16 at its own running max, errors that average out over
# the row's keys. A row is held to its own magnitude, so late causal rows,
# whose |O| is a fraction of max|v|, are held as tightly as early ones. On
# an H100 the sound kernel reads at most 2.0 (chip_smoke.py's shapes and
# every layer of the Llama-3-8B forward, for the first mma.sync body and
# the wgmma one alike); faults planted in the wgmma body by
# ops/fault_check.py flash_fwd read 6.3 to 8.2 (the probabilities at 4
# mantissa bits), 462 to 632 (the diagonal mask dropped) and inf (a phase
# bit not flipped: the watchdog's trap).
FLASH_BF16_ROW_LIMIT = 4.0

# How far K1's lse may stray from its plain version's, in
# flash_stats_error's unit: both are f32 sums over up to S keys in another
# order (the kernel's in log2 units, converted once), so within S * 2^-24
# of the largest |lse|. On an H100 the sound kernel reads at most 0.0097
# at phase 1's cases; the faults read 11.6 (p at 4 mantissa bits) and
# more.
FLASH_LSE_LIMIT = 1.0


def flash_out_error(out, ref):
    """The largest row error of `out` against `ref` ([..., D] alike):
    max_d |out - ref| over 2^-8 max_d |ref| + 1e-6, maximised over rows.
    The bf16 check of K1 holds it to FLASH_BF16_ROW_LIMIT."""
    diff = (out.float() - ref.float()).abs().amax(dim=-1)
    unit = 2.0 ** -8 * ref.float().abs().amax(dim=-1) + 1e-6
    return (diff / unit).max().item()


def _check_kernel_inputs(q, k, v, g=None):
    """Raise on what the flash kernels do not take: q (and g, the output
    gradient) [B, S, H, D] and k, v [B, S, KV, D] CUDA tensors of one dtype
    (bf16 or f32) and device, head dim 64 or 128, last dim contiguous, bf16
    rows 16-byte aligned."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    named = [("q", q), ("k", k), ("v", v)] + ([("g", g)] if g is not None
                                              else [])
    for name, t in named:
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError("flash kernel: %s must be a CUDA tensor on %s, "
                             "got %s" % (name, q.device, t.device))
        if t.dtype != q.dtype:
            raise ValueError("flash kernel: q, k, v dtypes differ")
        if t.stride(-1) != 1:
            raise ValueError("flash kernel: %s's last dim must be "
                             "contiguous" % name)
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("flash kernel takes bfloat16 or float32, got %s"
                         % q.dtype)
    if D not in FLASH_HEAD_DIMS:
        raise ValueError("flash kernel supports head dims %s, got %d"
                         % (FLASH_HEAD_DIMS, D))
    if (k.shape != (B, S, KV, D) or v.shape != k.shape or H % KV
            or B * H > 65535 or (g is not None and g.shape != q.shape)):
        raise ValueError("flash kernel: bad shapes q %s k %s v %s"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if q.dtype == torch.bfloat16:
        # TMA (K1) and 16-byte async copies (K2-K4): every row must start
        # 16-byte aligned
        for name, t in named:
            if not _rows_aligned(t):
                raise ValueError("flash kernel: %s rows are not 16-byte "
                                 "aligned" % name)


def _rows_aligned(t):
    return t.data_ptr() % 16 == 0 and all(st % 8 == 0
                                          for st in t.stride()[:3])


def _flash_forward_cuda(q, k, v, causal, scale):
    """Launch K1 on the card. Same contract as _flash_forward_plain."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    _check_kernel_inputs(q, k, v)
    lib = _build.load("flash_fwd")
    fn = lib.flash_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    out = torch.empty(B, S, H, D, dtype=q.dtype, device=q.device)
    lse = torch.empty(B * H, S, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), B, S, H, KV, D,
             1 if q.dtype == torch.bfloat16 else 0,
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             *out.stride()[:3], float(scale), int(bool(causal)),
             _build.device_index(q), stream)
    if err != 0:
        raise RuntimeError("flash_fwd kernel launch failed: CUDA error %d"
                           % err)
    LAUNCHES["flash_fwd"] += 1
    return out, lse


def _flash_forward(q, k, v, causal, scale):
    """K1 on q [B, S, H, D], k/v [B, S, KV, D]. Returns (out, lse [B*H, S]
    f32). A CPU tensor takes the plain version; any other device launches
    the kernel or raises."""
    if q.device.type == "cpu":
        return _flash_forward_plain(q, k, v, causal, scale)
    return _flash_forward_cuda(q, k, v, causal, scale)


# ---------------------------------------------------------------------------
# K4: one ring hop's flash forward, unnormalized
# ---------------------------------------------------------------------------


def _flash_block_fwd_plain(q, k, v, scale, causal_diag):
    """The plain version of K4: K1's plain version without the
    normalization. f32 scores scaled after the product, probabilities
    rounded to the input dtype before P.V, f32 sums. Returns (acc
    [B, S, H, D] f32, m and l [B*H, S] f32) with m the row max in
    natural-log units and l = sum exp(s - m)."""
    B, S, H, D = q.shape
    k = _broadcast_gqa(k, H)
    v = _broadcast_gqa(v, H)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal_diag:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return acc, m.reshape(B * H, S), l.reshape(B * H, S)


# How far K4's output may stray from its plain version: acc / l (the hop's
# own normalized output) in flash_out_error's unit, as K1's O, and m and
# lse = m + log l in flash_stats_error's. acc / l is held as K1's O is: the
# two sides round the probabilities to bf16 at different running maxima.
# m is a max of f32 scores (the kernel keeps it in log2 units and converts
# once), lse an f32 sum over up to S keys, so both are held to
# flash_stats_error's f32 rounding unit. On an H100 the sound kernel reads
# at most 1.22 on acc / l and 0.021 on m and lse (chip_smoke.py's phase-8a
# cases); faults planted by ops/fault_check.py flash_block_fwd read 7.6
# (the probabilities at 4 mantissa bits) to 722 on acc / l, and 105 (the
# same fault's lse) to 7e4 on m or lse (m left in log2 units: 2.9e4).
FLASH_BLOCK_ROW_LIMIT = 4.0
FLASH_BLOCK_STATS_LIMIT = 1.0


def flash_stats_error(got, want):
    """max |got - want| of a [B*H, S] row statistic (m or lse) over
    S * 2^-24 * max|want| + 1e-6: the f32 rounding of a sum over S terms
    of that size. K1's lse check uses the same unit."""
    S = want.shape[-1]
    unit = S * 2.0 ** -24 * want.abs().max().item() + 1e-6
    return (got - want).abs().max().item() / unit


def per_row(stat, B, H):
    """A [B*H, S] row statistic as [B, S, H, 1], to scale [B, S, H, D]."""
    return stat.reshape(B, H, -1).transpose(1, 2).unsqueeze(-1)


def flash_block_output(acc, l):
    """acc / l: a K4 output's (or merged ring sums') normalized attention
    output, f32 [B, S, H, D]."""
    B, _, H, _ = acc.shape
    return acc / per_row(l, B, H)


def flash_block_readings(acc, m, l, ref):
    """K4's output (acc, m, l) against its plain version's (ref): {'acc':
    acc / l in flash_out_error's unit, 'm', 'lse': flash_stats_error}."""
    ref_acc, ref_m, ref_l = ref
    return {"acc": flash_out_error(flash_block_output(acc, l),
                                   flash_block_output(ref_acc, ref_l)),
            "m": flash_stats_error(m, ref_m),
            "lse": flash_stats_error(m + torch.log(l),
                                     ref_m + torch.log(ref_l))}


def _flash_block_fwd_cuda(q, k, v, scale, causal_diag):
    """Launch K4 on the card. Same contract as _flash_block_fwd_plain."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    _check_kernel_inputs(q, k, v)
    lib = _build.load("flash_fwd")
    fn = lib.flash_block_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    acc = torch.empty(B, S, H, D, dtype=torch.float32, device=q.device)
    m = torch.empty(B * H, S, dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), acc.data_ptr(),
             m.data_ptr(), l.data_ptr(), B, S, H, KV, D,
             1 if q.dtype == torch.bfloat16 else 0,
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             *acc.stride()[:3], float(scale), int(bool(causal_diag)),
             _build.device_index(q), stream)
    if err != 0:
        raise RuntimeError("flash_block_fwd kernel launch failed: CUDA "
                           "error %d" % err)
    LAUNCHES["flash_block_fwd"] += 1
    return acc, m, l


def flash_block_fwd(q, k, v, scale, causal_diag):
    """One ring hop's unnormalized contribution: q [B, S, H, D], k, v
    [B, S, KV, D] (a shard each; views of the whole sequence are read in
    place). Returns (acc [B, S, H, D] f32, m [B*H, S] f32 in natural-log
    units, l [B*H, S] f32). causal_diag=True is the same-shard diagonal
    mask, False lets every key count. A CPU tensor takes the plain version;
    any other device launches K4 or raises."""
    _check_blocks(q.shape[1])
    if q.shape[2] % k.shape[2]:
        raise ValueError("kv heads (%d) must divide q heads (%d)"
                         % (k.shape[2], q.shape[2]))
    if q.device.type == "cpu":
        return _flash_block_fwd_plain(q, k, v, scale, causal_diag)
    return _flash_block_fwd_cuda(q, k, v, scale, causal_diag)


# ---------------------------------------------------------------------------
# K2, K3: flash backward
# ---------------------------------------------------------------------------


def _flash_block_bwd_plain(q, k, v, g, lse, delta, scale, causal):
    """The plain version of K2 and K3: the same function in one pass over
    the whole key range, with the kernels' rounding points. f32 scores
    scaled after the product, P = exp(s - lse), dP = dO V^T in f32,
    dS = P (dP - delta) scale rounded to the input dtype before dS K and
    dS^T q, P rounded to the input dtype before P^T dO, sums in f32, the
    GQA group summed in f32. Returns f32 (dq [B, S, H, D], dk and dv
    [B, S, KV, D])."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    kr = _broadcast_gqa(k, H).float()
    vr = _broadcast_gqa(v, H).float()
    qf, gf = q.float(), g.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kr) * scale
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - lse.reshape(B, H, S, 1))
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vr)
    ds = (p * (dp - delta.reshape(B, H, S, 1)) * scale).to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype).float(), gf)
    group = (B, S, KV, H // KV, D)
    return dq, dk.reshape(group).sum(3), dv.reshape(group).sum(3)


# How far K2's dq and K3's dk, dv (f32, as flash_block_bwd returns them)
# may stray from their plain version, in flash_out_error's unit, 2^-8 of
# the row's largest element. Both round dS and P to bf16 at the same
# points, so they differ by the f32 sums' order and exp2 against exp, and
# by the bf16 roundings of dS and P that those flip: one flip moves a row
# by half to one ulp of a term, which is most of the row in the early
# causal rows that sum a few keys. On an H100 the sound kernels read at
# most 1.98 for K2 and 0.73 for K3's wgmma body (chip_smoke.py's phase-4
# shapes; under 0.01 inside the bench_1b training step); faults planted
# by ops/fault_check.py read 8.8 (P at 4 mantissa bits in K3) and 11.2
# (dS at 4 mantissa bits in K2) up to 8e8 (K2's causal mask dropped) and
# inf (K3's phase bit not flipped: the watchdog's trap).
FLASH_BWD_ROW_LIMIT = 4.0


def _kernel_layout(t):
    """t itself when the flash kernels can read it in place (last dim
    contiguous, rows 16-byte aligned), else a contiguous copy. The output
    gradient reaching the backward may be any view (an expanded or sliced
    one), and the kernels read only such rows."""
    if t.stride(-1) == 1 and _rows_aligned(t):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _launch_bwd(name, q, k, v, g, lse, delta, scale, causal, outs):
    """Launch K2 (name 'flash_bwd_dq', outs (dq,)) or K3 ('flash_bwd_dkv',
    outs (dk, dv)) into the f32 outputs `outs`."""
    _check_kernel_inputs(q, k, v, g)
    B, S, H, D = q.shape
    KV = k.shape[2]
    for label, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or t.device != q.device
                or tuple(t.shape) != (B * H, S) or not t.is_contiguous()):
            raise ValueError("flash kernel: %s must be contiguous float32 "
                             "[B*H, S] on %s" % (label, q.device))
    lib = _build.load("flash_bwd")
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 15
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), outs[0].data_ptr(),
             outs[-1].data_ptr(), B, S, H, KV, D,
             1 if q.dtype == torch.bfloat16 else 0,
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             *g.stride()[:3], *outs[0].stride()[:3], float(scale),
             int(bool(causal)), _build.device_index(q), stream)
    if err != 0:
        raise RuntimeError("%s kernel launch failed: CUDA error %d"
                           % (name, err))
    LAUNCHES[name] += 1


def _flash_bwd_dq_cuda(q, k, v, g, lse, delta, scale, causal):
    """Launch K2 on the card: f32 dq [B, S, H, D]."""
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _launch_bwd("flash_bwd_dq", q, k, v, g, lse, delta, scale, causal, (dq,))
    return dq


def _flash_bwd_dkv_cuda(q, k, v, g, lse, delta, scale, causal):
    """Launch K3 on the card: f32 dk, dv [B, S, KV, D]."""
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty_like(dk)
    _launch_bwd("flash_bwd_dkv", q, k, v, g, lse, delta, scale, causal,
                (dk, dv))
    return dk, dv


def flash_block_bwd(q, k, v, g, lse, delta, scale, causal):
    """The flash backward given lse and delta = rowsum(dO * O) ([B*H, S]
    f32): q, g (the output gradient) [B, S, H, D], k, v [B, S, KV, D].
    Returns f32 (dq, dk, dv) with dk, dv summed over each kv head's GQA
    group. The seam ring attention reuses with the global lse and delta.
    A CPU tensor takes the plain version; any other device launches K2 and
    K3 or raises."""
    if q.device.type == "cpu":
        return _flash_block_bwd_plain(q, k, v, g, lse, delta, scale, causal)
    dq = _flash_bwd_dq_cuda(q, k, v, g, lse, delta, scale, causal)
    dk, dv = _flash_bwd_dkv_cuda(q, k, v, g, lse, delta, scale, causal)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The flash path with its gradient, as the JAX package's custom_vjp:
    the forward (K1) saves q, k, v, O and lse; the backward computes
    delta = rowsum(dO * O) in f32 from the O it returned, then runs K2 and
    K3 and casts their f32 gradients to the input dtype once."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, interpret):
        fwd = _flash_forward_plain if interpret else _flash_forward
        out, lse = fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.interpret = causal, scale, interpret
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        B, S, H, _ = q.shape
        delta = (g.float() * out.float()).sum(-1).transpose(1, 2).reshape(
            B * H, S).contiguous()
        if ctx.interpret:
            bwd = _flash_block_bwd_plain
        else:
            bwd = flash_block_bwd
            if g.is_cuda:
                g = _kernel_layout(g)
        dq, dk, dv = bwd(q, k, v, g, lse, delta, ctx.scale, ctx.causal)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def flash_attention(q, k, v, causal=True, scale=None, interpret=False):
    """Flash attention with its gradient; q,k,v: [B, S, H, D] (kv heads
    may be fewer). `interpret=True` runs the kernels' plain versions on any
    device, as the JAX package's interpret mode runs its kernels off the
    chip.

    Requires S to satisfy blocks_aligned (the `attention` dispatcher takes
    the plain path otherwise)."""
    B, S, H, D = q.shape
    _check_blocks(S)
    if H % k.shape[2]:
        raise ValueError("kv heads (%d) must divide q heads (%d)"
                         % (k.shape[2], H))
    scale = scale or (1.0 / math.sqrt(D))
    return _FlashAttention.apply(q, k, v, causal, scale, interpret)


def blocks_aligned(S):
    """True when seq len S satisfies the flash contract with the effective
    block sizes: S divisible by both blocks and mutual block divisibility.
    One predicate for the dispatcher and the kernel wrapper."""
    bq, bk = min(BLOCK_Q, S), min(BLOCK_K, S)
    return (S % bq == 0 and S % bk == 0
            and (bq % bk == 0 or bk % bq == 0))


def _check_blocks(S):
    """Effective (block_q, block_k) for seq len S; raises on a
    blocks_aligned violation rather than dropping the sequence tail."""
    block_q = min(BLOCK_Q, S)
    block_k = min(BLOCK_K, S)
    if not blocks_aligned(S):
        if S % block_q or S % block_k:
            raise ValueError(
                "flash block kernels require seq len divisible by the "
                "%d/%d block sizes (got %d); use the xla impl or pad the "
                "sequence" % (BLOCK_Q, BLOCK_K, S))
        raise ValueError(
            "flash attention block sizes must divide one another (got "
            "q=%d, k=%d via TPUFLOW_FLASH_BLOCK_Q/K)" % (block_q, block_k))
    return block_q, block_k


def attention(q, k, v, causal=True, scale=None, impl="auto"):
    """Dispatch: the flash kernel on a CUDA tensor whose shape meets the
    flash contract, the plain path otherwise (as the JAX package takes its
    XLA path off the TPU)."""
    if impl == "auto":
        S, D = q.shape[1], q.shape[3]
        aligned = blocks_aligned(S) and D % 128 == 0
        impl = "flash" if (q.is_cuda and aligned) else "xla"
    if impl == "flash":
        return flash_attention(q, k, v, causal=causal, scale=scale)
    if impl == "flash_interpret":
        return flash_attention(q, k, v, causal=causal, scale=scale,
                               interpret=True)
    return reference_attention(q, k, v, causal=causal, scale=scale)

