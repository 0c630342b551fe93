"""The float32-output product of bf16 operands, with its gradient.

The JAX package computes its logits (and its MoE oracle's expert products)
as bf16 x bf16 einsums with preferred_element_type=float32. The models and
the MoE op share this one port of it.
"""

import torch


class _MatmulBF16F32(torch.autograd.Function):
    """bf16 a [N, K] @ bf16 b [K, M] with float32 products, sums and result
    on the card (torch.mm with out_dtype, which autograd cannot
    differentiate). The gradients are the JAX package's transpose of its
    bf16 x bf16 -> f32 einsum as XLA on a TPU computes it at default
    precision: the f32 cotangent enters the products rounded to bf16, the
    sums are f32, and each gradient is cast to bf16."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(torch.bfloat16)
        return g @ b.t(), a.t() @ g


def matmul_f32(a, b):
    """a @ b with float32 products and sums and a float32 result (the JAX
    package's preferred_element_type=float32 on bf16 operands). On the card
    a bf16 product writes float32 directly; elsewhere the operands are cast
    up first."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16 and b.ndim == 2:
        out = _MatmulBF16F32.apply(a.reshape(-1, a.shape[-1]), b)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    return torch.matmul(a.float(), b.float())
