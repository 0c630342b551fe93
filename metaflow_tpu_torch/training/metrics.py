"""Training-step arithmetic: FLOPs per token and the card's peak rate, the
two halves of MFU. Per-step telemetry (`instrument_train_step`) waits for
the `train.step` record of the training-telemetry slice."""

from .. import knobs

# dense bf16 peak TFLOP/s per card, from NVIDIA's data sheets (SXM parts),
# substring-matched against torch.cuda.get_device_name
GPU_PEAK_TFLOPS = [
    ("h100", 989.0),
    ("h200", 989.0),
]


def peak_tflops(device_kind):
    """Published dense bf16 peak TFLOP/s for a card's name, or None.

    TPUFLOW_PEAK_TFLOPS overrides the table when it is set and parses, as
    in the JAX package; an empty or unparsable value falls through."""
    override = knobs.get_raw("TPUFLOW_PEAK_TFLOPS")
    if override:
        try:
            return float(override)
        except ValueError:
            pass
    kind = (device_kind or "").lower()
    return next((tf for sub, tf in GPU_PEAK_TFLOPS if sub in kind), None)


def flops_per_token_dense(n_params, n_layers, dim, seq):
    """Train-step FLOPs/token for a dense transformer (fwd+bwd = 3x fwd):
    6*N + 12*L*D*S, the PaLM appendix-B convention. Recomputation under
    remat is not counted, as MFU does not count it."""
    return 6.0 * n_params + 12.0 * n_layers * dim * seq
