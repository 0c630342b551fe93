"""Kernel launches since the last reset, by kernel name (the names of
ops.KERNELS). Each kernel's wrapper adds one where it launches its kernel
and nowhere else; a run reads the counts to show which kernels its path
went through."""

LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "flash_block_fwd": 0, "gmm_fwd": 0, "gmm_dw": 0}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0
