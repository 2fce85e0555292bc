"""Kernels and their plain PyTorch versions."""


def kernel_wrappers() -> dict:
    """The wrappers of the hand-written kernels by name; each counts the
    launches of its kernel in ``launches`` (the sweeps: one per wrapper
    call)."""
    from .cd_sweep import cd_sweep, cd_sweep_eager, cd_sweep_large, cd_sweep_v3
    from .densify import densify, densify_bf16
    from .gather import gather
    from .pack import pack

    return {"densify": densify, "densify_bf16": densify_bf16,
            "cd_sweep": cd_sweep,
            "cd_sweep_large": cd_sweep_large, "cd_sweep_v3": cd_sweep_v3,
            "cd_sweep_eager": cd_sweep_eager, "pack": pack,
            "gather": gather}
