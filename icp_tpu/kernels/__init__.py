"""GPU kernels of the hot path: Pallas through Triton.

Two searches keep their score tensors in registers instead of device
memory; everything around them is plain XLA (``icp_tpu.rbc``):

* :mod:`icp_tpu.kernels.rep_assign` — nearest representative per query
  plus per-bin counts (phase 1 of the fused RBC search).
* :mod:`icp_tpu.kernels.bin_nn` — per-bin exhaustive search returning
  each query's best slot and score (phase 2).

Each kernel has a plain-XLA twin with the same contract beside its caller.
:func:`on_gpu` picks between them per LOWERING platform, so a program
traced on one host and lowered for another still gets the right variant:
the kernel where the platform is CUDA, the twin elsewhere (the CPU is the
test platform). :func:`kernel_mode` overrides that choice while a function
is traced: "interpret" runs the kernel in the Pallas interpreter off the
GPU (how the CPU tests check kernel against twin), "xla" runs the twin
everywhere (how the card compares the two end to end).
"""

from __future__ import annotations

import contextlib
import functools

import jax

_MODES = ("auto", "interpret", "xla")
_mode = "auto"
_only = None


@contextlib.contextmanager
def kernel_mode(mode: str, only=None):
    """Select kernels or twins for code traced inside the block.

    ``only`` names the kernels the mode applies to ("rep_assign",
    "bin_nn"; default all); the others stay "auto". Takes effect at trace
    time, so wrap a function that has not been traced yet (a jitted entry
    point caches its first choice).
    """
    global _mode, _only
    if mode not in _MODES:
        raise ValueError(f"kernel mode must be one of {_MODES}, got {mode!r}")
    prev = _mode, _only
    _mode, _only = mode, (None if only is None else frozenset(only))
    try:
        yield
    finally:
        _mode, _only = prev


def on_gpu(name: str, kernel, twin, *args):
    """``kernel(*args)`` where the lowering platform is CUDA, else
    ``twin(*args)``, as :func:`kernel_mode` allows for kernel ``name``."""
    mode = _mode if _only is None or name in _only else "auto"
    if mode == "xla":
        return twin(*args)
    default = (functools.partial(kernel, interpret=True)
               if mode == "interpret" else twin)
    return jax.lax.platform_dependent(*args, cuda=kernel, default=default)
