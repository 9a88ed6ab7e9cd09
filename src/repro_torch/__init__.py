"""PyTorch/CUDA port of the TT-decomposed transformer stack.

The package mirrors ``repro``'s layout (configs, core, kernels, models,
serving, launch) in PyTorch's idiom: plain functions on tensors and
parameter dicts, an explicit ``device`` and explicit ``torch.Generator``s.
It imports neither ``jax`` nor anything of ``repro``; the framework-neutral
code it needs is copied in.  Entry points run on the GPU unless the caller
passes ``device="cpu"``.

Importing the package imports no ``torch``: ``launch.serve`` stamps the
process's start before its ``import torch``, so that ``--first-token``
counts the framework's start-up.
"""


def __getattr__(name):
    if name == "resolve_device":
        from .device import resolve_device
        return resolve_device
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
