"""What the LLM kernels' wrappers share as `torch.library` custom ops.

Each of `flash_attention`, `wkv`, `wkv_bwd`, `mamba_scan` and
`mamba_scan_bwd` is one custom op in the `repro_torch` namespace with a
CUDA implementation (the hand-written kernel), a CPU implementation
(its plain version) and a fake implementation (outputs of the kernel's
shapes and dtypes, nothing launched), so that a dispatch mode
(`repro_torch.launch.hlo_cost`) sees one op named for the kernel on
every device, fake tensors included, and never the plain version's
inner ops.
"""

from __future__ import annotations

import contextlib

import torch

_AUTOGRAD_KEYS = (torch._C.DispatchKey.AutogradCPU,
                  torch._C.DispatchKey.AutogradCUDA,
                  torch._C.DispatchKey.AutogradOther,
                  torch._C.DispatchKey.ADInplaceOrView)


def route(name: str, xs) -> str:
    """The device type every tensor of `xs` lies on: "cpu" (fake CPU
    tensors included), "cuda" or "meta"; inputs on several devices, or
    another device, raise."""
    devs = {x.device for x in xs}
    if len(devs) == 1 and next(iter(devs)).type in ("cpu", "cuda", "meta"):
        return next(iter(devs)).type
    raise ValueError(f"{name}: every input must lie on one CUDA device, "
                     f"got {sorted(str(d) for d in devs)}")


@contextlib.contextmanager
def autograd_inside():
    """Autograd recording inside a custom op's implementation, which runs
    below the autograd keys: the CPU implementation of a backward op
    differentiates its plain forward with `torch.autograd.grad`."""
    exclude = torch._C._dispatch_tls_local_exclude_set()
    for key in _AUTOGRAD_KEYS:
        exclude = exclude.remove(key)
    with torch._C._ForceDispatchKeyGuard(
            torch._C._dispatch_tls_local_include_set(), exclude), \
            torch.enable_grad():
        yield


def float_of(x: torch.Tensor) -> torch.dtype:
    """The plain versions' compute type: float32, or float64 for float64
    inputs."""
    return torch.promote_types(x.dtype, torch.float32)


def no_states(like: torch.Tensor, shape) -> torch.Tensor:
    """A kernel's saved states where the plain version keeps none: zeros
    of their shape at no memory (stride 0), in `like`'s dtype."""
    return like.new_zeros(()).expand(shape)
