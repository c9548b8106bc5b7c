"""The port's hand kernels as PyTorch operators, namespace ``vmg``.

Every kernel on a model path is an operator of the ``vmg`` library:
``torch.ops.vmg.<name>`` with a schema, a CUDA implementation (the kernel's
ctypes launch; its plan, pointer and alignment choices are made inside it,
and a build or launch failure raises), a CPU implementation (the kernel's
plain PyTorch version) and a fake implementation (the output shapes and
dtypes, for ``torch.export`` and other tracing).  The wrappers in
``ops/*.py`` call the operator in eager mode too: the dispatcher picks the
implementation from the tensors' device, so an exported graph holds one
``vmg`` node where eager launches one kernel.  Importing ``vmg_tpu_torch``
imports the modules that register them (``ops/__init__.py``), so a saved
program that names them loads in a fresh process.
"""

from __future__ import annotations

import torch

NAMESPACE = "vmg"
LIB = torch.library.Library(NAMESPACE, "DEF")


def define(name: str, schema: str, *, cpu, cuda, fake):
    """Define ``vmg::name`` with ``schema`` (its arguments and returns, e.g.
    ``"(Tensor x) -> Tensor"``) and its three implementations; returns the
    operator overload the wrapper calls."""
    LIB.define(name + schema)
    LIB.impl(name, _contiguous(cpu), "CPU")
    LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def _contiguous(plain):
    """The plain version with contiguous outputs, as the kernels write them
    and the fake implementations describe them."""

    def impl(*args):
        out = plain(*args)
        if isinstance(out, tuple):
            return tuple(t.contiguous() for t in out)
        return out.contiguous()

    return impl


def register_autograd(op, backward, setup_context) -> None:
    """The operator's gradient formula (``torch.library.register_autograd``)."""
    torch.library.register_autograd(op, backward, setup_context=setup_context, lib=LIB)


def empty(like: torch.Tensor, shape=None, dtype=None) -> torch.Tensor:
    """A contiguous output on ``like``'s device: ``like``'s shape and dtype
    unless given."""
    return torch.empty(like.shape if shape is None else shape,
                       dtype=like.dtype if dtype is None else dtype, device=like.device)
