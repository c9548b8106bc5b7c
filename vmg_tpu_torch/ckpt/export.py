"""Model export for serving (``vmg_tpu/ckpt/export.py``): the serving
forward as a ``torch.export`` program, saved to one file and loaded back.

The JAX package serialises ``model.apply(params, x)`` with its Pallas
kernels inside as custom calls; here every hand kernel is a ``vmg::``
operator (``ops/library.py``), so the exported graph holds one ``vmg``
node where the eager forward launches one kernel, and the loaded program
launches the same kernels.  The weights are baked in as the JAX export
bakes ``params``: the parameters are the program's state, and the kernels'
packed operands its constants (``models/blocks.py`` ``PackedOperands``).
The input shape is fixed.

    program = export_program(model_or_server, (1, 16, 180, 320, 3), "vmg.pt2")
    forward = load_program("vmg.pt2")   # import vmg_tpu_torch first
    y = forward(x)                      # x: float32 on the model's device
"""

from __future__ import annotations

import collections
from pathlib import Path
from typing import Tuple

import torch
from torch import nn

import vmg_tpu_torch  # noqa: F401  (registers the vmg:: operators a program names)
from vmg_tpu_torch.ops.library import NAMESPACE


class _Serving(nn.Module):
    """The model's forward with ``frames_mirror`` fixed (export traces
    tensor inputs only)."""

    def __init__(self, model: nn.Module, frames_mirror: bool):
        super().__init__()
        self.model = model
        self.frames_mirror = frames_mirror

    def forward(self, x):
        return self.model(x, frames_mirror=self.frames_mirror)


def export_program(model, input_shape: Tuple[int, ...], path: str | Path | None = None, *,
                   frames_mirror: bool = False) -> torch.export.ExportedProgram:
    """``torch.export.export`` of the serving forward at ``input_shape``, a
    float32 (1, T, h, w, 3) clip: ``model`` is an eval-mode ``VMG`` or an
    ``SRServer`` (its model, in its dtype, forms and device), run with
    ``frames_mirror`` as given.  One eager forward first packs the kernels'
    operands.  Writes the program with ``torch.export.save`` when ``path``
    is given; returns it."""
    module = getattr(model, "model", model)
    if module.training:
        raise ValueError("export_program exports the serving forward: put the model in eval "
                         "mode")
    device = next(module.parameters()).device
    x = torch.zeros(input_shape, dtype=torch.float32, device=device)
    serving = _Serving(module, frames_mirror)
    with torch.no_grad():
        serving(x)
        program = torch.export.export(serving, (x,))
    if path is not None:
        torch.export.save(program, str(path))
    return program


def load_program(path_or_program) -> nn.Module:
    """A program of :func:`export_program`, or the file it wrote, as a
    module to call on a clip of the exported shape."""
    program = path_or_program
    if isinstance(program, (str, Path)):
        program = torch.export.load(str(program))
    return program.module()


def operator_counts(program) -> collections.Counter:
    """``vmg::`` operator name -> the nodes calling it in the program's graph
    (an ``ExportedProgram`` or a module of :func:`load_program`)."""
    graph = getattr(program, "graph_module", program).graph
    counts = collections.Counter()
    for node in graph.nodes:
        op = getattr(node.target, "_schema", None)
        if node.op == "call_function" and op is not None and op.name.startswith(f"{NAMESPACE}::"):
            counts[op.name.split("::", 1)[1]] += 1
    return counts
