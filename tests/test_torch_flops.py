"""The port's cost accounting and traces (``vmg_tpu_torch/utils/profiling.py``,
``vmg_tpu_torch/eval/flops.py``) against the JAX package's.

* ``compiled_stats`` of one convolution and one dense layer (no bias, no
  padding: XLA's count leaves out the taps a padded border multiplies by
  zero, and adds the bias) equals the JAX package's ``compiled_stats``
  FLOPs, exactly.
* ``model_flops`` of ``TINY_TEST_PRESET`` (one TAB and one residual block a
  stage) on a 1x4x64x64 clip equals the convolution and ``dot_general``
  FLOPs (2 x multiply-adds, each scan body times its length) the test sums
  from the JAX model's jaxpr, exactly, where the JAX model's products are
  the network's: the interpolation matrices of its resizes
  (``vmg_tpu/ops/resize.py``; the port's resizes and pools count nothing)
  and the outer products that build its axis FCs' block-diagonal weight
  are left out, and that weight's products (``chunk`` x the axis FC's, 7 of
  8 blocks zero at chunk 8) count their nonzero blocks.
* ``trace`` writes a trace file that holds the ``annotate`` names.
(The eval command's ``dataset.FLOPs`` line: ``tests/test_torch_eval.py``.)
"""

import dataclasses
import glob
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vmg_tpu.configs import TINY_TEST_PRESET as J_TINY
from vmg_tpu.models import create_model as j_create_model
from vmg_tpu.utils.profiling import compiled_stats as j_compiled_stats
from vmg_tpu_torch.configs import TINY_TEST_PRESET
from vmg_tpu_torch.eval.flops import cost_analysis, model_flops
from vmg_tpu_torch.models.vmg import create_model
from vmg_tpu_torch.utils.profiling import annotate, compiled_stats, trace

NET = dict(depths=(1, 1, 1), traj_res_n=(1, 0, 1))


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_compiled_stats_conv_and_dense_match_jax():
    x = np.random.default_rng(0).random((2, 16, 16, 8), dtype=np.float32)
    conv = fnn.Conv(16, (3, 3), padding="VALID", use_bias=False)
    pc = conv.init(jax.random.key(0), jnp.asarray(x))
    want = j_compiled_stats(lambda p, v: conv.apply(p, v), pc, jnp.asarray(x))["flops"]
    w = torch.from_numpy(np.asarray(pc["params"]["kernel"]).transpose(3, 2, 0, 1).copy())
    got = compiled_stats(lambda v: F.conv2d(v.permute(0, 3, 1, 2), w),
                         torch.from_numpy(x))
    assert got["flops"] == want
    assert got["bytes accessed"] > 0 and got["peak_memory_bytes"] is None

    y = np.random.default_rng(1).random((64, 24), dtype=np.float32)
    dense = fnn.Dense(32, use_bias=False)
    pd = dense.init(jax.random.key(0), jnp.asarray(y))
    want = j_compiled_stats(lambda p, v: dense.apply(p, v), pd, jnp.asarray(y))["flops"]
    k = torch.from_numpy(np.asarray(pd["params"]["kernel"]).T.copy())
    assert cost_analysis(lambda v: F.linear(v, k), torch.from_numpy(y))["flops"] == want


def _jaxpr_flops(jaxpr, chunk: int, width: int, mult: int = 1) -> int:
    total = 0
    for eqn in jaxpr.eqns:
        m = mult * (eqn.params.get("length", 1) if eqn.primitive.name == "scan" else 1)
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                sub = getattr(sub, "jaxpr", sub)
                if hasattr(sub, "eqns"):
                    total += _jaxpr_flops(sub, chunk, width, m)
        out = np.prod(eqn.outvars[0].aval.shape) if eqn.outvars else 0
        if eqn.primitive.name == "conv_general_dilated":
            rhs = eqn.invars[1].aval.shape
            spec = eqn.params["dimension_numbers"].rhs_spec  # (out, in, spatial...)
            total += m * 2 * out * rhs[spec[1]] * int(np.prod([rhs[i] for i in spec[2:]]))
        elif eqn.primitive.name == "dot_general":
            tb = eqn.source_info.traceback
            if tb is not None and any(f.file_name.endswith(os.path.join("ops", "resize.py"))
                                      for f in tb.frames):
                continue  # a resize's interpolation matrix
            (lc, _), _ = eqn.params["dimension_numbers"]
            if not lc:
                continue  # an outer product: the block-diagonal weight's making
            lhs, rhs = eqn.invars[0].aval.shape, eqn.invars[1].aval.shape
            k = int(np.prod([lhs[i] for i in lc]))
            if tuple(rhs) == (chunk * width, chunk * width):
                k //= chunk  # the block-diagonal axis FC: its nonzero blocks
            total += m * 2 * out * k
    return int(total)


def test_model_flops_match_jax_jaxpr():
    x = np.random.default_rng(0).random((1, 4, 64, 64, 3), dtype=np.float32)
    jmodel = j_create_model(dataclasses.replace(J_TINY, **NET), is_train=False)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.asarray(x))
    jaxpr = jax.make_jaxpr(jmodel.apply)(shapes, jnp.asarray(x)).jaxpr
    chunk = int(J_TINY.image_size[0] * J_TINY.chunk_ratios[0])
    want = _jaxpr_flops(jaxpr, chunk, J_TINY.embed_dim[0])
    model = create_model(dataclasses.replace(TINY_TEST_PRESET, **NET), device="cpu",
                         generator=torch.Generator().manual_seed(0))
    assert model_flops(model, torch.from_numpy(x)) == want
    # counted on fake tensors: the real model still serves, on real operands
    with torch.no_grad():
        y = model(torch.from_numpy(x))
    assert y.shape == (1, 4, 256, 256, 3) and torch.isfinite(y).all()


def test_trace_holds_the_annotations(tmp_path):
    with trace(str(tmp_path)) as logdir:
        with annotate("vmg_annotated_region"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    files = glob.glob(os.path.join(logdir, "*.json"))
    assert files and any("vmg_annotated_region" in open(f).read() for f in files)

