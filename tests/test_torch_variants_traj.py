"""The port's axes op and trajectory beyond the full preset's
configuration, each against its ``vmg_tpu`` counterpart (CPU, float32,
seeded numpy inputs, the JAX module's parameters carried into the port
through ``vmg_tpu_torch.weights``): the axes op's linear and bias-free
forms, LTAM's 'max' mode, other twins windows, ``en_field``, ``ltam`` off
and the 'loc' carry.  Split from ``tests/test_torch_variants.py``, whose
helpers it repeats; tolerance ``TOL`` (3e-5, as
``tests/test_torch_blocks.py``).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vmg_tpu.models import trajectory as jtraj
from vmg_tpu.ops import morphfc_fused as jfused
from vmg_tpu_torch.models import trajectory
from vmg_tpu_torch.ops import morphfc_fused
from vmg_tpu_torch.ops.decay import morphfc_decay_np
from vmg_tpu_torch.weights import state_dict_from_jax

TOL = dict(atol=3e-5, rtol=3e-5)


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """The suite runs in several worker processes at once; torch at full
    width in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _x(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _load(module, params, path, prefix, **keys):
    """Carry a JAX sub-module's params (at ``path`` of a full model) into
    ``module`` (its state-dict ``prefix``), strict."""
    tree = params["params"]
    for key in reversed(path.split("/")):
        tree = {key: tree}
    module.load_state_dict(state_dict_from_jax(tree, prefix=prefix, **keys), strict=True)
    return module.eval()


def _perturb(params, rng, scale=0.05):
    """Every leaf plus seeded noise: zero-initialised weights and biases
    (the DCN's offset head, biases) take part in the comparison."""
    return jax.tree.map(lambda v: v + scale * rng.standard_normal(v.shape).astype(v.dtype),
                        params)


def _run(module, *args, **kw):
    with torch.no_grad():
        return module(*(torch.from_numpy(a) for a in args), **kw).numpy()


@pytest.mark.parametrize("form", ["big", "token"])
@pytest.mark.parametrize("non_linear", [True, False])
@pytest.mark.parametrize("bias", [True, False])
def test_axes_options_match_pallas(rng, form, non_linear, bias):
    """``vmg::morphfc_axes`` with ``non_linear`` and without biases against
    JAX's ``fused_morphfc_axes(..., non_linear=, bh_raw=None)`` in
    interpret mode (a partial last H chunk)."""
    N, H, W, C, ck = 2, 10, 16, 16, 4
    x, c = _x(rng, (N, H, W, C)), _x(rng, (N, H, W, C)) / C
    kh, kw = 0.1 * _x(rng, (C, C)), 0.1 * _x(rng, (C, C))
    bh, bw = (_x(rng, (C,)), _x(rng, (C,))) if bias else (None, None)
    j = lambda v: None if v is None else jnp.asarray(v)  # noqa: E731
    want = jfused.fused_morphfc_axes(j(x), j(c), j(kh), j(bh), j(kw), j(bw), chunk_h=ck,
                                     chunk_w=ck, non_linear=non_linear, interpret=True,
                                     form=form)
    gamma = morphfc_decay_np(ck, C // ck)
    t = lambda v: None if v is None else torch.from_numpy(v)  # noqa: E731
    got = morphfc_fused.fused_morphfc_axes(
        t(x), t(c), t((kh * gamma).astype(np.float32)), t(bh),
        t((kw * gamma).astype(np.float32)), t(bw), chunk_h=ck, chunk_w=ck, form=form,
        non_linear=non_linear)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), **TOL)
    if not non_linear:
        assert (got[0] < 0).any()  # the linear form keeps negative values
    with pytest.raises(ValueError, match="both biases or neither"):
        morphfc_fused.fused_morphfc_axes(t(x), t(c), t(kh), t(bh if bias else _x(rng, (C,))),
                                         t(kw), None, chunk_h=ck, chunk_w=ck)


def _kv(rng, n, h, w, K, C, S=2):
    """A warped carry: per slot [value | normalized key | fields...]."""
    parts = []
    for _ in range(K):
        key = np.asarray(jtraj._normalize(jnp.asarray(_x(rng, (n, h, w, C)))))
        parts += [_x(rng, (n, h, w, C)), key] + [_x(rng, (n, h, w, C)) for _ in range(S - 2)]
    return np.concatenate(parts, -1)


@pytest.mark.parametrize("mode,twins,en_field,scale",
                         [("max", (2, 2), False, True), ("max", (2, 2), True, False),
                          ("wins", (4, 2), False, False), ("wins", (2, 2), False, True)])
def test_ltam_modes_match_jax(rng, mode, twins, en_field, scale):
    """The windowed module form (the last case at 2x2 is held against the
    XLA windows form, with the port's kernel route switched off) and the
    'max' mode, with and without the en_field context fusion."""
    n, K, h, w, C, heads = 2, 3, 8, 12, 16, 4
    S = 4 if en_field else 2
    curr, anchor = _x(rng, (n, h, w, C)), _x(rng, (n, h, w, C))
    kv = _kv(rng, n, h, w, K, C, S)
    w5 = kv.reshape(n, h, w, K, S * C)
    jm = jtraj.LTAM(C, head=heads, mode=mode, if_scale=scale, twins=twins,
                    en_field=en_field, keys_prenormalized=True, presampled=True)
    extra = dict(sparse_s2=jnp.asarray(w5[..., 2 * C:3 * C]),
                 sparse_s3=jnp.asarray(w5[..., 3 * C:])) if en_field else {}
    args = (jnp.asarray(curr), jnp.asarray(w5[..., C:2 * C]), jnp.asarray(anchor),
            jnp.asarray(w5[..., :C]), None)
    p = _perturb(jm.init(jax.random.key(7), *args, **extra), rng)
    want = np.asarray(jm.apply(p, *args, **extra))
    m = _load(trajectory.LTAM(C, heads, mode, scale, twins, en_field), p,
              "encoder_layers0/traj_mixing/step/LTAM", "encoder_layers.0.traj_mixing.LTAM.")
    with torch.no_grad():
        got = m(*(torch.from_numpy(a) for a in (curr, anchor, kv)), kernel=False).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if en_field is False and mode == "max":
        with pytest.raises(NotImplementedError, match="mid_r"):
            trajectory.LTAM(C, heads, "wins", en_field=True)
