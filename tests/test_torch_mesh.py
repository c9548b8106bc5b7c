"""The port's (data, tensor) mesh and its tensor-sharding rule, without
processes: the rank -> (data, tensor) map and the batch slice of a (2, 2)
mesh, and ``param_shardings`` leaf by leaf against the JAX package's on
``tests/test_parallel_mesh.py``'s widened preset (a stage at 224 channels)
and its narrow / odd / scalar cases."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from vmg_tpu.configs import TINY_TEST_PRESET as J_TINY
from vmg_tpu.models import create_model as j_create_model
from vmg_tpu.parallel import make_mesh as j_make_mesh, param_shardings as j_param_shardings
from vmg_tpu_torch.configs import TINY_TEST_PRESET
from vmg_tpu_torch.models.vmg import create_model
from vmg_tpu_torch.parallel import Mesh, param_shardings, process_local_batch_slice
from vmg_tpu_torch.weights import state_dict_from_jax

WIDE = dict(embed_dim=(32, 224, 32), num_heads=(2, 4, 2))


def test_rank_to_data_tensor_and_batch_slice_at_2x2():
    # the JAX package's np.asarray(devices).reshape(2, 2): device r at (r // 2, r % 2)
    want = np.arange(4).reshape(2, 2)
    for r in range(4):
        m = Mesh(2, 2, r)
        assert want[m.data_index, m.tensor_index] == r
        assert m.data_ranks() == list(want[:, m.tensor_index])
        assert m.tensor_ranks() == list(want[m.data_index])
        # tensor peers take the same rows, the data axis splits them
        assert process_local_batch_slice(8, m) == (4, 4 * m.data_index)
    with pytest.raises(ValueError, match="data processes"):
        process_local_batch_slice(3, Mesh(2, 2, 0))


def test_tp_rule_matches_jax_leaf_by_leaf():
    cfg = dataclasses.replace(J_TINY, **WIDE)
    shapes = jax.eval_shape(j_create_model(cfg, is_train=False).init, jax.random.key(0),
                            jnp.zeros((1, 2, 64, 64, 3)))
    spec = j_param_shardings(j_make_mesh((4, 2)), shapes)
    # a marker per leaf: its index along the last flax dim where JAX shards
    # it, zeros where it replicates; the port's name map carries it over
    markers = jax.tree.map(
        lambda s, sh: np.broadcast_to(np.arange(s.shape[-1], dtype=np.float32) + 1, s.shape)
        if "tensor" in str(sh.spec) else np.zeros(s.shape, np.float32), shapes, spec)
    sd = state_dict_from_jax(markers)
    model = create_model(dataclasses.replace(TINY_TEST_PRESET, **WIDE), device="meta")
    rule = param_shardings(Mesh(4, 2, 0), model)
    assert sorted(rule) == sorted(sd)
    n = 0
    for name, dim in rule.items():
        m = sd[name]
        if not m.any():
            assert dim is None, name
            continue
        n += 1
        assert dim is not None, name
        along = m.movedim(dim, -1).reshape(-1, m.shape[dim])
        assert torch.equal(along, along[:1].expand_as(along)) and \
            torch.equal(along[0], torch.arange(1, m.shape[dim] + 1, dtype=torch.float32)), name
    assert n > 0


def test_tp_rule_narrow_odd_scalar():
    class Leaves(nn.Module):
        def __init__(self):
            super().__init__()
            self.wide_conv = nn.Conv2d(112, 448, 3)    # flax (3, 3, 112, 448)
            self.narrow_conv = nn.Conv2d(32, 32, 3)
            self.wide_in = nn.Linear(448, 32)          # flax (448, 32): out is narrow
            self.odd = nn.Parameter(torch.zeros(225))  # not divisible by 2
            self.scalar = nn.Parameter(torch.zeros(()))

    rule = param_shardings(Mesh(4, 2, 0), Leaves())
    assert rule["wide_conv.weight"] == 0 and rule["wide_conv.bias"] == 0
    for name in ("narrow_conv.weight", "narrow_conv.bias", "wide_in.weight", "wide_in.bias",
                 "odd", "scalar"):
        assert rule[name] is None, name
    assert all(v is None for v in param_shardings(Mesh(8, 1, 0), Leaves()).values())


@pytest.mark.parametrize("traj_win", [4, 8])
def test_seq_sharded_forward_in_one_process(traj_win):
    # no process group: the mesh is (1, 1), the shard is the whole clip and
    # nothing is exchanged; the output is the plain forward's, bit for bit
    from vmg_tpu_torch.models.blocks import MorphFCDecay
    from vmg_tpu_torch.parallel import make_mesh, make_seq_sharded_forward, shard_clip_over_time
    from vmg_tpu_torch.parallel.exchange import BYTES, SeqShard, seq_sharded, zero_bytes

    cfg = dataclasses.replace(TINY_TEST_PRESET, depths=(1, 1, 1), traj_res_n=(1, 0, 1),
                              traj_win=(traj_win, None))
    torch.manual_seed(0)
    model = create_model(cfg, device="cpu")
    x = torch.from_numpy(np.random.default_rng(5).random((1, 8, 64, 64, 3), dtype=np.float32))
    mesh = make_mesh()
    assert (mesh.data, mesh.tensor) == (1, 1)
    zero_bytes()
    with torch.no_grad():
        want = model(x)
        got = make_seq_sharded_forward(model, mesh)(shard_clip_over_time(mesh, x))
        mixer = MorphFCDecay(32, 8, 8).eval()
        clip = torch.rand(1, 8, 16, 16, 32)
        with seq_sharded(SeqShard(None, [0], 0, 8)):
            mixed = mixer(clip)
    assert torch.equal(got, want)
    assert torch.equal(mixed, mixer(clip))
    assert not any(BYTES.values())
