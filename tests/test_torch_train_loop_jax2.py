"""Losses of the port's training command line against the JAX loop of
``tools/train.py`` at grad_acc 2 (2 steps across an epoch boundary; the
helpers, fixtures and tolerance: ``tests/_train_loop_jax.py``)."""

import pytest

from _train_loop import _few_torch_threads, check_loop, jax_init, tree  # noqa: F401


@pytest.mark.parametrize("grad_acc,steps", [(2, 2)])
def test_loop_matches_jax(jax_init, tree, tmp_path, grad_acc, steps):  # noqa: F811
    check_loop(jax_init, tree, tmp_path, grad_acc, steps)
