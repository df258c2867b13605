"""The check that no module of the JAX package or its stack was loaded, by
whole top-level name."""

from __future__ import annotations

import pytest

from portbench.harness import core

JAX_PKG = "multimodal_hand_pose_enhancement_for_sign_language_tpu"


@pytest.mark.parametrize("name", ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
                                  "optax", JAX_PKG, JAX_PKG + ".ops.pallas_kernels"])
def test_flags_the_jax_stack(name):
    assert core.loaded_forbidden(["torch", "numpy", name]) == [name.split(".")[0]]


@pytest.mark.parametrize("name", [JAX_PKG + "_torch", JAX_PKG + "_torch.lifting.engine",
                                  "jaxtyping", "flaxen", "portbench.run"])
def test_passes_the_port_and_lookalikes(name):
    assert core.loaded_forbidden(["torch", name]) == []
