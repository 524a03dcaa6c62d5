"""The whole-name check for JAX and the JAX package."""

from benchlib import nojax


def test_planted_modules_fail():
    assert nojax.forbidden_modules(["jax.numpy", "os"]) == ["jax"]
    assert nojax.forbidden_modules(["augustus_tpu.engine.scan"]) == \
        ["augustus_tpu"]
    assert nojax.forbidden_modules(["jaxlib", "flax.linen"]) == \
        ["flax", "jaxlib"]


def test_the_port_passes():
    assert nojax.forbidden_modules(
        ["augustus_tpu_torch", "augustus_tpu_torch.predict", "jaxtyping",
         "augref.predict", "torch"]) == []
