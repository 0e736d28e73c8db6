"""Training through the encoder-decoder (whisper-large-v3: the audio
stub's frames, the non-causal encoder, cross attention in each decoder
block) at ``reduced()``: the port's ``lm_loss`` and its gradient against
the reference's ``lm_loss`` and ``jax.grad`` on the same weights and
batch, and remat on against off. The rules are in
``lm_train_support``."""
import pytest

jax = pytest.importorskip("jax")  # the card's machine has no JAX

from test_torch_support import one_thread  # noqa: F401,E402  (autouse)
from lm_train_support import (check_gradients,  # noqa: E402
                              check_loss_and_metrics, check_remat_bit_equal)

ARCHS = ["whisper-large-v3"]


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_metrics_match_the_reference(arch):
    check_loss_and_metrics(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_within_the_unrounded_rule(arch):
    check_gradients(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_equals_remat_off_bit_for_bit(arch):
    check_remat_bit_equal(arch)
