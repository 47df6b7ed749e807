"""PyTorch port, bf16 mixed precision: the four casting objectives beside
the GM-VAE's (vanilla RegVAE, CVAE, FaderNets, SingleVAE) against the JAX
package's bf16 objectives on its kernel path, with the helpers, inputs
and bounds of test_torch_mixed_precision_objectives.py (the loss to
rtol=1e-3, each gradient tensor to GRAD_REL of its largest entry, which
that module shows to lie below the JAX package's own scan-vs-Pallas bf16
disagreement)."""
import pytest

from test_torch_mixed_precision_objectives import (  # noqa: F401
    check_objective, jax_results,
)


@pytest.mark.parametrize("name", ["vanilla", "cvae", "fader", "singlevae"])
def test_family_bf16_matches_jax(jax_results, name):  # noqa: F811
    check_objective(jax_results, name)
