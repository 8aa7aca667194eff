"""``chip_smoke.check_estimator`` at ``qwen2-0.5b-smoke`` on the CPU.

The check holds one flat-route sphere step (``fedzo.local_iterate``) to the
estimator's definition: each coefficient d·(L(x + μ·v̂ₙ) − L(x))/μ against
a recomputation from the plain directions with float64 norms, at a μ where
every loss difference is at least 256 float32 ulps, so it cannot pass on
rounding. Here it runs the plain versions of the kernels; on the card
``chip_smoke.py`` runs it at Qwen2-0.5B's full width.

Sizing μ for the smoke model (loss 6.30, ulp 4.8e-7): the 8 differences
read 2–16 ulps at μ = 1e-3, 14–165 at 1e-2, 149–1,615 at 0.1 and
2,465–14,469 at μ = 1, the μ used here.
"""
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import fedzo
from repro_torch.utils import prng

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

MU = 1.0


@pytest.fixture(scope="module")
def smoke():
    """(model, weights, batch) of the smoke LM on the CPU, with one
    intra-op thread (the path is many small ops)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    model, toks = chip_smoke.lm_setup("qwen2-0.5b-smoke", "float32")
    params = model.init(prng.key(0), device="cpu")
    batch = chip_smoke.lm_batch(torch, toks, np.random.default_rng(0), 2, 16,
                                "cpu")
    yield model, params, batch
    torch.set_num_threads(n)


def _check(smoke, mu=MU):
    model, params, batch = smoke
    return chip_smoke.check_estimator(model, params, batch, prng.key(5),
                                      "cpu", mu=mu)


def test_check_passes_at_a_sized_mu(smoke):
    r = _check(smoke)
    assert min(abs(u) for u in r["diff_ulps"]) >= chip_smoke.CHECK_MIN_ULPS
    # reading: the coefficients equal their recomputation (error 0)
    assert r["max_err_over_tol"] <= 1
    assert r["base"] == r["loss"]


@pytest.mark.parametrize("fault", ["zeroed", "sign flipped"])
def test_check_fails_on_a_wrong_coefficient(smoke, monkeypatch, fault):
    real = fedzo.local_iterate

    def wrong(*args, **kwargs):
        params, coeffs, base = real(*args, **kwargs)
        coeffs = coeffs.clone()
        coeffs[3] = 0.0 if fault == "zeroed" else -coeffs[3]
        return params, coeffs, base

    monkeypatch.setattr(fedzo, "local_iterate", wrong)
    with pytest.raises(RuntimeError, match="differs from its recomputation"):
        _check(smoke)


def test_check_fails_at_a_mu_too_small(smoke):
    """At the launcher's μ = 1e-3 the differences are a few ulps."""
    with pytest.raises(RuntimeError, match="below 256 ulps"):
        _check(smoke, mu=1e-3)
