"""The plain reference against the frozen golden copy, and the control's
TF32 arithmetic."""

import math

import numpy as np
import pytest
import torch

from portbench.reference import golden, gp


def problem(n=30, m=50, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 2))
    y = np.sin(3 * x[:, 0]) * np.cos(2 * x[:, 1]) + 0.05 * rng.standard_normal(n)
    return x, y - y.mean(), rng.random((m, 2))


SAMPLES = gp.SampleSet(np.array([0.01, -0.02]), np.array([0.4, 0.9]),
                       np.array([2e-3, 5e-3]),
                       np.array([[0.6, 1.1], [0.3, 0.8]]))


def test_reference_matches_the_golden_copy():
    x, y, c = problem()
    got = gp.acquisition(x, y, c, SAMPLES, gp.REFERENCE, "cpu")
    jit = gp.jitter_for(x.shape[0])
    assert jit == golden.JITTER
    for s in range(2):
        h = [a[s] for a in SAMPLES]
        want_lp = golden.log_marginal(x, y, *h)
        assert got.lp[s] == pytest.approx(want_lp, rel=1e-10)
        want_ei = golden.compute_ei(x, y, c, *h)
        # the golden EI loses digits to float64's underflow below ~1e-300
        ok = want_ei > 1e-250
        assert ok.sum() > 20
        np.testing.assert_allclose(got.acq[s].numpy()[ok],
                                   np.log(want_ei[ok]), rtol=1e-8, atol=1e-8)
        assert np.all(got.acq[s].numpy()[~ok] < np.log(1e-250))
    avg = gp.sample_mean(got).numpy()
    want = np.mean([golden.compute_ei(x, y, c, *[a[s] for a in SAMPLES])
                    for s in range(2)], 0)
    ok = want > 1e-250
    np.testing.assert_allclose(avg[ok], np.log(want[ok]), rtol=1e-8,
                               atol=1e-8)


def test_per_second_divides_by_the_duration_posterior_mean():
    x, y, c = problem()
    t = 2.0 * x[:, 0]
    got = gp.acquisition(x, y, c, SAMPLES, gp.REFERENCE, "cpu",
                         time_y=t, time_samples=SAMPLES)
    plain = gp.acquisition(x, y, c, SAMPLES, gp.REFERENCE, "cpu")
    for s in range(2):
        h = [a[s] for a in SAMPLES]
        mu_t, _ = golden.posterior(x, t, c, *h)
        np.testing.assert_allclose(
            got.acq[s].numpy(),
            plain.acq[s].numpy() - np.maximum(mu_t, math.log(1e-3)),
            rtol=1e-8, atol=1e-8)
    assert got.lp_time[0] == pytest.approx(
        golden.log_marginal(x, t, *[a[0] for a in SAMPLES]), rel=1e-10)


def test_log_ei_is_finite_far_in_the_tail():
    mu = torch.tensor([0.0, 1.0, 10.0, 1e3], dtype=torch.float64)
    var = torch.full_like(mu, 1e-4)
    out = gp.log_expected_improvement(mu, var, torch.tensor(0.0,
                                                            dtype=torch.float64))
    assert torch.isfinite(out).all()
    assert torch.all(out[1:] < out[:-1])
    sigma, u = 1e-2, -1.0 / 1e-2 * 1.0   # mu = 1: u = -100
    # EI ≈ σ φ(u) / u² in the tail
    approx = (math.log(sigma) - 0.5 * u * u - 0.5 * math.log(2 * math.pi)
              - 2 * math.log(-u))
    assert float(out[1]) == pytest.approx(approx, abs=1e-3)


def test_to_tf32_rounds_to_ten_mantissa_bits():
    one = 1.0
    xs = torch.tensor([one + 2 ** -11, one + 3 * 2 ** -11, one + 2 ** -10,
                       -(one + 3 * 2 ** -12), 3.0], dtype=torch.float32)
    got = gp.to_tf32(xs)
    want = [1.0, 1.0 + 2 ** -9, 1.0 + 2 ** -10, -(1.0 + 2 ** -10), 3.0]
    assert got.tolist() == want


def test_control_is_tf32_arithmetic():
    x, y, c = problem(n=60)
    ref = gp.acquisition(x, y, c, SAMPLES, gp.REFERENCE, "cpu")
    ctl = gp.acquisition(x, y, c, SAMPLES, gp.CONTROL, "cpu")
    f32 = gp.acquisition(x, y, c, SAMPLES,
                         gp.Arith("f32", torch.float32, False), "cpu")
    top = ref.acq.max(1, keepdim=True).values
    near = ref.acq >= top - 5.0
    d_ctl = (ctl.acq - ref.acq)[near].abs().max()
    d_f32 = (f32.acq - ref.acq)[near].abs().max()
    assert d_ctl > 10 * d_f32
