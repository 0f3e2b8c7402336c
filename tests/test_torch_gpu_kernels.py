"""The port's CUDA kernels on the card (marker ``gpu``).

Run on a machine with an NVIDIA GPU and ``nvcc``:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_kernels.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX, which the
port's machine need not have; this file imports neither JAX nor
``spearmint_tpu``.)  Without a card every test skips, decided inside the
``cuda`` fixture.

Each kernel (B1 ``shifted_logdet_q``, B2 ``shifted_factor_logdet_q``, B3
``tri_inverse``) is held against its plain PyTorch version on the same
card and against a float64 ``torch.linalg`` oracle, at a ragged width, at
the production pad 1024 (the pad of ``tests/test_tpu_smoke.py``) and at
the pending flagship's augmented pad 5248.  Inputs are M = F Fᵀ/8 (rank 8)
plus shifts in [0.1, 0.4], so cond ≈ n/0.1 and float32 errors stay near
n·eps: tolerances ld 1e-5 and q 1e-4 relative, L 1e-4 absolute (entries
O(1)), w 5e-4 of its largest entry, X 5e-4 absolute (entries up to ~3).
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

TOL = dict(ld=1e-5, q=1e-4, L=1e-4, w=5e-4, X=5e-4)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import spearmint_tpu_torch  # noqa: F401  (full-f32 matmuls)
    from spearmint_tpu_torch.ops import build, gp_kernels

    build.build_all()
    return gp_kernels


def _case(k_batch, n, seed):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((k_batch, n, 8)).astype(np.float32)
    m = np.einsum("knd,kmd->knm", f, f) / 8
    d = rng.uniform(0.1, 0.4, (k_batch, n)).astype(np.float32)
    r = rng.standard_normal((k_batch, n)).astype(np.float32)
    return [torch.tensor(a, device="cuda") for a in (m, d, r)]


def _oracle(m, d, r):
    a = m.double() + torch.diag_embed(d.double())
    chol = torch.linalg.cholesky(a)
    w = torch.linalg.solve_triangular(chol, r.double()[..., None],
                                      upper=False)[..., 0]
    ld = torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    return ld, (w * w).sum(-1), chol, w


def _rel(a, b):
    return float(((a.double() - b.double()).abs() / b.double().abs()).max())


def _abs(a, b):
    return float((a.double() - b.double()).abs().max())


@pytest.mark.parametrize("k_batch,n", [(3, 1000), (2, 1024), (2, 5248)],
                         ids=["ragged1000", "pad1024", "pad5248"])
def test_kernels_match_plain_version_and_f64(cuda, k_batch, n):
    gk = cuda
    m, d, r = _case(k_batch, n, seed=n)
    ld1, q1 = gk.shifted_logdet_q(m, d, r)
    ld2, q2, lmat, w = gk.shifted_factor_logdet_q(m, d, r)
    x = gk.tri_inverse(lmat)
    torch.cuda.synchronize()
    p_ld, p_q, p_l, p_w = gk.shifted_factor_logdet_q_ref(m, d, r)
    p_x = gk.tri_inverse_ref(lmat)
    o_ld, o_q, o_l, o_w = _oracle(m, d, r)
    o_x = torch.linalg.inv(lmat.double())
    for ld, q in ((ld1, q1), (ld2, q2)):
        for want_ld, want_q in ((p_ld, p_q), (o_ld, o_q)):
            assert _rel(ld, want_ld) < TOL["ld"]
            assert _rel(q, want_q) < TOL["q"]
    for want_l, want_w in ((p_l, p_w), (o_l, o_w)):
        assert _abs(lmat, want_l) < TOL["L"]
        assert _abs(w, want_w) / float(want_w.abs().max()) < TOL["w"]
    assert float(torch.triu(lmat, 1).abs().max()) == 0.0
    assert _abs(x, p_x) < TOL["X"] and _abs(x, o_x) < TOL["X"]
    assert float(torch.triu(x, 1).abs().max()) == 0.0


def test_non_psd_lane_gives_nan_in_its_own_lane_only(cuda):
    gk = cuda
    m, d, r = _case(3, 300, seed=7)
    m[1] = -m[1]
    ld1, q1 = gk.shifted_logdet_q(m, d, r)
    ld2, q2, lmat, _ = gk.shifted_factor_logdet_q(m, d, r)
    x = gk.tri_inverse(lmat)
    for a in (ld1, q1, ld2, q2):
        assert bool(torch.isnan(a[1]))
        assert bool(torch.isfinite(a[[0, 2]]).all())
    assert bool(torch.isfinite(x[[0, 2]]).all())
    good = gk.shifted_factor_logdet_q(*(t[[0, 2]].contiguous()
                                         for t in (m, d, r)))
    assert _rel(ld2[[0, 2]], good[0]) < TOL["ld"]
    assert _abs(lmat[[0, 2]], good[2]) < TOL["L"]


def test_padded_rows_are_inert_on_the_card(cuda):
    """Rows with M = 0, shift 1, r = 0 add nothing to ld and q and factor
    to identity rows, across a panel edge (n_real = 100 of 200)."""
    gk = cuda
    m, d, r = _case(2, 200, seed=3)
    real = torch.arange(200, device="cuda") < 100
    m = torch.where(real[:, None] & real[None, :], m, 0.0)
    d = torch.where(real, d, 1.0).contiguous()
    r = torch.where(real, r, 0.0).contiguous()
    ld, q, lmat, w = gk.shifted_factor_logdet_q(m, d, r)
    ld0, q0 = gk.shifted_logdet_q(m[:, :100, :100].contiguous(),
                                  d[:, :100].contiguous(),
                                  r[:, :100].contiguous())
    assert _rel(ld, ld0) < TOL["ld"] and _rel(q, q0) < TOL["q"]
    assert torch.equal(lmat[:, 100:, 100:],
                       torch.eye(100, device="cuda").expand(2, -1, -1))
    assert float(lmat[:, 100:, :100].abs().max()) == 0.0
    assert float(w[:, 100:].abs().max()) == 0.0


def test_wrappers_count_cuda_launches_and_reject_bad_input(cuda):
    gk = cuda
    m, d, r = _case(2, 96, seed=1)
    gk.reset_launches()
    gk.shifted_logdet_q(m, d, r)
    _, _, lmat, _ = gk.shifted_factor_logdet_q(m, d, r)
    gk.tri_inverse(lmat)
    assert gk.launches == {"shifted_logdet_q": 1,
                           "shifted_factor_logdet_q": 1, "tri_inverse": 1}
    with pytest.raises(ValueError):
        gk.shifted_logdet_q(m.double(), d, r)
    with pytest.raises(ValueError):
        gk.shifted_logdet_q(m, d.cpu(), r)
    with pytest.raises(ValueError):
        gk.tri_inverse(lmat.transpose(1, 2))


def test_log_marginal_and_ei_on_the_card_match_f64(cuda):
    """The pipeline around the kernels at pad 1024 (n = 1000), against
    float64 dense math: lp to 1e-3 relative, posterior mean and variance
    to 5e-3 of their largest entry (the criteria of
    tests/test_tpu_smoke.py for the JAX package on its chip)."""
    from spearmint_tpu_torch.acquire import ei as ei_mod
    from spearmint_tpu_torch.core.kernels import matern52
    from spearmint_tpu_torch.core.likelihood import GPHypers, log_marginal

    n, pad = 1000, 1024
    rng = np.random.RandomState(0)
    x = rng.rand(n, 2)
    y = np.sin(3 * x[:, 0]) * np.cos(2 * x[:, 1]) + 0.05 * rng.randn(n)
    cand = rng.rand(256, 2)
    xp = np.zeros((pad, 2), np.float32); xp[:n] = x
    yp = np.zeros(pad, np.float32); yp[:n] = y
    xt, yt = torch.tensor(xp, device="cuda"), torch.tensor(yp, device="cuda")
    mt = torch.arange(pad, device="cuda") < n
    ct = torch.tensor(cand, dtype=torch.float32, device="cuda")
    h = GPHypers(*(torch.tensor(a, device="cuda") for a in (
        [0.0, 0.1], [1.0, 1.5], [1e-3, 1e-2], [[0.5, 0.8], [0.6, 0.9]])))
    lp = log_marginal(xt, yt, mt, h)
    cache = ei_mod.make_cache(xt, yt, mt, h, with_inverse=True)
    mu, var = ei_mod.posterior_from_cache(cache, xt, mt, ct)

    xd = torch.tensor(x, device="cuda")
    yd = torch.tensor(y, device="cuda")
    cd = torch.tensor(cand, device="cuda")
    hd = GPHypers(*(a.double() for a in h))
    eye = torch.eye(n, dtype=torch.float64, device="cuda")
    k = (hd.amp2[:, None, None] * (matern52(xd, xd, hd.ls) + 1e-6 * eye)
         + hd.noise[:, None, None] * eye)
    chol = torch.linalg.cholesky(k)
    res = (yd - hd.mean[:, None])[..., None]
    w = torch.linalg.solve_triangular(chol, res, upper=False)
    lp0 = (-torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
           - 0.5 * (w * w).sum((-2, -1)))
    kx = hd.amp2[:, None, None] * matern52(xd, cd, hd.ls)
    mu0 = hd.mean[:, None] + (kx.mT @ torch.cholesky_solve(res, chol))[..., 0]
    beta = torch.linalg.solve_triangular(chol, kx, upper=False)
    var0 = hd.amp2[:, None] * (1 + 1e-6) - (beta * beta).sum(-2)
    assert _rel(lp, lp0) < 1e-3
    assert _abs(mu, mu0) < 5e-3 * float(mu0.abs().max())
    assert _abs(var, var0) < 5e-3 * float(var0.abs().max())


def test_suggest_step_on_the_card_goes_through_every_kernel(cuda):
    from spearmint_tpu_torch.engine.suggest import (
        SuggestConfig, init_chain_states, suggest_step,
    )

    gk = cuda
    n, pad = 200, 224
    rng = np.random.RandomState(1)
    xp = np.zeros((pad, 2), np.float32); xp[:n] = rng.rand(n, 2)
    yp = np.zeros(pad, np.float32)
    yp[:n] = np.sin(3 * xp[:n, 0]) + 0.05 * rng.randn(n)
    mask = np.arange(pad) < n
    h = init_chain_states(torch.tensor(yp, device="cuda"),
                          torch.tensor(mask, device="cuda"), 2, 4)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    gk.reset_launches()
    res = suggest_step(gen, h, xp, yp, mask, np.zeros((4, 2), np.float32),
                       np.zeros(4, bool), rng.rand(256, 2).astype(np.float32),
                       np.ones(256, bool),
                       SuggestConfig(mcmc_iters=2, grid_subset=4,
                                     lbfgs_iters=10), device="cuda")
    assert int(res.n_ok) == 8
    assert bool(torch.isfinite(res.ei).all())
    assert min(gk.launches.values()) > 0, gk.launches
