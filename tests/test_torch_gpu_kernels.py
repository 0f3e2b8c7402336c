"""The port's CUDA kernels on the card (marker ``gpu``).

Run on a machine with an NVIDIA GPU and ``nvcc``:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_kernels.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX, which the
port's machine need not have; this file imports neither JAX nor
``spearmint_tpu``.)  Without a card every test skips, decided inside the
``cuda`` fixture.

Each kernel (B1 ``shifted_logdet_q``, B2 ``shifted_factor_logdet_q``, B3
``tri_inverse``, B4a ``logdet_q`` / B4b ``factor_logdet_q`` on
K = M + diag(d) assembled in float32, and B5 ``cr_logdet_q``, cyclic
reduction, at [3, 8, 16, 16] and [2, 64, 128, 128]) is held against its
plain PyTorch version on the same card and against a float64 oracle,
at a ragged width, at the production pad 1024 (the pad of
``tests/test_tpu_smoke.py``), at the pending flagship's augmented pad
5248 and at [2, 1152, 1152] with a ragged real block; B1 and B4a must
give bit-identical ld and q from call to call.  Inputs are M = F Fᵀ/8
(rank 8) plus shifts in [0.1, 0.4], so cond ≈ n/0.1 and float32 errors
stay near n·eps: tolerances ld 1e-5 and q 1e-4 relative, L 1e-4
absolute (entries O(1)), w 5e-4 of its largest entry, X 5e-4 absolute
(entries up to ~3).
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


@pytest.mark.parametrize("k_batch,n", [(3, 1000), (2, 1024), (2, 5248),
                                       (2, 1001)],
                         ids=["ragged1000", "pad1024", "pad5248",
                              "rows_not_float4_aligned1001"])
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
    del x, p_x, o_x

    # B4a/B4b on the same matrix assembled in float32, against their plain
    # versions and the float64 factor of that float32 K
    kmat = (m + torch.diag_embed(d)).contiguous()
    ld4, q4 = gk.logdet_q(kmat, r)
    ld5, q5, l5, w5 = gk.factor_logdet_q(kmat, r)
    torch.cuda.synchronize()
    p_ld, p_q, p_l, p_w = gk.factor_logdet_q_ref(kmat, r)
    o_ld, o_q, o_l, o_w = _oracle(kmat, torch.zeros_like(d), r)
    for ld, q in ((ld4, q4), (ld5, q5)):
        for want_ld, want_q in ((p_ld, p_q), (o_ld, o_q)):
            assert _rel(ld, want_ld) < TOL["ld"]
            assert _rel(q, want_q) < TOL["q"]
    for want_l, want_w in ((p_l, p_w), (o_l, o_w)):
        assert _abs(l5, want_l) < TOL["L"]
        assert _abs(w5, want_w) / float(want_w.abs().max()) < TOL["w"]
    assert float(torch.triu(l5, 1).abs().max()) == 0.0


def test_nine_panels_with_a_ragged_real_block(cuda):
    """[2, 1152, 1152]: nine 128-wide tiles (four and a half panels of the
    schedule) with 1000 real rows and 152 padded ones (M = 0, shift 1,
    r = 0) across the last two tiles, against the plain version and
    float64 of the real block at the file's tolerances."""
    gk = cuda
    n, n_real = 1152, 1000
    m, d, r = _case(2, n, seed=11)
    real = torch.arange(n, device="cuda") < n_real
    m = torch.where(real[:, None] & real[None, :], m, 0.0).contiguous()
    d = torch.where(real, d, 1.0).contiguous()
    r = torch.where(real, r, 0.0).contiguous()
    ld1, q1 = gk.shifted_logdet_q(m, d, r)
    ld2, q2, lmat, w = gk.shifted_factor_logdet_q(m, d, r)
    kmat = (m + torch.diag_embed(d)).contiguous()
    ld4, q4 = gk.logdet_q(kmat, r)
    torch.cuda.synchronize()
    p_ld, p_q, p_l, p_w = gk.shifted_factor_logdet_q_ref(m, d, r)
    s = slice(0, n_real)
    o_ld, o_q, o_l, o_w = _oracle(m[:, s, s], d[:, s], r[:, s])
    for ld, q in ((ld1, q1), (ld2, q2), (ld4, q4)):
        for want_ld, want_q in ((p_ld, p_q), (o_ld, o_q)):
            assert _rel(ld, want_ld) < TOL["ld"]
            assert _rel(q, want_q) < TOL["q"]
    assert _abs(lmat, p_l) < TOL["L"]
    assert _abs(w, p_w) / float(p_w.abs().max()) < TOL["w"]
    assert _abs(lmat[:, s, s], o_l) < TOL["L"]
    assert _abs(w[:, s], o_w) / float(o_w.abs().max()) < TOL["w"]
    assert float(torch.triu(lmat, 1).abs().max()) == 0.0
    assert torch.equal(lmat[:, n_real:, n_real:],
                       torch.eye(n - n_real, device="cuda").expand(2, -1, -1))


def test_ld_and_q_are_bitwise_reproducible(cuda):
    """Two calls of B1 and of B4a on the same input give bit-identical ld
    and q: every sum runs in a fixed order, with no atomics."""
    gk = cuda
    m, d, r = _case(3, 1024, seed=12)
    kmat = (m + torch.diag_embed(d)).contiguous()
    for fn in (lambda: gk.shifted_logdet_q(m, d, r),
               lambda: gk.logdet_q(kmat, r)):
        (ld1, q1), (ld2, q2) = fn(), fn()
        assert torch.equal(ld1, ld2) and torch.equal(q1, q2)


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
    kmat = (m + torch.diag_embed(d)).contiguous()
    ld4, q4 = gk.logdet_q(kmat, r)
    ld5, q5, l5, _ = gk.factor_logdet_q(kmat, r)
    for a in (ld4, q4, ld5, q5):
        assert bool(torch.isnan(a[1]))
        assert bool(torch.isfinite(a[[0, 2]]).all())
    assert bool(torch.isfinite(l5[[0, 2]]).all())


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
    kmat = (m + torch.diag_embed(d)).contiguous()   # identity padded rows
    ld4, q4, l4, w4 = gk.factor_logdet_q(kmat, r)
    for a, b in ((ld, ld0), (ld4, ld0)):
        assert _rel(a, b) < TOL["ld"]
    for a, b in ((q, q0), (q4, q0)):
        assert _rel(a, b) < TOL["q"]
    for lm, wv in ((lmat, w), (l4, w4)):
        assert torch.equal(lm[:, 100:, 100:],
                           torch.eye(100, device="cuda").expand(2, -1, -1))
        assert float(lm[:, 100:, :100].abs().max()) == 0.0
        assert float(wv[:, 100:].abs().max()) == 0.0


def test_wrappers_count_cuda_launches_and_reject_bad_input(cuda):
    gk = cuda
    m, d, r = _case(2, 96, seed=1)
    gk.reset_launches()
    gk.shifted_logdet_q(m, d, r)
    _, _, lmat, _ = gk.shifted_factor_logdet_q(m, d, r)
    gk.tri_inverse(lmat)
    kmat = (m + torch.diag_embed(d)).contiguous()
    gk.logdet_q(kmat, r)
    gk.factor_logdet_q(kmat, r)
    assert gk.launches == {"shifted_logdet_q": 1,
                           "shifted_factor_logdet_q": 1, "logdet_q": 1,
                           "factor_logdet_q": 1, "tri_inverse": 1}
    with pytest.raises(ValueError):
        gk.logdet_q(kmat, r.cpu())
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


@pytest.mark.parametrize("n", [16, 224, 256])
def test_small_pads_take_the_library_route_on_the_card(cuda, n):
    """Below ``linalg.kernel_ok`` the four dispatch points factor the
    assembled K = amp2·M + diag(d) with the library Cholesky and launch no
    kernel; held against float64 at the kernels' tolerances (L⁻¹ and α
    relative to their largest entry)."""
    from spearmint_tpu_torch.core import linalg

    m, d, r = _case(3, n, seed=7)
    amp2 = torch.tensor([0.5, 1.0, 2.0], device="cuda")
    km = amp2[:, None, None] * m
    cuda.reset_launches()
    ld, q = linalg.fma_logdet_q(m, amp2, d, r)
    ld2, q2 = linalg.chol_logdet_q(km + torch.diag_embed(d), r)
    chol, linv, alpha = linalg.cache_factor(m, amp2, d, r)
    chol2, alpha2 = linalg.factor_solve(m, amp2, d, r)
    torch.cuda.synchronize()
    assert max(cuda.launches.values()) == 0
    o_ld, o_q, o_chol, _ = _oracle(km, d, r)
    eye = torch.eye(n, dtype=torch.float64, device="cuda").expand(3, n, n)
    o_linv = torch.linalg.solve_triangular(o_chol, eye, upper=False)
    o_alpha = torch.cholesky_solve(r.double()[..., None], o_chol)[..., 0]
    for a, b in ((ld, q), (ld2, q2)):
        assert _rel(a, o_ld) < TOL["ld"] and _rel(b, o_q) < TOL["q"]
    for c in (chol, chol2):
        assert _abs(c, o_chol) < TOL["L"]
    assert _abs(linv, o_linv) < TOL["X"] * float(o_linv.abs().max())
    for a in (alpha, alpha2):
        assert _abs(a, o_alpha) < TOL["w"] * float(o_alpha.abs().max())


def test_suggest_step_on_the_card_goes_through_every_kernel(cuda):
    """At pad 512, the smallest the kernels take (``linalg.kernel_ok``)."""
    from spearmint_tpu_torch.engine.suggest import (
        SuggestConfig, init_chain_states, suggest_step,
    )

    gk = cuda
    n, pad = 500, 512
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
    flagship = ("shifted_logdet_q", "shifted_factor_logdet_q", "tri_inverse")
    assert min(gk.launches[k] for k in flagship) > 0, gk.launches
    assert gk.launches["logdet_q"] == gk.launches["factor_logdet_q"] == 0


def test_constrained_step_on_the_card_adds_the_unshifted_kernel(cuda):
    """The constrained suggestion at pad 512 launches B1, B2, B3 and B4a
    (the constraint ls move), with a finite acquisition.  The constraint
    chains start at ls = 0.15: at n = 500 the jitter is 1e-6 and the
    constraint GP has no noise term, so from ls = 1 (cond far above 1e8)
    the blocked float32 factorization gives NaN, in the Pallas kernel as
    here (ROADMAP C2; below pad 512 that route is no longer taken)."""
    from spearmint_tpu_torch.engine.constrained import (
        init_constraint_states, suggest_step_constrained,
    )
    from spearmint_tpu_torch.engine.suggest import (
        SuggestConfig, init_chain_states,
    )

    gk = cuda
    n, pad = 500, 512
    rng = np.random.RandomState(2)
    xp = np.zeros((pad, 2), np.float32); xp[:n] = rng.rand(n, 2)
    obs = np.arange(pad) < n
    valid = obs & (xp[:, 0] < 0.7)
    yp = np.where(valid, np.sin(3 * xp[:, 0]), 0.0).astype(np.float32)
    h = init_chain_states(torch.tensor(yp, device="cuda"),
                          torch.tensor(valid, device="cuda"), 2, 4)
    c = init_constraint_states(2, pad, 4, device="cuda")
    c = c._replace(ls=torch.full_like(c.ls, 0.15))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    gk.reset_launches()
    res = suggest_step_constrained(
        gen, h, c, xp, yp, valid, obs, rng.rand(256, 2).astype(np.float32),
        np.ones(256, bool), SuggestConfig(mcmc_iters=2, grid_subset=4,
                                          lbfgs_iters=10), device="cuda")
    assert int(res.n_ok) > 0
    assert bool(torch.isfinite(res.acq).all())
    path = ("shifted_logdet_q", "shifted_factor_logdet_q", "tri_inverse",
            "logdet_q")
    assert min(gk.launches[k] for k in path) > 0, gk.launches


def _cr_case(k, m, b, seed):
    """tests/test_band.py:212-223's input at [k, m, b, b], assembled, with
    block 2 of lane 1 negated (non-PD)."""
    from spearmint_tpu_torch.ops import band

    rng = np.random.RandomState(seed)
    base = rng.randn(k, m, b, 2 * b).astype(np.float32)
    d = np.matmul(base, np.swapaxes(base, -1, -2)) + 10 * np.eye(
        b, dtype=np.float32)
    s = (0.3 * rng.randn(k, m, b, b)).astype(np.float32)
    s[:, -1] = 0.0
    args = [torch.tensor(a, device="cuda") for a in (
        d, s, rng.uniform(0.5, 1.5, k).astype(np.float32),
        rng.uniform(0.01, 0.1, (k, m * b)).astype(np.float32))]
    a, bb = band._cr_assemble(*args)
    a[1, 2] = -a[1, 2]
    r = torch.tensor(rng.randn(k, m * b).astype(np.float32), device="cuda")
    return a, bb, r


def _cr_f64(a, bb, r):
    """float64 (ld, q) of the dense block-tridiagonal matrices."""
    k, m, b, _ = a.shape
    kd = torch.zeros(k, m * b, m * b, dtype=torch.float64, device=a.device)
    for i in range(m):
        kd[:, i*b:(i+1)*b, i*b:(i+1)*b] = a[:, i].double()
        if i + 1 < m:
            kd[:, (i+1)*b:(i+2)*b, i*b:(i+1)*b] = bb[:, i].double()
            kd[:, i*b:(i+1)*b, (i+1)*b:(i+2)*b] = bb[:, i].double().mT
    chol = torch.linalg.cholesky(kd)
    w = torch.linalg.solve_triangular(chol, r.double()[..., None],
                                      upper=False)[..., 0]
    return (torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1),
            (w * w).sum(-1))


@pytest.mark.parametrize("shape", [(3, 8, 16), (2, 64, 128)],
                         ids=["small", "flagship_block"])
def test_cyclic_reduction_matches_plain_version_and_f64(cuda, shape):
    """B5 against its plain version and float64 (ld 1e-5, q 1e-4
    relative), the non-PD lane NaN in its own ld and q only; inert
    identity blocks padding m to 2m change nothing, bit for bit."""
    from spearmint_tpu_torch.ops import band

    a, bb, r = _cr_case(*shape, seed=shape[1])
    band.reset_launches()
    ld, q = band.cr_logdet_q(a, bb, r)
    torch.cuda.synchronize()
    assert band.launches["cr_logdet_q"] == 1
    assert bool(torch.isnan(ld[1]) and torch.isnan(q[1]))
    good = [i for i in range(shape[0]) if i != 1]
    p_ld, p_q = band.cr_logdet_q_ref(a, bb, r)
    a, bb, r = (t[good].contiguous() for t in (a, bb, r))
    o_ld, o_q = _cr_f64(a, bb, r)
    for want_ld, want_q in ((p_ld[good], p_q[good]), (o_ld, o_q)):
        assert _rel(ld[good], want_ld) < TOL["ld"]
        assert _rel(q[good], want_q) < TOL["q"]
    ld1, q1 = band.cr_logdet_q(a, bb, r)
    k, m, b, _ = a.shape
    eye = torch.eye(b, device="cuda").expand(k, m, b, b)
    ld2, q2 = band.cr_logdet_q(torch.cat([a, eye], 1).contiguous(),
                               torch.cat([bb, torch.zeros_like(bb)], 1),
                               torch.cat([r, torch.zeros_like(r)], 1))
    assert torch.equal(ld1, ld2) and torch.equal(q1, q2)


def test_band_mode_suggest_step_launches_b5_and_b1(cuda):
    """suggest_step(band_joint=True) at pad 2560 (n = 2100, nb = 20
    blocks of 128, padded to 32 for cyclic reduction): the joint move's
    evaluations launch B5, the ls move's B1; every sample is usable."""
    from spearmint_tpu_torch.engine.suggest import (
        SuggestConfig, init_chain_states, suggest_step,
    )
    from spearmint_tpu_torch.ops import band

    gk = cuda
    n, pad = 2100, 2560
    rng = np.random.RandomState(3)
    xp = np.zeros((pad, 2), np.float32); xp[:n] = rng.rand(n, 2)
    yp = np.zeros(pad, np.float32)
    yp[:n] = np.sin(3 * xp[:n, 0]) + 0.05 * rng.randn(n)
    mask = np.arange(pad) < n
    h = init_chain_states(torch.tensor(yp, device="cuda"),
                          torch.tensor(mask, device="cuda"), 2, 4)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    gk.reset_launches()
    band.reset_launches()
    res = suggest_step(gen, h, xp, yp, mask, np.zeros((4, 2), np.float32),
                       np.zeros(4, bool), rng.rand(256, 2).astype(np.float32),
                       np.ones(256, bool),
                       SuggestConfig(mcmc_iters=1, grid_subset=4,
                                     lbfgs_iters=10, band_joint=True),
                       device="cuda")
    assert int(res.n_ok) == 4
    assert bool(torch.isfinite(res.ei).all())
    assert band.launches["cr_logdet_q"] > 0
    assert gk.launches["shifted_logdet_q"] > 0
