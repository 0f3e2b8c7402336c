"""Band mode of the port (``spearmint_tpu_torch/ops/band.py``) against the
JAX package's ``spearmint_tpu/ops/band.py`` on the CPU.

The counterparts of ``tests/test_band.py``: the compact-WY panel and the
reduction element by element, the band marginal on both evaluators over
the JAX test's shapes, the plain version of kernel B5 against the Pallas
kernel in interpret mode, the XLA recursion and float64, the congruence
with its exactly-zero padded tail, and the band-mode sampler in
distribution.  Then the slice: ``suggest_step(band_joint=True)``, the
cyclic-reduction gate and the chooser's band gate.  Inputs are made with
numpy and handed to both packages; each JAX result is compiled once per
module (``functools.cache``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spearmint_tpu.core.kernels import matern52 as jmatern52
from spearmint_tpu.core.likelihood import GPHypers as JHypers
from spearmint_tpu.core.likelihood import log_marginal as jlog_marginal
from spearmint_tpu.ops import band as jband
from spearmint_tpu_torch.choosers.GPEIOptChooser import band_gate
from spearmint_tpu_torch.core.kernels import matern52
from spearmint_tpu_torch.core.likelihood import GPHypers, unit_cov_matrix
from spearmint_tpu_torch.engine.suggest import (
    SuggestConfig, init_chain_states, suggest_step,
)
from spearmint_tpu_torch.mcmc.chains import (
    MCMCConfig, sample_hypers_lp, seed_lp,
)
from spearmint_tpu_torch.ops import band

torch.set_num_threads(1)

# four chains with different length scales and states (tests/test_band.py
# :136-152), noise ≥ 1e-2 as in its cyclic-reduction test (:172-179)
LS = np.random.RandomState(3).uniform(0.4, 1.1, (4, 2)).astype(np.float32)
MEAN = np.array([0.1, -0.2, 0.0, 0.05], np.float32)
AMP2 = np.array([0.8, 0.3, 1.5, 1.0], np.float32)
NOISE = np.array([1e-2, 0.1, 3e-2, 2e-2], np.float32)
# the shapes of tests/test_band.py:82-88 and :155-161
SHAPES = [(12, 16, 4), (40, 64, 8), (200, 256, 32), (300, 320, 32),
          (230, 256, 128), (128, 128, 128)]


def _problem(n_real, npad, d=2, seed=0):
    """tests/test_band.py's _problem, as numpy arrays."""
    rng = np.random.RandomState(seed)
    x = np.zeros((npad, d), np.float32)
    x[:n_real] = rng.rand(n_real, d)
    y = np.zeros(npad, np.float32)
    y[:n_real] = np.sin(3 * x[:n_real, 0]) + 0.1 * rng.randn(n_real)
    return x, y, np.arange(npad) < n_real


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


@functools.cache
def _jax_lp(n_real, npad, blk, route):
    """[4] lp of the four chains: route None is JAX log_marginal (dense),
    True/False the JAX band factory on that evaluator."""
    x, y, mask = map(jnp.asarray, _problem(n_real, npad))

    def one(ls, mean, amp2, noise):
        if route is None:
            return jlog_marginal(x, y, mask, JHypers(mean, amp2, noise, ls),
                                 jmatern52)
        return jband.band_marginal_factory(x, y, mask, ls, jmatern52,
                                           block=blk, use_cr=route)(
                                               mean, amp2, noise)

    return np.asarray(jax.jit(jax.vmap(one))(
        *map(jnp.asarray, (LS, MEAN, AMP2, NOISE))))


# ------------------------------------------------------- panel, reduction
def test_panel_wy_is_a_valid_block_reflector(rng):
    """Q = I − VTVᵀ orthogonal and QᵀP = [R; 0], per lane (:31-41); and
    the same (r, v, t) as the JAX panel."""
    k, m, b = 3, 24, 8
    p = rng.randn(k, m, b).astype(np.float32)
    r, v, t = band._panel_wy(torch.tensor(p))
    q = torch.eye(m) - v @ t @ v.mT
    for i in range(k):
        qi = q[i].numpy()
        np.testing.assert_allclose(qi.T @ qi, np.eye(m), atol=2e-5)
        qtp = qi.T @ p[i]
        np.testing.assert_allclose(qtp[:b], r[i].numpy(), atol=2e-5)
        np.testing.assert_allclose(qtp[b:], 0.0, atol=2e-5)
        for got, want in zip((r, v, t), jband._panel_wy(jnp.asarray(p[i]))):
            np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                       atol=2e-5)
    assert float(torch.tril(r, -1).abs().max()) == 0.0


def test_panel_wy_zero_tau_columns_are_identity_reflectors(rng):
    """Zero panel columns (padded observations) give H = I: their T row
    and column are exactly zero, and Q stays orthogonal (:44-58)."""
    k, m, b = 2, 20, 6
    p = rng.randn(k, m, b).astype(np.float32)
    p[:, :, 2] = 0.0
    p[:, :, 5] = 0.0
    _, v, t = band._panel_wy(torch.tensor(p))
    for c in (2, 5):
        assert float(t[:, c, :].abs().max()) == 0.0
        assert float(t[:, :, c].abs().max()) == 0.0
    q = torch.eye(m) - v @ t @ v.mT
    for i in range(k):
        qi = q[i].numpy()
        np.testing.assert_allclose(qi.T @ qi, np.eye(m), atol=2e-5)
        np.testing.assert_allclose((qi.T @ p[i])[b:], 0.0, atol=2e-5)


@pytest.mark.parametrize("n_real,npad,blk", [(40, 64, 8), (300, 320, 32)])
def test_reduce_to_band_matches_jax(n_real, npad, blk):
    """d_blocks, s_blocks and Qᵀvecs of each lane against the JAX
    reduction of that lane, element by element, to 2e-4 of each block's
    (each vector's) largest entry, on a well-conditioned symmetric M
    (F Fᵀ/N + I, padded rows and columns zero): there every reflector is
    well determined.  On a GP covariance the trailing panels fall below
    float32 resolution (the kernel's spectrum decays), their reflectors
    are set by rounding in any two implementations, and only invariants
    such as the marginal compare (next test)."""
    rng = np.random.RandomState(npad)
    f = rng.randn(2, npad, npad).astype(np.float32)
    mask = np.arange(npad) < n_real
    m0 = np.where(mask[:, None] & mask[None, :],
                  f @ np.swapaxes(f, 1, 2) / npad + np.eye(npad), 0.0
                  ).astype(np.float32)
    vecs = np.where(mask[:, None], rng.randn(2, npad, 2), 0.0).astype(
        np.float32)
    db, sb, vt = band.reduce_to_band(*_t(m0, vecs), blk)
    assert float(vt[:, n_real:].abs().max()) == 0.0
    jreduce = jax.jit(jband.reduce_to_band, static_argnums=2)
    for i in range(2):
        jd, js, jv = jreduce(jnp.asarray(m0[i]), jnp.asarray(vecs[i]), blk)
        for got, want in ((db[i], jd), (sb[i], js), (vt[i], jv)):
            want = np.asarray(want)
            axes = (-2, -1) if want.ndim == 3 else 0
            scale = np.abs(want).max(axes, keepdims=True)
            assert (np.abs(got.numpy() - want) <= 2e-4 * scale).all()


# --------------------------------------------------------- the marginal
@pytest.mark.parametrize("cr", [False, True], ids=["scan", "cr"])
@pytest.mark.parametrize("n_real,npad,blk", SHAPES)
def test_band_marginal_matches_jax_and_dense(n_real, npad, blk, cr):
    """The factory over four chains with different ls (one reduction, a
    [4] batch) against the JAX factory on the same evaluator and the JAX
    dense log_marginal, per lane, at the JAX test's rel 2e-3 / abs 2e-2 —
    pads that cross panel edges (zero-τ columns), nb ≤ 2 (no panels) and
    nb = 10 padded to 16 inert blocks for cyclic reduction."""
    x, y, mask = _problem(n_real, npad)
    marg = band.band_marginal_factory(*_t(x, y, mask), torch.tensor(LS),
                                      matern52, block=blk, cr=cr)
    got = marg(*_t(MEAN, AMP2, NOISE)).numpy()
    for want in (_jax_lp(n_real, npad, blk, cr),
                 _jax_lp(n_real, npad, blk, None)):
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-2)


def test_reduction_is_an_exact_congruence(rng):
    """(ld, q) through the reduced blocks, by the scan and by cyclic
    reduction, against float64 on the dense K = amp2·M + diag(dadd) of two
    lanes; the padded tail of Qᵀ[y, mask] is exactly zero (:108-133)."""
    x, y, mask = _problem(40, 64)
    xt, yt, mt = _t(x, y, mask)
    ls = torch.tensor([[0.6, 0.8], [0.9, 0.5]])
    m0 = unit_cov_matrix(xt, mt, ls)
    m64 = m0.double().numpy()
    vecs = torch.stack([torch.where(mt, yt, 0.0), mt.float()], -1)
    db, sb, vt = band.reduce_to_band(m0, vecs.expand(2, -1, -1).contiguous(),
                                     8)
    assert float(vt[:, 40:].abs().max()) == 0.0
    amp2 = torch.tensor([0.7, 1.2])
    dadd = torch.where(mt, torch.tensor([1e-2, 3e-2])[:, None], 1.0)
    resid = vt[..., 0] - 0.05 * vt[..., 1]
    a, bb = band._cr_assemble(db, sb, amp2, dadd)
    for ld, q in (band.band_logdet_q(db, sb, amp2, dadd, resid),
                  band.cr_logdet_q(a, bb, resid.contiguous())):
        for i in range(2):
            kd = float(amp2[i]) * m64[i] + np.diag(dadd[i].double().numpy())
            chol = np.linalg.cholesky(kd)
            w = np.linalg.solve(chol, np.where(mask, y, 0.0) - 0.05 * mask)
            np.testing.assert_allclose(float(ld[i]),
                                       np.log(np.diag(chol)).sum(), rtol=1e-4)
            np.testing.assert_allclose(float(q[i]), w @ w, rtol=1e-3)


# ---------------------------------------------------------------- B5
def _cr_case(rng, k, m, b):
    """tests/test_band.py:212-223's input, assembled (numpy float32)."""
    base = rng.randn(k, m, b, 2 * b).astype(np.float32)
    d = np.matmul(base, np.swapaxes(base, -1, -2)) + 10 * np.eye(
        b, dtype=np.float32)
    s = (0.3 * rng.randn(k, m, b, b)).astype(np.float32)
    s[:, -1] = 0.0
    amp2 = rng.uniform(0.5, 1.5, k).astype(np.float32)
    dadd = rng.uniform(0.01, 0.1, (k, m * b)).astype(np.float32)
    r = rng.randn(k, m * b).astype(np.float32)
    a, bb = band._cr_assemble(*_t(d, s, amp2, dadd))
    return a, bb, torch.tensor(r)


def _dense64(a, bb):
    """The float64 block-tridiagonal matrices [K, m·b, m·b]."""
    k, m, b, _ = a.shape
    kd = np.zeros((k, m * b, m * b))
    for i in range(m):
        kd[:, i*b:(i+1)*b, i*b:(i+1)*b] = a[:, i].double().numpy()
        if i + 1 < m:
            low = bb[:, i].double().numpy()
            kd[:, (i+1)*b:(i+2)*b, i*b:(i+1)*b] = low
            kd[:, i*b:(i+1)*b, (i+1)*b:(i+2)*b] = np.swapaxes(low, -1, -2)
    return kd


def test_cr_plain_version_matches_pallas_kernel_and_xla_recursion(rng):
    """B5's plain version against the Pallas kernel in interpret mode and
    the XLA recursion on the input of :212-223 (K=3, m=8, b=16): ld to
    1e-5 and q to 1e-4 relative, and against float64 at the same."""
    a, bb, r = _cr_case(rng, 3, 8, 16)
    ld, q = band.cr_logdet_q(a, bb, r)
    aj, bj, rj = (jnp.asarray(t.numpy()) for t in (a, bb, r))
    ld_k, q_k = jband.cr_logdet_q_pallas(aj, bj, rj, interpret=True)
    ld_x, q_x = jband._cr_body(aj, bj, rj.reshape(3, 8, 16), 1,
                               jband._chol_small)
    kd = _dense64(a, bb)
    chol = np.linalg.cholesky(kd)
    w = np.stack([np.linalg.solve(c, v) for c, v in
                  zip(chol, r.double().numpy())])
    for want_ld, want_q in ((ld_k, q_k), (ld_x, q_x),
                            (np.log(np.diagonal(chol, axis1=1,
                                                axis2=2)).sum(-1),
                             (w * w).sum(-1))):
        np.testing.assert_allclose(ld.numpy(), np.asarray(want_ld),
                                   rtol=1e-5)
        np.testing.assert_allclose(q.numpy(), np.asarray(want_q), rtol=1e-4)


@pytest.mark.parametrize("n_real", [1, 3, 5, 6])
def test_cr_skips_inert_blocks_past_n_real(rng, n_real):
    """m = 8 blocks of which the first ``n_real`` are real and the rest
    inert (a = I, bb = 0, r = 0, the coupling into the first inert block
    0): the plain version with ``n_real`` (no work on the inert blocks)
    against the Pallas kernel in interpret mode and the XLA recursion on
    the same input (ld 1e-5, q 1e-4 relative, :212-223's tolerances) and
    bit for bit equal to itself without ``n_real``."""
    a, bb, r = _cr_case(rng, 3, 8, 16)
    a[:, n_real:] = torch.eye(16)
    bb[:, n_real - 1:] = 0.0
    r[:, 16 * n_real:] = 0.0
    ld, q = band.cr_logdet_q(a, bb, r, n_real=n_real)
    ld_all, q_all = band.cr_logdet_q(a, bb, r)
    assert torch.equal(ld, ld_all) and torch.equal(q, q_all)
    aj, bj, rj = (jnp.asarray(t.numpy()) for t in (a, bb, r))
    ld_k, q_k = jband.cr_logdet_q_pallas(aj, bj, rj, interpret=True)
    ld_x, q_x = jband._cr_body(aj, bj, rj.reshape(3, 8, 16), 1,
                               jband._chol_small)
    for want_ld, want_q in ((ld_k, q_k), (ld_x, q_x)):
        np.testing.assert_allclose(ld.numpy(), np.asarray(want_ld),
                                   rtol=1e-5)
        np.testing.assert_allclose(q.numpy(), np.asarray(want_q), rtol=1e-4)
    with pytest.raises(ValueError):
        band.cr_logdet_q(a, bb, r, n_real=9)
    with pytest.raises(ValueError):
        band.cr_logdet_q(a, bb, r, n_real=0)


def test_cr_nan_lane_inert_blocks_and_single_level(rng):
    """A non-PD lane gives NaN in its own ld and q only; inert identity
    blocks (a = I, bb = 0, r = 0) padding m = 4 to m = 8 change nothing,
    bit for bit, and an all-inert input gives exactly (0, 0); m = 2 (one
    level) matches float64."""
    a, bb, r = _cr_case(rng, 3, 4, 8)
    bad = a.clone()
    bad[1, 2] = -bad[1, 2]
    ld, q = band.cr_logdet_q(bad, bb, r)
    assert bool(torch.isnan(ld[1]) and torch.isnan(q[1]))
    ld0, q0 = band.cr_logdet_q(a, bb, r)
    assert torch.equal(ld[[0, 2]], ld0[[0, 2]])
    assert torch.equal(q[[0, 2]], q0[[0, 2]])

    eye = torch.eye(8).expand(3, 4, 8, 8)
    a_pad = torch.cat([a, eye], 1).contiguous()
    bb_pad = torch.cat([bb, torch.zeros_like(bb)], 1)
    r_pad = torch.cat([r, torch.zeros_like(r)], 1)
    ld_p, q_p = band.cr_logdet_q(a_pad, bb_pad, r_pad)
    assert torch.equal(ld_p, ld0) and torch.equal(q_p, q0)
    ld_i, q_i = band.cr_logdet_q(eye.contiguous(), torch.zeros_like(bb),
                                 torch.zeros_like(r))
    assert float(ld_i.abs().max()) == 0.0 and float(q_i.abs().max()) == 0.0

    a2, bb2, r2 = _cr_case(rng, 2, 2, 4)
    ld2, q2 = band.cr_logdet_q(a2, bb2, r2)
    chol = np.linalg.cholesky(_dense64(a2, bb2))
    w = np.stack([np.linalg.solve(c, v) for c, v in
                  zip(chol, r2.double().numpy())])
    np.testing.assert_allclose(
        ld2.numpy(), np.log(np.diagonal(chol, axis1=1, axis2=2)).sum(-1),
        rtol=1e-5)
    np.testing.assert_allclose(q2.numpy(), (w * w).sum(-1), rtol=1e-4)


def test_cr_wrapper_rejects_what_the_kernel_does_not_take(rng):
    a, bb, r = _cr_case(rng, 2, 4, 8)
    before = dict(band.launches)
    with pytest.raises(ValueError):          # m not a power of two
        band.cr_logdet_q(a[:, :3].contiguous(), bb[:, :3].contiguous(),
                         r[:, :24].contiguous())
    big = torch.zeros(1, 2, 132, 132)
    with pytest.raises(ValueError):          # b > 128
        band.cr_logdet_q(big, big, torch.zeros(1, 264))
    with pytest.raises(ValueError):
        band.cr_logdet_q(a.double(), bb, r)
    with pytest.raises(ValueError):
        band.cr_logdet_q(a.transpose(2, 3), bb, r)
    with pytest.raises(ValueError):
        band.cr_logdet_q(a, bb, r.to("meta"))
    with pytest.raises(ValueError):
        band.cr_logdet_q(a.to("meta"), bb.to("meta"), r.to("meta"))
    assert band.launches == before           # CPU tensors launch nothing


# ------------------------------------------------------------ the sampler
def test_band_mode_sampler_matches_distribution():
    """Chains driven with the band-mode joint move land on the posterior
    of the port's dense sampler and of the JAX band-mode sampler: 4
    chains × 30 sweeps, the second halves pooled, log-moments within
    4 standard errors + 0.35 (tests/test_band.py:246-291)."""
    x, y, mask = _problem(100, 128)
    xt, yt, mt = _t(x, y, mask)
    chains, sweeps = 4, 30

    def run(band_joint, seed):
        cfg = MCMCConfig(band_joint=band_joint, band_block=16)
        h = init_chain_states(yt, mt, 2, chains)
        gen = torch.Generator()
        gen.manual_seed(seed)
        lp = seed_lp(xt, yt, mt, h, cfg)
        out = []
        for _ in range(sweeps):
            h, lp = sample_hypers_lp(gen, h, lp, xt, yt, mt, cfg)
            out.append(GPHypers(*(a.numpy().copy() for a in h)))
        return {k: np.stack([getattr(s, k) for s in out], 1)
                for k in ("amp2", "noise", "mean")}

    from spearmint_tpu.engine.suggest import init_chain_states as j_init
    from spearmint_tpu.mcmc import chains as jchains

    xj, yj, mj = map(jnp.asarray, (x, y, mask))
    jcfg = jchains.MCMCConfig(band_joint=True, band_block=16)

    def jchain(k, h0):
        def body(carry, kk):
            h2, lp2 = jchains.sample_hypers_lp(kk, *carry, xj, yj, mj, jcfg)
            return (h2, lp2), h2

        lp0 = jchains.marginal_at(xj, yj, mj, h0, jcfg)
        return jax.lax.scan(body, (h0, lp0), jax.random.split(k, sweeps))[1]

    js = jax.jit(jax.vmap(jchain))(jax.random.split(jax.random.PRNGKey(0),
                                                    chains),
                                   j_init(yj, mj, 2, chains))
    theirs = {k: np.asarray(getattr(js, k)) for k in ("amp2", "noise", "mean")}
    ours = run(True, 0)
    for ref in (run(False, 1), theirs):
        for name in ("amp2", "noise", "mean"):
            a = ours[name][:, sweeps // 2:].ravel()
            b = ref[name][:, sweeps // 2:].ravel()
            la, lb = np.log(np.abs(a) + 1e-6), np.log(np.abs(b) + 1e-6)
            se = np.sqrt(la.var() / 8 + lb.var() / 8)
            assert abs(la.mean() - lb.mean()) < 4 * se + 0.35, (
                name, la.mean(), lb.mean(), se)


def test_band_sweep_evaluates_each_move_on_its_own_path(monkeypatch):
    """In band mode neither move reads the carry: the seed is None, the
    joint move's evaluations are banded, the ls move's dense, and the
    returned lp is the dense marginal at the new state."""
    x, y, mask = _problem(60, 64)
    xt, yt, mt = _t(x, y, mask)
    cfg = MCMCConfig(band_joint=True, band_block=16)
    h = init_chain_states(yt, mt, 2, 3)
    assert seed_lp(xt, yt, mt, h, cfg) is None
    calls = {"band": 0}
    real = band.band_logdet_q

    def counted(*a):
        calls["band"] += 1
        return real(*a)

    monkeypatch.setattr(band, "band_logdet_q", counted)
    gen = torch.Generator()
    gen.manual_seed(4)
    h2, lp = sample_hypers_lp(gen, h, None, xt, yt, mt, cfg)
    assert calls["band"] >= 2
    want = seed_lp(xt, yt, mt, h2, MCMCConfig())
    np.testing.assert_allclose(lp.numpy(), want.numpy(), rtol=1e-6)


# ---------------------------------------------------------- the slice
def test_band_mode_suggest_step_on_the_cpu():
    """suggest_step(band_joint=True) at pad 256 (two 128-blocks, the scan):
    finite EI and every sample usable (n_ok = chains × iters)."""
    n, pad = 200, 256
    rng = np.random.RandomState(1)
    xp = np.zeros((pad, 2), np.float32); xp[:n] = rng.rand(n, 2)
    yp = np.zeros(pad, np.float32)
    yp[:n] = np.sin(3 * xp[:n, 0]) + 0.05 * rng.randn(n)
    mask = np.arange(pad) < n
    h = init_chain_states(torch.tensor(yp), torch.tensor(mask), 2, 3)
    gen = torch.Generator()
    gen.manual_seed(0)
    res = suggest_step(gen, h, xp, yp, mask, np.zeros((4, 2), np.float32),
                       np.zeros(4, bool), rng.rand(64, 2).astype(np.float32),
                       np.ones(64, bool),
                       SuggestConfig(mcmc_iters=2, grid_subset=3,
                                     lbfgs_iters=5, band_joint=True),
                       device="cpu")
    assert int(res.n_ok) == 3 * 2
    assert bool(torch.isfinite(res.ei).all() and torch.isfinite(res.x_opt).all())


def test_cyclic_reduction_gate_differs_from_jax_at_2048(monkeypatch):
    """The port takes cyclic reduction above pad 2048 (``use_cr``); the JAX
    factory from 2048 on, where ``_effective_jitter`` adds no conditioning
    floor yet.  The JAX factory's choice is read at pad 2048 with its
    reduction and evaluators stubbed."""
    assert band.use_cr(2048) is False and band.use_cr(2560) is True
    assert band.use_cr(5120) is True and band.use_cr(1024) is False
    chose = []
    zeros = jnp.zeros((16, 128, 128))
    monkeypatch.setattr(jband, "reduce_to_band",
                        lambda m0, vecs, b: (zeros, zeros, jnp.zeros((2048, 2))))
    monkeypatch.setattr(jband, "cr_eval",
                        lambda *a: chose.append("cr") or (0.0, 0.0))
    monkeypatch.setattr(jband, "band_logdet_q",
                        lambda *a: chose.append("scan") or (0.0, 0.0))
    marg = jband.band_marginal_factory(
        jnp.zeros((2048, 2)), jnp.zeros(2048), jnp.ones(2048, bool),
        jnp.ones(2), jmatern52)
    marg(jnp.float32(0.0), jnp.float32(1.0), jnp.float32(0.1))
    assert chose == ["cr"]


@pytest.mark.parametrize("min_pad,pad,use_obs,device,want", [
    (2048, 2560, False, "cuda", True),
    (2048, 2048, False, "cuda", True),
    (2048, 5120, False, "cuda", True),
    (2048, 1024, False, "cuda", False),     # below band_joint_min
    (0, 5120, False, "cuda", False),        # off
    (16, 20, False, "cuda", False),         # not 128-aligned
    (2048, 5120, True, "cuda", False),      # the obs-sharded path
    (2048, 5120, False, "cpu", False),      # the CPU runs dense
])
def test_chooser_band_gate(min_pad, pad, use_obs, device, want):
    assert band_gate(min_pad, pad, use_obs, torch.device(device)) is want
