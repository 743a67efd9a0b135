"""Subspace-constrained Gaussians: PCGMM and SCGMM.

A host copy (numpy only) of `aaltoasr_tpu/ops/subspaces.py`.

Reference: `aku/Subspaces.{hh,cc}` + the `USE_SUBSPACE_COV` classes in
`aku/Distributions.{hh,cc}` (PrecisionConstrainedGaussian at
Distributions.hh:664, SubspaceConstrainedGaussian at :721).  Upstream
ships this code but does not build it (`aku/CMakeLists.txt` omits
Subspaces.cc); we implement it fully.

* PCGMM (precision subspace, Subspaces.cc:22-470): every Gaussian's
  precision is constrained to P_g = sum_b lambda_gb S_b over a shared
  basis of symmetric matrices.  Stored per Gaussian: transformed mean
  tm = P mu and the coefficients.  log N(x) = const + tm'x
  - 0.5 x'P x with const = 0.5 log det P - 0.5 tm'P^-1 tm
  (PrecisionConstrainedGaussian::recompute_constant,
  Distributions.cc:1786).
* SCGMM (exponential subspace, Subspaces.cc:690-1420): the full
  exponential parameter theta = [psi; m2v(P)] is constrained to
  theta_g = sum_b lambda_gb b_b (theta_P . m2v(-0.5 xx') = -0.5 x'Px
  through the inner-product-preserving vec map).  log N(x) = K(theta) + theta'f(x)
  with f(x) = [x; m2v(-0.5 x x')] and K = 0.5(-d log 2pi + log det P
  - psi'P^-1 psi) (ExponentialSubspace::K, Subspaces.cc:1217-1251).

Scope note: `PrecisionSubspace::optimize_basis` is DECLARED in
Subspaces.hh:84 but never defined anywhere in the reference — basis
estimation upstream is exactly the PCA initialization implemented
here; per-Gaussian coefficients are the only trained parameters.

Known defects in the reference's (never-compiled) code, corrected here
and covered by tests: PrecisionConstrainedGaussian::
compute_log_likelihood (Distributions.cc:1639) discards the quadratic
term behind a stray ';', and SubspaceConstrainedGaussian::read
(Distributions.cc:1890-1910) misses the 0.5 factor of K.  We score with
the exact Gaussian log-density the optimization itself uses.

Device mapping: scoring stays FACTORED — scores = bias + phi(x) @ M
+ (phi(x) @ basis) @ Lambda, two matmuls through the shared
[D_phi, B] basis instead of materializing per-Gaussian precisions;
that compression is the entire point of subspace models.  Basis
initialization (weighted PCA, Subspaces.cc:22-126 / 1010-1171) and
per-Gaussian coefficient optimization (concave maximum-likelihood
objectives, solved with damped Newton / line-searched L-BFGS instead
of the reference's HCL library) are host-side NumPy by design.
"""

from __future__ import annotations

import numpy as np

LOG_2PI = float(np.log(2.0 * np.pi))


# ---------------------------------------------------------------------------
# symmetric matrix <-> vector maps (LinearAlgebra::map_m2v / map_v2m:
# lower triangle row-major, off-diagonals scaled by sqrt(2) so that
# <A, B>_F == m2v(A) . m2v(B))
# ---------------------------------------------------------------------------

def tri_indices(d: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(rows, cols, scale) of the m2v layout for dimension d."""
    ii, jj, cc = [], [], []
    for i in range(d):
        for j in range(i + 1):
            ii.append(i)
            jj.append(j)
            cc.append(1.0 if i == j else np.sqrt(2.0))
    return (np.asarray(ii), np.asarray(jj),
            np.asarray(cc, dtype=np.float64))


def map_m2v(m: np.ndarray) -> np.ndarray:
    d = m.shape[0]
    ii, jj, cc = tri_indices(d)
    return m[ii, jj] * cc


def map_v2m(v: np.ndarray) -> np.ndarray:
    d = int(round((np.sqrt(1 + 8 * len(v)) - 1) / 2))
    ii, jj, cc = tri_indices(d)
    m = np.zeros((d, d), dtype=np.float64)
    m[ii, jj] = v / cc
    m[jj, ii] = v / cc
    return m


def _force_min_eig(cov: np.ndarray, min_eig: float = 0.01) -> np.ndarray:
    """LinearAlgebra::force_min_eig semantics: clamp eigenvalues up."""
    w, v = np.linalg.eigh(cov)
    if w.min() >= min_eig:
        return cov
    w = np.maximum(w, min_eig)
    return (v * w) @ v.T


def _matrix_power(m: np.ndarray, p: float) -> np.ndarray:
    w, v = np.linalg.eigh(m)
    return (v * np.power(np.maximum(w, 1e-12), p)) @ v.T


def _max_psd_step(P: np.ndarray, dP: np.ndarray) -> float:
    """Largest t with P + t*dP still positive definite (the reference's
    limit_line_search via generalized eigenvalues, Subspaces.cc:367)."""
    nh = _matrix_power(P, -0.5)
    w = np.linalg.eigvalsh(nh @ dP @ nh)
    wmin = w.min()
    if wmin >= 0:
        return np.inf
    return -1.0 / wmin


# ---------------------------------------------------------------------------
# PrecisionSubspace
# ---------------------------------------------------------------------------

class PrecisionSubspace:
    """Shared basis {S_b} of symmetric matrices for PCGMM precisions."""

    def __init__(self, basis: np.ndarray | None = None):
        # basis: [B, D, D]
        self.basis = basis

    @property
    def subspace_dim(self) -> int:
        return 0 if self.basis is None else self.basis.shape[0]

    @property
    def feature_dim(self) -> int:
        return 0 if self.basis is None else self.basis.shape[1]

    def compute_precision(self, lam: np.ndarray) -> np.ndarray:
        return np.tensordot(np.asarray(lam, np.float64), self.basis, 1)

    # -- initialization (Subspaces.cc:22-126) -----------------------------
    @classmethod
    def initialize_pca(cls, weights, sample_covs, basis_dim: int
                       ) -> "PrecisionSubspace":
        """Weighted PCA of normalized sample precisions.

        S_0 = m^(1/2) Pbar m^(1/2) with m the weighted mean covariance
        and Pbar the weighted mean of normalized precisions; S_i are the
        top eigenvectors of the normalized-precision scatter, mapped
        back through m^(1/2) (Subspaces.cc:55-126).
        """
        c = np.asarray(weights, np.float64)
        c = c / c.sum()
        covs = [np.asarray(s, np.float64) for s in sample_covs]
        d = covs[0].shape[0]
        m = sum(ci * si for ci, si in zip(c, covs))
        m_sqrt = _matrix_power(m, 0.5)
        m_nsqrt = _matrix_power(m, -0.5)
        precs = []
        for s in covs:
            s = _force_min_eig(s)
            precs.append(m_nsqrt @ np.linalg.inv(s) @ m_nsqrt)
        vecs = np.stack([map_m2v(p) for p in precs])      # [N, dvec]
        mean_vec = c @ vecs
        centered = vecs - mean_vec
        C = (centered * c[:, None]).T @ centered
        w, V = np.linalg.eigh(C)
        order = np.argsort(w)[::-1]
        basis = np.zeros((basis_dim, d, d), dtype=np.float64)
        pbar = np.tensordot(c, np.stack(precs), 1)
        basis[0] = m_sqrt @ pbar @ m_sqrt
        for i in range(1, basis_dim):
            Si = map_v2m(V[:, order[i - 1]])
            basis[i] = m_sqrt @ Si @ m_sqrt
        return cls(basis)

    # -- ML coefficients (PcgmmLambdaFcnl; Subspaces.cc:128-167) ----------
    def optimize_coefficients(self, sample_cov: np.ndarray,
                              lam0: np.ndarray | None = None,
                              max_iter: int = 100,
                              tol: float = 1e-9) -> np.ndarray:
        """argmax_lambda  log det P(lambda) - tr(S P(lambda)).

        The objective is concave in lambda (P is linear in lambda), so a
        damped Newton iteration with a PSD-limited step converges to the
        global ML optimum the reference's BFGS searches for.
        """
        S = np.asarray(sample_cov, np.float64)
        B = self.subspace_dim
        lam = np.zeros(B) if lam0 is None else np.array(lam0, np.float64)
        if lam0 is None or not self._is_pd(lam):
            lam[:] = 0.0
            lam[0] = self._safe_first_coeff(S)
        Bv = np.stack([map_m2v(b) for b in self.basis])    # [B, dvec]
        for _ in range(max_iter):
            P = self.compute_precision(lam)
            Pinv = np.linalg.inv(P)
            grad = Bv @ map_m2v(Pinv - S)
            # Hessian H_bc = -tr(S_b Pinv S_c Pinv)
            PB = np.einsum("ij,bjk,kl->bil", Pinv, self.basis, Pinv)
            H = -np.einsum("bij,cji->bc", self.basis, PB)
            try:
                step = np.linalg.solve(H, -grad)
            except np.linalg.LinAlgError:
                step = grad
            if step @ grad <= 0:            # not an ascent direction
                step = grad
            dP = np.tensordot(step, self.basis, 1)
            t = min(1.0, 0.99 * _max_psd_step(P, dP))
            f0 = self._objective(lam, S)
            while t > 1e-12:
                f1 = self._objective(lam + t * step, S)
                if f1 >= f0 - 1e-12:
                    break
                t *= 0.5
            lam = lam + t * step
            if t * np.linalg.norm(step) < tol * (1 + np.linalg.norm(lam)):
                break
        return lam

    def _objective(self, lam, S):
        P = self.compute_precision(lam)
        sign, ld = np.linalg.slogdet(P)
        if sign <= 0:
            return -np.inf
        return ld - np.trace(S @ P)

    def _is_pd(self, lam):
        try:
            np.linalg.cholesky(self.compute_precision(lam))
            return True
        except np.linalg.LinAlgError:
            return False

    def _safe_first_coeff(self, S):
        """scale of S_0 that maximizes logdet(aS_0) - tr(S aS_0)."""
        tr = np.trace(S @ self.basis[0])
        return self.feature_dim / max(tr, 1e-12)

    # -- text I/O (Subspaces.cc:169-206: full matrices row-major) ---------
    def write(self, f) -> None:
        f.write(f"{self.feature_dim} {self.subspace_dim}\n")
        for b in self.basis:
            f.write(" ".join(_fmt(x) for x in b.reshape(-1)) + "\n")

    @classmethod
    def read(cls, it) -> "PrecisionSubspace":
        d = int(next(it))
        bdim = int(next(it))
        basis = np.zeros((bdim, d, d), dtype=np.float64)
        for b in range(bdim):
            basis[b] = np.array(
                [float(next(it)) for _ in range(d * d)]).reshape(d, d)
        return cls(basis)

    # -- per-Gaussian helpers ---------------------------------------------
    def constant(self, tm: np.ndarray, lam: np.ndarray) -> float:
        """0.5 log det P - 0.5 tm' P^-1 tm
        (recompute_constant, Distributions.cc:1786)."""
        P = self.compute_precision(lam)
        sign, ld = np.linalg.slogdet(P)
        mu = np.linalg.solve(P, tm)
        return 0.5 * ld - 0.5 * float(tm @ mu)


# ---------------------------------------------------------------------------
# ExponentialSubspace
# ---------------------------------------------------------------------------

class ExponentialSubspace:
    """Shared basis of exponential parameters theta = [psi; m2v(-P/2)]."""

    def __init__(self, basis_theta: np.ndarray | None = None,
                 feature_dim: int = 0):
        # basis_theta: [B, d + d(d+1)/2]
        self.basis_theta = basis_theta
        self._d = feature_dim

    @property
    def subspace_dim(self) -> int:
        return 0 if self.basis_theta is None else self.basis_theta.shape[0]

    @property
    def feature_dim(self) -> int:
        return self._d

    @property
    def exponential_dim(self) -> int:
        return self._d + self._d * (self._d + 1) // 2

    def compute_theta(self, lam) -> np.ndarray:
        return np.asarray(lam, np.float64) @ self.basis_theta

    def split_theta(self, theta) -> tuple[np.ndarray, np.ndarray]:
        """theta -> (psi, P).  The P block stores m2v(P); pairing with
        f = [x; m2v(-0.5 xx')] yields psi'x - 0.5 x'P x
        (initialize_basis_pca stores m2v(total_precision) in theta,
        Subspaces.cc:1139-1145)."""
        d = self._d
        psi = theta[:d]
        P = map_v2m(theta[d:])
        return psi, P

    def compute_precision(self, lam) -> np.ndarray:
        return self.split_theta(self.compute_theta(lam))[1]

    def compute_mu(self, lam) -> np.ndarray:
        psi, P = self.split_theta(self.compute_theta(lam))
        return np.linalg.solve(P, psi)

    def K(self, theta: np.ndarray) -> float:
        """log-normalizer (Subspaces.cc:1217-1251, WITH its 0.5)."""
        psi, P = self.split_theta(theta)
        sign, ld = np.linalg.slogdet(P)
        if sign <= 0:
            return -np.inf
        return 0.5 * (-self._d * LOG_2PI + ld
                      - float(psi @ np.linalg.solve(P, psi)))

    @staticmethod
    def exp_feature(mean: np.ndarray, second_moment: np.ndarray
                    ) -> np.ndarray:
        """f-bar = [m; m2v(-0.5 E[xx'])] (precompute, Subspaces.cc:745)."""
        return np.concatenate([mean, map_m2v(-0.5 * second_moment)])

    @staticmethod
    def _suff_stat_cov(mu: np.ndarray, Sig: np.ndarray) -> np.ndarray:
        """Cov_theta[f(x)] for f = [x; m2v(-0.5 xx')] under N(mu, Sig):
        the exponential-family Hessian of K (Gaussian moment formulas,
        Isserlis).  Lets coefficient optimization run damped Newton."""
        d = len(mu)
        ii, jj, cc = tri_indices(d)
        # Cov(x_i, x_k x_l) = mu_k Sig_il + mu_l Sig_ik
        Cxq = -0.5 * cc[None, :] * (
            mu[ii][None, :] * Sig[:, jj] + mu[jj][None, :] * Sig[:, ii])
        # Cov(x_i x_j, x_k x_l)
        S_ik = Sig[np.ix_(ii, ii)]
        S_il = Sig[np.ix_(ii, jj)]
        S_jk = Sig[np.ix_(jj, ii)]
        S_jl = Sig[np.ix_(jj, jj)]
        m_i, m_j = mu[ii], mu[jj]
        Cqq = (S_ik * S_jl + S_il * S_jk
               + np.outer(m_i, m_i) * S_jl + np.outer(m_i, m_j) * S_jk
               + np.outer(m_j, m_i) * S_il + np.outer(m_j, m_j) * S_ik)
        Cqq = 0.25 * np.outer(cc, cc) * Cqq
        top = np.concatenate([Sig, Cxq], axis=1)
        bot = np.concatenate([Cxq.T, Cqq], axis=1)
        return np.concatenate([top, bot], axis=0)

    # -- initialization (Subspaces.cc:1010-1171) ---------------------------
    @classmethod
    def initialize_pca(cls, weights, covs, means, basis_dim: int
                       ) -> "ExponentialSubspace":
        """First basis = exponential parameters of the pooled Gaussian;
        the rest are top singular vectors of the centered per-Gaussian
        natural parameters [P mu; m2v(P)]."""
        c = np.asarray(weights, np.float64)
        c = c / c.sum()
        covs = [_force_min_eig(np.asarray(s, np.float64)) for s in covs]
        means = [np.asarray(m, np.float64) for m in means]
        d = covs[0].shape[0]
        dvec = d * (d + 1) // 2
        total_mean = sum(ci * mi for ci, mi in zip(c, means))
        total_cov = sum(ci * (si + np.outer(mi, mi))
                        for ci, si, mi in zip(c, covs, means))
        total_cov -= np.outer(total_mean, total_mean)
        total_prec = np.linalg.inv(total_cov)
        total_psi = total_prec @ total_mean
        params = np.zeros((len(covs), d + dvec))
        for i, (s, m) in enumerate(zip(covs, means)):
            P = np.linalg.inv(s)
            params[i, :d] = P @ m
            params[i, d:] = map_m2v(P)
        params -= params.mean(axis=0)
        # top right-singular directions of the parameter cloud; the
        # FULL Vt supplies an orthonormal complement when basis_dim
        # exceeds the sample rank (the reference's LaSVD_IP likewise
        # produces the full d_exp x d_exp U, Subspaces.cc:1117-1125)
        U, sv, Vt = np.linalg.svd(params, full_matrices=True)
        basis = np.zeros((basis_dim, d + dvec))
        basis[0, :d] = total_psi
        basis[0, d:] = map_m2v(total_prec)
        for i in range(1, basis_dim):
            # singular vectors already live in [psi; m2v(P)] coordinates
            basis[i] = Vt[i - 1]
        return cls(basis, d)

    # -- ML coefficients (ScgmmLambdaFcnl; Subspaces.cc:712-742) ----------
    def optimize_coefficients(self, sample_mean, sample_cov,
                              lam0: np.ndarray | None = None,
                              max_iter: int = 200,
                              tol: float = 1e-9) -> np.ndarray:
        """argmax_lambda  theta(lambda)'f-bar + K(theta(lambda))
        (H(theta, f-bar), Subspaces.cc:1254-1262; K = -log-partition
        in this convention, so the objective is concave).

        Exponential-family ML: the gradient is B(f-bar - E_theta[f]),
        concave in theta and hence in lambda.  Line-searched gradient
        ascent with the PSD step limit (the reference's HCL BFGS has the
        same fixed point)."""
        m = np.asarray(sample_mean, np.float64)
        S = np.asarray(sample_cov, np.float64)
        fbar = self.exp_feature(m, S + np.outer(m, m))
        B = self.subspace_dim
        lam = np.zeros(B) if lam0 is None else np.array(lam0, np.float64)

        def pd(l):
            try:
                np.linalg.cholesky(self.compute_precision(l))
                return True
            except np.linalg.LinAlgError:
                return False

        if lam0 is None or not pd(lam):
            lam[:] = 0.0
            lam[0] = 1.0
            if not pd(lam):
                raise ValueError("basis_theta[0] is not a valid Gaussian")

        def objective(l):
            theta = self.compute_theta(l)
            k = self.K(theta)
            if not np.isfinite(k):
                return -np.inf
            return float(theta @ fbar) + k

        basis_P = np.stack([self.split_theta(b)[1]
                            for b in self.basis_theta])
        f0 = objective(lam)
        for _ in range(max_iter):
            theta = self.compute_theta(lam)
            psi, P = self.split_theta(theta)
            Sig = np.linalg.inv(P)
            mu = Sig @ psi
            grad = self.basis_theta @ (
                fbar - self.exp_feature(mu, Sig + np.outer(mu, mu)))
            # damped Newton: Hessian = -B Cov_theta[f] B' (concave)
            H = self.basis_theta @ self._suff_stat_cov(mu, Sig) \
                @ self.basis_theta.T
            try:
                step = np.linalg.solve(
                    H + 1e-10 * np.eye(B) * np.trace(H) / B, grad)
            except np.linalg.LinAlgError:
                step = grad
            if step @ grad <= 0:
                step = grad
            dP = np.tensordot(step, basis_P, 1)
            t = min(1.0, 0.99 * _max_psd_step(P, dP))
            improved = False
            while t > 1e-14:
                f1 = objective(lam + t * step)
                if f1 > f0 - 1e-12:
                    lam = lam + t * step
                    improved = (f1 > f0 + tol * (1 + abs(f0))
                                or t * np.linalg.norm(step) > tol)
                    f0 = max(f0, f1)
                    break
                t *= 0.5
            if not improved:
                break
        return lam

    # -- text I/O (Subspaces.cc:1175-1214: theta vectors) ------------------
    def write(self, f) -> None:
        f.write(f"{self.feature_dim} {self.subspace_dim}\n")
        for b in self.basis_theta:
            f.write(" ".join(_fmt(x) for x in b) + "\n")

    @classmethod
    def read(cls, it) -> "ExponentialSubspace":
        d = int(next(it))
        bdim = int(next(it))
        dexp = d + d * (d + 1) // 2
        basis = np.zeros((bdim, dexp))
        for b in range(bdim):
            basis[b] = [float(next(it)) for _ in range(dexp)]
        return cls(basis, d)

    def constant(self, lam) -> float:
        """K(theta(lambda)) — the correct 0.5-scaled normalizer (the
        reference's SubspaceConstrainedGaussian::read drops the 0.5;
        its own K() does not)."""
        return self.K(self.compute_theta(lam))


def _fmt(x: float) -> str:
    return np.format_float_positional(float(x), unique=True, trim="0")


# ---------------------------------------------------------------------------
# factored device scoring tables (float64, as the full-covariance product
# that shares phi(x) with them: `ops/gmm.py`)
# ---------------------------------------------------------------------------

def pcgmm_tables(ps: PrecisionSubspace, params: dict, dim: int,
                 num_padded: int) -> dict:
    """Device tables for PCGMM members of a pool.

    params: {gauss_index: (tm, lam)}.  Scoring contribution for
    Gaussian g: phi_quad(x) @ svec[:, b] picks up -0.5 x'S_b x, then
    @ Lambda[:, g] applies the coefficients; tm and the constant join
    the regular score_matrix/bias path.
    """
    Bss = ps.subspace_dim
    # basis columns over phi(x) = [vec(xx'), x]: quad block holds the
    # FULL vec of S_b scaled by -0.5 so that
    # vec(xx') . (-0.5 vec(S_b)) == -0.5 x'S_b x; x block is zero
    svec = np.zeros((dim * dim + dim, Bss))
    for b in range(Bss):
        svec[:dim * dim, b] = (-0.5 * ps.basis[b]).reshape(-1)
    lam = np.zeros((Bss, num_padded))
    for g, (tm, l) in params.items():
        lam[:, g] = l
    return {"sub_basis": svec, "sub_lambda": lam}


def scgmm_tables(es: ExponentialSubspace, params: dict, dim: int,
                 num_padded: int) -> dict:
    """Device tables for SCGMM members: theta'f(x) factored through the
    basis.  basis columns map to phi(x) = [vec(xx'), x]: the psi block
    hits the x slot; the P block (stored as m2v(-0.5 P)) becomes the
    full -0.5 P matrix over vec(xx')."""
    Bss = es.subspace_dim
    d = dim
    mat = np.zeros((d * d + d, Bss))
    for b in range(Bss):
        psi, P = es.split_theta(es.basis_theta[b])
        mat[:d * d, b] = (-0.5 * P).reshape(-1)
        mat[d * d:, b] = psi
    lam = np.zeros((Bss, num_padded))
    for g, l in params.items():
        lam[:, g] = l
    return {"sub_basis": mat, "sub_lambda": lam}
