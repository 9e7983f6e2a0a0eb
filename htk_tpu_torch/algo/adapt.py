"""Speaker adaptation: MLLR mean, CMLLR (constrained), MAP.

Mirrors `HTKLib/HAdapt.c` / `HTKLib/HMap.c` (SURVEY.md §2.1):

- **MLLR mean**: mu' = A mu + b = W xi, xi = [1; mu]. W solves row-wise
  W_i = G_i^{-1} k_i with
    G_i = sum_m (gamma_m / sigma^2_mi) xi_m xi_m^T
    k_i = sum_m (sumx_mi / sigma^2_mi) xi_m
  — needs only the per-Gaussian occupancy and first-order accumulators
  that standard Baum-Welch already produces (fb.Accumulators).

- **CMLLR**: feature transform x' = A x + b maximising the constrained
  likelihood; estimated row-by-row with the cofactor iteration
  (HAdapt.c's closed-form row update with the log|A| term). Needs
  second-order data statistics, accumulated on device by cmllr_stats().

- **MAP**: mu_map = (tau*mu0 + sumx) / (tau + occ) (HMap.c), wired into
  reestimation via map_tau.

Transforms store/load as TMF files using HTK's macro syntax (~a blocks);
the body layout follows HTK's MLLRMEAN/CMLLR xform kinds in simplified
form [LC — byte-level parity with HTK TMFs unverified, reference absent].

Copied from `htk_tpu/algo/adapt.py` into the PyTorch port: numpy, behaviour
unchanged. The port's accumulators hold tensors that may live on the card;
each function that reads them converts them to numpy once, at its entry
(`host_accs`), and the numerics below are the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from ..models.hmmset import CompiledHMMSet
from ..utils.errors import HError, contained
from .fb import Accumulators


def host_accs(accs: Accumulators) -> Accumulators:
    """`accs` with every field as host numpy (a tensor on any device is
    copied to the host; numpy and scalars pass through)."""
    return Accumulators(*(x.detach().cpu().numpy() if hasattr(x, "detach")
                          else x for x in accs))


def speaker_from_mask(mask: str, name: str) -> str:
    """Extract the speaker id from a filename using an HTK -h mask.

    HTK masks use `%` to capture one speaker-name character and `*` as a
    wildcard, e.g. `*/%%%_*.mfc` captures the first 3 chars of the
    basename. Matching follows HAdapt's MaskMatch semantics; returns the
    captured characters, or the whole basename when the mask doesn't
    match (with a warning at the caller).
    """
    import os as _os

    cand = name
    base = _os.path.basename(name)

    def match(m: str, s: str):
        # returns captured string or None; simple backtracking matcher
        if not m:
            return "" if not s else None
        if m[0] == "*":
            for k in range(len(s) + 1):
                r = match(m[1:], s[k:])
                if r is not None:
                    return r
            return None
        if not s:
            return None
        if m[0] == "%":
            r = match(m[1:], s[1:])
            return None if r is None else s[0] + r
        if m[0] == "?" or m[0] == s[0]:
            r = match(m[1:], s[1:])
            return r
        return None

    for target in (name, base):
        got = match(mask, target)
        if got:
            return got
    return _os.path.splitext(base)[0]


@dataclass
class Transform:
    kind: str  # "MLLRMEAN" | "CMLLR"
    A: np.ndarray  # (D, D)
    b: np.ndarray  # (D,)
    var_scale: Optional[np.ndarray] = None  # (D,) MLLRVAR diagonal H

    def apply_to_means(self, means: np.ndarray) -> np.ndarray:
        if self.kind != "MLLRMEAN":
            HError(7450, "apply_to_means: transform kind %s", self.kind)
        return means @ self.A.T + self.b[None, :]

    def apply_to_vars(self, variances: np.ndarray) -> np.ndarray:
        """sigma'^2 = H * sigma^2 (identity when no variance transform)."""
        if self.var_scale is None:
            return variances
        return variances * self.var_scale[None, :]

    def apply_to_features(self, feats: np.ndarray) -> np.ndarray:
        if self.kind != "CMLLR":
            HError(7450, "apply_to_features: transform kind %s", self.kind)
        return feats @ self.A.T + self.b[None, :]


def _estimate_mllr_mean_fc(comp: CompiledHMMSet, accs: Accumulators
                           ) -> Transform:
    """Exact global MLLR mean solve for a full-covariance set.

    Full precisions couple the rows of W, so instead of D independent
    (D+1)-dim solves the normal equations become ONE D(D+1) system:
        sum_m P_m W (occ_m xi_m xi_m^T) = sum_m P_m sumx_m xi_m^T
    flattened as A[(i,a),(j,b)] = sum_m P_m[i,j] S_m[a,b] — ~1.5k
    unknowns at D=39, one host f64 solve (the heavy part is a single
    (D^2, M)x(M, (D+1)^2) GEMM). P_m comes from the compiled precision
    Cholesky (fc_proj = L, P = L L^T), which also embeds DIAGC Gaussians
    of a mixed set correctly.
    """
    occ = np.asarray(accs.occ, np.float64)
    sum_x = np.asarray(accs.sum_x, np.float64)
    L = comp.fc_proj.astype(np.float64)
    P = L @ np.swapaxes(L, 1, 2)  # (M, D, D) precisions
    mu = comp.means.astype(np.float64)
    M, D = mu.shape
    Dp = D + 1
    xi = np.concatenate([np.ones((M, 1)), mu], axis=1)  # (M, Dp)
    S = np.einsum("m,ma,mb->mab", occ, xi, xi)  # (M, Dp, Dp)
    T2 = P.reshape(M, D * D).T @ S.reshape(M, Dp * Dp)
    A = (T2.reshape(D, D, Dp, Dp).transpose(0, 2, 1, 3)
           .reshape(D * Dp, D * Dp))
    y = np.einsum("mij,mj->mi", P, sum_x)  # (M, D) = P_m sumx_m
    K = y.T @ xi  # (D, Dp)
    A += np.eye(D * Dp) * 1e-6  # ridge for unseen dims
    W = np.linalg.solve(A, K.reshape(-1)).reshape(D, Dp)
    return Transform(kind="MLLRMEAN", A=W[:, 1:].copy(), b=W[:, 0].copy())


def fc_mu_from_means(comp: CompiledHMMSet, means: np.ndarray) -> np.ndarray:
    """FULLC scorer projected means after a mean-space transform.

    fc_mu = mu @ L per Gaussian; covariances are untouched by MLLRMEAN,
    so fc_proj and the gConsts stay as compiled."""
    return np.einsum("md,mde->me", means.astype(np.float64),
                     comp.fc_proj.astype(np.float64)).astype(np.float32)


def block_ranges(D: int, blocks: int):
    """Split D dims into `blocks` contiguous equal-ish ranges (HAdapt
    BLOCKINFO semantics; 3 blocks on a _D_A vector = statics/Δ/ΔΔ)."""
    blocks = max(1, min(int(blocks), D))
    base = D // blocks
    rem = D % blocks
    out = []
    lo = 0
    for b in range(blocks):
        hi = lo + base + (1 if b < rem else 0)
        out.append((lo, hi))
        lo = hi
    return out


def estimate_mllr_mean(comp: CompiledHMMSet, accs: Accumulators,
                       min_occ: float = 1e-2,
                       blocks: int = 1) -> Transform:
    """Global MLLR mean transform from standard FB accumulators.

    Full-covariance sets route to the exact coupled-row solve; diagonal
    sets use HAdapt's row-wise closed form. `blocks` > 1 (HADAPT:
    BLOCKS) restricts each row to its own contiguous block of input
    dims — HTK's answer to sparse adaptation data (a full D x (D+1)
    transform from a few hundred frames is under-determined and can
    actively hurt; 3 blocks on _D_A features keep statics/Δ/ΔΔ
    separate)."""
    accs = host_accs(accs)
    occ = np.asarray(accs.occ, np.float64)
    if occ.sum() < min_occ:
        HError(7440, "estimate_mllr_mean: no adaptation data")
    if getattr(comp, "full_cov", False):
        return _estimate_mllr_mean_fc(comp, accs)
    sum_x = np.asarray(accs.sum_x, np.float64)
    mu = comp.means.astype(np.float64)
    var = comp.variances.astype(np.float64)
    M, D = mu.shape

    xi = np.concatenate([np.ones((M, 1)), mu], axis=1)  # (M, D+1)
    W = np.zeros((D, D + 1))
    ranges = block_ranges(D, blocks)
    for lo, hi in ranges:
        cols = np.r_[0, 1 + np.arange(lo, hi)]
        xib = xi[:, cols]
        for i in range(lo, hi):
            w_m = occ / var[:, i]  # (M,)
            G = (xib * w_m[:, None]).T @ xib
            k = (sum_x[:, i] / var[:, i]) @ xib
            G += np.eye(len(cols)) * 1e-6  # ridge for unseen dims
            W[i, cols] = np.linalg.solve(G, k)
    return Transform(kind="MLLRMEAN", A=W[:, 1:].copy(), b=W[:, 0].copy())


def estimate_mllr_var(
    comp: CompiledHMMSet,
    accs: Accumulators,
    adapted_means: np.ndarray,
    sel: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Diagonal MLLR variance scaling H (HAdapt.c MLLRVAR role [LC]).

    sigma'^2 = H * sigma^2 with H the occupancy-weighted second moment of
    the data about the (mean-adapted) Gaussian means, normalised by the
    model variances:  H_d = sum_m E_m[(x_d - mu'_md)^2] / sigma2_md over
    sum_m occ_m.  Padded dims (multi-stream PAD_VAR) are excluded.
    Diagonal sets only — a diagonal H on a full covariance is undefined."""
    accs = host_accs(accs)
    if getattr(comp, "full_cov", False):
        HError(7450, "estimate_mllr_var: full-covariance sets adapt "
                     "means only (MLLRMEAN)")
    occ = np.asarray(accs.occ, np.float64)
    if sel is not None:
        occ = np.where(sel, occ, 0.0)
    rows = occ > 0
    sx = np.asarray(accs.sum_x, np.float64) * rows[:, None]
    sxx = np.asarray(accs.sum_xx, np.float64) * rows[:, None]
    var = comp.variances.astype(np.float64)
    live = var < 1e10
    mu = adapted_means.astype(np.float64)
    num = (sxx - 2.0 * mu * sx + occ[:, None] * mu * mu) / var
    num = np.where(live, num, 0.0)
    den = (occ[:, None] * live).sum(axis=0)
    H = num.sum(axis=0) / np.maximum(den, 1e-8)
    return np.clip(H, 1e-2, 1e2)


def build_regression_tree(comp: CompiledHMMSet, n_terminals: int):
    """Binary centroid-split regression tree over Gaussians (HAdapt's
    RC regression tree; flat k-means classes are its depth-1 case).

    Splits the largest leaf (2-means over Gaussian means) until
    `n_terminals` leaves. Returns (classes, parent, leaf_node):
    classes (M,) leaf class per Gaussian; parent (n_nodes,) with
    parent[0] = -1 (children always index above their parent);
    leaf_node (C,) tree-node index of each leaf class."""
    from .kmeans import kmeans

    means = comp.means.astype(np.float64)
    M = means.shape[0]
    parent = [-1]
    node_gauss = {0: np.arange(M)}
    leaves = [0]
    while len(leaves) < n_terminals:
        cand = max(leaves, key=lambda n: len(node_gauss[n]))
        idx = node_gauss[cand]
        if len(idx) < 2:
            break
        assign, _m = kmeans(means[idx], 2)
        if len(np.unique(assign)) < 2:
            break
        c0 = len(parent)
        parent.append(cand)
        c1 = len(parent)
        parent.append(cand)
        node_gauss[c0] = idx[assign == 0]
        node_gauss[c1] = idx[assign == 1]
        leaves.remove(cand)
        leaves += [c0, c1]
    classes = np.zeros(M, np.int32)
    leaf_node = np.zeros(len(leaves), np.int32)
    for c, n in enumerate(sorted(leaves)):
        classes[node_gauss[n]] = c
        leaf_node[c] = n
    return classes, np.asarray(parent, np.int32), leaf_node


def estimate_mllr_tree(
    comp: CompiledHMMSet,
    accs: Accumulators,
    classes: np.ndarray,
    parent: np.ndarray,
    leaf_node: np.ndarray,
    occ_thresh: float = 700.0,
    mllr_var: bool = False,
):
    """Regression-tree MLLR with occupancy back-off (HAdapt's tree walk).

    Each leaf walks up the tree to the deepest ancestor whose subtree
    occupancy reaches `occ_thresh` (the root always qualifies) and shares
    that node's transform. Returns (xforms, class_to_xf) in the same form
    as `estimate_mllr_classes`, so TMF I/O and application are shared."""
    accs = host_accs(accs)
    occ = np.asarray(accs.occ, np.float64)
    n_nodes = len(parent)
    node_occ = np.zeros(n_nodes)
    for c, n in enumerate(leaf_node):
        node_occ[int(n)] = occ[classes == c].sum()
    for n in range(n_nodes - 1, 0, -1):
        node_occ[int(parent[n])] += node_occ[n]

    # ancestors of each leaf class (inclusive), for subtree Gaussian masks
    anc = []
    for c in range(len(leaf_node)):
        path = set()
        m = int(leaf_node[c])
        while m != -1:
            path.add(m)
            m = int(parent[m])
        anc.append(path)
    leaf_of_gauss = classes

    def node_xform(m: int):
        sel = np.fromiter((m in anc[int(leaf_of_gauss[g])]
                           for g in range(len(leaf_of_gauss))),
                          bool, len(leaf_of_gauss))
        sub = Accumulators(
            occ=np.where(sel, np.asarray(accs.occ), 0.0).astype(np.float32),
            sum_x=np.where(sel[:, None], np.asarray(accs.sum_x), 0.0).astype(
                np.float32),
            sum_xx=np.asarray(accs.sum_xx),
            wt_occ=np.asarray(accs.wt_occ),
            tr=np.asarray(accs.tr),
            total_logp=accs.total_logp, total_frames=accs.total_frames,
            n_utts=accs.n_utts,
        )
        xf = estimate_mllr_mean(comp, sub)
        if mllr_var:
            xf.var_scale = estimate_mllr_var(
                comp, accs, xf.apply_to_means(comp.means), sel=sel)
        return xf

    xforms = [node_xform(0)]  # root = global back-off
    node_xf = {0: 0}
    class_to_xf = np.zeros(len(leaf_node), np.int32)
    for c in range(len(leaf_node)):
        m = int(leaf_node[c])
        while m != 0 and node_occ[m] < occ_thresh:
            m = int(parent[m])
        if m not in node_xf:
            node_xf[m] = len(xforms)
            xforms.append(node_xform(m))
        class_to_xf[c] = node_xf[m]
    return xforms, class_to_xf


def build_regression_classes(comp: CompiledHMMSet, n_classes: int) -> np.ndarray:
    """Cluster Gaussians into regression base classes (HAdapt ~b role).

    HTK builds a centroid-split regression tree; the flat equivalent here
    is k-means over the Gaussian means — at estimation time classes with
    too little occupancy fall back to the global transform, which is the
    tree's back-off behaviour for a depth-1 tree. Returns (M,) class ids.
    """
    from .kmeans import kmeans

    if comp.n_mix <= n_classes:
        return np.arange(comp.n_mix, dtype=np.int32) % max(n_classes, 1)
    assign, _means = kmeans(comp.means.astype(np.float64), n_classes)
    return assign.astype(np.int32)


def estimate_mllr_classes(
    comp: CompiledHMMSet,
    accs: Accumulators,
    classes: np.ndarray,
    min_occ: float = 100.0,
):
    """Per-regression-class MLLR mean transforms with global back-off.

    Returns (transforms list, class->transform index (C,)). Classes whose
    occupancy is below min_occ use the global transform (index 0).
    """
    accs = host_accs(accs)
    global_xf = estimate_mllr_mean(comp, accs)
    xforms = [global_xf]
    n_classes = int(classes.max()) + 1
    class_to_xf = np.zeros(n_classes, np.int32)
    occ = np.asarray(accs.occ, np.float64)
    for c in range(n_classes):
        sel = classes == c
        if occ[sel].sum() < min_occ:
            continue
        sub = Accumulators(
            occ=np.where(sel, np.asarray(accs.occ), 0.0).astype(np.float32),
            sum_x=np.where(sel[:, None], np.asarray(accs.sum_x), 0.0).astype(
                np.float32),
            sum_xx=np.asarray(accs.sum_xx),
            wt_occ=np.asarray(accs.wt_occ),
            tr=np.asarray(accs.tr),
            total_logp=accs.total_logp, total_frames=accs.total_frames,
            n_utts=accs.n_utts,
        )
        xforms.append(estimate_mllr_mean(comp, sub))
        class_to_xf[c] = len(xforms) - 1
    return xforms, class_to_xf


def apply_mllr_classes(
    comp: CompiledHMMSet, base_means: np.ndarray,
    xforms, class_to_xf: np.ndarray, classes: np.ndarray,
) -> np.ndarray:
    """Transform each Gaussian's mean with its class's transform."""
    out = base_means.copy()
    for c in range(len(class_to_xf)):
        sel = classes == c
        if not np.any(sel):
            continue
        xf = xforms[int(class_to_xf[c])]
        out[sel] = base_means[sel] @ xf.A.T + xf.b[None, :]
    return out


def apply_mllr_classes_vars(
    comp: CompiledHMMSet, base_vars: np.ndarray,
    xforms, class_to_xf: np.ndarray, classes: np.ndarray,
) -> np.ndarray:
    """Scale each Gaussian's variances with its class's MLLRVAR H."""
    out = base_vars.copy()
    for c in range(len(class_to_xf)):
        sel = classes == c
        xf = xforms[int(class_to_xf[c])]
        if xf.var_scale is None or not np.any(sel):
            continue
        out[sel] = base_vars[sel] * xf.var_scale[None, :]
    return out


# -- CMLLR ------------------------------------------------------------------


@dataclass
class CMLLRStats:
    """Row statistics for CMLLR: G (D, D+1, D+1), k (D, D+1), beta."""

    G: np.ndarray
    k: np.ndarray
    beta: float


def cmllr_stats_from_gammas(
    feats: np.ndarray,  # (T, D)
    gamma: np.ndarray,  # (T, M) per-Gaussian posteriors
    means: np.ndarray,
    variances: np.ndarray,
) -> CMLLRStats:
    """Accumulate CMLLR row stats for one utterance (host or device-fed).

      G_i = sum_t c_i(t) xi(t) xi(t)^T,  c_i(t) = sum_m gamma_m(t)/var_mi
      k_i = sum_t [sum_m gamma_m(t) mu_mi / var_mi] xi(t)
    """
    T, D = feats.shape
    xi = np.concatenate([np.ones((T, 1)), feats], axis=1)  # (T, D+1)
    inv_var = 1.0 / variances.astype(np.float64)  # (M, D)
    c = gamma @ inv_var  # (T, D)
    mv = gamma @ (means.astype(np.float64) * inv_var)  # (T, D)
    G = np.einsum("ti,ta,tb->iab", c, xi, xi, optimize=True)
    k = np.einsum("ti,ta->ia", mv, xi, optimize=True)
    return CMLLRStats(G=G, k=k, beta=float(gamma.sum()))


def _estimate_cmllr_dense(G, k, beta, n_iter: int) -> np.ndarray:
    """Row-by-row CMLLR estimation with cofactor quadratic (HAdapt.c).
    Returns W (D, D+1) for the given (already dimension-reduced)
    statistics."""
    D = k.shape[0]
    W = np.concatenate([np.zeros((D, 1)), np.eye(D)], axis=1)
    Ginv = [np.linalg.inv(G[i] + np.eye(D + 1) * 1e-6) for i in range(D)]
    for _ in range(n_iter):
        for i in range(D):
            A = W[:, 1:]
            cof = np.linalg.inv(A).T * np.linalg.det(A)  # cofactor matrix
            p = np.concatenate([[0.0], cof[i]])  # extended cofactor row
            pG = p @ Ginv[i]
            a_q = pG @ p
            b_q = pG @ k[i]
            # maximise Q => alpha^2 a + alpha b - beta = 0
            disc = b_q * b_q + 4.0 * a_q * beta
            if a_q <= 0 or disc < 0:
                continue
            alpha1 = (-b_q + np.sqrt(disc)) / (2 * a_q)
            alpha2 = (-b_q - np.sqrt(disc)) / (2 * a_q)

            def obj(alpha):
                w = (alpha * p + k[i]) @ Ginv[i]
                det_term = w @ p
                # HAdapt.c compares both quadratic roots via log|w.p|; a
                # negative-orientation root can be the likelihood
                # maximiser, so only det_term == 0 is invalid.
                if det_term == 0.0:
                    return -np.inf
                return (beta * np.log(abs(det_term))
                        - 0.5 * w @ G[i] @ w + w @ k[i])

            alpha = alpha1 if obj(alpha1) >= obj(alpha2) else alpha2
            W[i] = (alpha * p + k[i]) @ Ginv[i]
    return W


def estimate_cmllr(stats: CMLLRStats, n_iter: int = 20,
                   blocks: int = 1) -> Transform:
    """CMLLR from row statistics. `blocks` > 1 (HADAPT: BLOCKS)
    estimates a block-diagonal transform — log|det A| separates over
    the blocks exactly, so each block is an independent lower-dim
    CMLLR on its slice of the statistics (HAdapt BLOCKINFO semantics);
    the standard fix for sparse adaptation data, where the full-matrix
    row solves are under-determined and produce wild transforms."""
    D = stats.k.shape[0]
    if blocks <= 1:
        W = _estimate_cmllr_dense(stats.G, stats.k, stats.beta, n_iter)
        return Transform(kind="CMLLR", A=W[:, 1:].copy(),
                         b=W[:, 0].copy())
    A = np.zeros((D, D))
    b = np.zeros(D)
    for lo, hi in block_ranges(D, blocks):
        cols = np.r_[0, 1 + np.arange(lo, hi)]
        Gb = stats.G[lo:hi][:, cols][:, :, cols]
        kb = stats.k[lo:hi][:, cols]
        Wb = _estimate_cmllr_dense(Gb, kb, stats.beta, n_iter)
        A[lo:hi, lo:hi] = Wb[:, 1:]
        b[lo:hi] = Wb[:, 0]
    return Transform(kind="CMLLR", A=A, b=b)


def estimate_cmllr_classes(
    stats_list,  # [(CMLLRStats or None)] per class
    global_stats,  # CMLLRStats over all Gaussians
    occ_thresh: float = 1000.0,
):
    """Per-base-class CMLLR with occupancy back-off to the global
    transform (HAdapt's base-class constrained xforms).

    Returns (xforms, class_to_xf): index 0 is the global transform;
    classes whose stats carry less than `occ_thresh` frames share it."""
    xforms = [estimate_cmllr(global_stats)]
    class_to_xf = np.zeros(len(stats_list), np.int32)
    for c, st in enumerate(stats_list):
        if st is None or st.beta < occ_thresh:
            continue
        xforms.append(estimate_cmllr(st))
        class_to_xf[c] = len(xforms) - 1
    return xforms, class_to_xf


def apply_cmllr_classes_fc(comp: CompiledHMMSet, xforms,
                           class_to_xf: np.ndarray, classes: np.ndarray,
                           means: Optional[np.ndarray] = None):
    """Model-space application of per-class CMLLR transforms.

    A single feature transform per class cannot be applied to the shared
    feature stream, so each class's W = [b; A] moves into model space:
    mu' = A^-1(mu - b), Sigma' = A^-1 Sigma A^-T — a full covariance,
    evaluated through the FULLC scorer (the |A| Jacobian is absorbed by
    |Sigma'|). Returns (fc_proj, fc_mu, gconsts)."""
    if comp.n_streams > 1 or getattr(comp, "full_cov", False):
        HError(7450, "CMLLR classes: single-stream diagonal sets only")
    mu = (means if means is not None else comp.means).astype(np.float64)
    var = comp.variances.astype(np.float64)
    M, D = mu.shape
    fc_proj = np.zeros((M, D, D), np.float32)
    fc_mu = np.zeros((M, D), np.float32)
    gconsts = np.zeros(M, np.float32)
    for c in range(len(class_to_xf)):
        sel = classes == c
        if not np.any(sel):
            continue
        xf = xforms[int(class_to_xf[c])]
        A = xf.A.astype(np.float64)
        # P'_m = A^T Sigma_m^-1 A (precision of A^-1 Sigma A^-T)
        P = np.einsum("di,md,dj->mij", A, 1.0 / var[sel], A)
        L = np.linalg.cholesky(P)
        mup = (mu[sel] - xf.b[None, :]) @ np.linalg.inv(A).T
        fc_proj[sel] = L.astype(np.float32)
        fc_mu[sel] = np.einsum("md,mde->me", mup, L).astype(np.float32)
        gconsts[sel] = (D * np.log(2 * np.pi)
                        - 2.0 * np.sum(np.log(np.diagonal(
                            L, axis1=1, axis2=2)), axis=1)).astype(
                                np.float32)
    return fc_proj, fc_mu, gconsts


def mllrcov_stats_from_gammas(
    feats: np.ndarray,  # (T, D)
    gamma: np.ndarray,  # (T, M)
    means: np.ndarray,
    variances: np.ndarray,
):
    """Row statistics for the full variance transform (HAdapt MLLRCOV,
    Gales' H: Sigma' = H Sigma H^T).

    G[i] = sum_m (1/sigma2_mi) sum_t gamma_m(t) (o-mu_m)(o-mu_m)^T,
    beta = total occupancy. O(T M D^2) — adaptation-data sized."""
    d = feats[:, None, :] - means[None, :, :]  # (T, M, D)
    K = np.einsum("tm,tmd,tme->mde", gamma.astype(np.float64),
                  d.astype(np.float64), d.astype(np.float64))
    G = np.einsum("mi,mde->ide", 1.0 / variances.astype(np.float64), K)
    return G, float(gamma.sum())


def estimate_mllrcov(G: np.ndarray, beta: float, n_iter: int = 20
                     ) -> Transform:
    """Row/cofactor iteration for the inverse variance transform A = H^-1.

    Maximises beta log|A| - 0.5 sum_i a_i G_i a_i^T: each row is
    proportional to its own cofactor direction through G_i^-1, with the
    scale alpha = sqrt(beta / (p G_i^-1 p)) (the closed-form root of the
    per-row quadratic; scale-invariant in p, so the raw inverse row
    replaces HTK's determinant-scaled cofactor)."""
    D = G.shape[0]
    A = np.eye(D)
    Ginv = [np.linalg.inv(G[i] + np.eye(D) * 1e-6) for i in range(D)]
    for _ in range(n_iter):
        for i in range(D):
            p = np.linalg.inv(A).T[i]  # cofactor direction of row i
            pg = p @ Ginv[i]
            pgp = pg @ p
            if pgp <= 0:
                continue
            A[i] = np.sqrt(beta / pgp) * pg
    H = np.linalg.inv(A)
    return Transform(kind="MLLRCOV", A=H, b=np.zeros(D))


def apply_mllrcov(comp: CompiledHMMSet, xf: Transform,
                  means: Optional[np.ndarray] = None,
                  variances: Optional[np.ndarray] = None):
    """Full-covariance scorer inputs for Sigma'_m = H Sigma_m H^T.

    Returns (fc_proj, fc_mu, gconsts) in the compile_hmmset FULLC layout:
    P'_m = A^T Sigma_m^-1 A with A = H^-1, Cholesky-factored per Gaussian
    so decode rides ops/outp.full_cov_mix_scores unchanged. Single-stream
    diagonal sets only."""
    if comp.n_streams > 1 or getattr(comp, "full_cov", False):
        HError(7450, "MLLRCOV: single-stream diagonal sets only")
    mu = (means if means is not None else comp.means).astype(np.float64)
    var = (variances if variances is not None
           else comp.variances).astype(np.float64)
    A = np.linalg.inv(xf.A.astype(np.float64))
    M, D = mu.shape
    P = np.einsum("di,md,dj->mij", A, 1.0 / var, A)  # (M, D, D)
    L = np.linalg.cholesky(P)
    fc_proj = L.astype(np.float32)
    fc_mu = np.einsum("md,mde->me", mu, L).astype(np.float32)
    gconsts = (D * np.log(2 * np.pi)
               - 2.0 * np.sum(np.log(np.diagonal(L, axis1=1, axis2=2)),
                              axis=1)).astype(np.float32)
    return fc_proj, fc_mu, gconsts


def map_update(
    comp: CompiledHMMSet, accs: Accumulators, tau: float,
    min_occ: float = 1e-3,
) -> np.ndarray:
    """MAP mean update (HMap.c): mu = (tau*mu0 + sumx)/(tau + occ)."""
    accs = host_accs(accs)
    occ = np.asarray(accs.occ, np.float64)
    sum_x = np.asarray(accs.sum_x, np.float64)
    mu0 = comp.means.astype(np.float64)
    mu = (tau * mu0 + sum_x) / (tau + occ[:, None])
    mu = np.where(occ[:, None] > min_occ, mu, mu0)
    return mu.astype(np.float32)


def save_baseclass(path: str, name: str, classes: np.ndarray,
                   parent: Optional[np.ndarray] = None,
                   leaf_node: Optional[np.ndarray] = None) -> None:
    """Write a regression base-class file (HAdapt ~b/~r macro role).

    One class id per compiled Gaussian, in `CompiledHMMSet` order, plus
    the regression tree (parent links + leaf node per class) when built
    by HHEd RC. The layout is this framework's own (HTK's ~b itemlist
    form needs the reference to verify). [LC]
    """
    n_classes = int(classes.max()) + 1 if len(classes) else 0
    with open(path, "w") as f:
        f.write(f'~b "{name}"\n')
        f.write(f"<NUMCLASSES> {n_classes}\n")
        f.write(f"<GAUSSCLASSES> {len(classes)}\n")
        f.write(" " + " ".join(str(int(c)) for c in classes) + "\n")
        if parent is not None and leaf_node is not None:
            f.write(f"<PARENT> {len(parent)}\n")
            f.write(" " + " ".join(str(int(x)) for x in parent) + "\n")
            f.write(f"<LEAFNODE> {len(leaf_node)}\n")
            f.write(" " + " ".join(str(int(x)) for x in leaf_node) + "\n")


def load_baseclass(path: str, hset=None, comp=None):
    """Read a regression base-class file.

    Two accepted layouts: the framework's own `save_baseclass` form
    (<GAUSSCLASSES> + explicit per-Gaussian ids), and HTK's ~b itemlist
    form (HTKBook adaptation chapter:
    `<CLASS> n {model.state[..].mix[..]}` per class) — the latter needs
    `hset` and `comp` to resolve item lists onto compiled Gaussians.
    Returns (name, classes, tree) with classes an (M,) int32 array and
    tree either None (flat classes) or (parent, leaf_node) arrays."""
    text = open(path, errors="replace").read()
    toks = text.split()
    if not toks or toks[0] != "~b":
        HError(7460, "baseclass: %s is not a ~b file", path)
    if "<CLASS>" in text and "<GAUSSCLASSES>" not in text:
        if hset is None or comp is None:
            HError(7460, "baseclass: %s uses HTK itemlist classes — "
                         "the caller must supply the model set", path)
        with contained(7460, "baseclass", path):
            return _parse_baseclass_htk(text, path, hset, comp)
    with contained(7460, "baseclass", path):
        return _parse_baseclass(toks, path)


def _parse_baseclass_htk(text: str, path: str, hset, comp):
    """HTK ~b itemlist form -> per-compiled-Gaussian class ids.

    `HTKLib/HAdapt.c : LoadBaseClass` role; class numbers are 1-based in
    the file and 0-based in the returned array. Gaussians not named by
    any class land in class 0 (HTK's global fallback)."""
    import re as _re

    from ..models.itemlist import parse_item_list

    name = "global"
    m = _re.search(r'~b\s+"([^"]*)"', text)
    if m:
        name = m.group(1)
    id2idx = {id(mp): k for k, mp in enumerate(comp._mix_objs)}
    classes = np.zeros(comp.n_mix, np.int32)
    found = 0
    for cm in _re.finditer(r"<CLASS>\s+(\d+)\s+(\{[^}]*\})", text):
        cls = int(cm.group(1)) - 1
        found += 1
        for it in parse_item_list(cm.group(2), hset):
            if it.kind in ("hmm", "transP"):
                states = it.hmm.states
            else:
                states = [it.hmm.states[it.state_idx - 2]]
            for st in states:
                streams = (st.streams if it.kind in ("hmm", "state",
                                                     "transP")
                           else [st.streams[it.stream_idx - 1]])
                for se in streams:
                    mixes = (se.mixes if it.mix_idx is None
                             else [se.mixes[it.mix_idx - 1]])
                    for mp in mixes:
                        k = id2idx.get(id(mp))
                        if k is not None:
                            classes[k] = cls
    if not found:
        HError(7460, "baseclass: %s has no <CLASS> entries", path)
    return name, classes, None


def _parse_baseclass(toks, path: str):
    name = toks[1].strip('"')
    m = int(toks[toks.index("<GAUSSCLASSES>") + 1])
    i = toks.index("<GAUSSCLASSES>") + 2
    classes = np.array([int(t) for t in toks[i : i + m]], dtype=np.int32)
    if len(classes) != m:
        HError(7460, "baseclass: %s truncated (%d of %d ids)",
               path, len(classes), m)
    tree = None
    if "<PARENT>" in toks:
        i = toks.index("<PARENT>")
        n = int(toks[i + 1])
        parent = np.array([int(t) for t in toks[i + 2 : i + 2 + n]],
                          dtype=np.int32)
        i = toks.index("<LEAFNODE>")
        n = int(toks[i + 1])
        leaf_node = np.array([int(t) for t in toks[i + 2 : i + 2 + n]],
                             dtype=np.int32)
        tree = (parent, leaf_node)
    return name, classes, tree


# -- TMF I/O ----------------------------------------------------------------


def save_tmf_classes(path: str, name: str, xforms, class_to_xf: np.ndarray,
                     classes: np.ndarray,
                     kind: str = "MLLRCLASSES") -> None:
    """Multi-transform TMF: regression-class MLLR/CMLLR set (~a + maps)."""
    D = xforms[0].A.shape[0]
    with open(path, "w") as f:
        f.write(f'~a "{name}"\n')
        f.write(f"<ADAPTKIND> {kind}\n<VECSIZE> {D}\n")
        f.write(f"<NUMXFORMS> {len(xforms)}\n")
        f.write(f"<GAUSSCLASSES> {len(classes)}\n")
        f.write(" " + " ".join(str(int(c)) for c in classes) + "\n")
        f.write(f"<CLASSXFORM> {len(class_to_xf)}\n")
        f.write(" " + " ".join(str(int(i)) for i in class_to_xf) + "\n")
        for k, xf in enumerate(xforms):
            f.write(f"<XFORMID> {k}\n<BIAS> {D}\n")
            f.write(" " + " ".join("%.6e" % v for v in xf.b) + "\n")
            f.write(f"<XFORM> {D} {D}\n")
            for row in xf.A:
                f.write(" " + " ".join("%.6e" % v for v in row) + "\n")
            if xf.var_scale is not None:
                f.write(f"<VARSCALE> {D}\n")
                f.write(" " + " ".join("%.6e" % v
                                       for v in xf.var_scale) + "\n")


def load_tmf_classes(path: str):
    """Load a MLLRCLASSES TMF; returns (name, xforms, class_to_xf, classes)
    or None when the file is a plain single-transform TMF."""
    toks = open(path).read().split()
    if "<ADAPTKIND>" not in toks:
        return None
    kind = toks[toks.index("<ADAPTKIND>") + 1]
    if kind not in ("MLLRCLASSES", "CMLLRCLASSES"):
        return None
    xf_kind = "CMLLR" if kind == "CMLLRCLASSES" else "MLLRMEAN"
    name = toks[1].strip('"') if toks[0] == "~a" else "unnamed"
    i = 0
    D = 0
    classes = None
    class_to_xf = None
    xforms = []
    cur_b = None
    while i < len(toks):
        t = toks[i]
        if t == "<VECSIZE>":
            D = int(toks[i + 1]); i += 2
        elif t == "<GAUSSCLASSES>":
            n = int(toks[i + 1])
            classes = np.array([int(x) for x in toks[i + 2 : i + 2 + n]],
                               np.int32)
            i += 2 + n
        elif t == "<CLASSXFORM>":
            n = int(toks[i + 1])
            class_to_xf = np.array([int(x) for x in toks[i + 2 : i + 2 + n]],
                                   np.int32)
            i += 2 + n
        elif t == "<BIAS>":
            n = int(toks[i + 1])
            cur_b = np.array([float(x) for x in toks[i + 2 : i + 2 + n]])
            i += 2 + n
        elif t == "<XFORM>":
            r, c = int(toks[i + 1]), int(toks[i + 2])
            vals = [float(x) for x in toks[i + 3 : i + 3 + r * c]]
            xforms.append(Transform(kind=xf_kind,
                                    A=np.array(vals).reshape(r, c),
                                    b=cur_b))
            i += 3 + r * c
        elif t == "<VARSCALE>":
            n = int(toks[i + 1])
            xforms[-1].var_scale = np.array(
                [float(x) for x in toks[i + 2 : i + 2 + n]])
            i += 2 + n
        else:
            i += 1
    if classes is None or class_to_xf is None or not xforms:
        HError(7460, "load_tmf_classes: malformed %s", path)
    return name, xforms, class_to_xf, classes


def save_tmf(path: str, name: str, xf: Transform) -> None:
    D = xf.A.shape[0]
    with open(path, "w") as f:
        f.write(f'~a "{name}"\n')
        f.write(f"<ADAPTKIND> {xf.kind}\n")
        f.write(f"<VECSIZE> {D}\n")
        f.write(f"<BIAS> {D}\n")
        f.write(" " + " ".join("%.6e" % v for v in xf.b) + "\n")
        f.write(f"<XFORM> {D} {D}\n")
        for row in xf.A:
            f.write(" " + " ".join("%.6e" % v for v in row) + "\n")
        if xf.var_scale is not None:
            f.write(f"<VARSCALE> {D}\n")
            f.write(" " + " ".join("%.6e" % v for v in xf.var_scale) + "\n")


def load_tmf(path: str) -> Tuple[str, Transform]:
    with contained(7460, "load_tmf", path):
        return load_tmf_text(open(path, errors="replace").read())


def load_tmf_text(text: str) -> Tuple[str, Transform]:
    """Parse a single-transform TMF from its text (also the body of an
    MMF-embedded ~a input transform, HHEd XF)."""
    toks = text.split()
    name = "unnamed"
    kind = "MLLRMEAN"
    i = 0
    b = None
    A = None
    vs = None
    D = 0
    while i < len(toks):
        t = toks[i]
        if t == "~a":
            name = toks[i + 1].strip('"')
            i += 2
        elif t == "<ADAPTKIND>":
            kind = toks[i + 1]
            i += 2
        elif t == "<VECSIZE>":
            D = int(toks[i + 1])
            i += 2
        elif t == "<BIAS>":
            n = int(toks[i + 1])
            b = np.array([float(x) for x in toks[i + 2 : i + 2 + n]])
            i += 2 + n
        elif t == "<XFORM>":
            r, c = int(toks[i + 1]), int(toks[i + 2])
            vals = [float(x) for x in toks[i + 3 : i + 3 + r * c]]
            A = np.array(vals).reshape(r, c)
            i += 3 + r * c
        elif t == "<VARSCALE>":
            n = int(toks[i + 1])
            vs = np.array([float(x) for x in toks[i + 2 : i + 2 + n]])
            i += 2 + n
        else:
            i += 1
    if A is None or b is None:
        HError(7460, "load_tmf: malformed transform (%d tokens)",
               len(toks))
    return name, Transform(kind=kind, A=A, b=b, var_scale=vs)
