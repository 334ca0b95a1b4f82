"""Fisher-weighted parameter fusion and the approximate combine (port of
ceph_tpu/inference/fisher.py).

The algebra (arXiv:2409.01420 shape): data shard i holds parameter
block theta_i; fused shard j holds

    phi_j = sum_i A[j,i] * theta_i,        A = C * diag(omega)

where omega is the Fisher-normalized importance of each shard (fusion
distorts the least-important parameters most) and C is a Cauchy
matrix row-normalized so every fused block is a weighted AVERAGE of
the data blocks.  Cauchy structure is the load-bearing choice: every
square submatrix of a (positively row/column scaled) Cauchy matrix is
nonsingular, so ANY missing-shard pattern with enough fused results
is solvable — the rateless any-sufficient-set property
(arXiv:1804.10331) in the parameter domain.

For a LINEAR scorer the forward pass commutes with the fusion
exactly: r_j = Q @ phi_j^T = sum_i A[j,i] y_i up to float rounding,
so the combine is exact for any k-subset.  For the MLP the
nonlinearity opens a Jensen gap: r_j = f(phi_j) only approximates
sum_i A[j,i] f(theta_i).  The registry CALIBRATES that gap at store
time (per-fused-shard residual rho_j per unit query scale), and the
combine turns (which shards are missing) x (which fused rows answer)
into a STRUCTURAL error bound — computable before any result bytes
arrive, which is what lets the hedged gather's sufficiency predicate
decide "this arrival set can serve within budget" without waiting.

Every approximate-combine return MUST consult `check_budget` — the
reference's `unbudgeted-approx-result` lint rule checks it there.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

#: safety margin over the calibrated worst residual: on-distribution
#: queries stay under the bound with room for float noise
RHO_MARGIN = 2.0

_TINY = 1e-12


def check_budget(est_error: float, budget: Optional[float]) -> bool:
    """THE error-budget gate: True when an approximate result with
    estimated relative error `est_error` may be served under
    `budget` (None = caller accepts any estimate).  Single choke
    point, so one symbol carries the rule."""
    if budget is None:
        return True
    return float(est_error) <= float(budget)


def fisher_weights(blocks: Sequence[np.ndarray],
                   fisher: Optional[Sequence[float]] = None
                   ) -> np.ndarray:
    """Per-shard fusion weights omega (sum 1).  `fisher` supplies the
    per-shard Fisher information when the caller has calibration
    gradients; absent that, the empirical proxy is the parameter
    second moment (large-magnitude blocks carry more of the function
    and should dominate the average)."""
    if fisher is not None:
        f = np.asarray(fisher, dtype=np.float64)
    else:
        f = np.array([float(np.mean(np.square(
            np.asarray(b, dtype=np.float64)))) for b in blocks])
    f = np.maximum(f, _TINY)
    return f / f.sum()


def fusion_coeff(k: int, m: int, omega: np.ndarray) -> np.ndarray:
    """(m x k) fusion matrix A: Cauchy nodes x Fisher column scaling,
    rows normalized to sum 1 (each fused block is a weighted average,
    so fused forward passes live on the data shards' activation
    scale).  Positive scalings preserve the all-minors-nonsingular
    Cauchy property, so any |missing| <= |fused answered| pattern
    solves."""
    x = np.arange(1, m + 1, dtype=np.float64)
    y = np.arange(m + 1, m + k + 1, dtype=np.float64)
    cauchy = 1.0 / (x[:, None] + y[None, :])
    a = cauchy * np.asarray(omega, dtype=np.float64)[None, :]
    return a / a.sum(axis=1, keepdims=True)


def fuse_blocks(blocks: Sequence[Dict[str, np.ndarray]],
                coeff: np.ndarray) -> List[Dict[str, np.ndarray]]:
    """k same-shape parameter dicts -> m fused parameter dicts
    (element-wise weighted averages; float32 like the stored
    streams)."""
    out: List[Dict[str, np.ndarray]] = []
    for row in np.asarray(coeff, dtype=np.float64):
        fused: Dict[str, np.ndarray] = {}
        for name in blocks[0]:
            acc = np.zeros(blocks[0][name].shape, dtype=np.float64)
            for w, blk in zip(row, blocks):
                acc += w * np.asarray(blk[name], dtype=np.float64)
            fused[name] = acc.astype(np.float32)
        out.append(fused)
    return out


def query_scale(queries: np.ndarray) -> float:
    """RMS of the query batch — the unit the calibrated residuals are
    expressed per, so the bound tracks query magnitude."""
    q = np.asarray(queries, dtype=np.float64)
    return float(np.sqrt(np.mean(np.square(q))) + _TINY)


def _solver(coeff: np.ndarray, data_present: Sequence[int],
            fused_present: Sequence[int], k: int
            ) -> Optional[Tuple[np.ndarray, float]]:
    """(pseudo-inverse of the missing-block system, its spectral
    norm) for the arrival pattern, or None when the pattern cannot
    determine the missing contributions."""
    missing = [i for i in range(k) if i not in set(data_present)]
    if not missing:
        return np.zeros((0, 0)), 0.0
    if len(fused_present) < len(missing):
        return None
    a = np.asarray(coeff, dtype=np.float64)
    sub = a[np.asarray(fused_present)][:, np.asarray(missing)]
    pinv = np.linalg.pinv(sub)
    return pinv, float(np.linalg.norm(pinv, 2))


def _accum(spec: Dict[str, Any], nmissing: int) -> float:
    """Contribution-error -> output-error accumulation factor: the
    mlp combine SUMS contributions, so errors of the substituted
    shards can add coherently (sqrt(|missing|) worst case under the
    Frobenius bound); the linear combine concatenates, which
    preserves the aggregate RMS."""
    if spec.get("kind") == "mlp" and nmissing > 1:
        return float(np.sqrt(nmissing))
    return 1.0


def structural_error(spec: Dict[str, Any],
                     data_present: Sequence[int],
                     fused_present: Sequence[int],
                     qscale: float) -> Optional[float]:
    """Relative error bound for serving from this arrival pattern —
    a pure function of WHICH streams answered (plus the calibrated
    rho/yscale in the manifest), so the hedged gather's sufficiency
    predicate can price an arrival set before combining anything.
    None = pattern cannot serve at all."""
    k = int(spec["k"])
    solved = _solver(np.asarray(spec["coeff"], dtype=np.float64),
                     data_present, fused_present, k)
    if solved is None:
        return None
    _pinv, gain = solved
    if gain == 0.0:
        return 0.0
    nmissing = k - len(set(data_present))
    rho = np.asarray(spec["rho"], dtype=np.float64)
    eps = np.sqrt(np.sum(np.square(
        rho[np.asarray(fused_present)] * qscale)))
    yscale = float(spec.get("yscale", 1.0)) * qscale
    return float(_accum(spec, nmissing) * gain * eps /
                 max(yscale, _TINY))


def combine(spec: Dict[str, Any],
            data_parts: Dict[int, np.ndarray],
            fused_parts: Dict[int, np.ndarray],
            queries: np.ndarray,
            budget: Optional[float]
            ) -> Optional[Tuple[np.ndarray, float, int]]:
    """Fisher-averaged approximate combine: solve the missing data
    contributions from the fused results, then run the SAME fixed
    combine the exact paths use.  Returns (scores, est_error,
    substituted) or None when the budget check refuses (caller takes
    the exact full-decode fallback).

    est_error folds two signals: the structural calibration bound,
    and — when more fused rows answered than shards are missing — the
    measured least-squares inconsistency of the overdetermined fit
    (an on-line residual the calibration cannot fake)."""
    from ceph_tpu_torch.inference import model as model_mod

    k = int(spec["k"])
    present = sorted(data_parts)
    fused_ids = sorted(fused_parts)
    missing = [i for i in range(k) if i not in data_parts]
    qscale = query_scale(queries)
    est = structural_error(spec, present, fused_ids, qscale)
    if est is None or not check_budget(est, budget):
        return None
    parts: List[np.ndarray] = [None] * k  # type: ignore[list-item]
    for i, y in data_parts.items():
        parts[i] = np.asarray(y, dtype=np.float32)
    if missing:
        a = np.asarray(spec["coeff"], dtype=np.float64)
        shape = next(iter(data_parts.values())).shape \
            if data_parts else next(iter(fused_parts.values())).shape
        rhs = []
        for j in fused_ids:
            r = np.asarray(fused_parts[j], dtype=np.float64)
            for i in present:
                r = r - a[j, i] * np.asarray(data_parts[i],
                                             dtype=np.float64)
            rhs.append(r.reshape(-1))
        sub = a[np.asarray(fused_ids)][:, np.asarray(missing)]
        sol, resid, _rank, _sv = np.linalg.lstsq(
            sub, np.stack(rhs), rcond=None)
        if len(fused_ids) > len(missing):
            # overdetermined: the fit residual is a measured lower
            # bound on the fused rows' inconsistency — amplify it
            # through the solver gain onto the output scale and take
            # the worse of the two estimates
            fit = np.stack(rhs) - sub @ sol
            gain = float(np.linalg.norm(np.linalg.pinv(sub), 2))
            yscale = float(spec.get("yscale", 1.0)) * qscale
            measured = _accum(spec, len(missing)) * gain * float(
                np.sqrt(np.mean(np.square(fit)))) / max(yscale, _TINY)
            est = max(est, measured)
            if not check_budget(est, budget):
                return None
        for row, i in enumerate(missing):
            parts[i] = sol[row].reshape(shape).astype(np.float32)
    scores = model_mod.combine_contributions(spec, parts)
    return scores, float(est), len(missing)
