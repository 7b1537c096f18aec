"""Preconditioner utilities: ILU factors from .mat files or scipy sparse
(port of ``diffnet_tpu/utils/precond.py``, numpy and scipy only, as it is).

Reference: examples/poisson/single_instance/utils.py:36-70 (``load_ilu_data``
loading an invL factor from MATLAB COO triplets into a dense matrix, used by
the preconditioned resmin loss e8_2d_poisson_mms.py:67-68,143-149).
"""

from __future__ import annotations

import numpy as np

__all__ = ["load_ilu_mat", "ilu_from_operator"]


def load_ilu_mat(path, key="invL"):
    """Load a (possibly sparse-COO-triplet) factor from a .mat file into a
    dense [N, N] float32 matrix. Supports both a direct dense/sparse matrix
    under `key` and the reference's (rows, cols, data) triplet layout."""
    import scipy.io
    import scipy.sparse as sp

    data = scipy.io.loadmat(path)
    if key in data:
        M = data[key]
        if sp.issparse(M):
            M = M.toarray()
        return np.asarray(M, np.float32)
    rows = np.asarray(data["rows"]).squeeze().astype(np.int64) - 1
    cols = np.asarray(data["cols"]).squeeze().astype(np.int64) - 1
    vals = np.asarray(data["data"]).squeeze().astype(np.float32)
    n = int(max(rows.max(), cols.max())) + 1
    M = sp.coo_matrix((vals, (rows, cols)), shape=(n, n))
    return M.toarray().astype(np.float32)


def ilu_from_operator(matvec, n, drop_tol=1e-4, fill_factor=10.0):
    """Build inv(L) of an ILU factorization of the dense operator given by
    `matvec` on R^n (for moderate n): its use is a dense triangular apply,
    matching the reference's dense invL (e8:67-68). Returns
    invL [n, n] float32."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    cols = [np.asarray(matvec(np.eye(n, dtype=np.float32)[i]))
            for i in range(n)]
    A = sp.csc_matrix(np.stack(cols, axis=1))
    # NATURAL ordering + no diagonal pivoting: spilu's default COLAMD
    # permutations would make ilu.L the L-factor of P_r A P_c, not of A, and
    # inv(L) a far weaker left preconditioner for the UNpermuted residual
    ilu = spla.spilu(A, drop_tol=drop_tol, fill_factor=fill_factor,
                     permc_spec="NATURAL",
                     options={"DiagPivotThresh": 0.0})
    # inv(L) via triangular solve against identity
    from scipy.linalg import solve_triangular

    invL = solve_triangular(ilu.L.toarray(), np.eye(n), lower=True,
                            unit_diagonal=True)
    return invL.astype(np.float32)
