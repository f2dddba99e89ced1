"""Causal-graph distances: SHD and the adjustment-identification distances (a
copy of the JAX package's ``eval/causal_distances.py``; numpy on the host).

The reference scores supervised-discovery estimates with the external Rust
package ``gadjid`` (ancestor_aid / oset_aid / parent_aid / shd, imported at
the reference's
evaluate/eval_algsT_by_expSynSys12112_forF1RocAucCausalDistStats.py:11-12
and called with ``edge_direction="from column to row"`` at :339-378).  This
module is a native reimplementation of those four metrics for DAG inputs,
following the definitions in "Adjustment Identification Distance: A gadjid for
Causal Structure Learning" (Henckel, Würtzen & Weichwald, arXiv:2402.08616):

For every ordered pair (x, y) of distinct nodes the *guess* graph proposes an
identification strategy for the total causal effect of x on y:
  - if y is not a descendant of x in the guess: the claim "zero effect";
  - otherwise an adjustment set Z derived from the guess —
      parent_aid:   Z = Pa_guess(x)
      ancestor_aid: Z = An_guess({x, y}) \\ (Forb_guess(x, y) ∪ {x, y})
                    (the canonical "Adjust" set of van der Zander et al.)
      oset_aid:     Z = O_guess(x, y) = Pa_guess(Cn(x, y)) \\ Forb_guess(x, y)
                    (the optimal adjustment set of Henckel et al. 2022)
The strategy is verified against the *true* graph: a zero-effect claim is
correct iff y ∉ De_true(x); an adjustment set is correct iff it satisfies the
adjustment criterion in the true DAG — Z ∩ Forb_true(x, y) = ∅ and Z
d-separates x from y in the proper back-door graph.  The distance is the number
of ordered pairs with an incorrect strategy; the normalized distance divides by
p·(p-1).

Here Cn(x, y) = De(x) ∩ An(y) \\ {x} (nodes on proper causal paths) and
Forb(x, y) = De(Cn(x, y)) ∪ {x}.

Cyclic inputs raise ValueError, mirroring gadjid's rejection of non-DAG inputs
(the reference wraps every call in try/except and records NaN).
"""
from __future__ import annotations

import numpy as np

__all__ = ["shd", "parent_aid", "ancestor_aid", "oset_aid"]


def _to_row_to_col(A, edge_direction):
    """Return boolean adjacency with A[i, j] == True meaning i -> j."""
    A = np.asarray(A)
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise ValueError("adjacency must be square")
    B = A != 0
    if edge_direction == "from column to row":
        B = B.T
    elif edge_direction != "from row to column":
        raise ValueError(f"unknown edge_direction: {edge_direction!r}")
    if np.any(np.diag(B)):
        raise ValueError("self-loops are not allowed")
    return B


def _reachability(B):
    """R[i, j] = True iff there is a directed path i -> ... -> j (length >= 1).
    Boolean matrix closure by repeated squaring."""
    n = B.shape[0]
    R = B.copy()
    while True:
        R2 = R | (R @ R)
        if np.array_equal(R2, R):
            break
        R = R2
    if np.any(np.diag(R)):
        raise ValueError("graph contains a cycle; AID/SHD require a DAG")
    return R


def shd(true_A, guess_A, edge_direction="from row to column"):
    """Structural Hamming distance between two directed graphs.

    Each unordered node pair {i, j} contributes one mistake when its edge
    status (none / i->j / j->i / both) differs between the graphs.
    Returns (normalized_distance, n_mistakes) with normalization p(p-1)/2.
    """
    T = _to_row_to_col(true_A, edge_direction)
    G = _to_row_to_col(guess_A, edge_direction)
    if T.shape != G.shape:
        raise ValueError("graphs must have the same number of nodes")
    diff = (T != G) | (T.T != G.T)
    iu = np.triu_indices(T.shape[0], k=1)
    mistakes = int(np.sum(diff[iu]))
    total = T.shape[0] * (T.shape[0] - 1) // 2
    return (mistakes / total if total else 0.0, mistakes)


def _causal_nodes(R, x, y):
    """Cn(x, y): nodes on proper causal paths from x to y (includes y when an
    effect exists). R is the strict-reachability matrix."""
    n = R.shape[0]
    de_x = R[x].copy()
    an_y = R[:, y].copy()
    an_y[y] = True
    cn = de_x & an_y
    cn[x] = False
    return cn


def _forbidden(R, x, y):
    """Forb(x, y) = De(Cn(x, y)) ∪ {x} (descendants include the node itself)."""
    cn = _causal_nodes(R, x, y)
    forb = cn.copy()
    if cn.any():
        forb |= np.any(R[cn], axis=0)
    forb[x] = True
    return forb


def _d_separated(B, x, y, Z):
    """d-separation of x and y given set Z (boolean mask) in DAG B via the
    moralized-ancestral-graph construction."""
    n = B.shape[0]
    # ancestors of {x, y} ∪ Z, including themselves
    seed = Z.copy()
    seed[x] = True
    seed[y] = True
    anc = seed.copy()
    frontier = seed.copy()
    while frontier.any():
        parents = np.any(B[:, frontier], axis=1) & ~anc
        anc |= parents
        frontier = parents
    # induced subgraph on anc, moralized and undirected
    sub = B & anc[:, None] & anc[None, :]
    moral = sub | sub.T
    # marry parents of every common child
    for c in np.flatnonzero(anc):
        ps = np.flatnonzero(sub[:, c])
        if len(ps) > 1:
            moral[np.ix_(ps, ps)] = True
    np.fill_diagonal(moral, False)
    # connectivity from x to y avoiding Z
    blocked = Z
    if blocked[x] or blocked[y]:
        # conditioning on an endpoint separates trivially in this construction
        return True
    visited = np.zeros(n, dtype=bool)
    visited[x] = True
    frontier = np.zeros(n, dtype=bool)
    frontier[x] = True
    while frontier.any():
        nxt = np.any(moral[frontier], axis=0) & ~visited & ~blocked
        if nxt[y]:
            return False
        visited |= nxt
        frontier = nxt
    return True


def _valid_adjustment_set(B, R, x, y, Z):
    """Adjustment criterion for (x, y) in DAG B: Z ∩ Forb(x, y) = ∅ and Z
    d-separates x from y in the proper back-door graph (B minus the edges
    x -> c for c ∈ Cn(x, y))."""
    if Z[x] or Z[y]:
        return False
    forb = _forbidden(R, x, y)
    if np.any(Z & forb):
        return False
    cn = _causal_nodes(R, x, y)
    pbd = B.copy()
    pbd[x, cn] = False
    return _d_separated(pbd, x, y, Z)


def _aid(true_A, guess_A, strategy, edge_direction):
    T = _to_row_to_col(true_A, edge_direction)
    G = _to_row_to_col(guess_A, edge_direction)
    if T.shape != G.shape:
        raise ValueError("graphs must have the same number of nodes")
    n = T.shape[0]
    RT = _reachability(T)
    RG = _reachability(G)
    mistakes = 0
    for x in range(n):
        for y in range(n):
            if x == y:
                continue
            if not RG[x, y]:
                # guess claims zero effect of x on y
                if RT[x, y]:
                    mistakes += 1
                continue
            if strategy == "parent":
                Z = G[:, x].copy()
            elif strategy == "ancestor":
                Z = RG[:, x] | RG[:, y]
                Z[x] = True
                Z[y] = True
                Z &= ~_forbidden(RG, x, y)
                Z[x] = False
                Z[y] = False
            elif strategy == "oset":
                cn = _causal_nodes(RG, x, y)
                Z = np.any(G[:, cn], axis=1) if cn.any() else np.zeros(n, bool)
                Z &= ~_forbidden(RG, x, y)
            else:
                raise ValueError(strategy)
            if not _valid_adjustment_set(T, RT, x, y, Z):
                mistakes += 1
    total = n * (n - 1)
    return (mistakes / total if total else 0.0, mistakes)


def parent_aid(true_A, guess_A, edge_direction="from row to column"):
    """Parent-adjustment identification distance (gadjid parent_aid parity).
    Returns (normalized_distance, n_mistakes)."""
    return _aid(true_A, guess_A, "parent", edge_direction)


def ancestor_aid(true_A, guess_A, edge_direction="from row to column"):
    """Ancestor-adjustment identification distance (gadjid ancestor_aid
    parity). Returns (normalized_distance, n_mistakes)."""
    return _aid(true_A, guess_A, "ancestor", edge_direction)


def oset_aid(true_A, guess_A, edge_direction="from row to column"):
    """Optimal-adjustment-set identification distance (gadjid oset_aid
    parity). Returns (normalized_distance, n_mistakes)."""
    return _aid(true_A, guess_A, "oset", edge_direction)
