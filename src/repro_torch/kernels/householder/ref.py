"""Plain PyTorch version of the Householder panel factorization (its
oracle), and the compact-WY T factor.

``panel_factor_ref`` is the JAX package's ``kernels/householder/ref.py``
(and the TPU kernel's ``_panel_body``) in PyTorch: an unblocked
Householder QR of an (M, b) panel, returning V (M, b) unit-lower
reflectors (v_j[j] = 1, zero above), τ (b,) and R (b, b) upper triangular
with (I − τ_b v_b v_bᵀ)···(I − τ_1 v_1 v_1ᵀ) A = [R; 0].  A zero column
takes the ``safe`` branch: τ = 0 and v = 0, so H = I.  It takes a leading
batch, ``(..., M, b)``, and panels shorter than they are wide (M < b: the
columns past M get τ = 0 and zero rows of R).

``panel_factor_tsqr`` is the CUDA kernel's TSQR route in PyTorch, tile for
tile (Ballard, Demmel, Grigori, Jacquelin, Nguyen, Solomonik,
"Reconstructing Householder vectors from tall-skinny QR", IPDPS 2014):

1. leaf chains: the member's rows are cut into tiles of ``tile`` rows, and
   chain c takes tiles [c·tpb, (c+1)·tpb) from the bottom one up; each step
   is a structured Householder QR of [R; X] (R the chain's running 32 × 32
   triangle, from zero; X the tile), which keeps Y (the reflectors are
   [I; Y]), T (forward LARFT) and the new R;
2. the tree: one more chain over the stacked leaf R's (in steps of
   2·``tile`` rows) gives R_tsqr, and its Q walked down from the top
   tile (C ← C − T C, rows −Y T C) gives each leaf chain's 32 × 32 block
   C_c of the thin Q;
3. the top block: Q₁ = −Y_top[:32] T_top C_0, and the LU Q₁ − S = L U with
   S_jj = −sign(the running diagonal), so |U_jj| = 1 + |q| ≥ 1: then
   R = S R_tsqr and V's top 32 rows are L;
4. apply: each chain walks its tiles from the top with C' = C_c U⁻¹:
   V's rows = −Y (T C'), C' ← C' − T C'; then τ_j = 2 / ||v_j||² (in exact
   arithmetic −U_jj S_jj; from V itself the reflectors are orthogonal to
   rounding).

The running R, T, the walked C and the top block are float64, as in the
kernel: in a chain R grows tile by tile, and float32 copies of T or C put an
error of ε·||R|| into Q R at every step.

Only the leading k nonzero columns are factored (k from the columns that
hold a nonzero): trailing zero columns get V = 0, τ = 0 and zero rows and
columns of R, as the ``safe`` branch gives them.  A panel with a zero
column before a nonzero one goes to ``panel_factor_ref`` (the kernel's
sweep route), since its Q column is not A's.
"""

from __future__ import annotations

import torch


def panel_factor_ref(a_panel: torch.Tensor):
    """(V (..., M, b), τ (..., b), R (..., b, b)), float32."""
    acc = a_panel.float().clone()
    *lead, m, b = acc.shape
    dev = acc.device
    vs = torch.zeros_like(acc)
    taus = torch.zeros((*lead, b), dtype=torch.float32, device=dev)
    rows = torch.arange(m, device=dev)
    for j in range(b):
        mask = (rows >= j).to(acc.dtype)
        x = acc[..., :, j] * mask
        norm = torch.linalg.vector_norm(x, dim=-1)
        x1 = (acc[..., j, j] if j < m
              else torch.zeros(lead, dtype=acc.dtype, device=dev))
        s = torch.where(x1 >= 0, 1.0, -1.0).to(acc.dtype)
        pivot = -s * norm
        v1 = x1 + s * norm
        safe = v1.abs() > 0
        v = x / torch.where(safe, v1, 1.0)[..., None]
        if j < m:
            v[..., j] = safe.to(acc.dtype)
        tau = torch.where(safe, s * v1 / torch.where(norm == 0, 1.0, norm),
                          0.0)
        w = (v[..., None, :] @ acc)[..., 0, :]                 # vᵀ A
        acc = acc - (tau[..., None] * v)[..., :, None] * w[..., None, :]
        if j < m:
            acc[..., j, j] = pivot
        vs[..., :, j] = v
        taus[..., j] = tau
    r = torch.zeros((*lead, b, b), dtype=acc.dtype, device=dev)
    k = min(m, b)
    r[..., :k, :] = torch.triu(acc[..., :k, :])
    return vs, taus, r


def build_t(vs: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
    """Compact-WY T (forward, columnwise, LAPACK's LARFT):
    H_1 … H_b = I − V T Vᵀ.  Takes a leading batch."""
    b = taus.shape[-1]
    vtv = vs.transpose(-1, -2) @ vs
    t = torch.zeros((*taus.shape[:-1], b, b), dtype=vs.dtype,
                    device=vs.device)
    for j in range(b):
        tj = taus[..., j]
        col = -tj[..., None] * (t[..., :, :j] @ vtv[..., :j, j:j + 1])[..., 0]
        t[..., :j, j] = col[..., :j]
        t[..., j, j] = tj
    return t


def tsqr_plan(m: int, batch: int, tile: int, chains: int):
    """(tiles per leaf chain, leaf chains per member, tiles per member) of
    an (M, b) panel: about ``chains`` leaf chains over the whole batch."""
    ntiles = -(-m // tile)
    tpb = -(-ntiles // max(1, -(-chains // batch)))
    return tpb, -(-ntiles // tpb), ntiles


def leading_columns(masks) -> bool:
    """True when the columns holding a nonzero (the OR of ``masks``, a bit
    per column) are the leading ones."""
    mask = 0
    for x in masks:
        mask |= int(x) & 0xFFFFFFFF
    return mask & (mask + 1) == 0


def _structured_step(r: torch.Tensor, x: torch.Tensor):
    """Householder QR of [r; x], r (..., 32, 32) upper in float64, x
    (..., rows, 32) float32: (new r, Y (..., rows, 32) float32, T
    (..., 32, 32) float64) with the reflectors [I; Y], as the kernel's step
    computes them: the tile and its HOUSE (τ, 1/v1, w) in float32, R's rows,
    Z and τ for T in float64, both from the same column sums."""
    r, x = r.clone(), x.clone()
    *lead, _, nb = x.shape
    dd = torch.float64
    cols = torch.arange(nb, device=x.device)
    taus = torch.zeros((*lead, nb), dtype=dd, device=x.device)
    z = torch.zeros((*lead, nb, nb), dtype=dd, device=x.device)
    for j in range(nb):
        xj = x[..., :, j]
        s = (xj[..., None, :] @ x)[..., 0, :].to(dd)       # x · X[:, c]
        x1 = r[..., j, j]
        norm = torch.sqrt(x1 * x1 + s[..., j])
        sgn = torch.where(x1 >= 0, 1.0, -1.0).to(dd)
        v1 = x1 + sgn * norm
        safe = v1.abs() > 0
        tau = torch.where(safe, sgn * v1 / torch.where(norm == 0, 1.0, norm),
                          0.0)
        div = torch.where(safe, v1, 1.0)[..., None]
        w = torch.where(safe[..., None] & (cols > j), s / div + r[..., j, :],
                        0.0)
        z[..., j, :] = torch.where(safe[..., None] & (cols < j), s / div, 0.0)
        # the tile's HOUSE in float32
        sf, x1f, rf = s.float(), x1.float(), r[..., j, :].float()
        normf = torch.sqrt(x1f * x1f + sf[..., j])
        v1f = x1f + sgn.float() * normf
        safef = v1f.abs() > 0
        divf = torch.where(safef, v1f, 1.0)
        tauf = torch.where(safef, sgn.float() * v1f
                           / torch.where(normf == 0, 1.0, normf), 0.0)
        wf = torch.where(safef[..., None] & (cols > j),
                         sf / divf[..., None] + rf, 0.0)
        v = xj * (1.0 / divf)[..., None]
        x[..., :, j + 1:] -= (tauf[..., None] * v)[..., :, None] * \
            wf[..., None, j + 1:]
        x[..., :, j] = v
        r[..., j, j + 1:] -= tau[..., None] * w[..., j + 1:]
        r[..., j, j] = -sgn * norm
        taus[..., j] = tau
    t = torch.zeros_like(z)
    for j in range(nb):
        t[..., :j, j] = -taus[..., j, None] * (
            t[..., :j, :j] @ z[..., j, :j, None])[..., 0]
        t[..., j, j] = taus[..., j]
    return r, x, t


def _chains(tiles: torch.Tensor, live: torch.Tensor):
    """Leaf chains side by side: tiles (..., steps, rows, 32), chain by
    chain, each from its bottom live tile up (``live`` (..., steps) marks
    the tiles that exist).  Returns (R (..., 32, 32) float64, Y like tiles,
    T (..., steps, 32, 32) float64)."""
    *lead, steps, _, nb = tiles.shape
    r = torch.zeros((*lead, nb, nb), dtype=torch.float64, device=tiles.device)
    ys = torch.zeros_like(tiles)
    ts = torch.zeros((*lead, steps, nb, nb), dtype=torch.float64,
                     device=tiles.device)
    for s in reversed(range(steps)):
        rn, y, t = _structured_step(r, tiles[..., s, :, :])
        on = live[..., s, None, None]
        r = torch.where(on, rn, r)
        ys[..., s, :, :] = y
        ts[..., s, :, :] = t
    return r, ys, ts


def _walk(ys: torch.Tensor, ts: torch.Tensor, c: torch.Tensor):
    """Q's rows of chains walked from their top tile: per step W = T C (in
    float64), rows −Y W (float32), C ← C − W.  ys (..., steps, rows, 32),
    ts (..., steps, 32, 32), c (..., 32, 32) float64."""
    out = torch.empty_like(ys)
    for s in range(ys.shape[-3]):
        w = ts[..., s, :, :] @ c
        out[..., s, :, :] = -(ys[..., s, :, :] @ w.float())
        c = c - w
    return out


def _tiles(a: torch.Tensor, tile: int, groups: int, per: int):
    """(B, M, 32) → (B, groups, per, tile, 32), zero rows past M."""
    bsz, m, nb = a.shape
    pad = torch.zeros((bsz, groups * per * tile, nb), dtype=a.dtype,
                      device=a.device)
    pad[:, :m] = a
    return pad.reshape(bsz, groups, per, tile, nb)


def panel_factor_tsqr(a_panel: torch.Tensor, tile: int, chains: int):
    """The TSQR route of ``panel_factor`` (module docstring), tile for tile:
    (V (..., M, b), τ (..., b), R (..., b, b)), float32.  ``tile`` rows a
    leaf step, 2·``tile`` a tree step, and about ``chains`` leaf chains, as
    the kernel plans them (``tsqr_plan``); M >= 32."""
    a = a_panel.float()
    *lead, m, b = a.shape
    if m < 32 or b > 32:
        raise ValueError(f"panel_factor_tsqr: needs M >= 32 and b <= 32, "
                         f"got {tuple(a.shape)}")
    a3 = a.reshape(-1, m, b)
    bsz, dev = a3.shape[0], a.device
    nb = 32
    x = torch.zeros((bsz, m, nb), dtype=torch.float32, device=dev)
    x[..., :b] = a3
    masks = [sum(1 << c for c in range(b) if bool(a3[k, :, c].ne(0).any()))
             for k in range(bsz)]
    if not all(leading_columns([mk]) for mk in masks):
        return panel_factor_ref(a_panel)
    kcols = torch.tensor([mk.bit_length() for mk in masks], device=dev)
    tpb, nblk, ntiles = tsqr_plan(m, bsz, tile, chains)
    # 1. leaf chains
    steps = torch.arange(nblk * tpb, device=dev).reshape(nblk, tpb)
    live = (steps < ntiles).expand(bsz, nblk, tpb)
    r_leaf, y_leaf, t_leaf = _chains(_tiles(x, tile, nblk, tpb), live)
    # 2. the tree over the stacked leaf R's (float32, as the kernel keeps
    # them)
    ntree = -(-(nblk * nb) // (2 * tile))
    stacked = _tiles(r_leaf.float().reshape(bsz, nblk * nb, nb), 2 * tile,
                     1, ntree)
    tlive = torch.ones((bsz, 1, ntree), dtype=torch.bool, device=dev)
    r_tsqr, y_tree, t_tree = _chains(stacked, tlive)
    r_tsqr = r_tsqr[:, 0]
    eye = torch.eye(nb, dtype=torch.float64, device=dev).expand(bsz, 1, nb,
                                                                 nb)
    c_blk = _walk(y_tree, t_tree, eye).reshape(bsz, -1, nb)[:, :nblk * nb]
    c_blk = c_blk.reshape(bsz, nblk, nb, nb).double()
    # 3. the top block, in float64
    q1 = -(y_leaf[:, 0, 0, :nb].double() @ (t_leaf[:, 0, 0] @ c_blk[:, 0]))
    mat = q1.clone()
    d = torch.zeros((bsz, nb), dtype=torch.float64, device=dev)
    on_col = torch.arange(nb, device=dev)[None, :] < kcols[:, None]
    for j in range(nb):
        act = j < kcols
        q = mat[:, j, j]
        dj = torch.where(q >= 0, -1.0, 1.0).to(torch.float64)
        u = q - dj
        mat[:, j, j] = torch.where(act, u, q)
        low = mat[:, j + 1:, j] / u[:, None]
        mat[:, j + 1:, j] = torch.where(act[:, None], low, mat[:, j + 1:, j])
        upd = (act[:, None] & on_col[:, j + 1:])[:, None, :]
        mat[:, j + 1:, j + 1:] -= torch.where(
            upd, low[:, :, None] * mat[:, j, None, j + 1:], 0.0)
        d[:, j] = torch.where(act, dj, 0.0)
    eye64 = torch.eye(nb, dtype=torch.float64, device=dev)
    on = on_col[:, :, None] & on_col[:, None, :]
    u = torch.where(on, torch.triu(mat), eye64)
    uinv = torch.where(on, torch.linalg.inv(u), 0.0)
    r = torch.where(on, torch.triu(d[:, :, None] * r_tsqr), 0.0).float()
    top = torch.where(on_col[:, None, :], torch.tril(mat, -1) + eye64,
                      0.0).float()
    # 4. apply; τ_j = 2 / ||v_j||², the reflector's own τ
    v = _walk(y_leaf, t_leaf, c_blk @ uinv[:, None]).reshape(bsz, -1, nb)
    v = v[:, :m].clone()
    v[:, :nb] = top
    sq = (v.double() ** 2).sum(dim=-2)
    taus = torch.where(sq > 0, 2.0 / torch.where(sq > 0, sq, 1.0),
                       0.0).float()
    return (v[..., :b].reshape(*lead, m, b), taus[:, :b].reshape(*lead, b),
            r[:, :b, :b].reshape(*lead, b, b))
