"""CPU models of K3's schedules (sgnerf_tpu_torch/csrc/fused_agg_bwd.cu):
K3c's split-K weight gradient over fixed slabs of rows and its output
tiles, and K3b's tiles of rows; the kernels themselves run on the card
(tests/test_torch_cuda.py)."""
import numpy as np
import pytest

from sgnerf_tpu_torch.ops.fused_agg import (K3C_SLAB, TILE_ROWS, k3_tiles,
                                            wgrad_slabs)

TILE = 128    # K3c's output tile, rows and columns (kTI, kTC)
STAGE = 16    # rows a K3c stage holds (kKC)


def _tiles(n_layers, in0, C):
    """K3c's grid.x as its kernel decodes it: block -> (product, i0, c0)."""
    def per(nin):
        return -(-nin // TILE) * -(-C // TILE)
    total = per(in0) + (n_layers - 1) * per(C)
    out = []
    for b in range(total):
        tile, p, nin = b, 0, in0
        while tile >= per(nin):
            tile -= per(nin)
            p, nin = p + 1, C
        nct = -(-C // TILE)
        out.append((p, (tile // nct) * TILE, (tile % nct) * TILE, nin))
    return out


@pytest.mark.parametrize("N", [1, 2047, 2048, 2049, 4100, 196608])
def test_slabs_take_every_row_once_in_order(N):
    slabs = wgrad_slabs(N)
    assert slabs[0][0] == 0 and slabs[-1][1] == N
    assert all(a[1] == b[0] for a, b in zip(slabs, slabs[1:]))
    assert all(hi - lo == K3C_SLAB for lo, hi in slabs[:-1])
    assert 0 < slabs[-1][1] - slabs[-1][0] <= K3C_SLAB
    assert (N % K3C_SLAB != 0) == (slabs[-1][1] - slabs[-1][0] < K3C_SLAB)


@pytest.mark.parametrize("n_layers,in0,C", [(2, 284, 256), (3, 86, 32),
                                            (1, 172, 160)])
def test_wgrad_tiles_cover_every_output_once(n_layers, in0, C):
    seen = [np.zeros((in0 if p == 0 else C, C), int)
            for p in range(n_layers)]
    for p, i0, c0, nin in _tiles(n_layers, in0, C):
        seen[p][i0:min(i0 + TILE, nin), c0:min(c0 + TILE, C)] += 1
    assert all((s == 1).all() for s in seen)


def test_split_k_model_sums_every_row_once():
    """The schedule on ones: every (i, c) of a slab's partial counts its
    rows, stage by stage (zero past the end), and the partials, summed in
    slab order, count N: no row is dropped or summed twice. On seeded
    operands the same schedule gives x^T d."""
    N, nin, C = 4100, 40, 24
    rng = np.random.default_rng(0)
    for x, d in ((np.ones((N, nin), np.float32), np.ones((N, C), np.float32)),
                 (rng.normal(size=(N, nin)).astype(np.float32),
                  rng.normal(size=(N, C)).astype(np.float32))):
        out = np.zeros((nin, C), np.float32)
        for lo, hi in wgrad_slabs(N):
            part = np.zeros((nin, C), np.float32)
            for r in range(lo, lo + -(-(hi - lo) // STAGE) * STAGE, STAGE):
                xs = np.zeros((STAGE, nin), np.float32)
                ds = np.zeros((STAGE, C), np.float32)
                xs[:max(0, min(hi - r, STAGE))] = x[r:min(hi, r + STAGE)]
                ds[:max(0, min(hi - r, STAGE))] = d[r:min(hi, r + STAGE)]
                part += xs.T @ ds
            out += part
        ref = x.astype(np.float64).T @ d.astype(np.float64)
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-3)
    assert (out != 0).all()


@pytest.mark.parametrize("bf16", [False, True])
def test_k3b_tiles_take_every_row_once(bf16):
    """K3b's blocks and alpha_part's rows: tiles of TILE_ROWS rows, the
    last ragged; K3b's CUDA alpha_part has one row a tile."""
    for N in (1, 63, 64, 65, 196608):
        T = k3_tiles(N, bf16)
        rows = TILE_ROWS[bf16]
        assert (T - 1) * rows < N <= T * rows
