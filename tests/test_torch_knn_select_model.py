"""CPU models of K1's and K6's select (sgnerf_tpu_torch/csrc/fused_knn.cu):
the lane split, each lane's sorted list, the K merge rounds and the warp's
early stop, stated in torch step for step and held bit for bit to
`fused_knn_select_plain` on tie-heavy rows; then K6's persistent tile
schedule and its shared-memory layout. The kernels themselves run on the
card (tests/test_torch_cuda.py)."""
import os
import re

import numpy as np
import pytest
import torch

from sgnerf_tpu_torch.ops.fused_knn import (fused_knn_select_plain,
                                            fused_knn_select_tiled_plain,
                                            tile_unique)

CU = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "sgnerf_tpu_torch", "csrc", "fused_knn.cu")


def _cu_constant(name):
    """A `constexpr` integer of the kernel's source."""
    with open(CU) as f:
        m = re.search(rf"constexpr \w+ {name} = (\w+);", f.read())
    return int(m.group(1), 0)


NONE = 2 ** 32 - 1           # the key of a rejected candidate (kNone)
FLT_MAX = float(np.finfo(np.float32).max)
LANES = _cu_constant("kLanes")               # lanes a shading point
K6_THREADS = _cu_constant("kTiledThreads")   # threads of a K6 block
K6_MAX_SMEM = _cu_constant("kMaxSmem")       # shared memory a block may use
POINTS_PER_WARP = 32 // LANES


def _keys(rows, delta, ok, r2, C):
    """(M, C) keys as the kernel forms them: the unsigned bits of a valid
    d2 (non-negative, below FLT_MAX), else NONE; and (M, C) int32 ids."""
    x, y, z = (rows[:, i * C:(i + 1) * C].contiguous().view(torch.bfloat16)
               .to(torch.float32) for i in range(3))
    pid = ((rows[:, 4 * C:].to(torch.int32) << 16)
           | (rows[:, 3 * C:4 * C].to(torch.int32) & 0xFFFF))
    ex, ey, ez = x - delta[:, :1], y - delta[:, 1:2], z - delta[:, 2:3]
    d2 = ex * ex + ey * ey + ez * ez       # (ex^2 + ey^2) + ez^2, no FMA
    r2 = torch.tensor(r2, dtype=torch.float32)
    valid = (ok[:, None] & (pid >= 0) & ((d2 <= r2) | (r2 <= 0))
             & (d2 < FLT_MAX))
    bits = d2.view(torch.int32).to(torch.int64)      # d2 >= 0: bits >= 0
    return torch.where(valid, bits, torch.full_like(bits, NONE)), pid


def _lane_lists(key, pid, C):
    """Lane g of a point holds candidates g*N .. g*N+N-1 (N = ceil(C/8));
    past C a slot holds NONE. Returns (M, LANES, N) keys and ids."""
    M = key.shape[0]
    N = -(-C // LANES)
    pad = LANES * N - C
    key = torch.cat([key, torch.full((M, pad), NONE, dtype=key.dtype)], 1)
    pid = torch.cat([pid, torch.full((M, pad), -1, dtype=pid.dtype)], 1)
    return key.reshape(M, LANES, N), pid.reshape(M, LANES, N)


def _lane_sort(key, pid):
    """lane_sort: N passes of odd-even transposition, a pair swapped only
    when the left key is strictly larger (equal keys keep index order)."""
    key, pid = key.clone(), pid.clone()
    N = key.shape[-1]
    for p in range(N):
        for i in range(p & 1, N - 1, 2):
            swap = key[..., i] > key[..., i + 1]
            k0, k1 = key[..., i].clone(), key[..., i + 1].clone()
            p0, p1 = pid[..., i].clone(), pid[..., i + 1].clone()
            key[..., i] = torch.where(swap, k1, k0)
            key[..., i + 1] = torch.where(swap, k0, k1)
            pid[..., i] = torch.where(swap, p1, p0)
            pid[..., i + 1] = torch.where(swap, p0, p1)
    return key, pid


def _merge_rounds(key, pid, K, live):
    """merge_rounds for warps of 4 points (M a multiple of 4; `live` false
    on the points past the end). Returns (M, K) ids and the rounds each
    warp ran before its early stop."""
    key, pid = key.clone(), pid.clone()
    M = key.shape[0]
    out = torch.full((M, K), 7777, dtype=torch.int32)   # never written: 7777
    lane = torch.arange(LANES)
    rounds = torch.full((M // POINTS_PER_WARP,), K)
    stopped = torch.zeros(M // POINTS_PER_WARP, dtype=torch.bool)
    for r in range(K):
        m = key[:, :, 0].clone()                      # each lane's head
        for off in (1, 2, 4):                         # __shfl_xor_sync
            m = torch.minimum(m, m[:, lane ^ off])
        assert (m == m[:, :1]).all()                  # every lane has the min
        m = m[:, 0]
        done = (m == NONE).reshape(-1, POINTS_PER_WARP).all(dim=1)
        stop = done & ~stopped                        # __all_sync
        for w in stop.nonzero().flatten().tolist():
            pts = slice(w * POINTS_PER_WARP, (w + 1) * POINTS_PER_WARP)
            out[pts, r:] = torch.where(live[pts, None],
                                       torch.tensor(-1, dtype=torch.int32),
                                       out[pts, r:])
            rounds[w] = r
        stopped |= stop
        run = ~stopped.repeat_interleave(POINTS_PER_WARP)
        ties = key[:, :, 0] == m[:, None]             # __ballot_sync
        winner = ties.to(torch.int8).argmax(dim=1)    # __ffs: lowest lane
        rows = torch.arange(M)
        head_pid = pid[rows, winner, 0]
        w_out = run & live
        out[w_out, r] = torch.where(m != NONE, head_pid,
                                    torch.tensor(-1, dtype=torch.int32))[w_out]
        pop = run
        key[rows[pop], winner[pop]] = torch.cat(
            [key[rows[pop], winner[pop], 1:],
             torch.full((int(pop.sum()), 1), NONE, dtype=key.dtype)], 1)
        pid[rows[pop], winner[pop]] = torch.cat(
            [pid[rows[pop], winner[pop], 1:],
             torch.full((int(pop.sum()), 1), -1, dtype=pid.dtype)], 1)
    return out, rounds


def model_select(rows, delta, ok, r2, C, K, M_live=None):
    """K1 as the kernel computes it, on M rows (padded to whole warps)."""
    M = rows.shape[0] if M_live is None else M_live
    pad = -rows.shape[0] % POINTS_PER_WARP
    rows = torch.cat([rows, torch.zeros((pad, 5 * C), dtype=rows.dtype)])
    delta = torch.cat([delta, torch.zeros((pad, 3))])
    ok = torch.cat([ok, torch.zeros(pad, dtype=torch.bool)])
    live = torch.arange(rows.shape[0]) < M
    key, pid = _keys(rows, delta, ok & live, r2, C)
    key, pid = _lane_sort(*_lane_lists(key, pid, C))
    out, rounds = _merge_rounds(key, pid, K, live)
    return out[:M], rounds


def _tie_rows(seed, M, C, invalid=0.2):
    """Planar bf16 rows whose offsets and deltas lie on a lattice of 2^-6:
    many candidates share a d2, within a row and across its lanes."""
    rng = np.random.default_rng(seed)
    off = rng.integers(-3, 4, size=(M, C, 3)).astype(np.float32) / 64
    off[:, 1::5] = off[:, :1]                 # exact duplicates too
    pid = rng.integers(0, 1 << 31, size=(M, C), dtype=np.int64).astype(
        np.int32)
    pid[rng.random((M, C)) < invalid] = -1
    xi = torch.from_numpy(off).to(torch.bfloat16).view(torch.int16)
    pi = torch.from_numpy(pid).view(torch.int16).reshape(M, C, 2)
    rows = torch.cat([xi.movedim(-1, -2).reshape(M, -1),
                      pi.movedim(-1, -2).reshape(M, -1)], dim=-1)
    delta = torch.from_numpy(
        rng.integers(-2, 3, size=(M, 3)).astype(np.float32) / 64)
    ok = torch.from_numpy(rng.random(M) < 0.9)
    return rows, delta, ok


KC = [(K, C) for C in (1, 24, 63, 64) for K in (1, 7, 8, 9, 16, 33, 64)
      if K <= C]


@pytest.mark.parametrize("K,C", KC)
def test_model_equals_plain_on_tie_heavy_rows(K, C):
    rows, delta, ok = _tie_rows(K * 100 + C, M=41, C=C)
    for r2 in (0.0, 3 / 64 ** 2):
        got, _ = model_select(rows, delta, ok, r2, C, K)
        ref = fused_knn_select_plain(rows, delta, ok, r2, C=C, K=K)
        assert torch.equal(got, ref), (r2, int((got != ref).sum()))
    # the lattice really ties: some point has equal d2 among its ids
    key, _ = _keys(rows, delta, ok, 0.0, C)
    if C > 1:
        s = key.sort(dim=1).values
        assert ((s[:, 1:] == s[:, :-1]) & (s[:, 1:] != NONE)).any()


@pytest.mark.parametrize("K,C", [(8, 64), (64, 64), (1, 1), (9, 24)])
def test_model_on_rows_with_nothing_to_take(K, C):
    """All candidates invalid (ids -1), every slot invalid, and an r2 that
    rejects every candidate: -1 everywhere, the warp stops at round 0."""
    rows, delta, ok = _tie_rows(5, M=12, C=C, invalid=1.0)
    cases = [(rows, ok, 0.0)]
    rows2, delta, ok2 = _tie_rows(6, M=12, C=C, invalid=0.0)
    cases += [(rows2, torch.zeros_like(ok2), 0.0),
              (rows2, torch.ones_like(ok2), 1e-9)]
    delta = delta + 1 / 256                  # off the lattice: no d2 is 0
    for rows_, ok_, r2 in cases:
        got, rounds = model_select(rows_, delta, ok_, r2, C, K)
        ref = fused_knn_select_plain(rows_, delta, ok_, r2, C=C, K=K)
        assert torch.equal(got, ref) and (got == -1).all()
        assert (rounds == 0).all()


@pytest.mark.parametrize("M", [1, 7, 33])
def test_model_writes_only_the_live_points(M):
    """M not a multiple of a warp's 4 points: the points past the end take
    part in the shuffles but write nothing."""
    rows, delta, ok = _tie_rows(M, M=M, C=64)
    got, _ = model_select(rows, delta, ok, 0.0, 64, 8)
    assert got.shape == (M, 8) and not (got == 7777).any()
    assert torch.equal(got, fused_knn_select_plain(rows, delta, ok, 0.0,
                                                   C=64, K=8))


def test_early_stop_saves_rounds_and_shuffles():
    """At K = 8 a point costs 3 shuffles a round for its warp's 4 points;
    where every point runs out early the warp stops."""
    rows, delta, ok = _tie_rows(9, M=64, C=64, invalid=0.9)
    got, rounds = model_select(rows, delta, ok, 0.0, 64, 8)
    assert torch.equal(got, fused_knn_select_plain(rows, delta, ok, 0.0,
                                                   C=64, K=8))
    assert (rounds < 8).any()
    assert 3 * 8 / POINTS_PER_WARP == 6          # shuffles a point, worst


# ---- K6: the persistent schedule and the shared-memory layout


def k6_grid(M, slots):
    """The C entry's `k6_grid` when `slots` blocks fit the card at once:
    (points a block, blocks); no block takes fewer points than one pass of
    its warps."""
    pass_ = K6_THREADS // LANES
    want = max(1, min(slots, -(-M // pass_)))
    per = max(1, -(-M // want))
    return per, -(-M // per)


def k6_max_rows(C):
    """The most rows a tile may hold at C candidates: U rows of 10 C
    bytes within a block's shared memory (the C entry's check)."""
    return K6_MAX_SMEM // (10 * C)


def _schedule(M, T, slots):
    """Block b's point range and the tiles it stages, in order."""
    per, blocks = k6_grid(M, slots)
    out = []
    for b in range(blocks):
        p0, p1 = b * per, min(M, (b + 1) * per)
        tiles = []
        t = p0 // T
        while t * T < p1:                           # the kernel's tile loop
            tiles.append((t, max(p0, t * T), min(p1, (t + 1) * T)))
            t += 1
        out.append((p0, p1, tiles))
    return per, out


@pytest.mark.parametrize("nt,T,slots", [(144, 1536, 264), (144, 1536, 132),
                                        (1, 64, 264), (5, 1536, 264),
                                        (3, 7, 2), (40, 24, 1000)])
def test_k6_schedule_takes_every_point_once_and_stages_each_tile_once(
        nt, T, slots):
    M = nt * T
    per, sched = _schedule(M, T, slots)
    seen = np.zeros(M, int)
    stagers = {}
    for b, (p0, p1, tiles) in enumerate(sched):
        assert p0 < p1
        assert len({t for t, _, _ in tiles}) == len(tiles)  # once a block
        for t, a, e in tiles:
            assert t * T <= a < e <= (t + 1) * T
            seen[a:e] += 1
            stagers.setdefault(t, []).append(b)
    assert (seen == 1).all()
    assert len(sched) <= slots
    # balanced: the ranges differ by less than a block's pass of points or
    # are all one pass long
    sizes = [p1 - p0 for p0, p1, _ in sched]
    assert max(sizes) - min(sizes) < max(per, K6_THREADS // LANES)
    # a tile is staged by the blocks whose ranges meet it, and by one
    # alone when a block's range covers whole tiles
    for t, bs in stagers.items():
        assert bs == list(range(bs[0], bs[-1] + 1))
        if per >= T:
            assert len(bs) <= 2


def test_k6_eval_chunk_schedule():
    """The eval chunk (144 tiles of 64 rays x SR 24) with 2 blocks on each
    of 132 SMs: 264 blocks of 838 points, none on more than 2 tiles; each
    tile staged by the 2 or 3 blocks whose ranges meet it, 407 stagings in
    all, where the first port staged each tile in each of its 6 blocks
    (864)."""
    per, sched = _schedule(144 * 1536, 1536, 132 * 2)
    assert per == 838 and len(sched) == 264
    assert max(len(tiles) for _, _, tiles in sched) == 2
    by_tile = {}
    for b, (_, _, tiles) in enumerate(sched):
        for t, _, _ in tiles:
            by_tile.setdefault(t, []).append(b)
    assert sorted(by_tile) == list(range(144))
    assert {len(bs) for bs in by_tile.values()} == {2, 3}
    assert sum(len(bs) for bs in by_tile.values()) == 407 < 144 * 6


def _banks(byte_addrs):
    return [(a // 4) % 32 for a in byte_addrs]


@pytest.mark.parametrize("seed", range(3))
def test_k6_shared_rows_are_conflict_free_for_16_byte_loads(seed):
    """Rows stay unpadded (stride 10 C = 640 bytes at C = 64). A 16-byte
    shared load is served a quarter-warp (8 lanes) at a time; a quarter
    warp is one point's 8 lanes, which read 128 contiguous bytes of one
    plane of its row: the 32 words fall in 32 distinct banks, whatever row
    each point of the warp reads."""
    C = 64
    stride = 10 * C
    rng = np.random.default_rng(seed)
    for plane in range(5):
        v = rng.integers(0, 160, size=POINTS_PER_WARP)   # each point's row
        for q in range(POINTS_PER_WARP):                 # quarter-warps
            addrs = [v[q] * stride + plane * 2 * C + 16 * g + 4 * w
                     for g in range(LANES) for w in range(4)]
            assert sorted(_banks(addrs)) == list(range(32))
    assert stride % 16 == 0          # every staged row is 16-byte aligned


def test_k6_takes_the_parents_u_range():
    """U rows a tile up to U * 10 C <= 232,448 bytes, as before the
    redesign (the kernel's kMaxSmem check is the same formula)."""
    assert K6_MAX_SMEM == 232448
    for C in (1, 24, 63, 64):
        U = k6_max_rows(C)
        assert U * 10 * C <= K6_MAX_SMEM < (U + 1) * 10 * C
    assert k6_max_rows(64) == 363


@pytest.mark.parametrize("U,n_slots", [(1, 1), (40, 120), (160, 120),
                                       (363, 400)])
def test_k6_model_equals_plain(U, n_slots):
    """K6 as the kernel computes it: each block's range, point p reading
    row inv[p] of its tile from the staged rows (inv == U: no row), then
    K1's select; equal to the plain K6, overflowed tiles included."""
    nt, T, C, K = 3, 100, 64, 8
    rows, _, _ = _tie_rows(U, M=nt * U, C=C)
    g = torch.Generator().manual_seed(U)
    slot = torch.randint(0, n_slots, (nt * T,), generator=g,
                         dtype=torch.int32)
    okp = torch.rand(nt * T, generator=g) < 0.85
    _, inv = tile_unique(slot, okp, T, U)
    delta = torch.randint(-2, 3, (nt * T, 3), generator=g).float() / 64
    out = torch.full((nt * T, K), 7777, dtype=torch.int32)
    _, sched = _schedule(nt * T, T, slots=4)
    for p0, p1, tiles in sched:
        for t, a, e in tiles:
            staged = rows[t * U:(t + 1) * U]                 # the tile once
            v = inv[a:e]
            has = v < U
            got, _ = model_select(staged[v.clamp(max=U - 1).long()],
                                  delta[a:e], okp[a:e] & has, 9 / 64 ** 2,
                                  C, K)
            out[a:e] = got
    ref = fused_knn_select_tiled_plain(rows, inv, delta, okp, 9 / 64 ** 2,
                                       C=C, K=K, T=T, U=U)
    assert torch.equal(out, ref)
    if U == 40:
        assert bool(((inv == U) & okp).any())          # a tile overflowed
