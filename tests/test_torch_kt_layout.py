"""The kt mirror's layout inside kernel #7 (csrc/decode_attention.cuh,
the mirror layout), emulated in numpy on the CPU: a committed tile lands
feature-major and swizzled (`kt_swz`), q.K^T reads it by ldmatrix.trans
with lane row addresses in the int8 feature order (`k_feature`), and the
score fragments' positions (`tpos`) are the order p.V's V rows follow; the
flush transposes 4 x 4 byte blocks with byte permutes. Each emulation
mirrors the kernel's index arithmetic and checks it against the plain
definition: the scores equal q . K at the positions `tpos` names, the
eight lines of every ldmatrix matrix meet eight distinct 16-byte bank
groups, and the flushed lines equal the tile's columns.

Shapes: D = 64 and 128, tiles of 16, 32 and 64 positions (the tiles
`attention_plan` picks; each divides a 128-position chunk). No JAX.
"""

import numpy as np
import pytest

from deeppowers_tpu_torch.ops.kernels import decode_attention as da

TILES = [16, 32, 64]
DIMS = [64, 128]


def kt_swz(lam, f, cpl, d):
    """csrc `kt_swz`: chunk lam of line f XOR its quarter of D's pattern."""
    qd = f // (d // 4)
    h = 2 * qd if cpl == 1 else ((qd & 1) | ((qd & 2) << 1)) if cpl == 2 \
        else qd
    return lam ^ h


def k_feature(ks, c, i, d):
    """csrc `k_feature` for int8 K."""
    return (d // 4) * c + 4 * ks + i


def tpos(nt, e, c, fm):
    """csrc `tpos`."""
    return 4 * c + 2 * e + nt if fm else 8 * nt + 2 * c + e


def land(tile, d, tl):
    """`copy_kt`: the (D, TL) feature-major tile's 16-byte chunks at their
    swizzled places in shared memory."""
    cpl = tl // 16
    sm = np.zeros(d * tl, np.uint8)
    for x in range(d * cpl):
        f, q = divmod(x, cpl)
        p = kt_swz(x, f, cpl, d)
        sm[16 * p:16 * p + 16] = tile[f, 16 * q:16 * q + 16].view(np.uint8)
    return sm


def row_addresses(kp, sb, d, tl):
    """The byte address each lane gives ldmatrix.x4.trans for k-step pair
    kp of sub-block sb: lane row r of matrix mx is feature (D/4)(r // 2)
    + 4 (2 kp + mx // 2) + 2 (mx % 2) + r % 2."""
    cpl = tl // 16
    out = []
    for lane in range(32):
        mx, r = lane >> 3, lane & 7
        f = (d // 4) * (r >> 1) + 4 * (2 * kp + (mx >> 1)) + 2 * (mx & 1) + \
            (r & 1)
        out.append(16 * kt_swz(f * cpl + sb, f, cpl, d))
    return out


def ldmatrix_x4_trans(sm, addr):
    """Four 8 x 8 b16 matrices, lanes 8m..8m + 7 addressing matrix m's
    rows; .trans: thread t's register m holds (row 2(t % 4), column t / 4)
    in its low half and row 2(t % 4) + 1 in its high half. Returns (32, 4,
    4) bytes."""
    regs = np.zeros((32, 4, 4), np.uint8)
    for m in range(4):
        rows = [sm[addr[8 * m + r]:addr[8 * m + r] + 16] for r in range(8)]
        for t in range(32):
            g, c = t >> 2, t & 3
            regs[t, m] = np.concatenate([rows[2 * c][2 * g:2 * g + 2],
                                         rows[2 * c + 1][2 * g:2 * g + 2]])
    return regs


@pytest.mark.parametrize("tl", TILES)
@pytest.mark.parametrize("d", DIMS)
def test_feature_major_scores_follow_tpos(d, tl):
    """q.K^T of a feature-major tile through the emulated fragments: the
    score a thread holds as element e of n8 tile nt is q . K at position
    rb + tpos(nt, e, c), and p.V's V rows (k indices 2c, 2c + 1, 2c + 8,
    2c + 9 of the thread) are those positions too."""
    rng = np.random.default_rng(d + tl)
    k = rng.integers(-128, 128, (tl, d), dtype=np.int8)      # (pos, feature)
    q = rng.integers(-8, 8, (16, d)).astype(np.int64)        # 16 query rows
    sm = land(np.ascontiguousarray(k.T), d, tl)
    ks_n = d // 16
    for sb in range(tl // 16):
        rb = 16 * sb
        sc = np.zeros((2, 32, 4), np.int64)     # [nt][thread][C fragment]
        for kp in range(ks_n // 2):
            regs = ldmatrix_x4_trans(sm, row_addresses(kp, sb, d, tl))
            vals = regs.view(np.int8).astype(np.int64)
            for half in range(2):
                ks = 2 * kp + half
                for nt in range(2):
                    b = np.zeros((16, 8), np.int64)           # B[k][n]
                    for t in range(32):
                        g, c = t >> 2, t & 3
                        b0, b1 = vals[t, 2 * half], vals[t, 2 * half + 1]
                        b[2 * c, g], b[2 * c + 1, g] = b0[nt], b0[2 + nt]
                        b[2 * c + 8, g], b[2 * c + 9, g] = b1[nt], b1[2 + nt]
                    a = np.zeros((16, 16), np.int64)          # A[row][k]
                    for c in range(4):
                        for i in range(4):
                            kk = 2 * c + (i & 1) + 8 * (i >> 1)
                            a[:, kk] = q[:, k_feature(ks, c, i, d)]
                    cm = a @ b                                # (16, 8)
                    for t in range(32):
                        g, c = t >> 2, t & 3
                        sc[nt, t] += [cm[g, 2 * c], cm[g, 2 * c + 1],
                                      cm[g + 8, 2 * c], cm[g + 8, 2 * c + 1]]
        ref = q @ k.astype(np.int64).T                        # (16, TL)
        for t in range(32):
            g, c = t >> 2, t & 3
            for nt in range(2):
                for e in range(2):
                    pos = rb + tpos(nt, e, c, True)
                    assert sc[nt, t, e] == ref[g, pos]
                    assert sc[nt, t, 2 + e] == ref[g + 8, pos]
            # p.V: k index kappa of p (tile kappa // 8, column kappa % 8)
            # sits at position 2 (kappa % 8) + kappa // 8
            for e4, kappa in enumerate((2 * c, 2 * c + 1, 2 * c + 8,
                                        2 * c + 9)):
                assert tpos(e4 >> 1, e4 & 1, c, True) == \
                    2 * (kappa % 8) + kappa // 8


@pytest.mark.parametrize("tl", TILES)
@pytest.mark.parametrize("d", DIMS)
def test_feature_major_reads_meet_no_bank_twice(d, tl):
    """Every ldmatrix matrix's eight 16-byte lines fall in eight distinct
    bank groups (addr / 16 mod 8), and the landing puts every chunk in its
    own place."""
    cpl = tl // 16
    places = {kt_swz(x, x // cpl, cpl, d) for x in range(d * cpl)}
    assert places == set(range(d * cpl))
    for sb in range(cpl):
        for kp in range(d // 32):
            addr = row_addresses(kp, sb, d, tl)
            for m in range(4):
                groups = {(a // 16) % 8 for a in addr[8 * m:8 * m + 8]}
                assert len(groups) == 8, (sb, kp, m)


def byte_perm(x, y, s):
    """__byte_perm(x, y, s) on 32-bit words (no sign modes)."""
    src = list(int(x).to_bytes(4, "little")) + list(int(y).to_bytes(4,
                                                                "little"))
    return int.from_bytes(bytes(src[(s >> (4 * i)) & 7] for i in range(4)),
                          "little")


def test_flush_transposes_four_by_four_blocks():
    """`flush_kt`'s byte permutes: four positions' words of four features
    become four features' words of four positions."""
    rng = np.random.default_rng(4)
    blk = rng.integers(0, 256, (4, 4), dtype=np.uint8)     # [position][feat]
    w = [int.from_bytes(bytes(blk[i]), "little") for i in range(4)]
    t0 = byte_perm(w[0], w[1], 0x5140)
    t1 = byte_perm(w[0], w[1], 0x7362)
    t2 = byte_perm(w[2], w[3], 0x5140)
    t3 = byte_perm(w[2], w[3], 0x7362)
    out = [byte_perm(t0, t2, 0x5410), byte_perm(t0, t2, 0x7632),
           byte_perm(t1, t3, 0x5410), byte_perm(t1, t3, 0x7632)]
    for j in range(4):
        assert list(out[j].to_bytes(4, "little")) == list(blk[:, j])


@pytest.mark.parametrize("rows", [1, 5, 8, 40])
@pytest.mark.parametrize("kh, d", [(32, 128), (4, 64)])
def test_kt_plan_tiles_divide_a_chunk(kh, d, rows):
    """The plan #7 launches with (`attention_plan` at the mirror's S):
    tiles of 16-64 positions, each dividing a chunk (so a tile is
    committed or tail as a whole), splits starting on a tile."""
    plan = da.attention_plan(8, kh, 1024, rows, d)
    assert plan.tile in TILES and da.KT_CHUNK % plan.tile == 0
    assert plan.chunk % plan.tile == 0
