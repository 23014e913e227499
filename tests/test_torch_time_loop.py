"""The launch geometry of the backward time loops E, G and I and of the
forward loop of D, F and H (`paddle_tpu_torch.ops.time_loop`), at an H100's
limits: 132 SMs and 232,448 bytes of opt-in shared memory per block. No
card is needed: the geometry is host arithmetic, and the kernels take
exactly what it returns."""

import re
from pathlib import Path

import pytest

from paddle_tpu_torch.ops import time_loop as TL

SMS, OPTIN = 132, 232448

# (B, H, gates): E at bench_lstm's shape, at H=256 B=128 and at H=1280;
# G at the seq2seq encoder's and generation's widths, at H=1024 (refused
# by the one-slice design before), and small and ragged batches; E and G
# where w_hh's rows do not fit shared memory (H >= 1536) and where a
# thread carries several pairs (wide H, B >= 128); I (one gate) at the
# RNN benchmark's shape, at H=2048 (refused by the one-launch I) and
# beyond, where its rows are read through L2
SHAPES = [(64, 512, 4), (128, 256, 4), (64, 1280, 4), (64, 512, 3),
          (16, 512, 3), (64, 1024, 3), (64, 256, 3), (100, 512, 4),
          (4, 16, 4), (4, 16, 3), (1, 8, 4), (37, 96, 3), (64, 1536, 4),
          (64, 2048, 4), (64, 4096, 4), (256, 512, 4), (128, 1024, 4),
          (200, 1024, 4), (64, 2048, 3), (128, 2048, 3), (64, 512, 1),
          (4, 16, 1), (37, 96, 1), (16, 2048, 1), (64, 2048, 1),
          (128, 2048, 1), (64, 2560, 1), (64, 3072, 1), (64, 4096, 1)]

# the narrowest H at which no unit tile's rows of w_hh (backward) or
# gate columns (forward, at FORWARD_SHAPES) fit beside the smallest
# staging, per gate count
L2_FROM = {1: 2816, 3: 1536, 4: 1536}


@pytest.mark.parametrize("b,h,gates", SHAPES)
def test_backward_geometry_fits_the_card(b, h, gates):
    g = TL.backward_geometry("t", b, h, gates, SMS, OPTIN)
    cols = gates * h
    # row groups x unit groups cover the batch and the hidden units, in
    # whole thread tiles of ROW_TILE * rep rows x unit_tile units
    bound = {(ut, rep): n for ut, rep, n in TL.LOOP_TILES}
    assert (g.unit_tile, g.rep) in bound
    assert g.unit_groups * g.hb == h and g.hb % g.unit_tile == 0
    assert g.br % (TL.ROW_TILE * g.rep) == 0
    assert (g.row_groups - 1) * g.br < b <= g.row_groups * g.br
    # at most one CTA per SM: the grid is co-resident, which the loop's
    # group barriers need
    assert g.ctas <= SMS
    # rep (row, unit) pairs per thread, whole warps, within the tile's
    # launch bound
    assert g.br * g.hb == g.rep * (g.br * g.hb // g.rep)
    assert g.br * g.hb // g.rep <= g.threads <= bound[g.unit_tile, g.rep]
    assert g.threads % 32 == 0 and g.threads - g.br * g.hb // g.rep < 32
    # the resident rows of w_hh (where they fit) and two staged operand
    # chunks fit
    held = g.hb * (cols + 4) * 4 if g.resident else 0
    assert g.smem == held + 2 * g.br * (g.chunk + 4) * 4
    assert g.smem <= OPTIN and g.chunk % 8 == 0
    # rows are resident whenever any grid can hold them: at least one
    # unit tile's rows plus the smallest staging fit only below L2_FROM
    assert g.resident == (h < L2_FROM[gates])


def test_backward_geometry_prefers_more_ctas_then_fewer_rows():
    """E at bench_lstm's shape takes 4 row groups x 32 unit groups (128
    CTAs, 16 rows each: 128 KB of operand per CTA per step, not all 64
    rows' 512 KB); the grid with as many CTAs and 64 rows each loses."""
    g = TL.backward_geometry("t", 64, 512, 4, SMS, OPTIN)
    assert (g.row_groups, g.unit_groups, g.br, g.hb) == (4, 32, 16, 16)
    assert g.ctas == 128 and g.unit_tile == 4 and g.chunk == 512


def test_backward_geometry_reads_wide_w_hh_from_l2():
    """Where no unit group's rows of w_hh fit shared memory (E at H >=
    1536), the loop reads them from global memory, and the grid keeps
    the rows it reads from L2 each step few: two row groups (w_hh read
    twice) x 64 unit groups (the operand 64 times), not one row group's
    64 x 128. A thread carries 1, 2 or 4 pairs as H grows."""
    for h, (hb, ut, rep) in {1536: (24, 4, 1), 2048: (32, 2, 2),
                             4096: (64, 2, 4)}.items():
        g = TL.backward_geometry("t", 64, h, 4, SMS, OPTIN)
        assert not g.resident and (g.row_groups, g.unit_groups) == (2, 64)
        assert (g.hb, g.br, g.unit_tile, g.rep) == (hb, 32, ut, rep)
    # the widest resident grid at B=256: two pairs per thread
    g = TL.backward_geometry("t", 256, 512, 4, SMS, OPTIN)
    assert g.resident and (g.row_groups, g.unit_groups, g.rep) == (4, 32, 2)


@pytest.mark.parametrize("b,h,gates,match", [
    (64, 510, 4, "multiple of 4"),
    (128, 4096, 4, "2048 \\(row, unit\\) pairs per CTA"),
    (64, 8192, 3, "2048 \\(row, unit\\) pairs per CTA"),
    (20000, 512, 4, "132 CTAs"),
])
def test_backward_geometry_refuses_what_does_not_fit(b, h, gates, match):
    with pytest.raises(ValueError, match=match):
        TL.backward_geometry("t", b, h, gates, SMS, OPTIN)


@pytest.mark.parametrize("rows,h,gates,want", [
    (6400, 512, 4, (4, 1600)),     # E, bench_lstm: 64 tiles x 4
    (1920, 512, 3, (6, 320)),      # G, the seq2seq encoder: 48 tiles x 6
    (12800, 256, 4, (16, 800)),    # E at H=256, B=128: 16 tiles x 16
    (6400, 1280, 4, (1, 6400)),    # E at H=1280: 400 tiles fill the card
    (36, 16, 4, (5, 8)),
])
def test_dw_splits_cover_the_rows(rows, h, gates, want):
    splits, chunk = TL.dw_splits(rows, h, gates, SMS)
    assert (splits, chunk) == want
    assert chunk % 8 == 0 and (splits - 1) * chunk < rows <= splits * chunk


@pytest.mark.parametrize("cols,want", [(2048, 2048), (1536, 1536),
                                       (12, 16), (20, 24)])
def test_operand_rows_start_on_16_bytes(cols, want):
    assert TL.operand_ld(cols) == want


# -- the forward loop (D, F, H) ----------------------------------------------

# (B, H): F at the seq2seq encoder's shape, generation's B=16, H=1024 and
# H=256, small and ragged batches, a batch above the old one-launch
# design's pairs, and widths whose gate columns no longer fit shared
# memory (read from w_hh^T through L2)
FORWARD_SHAPES = [(64, 512), (16, 512), (64, 1024), (64, 256), (4, 16),
                  (1, 8), (37, 96), (100, 512), (128, 1024), (256, 512),
                  (1, 1320), (2048, 4), (64, 1536), (64, 2048), (16, 2048),
                  (48, 2048)]


def _forward_cases(shapes):
    """(B, H, gates) for F (3 gate columns, ids "B-H"), D (4, ids
    "B-H-lstm") and H (1, ids "B-H-rnn") at each shape."""
    return ([pytest.param(b, h, 3, id=f"{b}-{h}") for b, h in shapes]
            + [pytest.param(b, h, 4, id=f"{b}-{h}-lstm") for b, h in shapes]
            + [pytest.param(b, h, 1, id=f"{b}-{h}-rnn") for b, h in shapes])


# The old one-launch forward designs of D, F and H: CTA k owned hb
# hidden units, hb the smallest divisor of H with H / hb <= the SM count
# (one CTA per SM); a thread carried up to 4 (row, unit) pairs over at
# most 512 threads; and every CTA staged all B rows of h in one tile, as
# wide as the room beside its resident slices of w_hh left, of at least
# min(64, H) columns (a row padded by 4 floats).
_ONE_LAUNCH_PAIRS = 512 * 4


def _one_launch_units(b, h):
    """The one-launch designs' units per CTA at (B, H), or None where B x
    hb exceeded the pairs a CTA carried."""
    hb = next(d for d in range(1, h + 1) if h % d == 0 and h // d <= SMS)
    return hb if b * hb <= _ONE_LAUNCH_PAIRS else None


def _one_launch_tile_fits(b, h, resident):
    """Did `resident` bytes of w_hh slices fit beside the narrowest staged
    tile of all B rows?"""
    return resident + b * (min(64, h) + 4) * 4 <= OPTIN


def _one_launch_f_takes(b, h):
    """Does the one-launch F (gate columns [H][hb][4] resident beside a
    staged tile of all B rows, one CTA per unit group) take (B, H)?"""
    hb = _one_launch_units(b, h)
    return hb is not None and _one_launch_tile_fits(b, h, 16 * h * hb)


@pytest.mark.parametrize("b,h,gates", _forward_cases(FORWARD_SHAPES))
def test_forward_geometry_fits_the_card(b, h, gates):
    g = TL.forward_geometry("t", b, h, gates, SMS, OPTIN)
    bound = {(ut, rep): n for ut, rep, n in TL.forward_tiles(gates)}
    assert (g.unit_tile, g.rep) in bound
    # row groups x unit groups cover B and H in whole thread tiles
    assert g.unit_groups * g.hb == h and g.hb % g.unit_tile == 0
    assert g.br % (TL.ROW_TILE * g.rep) == 0
    assert (g.row_groups - 1) * g.br < b <= g.row_groups * g.br
    assert g.ctas <= SMS
    pairs = g.br * g.hb // g.rep
    assert pairs <= g.threads <= bound[g.unit_tile, g.rep]
    assert g.threads % 32 == 0 and g.threads - pairs < 32
    # `gates` gate columns per unit as rows of H (+ 4) f32 where
    # resident, beside two staged chunks of the operand, whose depth is H
    held = gates * g.hb * (h + 4) * 4 if g.resident else 0
    assert g.smem == held + 2 * g.br * (g.chunk + 4) * 4 <= OPTIN
    assert g.chunk % 8 == 0 and g.chunk <= -(-h // 8) * 8
    # the columns are resident wherever the one-launch F ran (D and H: at
    # these shapes too), and from H=1536 (H: 2816) they are not
    assert g.resident == (h < L2_FROM[gates])


@pytest.mark.parametrize("b", [1, 4, 16, 37, 64, 100, 128, 256, 1000])
@pytest.mark.parametrize("h", [4, 8, 16, 96, 256, 512, 1024, 1280, 1320,
                               1408, 1536])
def test_forward_geometry_takes_every_shape_the_one_launch_f_took(b, h):
    if _one_launch_f_takes(b, h):
        g = TL.forward_geometry("t", b, h, 3, SMS, OPTIN)
        assert g.resident and g.ctas <= SMS


def _one_launch_d_takes(b, h):
    """Did the one-launch D (one CTA per unit group, all B rows of h
    staged in one tile of at least 64 columns; its gate columns resident
    beside the tile where they fit, else read from w_hh) take (B, H)?"""
    return (_one_launch_units(b, h) is not None
            and b * (64 + 4) * 4 <= OPTIN)


@pytest.mark.parametrize("b", [1, 4, 16, 37, 64, 100, 128, 256, 854, 1000])
@pytest.mark.parametrize("h", [4, 8, 16, 96, 256, 512, 1024, 1280, 1320,
                               1408, 1536, 2048, 4096])
def test_forward_geometry_takes_every_shape_the_one_launch_d_took(b, h):
    if _one_launch_d_takes(b, h):
        g = TL.forward_geometry("t", b, h, 4, SMS, OPTIN)
        assert g.ctas <= SMS and g.smem <= OPTIN
        # up to bench_lstm's batch the columns stay resident wherever the
        # one-launch D held its slice
        if b <= 64 and h <= 1280:
            assert g.resident


def _one_launch_h_takes(b, h):
    """Did the one-launch H (its units' columns of w_hh, [H][hb] f32,
    resident beside a staged tile of all B rows) take (B, H)?"""
    hb = _one_launch_units(b, h)
    return hb is not None and _one_launch_tile_fits(b, h, 4 * h * hb)


@pytest.mark.parametrize("b", [1, 4, 7, 16, 37, 64, 100, 128, 256, 512,
                               1000, 2048])
@pytest.mark.parametrize("h", [4, 8, 16, 96, 256, 512, 1024, 1320, 1536,
                               2048, 2560, 2816, 3072, 4096])
def test_forward_geometry_takes_every_shape_the_one_launch_h_took(b, h):
    """H on the forward loop, one gate column, takes every shape the
    one-launch H took -- B=100, H=2560 (2000 pairs per CTA there) only
    through the one-gate bounds of the 2 x 4 and 1 x 8 tiles -- and
    keeps the columns resident wherever that H held them but there: 20
    units' rows (205,120 bytes) leave no room for two staged chunks of
    100 rows, where the one-launch H staged one tile, so the loop reads
    them from w_hh^T through L2."""
    if _one_launch_h_takes(b, h):
        g = TL.forward_geometry("t", b, h, 1, SMS, OPTIN)
        assert g.ctas <= SMS and g.smem <= OPTIN
        assert g.resident == ((b, h) != (100, 2560))


def _declared_forward_bounds():
    """{(unit_tile, rep): (one gate, up to 3, 4)} as `time_loop.cuh
    forward_bound` declares them."""
    src = (Path(TL.__file__).resolve().parent.parent / "csrc" /
           "time_loop.cuh").read_text()
    return {(int(ut), int(rep)): (int(one), int(few), int(four))
            for ut, rep, one, few, four in re.findall(
                r"if \(kUT == (\d+) && kRep == (\d+)\) return kOut == 1 "
                r"\? (\d+) : kOut <= 3 \? (\d+) : (\d+);", src)}


def test_forward_bounds_match_the_kernel():
    """Each forward tile's launch bound, for one gate column (H), up to 3
    (F) and 4 (D), is what `time_loop.cuh forward_bound` declares: the
    host never asks a tile for more threads than its kernel was built
    for."""
    declared = _declared_forward_bounds()
    assert declared == {(ut, rep): (one, few, four)
                        for ut, rep, one, few, four in TL.FORWARD_TILES}
    for gates, col in ((1, 0), (2, 1), (3, 1), (4, 2)):
        assert {(ut, rep): n for ut, rep, n in TL.forward_tiles(gates)} == \
            {k: v[col] for k, v in declared.items()}
    # a fourth gate column adds a quarter to a lane's sums: no tile's
    # bound rises with it
    assert all(four <= few for _, _, _, few, four in TL.FORWARD_TILES)


def test_one_gate_bounds_hold_the_one_launch_h_pairs():
    """A one-gate lane keeps a third of F's sums and weight vectors: no
    tile's bound falls from F's, the 4 x 4 tile takes the backward loop's
    768 threads (the same product), and the 2 x 4 and 1 x 8 tiles reach
    512 threads, 2048 and 4096 pairs per CTA: at least the 2048 the
    one-launch H carried."""
    declared = _declared_forward_bounds()
    assert all(one >= few for one, few, _ in declared.values())
    backward = {(ut, rep): n for ut, rep, n in TL.LOOP_TILES}
    assert declared[4, 1][0] == backward[4, 1] == 768
    assert declared[2, 4][0] == declared[1, 8][0] == 512
    assert max(one * rep for (_, rep), (one, _, _) in declared.items()) \
        >= _ONE_LAUNCH_PAIRS


def test_forward_geometry_at_the_encoder_shape():
    """F at T=30, B=64, H=512: 8 row groups x 16 unit groups, 8 rows x 32
    units per CTA in 4 x 4 thread tiles (256 threads), its 96 rows of
    w_hh's columns resident and the whole operand row in one chunk; B=64
    H=2048 reads the columns from L2 with four pairs a thread."""
    g = TL.forward_geometry("t", 64, 512, 3, SMS, OPTIN)
    assert (g.row_groups, g.unit_groups, g.br, g.hb, g.unit_tile,
            g.threads, g.chunk, g.rep, g.resident) == (
        8, 16, 8, 32, 4, 256, 512, 1, True)
    g = TL.forward_geometry("t", 64, 2048, 3, SMS, OPTIN)
    assert not g.resident and g.rep == 4 and g.ctas == 128


def test_forward_geometry_at_bench_lstm_shape():
    """D at T=100, B=64, H=512: four gate columns of 32 units would take
    264 KB, so the grid differs from F's: 4 row groups x 32 unit groups,
    16 rows x 16 units per CTA in 4 x 4 thread tiles (256 threads, the
    tile's bound with four columns), its 64 rows of w_hh's columns
    resident (132 KB) and the whole operand row in one chunk -- E's
    grid. B=64 H=2048 reads the columns from L2, four pairs a thread."""
    g = TL.forward_geometry("t", 64, 512, 4, SMS, OPTIN)
    assert (g.row_groups, g.unit_groups, g.br, g.hb, g.unit_tile,
            g.threads, g.chunk, g.rep, g.resident) == (
        4, 32, 16, 16, 4, 256, 512, 1, True)
    assert g.smem == 4 * 16 * 516 * 4 + 2 * 16 * 516 * 4
    g = TL.forward_geometry("t", 64, 2048, 4, SMS, OPTIN)
    assert not g.resident and g.rep == 4 and g.ctas == 128


def test_forward_geometry_at_the_rnn_shape():
    """H at T=100, B=64, H=512: one gate column gives the grid of I's
    backward loop at the same shape -- 16 row groups x 8 unit groups, 4
    rows x 64 units per CTA in 4 x 4 thread tiles (256 threads), w_hh's
    64 columns resident as rows and the whole operand row in one chunk
    (148,608 bytes of shared memory). B=64 H=2816 reads the columns from
    w_hh^T through L2."""
    g = TL.forward_geometry("t", 64, 512, 1, SMS, OPTIN)
    assert (g.row_groups, g.unit_groups, g.br, g.hb, g.unit_tile,
            g.threads, g.chunk, g.rep, g.resident) == (
        16, 8, 4, 64, 4, 256, 512, 1, True)
    assert g.smem == 64 * 516 * 4 + 2 * 4 * 516 * 4 == 148608
    assert g == TL.backward_geometry("t", 64, 512, 1, SMS, OPTIN)
    assert TL.forward_geometry("t", 64, 2560, 1, SMS, OPTIN).resident
    assert not TL.forward_geometry("t", 64, 2816, 1, SMS, OPTIN).resident


@pytest.mark.parametrize("b,h,match", [
    (64, 510, "multiple of 4"),
    (1024, 1024, "2048 \\(row, unit\\) pairs per CTA"),
    (64, 8192, "pairs per CTA"),
    (20000, 512, "132 CTAs"),
])
def test_forward_geometry_refuses_what_does_not_fit(b, h, match):
    with pytest.raises(ValueError, match=match):
        TL.forward_geometry("t", b, h, 3, SMS, OPTIN)


@pytest.mark.parametrize("b,h,gates", _forward_cases(
    [(64, 512), (16, 512), (37, 96), (4, 16), (100, 64), (1000, 16),
     (48, 256)]))
def test_forward_loop_threads_cover_each_pair_once(b, h, gates):
    """The forward loop's thread mapping (`forward_loop_kernel`: lane l of
    tile (rb, ub) carries rows 4 * (rep * rb + q) + l / unit_tile and
    unit unit_tile * ub + l % unit_tile), applied to every CTA of the
    geometry, stores each (row, unit) pair exactly once."""
    g = TL.forward_geometry("t", b, h, gates, SMS, OPTIN)
    lanes, rows_tile = TL.ROW_TILE * g.unit_tile, TL.ROW_TILE * g.rep
    n_ub = g.hb // g.unit_tile
    n_tiles = (g.br // rows_tile) * n_ub
    seen = []
    for cta in range(g.ctas):
        row0 = (cta // g.unit_groups) * g.br
        unit0 = (cta % g.unit_groups) * g.hb
        for tid in range(g.threads):
            tile, lane = divmod(tid, lanes)
            if tile >= n_tiles:
                continue
            rb, ub = divmod(tile, n_ub)
            j = unit0 + ub * g.unit_tile + lane % g.unit_tile
            for q in range(g.rep):
                row = (row0 + rb * rows_tile + q * TL.ROW_TILE
                       + lane // g.unit_tile)
                if row < b:
                    seen.append((row, j))
    assert len(seen) == len(set(seen)) == b * h
