"""The launch geometry of the backward time loops E, G and I
(`paddle_tpu_torch.ops.time_loop`), at an H100's limits: 132 SMs and
232,448 bytes of opt-in shared memory per block. No card is needed: the
geometry is host arithmetic, and the kernels take exactly what it
returns."""

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

# the narrowest H at which no unit tile's rows of w_hh fit beside the
# smallest staging, per gate count
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
