"""The frozen byte and operation counts against hand counts at small
shapes."""

import pytest

from portbench.counts import kernels as K
from portbench.counts import peaks


def test_bound_picks_the_larger_time():
    t, by = peaks.bound_s(3.35e12, 0)
    assert t == pytest.approx(1.0) and by == "bytes"
    t, by = peaks.bound_s(1, 67e12 * 2)
    assert t == pytest.approx(2.0) and by == "operations"


def test_b1_first_hits_hand_count():
    # 10 lanes, 4 live, no meshes, 2 spheres and 3 quads
    nb, ops = K.b1_first_hits(10, 4, 0, 0, 2, 3, 0)
    want = (10                       # live flags
            + 4 * 10 * 5             # j, tid, mid, row, sub
            + 4 * 4 * (7 + 8)        # o, d, time in; p, n, u, v out
            + 4 * (2 * 9 + 3 * 47))  # the sphere and quad tables
    assert nb == want
    assert ops == 4 * (5 * 30 + 60)
    nb2, _ = K.b1_first_hits(10, 4, 2, 0, 2, 3, 0)
    assert nb2 - nb == 4 * 10 * 2    # idx_t, idx_n
    nb3, _ = K.b1_first_hits(10, 4, 0, 1, 2, 3, 7)
    assert nb3 - nb == 4 * 4 * 2 + 4 * 7 * 24   # t, tri; the triangle pack


def test_b2_shade_hand_count():
    # 10 lanes, 6 active, 5 of them hit, 1 light, 4 materials
    nb, ops = K.b2_shade(10, 6, 5, False, False, 1, 4)
    hit = 2 + 2 + 3 + 3 + 3 + 3 + 3 + 1 + 1
    miss = 1 + 3 + 3 + 3
    wr = 4 * 3 * 6 + 4 * 9 * 5 + 1
    assert nb == 10 + 4 * (hit * 5 + miss * 1) + wr + 4 * (4 * 20 + 1 * 6)
    assert ops == 6 * (150 + 25)
    last, _ = K.b2_shade(10, 6, 5, False, True, 1, 4)
    assert last == (10 + 4 * ((hit - 1) * 5 + miss) + 4 * 3 * 6
                    + 4 * (4 * 20 + 6))
    pair, _ = K.b2_shade(10, 6, 5, True, False, 1, 4)
    assert pair - nb == 4 * 4 * 5
    plain, _ = K.b2_shade(10, 6, 5, False, False, 1, 4, uv=False)
    assert nb - plain == 4 * 2 * 5


def test_b3_and_b4_hand_count():
    nb, ops = K.b3_bounce_bwd(10, 6, False, True, 2, 3, 4)
    live, dead, out = 10 + 1 + 1 + 3 + 8 + 11, 1 + 10, 16
    tables = 4 * (8 * 2 + 19 * 3 + 21 * 4)
    acc = 4 * (18 * 4 + 8 * 2 + 19 * 3 + 1)
    assert nb == 4 * (6 * live + 4 * dead + 10 * out) + tables + 2 * acc
    assert ops == 0
    assert K.b4_fold(100, 7) == (100 * 16 + 2 * 7 * 12, 0)


def test_tree_kernels_count_each_node_and_triangle_once():
    # a tree of 7 nodes over 32 triangles, leaves of 16: depth 2
    assert K.tree_depth(32, 16) == 2
    nb, ops = K.b5_traverse(10, 4, 7, 32, 1, 16)
    assert nb == 10 + 4 * 6 * 4 + 8 * 10 + 32 * 7 + 72 * 32
    assert ops == 4 * (2 * 27 + 16 * 45)
    nb6, ops6 = K.b6_shadow(10, 4, 2, 80, 120, 3, 1, 7, 32, 1, 16)
    assert nb6 == (10 + 4 * 5 * 4 + 4 * 2 * 10
                   + 4 * (4 * 2 + 9 * 3 + 20 * 1) + 32 * 7 + 72 * 32)
    assert ops6 == 80 * (60 + 2 * 27 + 16 * 45) + 120 * 30
    # the count does not depend on which nodes a walk visited: the same
    # shapes give the same bytes
    assert K.b5_traverse(10, 4, 7, 32, 1, 16) == (nb, ops)
