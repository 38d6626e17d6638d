"""``mesh_mfu.train``: one card's share of its peak, in %: the operations a
step of one card (the configuration's ``ops_per_step``; at data 1 each card
runs the whole batch's tower), by the dtype each runs in, over that dtype's
peak (``harness.card.PEAK_OPS_PER_S``), over the untraced window's seconds a
step."""

from harness.card import bound_s


def read(seg):
    if seg.step_s <= 0:
        return None
    return 100.0 * bound_s(0.0, seg.ops) / seg.step_s
