"""``train_mfu``: the whole step's share of the card's peak, in %: the sum
over the step's operations, by the dtype each runs in, of operations over
that dtype's peak (``harness.card.PEAK_OPS_PER_S``; the configuration's
``ops_per_step``), over the untraced window's seconds a step."""

from harness.card import bound_s


def read(seg):
    if seg.step_s <= 0:
        return None
    return 100.0 * bound_s(0.0, seg.ops) / seg.step_s
