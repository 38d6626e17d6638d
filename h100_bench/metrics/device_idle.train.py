"""``device_idle.train``: the share of the traced segment, in %, in which the
card ran no kernel and no copy: 1 minus the union of their intervals over
the segment."""


def read(seg):
    window = seg.device.window_s
    return None if window <= 0 else 100.0 * (1.0 - seg.device.busy_s / window)
