"""``host_dispatch_ms.train``: host ms a step of the dispatch itself:
``Trainer.host_ms["step"] + host_ms["place"]`` over the untraced window,
per step (the copy of a group to the card and the enqueue of its graph
replay, or of eager steps)."""


def read(seg):
    if "step" not in seg.host_ms:
        return None
    return seg.host_ms["step"] + seg.host_ms.get("place", 0.0)
