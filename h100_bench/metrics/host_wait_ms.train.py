"""``host_wait_ms.train``: host ms a step that the training loop waited for a
packed group (``Trainer.host_ms["wait"]`` over the untraced window, per
step).  It takes in the packing where that runs on the loop's thread."""


def read(seg):
    return seg.host_ms.get("wait")
