"""Runnable examples of the port (twins of the repo's ``examples/``):
``python -m torecsys_tpu_torch.examples.train_fm_sample`` and
``python -m torecsys_tpu_torch.examples.ltr_with_miner``; both run on the
card unless ``--device cpu`` is given."""
