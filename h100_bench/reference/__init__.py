"""The plain reference of the CTR configurations: plain PyTorch, no kernel
of the program, nothing imported from it.

``precision`` holds the two precisions the reference computes in: the
configuration's own (``stated``), and one step below it (``control``), the
step that would tempt a later change; ``deepfm`` and ``xdeepfm`` the
models' forward passes; ``ctr`` the training steps (lookup, loss, autograd,
the lazy row-wise Adam of the table and Adam of the dense parameters) and
the readings that the benchmark compares.
"""
