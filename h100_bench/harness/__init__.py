"""The benchmark's yardstick: what later changes to the program cannot move.

``cell`` reads ``BENCHMARK.json`` and finds a cell's files by name, its
traffic mix's generator among them; ``traffic`` holds the samplers the
generators share; ``weights`` makes the initial weights
from the seed; ``card`` holds the card's checks and published peaks;
``profiling`` the profiler window and its reduction to device intervals;
``layers`` the attribution of device operations to the program's layers;
``counts`` the bytes and operations a step needs; ``check`` the comparison
that decides ``correct``; ``trainer_run`` runs a training cell through the
program's ``Trainer``, calling the configuration's hooks; ``ctr`` the hooks
the CTR configurations share; ``guard`` the check that neither JAX nor the
JAX package was loaded.

Nothing here imports the program at module level: ``ctr`` imports it
inside the functions that build it, so that a checkout without the program
fails at run time with an error, and a test can load these modules alone.
"""
