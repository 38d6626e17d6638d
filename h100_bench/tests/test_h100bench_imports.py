"""Nothing the benchmark runs loads JAX or the JAX package: in a fresh
process, ``run.py``'s imports, a cell's files and the program built at a tiny
size load no top-level ``jax``, ``jaxlib``, ``flax``, ``optax`` or
``torecsys_tpu`` (names compared whole: ``torecsys_tpu_torch`` is the port)."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

from conftest import BENCH_DIR, ROOT

from harness import guard

SCRIPT = textwrap.dedent("""
    import json, sys
    sys.path[:0] = [{bench!r}, {root!r}]
    sys.path.insert(0, {tests!r})
    import run
    from conftest import tiny
    from harness import guard
    import torch
    cell = tiny("xdeepfm_criteo.train")
    trainer = cell.model.build_program(cell.config, torch.device("cpu"), 1)
    trainer.train_steps(cell.generator.make_pool(cell.mix, cell.config, 1)[:1])
    print(json.dumps({{"loaded": guard.forbidden_loaded(),
                       "port": "torecsys_tpu_torch" in sys.modules}}))
""")


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = SCRIPT.format(bench=str(BENCH_DIR), root=str(ROOT), tests=str(BENCH_DIR / "tests"))
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=300, check=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line == {"loaded": [], "port": True}


def test_names_are_compared_whole():
    assert guard.forbidden_loaded(["torecsys_tpu_torch", "torecsys_tpu_torch.train"]) == []
    assert guard.forbidden_loaded(["torecsys_tpu.models", "numpy"]) == ["torecsys_tpu"]
    assert guard.forbidden_loaded(["jaxlib.xla_client", "flax", "optax"]) == [
        "flax", "jaxlib", "optax"]
    assert guard.forbidden_loaded(["jaxtyping"]) == []
