"""The port stands alone: importing it, and running its paths (sparse and
dense training, evaluation, prediction), loads neither JAX (nor flax,
optax) nor anything of the JAX package."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys
import numpy as np
import torecsys_tpu_torch as pkg
for info in pkgutil.walk_packages(pkg.__path__, prefix=pkg.__name__ + "."):
    importlib.import_module(info.name)
from torecsys_tpu_torch import Inputs, MultiIndicesEmbedding, Pipeline, Trainer, ValueInput
inputs = Inputs({"feat_inputs": ValueInput(("d",)),
                 "emb_inputs": MultiIndicesEmbedding(16, (50, 9), ("a", "b"), device="cpu")})
pipe = (Pipeline(device="cpu").set_inputs(inputs).set_model("DeepFM", deep_layer_sizes=(8,))
        .set_sparse_embeddings(True))
rng = np.random.default_rng(0)
batch = {"a": rng.integers(0, 50, 16), "b": rng.integers(0, 9, 16),
         "d": rng.normal(size=16).astype(np.float32),
         "label": (rng.uniform(size=16) < 0.5).astype(np.float32)}
assert np.isfinite(float(Trainer(pipe).train_steps([batch, batch])[-1]))
dense = Trainer(pipe.set_sparse_embeddings(False))
assert np.isfinite(dense.fit([batch, batch], val_loader=[batch])["val_logloss"])
assert dense.predict(batch).shape == (16, 1)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "torecsys_tpu"))
print("LOADED", bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "LOADED []" in proc.stdout
