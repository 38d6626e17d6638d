"""Learning-to-rank with in-batch negative mining, BPR on matrix
factorization (twin of ``examples/ltr_with_miner.py``).

The ``ltr`` objective: the miner splits each batch into positive and
sampled-negative views inside the step (no host round trip), the model
scores both, and a pairwise loss (BPR here) drives the update.  Evaluation
is streaming NDCG@k over mined candidate lists.

Run: ``python -m torecsys_tpu_torch.examples.ltr_with_miner [--device cpu]``
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from torecsys_tpu_torch.inputs import Inputs, MultiIndicesEmbedding
from torecsys_tpu_torch.train import Pipeline, Trainer

USERS, ITEMS = 200, 120


def make_interactions(n: int = 20_000, seed: int = 0):
    """Implicit feedback with planted structure: user u prefers items near
    ``u * ITEMS / USERS``, so a working ranker beats random NDCG easily."""
    rng = np.random.default_rng(seed)
    users = rng.integers(0, USERS, n)
    items = (users * ITEMS // USERS + rng.integers(-8, 9, n)) % ITEMS
    return {"user": users.astype(np.int32), "item": items.astype(np.int32),
            "label": np.ones(n, np.float32)}


def main(epochs: int = 4, batch_size: int = 512, device: Optional[str] = None) -> float:
    data = make_interactions()
    n = len(data["label"])
    split = int(n * 0.85)

    inputs = Inputs({"emb_inputs": MultiIndicesEmbedding(8, (USERS, ITEMS), ("user", "item"),
                                                         device=device)})
    pipeline = (
        Pipeline(device=device)
        .set_objective("ltr")
        .set_inputs(inputs)
        .set_model("MF")
        .set_criterion("BayesianPersonalizedRankingLoss")
        .set_miner("UniformBatchMiner", num_negs=4)
        .set_miner_target_field("item")
        .set_optimizer("Adam", lr=0.02)
        .set_target_fields("label")
    )

    def loader(lo, hi):
        def gen():
            for s in range(lo, hi - batch_size + 1, batch_size):
                yield {k: v[s:s + batch_size] for k, v in data.items()}
        return gen

    trainer = Trainer(pipeline, log_every=10_000, ndcg_k=10)
    trainer.fit(loader(0, split), max_epochs=epochs)
    ndcg = trainer.evaluate(loader(split, n))["val_ndcg@10"]
    print(f"NDCG@10 after {epochs} epochs: {ndcg:.4f}")
    return ndcg


def cli(argv: Optional[Sequence[str]] = None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cpu, or the card (the default)")
    ap.add_argument("--epochs", type=int, default=4)
    args = ap.parse_args(argv)
    return main(epochs=args.epochs, device=args.device)


if __name__ == "__main__":
    cli()
