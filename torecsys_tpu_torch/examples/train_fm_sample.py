"""Train a Factorization Machine on the bundled Criteo sample (twin of
``examples/train_fm_sample.py``).

Parse the Criteo DAC TSV with the port's parser, build the input schema
(dense values and one fused embedding table), configure a Pipeline and fit
with the Trainer.

Run: ``python -m torecsys_tpu_torch.examples.train_fm_sample [--device cpu]``
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from torecsys_tpu_torch.data.native import NUM_CATS, NUM_DENSE, parse_criteo_tsv
from torecsys_tpu_torch.inputs import Inputs, MultiIndicesEmbedding, ValueInput
from torecsys_tpu_torch.train import Pipeline, Trainer

# the repo's bundled sample (a data file beside the JAX package; nothing of
# that package is imported)
SAMPLE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__)))), "torecsys_tpu", "data", "sample", "criteo_sample.tsv")


def main(batch_size: int = 256, epochs: int = 3, device: Optional[str] = None) -> float:
    hash_sizes = (1000,) * NUM_CATS
    with open(SAMPLE, "rb") as f:
        parsed = parse_criteo_tsv(f.read(), hash_sizes)

    # column-dict convention: label / dense_j / cat_i
    data = {"label": parsed["label"]}
    for j in range(NUM_DENSE):
        data[f"dense_{j}"] = parsed["dense"][:, j]
    for i in range(NUM_CATS):
        data[f"cat_{i}"] = parsed["cats"][:, i]
    n = len(data["label"])
    split = int(n * 0.9)

    inputs = Inputs({
        "feat_inputs": ValueInput(tuple(f"dense_{j}" for j in range(NUM_DENSE))),
        "emb_inputs": MultiIndicesEmbedding(8, hash_sizes,
                                            tuple(f"cat_{i}" for i in range(NUM_CATS)),
                                            device=device),
    })
    pipeline = (
        Pipeline(device=device)
        .set_objective("ctr")
        .set_inputs(inputs)
        .set_model("FM")
        .set_criterion("BCEWithLogitsLoss")
        .set_optimizer("Adam", lr=0.01)
        .set_target_fields("label")
    )

    def loader(lo, hi):
        def gen():
            for s in range(lo, hi - batch_size + 1, batch_size):
                yield {k: v[s:s + batch_size] for k, v in data.items()}
        return gen

    trainer = Trainer(pipeline, log_every=1000)
    metrics = trainer.fit(loader(0, split), val_loader=loader(split, n), max_epochs=epochs)
    print(f"val AUC {metrics['val_auc']:.4f}  val logloss {metrics['val_logloss']:.4f}")
    return metrics["val_auc"]


def cli(argv: Optional[Sequence[str]] = None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cpu, or the card (the default)")
    ap.add_argument("--epochs", type=int, default=3)
    args = ap.parse_args(argv)
    return main(epochs=args.epochs, device=args.device)


if __name__ == "__main__":
    cli()
