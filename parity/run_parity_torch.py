"""Run PARITY.md's protocol (configs 1-5) through the PyTorch port and write
PARITY_TORCH.json.

The protocol is ``parity/run_parity.py``'s: the same synthetic data (the
port's ``make_synthetic_ctr``, equal to the JAX package's arrays), split,
Adam at 3e-3, batch 1024, epochs and seeds, the same models and inputs
(:data:`OUR_SPECS`, :func:`build_schema`), and for config 5 the same
implicit-feedback data, loader reshuffles, miner and NDCG@10.  Each model
trains through the port's public pipeline (``Pipeline``, ``Trainer.fit``,
then ``Trainer.predict`` for NDCG) on two routes:

* ``default``: the automatic choice (these tables are small: the dense
  route; on the card its lookup is ``row_gather`` and its table gradient
  ``fused_sorted_dedup_update``);
* ``sparse``: ``Pipeline.set_sparse_embeddings(True)`` with ``presort``
  None: on the card the on-device route (``row_gather``,
  ``widen_segment_sum``, ``fused_rowwise_update`` with rule ``adam``), on the
  CPU the presorted route.  The ``ltr`` objective has the dense route only,
  as in the JAX package, so config 5 runs on ``default`` alone.

On the card both routes take 8 steps a dispatch (CUDA graphs).  Each row
records the port's per-seed metrics with their mean and band (max - min)
per device and route, beside ``PARITY.json``'s columns for the JAX package
(``ours`` there, ``jax`` here) and for the reference oracle, and is judged
by PARITY.md's rule: the delta of means lies inside the larger of the two
seed bands.  xDeepFM with BatchNorm is judged against both columns; config 5
is judged by whether its NDCG range overlaps the JAX column's.

This file imports neither JAX nor the JAX package: it keeps its own copies
of ``make_implicit_data``, ``ndcg_at_k`` and ``eval_ndcg``.

Run:  python parity/run_parity_torch.py --device cpu    (the CPU columns)
      python3 chip_smoke.py --phases parity            (the card's columns)
Each run merges its device's columns into the JSON it writes (``--out``,
by default PARITY_TORCH.json beside PARITY.json), keeping the other's.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

FIELD_SIZES = (200, 100, 100, 50, 50, 20)
N_FIELDS = len(FIELD_SIZES)
NUM_DENSE = 0
PAIR_SCALE = 2.0
ROWS, TRAIN = 120_000, 100_000
DATA_SEED = 7
N_SEEDS = 5  # configs 1-4 (config 5 takes NCF_SEEDS)
E = 8
EPOCHS = 6
LR = 3e-3
BATCH = 1024
CAT = tuple(f"cat_{i}" for i in range(N_FIELDS))
CARD_STEPS_PER_EXECUTION = 8
ROUTES = {"default": None, "sparse": True}
JAX_JSON = os.path.join(REPO, "PARITY.json")
OUT_JSON = os.path.join(REPO, "PARITY_TORCH.json")

CONFIG_MODELS = {
    "config1_lr": ["LR"],
    "config2_fm_ffm": ["FM", "FFM"],
    "config3_deepfm_nfm": ["DeepFM", "NFM"],
    "config4_dcn_xdeepfm": ["DCN", "xDeepFM", "xDeepFM_noBN"],
}

# name: (registry name, {"schema": kind, "criterion": ...}, model kwargs),
# as parity/run_parity.py's OUR_SPECS
OUR_SPECS = {
    "LR": ("LR", {"schema": "feat_only", "criterion": "BCELoss"}, {}),
    "FM": ("FM", {"schema": "feat_emb"}, {"dropout_rate": 0.0}),
    "FFM": ("FFM", {"schema": "feat_fieldemb"}, {"num_fields": N_FIELDS}),
    "DeepFM": ("DeepFM", {"schema": "feat_emb"}, {"deep_layer_sizes": (64, 64)}),
    "NFM": ("NFM", {"schema": "feat_emb"}, {"deep_layer_sizes": (64, 64)}),
    "DCN": ("DCN", {"schema": "emb_only"}, {
        "cross_num_layers": 2, "deep_output_size": 16, "deep_layer_sizes": (64, 64)}),
    "xDeepFM": ("xDeepFM", {"schema": "feat_emb"}, {
        "embed_size": E, "num_fields": N_FIELDS,
        "cin_layer_sizes": (16, 16), "deep_layer_sizes": (64, 64)}),
    "xDeepFM_noBN": ("xDeepFM", {"schema": "feat_emb"}, {
        "embed_size": E, "num_fields": N_FIELDS, "use_batchnorm": False,
        "cin_layer_sizes": (16, 16), "deep_layer_sizes": (64, 64)}),
}
# judged against the reference oracle's column too (PARITY.md: BatchNorm's
# running statistics differ between the frameworks)
BOTH_COLUMNS = ("xDeepFM",)

# ---- config 5: NCF + BPR, NDCG@10 (parity/run_parity.py:260-330) ---------

U_USERS, N_ITEMS, LATENT = 600, 1200, 8
LTR_ROWS, LTR_TRAIN = 60_000, 50_000
NCF_E = 16
EPOCHS_LTR = 5
NCF_SEEDS = 4
LTR_SHUFFLE_SEED = 5
PREDICT_BATCH = 8192


def make_implicit_data(seed=11):
    """Latent-factor implicit feedback: positives are high-affinity pairs."""
    rng = np.random.default_rng(seed)
    uf = rng.normal(0, 1.0, size=(U_USERS, LATENT))
    vf = rng.normal(0, 1.0, size=(N_ITEMS, LATENT))
    users = rng.integers(0, U_USERS, LTR_ROWS).astype(np.int32)
    # a positive is the best of 8 random items by affinity
    cands = rng.integers(0, N_ITEMS, (LTR_ROWS, 8))
    scores = np.einsum("rk,rck->rc", uf[users], vf[cands])
    items = cands[np.arange(LTR_ROWS), scores.argmax(1)].astype(np.int32)
    return {"user": users, "item": items}, uf, vf


def ndcg_at_k(rank_of_pos: np.ndarray, k: int = 10) -> float:
    """Mean NDCG@k for lists with exactly one relevant item."""
    gain = np.where(rank_of_pos < k, 1.0 / np.log2(rank_of_pos + 2.0), 0.0)
    return float(gain.mean())  # IDCG == 1 (the relevant item at rank 0)


def eval_ndcg(score_pairs, data, seed=12, n_users=3000, n_cand=100):
    """Rank 1 held-out positive against 99 random negatives per user."""
    rng = np.random.default_rng(seed)
    eval_rows = rng.choice(np.arange(LTR_TRAIN, LTR_ROWS), n_users, replace=False)
    users = data["user"][eval_rows]
    pos = data["item"][eval_rows]
    negs = rng.integers(0, N_ITEMS, (n_users, n_cand - 1)).astype(np.int32)
    items = np.concatenate([pos[:, None], negs], axis=1)  # (U, C), column 0 the positive
    u_rep = np.repeat(users, n_cand)
    scores = score_pairs(u_rep, items.reshape(-1)).reshape(n_users, n_cand)
    rank_of_pos = (scores > scores[:, :1]).sum(axis=1)
    return ndcg_at_k(rank_of_pos, k=10)


# ---- the port's side -----------------------------------------------------


def loader(data, lo, hi, shuffle_seed=None):
    """Batches of rows ``[lo, hi)``; with ``shuffle_seed`` the rows reshuffle
    every epoch (the in-batch miner's negative pools change with them)."""
    state = {"epoch": 0}

    def gen():
        idx = np.arange(lo, hi)
        if shuffle_seed is not None:
            rng = np.random.default_rng(shuffle_seed + state["epoch"])
            rng.shuffle(idx)
            state["epoch"] += 1
        for s in range(0, len(idx) - BATCH + 1, BATCH):
            sl = idx[s:s + BATCH]
            yield {k: v[sl] for k, v in data.items()}
    return gen


def ctr_data():
    from torecsys_tpu_torch.data.sample_data import make_synthetic_ctr

    return make_synthetic_ctr(num_rows=ROWS, field_sizes=FIELD_SIZES, num_dense=NUM_DENSE,
                              seed=DATA_SEED, pair_scale=PAIR_SCALE)


def build_schema(kind, device):
    """The protocol's inputs: a 1-wide embedding of the fields as the first
    order (NUM_DENSE is 0), the E-wide one, or the field-aware one."""
    from torecsys_tpu_torch.inputs import MultiIndicesEmbedding, MultiIndicesFieldAwareEmbedding

    def feat():
        return MultiIndicesEmbedding(1, FIELD_SIZES, CAT, device=device)

    if kind == "feat_only":
        return {"feat_inputs": feat()}
    if kind == "feat_emb":
        return {"feat_inputs": feat(),
                "emb_inputs": MultiIndicesEmbedding(E, FIELD_SIZES, CAT, device=device)}
    if kind == "emb_only":
        return {"emb_inputs": MultiIndicesEmbedding(E, FIELD_SIZES, CAT, device=device)}
    if kind == "feat_fieldemb":
        return {"feat_inputs": feat(),
                "field_emb_inputs": MultiIndicesFieldAwareEmbedding(E, FIELD_SIZES, CAT,
                                                                    device=device)}
    raise KeyError(kind)


def steps_per_execution(device) -> int:
    return CARD_STEPS_PER_EXECUTION if str(device).startswith("cuda") else 1


def route_name(trainer) -> str:
    if not trainer.sparse:
        return "dense"
    return "presorted" if trainer._presorter is not None else "ondevice"


def run_port(data, name, seed, device, route):
    """One seed of one CTR row: ``fit`` over the protocol's epochs with the
    held-out rows as ``val_loader``; the last epoch's metrics."""
    from torecsys_tpu_torch import Inputs, Pipeline, Trainer

    reg_name, meta, kwargs = OUR_SPECS[name]
    pipe = (Pipeline(device=device).set_objective("ctr")
            .set_inputs(Inputs(build_schema(meta["schema"], device)))
            .set_model(reg_name, **kwargs)
            .set_criterion(meta.get("criterion", "BCEWithLogitsLoss"))
            .set_optimizer("Adam", lr=LR).set_sparse_embeddings(ROUTES[route])
            .set_target_fields("label"))
    trainer = Trainer(pipe, log_every=10**9, seed=seed,
                      steps_per_execution=steps_per_execution(device))
    t0 = time.perf_counter()
    m = trainer.fit(loader(data, 0, TRAIN), val_loader=loader(data, TRAIN, ROWS),
                    max_epochs=EPOCHS)
    return {"auc": round(m["val_auc"], 4), "logloss": round(m["val_logloss"], 4),
            "seconds": round(time.perf_counter() - t0, 1), "route": route_name(trainer),
            "graph_stats": trainer.graph_stats}


def run_port_ncf_bpr(data, seed, device, route="default"):
    """One seed of config 5: NCF + BPR with one in-batch negative, trained
    over the reshuffling loader; NDCG@10 from ``Trainer.predict``."""
    from torecsys_tpu_torch import Inputs, Pipeline, Trainer
    from torecsys_tpu_torch.inputs import MultiIndicesEmbedding

    pipe = (Pipeline(device=device).set_objective("ltr")
            .set_inputs(Inputs({"emb_inputs": MultiIndicesEmbedding(
                NCF_E, (U_USERS, N_ITEMS), ("user", "item"), device=device)}))
            .set_model("NCF", deep_layer_sizes=(32,))
            .set_criterion("BayesianPersonalizedRankingLoss")
            .set_optimizer("Adam", lr=LR).set_sparse_embeddings(ROUTES[route])
            .set_miner("UniformBatchMiner", num_negs=1).set_miner_target_field("item")
            .set_target_fields("label"))
    trainer = Trainer(pipe, log_every=10**9, seed=seed,
                      steps_per_execution=steps_per_execution(device))
    train = {k: v[:LTR_TRAIN] for k, v in data.items()}
    t0 = time.perf_counter()
    trainer.fit(loader(train, 0, LTR_TRAIN, shuffle_seed=LTR_SHUFFLE_SEED),
                max_epochs=EPOCHS_LTR)

    def score_pairs(users, items):
        out = []
        for s in range(0, len(users), PREDICT_BATCH):
            batch = {"user": users[s:s + PREDICT_BATCH], "item": items[s:s + PREDICT_BATCH]}
            out.append(trainer.predict(batch).float().cpu().numpy().reshape(-1))
        return np.concatenate(out)

    ndcg = eval_ndcg(score_pairs, data)
    return {"ndcg@10": round(ndcg, 4), "seconds": round(time.perf_counter() - t0, 1),
            "route": route_name(trainer), "graph_stats": trainer.graph_stats}


def band(runs, key):
    vals = [r[key] for r in runs]
    return {f"{key}_per_seed": vals, f"{key}_mean": round(float(np.mean(vals)), 4),
            f"{key}_band": round(float(np.max(vals) - np.min(vals)), 4)}


def judge_ctr(port, column):
    """PARITY.md's rule: the delta of AUC means inside the larger seed band."""
    joint = max(port["auc_band"], column["auc_band"])
    delta = round(port["auc_mean"] - column["auc_mean"], 4)
    return {"auc_delta_of_means": delta, "auc_seed_band_max": round(joint, 4),
            "logloss_delta_of_means": round(port["logloss_mean"] - column["logloss_mean"], 4),
            "within_band": bool(abs(delta) <= joint + 1e-9)}


def judge_ndcg(port, column):
    """Config 5: the port's NDCG range overlaps the column's."""
    lo, hi = min(port["ndcg@10_per_seed"]), max(port["ndcg@10_per_seed"])
    clo, chi = min(column["ndcg@10_per_seed"]), max(column["ndcg@10_per_seed"])
    return {"ndcg_delta_of_means": round(port["ndcg@10_mean"] - column["ndcg@10_mean"], 4),
            "bands_overlap": bool(lo <= chi + 1e-9 and clo <= hi + 1e-9)}


def card_line(device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or "cpu"."""
    if not str(device).startswith("cuda"):
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def run_protocol(device, n_seeds=N_SEEDS, ncf_seeds=NCF_SEEDS, only=None, routes=tuple(ROUTES),
                 log=print):
    """Train every row on ``device`` over ``routes``; returns
    ``{config: {row: {route: {"runs": [...], **bands}}}}``."""
    out = {}
    data = None
    for config, models in CONFIG_MODELS.items():
        for name in models:
            if only and name not in only:
                continue
            data = ctr_data() if data is None else data
            for route in routes:
                runs = [run_port(data, name, sd, device, route) for sd in range(n_seeds)]
                cell = {"runs": runs, **band(runs, "auc"), **band(runs, "logloss")}
                out.setdefault(config, {}).setdefault(name, {})[route] = cell
                log(f"[parity] {config} / {name} / {route} ({runs[0]['route']}): auc "
                    f"{cell['auc_per_seed']} logloss {cell['logloss_per_seed']}, "
                    f"{[r['seconds'] for r in runs]} s")
    if ncf_seeds and (not only or "NCF_BPR" in only):
        ltr_data, _, _ = make_implicit_data()
        runs = [run_port_ncf_bpr(ltr_data, sd, device) for sd in range(ncf_seeds)]
        cell = {"runs": runs, **band(runs, "ndcg@10")}
        out["config5_ncf_bpr"] = {"NCF_BPR": {"default": cell}}
        log(f"[parity] config5_ncf_bpr / NCF_BPR / default ({runs[0]['route']}): ndcg@10 "
            f"{cell['ndcg@10_per_seed']}, {[r['seconds'] for r in runs]} s")
    return out


def jax_columns():
    """PARITY.json's rows: {config: {row: {"jax": ours, "reference": ...}}}."""
    with open(JAX_JSON) as f:
        rows = json.load(f)["configs"]
    return {config: {name: {"jax": row["ours"], "reference": row["reference"]}
                     for name, row in models.items()} for config, models in rows.items()}


def judged(columns):
    """Each route of one device's columns judged against the JAX column
    (and the reference's where :data:`BOTH_COLUMNS` says)."""
    ref = jax_columns()
    out = {}
    for config, models in columns.items():
        for name, by_route in models.items():
            for route, cell in by_route.items():
                want = ref[config][name]
                if config == "config5_ncf_bpr":
                    verdict = {"jax": judge_ndcg(cell, want["jax"])}
                else:
                    verdict = {"jax": judge_ctr(cell, want["jax"])}
                    if name in BOTH_COLUMNS:
                        verdict["reference"] = judge_ctr(cell, want["reference"])
                out.setdefault(config, {}).setdefault(name, {})[route] = verdict
    return out


def write(columns, device_key, card, seconds, out_path, base_path=OUT_JSON):
    """Merge ``device_key``'s columns into the JSON at ``base_path`` (or a
    fresh one) and write it to ``out_path``."""
    if os.path.exists(base_path):
        with open(base_path) as f:
            doc = json.load(f)
    else:
        doc = {"protocol": {
            "runner": "parity/run_parity_torch.py",
            "dataset": "make_synthetic_ctr (the port's, equal to the JAX package's arrays); "
                       "config 5: make_implicit_data (copied)",
            "rows": ROWS, "train_rows": TRAIN, "data_seed": DATA_SEED,
            "field_sizes": FIELD_SIZES, "num_dense": NUM_DENSE, "pair_scale": PAIR_SCALE,
            "embed_size": E, "epochs": EPOCHS, "lr": LR, "batch_size": BATCH,
            "optimizer": "Adam", "seeds": N_SEEDS, "ncf_seeds": NCF_SEEDS,
            "routes": {"default": "set_sparse_embeddings(None): the automatic choice",
                       "sparse": "set_sparse_embeddings(True), presort None"},
            "steps_per_execution": {"cuda": CARD_STEPS_PER_EXECUTION, "cpu": 1},
            "jax": "PARITY.json's 'ours' column (the JAX package)",
            "reference": "PARITY.json's 'reference' column (parity/torch_twin.py)",
            "rule": "within_band: |delta of AUC means| <= the larger of the two seed bands; "
                    "config 5: the NDCG ranges overlap"},
            "devices": {}, "configs": {}}
    doc["devices"][device_key] = {"card": card, "seconds": round(seconds, 1)}
    verdicts = judged(columns)
    ref = jax_columns()
    for config, models in columns.items():
        for name, by_route in models.items():
            row = doc["configs"].setdefault(config, {}).setdefault(name, {})
            row["jax"] = ref[config][name]["jax"]
            row["reference"] = ref[config][name]["reference"]
            row.setdefault("port", {})[device_key] = by_route
            row.setdefault("judged", {})[device_key] = verdicts[config][name]
    with open(out_path, "w") as f:
        json.dump(doc, f, indent=1)
    return doc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the port trains (default: the card)")
    ap.add_argument("--out", default=OUT_JSON, help="the JSON to write")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("run_parity_torch: no CUDA device (pass --device cpu for the CPU columns)",
                  file=sys.stderr)
            return 1
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    columns = run_protocol(args.device)
    base = args.out if os.path.exists(args.out) else OUT_JSON
    doc = write(columns, args.device, card_line(args.device), time.perf_counter() - t0,
                args.out, base)
    for config, models in columns.items():
        for name in models:
            print(json.dumps({"row": name, "judged": doc["configs"][config][name]["judged"][
                args.device]}))
    print("wrote", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
