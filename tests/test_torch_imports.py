"""The port stands alone: importing it (every module) and ``chip_smoke.py``,
and running its paths (sparse training on the presorted and the on-device
route, on both settings of ``TORECSYS_TPU_FUSED_DEDUP``, dense training,
evaluation, prediction; each model of the registry built and applied, and
xDeepFM, FFM over the field-aware table and NCF over two single-index
tables trained on both routes and checkpointed; FiBiNET, DeepFFM and
FAT-DeepFFM trained on both routes under AdamW, SGD and Adagrad, DeepFM
under each of the twelve optimizers and under an opaque factory; MMoE on a
two-task label and ESMM with a callable criterion trained on both routes
in bf16, ESM², DeepMoE and DeepMCP applied, PRM trained, PAL around FM through nested
inputs trained and predicting; DSIN over a behaviour list trained at 2 steps a
dispatch and evaluated, and DeepFM over both sequence inputs stacked with a
fused table trained on the sparse route and evaluated; the ``ltr`` objective (NCF
with BPR and the miner, a regularizer) fit and evaluated, eager and at 2
steps a dispatch, and StarSpace on ``emb``; and the CLI: streamed training
from the bundled Criteo sample with a checkpoint, a resumed run and
evaluation, which also parse, collate and load data, and ``build
--objective ltr``; DeepFM over a fused table stacked with an image tower
under a schedule and optax's other names at 2 steps a dispatch, the two
lookups, ``strip_aux``, ``not_jittable``, ``TqdmHandler``,
``use_torch_linear_init`` and both examples; the parity runner
``parity/run_parity_torch.py`` with its inputs and one row trained a step),
loads neither JAX (nor flax, optax) nor anything of the JAX package, nor
click or pandas."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, os, pkgutil, sys
import numpy as np
import torecsys_tpu_torch as pkg
import chip_smoke
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
for fused in ("0", "1"):
    os.environ["TORECSYS_TPU_FUSED_DEDUP"] = fused
    assert np.isfinite(float(Trainer(pipe, presort=False).train_steps([batch, batch])[-1]))
dense = Trainer(pipe.set_sparse_embeddings(False))
assert np.isfinite(dense.fit([batch, batch], val_loader=[batch])["val_logloss"])
assert dense.predict(batch).shape == (16, 1)
import tempfile
import torch
from torecsys_tpu_torch import inputs as I
from torecsys_tpu_torch.models import MODELS
cats = {"a": rng.integers(0, 50, 16), "b": rng.integers(0, 9, 16)}
schemas = {
    "xDeepFM": {"feat_inputs": I.ValueInput(("d",)),
                "emb_inputs": I.MultiIndicesEmbedding(4, (50, 9), ("a", "b"), device="cpu")},
    "FFM": {"feat_inputs": I.ValueInput(("d",)),
            "field_emb_inputs": I.MultiIndicesFieldAwareEmbedding(4, (50, 9), ("a", "b"),
                                                                  device="cpu")},
    "DCN": {"emb_inputs": I.MultiIndicesEmbedding(4, (50, 9), ("a", "b"), device="cpu")},
    "NCF": {"emb_inputs": I.StackedInput([I.SingleIndexEmbedding(50, 8, ("a",), device="cpu"),
                                          I.SingleIndexEmbedding(9, 8, ("b",), device="cpu")])},
}
for name, schema in schemas.items():
    for sparse in (True, False):
        pipe = Pipeline(device="cpu").set_inputs(I.Inputs(schema)).set_model(name)
        t = Trainer(pipe.set_sparse_embeddings(sparse), steps_per_execution=2)
        assert np.isfinite(float(t.train_steps([batch, batch])[-1]))
        with tempfile.TemporaryDirectory() as d:
            t.save_checkpoint(os.path.join(d, "c.pt"))
field_only = {"field_emb_inputs": schemas["FFM"]["field_emb_inputs"]}
for name, schema, opt in (("FiBiNET", schemas["DCN"], "AdamW"), ("DeepFFM", field_only, "SGD"),
                          ("FATDeepFFM", field_only, "Adagrad")):
    for sparse in (True, False):
        pipe = (Pipeline(device="cpu").set_inputs(I.Inputs(schema)).set_model(name)
                .set_optimizer(opt, lr=0.01).set_sparse_embeddings(sparse))
        t = Trainer(pipe, steps_per_execution=2)
        assert np.isfinite(float(t.train_steps([batch, batch])[-1]))
from torecsys_tpu_torch.train.optimizers import available_optimizers
for opt in sorted(available_optimizers()):
    pipe = (Pipeline(device="cpu").set_inputs(I.Inputs(schemas["xDeepFM"])).set_model("DeepFM")
            .set_optimizer(opt))
    t = Trainer(pipe)  # without a row twin: the dense route
    assert np.isfinite(float(t.train_steps([batch])[-1]))
t = Trainer(Pipeline(device="cpu").set_inputs(I.Inputs(schemas["xDeepFM"])).set_model("FM")
            .set_optimizer(lambda params: torch.optim.SGD(params, lr=0.1)))
assert np.isfinite(float(t.train_steps([batch])[-1])) and not t.sparse
for name in sorted(set(MODELS.values()), key=lambda c: c.__name__):
    if name.__name__ in ("FieldAwareFactorizationMachineModel", "LogisticRegressionModel",
                         "NeuralCollaborativeFilteringModel", "DeepAndCrossNetworkModel",
                         "StarSpaceModel", "LearningToRankWrapper",
                         "PersonalizedReRankingModel", "DeepFieldAwareFactorizationMachineModel",
                         "FieldAttentiveDeepFieldAwareFactorizationMachineModel",
                         "FeatureImportanceAndBilinearFeatureInteractionNetwork",
                         "MultiGateMixtureOfExpertsModel", "DeepMixtureOfExpertsModel",
                         "EntireSpaceMultiTaskModel",
                         "ElaboratedEntireSpaceSupervisedMultiTaskModel",
                         "DeepMatchingCorrelationPredictionModel",
                         "PositionBiasAwareLearningFrameworkModel"):
        continue  # other inputs or outputs (above, or in the steps after)
    if name.__name__ == "DeepSessionInterestNetworkModel":
        # DSIN over a behaviour list and the session index, trained (K = 2)
        # and evaluated; a DeepFM over both sequence inputs on the sparse route
        hist = {"h": rng.integers(0, 9, (16, 5)), "h_len": rng.integers(0, 6, 16),
                "s": rng.integers(0, 3, 16)}
        seq_batch = {**batch, **hist}

        class SessionIndex(I.BaseInput):
            fields = ("s",)

            def forward(self, batch):
                return batch["s"]

        import warnings
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            pipe = Pipeline(device="cpu").set_inputs(I.Inputs({
                "session_embed_inputs": I.ListIndicesEmbedding(9, 8, ("h",), output_method="none",
                                                               device="cpu"),
                "session_index": SessionIndex()})).set_model(
                "DSIN", max_num_session=3, max_num_position=5, extractor_num_heads=2,
                interacting_hidden_size=4)
        assert any(issubclass(w.category, FutureWarning) for w in caught)
        t = Trainer(pipe, steps_per_execution=2)
        assert np.isfinite(t.fit([seq_batch, seq_batch], val_loader=[seq_batch])["val_logloss"])
        emb = I.StackedInput([
            I.MultiIndicesEmbedding(8, (50, 9), ("a", "b"), device="cpu"),
            I.SequenceIndicesEmbedding(9, 8, ("h",), lengths_field="h_len", bidirectional=True,
                                       num_layers=2, device="cpu"),
            I.ListIndicesEmbedding(9, 8, ("h",), use_attn=True, num_heads=2, device="cpu")])
        pipe = (Pipeline(device="cpu").set_inputs(I.Inputs({"feat_inputs": I.ValueInput(("d",)),
                                                            "emb_inputs": emb}))
                .set_model("DeepFM", deep_layer_sizes=(8,)).set_sparse_embeddings(True))
        t = Trainer(pipe)
        assert np.isfinite(float(t.train_steps([seq_batch, seq_batch])[-1])) and t.sparse
        assert np.isfinite(t.evaluate([seq_batch])["val_auc"])
        continue
    if name.__name__ == "MatrixFactorizationModel":
        pipe = Pipeline(device="cpu").set_inputs(I.Inputs({"emb_inputs": schemas["DCN"][
            "emb_inputs"]})).set_model("MF")
        assert pipe.sequential({k: torch.as_tensor(v) for k, v in cats.items()}).shape == (16, 1)
        continue
    pipe = Pipeline(device="cpu").set_inputs(I.Inputs(schemas["xDeepFM"])).set_model(
        name.__name__, **({"attn_size": 4} if "Attentional" in name.__name__ else {}))
    assert pipe.sequential({k: torch.as_tensor(v) for k, v in batch.items()}).shape == (16, 1)
# the multi-task models: MMoE on a (B, 2) label on both routes at 2 steps a
# dispatch, ESMM with a callable criterion, ESM2 and DeepMCP applied
two_task = {**batch, "label": np.stack([batch["label"], batch["label"] * 0], axis=1)}
from torecsys_tpu_torch.losses import BCELoss
bce = BCELoss()
for name, kwargs, crit in (("MMoE", {"num_tasks": 2, "num_experts": 3}, "BCEWithLogitsLoss"),
                           ("ESMM", {"deep_layer_sizes": (8,)},
                            lambda p, y: bce(p[1], y[:, 0]) + bce(p[1] * p[0], y[:, 1]))):
    for sparse in (True, False):
        pipe = (Pipeline(device="cpu").set_inputs(I.Inputs(schemas["DCN"]))
                .set_model(name, **kwargs).set_criterion(crit).set_sparse_embeddings(sparse)
                .set_compute_dtype("bfloat16"))
        t = Trainer(pipe, presort=False, steps_per_execution=2)
        assert np.isfinite(float(t.train_steps([two_task, two_task])[-1]))
pipe = Pipeline(device="cpu").set_inputs(I.Inputs(schemas["DCN"])).set_model("ESM2")
assert len(pipe.sequential({k: torch.as_tensor(v) for k, v in cats.items()})) == 3
pipe = Pipeline(device="cpu").set_inputs(I.Inputs(schemas["DCN"])).set_model("DeepMoE",
                                                                             num_moe_layers=2)
assert pipe.sequential({k: torch.as_tensor(v) for k, v in cats.items()}).shape == (16, 1)
items = I.SingleIndexEmbedding(9, 8, ("b",), device="cpu")
pipe = Pipeline(device="cpu").set_inputs(I.Inputs({
    "user_emb_inputs": I.SingleIndexEmbedding(50, 8, ("a",), device="cpu"),
    "content_emb_inputs": items, "pos_emb_inputs": items, "neg_emb_inputs": items})).set_model(
    "DeepMCP")
assert len(pipe.sequential({k: torch.as_tensor(v) for k, v in cats.items()})) == 4
# PRM on per-position labels, and PAL around FM through nested inputs
lists = {f"p{i}": rng.integers(0, 50, 16) for i in range(5)}
lists["label"] = (rng.uniform(size=(16, 5)) < 0.3).astype(np.float32)
pipe = (Pipeline(device="cpu").set_inputs(I.Inputs({"feat_inputs": I.SingleIndexEmbedding(
    50, 8, tuple(f"p{i}" for i in range(5)), device="cpu")})).set_model("PRM")
        .set_criterion("BCELoss"))
assert np.isfinite(float(Trainer(pipe, steps_per_execution=2).train_steps([lists, lists])[-1]))


class PositionInput(I.BaseInput):
    fields = ("b",)

    def forward(self, batch):
        return batch["b"]


pipe = Pipeline(device="cpu").set_inputs(I.Inputs({"pctr_inputs": I.Inputs(schemas["xDeepFM"]),
                                                   "pos_inputs": PositionInput()}))
pipe.set_model(MODELS["PAL"].from_inputs(pipe.inputs, "FM", max_num_position=9, device="cpu"))
t = Trainer(pipe)
assert np.isfinite(float(t.train_steps([batch])[-1])) and t.predict(batch).shape == (16, 1)
ranking = {"u": rng.integers(0, 50, 16), "i": rng.integers(0, 9, 16),
           "label": np.ones(16, np.float32)}
for spe in (1, 2):
    pipe = (Pipeline(device="cpu").set_objective("ltr")
            .set_inputs(I.Inputs({"emb_inputs": I.MultiIndicesEmbedding(8, (50, 9), ("u", "i"),
                                                                         device="cpu")}))
            .set_model("NCF", deep_layer_sizes=(8,)).set_criterion("BayesianPersonalizedRankingLoss")
            .set_miner("UniformBatchMiner", num_negs=4).set_miner_target_field("i")
            .set_regularizer(weight_decay=0.01))
    t = Trainer(pipe, steps_per_execution=spe)
    assert 0.0 < t.fit([ranking, ranking], val_loader=[ranking])["val_ndcg@10"] <= 1.0
    assert not t.sparse
pipe = (Pipeline(device="cpu").set_objective("emb")
        .set_inputs(I.Inputs({"context_inputs": I.SingleIndexEmbedding(50, 8, ("u",), device="cpu"),
                              "target_inputs": I.SingleIndexEmbedding(9, 8, ("i",), device="cpu")}))
        .set_model("StarSpace", num_neg=3).set_miner("UniformBatchMiner", num_negs=3)
        .set_miner_target_field("i"))
assert np.isfinite(float(Trainer(pipe).train_steps([ranking])[-1]))
from torecsys_tpu_torch.cli import main
assert main(["build", "--device", "cpu", "--objective", "ltr", "--model_config",
             '{"method": "MF"}', "--inputs_config",
             '{"emb_inputs": {"method": "MultiIndicesEmbedding", "embed_size": 4, '
             '"field_sizes": [50, 9], "fields": ["u", "i"]}}', "--miner_target_field", "i"]) == 0
from torecsys_tpu_torch.data import CollateFunction, DataLoader, FieldSpec, NdarrayToDataset
from torecsys_tpu_torch.data.sample_data import load_criteo_data
sample = os.path.join("torecsys_tpu", "data", "sample", "criteo_sample.tsv")
with tempfile.TemporaryDirectory() as ckpts:
    train = ["train", "--device", "cpu", "--model_config", '{"method": "FM"}', "--train_file",
             sample, "--stream", "on", "--batch_size", "512", "--embed_size", "4",
             "--criteo_hash_size", "500", "--max_num_iterations", "2", "--checkpoint_dir", ckpts]
    assert main(train) == 0 and main(train) == 0
    assert main(["evaluate", "--device", "cpu", "--model_config", '{"method": "FM"}',
                 "--load_from", os.path.join(ckpts, "ckpt_4.pt"), "--eval_file", sample,
                 "--stream", "on", "--batch_size", "512", "--embed_size", "4",
                 "--criteo_hash_size", "500"]) == 0
assert len(load_criteo_data(sample, nrows=5)["C1"]) == 5
loader = DataLoader(NdarrayToDataset(np.arange(12).reshape(6, 2), ["a", "b"]), 3,
                    CollateFunction({"a": FieldSpec("values"), "b": FieldSpec("indices")}))
assert len(list(loader)) == 2
from torecsys_tpu_torch.train import schedules
from torecsys_tpu_torch.ops.embedding import embedding_lookup, fused_offset_lookup
from torecsys_tpu_torch.data.presort import strip_aux
from torecsys_tpu_torch.utils.decorator import not_jittable
from torecsys_tpu_torch.utils.logging import TqdmHandler
from torecsys_tpu_torch.layers.precision import use_torch_linear_init
image_batch = dict(batch, img=rng.integers(0, 256, (16, 8, 8, 3)).astype(np.uint8))
for name, lr in (("Adam", schedules.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 8)),
                 ("adabelief", 1e-3), ("noisy_sgd", schedules.exponential_decay(1e-2, 2, 0.5))):
    with use_torch_linear_init():
        pipe = (Pipeline(device="cpu").set_inputs(I.Inputs({
            "feat_inputs": I.ValueInput(("d",)),
            "emb_inputs": I.StackedInput([
                I.MultiIndicesEmbedding(4, (50, 9), ("a", "b"), device="cpu"),
                I.ImageInput(4, 3, layers_size=(2, 3), fields=("img",), device="cpu")])}))
            .set_model("DeepFM", deep_layer_sizes=(8,)).set_optimizer(name, lr=lr)
            .set_sparse_embeddings(False))
        t = Trainer(pipe, steps_per_execution=2)
        assert np.isfinite(float(t.train_steps([image_batch] * 2)[-1]))
table = torch.randn(9, 4)
assert embedding_lookup(table, torch.tensor([[1, -1]])).shape == (1, 2, 4)
assert fused_offset_lookup(table, torch.tensor([[1, 2]]), np.array([0, 5])).shape == (1, 2, 4)
assert strip_aux({"__presort__x": 1, "a": 2}) == {"a": 2}
assert not_jittable(lambda: 3)() == 3
from torecsys_tpu_torch.examples import ltr_with_miner, train_fm_sample
assert 0.0 < train_fm_sample.cli(["--device", "cpu", "--epochs", "1"]) <= 1.0
assert 0.0 < ltr_with_miner.cli(["--device", "cpu", "--epochs", "1"]) <= 1.0
from parity import run_parity_torch
for kind in ("feat_only", "feat_emb", "emb_only", "feat_fieldemb"):
    assert run_parity_torch.build_schema(kind, "cpu")
implicit, _, _ = run_parity_torch.make_implicit_data()
pipe = (Pipeline(device="cpu").set_inputs(Inputs(run_parity_torch.build_schema("feat_emb", "cpu")))
        .set_model("FM"))
row = {k: v[:64] for k, v in run_parity_torch.ctr_data().items()}
assert np.isfinite(float(Trainer(pipe).train_steps([row])[-1]))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "torecsys_tpu", "click",
                                    "pandas"))
print("LOADED", bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "LOADED []" in proc.stdout


PARALLEL_SCRIPT = r"""
import os, sys, tempfile
sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
import numpy as np
import torch
import test_torch_parallel_ranks
from torecsys_tpu_torch import parallel
from torecsys_tpu_torch.parallel import lookup, mesh, sharding
from torecsys_tpu_torch.examples import sharded_lookup
from torecsys_tpu_torch.ops.sparse import sharded_row_update
from torecsys_tpu_torch.train.trainer import LookupOverflowSuspected
from torecsys_tpu_torch.parallel.mesh import initialize_distributed
tmp = tempfile.mkdtemp()
initialize_distributed(init_method=f"file://{tmp}/init", world_size=1, rank=0, backend="gloo",
                       device_type="cpu")
m = parallel.make_mesh(1, 1, device_type="cpu")
t = torch.randn(100, 16)
ids = torch.randint(0, 100, (4, 3))
for strategy in ("psum", "alltoall"):
    with parallel.use_sharded_lookup(m, strategy=strategy, min_rows_to_shard=0):
        assert torch.equal(parallel.maybe_sharded_lookup(t, ids), t[ids])
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "torecsys_tpu", "click",
                                    "pandas"))
print("LOADED", bad)
sys.exit(1 if bad else 0)
"""


def test_parallel_modules_and_rank_code_import_no_jax():
    """The parallel package, the sharded update, the example twin and the
    parallel tests' rank code (``tests/test_torch_parallel_ranks.py``), in
    a fresh process that also looks a table up in a one-rank gloo world,
    load neither JAX nor anything of the JAX package."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", PARALLEL_SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "LOADED []" in proc.stdout
