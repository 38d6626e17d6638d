"""The port's CLI (``torecsys_tpu_torch/cli``) on the CPU (``--device cpu``),
mirroring ``tests/test_e2e_criteo.py``: the parsed column dict equals the
JAX ``_load_table``'s (Criteo TSV and CSV); ``FM`` trained through
``main(["train", ...])`` on the bundled sample learns (``val_auc > 0.6``);
train → checkpoint → auto-resume → evaluate; streaming; xDeepFM (its
running statistics in the checkpoint) trained and evaluated on the bundled
sample; every input class from JSON, containers included; the refusals (a
CSV with ``--stream on``, mesh options, unported inputs, objectives,
regularizers and miners); ``build`` and ``version``."""

import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from torecsys_tpu.cli import _load_table as jax_load_table
from torecsys_tpu_torch.cli import UsageError, _build_inputs, _load_table, main, run
from torecsys_tpu_torch.train import Pipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARD = os.path.join(REPO, "torecsys_tpu", "data", "sample", "criteo_sample.tsv")


def _same_columns(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert np.array_equal(np.ascontiguousarray(got[k]).view(np.uint8),
                              np.ascontiguousarray(want[k]).view(np.uint8)), k


@pytest.mark.parametrize("target", ["label", "click"])
def test_criteo_columns_equal_the_jax_load_table(target):
    got = _load_table(SHARD, "criteo", target, criteo_hash_size=2000)
    _same_columns(got, jax_load_table(SHARD, "criteo", target, criteo_hash_size=2000))
    assert len(got[target]) == 4096


def _toy_csv(path, n=2048):
    rng = np.random.default_rng(0)
    cat = rng.integers(0, 50, n).astype(np.int32)
    dense = rng.normal(size=n).astype(np.float32)
    label = ((cat % 7 == 0) | (dense > 1.0)).astype(np.float32)
    pd.DataFrame({"user": cat, "score": dense, "label": label}).to_csv(path, index=False)
    return path


def test_csv_columns_equal_the_jax_load_table(tmp_path):
    path = _toy_csv(str(tmp_path / "toy.csv"))
    _same_columns(_load_table(path, "auto", "label", 100),
                  jax_load_table(path, "auto", "label", 100))
    with pytest.raises(UsageError, match="not in CSV columns"):
        _load_table(path, "csv", "clicked", 100)


def _metrics(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_fm_trained_through_main_learns(capsys):
    assert main(["train", "--device", "cpu", "--model_config", '{"method": "FM"}',
                 "--train_file", SHARD, "--batch_size", "256", "--embed_size", "8",
                 "--criteo_hash_size", "2000", "--max_num_epochs", "6",
                 "--optimizer_config", '{"method": "Adam", "lr": 0.01}']) == 0
    metrics = _metrics(capsys)
    assert metrics["epoch"] == 5 and metrics["val_auc"] > 0.6, metrics


COMMON = ["--device", "cpu", "--model_config", '{"method": "FM"}', "--train_file", SHARD,
          "--batch_size", "512", "--embed_size", "4", "--criteo_hash_size", "500",
          "--max_num_iterations", "4"]


@pytest.mark.parametrize("stream", ["off", "on"])
def test_train_checkpoint_resume_evaluate(tmp_path, capsys, stream):
    ckpt_dir = str(tmp_path / "ckpts")
    argv = ["train", *COMMON, "--checkpoint_dir", ckpt_dir, "--stream", stream,
            "--stream_chunk_mb", "1", "--steps_per_execution", "2"]
    assert main(argv) == 0
    assert os.listdir(ckpt_dir) == ["ckpt_4.pt"]
    trainer = run(argv)  # auto-resumes: the step counter goes on from 4
    assert int(trainer.state.step) == 8
    assert sorted(os.listdir(ckpt_dir)) == ["ckpt_4.pt", "ckpt_8.pt"]
    capsys.readouterr()
    assert main(["evaluate", "--device", "cpu", "--model_config", '{"method": "FM"}',
                 "--load_from", os.path.join(ckpt_dir, "ckpt_8.pt"), "--eval_file", SHARD,
                 "--batch_size", "512", "--embed_size", "4", "--criteo_hash_size", "500",
                 "--stream", stream]) == 0
    metrics = _metrics(capsys)
    assert 0.0 <= metrics["val_auc"] <= 1.0 and np.isfinite(metrics["val_logloss"])
    # --no-resume starts afresh; --load_from restores an explicit checkpoint
    assert int(run([*argv, "--no-resume"]).state.step) == 4
    assert int(run([*argv, "--no-resume", "--load_from",
                    os.path.join(ckpt_dir, "ckpt_4.pt")]).state.step) == 8


def test_csv_train_file_and_synthetic_data(tmp_path, capsys):
    path = _toy_csv(str(tmp_path / "toy.csv"))
    assert main(["train", "--device", "cpu", "--model_config", '{"method": "FM"}',
                 "--train_file", path, "--batch_size", "256", "--embed_size", "4",
                 "--max_num_iterations", "4"]) == 0
    assert np.isfinite(_metrics(capsys)["train_loss"])
    trainer = run(["train", "--device", "cpu", "--model_config",
                   '{"method": "DeepFM", "deep_layer_sizes": [8]}', "--num_rows", "3000",
                   "--batch_size", "256", "--max_num_iterations", "3", "--no_presort",
                   "--prefetch", "0"])
    assert trainer.presort is False and trainer.prefetch == 0 and int(trainer.state.step) == 3


def test_stream_on_rejects_a_csv(tmp_path, capsys):
    path = str(tmp_path / "t.csv")
    pd.DataFrame({"a": [1, 2], "label": [0.0, 1.0]}).to_csv(path, index=False)
    assert main(["train", "--device", "cpu", "--model_config", '{"method": "FM"}',
                 "--train_file", path, "--stream", "on"]) == 2
    assert "criteo" in capsys.readouterr().err


def test_a_missing_file_is_a_usage_error(capsys):
    with pytest.raises(SystemExit) as e:
        main(["train", "--model_config", '{"method": "FM"}', "--train_file", SHARD + ".nope"])
    assert e.value.code == 2 and "does not exist" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [["--data_parallel", "2"], ["--table_parallel", "4"],
                                   ["--lookup_strategy", "psum"], ["--capacity_factor", "4"],
                                   ["--min_rows_to_shard", "10"]])
def test_mesh_options_beyond_one_device_are_refused(flags):
    """Meshes are ported (``test_torch_parallel_ckpt`` runs the CLI's in a
    gloo world): in one process, with no process group, a mesh of more than
    one rank is refused as ``make_mesh`` refuses it (the JAX CLI's
    ``ValueError`` when the devices are short), and the lookup options
    alone are taken, as the JAX CLI takes them, and kept for a mesh."""
    if flags[0] in ("--data_parallel", "--table_parallel"):
        with pytest.raises(ValueError, match=f"needs {flags[1]} devices, have 1"):
            run(["train", *COMMON, *flags])
        return
    trainer = run(["train", *COMMON, *flags])
    key, kind = {"--lookup_strategy": ("strategy", str),
                 "--capacity_factor": ("capacity_factor", float),
                 "--min_rows_to_shard": ("min_rows_to_shard", int)}[flags[0]]
    assert trainer.lookup_options[key] == kind(flags[1])
    assert trainer.mesh is None and int(trainer.state.step) == 4


def test_single_device_mesh_options_run():
    trainer = run(["train", *COMMON, "--data_parallel", "1", "--table_parallel", "1",
                   "--lookup_strategy", "auto", "--capacity_factor", "2.0"])
    assert int(trainer.state.step) == 4


def test_unported_inputs_objectives_regularizers_and_miners_are_refused():
    """Every input of the JAX package is ported: the image inputs build from
    JSON as the JAX CLI builds them, also inside a container
    (``test_torch_image.test_cli_builds_the_image_inputs`` holds them against
    the JAX CLI's), and a name that is no input class raises
    ``AttributeError`` in both CLIs.  The sequence inputs are ported
    (``test_torch_dsin.test_cli_builds_both_sequence_inputs_from_json``),
    the objectives, the regularizer and the miner
    (``test_build_takes_the_ranking_objectives_miner_and_regularizer``), and
    PRM (``test_prm_builds_as_the_jax_package_builds_it``)."""
    from torecsys_tpu.cli import _build_inputs as jax_build_inputs
    from torecsys_tpu_torch.inputs import ImageInput, StackedInput

    image = _build_inputs({"emb_inputs": {"method": "ImageInput", "embed_size": 4,
                                          "in_channels": 3, "layers_size": [2, 3]}}, "cpu")
    assert isinstance(image.schema["emb_inputs"], ImageInput)
    stacked = _build_inputs({"emb_inputs": {"method": "StackedInput", "inputs": [
        {"method": "SequenceIndicesEmbedding", "embed_size": 4, "field_size": 9,
         "fields": ["a"]},
        {"method": "ImageInput", "embed_size": 4, "in_channels": 3}]}}, "cpu")
    assert isinstance(stacked.schema["emb_inputs"], StackedInput)
    for build in (_build_inputs, jax_build_inputs):
        with pytest.raises(AttributeError):
            build({"emb_inputs": {"method": "NoSuchInput", "embed_size": 4}},
                  *(("cpu",) if build is _build_inputs else ()))


def _outcome(build):
    """``("built", model class name)`` or ``("raised", error type name)``."""
    try:
        return "built", type(build().model).__name__
    except Exception as e:  # noqa: BLE001 - the outcome is compared, whatever it is
        return "raised", type(e).__name__


@pytest.mark.parametrize("inputs,model", [
    # no embed_size: the JAX PRM requires it, and the port's reads it only
    # off a feat_inputs, which these inputs do not give
    ({"emb_inputs": {"method": "MultiIndicesEmbedding", "embed_size": 4,
                     "field_sizes": [10, 20], "fields": ["u", "i"]}},
     {"method": "PRM", "max_num_position": 5}),
    ({"feat_inputs": {"method": "SingleIndexEmbedding", "embed_size": 4, "field_size": 30,
                      "fields": ["p0", "p1", "p2", "p3", "p4"]}},
     {"method": "PRM", "embed_size": 4, "max_num_position": 5, "encoding_size": 8}),
])
def test_prm_builds_as_the_jax_package_builds_it(inputs, model):
    """``Pipeline.build`` of an ``ltr`` PRM config: the port's outcome is the
    JAX package's (a ``TypeError`` without ``embed_size``; else the model)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from torecsys_tpu import inputs as J
    from torecsys_tpu.train import Pipeline as JaxPipeline

    def jax_inputs():
        schema = {}
        for name, spec in inputs.items():
            spec = {k: tuple(v) if isinstance(v, list) else v for k, v in spec.items()}
            schema[name] = getattr(J, spec.pop("method"))(**spec)
        return J.Inputs(schema=schema)

    def config(port):
        return dict(objective="ltr", model_config=model, miner_target_field="p0",
                    inputs_config=_build_inputs(inputs, "cpu") if port else jax_inputs())

    want = _outcome(lambda: JaxPipeline.build(**config(False)))
    got = _outcome(lambda: Pipeline.build(device="cpu", **config(True)))
    assert got == want, (got, want)


def test_build_takes_the_ranking_objectives_miner_and_regularizer(capsys):
    inputs = json.dumps({"emb_inputs": {"method": "MultiIndicesEmbedding", "embed_size": 4,
                                        "field_sizes": [10, 20], "fields": ["u", "i"]}})
    pipe = run(["build", "--device", "cpu", "--objective", "ltr", "--model_config",
                '{"method": "NCF", "deep_layer_sizes": [8]}', "--inputs_config", inputs,
                "--criterion_config", '{"method": "BayesianPersonalizedRankingLoss"}',
                "--miner_config", '{"method": "UniformBatchMiner", "num_negs": 4}',
                "--miner_target_field", "i", "--regularizer_config",
                '{"weight_decay": 0.01, "key_filter": "kernel"}'])
    out = capsys.readouterr().out
    assert "ltr" in out and "UniformBatchMiner" in out and "key_filter='kernel'" in out
    assert pipe.objective == "ltr" and pipe.num_negs == 4 and pipe.miner_target_field == "i"
    assert pipe.regularizer.weight_decay == 0.01
    pipe = run(["build", "--device", "cpu", "--objective", "emb", "--model_config",
                '{"method": "MF"}', "--inputs_config", inputs, "--miner_target_field", "i"])
    assert pipe.objective == "emb" and type(pipe.model).__name__ == "MatrixFactorizationModel"


def test_build_and_version(capsys):
    inputs = json.dumps({
        "feat_inputs": {"method": "ValueInput", "fields": ["d0", "d1"]},
        "emb_inputs": {"method": "MultiIndicesEmbedding", "embed_size": 4,
                       "field_sizes": [10, 20], "fields": ["c0", "c1"]}})
    pipe = run(["build", "--device", "cpu", "--model_config",
                '{"method": "DeepFM", "deep_layer_sizes": [8]}', "--inputs_config", inputs,
                "--optimizer_config", '{"method": "Adam", "lr": 0.01}'])
    out = capsys.readouterr().out
    assert "DeepFactorizationMachineModel" in out and "cpu" in out
    assert pipe.sequential is not None and pipe.inputs.schema["emb_inputs"].field_sizes == (10, 20)
    assert main(["build", "--device", "cpu", "--model_config", '{"method": "LR"}']) == 0
    assert "LogisticRegressionModel" in capsys.readouterr().out
    import torecsys_tpu_torch

    assert main(["version"]) == 0
    assert capsys.readouterr().out.strip() == torecsys_tpu_torch.__version__


def test_module_entry_point_runs():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-m", "torecsys_tpu_torch.cli", "version"], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "0.1.0", proc.stderr[-2000:]


def test_xdeepfm_trains_and_evaluates_through_the_cli(tmp_path, capsys):
    """xDeepFM with the JAX CLI's default inputs (13 dense values, one fused
    26-field table) on the bundled sample: train with a checkpoint, then
    evaluate it, the CIN's running statistics restored."""
    model = json.dumps({"method": "xDeepFM", "embed_size": 4, "num_fields": 26,
                        "cin_layer_sizes": [8, 8], "deep_layer_sizes": [16]})
    ckpt_dir = str(tmp_path / "ckpts")
    trainer = run(["train", "--device", "cpu", "--model_config", model, "--train_file", SHARD,
                   "--batch_size", "256", "--embed_size", "4", "--criteo_hash_size", "500",
                   "--max_num_epochs", "2", "--checkpoint_dir", ckpt_dir,
                   "--steps_per_execution", "2"])
    metrics = trainer.history[-1]
    assert np.isfinite(metrics["train_loss"]) and 0.0 <= metrics["val_auc"] <= 1.0
    assert trainer.history[-1]["train_loss"] < trainer.history[0]["train_loss"]
    seq = trainer.pipeline.sequential
    assert type(seq.model).__name__ == "XDeepFactorizationMachineModel"
    (ckpt,) = sorted(os.listdir(ckpt_dir))[-1:]
    capsys.readouterr()
    assert main(["evaluate", "--device", "cpu", "--model_config", model, "--load_from",
                 os.path.join(ckpt_dir, ckpt), "--eval_file", SHARD, "--batch_size", "256",
                 "--embed_size", "4", "--criteo_hash_size", "500"]) == 0
    got = _metrics(capsys)
    assert 0.0 <= got["val_auc"] <= 1.0 and np.isfinite(got["val_logloss"])


def test_every_input_class_builds_from_json():
    inputs = _build_inputs({
        "feat_inputs": {"method": "ValueInput", "fields": ["d"]},
        "field_emb_inputs": {"method": "MultiIndicesFieldAwareEmbedding", "embed_size": 4,
                             "field_sizes": [10, 20], "fields": ["a", "b"]},
        "emb_inputs": {"method": "StackedInput", "inputs": [
            {"method": "SingleIndexEmbedding", "field_size": 10, "embed_size": 8,
             "fields": ["a"], "pretrained": np.ones((10, 8)).tolist()},
            {"method": "SingleIndexEmbedding", "field_size": 20, "embed_size": 8,
             "fields": ["b"]}]},
        "wide": {"method": "ConcatInput", "inputs": [
            {"method": "MultiIndicesEmbedding", "embed_size": 4, "field_sizes": [10, 20],
             "fields": ["a", "b"]}, {"method": "ValueInput", "fields": ["d"]}]},
    }, "cpu")
    assert inputs.schema["emb_inputs"].output_shape() == (2, 8)
    assert float(inputs.schema["emb_inputs"][0].embedding.detach().sum()) == 80.0
    assert inputs.schema["wide"].output_shape() == (1, 9)
    assert inputs.schema["field_emb_inputs"].output_shape() == (4, 4)
    pipe = Pipeline.build(device="cpu", inputs_config=inputs,
                          model_config={"method": "FFM", "num_fields": 2})
    assert type(pipe.model).__name__ == "FieldAwareFactorizationMachineModel"
