"""Command-line interface of the port (counterpart of
``torecsys_tpu/cli/__init__.py``), on ``argparse``:

* ``version``  — the package version;
* ``build``    — assemble a pipeline from JSON configs and print its summary;
* ``train``    — ``Trainer.fit`` on synthetic CTR data or a file
  (``--train_file``): a headered CSV, or a Criteo DAC 39-column TSV parsed
  by the C++ parser, whole or (``--stream``) in line-aligned chunks.  It
  honours ``--load_from`` and auto-resumes from ``--checkpoint_dir``;
* ``evaluate`` — restore a checkpoint and print AUC and logloss on a file or
  the synthetic holdout.

The options are the JAX package's, with its names and defaults, and one
more: ``--device`` (default: the card; ``cpu`` runs on the CPU), since the
port's entry points take a device.

The mesh options, as the JAX CLI's: ``--data_parallel`` and
``--table_parallel`` size a ``(data, table)`` mesh of ranks
(``parallel.make_mesh``; both 1, the default, is one device);
``--lookup_strategy`` picks the sharded lookup's collective (``auto``: the
calibrated byte model of ``parallel.lookup``), ``--capacity_factor`` sizes
the all-to-all's buckets (worst-case-safe is ``--table_parallel``), and
``--min_rows_to_shard`` is the stored rows under which a table replicates
instead of row-sharding (default ``parallel.sharding``'s 65536).  A mesh
runs one process a rank, under ``torchrun`` (which sets the process group's
environment; NCCL on the cards, gloo with ``--device cpu``); every rank
reads the same data and keeps its slice, and only rank 0 prints the
pipeline and the JSON metrics lines.

Run: ``python -m torecsys_tpu_torch.cli train --model_config '{"method": "FM"}'
--train_file data.tsv`` (or the ``torecsys-tpu-torch`` console script);
on four cards ``torchrun --nproc_per_node 4 -m torecsys_tpu_torch.cli train
--data_parallel 2 --table_parallel 2 ...``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import Dict, List, Optional

import numpy as np

import torecsys_tpu_torch

Columns = Dict[str, np.ndarray]

class UsageError(Exception):
    """A command-line mistake: ``main`` prints it and returns 2."""


def _parse(cfg: Optional[str]):
    return json.loads(cfg) if cfg else None


def _build_input(spec: dict, device=None):
    """One ``{"method": <class>, ...kwargs}`` input spec → an input module,
    the class looked up by name in the port's ``inputs`` as the JAX CLI looks
    it up in its own (an unknown name raises ``AttributeError`` there and
    here); a container's ``inputs`` is a list of such specs."""
    from torecsys_tpu_torch import inputs as inputs_mod

    spec = dict(spec)
    method = spec.pop("method")
    cls = getattr(inputs_mod, method)
    if method in ("ConcatInput", "StackedInput"):
        return cls([_build_input(child, device) for child in spec.pop("inputs")], **spec)
    for key in ("fields", "field_sizes", "layers_size", "kernel_sizes", "strides",
                "pooling_sizes"):
        if key in spec and isinstance(spec[key], list):
            spec[key] = tuple(spec[key])
    if spec.get("pretrained") is not None:
        spec["pretrained"] = np.asarray(spec["pretrained"], dtype=np.float32)
    if method != "ValueInput":
        spec.setdefault("device", device)
    return cls(**spec)


def _build_inputs(cfg: dict, device=None):
    """JSON → ``Inputs``: ``{arg_name: {"method": <class>, ...kwargs}}``, the
    port's input classes: ``ValueInput``, ``SingleIndexEmbedding``,
    ``MultiIndicesEmbedding``, ``MultiIndicesFieldAwareEmbedding``, the
    list and sequence inputs ``ListIndicesEmbedding`` and
    ``SequenceIndicesEmbedding``, the image inputs ``ImageInput`` and
    ``PretrainedImageInput`` (with ``weights_path``), and the containers
    ``ConcatInput`` and ``StackedInput``, whose ``inputs`` is a list of such
    specs."""
    from torecsys_tpu_torch import inputs as inputs_mod

    return inputs_mod.Inputs({arg_name: _build_input(spec, device)
                              for arg_name, spec in cfg.items()})


def _data_format(path: str, data_format: str) -> str:
    if data_format == "auto":
        return "criteo" if str(path).endswith((".tsv", ".txt")) else "csv"
    return data_format


def _load_table(path: str, data_format: str, target_fields: str,
                criteo_hash_size: int) -> Columns:
    """File → column dict ``{name: np.ndarray}`` with CTR-ready columns.

    ``criteo``: the 39-column DAC TSV through the C++ parser (hashed cats,
    log1p dense), expanded to ``cat_{i}`` / ``dense_{j}`` / ``label``
    columns.  ``csv``: a headered CSV; integer columns (but the target) are
    categorical (int32), the others dense (float32).
    """
    data_format = _data_format(path, data_format)
    if data_format == "criteo":
        from torecsys_tpu_torch.data import load_criteo_batches
        from torecsys_tpu_torch.data.native import NUM_CATS

        arrays = load_criteo_batches(path, hash_sizes=(criteo_hash_size,) * NUM_CATS)
        out = {"label": arrays["label"]}
        for j in range(arrays["dense"].shape[1]):
            out[f"dense_{j}"] = arrays["dense"][:, j]
        for i in range(arrays["cats"].shape[1]):
            out[f"cat_{i}"] = arrays["cats"][:, i]
        if target_fields != "label":
            out[target_fields] = out.pop("label")
        return out
    if data_format == "csv":
        from torecsys_tpu_torch.data.sample_data import read_table

        table = read_table(path)
        if target_fields not in table:
            raise UsageError(f"--target_fields {target_fields!r} not in CSV columns "
                             f"{list(table)}")
        out = {}
        for col, v in table.items():
            if col == target_fields:
                out[col] = v.astype(np.float32)
            elif np.issubdtype(v.dtype, np.integer):
                out[col] = v.astype(np.int32)
            else:
                out[col] = v.astype(np.float32)
        return out
    raise UsageError(f"unknown --data_format {data_format!r}")


def _default_inputs(data: Columns, target_fields: str, embed_size: int, device=None):
    """The default schema of a column dict: int columns → one fused
    ``MultiIndicesEmbedding``, float columns → ``ValueInput``."""
    from torecsys_tpu_torch.inputs import Inputs, MultiIndicesEmbedding, ValueInput

    cat_fields = tuple(sorted(k for k, v in data.items()
                              if k != target_fields and np.issubdtype(v.dtype, np.integer)))
    dense_fields = tuple(sorted(k for k, v in data.items()
                                if k != target_fields and not np.issubdtype(v.dtype, np.integer)))
    field_sizes = tuple(int(data[f].max()) + 1 for f in cat_fields)
    schema = {}
    if dense_fields:
        schema["feat_inputs"] = ValueInput(fields=dense_fields)
    if cat_fields:
        schema["emb_inputs"] = MultiIndicesEmbedding(embed_size, field_sizes, cat_fields,
                                                     device=device)
    return Inputs(schema)


def _batch_loader(data: Columns, lo: int, hi: int, batch_size: int, shuffle: bool,
                  seed: int = 0):
    idx = np.arange(lo, hi)

    def gen():
        order = np.random.default_rng(seed).permutation(idx) if shuffle else idx
        stop = len(order) - (len(order) % batch_size)
        for s in range(0, stop, batch_size):
            sel = order[s:s + batch_size]
            yield {k: v[sel] for k, v in data.items()}

    return gen


def _should_stream(path, data_format: str, stream: str, threshold_mb: int) -> bool:
    """Streaming applies to Criteo TSVs: forced by ``--stream on``, or in
    ``auto`` mode when the file exceeds the size threshold."""
    if _data_format(path, data_format) != "criteo":
        if stream == "on":
            raise UsageError("--stream=on requires a criteo-format file")
        return False
    if stream == "off":
        return False
    if stream == "on":
        return True
    from torecsys_tpu_torch.data.streaming import file_larger_than

    return file_larger_than(path, threshold_mb << 20)


def _streaming_loader(path, criteo_hash_size: int, target_fields: str, batch_size: int,
                      chunk_mb: int, shuffle: bool):
    from torecsys_tpu_torch.data.native import NUM_CATS
    from torecsys_tpu_torch.data.streaming import CriteoFileIterable

    return CriteoFileIterable(path, hash_sizes=(criteo_hash_size,) * NUM_CATS,
                              batch_size=batch_size, chunk_bytes=chunk_mb << 20,
                              shuffle=shuffle, target_fields=target_fields)


def _criteo_schema_inputs(criteo_hash_size: int, embed_size: int, device=None):
    """The Criteo schema without reading data: 13 dense values and one fused
    26-field ``MultiIndicesEmbedding`` of the hash sizes."""
    from torecsys_tpu_torch.data.native import NUM_CATS, NUM_DENSE
    from torecsys_tpu_torch.inputs import Inputs, MultiIndicesEmbedding, ValueInput

    return Inputs({
        "feat_inputs": ValueInput(fields=tuple(f"dense_{j}" for j in range(NUM_DENSE))),
        "emb_inputs": MultiIndicesEmbedding(embed_size, (criteo_hash_size,) * NUM_CATS,
                                            tuple(f"cat_{i}" for i in range(NUM_CATS)),
                                            device=device),
    })


def _make_mesh(args):
    """The ``(data, table)`` mesh of ``--data_parallel``/``--table_parallel``
    (None for one device), with the process group brought up from the
    launcher's environment first."""
    if args.data_parallel <= 1 and args.table_parallel <= 1:
        return None
    from torecsys_tpu_torch.parallel.mesh import initialize_distributed, make_mesh

    device_type = "cpu" if args.device == "cpu" else "cuda"
    initialize_distributed(device_type=device_type)
    return make_mesh(data=args.data_parallel, table=args.table_parallel, device_type=device_type)


def _lookup_options(args) -> Dict:
    options = {"strategy": args.lookup_strategy, "capacity_factor": args.capacity_factor}
    if args.min_rows_to_shard is not None:
        options["min_rows_to_shard"] = args.min_rows_to_shard
    return options


def _prints() -> bool:
    """Whether this process prints: rank 0 of a process group, or the only one."""
    from torecsys_tpu_torch.parallel.mesh import world

    return world()[0] == 0


def _inputs(args, streaming: bool, data: Optional[Columns]):
    """The schema: ``--inputs_config``, else the Criteo schema when
    streaming, else the one inferred from the loaded columns."""
    if args.inputs_config:
        return _build_inputs(_parse(args.inputs_config), args.device)
    if streaming:
        return _criteo_schema_inputs(args.criteo_hash_size, args.embed_size, args.device)
    return _default_inputs(data, args.target_fields, args.embed_size, args.device)


def _setup_logging() -> None:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(message)s")


# ---- commands ---------------------------------------------------------------

def cmd_version(args):
    print(torecsys_tpu_torch.__version__)
    return torecsys_tpu_torch.__version__


def cmd_build(args):
    """Assemble a pipeline from JSON configs and print its summary."""
    from torecsys_tpu_torch.models import MODELS
    from torecsys_tpu_torch.train import Pipeline

    inputs = _build_inputs(_parse(args.inputs_config), args.device) if args.inputs_config \
        else None
    model_config = _parse(args.model_config)
    pipeline = Pipeline.build(
        device=args.device, objective=args.objective, inputs_config=inputs,
        # a registry model is built from its inputs' widths
        model_config=model_config if inputs is not None else None,
        regularizer_config=_parse(args.regularizer_config),
        criterion_config=_parse(args.criterion_config),
        optimizer_config=_parse(args.optimizer_config),
        miner_config=_parse(args.miner_config), miner_target_field=args.miner_target_field,
        target_fields=args.target_fields,
    )
    print(pipeline.summary())
    if inputs is None:
        print(f"model (not built without --inputs_config): "
              f"{MODELS[model_config['method']].__name__}")
    return pipeline


def cmd_train(args):
    """Train end to end on synthetic CTR data or a file (CSV or Criteo TSV);
    returns the Trainer."""
    from torecsys_tpu_torch.train import Pipeline, Trainer

    _setup_logging()
    mesh = _make_mesh(args)
    streaming = bool(args.train_file) and _should_stream(
        args.train_file, args.data_format, args.stream, args.stream_threshold_mb)
    data = None
    if args.train_file and not streaming:
        data = _load_table(args.train_file, args.data_format, args.target_fields,
                           args.criteo_hash_size)
    elif not args.train_file:
        from torecsys_tpu_torch.data import make_synthetic_ctr

        data = make_synthetic_ctr(num_rows=args.num_rows)

    inputs = _inputs(args, streaming, data)

    pipeline = Pipeline.build(
        device=args.device, objective="ctr", inputs_config=inputs,
        model_config=_parse(args.model_config),
        criterion_config=_parse(args.criterion_config),
        optimizer_config=_parse(args.optimizer_config),
        regularizer_config=_parse(args.regularizer_config),
        target_fields=args.target_fields, load_from=args.load_from,
    )
    if _prints():
        print(pipeline.summary())

    if streaming:
        train_loader = _streaming_loader(args.train_file, args.criteo_hash_size,
                                         args.target_fields, args.batch_size,
                                         args.stream_chunk_mb, shuffle=True)
        val_loader = _streaming_loader(args.val_file, args.criteo_hash_size,
                                       args.target_fields, args.batch_size,
                                       args.stream_chunk_mb, shuffle=False) \
            if args.val_file else None
    else:
        n = len(next(iter(data.values())))
        if args.val_file:
            val_data = _load_table(args.val_file, args.data_format, args.target_fields,
                                   args.criteo_hash_size)
            train_loader = _batch_loader(data, 0, n, args.batch_size, True)
            nv = len(next(iter(val_data.values())))
            val_loader = _batch_loader(val_data, 0, nv, args.batch_size, False)
        else:
            split = max(int(n * 0.9), 1)
            train_loader = _batch_loader(data, 0, split, args.batch_size, True)
            val_loader = (_batch_loader(data, split, n, args.batch_size, False)
                          if split < n else None)

    trainer = Trainer(pipeline, checkpoint_dir=args.checkpoint_dir, resume=args.resume,
                      steps_per_execution=args.steps_per_execution, presort=args.presort,
                      prefetch=args.prefetch, mesh=mesh, lookup_options=_lookup_options(args))
    metrics = trainer.fit(train_loader, val_loader=val_loader,
                          max_epochs=args.max_num_epochs, max_steps=args.max_num_iterations)
    if _prints():
        print(json.dumps(metrics))
    return trainer


def cmd_evaluate(args):
    """Restore a checkpoint and print AUC and logloss on a file (or the
    synthetic holdout); returns the metrics."""
    from torecsys_tpu_torch.train import Pipeline, Trainer

    _setup_logging()
    streaming = bool(args.eval_file) and _should_stream(
        args.eval_file, args.data_format, args.stream, args.stream_threshold_mb)
    data = None
    if streaming:
        loader = _streaming_loader(args.eval_file, args.criteo_hash_size, args.target_fields,
                                   args.batch_size, args.stream_chunk_mb, shuffle=False)
    elif args.eval_file:
        data = _load_table(args.eval_file, args.data_format, args.target_fields,
                           args.criteo_hash_size)
        lo = 0
    else:
        from torecsys_tpu_torch.data import make_synthetic_ctr

        data = make_synthetic_ctr(num_rows=args.num_rows)
        lo = int(args.num_rows * 0.9)  # the holdout the train command leaves out

    inputs = _inputs(args, streaming, data)

    pipeline = Pipeline.build(
        device=args.device, objective="ctr", inputs_config=inputs,
        model_config=_parse(args.model_config),
        optimizer_config=_parse(args.optimizer_config),
        target_fields=args.target_fields, load_from=args.load_from,
    )
    if not streaming:
        n = len(next(iter(data.values())))
        loader = _batch_loader(data, lo, n, args.batch_size, False)

    trainer = Trainer(pipeline, resume=False, load_from=args.load_from)
    trainer.init_state()
    metrics = trainer.evaluate(loader)
    print(json.dumps(metrics))
    return metrics


# ---- argument parsing -------------------------------------------------------

def _existing_path(path: str) -> str:
    if not os.path.exists(path):
        raise argparse.ArgumentTypeError(f"path {path!r} does not exist")
    return path


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the CUDA card; 'cpu' runs on "
                        "the CPU)")


def _add_data_options(p: argparse.ArgumentParser) -> None:
    p.add_argument("--target_fields", default="label")
    p.add_argument("--batch_size", default=1024, type=int)
    p.add_argument("--embed_size", default=16, type=int)
    p.add_argument("--data_format", default="auto",
                   help="auto | criteo (39-col DAC TSV) | csv (headered)")
    p.add_argument("--criteo_hash_size", default=100_000, type=int,
                   help="per-field hash-bucket count for criteo cats")
    p.add_argument("--stream", default="auto", choices=["auto", "on", "off"],
                   help="chunked streaming for criteo files: auto = stream when the file "
                        "exceeds --stream_threshold_mb")
    p.add_argument("--stream_threshold_mb", default=1024, type=int)
    p.add_argument("--stream_chunk_mb", default=256, type=int,
                   help="chunk size (RAM bound and shuffle buffer) when streaming")


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="torecsys-tpu-torch",
        description="torecsys_tpu_torch: the PyTorch/CUDA port of torecsys-tpu.")
    sub = parser.add_subparsers(dest="command", required=True)

    sub.add_parser("version", help="print the package version").set_defaults(fn=cmd_version)

    p = sub.add_parser("build", help="assemble a pipeline from JSON configs and print it")
    p.add_argument("--objective", default="ctr", help="ctr | emb | ltr")
    p.add_argument("--inputs_config", default=None, help="JSON inputs config")
    p.add_argument("--model_config", required=True, help='JSON, e.g. \'{"method":"DeepFM"}\'')
    p.add_argument("--regularizer_config", default=None, help="JSON regularizer config")
    p.add_argument("--criterion_config", default=None, help="JSON criterion config")
    p.add_argument("--optimizer_config", default=None, help="JSON optimizer config")
    p.add_argument("--miner_config", default=None, help="JSON miner config (ltr/emb)")
    p.add_argument("--miner_target_field", default=None)
    p.add_argument("--target_fields", default="label")
    _add_device(p)
    p.set_defaults(fn=cmd_build)

    p = sub.add_parser("train", help="train on synthetic data or a CSV / Criteo TSV file")
    p.add_argument("--model_config", required=True, help='JSON, e.g. \'{"method":"DeepFM"}\'')
    p.add_argument("--inputs_config", default=None,
                   help="JSON inputs config; default = schema inferred from data")
    p.add_argument("--criterion_config", default=None)
    p.add_argument("--optimizer_config", default=None)
    p.add_argument("--regularizer_config", default=None)
    p.add_argument("--train_file", default=None, type=_existing_path,
                   help="CSV or Criteo TSV; omitted = synthetic CTR data")
    p.add_argument("--val_file", default=None, type=_existing_path)
    p.add_argument("--max_num_epochs", default=1, type=int)
    p.add_argument("--max_num_iterations", default=None, type=int)
    p.add_argument("--num_rows", default=100_000, type=int, help="synthetic dataset size")
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--load_from", default=None,
                   help="explicit checkpoint to restore before training")
    p.add_argument("--resume", dest="resume", action="store_true", default=True,
                   help="auto-resume from the newest checkpoint in --checkpoint_dir (default)")
    p.add_argument("--no-resume", dest="resume", action="store_false")
    p.add_argument("--data_parallel", default=1, type=int, help="mesh data axis size")
    p.add_argument("--table_parallel", default=1, type=int, help="mesh table axis size")
    p.add_argument("--steps_per_execution", default=1, type=int)
    p.add_argument("--lookup_strategy", default="auto", choices=["auto", "psum", "alltoall"],
                   help="sharded-lookup collective: auto picks from the calibrated comm-byte "
                        "model (parallel.lookup)")
    p.add_argument("--capacity_factor", default=2.0, type=float,
                   help="all-to-all per-destination bucket capacity factor; worst-case-safe "
                        "is --table_parallel")
    p.add_argument("--min_rows_to_shard", default=None, type=int,
                   help="tables with fewer stored rows replicate instead of row-sharding "
                        "(default: parallel.sharding's 65536)")
    p.add_argument("--presort", dest="presort", action="store_const", const=True, default=None,
                   help="host presort of the id streams (default: the Trainer's choice)")
    p.add_argument("--no_presort", dest="presort", action="store_const", const=False)
    p.add_argument("--prefetch", default=4, type=int,
                   help="host input-pipeline look-ahead depth (0 disables the workers)")
    _add_data_options(p)
    _add_device(p)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("evaluate", help="restore a checkpoint and print AUC and logloss")
    p.add_argument("--model_config", required=True)
    p.add_argument("--inputs_config", default=None)
    p.add_argument("--optimizer_config", default=None,
                   help="must match the checkpoint's optimizer (state layout)")
    p.add_argument("--load_from", required=True, type=_existing_path,
                   help="checkpoint to evaluate")
    p.add_argument("--eval_file", default=None, type=_existing_path)
    p.add_argument("--num_rows", default=100_000, type=int,
                   help="synthetic dataset size when --eval_file is omitted")
    _add_data_options(p)
    _add_device(p)
    p.set_defaults(fn=cmd_evaluate)
    return parser


def run(argv: Optional[List[str]] = None):
    """Parse ``argv`` and run its command; returns what the command returns
    (the Pipeline of ``build``, the Trainer of ``train``, the metrics of
    ``evaluate``).  Raises :class:`UsageError` on a command-line mistake."""
    args = make_parser().parse_args(argv)
    return args.fn(args)


def main(argv: Optional[List[str]] = None) -> int:
    """The console entry: runs the command and returns the exit code (2 on a
    command-line mistake, with the message on stderr)."""
    try:
        run(argv)
    except UsageError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 2
    return 0


__all__ = ["UsageError", "main", "make_parser", "run"]
