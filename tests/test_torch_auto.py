"""The automatic dense/sparse choice (``set_sparse_embeddings(None)``):
the Trainer takes the sparse route from its threshold on, in packed table
elements, which depends on whether the host presort applies; a bf16 table
keeps the dense route; an explicit choice wins.  The JAX package makes the
same decision with thresholds measured on a TPU; the port's come from the
card (``chip_smoke.py --auto-sweep``).  The rule is held here at small
thresholds, so the tables stay small."""

import pytest
import torch

from torecsys_tpu_torch import Inputs, MultiIndicesEmbedding, Pipeline, Trainer, ValueInput
from torecsys_tpu_torch.train import trainer as trainer_mod
from torecsys_tpu_torch.train.sparse import is_hybrid_opt_state

E = 16
STORED = 8 * E  # elements of one stored row: 8 logical rows of 16
SMALL = {"SPARSE_AUTO_MIN_ELEMENTS": 40 * STORED, "SPARSE_AUTO_MIN_ELEMENTS_PRESORTED": 60 * STORED}


@pytest.fixture
def small_thresholds(monkeypatch):
    for name, value in SMALL.items():
        monkeypatch.setattr(trainer_mod, name, value)


def _trainer(rows, presort=None, table_dtype=None, sparse=None):
    inputs = Inputs({"feat_inputs": ValueInput(("d",)),
                     "emb_inputs": MultiIndicesEmbedding(E, (rows - 7, 7), ("a", "b"),
                                                         device="cpu")})
    pipe = (Pipeline(device="cpu").set_inputs(inputs).set_model("DeepFM", deep_layer_sizes=(4,))
            .set_sparse_embeddings(sparse).set_table_dtype(table_dtype))
    trainer = Trainer(pipe, presort=presort)
    trainer.init_state()
    return trainer


def test_the_card_thresholds_are_whole_stored_rows():
    for name in SMALL:
        value = getattr(trainer_mod, name)
        assert value > 0 and value % STORED == 0, name


@pytest.mark.parametrize("presort,name", [(None, "SPARSE_AUTO_MIN_ELEMENTS_PRESORTED"),
                                          (True, "SPARSE_AUTO_MIN_ELEMENTS_PRESORTED"),
                                          (False, "SPARSE_AUTO_MIN_ELEMENTS")])
@pytest.mark.parametrize("side", ["below", "at"])
def test_auto_choice_on_both_sides_of_its_threshold(small_thresholds, presort, name, side):
    """On the CPU presort None presorts, so it takes the presorted
    threshold."""
    elements = SMALL[name] + (-STORED if side == "below" else 0)
    trainer = _trainer(elements // E, presort=presort)
    table = trainer.pipeline.sequential.inputs.schema["emb_inputs"].embedding
    assert table.numel() == elements
    sparse = side == "at"
    assert trainer.sparse is sparse
    assert is_hybrid_opt_state(trainer.state.opt_state) is sparse
    assert (trainer._presorter is not None) == (sparse and presort is not False)


def test_a_bf16_table_keeps_the_dense_route_and_explicit_choices_win(small_thresholds):
    big = max(SMALL.values()) // E + 8
    bf16 = _trainer(big, table_dtype="bfloat16")
    assert bf16.sparse is False and bf16._presorter is None
    assert bf16.pipeline.sequential.inputs.schema["emb_inputs"].embedding.dtype == torch.bfloat16
    assert _trainer(big).sparse is True
    assert _trainer(big, sparse=False).sparse is False
    assert _trainer(64, sparse=True).sparse is True


@pytest.mark.parametrize("presort,device,applies", [
    (None, "cpu", True), (None, "cuda", False), (True, "cuda", True), (False, "cpu", False)])
def test_presort_none_presorts_on_the_cpu_and_not_on_a_card(presort, device, applies):
    """presort None follows the JAX package on the CPU (one host presorts)
    and sorts on the card on a CUDA device, where the device sort costs far
    less than the host presort; it also picks the threshold."""
    trainer = Trainer(Pipeline(device="cpu").set_inputs(Inputs({
        "emb_inputs": MultiIndicesEmbedding(E, (10,), ("a",), device="cpu")}))
        .set_model("DeepFM", deep_layer_sizes=(4,)), presort=presort)
    trainer.device = torch.device(device)
    assert trainer._presort_applicable() is applies
