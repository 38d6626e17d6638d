"""The operation and byte counts against hand counts at a small shape."""

from __future__ import annotations

import pytest
from conftest import ROOT

from harness import cell as cells
from harness import counts

CFG = {"field_sizes": [10, 20, 30], "num_dense": 2, "embed_size": 4, "rows_per_stored_row": 2,
       "deep_layer_sizes": [5, 6], "dropout": 0.0, "cin_layer_sizes": [4, 2],
       "cin_is_direct": False, "use_batchnorm": True, "l2_reg": 0.0, "table_init_std": 0.01}
STATS = {"ids": 6, "logical_rows": 5, "stored_rows": 3}  # a batch of 2 over 3 fields


def test_tower_gemms_and_params():
    # 2 x (2*3*4 + 2*4*5) forward, three times that with the backward
    assert counts.tower_gemm_ops(2, [3, 4, 5]) == 3 * 2 * (2 * 3 * 4 + 2 * 4 * 5)
    assert counts.tower_params([3, 4, 5]) == 3 * 4 + 4 + 4 * 5 + 5


def test_lookup_and_sparse_update_bytes():
    # ids 6 x 4 B, 5 distinct rows x 4 x 4 B read, 6 rows x 4 x 4 B written
    assert counts.lookup_bytes(CFG, STATS) == 6 * 4 + 5 * 16 + 6 * 16
    # gradients 6 x (16 + 4) B; 3 stored rows of 8 floats, table m v, read and written
    assert counts.sparse_update_bytes(CFG, STATS) == 6 * 20 + 2 * 3 * 3 * 8 * 4


@pytest.mark.parametrize("name", ["deepfm_criteo", "xdeepfm_criteo"])
def test_configs_ops_per_step(name):
    model = cells.load_module(ROOT / "h100_bench" / "configs" / f"{name}.py", f"t_{name}")
    ops = model.ops_per_step(CFG, 2, STATS)
    row_update = counts.ADAM_OPS * 3 * 8
    if name == "deepfm_criteo":
        tower = 3 * 2 * (2 * 12 * 5 + 2 * 5 * 6 + 2 * 6 * 1)
        params = 12 * 5 + 5 + 5 * 6 + 6 + 6 + 1
        assert ops["bfloat16"] == tower
        assert ops["float32"] == 6 * 2 * 3 * 4 + counts.ADAM_OPS * params + row_update
    else:
        # CIN maps: (4, 3) pooling 2 and passing 2; then (2, 2) pooling 2: pooled 4
        cin = sum(3 * 2 * 2 * 4 * h * p * 3 + 5 * 2 * 4 * p * 3 + 20 * 2 * 4 * h
                  for h, p in ((4, 3), (2, 2)))
        params = (4 * 3 * 3 + 12) + (2 * 2 * 3 + 6) + (12 * 5 + 5 + 5 * 6 + 6 + 6 + 1)
        assert ops["float32"] == cin + counts.ADAM_OPS * (params + 4 + 1) + row_update
        tower = 3 * 2 * (2 * 12 * 5 + 2 * 5 * 6 + 2 * 6 * 1) + 3 * 2 * 2 * 4 * 1
        assert ops["bfloat16"] == tower


@pytest.mark.parametrize("name", ["deepfm_criteo", "xdeepfm_criteo"])
def test_weight_spec_covers_the_table_and_tower(name):
    model = cells.load_module(ROOT / "h100_bench" / "configs" / f"{name}.py", f"w_{name}")
    params, buffers = model.weight_spec(CFG)
    assert params[model.TABLE][0] == (60, 4)
    assert params["model.deep.dense_0.weight"][0] == (5, 12)
    assert params["model.deep.output.weight"][0] == (1, 6)
    if name == "xdeepfm_criteo":
        assert params["model.cin.conv_1"][0] == (2, 2, 3)
        assert params["model.cin.head.weight"][0] == (1, 4)
        assert set(buffers) == {f"model.cin.bn_{k}.{s}" for k in (0, 1) for s in ("mean", "var")}
