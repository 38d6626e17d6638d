"""Row-wise datasets over table-like and numpy containers (counterpart of
``torecsys_tpu/data/dataset.py``).

Plain indexable containers: ``__getitem__`` returns a ``{column: value}``
row, ``__len__`` the row count, which is what
:class:`torecsys_tpu_torch.data.DataLoader` batches and
:class:`torecsys_tpu_torch.data.CollateFunction` turns into fixed-shape
arrays.  :class:`DataFrameToDataset` is duck-typed: it reads ``.columns``
and ``.iloc`` of whatever it is given and imports no data-frame library.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


class DataFrameToDataset:
    """Dataset over a data frame (anything with ``.columns``, ``.iloc`` and
    ``len``): row i → ``{col: value}``."""

    def __init__(self, dataframe, columns: Optional[Sequence[str]] = None):
        self.df = dataframe
        self.columns = list(columns) if columns is not None else list(dataframe.columns)

    def __len__(self) -> int:
        return len(self.df)

    def __getitem__(self, idx: int) -> Dict[str, object]:
        row = self.df.iloc[idx]
        return {c: row[c] for c in self.columns}


class NdarrayToDataset:
    """Dataset over a 2-D ``np.ndarray``: row i → ``{str(col_idx): value}``.

    Column names default to stringified column indices (positional access); pass ``columns`` to
    name them.
    """

    def __init__(self, array: np.ndarray, columns: Optional[Sequence[str]] = None):
        array = np.asarray(array)
        if array.ndim != 2:
            raise ValueError(f"expected 2-D array, got {array.shape}")
        self.array = array
        self.columns = (
            list(columns) if columns is not None else [str(i) for i in range(array.shape[1])]
        )

    def __len__(self) -> int:
        return self.array.shape[0]

    def __getitem__(self, idx: int) -> Dict[str, object]:
        return {c: self.array[idx, j] for j, c in enumerate(self.columns)}
