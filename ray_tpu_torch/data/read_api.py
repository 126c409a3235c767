"""Port of ``ray_tpu/data/read_api.py``.

Creation APIs for Datasets (reference: python/ray/data/read_api.py)."""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Union

import numpy as np

from ray_tpu_torch.data import _logical as L
from ray_tpu_torch.data.block import Block, BlockAccessor
from ray_tpu_torch.data.dataset import Dataset, MaterializedDataset
from ray_tpu_torch.data.datasource import (BinaryDatasource, BlocksDatasource,
                                     CSVDatasource, Datasource,
                                     ItemsDatasource, JSONDatasource,
                                     NumpyDatasource, ParquetDatasource,
                                     RangeDatasource, TextDatasource)

DEFAULT_PARALLELISM = 8


def read_datasource(datasource: Datasource, *,
                    parallelism: int = -1) -> Dataset:
    if parallelism <= 0:
        parallelism = DEFAULT_PARALLELISM
    return Dataset(L.Read(datasource=datasource, parallelism=parallelism))


def range(n: int, *, parallelism: int = -1) -> Dataset:  # noqa: A001
    return read_datasource(RangeDatasource(n), parallelism=parallelism)


def range_tensor(n: int, *, shape=(1,), parallelism: int = -1) -> Dataset:
    ds = range(n, parallelism=parallelism)

    def expand(batch):
        ids = batch["id"]
        data = np.broadcast_to(
            ids.reshape((len(ids),) + (1,) * len(shape)),
            (len(ids),) + tuple(shape)).copy()
        return {"data": data}

    return ds.map_batches(expand)


def from_items(items: Sequence[Any], *, parallelism: int = -1) -> Dataset:
    if parallelism <= 0:
        parallelism = DEFAULT_PARALLELISM
    return read_datasource(ItemsDatasource(items), parallelism=parallelism)


def from_blocks(blocks: List[Block]) -> Dataset:
    return read_datasource(BlocksDatasource(blocks),
                           parallelism=len(blocks) or 1)


def from_numpy(arrays: Union[np.ndarray, List[np.ndarray]],
               column: str = "data") -> Dataset:
    if isinstance(arrays, np.ndarray):
        arrays = [arrays]
    return from_blocks([{column: a} for a in arrays])


def from_pandas(dfs) -> Dataset:
    if not isinstance(dfs, list):
        dfs = [dfs]
    return from_blocks([BlockAccessor.from_pandas(df) for df in dfs])


def from_arrow(tables) -> Dataset:
    if not isinstance(tables, list):
        tables = [tables]
    return from_blocks([BlockAccessor.from_arrow(t) for t in tables])


def read_csv(paths, *, parallelism: int = -1, **kwargs) -> Dataset:
    return read_datasource(CSVDatasource(paths, **kwargs),
                           parallelism=parallelism)


def read_json(paths, *, parallelism: int = -1, **kwargs) -> Dataset:
    return read_datasource(JSONDatasource(paths, **kwargs),
                           parallelism=parallelism)


def read_parquet(paths, *, parallelism: int = -1, **kwargs) -> Dataset:
    return read_datasource(ParquetDatasource(paths, **kwargs),
                           parallelism=parallelism)


def read_numpy(paths, *, parallelism: int = -1, **kwargs) -> Dataset:
    return read_datasource(NumpyDatasource(paths, **kwargs),
                           parallelism=parallelism)


def read_text(paths, *, parallelism: int = -1, **kwargs) -> Dataset:
    return read_datasource(TextDatasource(paths, **kwargs),
                           parallelism=parallelism)


def read_binary_files(paths, *, parallelism: int = -1, **kwargs) -> Dataset:
    return read_datasource(BinaryDatasource(paths, **kwargs),
                           parallelism=parallelism)
