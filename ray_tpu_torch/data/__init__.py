"""Port of ``ray_tpu/data/__init__.py``.

ray_tpu_torch.data — streaming, lazy, distributed datasets.

Counterpart of Ray Data (reference: python/ray/data/): the same lazy
logical-plan / streaming-executor architecture, with dict-of-numpy blocks
as the canonical format so data flows shared-memory store ->
``torch.from_numpy`` without row pivots, and ``iter_torch_batches`` /
``streaming_split`` feeding training loops on the cards.
"""

from ray_tpu_torch.data._logical import ActorPoolStrategy
from ray_tpu_torch.data.aggregate import (AbsMax, AggregateFn, Count, Max, Mean,
                                    Min, Std, Sum)
from ray_tpu_torch.data.block import Block, BlockAccessor, BlockMetadata
from ray_tpu_torch.data.dataset import Dataset, GroupedData, MaterializedDataset
from ray_tpu_torch.data.datasource import Datasource, ReadTask
from ray_tpu_torch.data.iterator import DataIterator
from ray_tpu_torch.data.read_api import (from_arrow, from_blocks, from_items,
                                   from_numpy, from_pandas, range,
                                   range_tensor, read_binary_files, read_csv,
                                   read_datasource, read_json, read_numpy,
                                   read_parquet, read_text)

__all__ = [
    "ActorPoolStrategy", "AggregateFn", "Count", "Sum", "Min", "Max", "Mean",
    "Std", "AbsMax", "Block", "BlockAccessor", "BlockMetadata", "Dataset",
    "GroupedData", "MaterializedDataset", "Datasource", "ReadTask",
    "DataIterator", "from_arrow", "from_blocks", "from_items", "from_numpy",
    "from_pandas", "range", "range_tensor", "read_binary_files", "read_csv",
    "read_datasource", "read_json", "read_numpy", "read_parquet", "read_text",
]
