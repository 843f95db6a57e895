"""Physical operator (exec) layer of the port (reference:
``spark_rapids_tpu/exec``)."""
from .base import Metric, TpuExec, batch_from_vals, vals_of_batch  # noqa: F401
from .basic import InMemoryScanExec, TpuFilterExec, TpuProjectExec  # noqa: F401
from .aggregate import TpuHashAggregateExec, choose_agg_strategy  # noqa: F401
from .join import (TpuBroadcastNestedLoopJoinExec,  # noqa: F401
                   TpuCartesianProductExec, TpuShuffledHashJoinExec,
                   choose_join_strategy)
from .transitions import ColumnarToRowExec, RowToColumnarExec  # noqa: F401
