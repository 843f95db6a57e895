from .column import (  # noqa: F401
    DeviceColumn,
    HostColumn,
    choose_capacity,
    column_from_pylist,
    dict_column_from_parts,
    dict_column_from_pylist,
    resolve_device,
)
from .batch import (  # noqa: F401
    ColumnarBatch,
    batch_from_host_arrays,
    batch_from_rows,
    schema_of,
)
from .split import split_batch  # noqa: F401,E402
