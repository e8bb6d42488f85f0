"""The IR's string dtypes <-> ``torch.dtype``."""
from __future__ import annotations

import torch

_BY_NAME = {
    "bfloat16": torch.bfloat16, "float16": torch.float16,
    "float32": torch.float32, "float64": torch.float64,
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}
_BY_DTYPE = {v: k for k, v in _BY_NAME.items()}


def to_torch_dtype(dt) -> torch.dtype:
    """``"bfloat16"`` (or a ``torch.dtype``) -> ``torch.bfloat16``."""
    if isinstance(dt, torch.dtype):
        return dt
    return _BY_NAME[str(dt)]


def dtype_name(dt) -> str:
    """``torch.bfloat16`` (or a name) -> ``"bfloat16"``."""
    if isinstance(dt, torch.dtype):
        return _BY_DTYPE[dt]
    name = str(dt)
    if name not in _BY_NAME:
        raise KeyError(f"unsupported dtype {dt!r}")
    return name
