"""Two-tier compiled-program cache — the port of the JAX package's
``cache`` package.

L1 is ``core.tapir``'s in-memory ``_CACHE`` / ``_PROGRAMS`` (dies with the
process); this package provides the content-addressed on-disk L2 tier
(``ProgramDiskCache``), the cross-process key digest (``stable_digest``)
and the pipeline-semantics salt (``PIPELINE_VERSION``) every L2 key
includes.  Wiring lives in ``core.tapir._compile``: L1 miss -> L2 probe ->
compile + publish.  The reference's ``enable_xla_disk_cache`` and
``suspend_xla_disk_cache`` have no counterpart (torch has no compile cache
to point at the store; the kernels' libraries persist in ``build/``, keyed
by their sources' digest).
"""
from .digest import stable_digest
from .disk import (FORMAT_VERSION, PIPELINE_VERSION, ProgramDiskCache,
                   atomic_write_bytes, atomic_write_json)

__all__ = [
    "FORMAT_VERSION", "PIPELINE_VERSION", "ProgramDiskCache",
    "atomic_write_bytes", "atomic_write_json", "stable_digest",
]
